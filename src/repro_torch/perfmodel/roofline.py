"""Roofline constants of the NVIDIA H100 SXM, the term tie-break and
each (arch x shape x mesh) cell's roofline.

Every time prediction of the port divides by these numbers: the
per-node predictions of ``obs.attribution``, the kernel bounds that
``chip_smoke.py`` records and the cell terms below.  They are the data
sheet's dense rates (no sparsity) at the card's full 700 W power limit;
a card set below it runs slower under load, so a measurement is read
beside the card's ``nvidia-smi`` power limit.

A cell's roofline (port of ``repro.perfmodel.roofline``):

1. compute term: the global FLOPs of the cell's unsharded step on
   ``launch/specs.py``'s meta stand-ins (:func:`exact_flops`), over
   ``chips * PEAK_FLOPS``;
2. memory and collective terms: the per-device ``hbm_bytes_est`` and
   collective bytes of ``launch/dryrun.py``'s full-depth walk of the
   cell on the fake 256/512-rank mesh, over ``HBM_BW`` and ``LINK_BW``.
   :func:`depth_differential` keeps JAX's depth-1/depth-2 extrapolation
   (an eager walk sees every layer, so the full-depth walk needs none).
"""

from __future__ import annotations

import dataclasses

import torch

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: dense bf16/fp16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
#: dense int8 tensor-core peak, OP/s (the packed SNN kernels' mma.sync s8)
PEAK_INT8_OPS = 1979e12
#: float32 outside the tensor cores, FLOP/s (the float stem, TF32 off)
PEAK_FP32_FLOPS = 67e12
#: NVLink 4, per direction per GPU (900 GB/s both ways), bytes/s
LINK_BW = 450e9

# Tie-break priority for the dominant roofline term.  ``max()`` returns
# the FIRST maximal element, so equal times resolve compute > memory >
# collective, deterministically.
_BOTTLENECK_PRIORITY = ("compute", "memory", "collective")


def pick_bottleneck(t_comp: float, t_mem: float, t_coll: float) -> str:
    """Name of the dominant term, ties broken by _BOTTLENECK_PRIORITY."""
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return max(_BOTTLENECK_PRIORITY, key=lambda k: terms[k])


def override_depth(cfg, n_layers: int):
    """Clone an LM config at a reduced depth (layer-pattern safe)."""
    kw = {"n_layers": n_layers}
    if cfg.global_attn_layers:
        kw["global_attn_layers"] = tuple(
            i for i in cfg.global_attn_layers if i < n_layers
        ) or (0,)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_layers=n_layers)
    return dataclasses.replace(cfg, **kw)


def exact_flops(arch: str, shape_name: str, quant_bits: int = 16) -> int:
    """Global FLOPs of the cell's step (``perfmodel/flops.py``'s count of
    the unsharded step on meta tensors: nothing is allocated or
    computed).  A decode step is given the cache's length from the host,
    as the dry run gives it."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch import steps as St
    from repro_torch.perfmodel.flops import count_fn_flops
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.train.optimizer import OptConfig

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat="dots")
    if quant_bits != 16:
        cfg = dataclasses.replace(
            cfg, precision=PrecisionConfig(bits=quant_bits, group_size=-1))
    params = S.param_specs_struct(cfg)
    if shape.kind == "train":
        fn = St.make_train_step(cfg, OptConfig())
        return count_fn_flops(fn, params, S.opt_specs_struct(params),
                              S.train_batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return count_fn_flops(St.make_prefill_step(cfg), params,
                              S.prefill_batch_specs(cfg, shape))
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                         device="meta")
    return count_fn_flops(St.make_decode_step(cfg), params,
                          S.cache_specs_struct(cfg, shape), tokens,
                          kv_len=shape.seq_len)


def depth_differential(arch: str, shape_name: str, *, multi_pod=False,
                       quant_bits: int = 16, force=False, tag: str = "",
                       cfg_override=None) -> dict:
    """bytes/collectives per device, extrapolated from depth-1 and
    depth-2 dry runs: ``c(L1) + (n_layers - 1) * max(0, c(L2) - c(L1))``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as D

    cfg = cfg_override if cfg_override is not None else get_config(arch)
    L = cfg.n_layers
    recs = {}
    for depth in (1, 2):
        recs[depth] = D.run_cell_cfg(
            override_depth(cfg, depth), arch, shape_name,
            tag_suffix=f"__depth{depth}{tag}", multi_pod=multi_pod,
            quant_bits=quant_bits, force=force,
        )
        if not recs[depth]["ok"]:
            return {"ok": False, "error": recs[depth].get("error"),
                    "depth_failed": depth}

    def extrap(key, sub=None):
        def get(r):
            v = r.get(key, 0) or 0
            if sub is not None:
                v = (v or {}).get(sub, 0) or 0
            return float(v)
        c1, c2 = get(recs[1]), get(recs[2])
        return c1 + (L - 1) * max(0.0, c2 - c1)

    return {
        "ok": True,
        "bytes_per_device": extrap("hbm_bytes_est"),
        "bytes_cost_analysis": extrap("bytes_per_device"),
        "coll_bytes_per_device": extrap("collective_bytes", "total"),
        "coll_breakdown": {k: extrap("collective_bytes", k)
                           for k in D.COLL_KINDS},
        "depth1": recs[1], "depth2": recs[2],
    }


def roofline_cell(arch: str, shape_name: str, *, multi_pod=False,
                  quant_bits: int = 16, force=False, tag: str = "",
                  cfg_override=None) -> dict:
    """The cell's three roofline terms on ``chips`` H100s (256, or 512
    multi-pod), its bottleneck, lower bound and roofline fraction."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    rec = {"arch": arch, "shape": shape_name, "tag": tag,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": chips, "quant_bits": quant_bits}

    flops = exact_flops(arch, shape_name, quant_bits)
    full = D.run_cell_cfg(cfg_override, arch, shape_name,
                          tag_suffix=tag, multi_pod=multi_pod,
                          quant_bits=quant_bits, force=force)
    if not full["ok"]:
        rec.update(ok=False, error=full.get("error"))
        return rec
    coll = full["collective_bytes"]
    diff = {
        "bytes_per_device": float(full["hbm_bytes_est"]),
        "coll_bytes_per_device": float(coll.get("total", 0)),
        "coll_breakdown": {k: float(coll.get(k, 0)) for k in D.COLL_KINDS},
    }

    t_comp = flops / (chips * PEAK_FLOPS)
    t_mem = diff["bytes_per_device"] / HBM_BW
    t_coll = diff["coll_bytes_per_device"] / LINK_BW

    toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)
    n_act = cfg.active_params()
    model_flops = (6 if shape.kind == "train" else 2) * n_act * toks

    rec.update(
        ok=True,
        hlo_flops_global=float(flops),
        model_flops=float(model_flops),
        useful_ratio=float(model_flops / flops) if flops else 0.0,
        bytes_per_device=diff["bytes_per_device"],
        coll_bytes_per_device=diff["coll_bytes_per_device"],
        coll_breakdown=diff["coll_breakdown"],
        compute_s=t_comp, memory_s=t_mem, collective_s=t_coll,
        bottleneck=pick_bottleneck(t_comp, t_mem, t_coll),
        step_s_lower_bound=max(t_comp, t_mem, t_coll),
        roofline_fraction=float(
            t_comp / max(t_comp, t_mem, t_coll, 1e-30)),
    )
    return rec
