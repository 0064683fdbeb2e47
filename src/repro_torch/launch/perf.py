"""Perf-iteration tool: one cell's roofline under a tag.

Port of ``repro.launch.perf``, with the same flags.  Each invocation
measures the current code for one cell (``perfmodel.roofline_cell``:
global FLOPs on meta tensors, the dry run's walk on the fake 16 x 16
mesh) and appends the record to ``build/results_torch/perf_log.jsonl``,
so a hypothesis -> change -> measure loop is reproducible:

  PYTHONPATH=src python -m repro_torch.launch.perf --arch olmo-1b \\
      --shape decode_32k --tag it1-bf16-attn [--quant-bits 4] \\
      [--serve-sharding] [--ssd-chunk 128] [--kv-bits 4] [--spiking-ffn] \\
      [--attn-cp] [--moe-dense] [--moe-buf-shard data,,model,] \\
      [--hypothesis "..."] [--force]

``--attn-cp`` and ``--moe-buf-shard`` set ``models.layers``' and
``models.moe``'s hints on the fake production mesh.  JAX's hints are
sharding constraints on the global tensor; the port's step computes on
the rank's batch rows (FSDP, ``launch/steps.py``), so each hint lays the
rows out as the spec says and gathers them back (:func:`layout_hint`):
the traffic of the layout, not a split of the compute.  Like the dry
run, the tool allocates nothing on any device (no ``device=``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

LOG = (Path(__file__).resolve().parents[3] / "build" / "results_torch"
       / "perf_log.jsonl")


def layout_hint(mesh, spec):
    """``x -> x``: the rank's batch rows of ``x`` (split over ``data`` on
    dim 0) placed by ``spec`` on ``mesh`` and gathered back to the rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import sharding as shd

    rows = tuple(Shard(0) if name == "data" else Replicate()
                 for name in mesh.mesh_dim_names)
    target = shd.NamedSharding(mesh, spec).placements

    def hint(x, *_):
        d = DTensor.from_local(x, mesh, rows, run_check=False)
        return d.redistribute(mesh, target).redistribute(mesh, rows) \
            .to_local()

    return hint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--quant-bits", type=int, default=16)
    ap.add_argument("--serve-sharding", action="store_true",
                    help="inference-mode sharding: TP-only weights "
                         "(no FSDP all-gathers on the serve path)")
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--kv-bits", type=int, default=16,
                    help="packed low-bit KV cache (L-SPINE datapath on the "
                         "decode-dominant buffer)")
    ap.add_argument("--spiking-ffn", action="store_true",
                    help="L-SPINE spiking execution of FFN blocks (LIF over "
                         "T=4 timesteps, shift-add leak)")
    ap.add_argument("--attn-cp", action="store_true",
                    help="context-parallel attention: shard query chunks "
                         "over the model axis (for head counts that do not "
                         "divide it)")
    ap.add_argument("--moe-dense", action="store_true",
                    help="dense-mixture MoE (no dispatch comm)")
    ap.add_argument("--moe-buf-shard", default=None,
                    help="pin MoE dispatch buffers, e.g. 'data,,model,' "
                         "for P(data,None,model,None) on (B,E,C,d)")
    ap.add_argument("--hypothesis", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.perfmodel.roofline import roofline_cell

    if args.serve_sharding:
        shd.set_variant("serve")

    if args.attn_cp:
        from repro_torch.models import layers as Ly

        Ly.set_attention_cp(hint=layout_hint(
            fake_world(), shd.P("data", "model", None, None, None, None)),
            q_chunk=256)

    if args.moe_buf_shard is not None:
        from repro_torch.models import moe as MOE

        axes = tuple(a if a else None for a in args.moe_buf_shard.split(","))
        MOE.set_buffer_hint(layout_hint(fake_world(), shd.P(*axes)))

    cfg_override = None
    if (args.ssd_chunk or args.kv_bits != 16 or args.moe_dense
            or args.spiking_ffn):
        base = get_config(args.arch)
        kw = {}
        if args.spiking_ffn:
            from repro_torch.configs.base import SpikingConfig
            kw["spiking"] = SpikingConfig()
        if args.ssd_chunk:
            kw["ssm"] = dataclasses.replace(base.ssm,
                                            chunk_size=args.ssd_chunk)
        if args.kv_bits != 16:
            kw["kv_cache_bits"] = args.kv_bits
        if args.moe_dense:
            kw["moe"] = dataclasses.replace(base.moe, force_dense=True)
        cfg_override = dataclasses.replace(base, **kw)

    rec = roofline_cell(args.arch, args.shape, quant_bits=args.quant_bits,
                        force=args.force, tag="__" + args.tag,
                        cfg_override=cfg_override)
    small = {k: v for k, v in rec.items() if k not in ("depth1", "depth2")}
    small["hypothesis"] = args.hypothesis
    small["knobs"] = {"serve_sharding": args.serve_sharding,
                      "ssd_chunk": args.ssd_chunk,
                      "quant_bits": args.quant_bits,
                      "kv_bits": args.kv_bits,
                      "moe_buf_shard": args.moe_buf_shard,
                      "spiking_ffn": args.spiking_ffn}
    LOG.parent.mkdir(parents=True, exist_ok=True)
    with LOG.open("a") as f:
        f.write(json.dumps(small) + "\n")
    if rec.get("ok"):
        print(f"[{args.tag}] {args.arch} {args.shape}: "
              f"comp={rec['compute_s']:.4f}s mem={rec['memory_s']:.4f}s "
              f"coll={rec['collective_s']:.4f}s -> {rec['bottleneck']} "
              f"(bound {rec['step_s_lower_bound']:.4f}s)")
    else:
        print(f"[{args.tag}] FAILED: {rec.get('error')}")
    return rec


if __name__ == "__main__":
    main()
