"""Multi-pod dry run: every (arch x shape x mesh) cell's step on a fake
256- or 512-rank process group.

Port of ``repro.launch.dryrun``.  JAX forces 512 host devices, lowers
and compiles each cell with pjit and reads XLA's cost analysis, memory
analysis and HLO text.  PyTorch has no partitioner to ask, so the port
runs the cell's step itself, on nothing:

* the world is a fake process group (``"fake"`` backend,
  ``torch.testing._internal.distributed.fake_pg``) of 256 ranks (512
  multi-pod) in this one process, as rank 0, and the mesh is
  ``launch/mesh.py``'s production mesh over it; collectives return at
  once and move nothing;
* every tensor is a fake tensor (``FakeTensorMode``): shape, dtype and
  strides, no storage, so a cell allocates nothing on any device;
* params, moments, batch and cache are ``launch/specs.py``'s stand-ins
  placed by ``distributed/sharding.py``'s specs (DTensors), and the step
  is the port's own sharded step (``launch/steps.py``: train, prefill
  and decode tensor-parallel over ``model`` for every family);
* :class:`CellWalker`, a dispatch mode, meets every op rank 0 runs, at
  the rank's local shapes (``perfmodel.flops.LocalOpMode``: a DTensor
  op is handed on to DTensor, whose local ops and collectives come
  back to the mode).  Every spec splits evenly (``sharding._fits``), so
  rank 0's shards and traffic stand for every rank's.

The tool never runs a step for real and allocates nothing, as JAX's
runs on forced host devices: it is the port's one entry point without
``device=``.  The fake group is process-global, so a process holds one
world; the CLI and the tests run the tool in a process of its own.

What a cell records (schema 4, JAX's keys and meanings, per device):

``flops_per_device``   ``perfmodel/flops.py``'s rules over the rank's ops
``bytes_per_device``   input and output bytes of every op that is not a
                       view (XLA's ``bytes accessed``)
``hbm_bytes_est``      :class:`CellWalker`'s walk, ``analyze_hlo``'s
                       rules on ATen: the step's inputs read once; loads
                       (``index``, ``index_select``, ``gather``,
                       ``embedding``) charge their output once; other
                       ops that write memory twice (write + re-read),
                       in-place arithmetic (AdamW's ``mul_``) included;
                       collectives twice; free: views, slice and index
                       writes (``index_put``, ``index_copy``, ``scatter``,
                       ``slice_scatter``) and dtype or copy moves
                       (``copy_``, ``_to_copy``, ``clone``): JAX's
                       ``_INPLACE``
``collective_bytes``   output bytes by JAX's kinds (``all-gather``,
                       ``reduce-scatter``, ``all-reduce``, ``all-to-all``;
                       point-to-point receives as ``collective-permute``)
                       and ``total``
``argument_size_in_bytes``  local bytes of the step's inputs
``output_size_in_bytes``    local bytes of its outputs
``temp_size_in_bytes``      the peak of live storage bytes the step
                            allocated (the arguments' are not in it)

plus ``schema``, ``n_devices``, ``lower_s`` (build and placement),
``compile_s`` (the fake run), ``ok`` and ``wall_s``.  An eager run goes
round each Python loop (layers, attention and cross-entropy chunks) once
a trip, and the walk sees every op as often as it runs, so JAX's
computation split and trip counts (``_split_computations``,
``_trip_count``) have no counterpart, and neither has
``collective_bytes_body_once`` (a loop body read once) or
``generated_code_size_in_bytes``.  The port's collectives are its own
design's (``launch/steps.py``: params gathered over the batch's dims,
or whole on the FSDP route, gradients reduce-scattered, and on the
tensor-parallel route the all-reduces of ``distributed/tensor_parallel``
and a serve step's softmax merge over a sequence-split cache), not
XLA's, so its collective bytes are its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \
      [--roofline]

Records are cached per cell in ``build/results_torch/dryrun/<cell>.json``
(only ``ok`` records of the current schema are reused; ``--force``
redoes them), so a sweep is resumable.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
import traceback
import weakref
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from repro_torch.distributed import sharding as shd
from repro_torch.launch import specs as S
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import dp_axes, make_production_mesh
from repro_torch.perfmodel.flops import LocalOpMode, _op_flops, is_comm
from repro_torch.train import optimizer as opt
from repro_torch.tree import map_tree

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "build" / "results_torch"
               / "dryrun")
SCHEMA = 4

# --- the fake world ----------------------------------------------------------


def fake_group(world: int, rank: int = 0) -> None:
    """Make the default process group a fake one of ``world`` ranks, this
    process being ``rank``.  A fake group of another size or rank is
    replaced; any other group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"running; the dry run needs its own process")
        if (dist.get_world_size(), dist.get_rank()) == (world, rank):
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def fake_world(*, multi_pod: bool = False, rank: int = 0):
    """The production mesh (``launch/mesh.py``) over a fake group of 256
    ranks, or 512 with ``multi_pod``, as ``rank``."""
    fake_group(512 if multi_pod else 256, rank)
    return make_production_mesh(multi_pod=multi_pod)


def fake_tensors(tree):
    """``tree``'s tensors (``meta`` stand-ins) as fake CPU tensors of the
    same shapes, dtypes and strides; call under a ``FakeTensorMode``."""
    return map_tree(lambda t: torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="cpu"), tree)


# --- the walk ----------------------------------------------------------------

_COLL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    # c10d's in-place ops (torch.distributed.all_reduce & co.): the
    # output is their first argument
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
}
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
_LOADS = {"index", "index_select", "gather", "embedding"}
_FREE = {"copy_", "_to_copy", "clone", "index_put", "index_put_",
         "_index_put_impl_", "index_copy", "index_copy_", "index_add",
         "index_add_", "scatter", "scatter_", "scatter_add", "scatter_add_",
         "scatter_reduce", "scatter_reduce_", "slice_scatter",
         "select_scatter", "empty", "empty_like", "empty_strided",
         "new_empty", "new_empty_strided"}
# ops that alias their input without an alias annotation, or change a
# tensor's metadata in place
_ALIASES = {"_unsafe_view", "wait_tensor", "unsqueeze_", "squeeze_",
            "transpose_", "t_", "as_strided_", "detach_"}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


def nbytes(tree) -> int:
    """Local bytes of every tensor in ``tree`` (a DTensor's shard)."""
    return sum(_local(t).numel() * _local(t).element_size()
               for t in _tensors(tree))


class CellWalker(LocalOpMode):
    """Counts what one rank's step costs under the module docstring's
    rules.  ``args`` are the step's inputs: their bytes start the HBM
    estimate and their storages are not the step's own."""

    def __init__(self, args):
        super().__init__()
        self.arg_bytes = nbytes(args)
        self.flops = 0
        self.bytes = 0
        self.hbm = self.arg_bytes
        self.colls: dict = {}
        self._given = {_local(t).untyped_storage()._cdata
                       for t in _tensors(args)}
        self._live: dict = {}
        self.live = 0
        self.peak = 0
        self.flops_by_op: dict = {}

    def charge(self, func, args, out) -> None:
        name = func.overloadpacket.__name__
        flops = _op_flops(func, args, out)
        if flops:
            self.flops += flops
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + flops
        if func.namespace == "prim" or func.is_view or name in _ALIASES:
            return
        outs = _tensors(out)
        self.bytes += nbytes(args) + nbytes(outs)
        if is_comm(func):
            kind = _COLL_KINDS.get(name)
            if kind is not None:
                got = nbytes(outs if func.namespace == "_c10d_functional"
                              else args[0])
                self.colls[kind] = self.colls.get(kind, 0) + got
                self.colls["total"] = self.colls.get("total", 0) + got
                self.hbm += 2 * got
        elif name in _LOADS:
            self.hbm += nbytes(outs)
        elif name not in _FREE:
            self.hbm += 2 * nbytes(outs)
        for t in outs:
            self._hold(t.untyped_storage())

    def _hold(self, storage) -> None:
        key = storage._cdata
        if key in self._given or key in self._live:
            return
        self._live[key] = storage.nbytes()
        self.live += self._live[key]
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._live.pop(key, 0)


def count_step(fn, args):
    """Run ``fn(*args)`` once under a :class:`CellWalker`; returns (its
    output, the record's counts)."""
    walker = CellWalker(args)
    with walker:
        out = fn(*args)
    return out, {
        "flops_per_device": float(walker.flops),
        "bytes_per_device": float(walker.bytes),
        "hbm_bytes_est": int(walker.hbm),
        "collective_bytes": dict(walker.colls) or {"total": 0},
        "argument_size_in_bytes": int(walker.arg_bytes),
        "output_size_in_bytes": int(nbytes(out)),
        "temp_size_in_bytes": int(walker.peak),
    }


def check_placed(out, shardings) -> None:
    """Raise unless every output leaf is laid out as the matching
    ``NamedSharding`` says (a plain tensor stands for replicated)."""
    def check(t, sh):
        want = tuple(sh.placements)
        if isinstance(t, DTensor):
            ok = tuple(t.placements) == want
        else:
            ok = all(p.is_replicate() for p in want)
        if not ok:
            got = tuple(t.placements) if isinstance(t, DTensor) else "whole"
            raise AssertionError(f"an output is placed {got}; its out "
                                 f"sharding says {want} ({sh.spec})")

    map_tree(check, out, shardings)


# --- the cells ---------------------------------------------------------------


def cell_config(cfg, shape, quant_bits: int = 16):
    """JAX's rules for a cell's config: remat ``"dots"`` for a train
    step, per-channel fake-quant at ``quant_bits`` (when not 16 and the
    config is not quantized already)."""
    from repro_torch.quant.formats import PrecisionConfig

    if shape.kind == "train" and cfg.remat == "none":
        cfg = dataclasses.replace(cfg, remat="dots")
    if quant_bits != 16 and not cfg.precision.quantized:
        cfg = dataclasses.replace(
            cfg, precision=PrecisionConfig(bits=quant_bits, group_size=-1))
    return cfg


def place_cell(cfg, shape, mesh):
    """(fn, args, out_shardings) of a cell whose config is final: the
    step and its inputs, fake tensors placed on ``mesh``.  Call under a
    ``FakeTensorMode`` and run ``fn`` under the same one."""
    dp = dp_axes(mesh)
    params = S.param_specs_struct(cfg)
    pshard = shd.to_shardings(shd.param_specs(params, mesh), mesh)
    params = shd.distribute(fake_tensors(params), pshard)
    rep = shd.NamedSharding(mesh, shd.P())

    def placed_batch(batch):
        return {k: shd.place(v, shd.NamedSharding(
            mesh, shd.batch_spec(k, v.shape, mesh, dp)))
            for k, v in fake_tensors(batch).items()}

    if shape.kind == "train":
        ostate = opt.init(params)
        batch = placed_batch(S.train_batch_specs(cfg, shape))
        fn = St.make_train_step(cfg, opt.OptConfig(), tensor_parallel=True)
        out_sh = (pshard, {"m": pshard, "v": pshard, "step": rep},
                  {"grad_norm": rep, "lr": rep, "loss": rep})
        return fn, (params, ostate, batch), out_sh

    lshard = shd.NamedSharding(
        mesh, shd.logits_spec(cfg, shape.global_batch, mesh))
    cache = S.cache_specs_struct(cfg, shape)
    cshard = shd.to_shardings(shd.cache_specs(cache, mesh, dp), mesh)
    if shape.kind == "prefill":
        batch = placed_batch(S.prefill_batch_specs(cfg, shape))
        return St.make_prefill_step(cfg), (params, batch), (lshard, cshard)
    # decode: the cache is at context length ``seq_len``, which the step
    # is given from the host (it reads no length off the device)
    cache = shd.distribute(fake_tensors(cache), cshard)
    tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32)
    tokens = shd.place(tokens, shd.NamedSharding(
        mesh, shd.batch_spec("tokens", tokens.shape, mesh, dp)))
    fn = functools.partial(St.make_decode_step(cfg), kv_len=shape.seq_len)
    return fn, (params, cache, tokens), (lshard, cshard)


def build_cell(arch: str, shape_name: str, mesh, quant_bits: int = 16,
               cfg=None):
    """Returns (fn, args, out_shardings): the cell's step, its inputs
    placed on ``mesh`` (fake tensors: call under a ``FakeTensorMode``)
    and the shardings its outputs take.  ``cfg`` replaces the arch's
    config (JAX's rules of :func:`cell_config` still apply)."""
    shape = SHAPES[shape_name]
    cfg = cell_config(cfg if cfg is not None else get_config(arch), shape,
                      quant_bits)
    return place_cell(cfg, shape, mesh)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant_bits: int = 16, force: bool = False) -> dict:
    return run_cell_cfg(None, arch, shape_name, multi_pod=multi_pod,
                        quant_bits=quant_bits, force=force)


def run_cell_cfg(cfg, arch: str, shape_name: str, *, tag_suffix: str = "",
                 multi_pod: bool = False, quant_bits: int = 16,
                 force: bool = False) -> dict:
    """Build and walk one cell (optionally with a modified cfg, e.g. the
    depth-1/2 variants of the roofline differential or a perf
    experiment).  A cell that fails records ``ok: false`` with the error
    and the traceback's tail, and does not raise."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_tag}" + (
        f"__w{quant_bits}" if quant_bits != 16 else "") + tag_suffix
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    cache_file = RESULTS_DIR / f"{tag}.json"
    if cache_file.exists() and not force:
        cached = json.loads(cache_file.read_text())
        # never reuse failures or records from an older schema
        if cached.get("ok") and cached.get("schema") == SCHEMA:
            return cached

    t0 = time.time()
    rec = {"cell": tag, "arch": arch, "shape": shape_name, "mesh": mesh_tag,
           "quant_bits": quant_bits}
    try:
        mesh = fake_world(multi_pod=multi_pod)
        with FakeTensorMode():
            fn, args, out_sh = build_cell(arch, shape_name, mesh,
                                          quant_bits, cfg=cfg)
            t_lower = time.time() - t0
            out, counts = count_step(fn, args)
            t_compile = time.time() - t0 - t_lower
            check_placed(out, out_sh)
        rec.update(counts)
        rec["schema"] = SCHEMA
        rec["n_devices"] = int(mesh.size())
        rec["lower_s"] = round(t_lower, 1)
        rec["compile_s"] = round(t_compile, 1)
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["wall_s"] = round(time.time() - t0, 1)
    cache_file.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant-bits", type=int, default=16)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="derive roofline terms (global FLOPs on meta "
                         "tensors + the full-depth walk)")
    args = ap.parse_args(argv)

    if args.roofline:
        from repro_torch.perfmodel.roofline import roofline_cell

        cells = ([(args.arch, args.shape)] if args.arch else
                 [(a, s) for a in ARCH_IDS for s in supported_shapes(a)])
        out_dir = RESULTS_DIR.parent / "roofline"
        out_dir.mkdir(parents=True, exist_ok=True)
        for arch, shp in cells:
            rec = roofline_cell(arch, shp, multi_pod=args.multi_pod,
                                quant_bits=args.quant_bits, force=args.force)
            small = {k: v for k, v in rec.items()
                     if k not in ("depth1", "depth2")}
            name = f"{arch}__{shp}__{'2x16x16' if args.multi_pod else '16x16'}"
            if args.quant_bits != 16:
                name += f"__w{args.quant_bits}"
            (out_dir / f"{name}.json").write_text(
                json.dumps(small, indent=2))
            if rec.get("ok"):
                print(f"[ROOF] {arch:24s} {shp:12s} "
                      f"comp={rec['compute_s']:.4f}s mem={rec['memory_s']:.4f}s "
                      f"coll={rec['collective_s']:.4f}s -> {rec['bottleneck']}"
                      f" frac={rec['roofline_fraction']:.2f}", flush=True)
            else:
                print(f"[ROOF-FAIL] {arch} {shp}: {rec.get('error')}",
                      flush=True)
        return

    if args.all:
        cells = [(arch, shp) for arch in ARCH_IDS
                 for shp in supported_shapes(arch)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_ok = 0
    for arch, shp in cells:
        for mp in meshes:
            rec = run_cell(arch, shp, multi_pod=mp,
                           quant_bits=args.quant_bits, force=args.force)
            status = "OK " if rec["ok"] else "FAIL"
            print(f"[{status}] {rec['cell']:56s} "
                  f"flops/dev={rec.get('flops_per_device', -1):.3e} "
                  f"coll={rec.get('collective_bytes', {}).get('total', 0):.3e} "
                  f"wall={rec['wall_s']}s", flush=True)
            if not rec["ok"]:
                print("   ", rec["error"], flush=True)
            n_ok += rec["ok"]
    print(f"{n_ok} cells OK")


if __name__ == "__main__":
    main()
