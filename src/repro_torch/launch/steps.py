"""Step functions: one optimizer step, one prefill, one decode step.

Port of ``repro.launch.steps``.  Params and optimizer state are the
port's trees of tensors; the train step updates them in place (and
returns them, with JAX's signature).

The train step also runs on params, moments and a batch placed on a
mesh (DTensors, ``distributed.sharding.distribute``): the counterpart of
JAX's pjit'd step, on one of two routes (:func:`_sharded_value_and_grad`):

* tensor-parallel (``make_train_step(tensor_parallel=True)``, which the
  dry run and ``chip_smoke.py`` ask for), for every family (olmo-1b,
  stablelm-1.6b, gemma2-2b, internlm2-20b, paligemma-3b,
  granite-moe-3b-a800m, moonshot-v1-16b-a3b, mamba2-1.3b, hymba-1.5b,
  whisper-base): each param is gathered over the batch's mesh dims and
  keeps its ``model`` split, and the loss runs on the rank's shards
  through ``distributed.tensor_parallel`` (column/row-parallel linears,
  head-split attention, whisper's cross-attention among them, experts
  split on ``d_ff_expert``, the Mamba-2 mixer's heads split,
  vocab-split embedding and cross-entropy), as XLA's partitioner
  splits JAX's step;
* FSDP, for meshes without ``model`` and every family without
  ``tensor_parallel=True``: each param is gathered whole and the whole
  loss runs on every rank, so every rank's forward is the unsharded
  step's, bit for bit, on its rows (but for the MoE aux loss's batch
  means, below).  A split contraction rounds otherwise: on a (1, 1)
  mesh the two routes are bit-equal, on a split ``model`` axis they
  differ by float32 rounding, as a float64 step differs from a float32
  one.

On both, the loss and its gradient are computed on the rank's batch
shard, and each gradient is reduce-scattered (summed over the mesh dims
the batch is split on, in float32, never over ``model``, whose ranks
see the same rows) into its param's placements, where AdamW updates
the shards.  Each rank's loss is weighted by its share of the global
label count, so the summed loss and gradient are those of the global
batch; the MoE aux loss, a product of two batch means, takes its means
over the global batch on both routes (``moe.batch_mean``).
``grad_accum`` runs on a mesh too (:func:`_microbatches`).

The prefill and decode steps take DTensor params too (JAX's dry run
pjits all three kinds of step), forward only (:func:`_sharded_prefill`,
:func:`_sharded_decode`).  They need no flag: with no AdamW after them
there is no rounding to keep bit-equal, so they take the
tensor-parallel route wherever the mesh allows it
(``tensor_parallel.for_step`` is not ``None``), and FSDP elsewhere:

* tensor-parallel, for every family on a mesh with ``model``: each
  param keeps its ``model`` split, as in the train step, the model runs
  on the rank's shards and the KV cache stays where
  ``sharding.cache_entry_spec`` puts ``model``: split by KV heads, by
  sequence or whole (``distributed.tensor_parallel``'s three cache
  routes), each of whisper's two caches on the route its own shape
  takes (``k``/``v`` the prompt's, ``xk``/``xv`` the encoder's
  ``T_enc`` positions); the logits come out vocab-split.  A packed (INT4) cache
  split by sequence is the one exception: a decode step gathers each
  of its layers over ``model`` (:class:`_LayerRows`) and attends whole,
  as ``kv_attention`` returns no log-sum-exp to merge.  A Mamba-2
  layer's state is the rank's heads' where they split and its conv
  inputs are whole on the rank (:func:`_model_at`); an entry whose
  spec splits it otherwise (the conv inputs' contiguous channel split,
  a state split on ``hp``) is read through :class:`_LayerRows`;
* FSDP, on a mesh without ``model``, as in the train step: every param
  gathered whole and the whole model on the rank's rows; a decode step
  gathers each cache layer over the mesh for its rows.

Either way the outputs are placed as JAX's dry run's out shardings
say, with no gather where the rank's layout already is the spec's.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.tensor_parallel import for_step as tp_for_step
from repro_torch.distributed.tensor_parallel import mean_over
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import moe
from repro_torch.models.api import get_model
from repro_torch.train import optimizer as opt
from repro_torch.tree import (
    leaves,
    leaves_with_path,
    map_tree,
    unflatten_like,
)


def make_train_step(cfg: ArchConfig, opt_cfg: opt.OptConfig,
                    grad_accum: int = 1, *, tensor_parallel: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` holds tensors on the params' device.  grad_accum > 1 splits
    it into microbatches run one after another; their gradients are
    summed in float32 and divided by ``grad_accum``, as are their losses
    (JAX's ``lax.scan`` over the microbatches), on a mesh as without
    one.  A param the loss does not reach (a GLU's ``wg`` under the
    spiking FFN) gets a zero gradient, as ``jax.grad`` gives it.
    ``tensor_parallel`` picks the route on a mesh (module docstring).
    """
    mb = get_model(cfg)

    def value_and_grad(params, batch):
        flat = leaves(params)
        if isinstance(flat[0], DTensor):
            return _sharded_value_and_grad(mb, cfg, params, batch,
                                           tensor_parallel)
        for p in flat:
            p.requires_grad_(True)
        loss = mb.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return loss.detach(), unflatten_like(params, list(grads))

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            grads = map_tree(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for micro in _microbatches(batch, grad_accum):
                loss_i, g = value_and_grad(params, micro)
                map_tree(lambda acc, gi: acc.add_(gi), grads, g)
                lsum = lsum + loss_i
            grads = map_tree(lambda acc: acc / grad_accum, grads)
            loss = lsum / grad_accum
        params, opt_state, metrics = opt.update(grads, opt_state, params,
                                                opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _microbatches(batch, n: int) -> list:
    """``batch`` split into ``n`` microbatches of consecutive rows, as
    JAX's ``reshape(n, B // n, ...)`` splits it: microbatch ``i`` holds
    the global rows ``[i * B / n, (i + 1) * B / n)``.  A placed batch is
    gathered (it is small beside the params) and each microbatch placed
    as the batch was, so a rank's microbatch rows are not its own rows
    of the batch: splitting those would pair other rows in a microbatch,
    and a microbatch's loss is a mean over its own labels."""
    def split(v):
        whole = v.full_tensor() if isinstance(v, DTensor) else v
        parts = whole.reshape(n, whole.shape[0] // n, *whole.shape[1:])
        if not isinstance(v, DTensor):
            return list(parts)
        return [distribute_tensor(t, v.device_mesh, v.placements,
                                  src_data_rank=None) for t in parts]

    cut = {k: split(v) for k, v in batch.items()}
    return [{k: parts[i] for k, parts in cut.items()} for i in range(n)]


def _sharded_value_and_grad(mb, cfg, params, batch, split_model=False):
    """(global loss, gradients placed as the params) of DTensor params on
    a DTensor batch split along its first dim, on the route the module
    docstring gives ``cfg``'s family (``split_model``: tensor-parallel
    where the family takes it)."""
    flat = leaves(params)
    mesh = flat[0].device_mesh
    tp = tp_for_step(cfg, mesh) if split_model else None
    # the batch's data dims: there, gradients and counts are partial sums
    split = next(iter(batch.values())).placements
    partial = [Partial() if pl.is_shard(0) else Replicate() for pl in split]
    back = []
    for path, _ in leaves_with_path(params):
        b = tp.placements(path)[1] if tp is not None else Replicate()
        back.append([b if _is_model(mesh, i) else pl
                     for i, pl in enumerate(partial)])
    held = [p.detach().requires_grad_(True)
            for p in _held(params, mesh, tp)]
    local = {k: v.to_local() for k, v in batch.items()}

    def summed(t):
        return DTensor.from_local(t, mesh, partial,
                                  run_check=False).full_tensor()

    count = torch.sum(local["labels"] >= 0).to(torch.float32)
    share = count / torch.clamp_min(summed(count), 1.0)
    tree = unflatten_like(params, held)
    # the MoE aux loss's batch means over the global batch, in the
    # forward and in remat's recompute during the backward
    with moe.batch_mean(mean_over(mesh, [
            i for i, pl in enumerate(split) if pl.is_shard(0)])):
        loss = mb.loss_fn(tree, local, tp=tp) * share
        grads = torch.autograd.grad(loss, held, materialize_grads=True)
    placed = [DTensor.from_local(g.to(torch.float32), mesh, pl,
                                 run_check=False)
              .redistribute(mesh, p.placements)
              for g, p, pl in zip(grads, flat, back)]
    return summed(loss.detach()), unflatten_like(params, placed)


def _is_model(mesh, i: int) -> bool:
    """Whether mesh dim ``i`` is the ``model`` axis."""
    return (mesh.mesh_dim_names or (None,) * mesh.ndim)[i] == "model"


def _held(params, mesh, tp) -> list:
    """Each param's local tensor for a sharded step's forward: gathered
    whole (``tp`` ``None``: FSDP), or split over ``model`` as
    ``tp.placements`` says and gathered over the mesh's other dims."""
    held = []
    for path, p in leaves_with_path(params):
        f = tp.placements(path)[0] if tp is not None else Replicate()
        want = tuple(f if _is_model(mesh, i) else Replicate()
                     for i in range(mesh.ndim))
        # a param placed as the step holds it needs no redistribution
        held.append(p.to_local() if tuple(p.placements) == want else
                    p.redistribute(mesh, want).to_local())
    return held


def make_prefill_step(cfg: ArchConfig):
    """(params, batch) -> (last-token logits, cache).  On DTensor params
    see :func:`_sharded_prefill`."""
    mb = get_model(cfg)

    def prefill_step(params, batch):
        if isinstance(leaves(params)[0], DTensor):
            return _sharded_prefill(mb, cfg, params, batch)
        return mb.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """(params, cache, tokens, kv_len=None) -> (logits, cache), the cache
    written in place; ``kv_len`` as in ``transformer.decode_step``.  On
    DTensor params see :func:`_sharded_decode`."""
    mb = get_model(cfg)

    def decode_step(params, cache, tokens, kv_len=None):
        if isinstance(leaves(params)[0], DTensor):
            return _sharded_decode(mb, cfg, params, cache, tokens, kv_len)
        return mb.decode_step(params, cache, tokens, kv_len=kv_len)

    return decode_step


# --- the serve steps on a mesh -----------------------------------------------
# Both routes run on the rank's batch rows (the batch's or the tokens'
# dim-0 placements) and place the outputs as JAX's dry run's out
# shardings say: logits by ``sharding.logits_spec``, the cache by
# ``sharding.cache_specs``.  On the FSDP route the ``model`` axis splits
# the cache, not the compute: where a cache spec shards heads or
# sequence, a decode step gathers those dims for its rows, one layer at
# a time (:class:`_LayerRows`).  On the tensor-parallel route the rank
# computes on its share of the cache where it lies.


def _rows_at(rows, dim: int, model=None, mesh=None) -> tuple:
    """Placements of the rank's batch rows with the batch at ``dim``:
    ``Shard(dim)`` on each mesh dim that ``rows`` (the batch's
    placements, batch at dim 0) splits dim 0 over, else ``Replicate()``;
    with ``model``, that placement on ``mesh``'s ``model`` dim."""
    at = [Shard(dim) if p.is_shard(0) else Replicate() for p in rows]
    if model is not None:
        at[mesh.mesh_dim_names.index("model")] = model
    return tuple(at)


#: a stacked K/V entry's ``model`` placement on each cache route
_KV_AT = {"heads": Shard(3), "seq": Shard(2), "whole": Replicate()}


def _model_at(tp, key: str):
    """The ``model`` placement of the rank's share of cache entry ``key``
    on the tensor-parallel route: K/V by ``tp.cache``, whisper's cross
    K/V (``xk``/``xv``) by ``tp.xcache``; an SSM state
    ``(L, B, nh, hp, N)`` split by heads where the mixer's heads split,
    else whole; the conv inputs whole (the mixer gathers their x
    channels: their spec's contiguous channel split is not the rank's
    heads')."""
    if key == "ssm":
        return Shard(2) if tp.ssm else Replicate()
    if key == "conv":
        return Replicate()
    return _KV_AT[tp.xcache if key in ("xk", "xv") else tp.cache]


def _kv_route(mesh, shape) -> str:
    """Where ``cache_entry_spec`` puts ``model`` on a stacked K/V entry
    of ``shape`` ``(L, B, S, K, ...)`` (the self or the cross cache: one
    rule): ``"heads"``, ``"seq"`` or ``"whole"``."""
    pl = shd.NamedSharding(mesh, shd.cache_entry_spec(
        "k", shape, mesh, dp_axes(mesh))).placements[
        mesh.mesh_dim_names.index("model")]
    return {3: "heads", 2: "seq"}.get(pl.dim if pl.is_shard() else None,
                                      "whole")


def _place_serve_out(cfg, mesh, rows, logits, cache, tp=None):
    """The rank's rows of logits and cache -> DTensors placed by
    ``logits_spec`` and ``cache_specs``.  ``cache`` maps names to local
    tensors (the batch at dim 1; ``len`` at dim 0, or 0-d) or to
    DTensors already placed, which are kept.  With ``tp``, the logits
    are the rank's vocab slice where the vocab splits and the K/V the
    rank's share (``tp.cache``)."""
    def place(t, placements, spec_of):
        d = DTensor.from_local(t, mesh, placements, run_check=False)
        return d.redistribute(mesh, shd.NamedSharding(
            mesh, spec_of(tuple(d.shape))).placements)

    split = tp is not None
    out_logits = place(logits, _rows_at(
        rows, 0, Shard(1) if split and tp.vocab else None, mesh),
        lambda shape: shd.logits_spec(cfg, shape[0], mesh))
    out = {}
    for key, t in cache.items():
        if isinstance(t, DTensor):
            out[key] = t
            continue
        at = (tuple(Replicate() for _ in rows) if t.ndim == 0 else
              _rows_at(rows, 0) if key == "len" else
              _rows_at(rows, 1, _model_at(tp, key) if split else None,
                       mesh))
        out[key] = place(t, at, lambda shape, key=key: shd.cache_entry_spec(
            key, shape, mesh, dp_axes(mesh)))
    return out_logits, out


def _sharded_prefill(mb, cfg, params, batch):
    """Prefill on DTensor params and batch (placed by
    ``sharding.distribute``) on the rank's batch rows: gathered params,
    or on the tensor-parallel route (where the family and mesh take it)
    the rank's shards emitting its share of the cache; logits
    and cache placed as :func:`_place_serve_out` says."""
    mesh = leaves(params)[0].device_mesh
    first = next(iter(batch.values()))
    rows = first.placements
    local = {k: v.to_local() for k, v in batch.items()}
    tp = tp_for_step(cfg, mesh)
    if tp is None:
        full = unflatten_like(params, _held(params, mesh, None))
        return _place_serve_out(cfg, mesh, rows, *mb.prefill(full, local))
    kv = (cfg.n_kv, cfg.head_dim)
    if not cfg.is_attention_free:
        tp.cache = _kv_route(mesh, (cfg.n_layers, first.shape[0],
                                    batch["tokens"].shape[1]
                                    + cfg.vision_prefix_len) + kv)
    if "frames" in batch:           # whisper's cross cache: T_enc long
        tp.xcache = _kv_route(mesh, (cfg.n_layers, first.shape[0],
                                     batch["frames"].shape[1]) + kv)
    held = unflatten_like(params, _held(params, mesh, tp))
    logits, cache = mb.prefill(held, local, tp=tp)
    return _place_serve_out(cfg, mesh, rows, logits, cache, tp)


def _sharded_decode(mb, cfg, params, cache, tokens, kv_len):
    """One decode step on DTensor params, cache and tokens, on the
    tokens' rows: gathered params and each stacked cache entry seen
    through :class:`_LayerRows`, or on the tensor-parallel route (where
    the family and mesh take it) the rank's shards and
    its share of each entry in place (through :class:`_LayerRows` where
    the entry lies otherwise: a packed cache split by sequence is
    gathered over ``model``); the placed entries are written and
    returned, ``len`` and logits placed by ``cache_specs`` and
    ``logits_spec``."""
    mesh = leaves(params)[0].device_mesh
    rows = tokens.placements
    tp = tp_for_step(cfg, mesh)
    if tp is not None and "k" in cache:
        tp.cache = _kv_route(mesh, tuple(cache["k"].shape))
        if tp.cache == "seq" and "k_scale" in cache:    # packed
            tp.cache = "whole"
    if tp is not None and "xk" in cache:
        tp.xcache = _kv_route(mesh, tuple(cache["xk"].shape))
    held = unflatten_like(params, _held(params, mesh, tp))
    local, stacks = {}, []
    for key, t in cache.items():
        if key == "len":
            local[key] = (t.to_local() if t.ndim == 0 else
                          t.redistribute(mesh, _rows_at(rows, 0)).to_local())
            continue
        at = _rows_at(rows, 1, _model_at(tp, key) if tp is not None else
                      None, mesh)
        if tp is not None and tuple(t.placements) == at:
            local[key] = t.to_local()
        else:
            local[key] = _LayerRows(t, mesh, at)
            stacks.append(local[key])
    logits, new = mb.decode_step(held, local, tokens.to_local(),
                                 kv_len=kv_len, tp=tp)
    for s in stacks:
        s.flush()
    return _place_serve_out(cfg, mesh, rows, logits,
                            {**cache, "len": new["len"]}, tp)


def _drop_dim0(p):
    return Shard(p.dim - 1) if p.is_shard() else p


class _LayerRows:
    """A stacked cache entry ``(L, B, ...)`` placed on a mesh, as a
    decode step sees it: laid out as ``rows`` (stacked placements: the
    rank's batch rows, and on the tensor-parallel route its share over
    ``model``).  Indexing layer ``i`` gathers it (``redistribute`` to
    ``rows``); indexing the next layer, or :meth:`flush`, splits the
    layer back into the placed entry, so one layer at a time is held
    in that layout.  Assigning a layer (an SSM's new state) replaces the
    gathered one."""

    def __init__(self, placed, mesh, rows):
        self.placed, self.mesh = placed, mesh
        self.held = tuple(_drop_dim0(p) for p in placed.placements)
        self.rows = tuple(_drop_dim0(p) for p in rows)
        shape = list(placed.shape)
        for p, n in zip(rows, mesh.shape):
            if p.is_shard():
                shape[p.dim] //= n
        self.shape = torch.Size(shape)
        self._open = None

    def __getitem__(self, i):
        self.flush()
        layer = DTensor.from_local(self.placed.to_local()[i], self.mesh,
                                   self.held, run_check=False)
        self._open = (i, layer.redistribute(self.mesh, self.rows).to_local())
        return self._open[1]

    def __setitem__(self, i, value):
        if self._open is None or self._open[0] != i:
            self.flush()
        self._open = (i, value)

    def flush(self):
        if self._open is None:
            return
        i, whole = self._open
        self._open = None
        part = DTensor.from_local(whole, self.mesh, self.rows,
                                  run_check=False).redistribute(
            self.mesh, self.held).to_local()
        self.placed.to_local()[i].copy_(part)
