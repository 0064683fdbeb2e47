"""Step functions: one optimizer step, one prefill, one decode step.

Port of ``repro.launch.steps``.  Params and optimizer state are the
port's trees of tensors; the train step updates them in place (and
returns them, with JAX's signature).

The train step also runs on params, moments and a batch placed on a
mesh (DTensors, ``distributed.sharding.distribute``): the counterpart of
JAX's pjit'd step, on one of two routes (:func:`_sharded_value_and_grad`):

* tensor-parallel (``make_train_step(tensor_parallel=True)``, which the
  dry run and ``chip_smoke.py`` ask for), for the ``"dense"`` and
  ``"vlm"`` families (olmo-1b, stablelm-1.6b, gemma2-2b, internlm2-20b,
  paligemma-3b): each param is gathered over the batch's mesh dims and
  keeps its ``model`` split, and the loss runs on the rank's shards
  through ``distributed.tensor_parallel`` (column/row-parallel linears,
  head-split attention, vocab-split embedding and cross-entropy), as
  XLA's partitioner splits JAX's step;
* FSDP, for the MoE, SSM, hybrid and audio families (granite-moe,
  moonshot, mamba2, hymba, whisper), meshes without ``model`` and every
  family without ``tensor_parallel=True``: each param is gathered whole
  and the whole loss runs on every rank, so every rank's forward is the
  unsharded step's, bit for bit, on its rows.  A split contraction
  rounds otherwise: on a (1, 1) mesh the two routes are bit-equal, on a
  split ``model`` axis they differ by float32 rounding, as a float64
  step differs from a float32 one.

On both, the loss and its gradient are computed on the rank's batch
shard, and each gradient is reduce-scattered (summed over the mesh dims
the batch is split on, in float32, never over ``model``, whose ranks
see the same rows) into its param's placements, where AdamW updates
the shards.  Each rank's loss is weighted by its share of the global
label count, so the summed loss and gradient are those of the global
batch.  ``grad_accum`` runs on a mesh too (:func:`_microbatches`).

The prefill and decode steps take DTensor params too, in the same
design (:func:`_sharded_prefill`, :func:`_sharded_decode`): JAX's dry
run pjits all three kinds of step.
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
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import transformer
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
    model = (mesh.mesh_dim_names.index("model") if tp is not None
             else None)
    fwd, back = [], []
    for path, _ in leaves_with_path(params):
        f, b = (tp.placements(path) if tp is not None
                else (Replicate(), Replicate()))
        fwd.append([f if i == model else Replicate()
                    for i in range(mesh.ndim)])
        back.append([b if i == model else pl
                     for i, pl in enumerate(partial)])
    held = [p.redistribute(mesh, pl).to_local().detach().requires_grad_(True)
            for p, pl in zip(flat, fwd)]
    local = {k: v.to_local() for k, v in batch.items()}

    def summed(t):
        return DTensor.from_local(t, mesh, partial,
                                  run_check=False).full_tensor()

    count = torch.sum(local["labels"] >= 0).to(torch.float32)
    share = count / torch.clamp_min(summed(count), 1.0)
    tree = unflatten_like(params, held)
    loss = (mb.loss_fn(tree, local) if tp is None else
            transformer.loss_fn(tree, cfg, local, tp=tp)) * share
    grads = torch.autograd.grad(loss, held, materialize_grads=True)
    placed = [DTensor.from_local(g.to(torch.float32), mesh, pl,
                                 run_check=False)
              .redistribute(mesh, p.placements)
              for g, p, pl in zip(grads, flat, back)]
    return summed(loss.detach()), unflatten_like(params, placed)


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
# The train step's FSDP design: every param is all-gathered, the model
# runs whole on the rank's batch rows (the batch's or the tokens' dim-0
# placements), and the outputs are placed as JAX's dry run's out
# shardings say: logits by ``sharding.logits_spec``, the cache by
# ``sharding.cache_specs``.  The ``model`` axis splits the cache, not the
# compute: where a cache spec shards heads or sequence, a decode step
# gathers those dims for its rows, one layer at a time (:class:`_LayerRows`).


def _rows_at(rows, dim: int) -> tuple:
    """Placements of the rank's batch rows with the batch at ``dim``:
    ``Shard(dim)`` on each mesh dim that ``rows`` (the batch's
    placements, batch at dim 0) splits dim 0 over, else ``Replicate()``."""
    return tuple(Shard(dim) if p.is_shard(0) else Replicate() for p in rows)


def _whole(params):
    flat = leaves(params)
    return flat[0].device_mesh, unflatten_like(
        params, [p.full_tensor() for p in flat])


def _place_serve_out(cfg, mesh, rows, logits, cache):
    """The rank's rows of logits and cache -> DTensors placed by
    ``logits_spec`` and ``cache_specs``.  ``cache`` maps names to local
    tensors (the batch at dim 1; ``len`` at dim 0, or 0-d) or to
    DTensors already placed, which are kept."""
    def place(t, placements, spec_of):
        d = DTensor.from_local(t, mesh, placements, run_check=False)
        return d.redistribute(mesh, shd.NamedSharding(
            mesh, spec_of(tuple(d.shape))).placements)

    out_logits = place(logits, _rows_at(rows, 0),
                       lambda shape: shd.logits_spec(cfg, shape[0], mesh))
    out = {}
    for key, t in cache.items():
        if isinstance(t, DTensor):
            out[key] = t
            continue
        at = (tuple(Replicate() for _ in rows) if t.ndim == 0 else
              _rows_at(rows, 0 if key == "len" else 1))
        out[key] = place(t, at, lambda shape, key=key: shd.cache_entry_spec(
            key, shape, mesh, dp_axes(mesh)))
    return out_logits, out


def _sharded_prefill(mb, cfg, params, batch):
    """Prefill on DTensor params and batch (placed by
    ``sharding.distribute``): gathered params, the rank's batch rows,
    logits and cache placed as :func:`_place_serve_out` says."""
    mesh, full = _whole(params)
    rows = next(iter(batch.values())).placements
    logits, cache = mb.prefill(full, {k: v.to_local()
                                      for k, v in batch.items()})
    return _place_serve_out(cfg, mesh, rows, logits, cache)


def _sharded_decode(mb, cfg, params, cache, tokens, kv_len):
    """One decode step on DTensor params, cache and tokens: gathered
    params, the tokens' rows, each stacked cache entry seen through
    :class:`_LayerRows` (written back into the placed entries, which the
    step returns), ``len`` and logits placed by ``cache_specs`` and
    ``logits_spec``."""
    mesh, full = _whole(params)
    rows = tokens.placements
    local, stacks = {}, []
    for key, t in cache.items():
        if key == "len":
            local[key] = (t.to_local() if t.ndim == 0 else
                          t.redistribute(mesh, _rows_at(rows, 0)).to_local())
        else:
            local[key] = _LayerRows(t, mesh, _rows_at(rows, 1))
            stacks.append(local[key])
    logits, new = mb.decode_step(full, local, tokens.to_local(),
                                 kv_len=kv_len)
    for s in stacks:
        s.flush()
    return _place_serve_out(cfg, mesh, rows, logits,
                            {**cache, "len": new["len"]})


def _drop_dim0(p):
    return Shard(p.dim - 1) if p.is_shard() else p


class _LayerRows:
    """A stacked cache entry ``(L, B, ...)`` placed on a mesh, as a
    decode step sees it: the rank's batch rows, every other dim whole.
    Indexing layer ``i`` gathers it (``redistribute`` to ``rows``);
    indexing the next layer, or :meth:`flush`, splits the layer back into
    the placed entry, so one layer at a time is held whole.  Assigning a
    layer (an SSM's new state) replaces the gathered one."""

    def __init__(self, placed, mesh, rows):
        self.placed, self.mesh = placed, mesh
        self.held = tuple(_drop_dim0(p) for p in placed.placements)
        self.rows = tuple(_drop_dim0(p) for p in rows)
        shape = list(placed.shape)
        for p, n in zip(rows, mesh.shape):
            if p.is_shard():
                shape[1] //= n
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
