"""Step functions: one optimizer step, one prefill, one decode step.

Port of ``repro.launch.steps``.  Params and optimizer state are the
port's trees of tensors; the train step updates them in place (and
returns them, with JAX's signature).

The train step also runs on params, moments and a batch placed on a
mesh (DTensors, ``distributed.sharding.distribute``): the counterpart of
JAX's pjit'd step.  It is FSDP over DTensor: each param is all-gathered
(``full_tensor``), the loss and its gradient are computed on the rank's
batch shard, and each gradient is reduce-scattered (summed over the mesh
dims the batch is split on, in float32) into its param's placements,
where AdamW updates the shards.  Each rank's loss is weighted by its
share of the global label count, so the summed loss and gradient are
those of the global batch.  The ``model`` axis holds shards but does
not split the compute: the forward runs on whole params.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import get_model
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, map_tree, unflatten_like


def make_train_step(cfg: ArchConfig, opt_cfg: opt.OptConfig,
                    grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``batch`` holds tensors on the params' device.  grad_accum > 1 splits
    it into microbatches run one after another; their gradients are
    summed in float32 and divided by ``grad_accum``, as are their losses
    (JAX's ``lax.scan`` over the microbatches).  A param the loss does not
    reach (a GLU's ``wg`` under the spiking FFN) gets a zero gradient, as
    ``jax.grad`` gives it.
    """
    mb = get_model(cfg)

    def value_and_grad(params, batch):
        flat = leaves(params)
        if isinstance(flat[0], DTensor):
            return _sharded_value_and_grad(mb, params, batch)
        for p in flat:
            p.requires_grad_(True)
        loss = mb.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return loss.detach(), unflatten_like(params, list(grads))

    def train_step(params, opt_state, batch):
        if grad_accum > 1 and isinstance(leaves(params)[0], DTensor):
            raise NotImplementedError("grad_accum > 1 on a mesh")
        if grad_accum == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            split = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = map_tree(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(grad_accum):
                loss_i, g = value_and_grad(
                    params, {k: v[i] for k, v in split.items()})
                map_tree(lambda acc, gi: acc.add_(gi), grads, g)
                lsum = lsum + loss_i
            grads = map_tree(lambda acc: acc / grad_accum, grads)
            loss = lsum / grad_accum
        params, opt_state, metrics = opt.update(grads, opt_state, params,
                                                opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def _sharded_value_and_grad(mb, params, batch):
    """(global loss, gradients placed as the params) of DTensor params on
    a DTensor batch split along its first dim."""
    flat = leaves(params)
    mesh = flat[0].device_mesh
    full = [p.full_tensor().detach().requires_grad_(True) for p in flat]
    local = {k: v.to_local() for k, v in batch.items()}
    # the batch's data dims: there, gradients and counts are partial sums
    split = next(iter(batch.values())).placements
    partial = [Partial() if pl.is_shard(0) else Replicate() for pl in split]

    def summed(t):
        return DTensor.from_local(t, mesh, partial,
                                  run_check=False).full_tensor()

    count = torch.sum(local["labels"] >= 0).to(torch.float32)
    share = count / torch.clamp_min(summed(count), 1.0)
    loss = mb.loss_fn(unflatten_like(params, full), local) * share
    grads = torch.autograd.grad(loss, full, materialize_grads=True)
    placed = [DTensor.from_local(g.to(torch.float32), mesh, partial,
                                 run_check=False)
              .redistribute(mesh, p.placements)
              for g, p in zip(grads, flat)]
    return summed(loss.detach()), unflatten_like(params, placed)


def make_prefill_step(cfg: ArchConfig):
    mb = get_model(cfg)

    def prefill_step(params, batch):
        return mb.prefill(params, batch)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    mb = get_model(cfg)

    def decode_step(params, cache, tokens):
        return mb.decode_step(params, cache, tokens)

    return decode_step
