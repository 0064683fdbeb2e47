"""Step functions: one optimizer step, one prefill, one decode step.

Port of ``repro.launch.steps``.  Params and optimizer state are the
port's trees of tensors; the train step updates them in place (and
returns them, with JAX's signature).
"""

from __future__ import annotations

import torch

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
        for p in flat:
            p.requires_grad_(True)
        loss = mb.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        return loss.detach(), unflatten_like(params, list(grads))

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            split = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                  *v.shape[1:]) for k, v in batch.items()}
            grads = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
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
