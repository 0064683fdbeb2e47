"""AdamW + schedules on nested dict/list trees of tensors.

Port of ``repro.train.optimizer``.  This is not ``torch.optim.AdamW``:
the gradient is clipped by its global norm first (scale
``min(1, clip / (gnorm + 1e-9))``), the step is ``mh / (sqrt(vh) + eps)``
from bias-corrected moments, decoupled weight decay joins the step on
the leaves whose JAX counterpart has ``ndim >= 2`` (:func:`decays`), and
``lr`` is ``schedule(step + 1)``.
There is no float32 master copy: a bfloat16 param is updated in float32
and cast back, as the JAX package does.  :func:`update` works in place
(params, ``m`` and ``v``) under ``torch.no_grad()``, each elementwise
operation in JAX's order, in float32.

The moments have the params' tree structure, so they live on the
params' device; ``step`` is a 0-d int32 tensor beside them.

Params placed on a mesh (DTensors, ``distributed.sharding``) get
DTensor moments with their placements.  :func:`update` then takes the
gradient norm over the whole tensors (one all-reduce a leaf) and
updates each rank's shards of params, gradients and moments in place:
the step is elementwise, so a shard needs nothing from other ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.convert import LAYER_STACKS
from repro_torch.tree import leaves, leaves_with_path, map_tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params) -> dict:
    """Zero float32 moments shaped, placed and laid out as the params:
    ``meta`` params give ``meta`` moments, a DTensor param a DTensor
    moment with its placements."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    first = leaves(params)[0]
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view), a plain tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _sq_sum(g: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(g.to(torch.float32)))
    return s.full_tensor() if isinstance(s, DTensor) else s


def decays(path, p: torch.Tensor) -> bool:
    """Whether AdamW decays the leaf ``p`` at ``path``: JAX decays a
    leaf of ``ndim >= 2``, and stacks each layer's params into ``(L,
    ...)`` leaves (the decoder layers of every LM family, whisper's
    encoder and decoder layers: ``convert.LAYER_STACKS``), where the
    port keeps a list of per-layer leaves.  A leaf in such a list counts
    one dim more, so a layer's ``(d,)`` norm scales and biases decay and
    a per-layer scalar does not."""
    stacked = (len(path) > 1 and path[0] in LAYER_STACKS
               and isinstance(path[1], int))
    return p.ndim + stacked >= 2


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_sq_sum(g) for g in leaves(tree)))


@torch.no_grad()
def update(grads, state: dict, params, cfg: OptConfig
           ) -> Tuple[Any, dict, dict]:
    """One AdamW step.  Returns (params, state, metrics), the first two
    the same trees as passed, updated in place."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, step_f)
    bc2 = 1 - torch.pow(b2, step_f)

    def upd(p, g, m, v, decay):
        p, g, m, v = _local(p), _local(g), _local(m), _local(v)
        g = g.to(torch.float32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decay:  # decoupled weight decay on JAX's matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

    for (path, p), g, m, v in zip(leaves_with_path(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"])):
        upd(p, g, m, v, decays(path, p))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
