"""AdamW + schedules on nested dict/list trees of tensors.

Port of ``repro.train.optimizer``.  This is not ``torch.optim.AdamW``:
the gradient is clipped by its global norm first (scale
``min(1, clip / (gnorm + 1e-9))``), the step is ``mh / (sqrt(vh) + eps)``
from bias-corrected moments, decoupled weight decay joins the step on
tensors with ``ndim >= 2`` only, and ``lr`` is ``schedule(step + 1)``.
There is no float32 master copy: a bfloat16 param is updated in float32
and cast back, as the JAX package does.  :func:`update` works in place
(params, ``m`` and ``v``) under ``torch.no_grad()``, each elementwise
operation in JAX's order, in float32.

The moments have the params' tree structure, so they live on the
params' device; ``step`` is a 0-d int32 tensor beside them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, map_tree


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
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)[0]
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in leaves(tree)))


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

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

    map_tree(upd, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
