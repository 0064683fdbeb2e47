"""Meta-device input stand-ins for every (arch x shape) cell.

Port of ``repro.launch.specs``: JAX's ``ShapeDtypeStruct``s become
tensors on the ``meta`` device, which carry a shape and a dtype and
allocate nothing (moonshot-v1-16b-a3b is 28.1 B parameters).  The
modality frontends are stubs: whisper gets frame embeddings, paligemma
patch embeddings.  Params are the port's trees, each layer stack a list
of per-layer dicts; caches keep the stacked ``(L, B, ...)`` layout of
both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer
from repro_torch.models.api import get_model

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        return {
            "frames": _sds((B, S, cfg.d_model), dt),
            "tokens": _sds((B, S), torch.int32),
            "labels": _sds((B, S), torch.int32),
        }
    if cfg.family == "vlm":
        St = S - cfg.vision_prefix_len
        return {
            "tokens": _sds((B, St), torch.int32),
            "vision_embeds": _sds((B, cfg.vision_prefix_len, cfg.d_model),
                                  dt),
            "labels": _sds((B, St), torch.int32),
        }
    return {
        "tokens": _sds((B, S), torch.int32),
        "labels": _sds((B, S), torch.int32),
    }


def prefill_batch_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b = train_batch_specs(cfg, shape)
    b.pop("labels")
    return b


def cache_specs_struct(cfg: ArchConfig, shape: ShapeConfig):
    """Shapes of the serving cache at context length = shape.seq_len."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "audio":
        dt = getattr(torch, cfg.dtype)
        kv = (cfg.n_layers, B, S, cfg.n_kv, cfg.head_dim)
        return {"k": _sds(kv, dt), "v": _sds(kv, dt), "xk": _sds(kv, dt),
                "xv": _sds(kv, dt), "len": _sds((), torch.int32)}
    return transformer.init_cache(cfg, B, S, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All step inputs for the cell (excluding params/opt state)."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape)}
    return {"cache": cache_specs_struct(cfg, shape),
            "tokens": _sds((shape.global_batch, 1), torch.int32)}


def param_specs_struct(cfg: ArchConfig):
    return get_model(cfg).init(0, device=META)


def opt_specs_struct(params_struct):
    from repro_torch.train import optimizer

    return optimizer.init(params_struct)
