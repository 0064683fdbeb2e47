"""Model registry: uniform init / loss / prefill / decode per family.

Port of ``repro.models.api``: every family of ``configs/``.  The audio
family (whisper) is an encoder-decoder with no ``init_cache`` (its
prefill takes ``frames`` and emits the cache); every other family is
the decoder-only :mod:`repro_torch.models.transformer`.  ``loss_fn`` is
differentiable with ``torch.autograd``.  ``loss_fn``, ``prefill`` and
``decode_step`` take ``tp=``, the tensor-parallel context the sharded
steps hand every family's model (``None``: the unsharded model).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer, whisper


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    init: Callable[..., Any]             # (seed, device=) -> params
    loss_fn: Callable[..., Any]          # (params, batch, tp=) -> loss
    prefill: Callable[..., Any]          # (params, batch, tp=) -> (logits,
    #                                      cache)
    decode_step: Callable[..., Any]      # (params, cache, tokens, tp=,
    #                                      kv_len=) -> (logits, cache)
    init_cache: Optional[Callable[..., Any]] = None


def get_model(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "audio":
        return ModelBundle(
            init=lambda seed, device="cuda": whisper.init(seed, cfg,
                                                          device=device),
            loss_fn=lambda params, batch, tp=None: whisper.loss_fn(
                params, cfg, batch, tp=tp),
            prefill=lambda params, batch, tp=None: whisper.prefill(
                params, cfg, batch["tokens"], batch["frames"], tp=tp),
            decode_step=lambda params, cache, tokens, **kw:
                whisper.decode_step(params, cfg, cache, tokens, **kw),
        )
    return ModelBundle(
        init=lambda seed, device="cuda": transformer.init(seed, cfg,
                                                          device=device),
        loss_fn=lambda params, batch, tp=None: transformer.loss_fn(
            params, cfg, batch, tp=tp),
        prefill=lambda params, batch, tp=None: transformer.prefill(
            params, cfg, batch["tokens"], batch.get("vision_embeds"), tp=tp),
        decode_step=lambda params, cache, tokens, **kw:
            transformer.decode_step(params, cfg, cache, tokens, **kw),
        init_cache=lambda batch_size, max_len, device="cuda":
            transformer.init_cache(cfg, batch_size, max_len, device=device),
    )
