"""Model registry: uniform init / loss / prefill / decode per family.

Port of ``repro.models.api`` for the decoder-only families the port has
(dense, with QAT fake-quant, the spiking FFN and remat).  ``loss_fn`` is
differentiable with ``torch.autograd``.  The audio family and the
families ``transformer`` leaves out (MoE, SSM, hybrid, VLM) raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    init: Callable[..., Any]             # (seed, device=) -> params
    loss_fn: Callable[..., Any]          # (params, batch) -> scalar loss
    prefill: Callable[..., Any]          # (params, batch) -> (logits, cache)
    decode_step: Callable[..., Any]      # (params, cache, tokens) -> ...
    init_cache: Optional[Callable[..., Any]] = None


def get_model(cfg: ArchConfig) -> ModelBundle:
    transformer.check_supported(cfg)
    return ModelBundle(
        init=lambda seed, device="cuda": transformer.init(seed, cfg,
                                                          device=device),
        loss_fn=lambda params, batch: transformer.loss_fn(params, cfg,
                                                          batch),
        prefill=lambda params, batch: transformer.prefill(
            params, cfg, batch["tokens"], batch.get("vision_embeds")),
        decode_step=lambda params, cache, tokens, **kw:
            transformer.decode_step(params, cfg, cache, tokens, **kw),
        init_cache=lambda batch_size, max_len, device="cuda":
            transformer.init_cache(cfg, batch_size, max_len, device=device),
    )
