"""Batched LM serving engine: prefill/decode with slot-based continuous
batching.

Port of ``repro.serve.engine``.  A fixed pool of B slots shares one
stacked cache.  New requests are prefilled one at a time (their
per-layer K/V written into the free slot's batch row, zero-padded to
``max_len``, and an SSM layer's conv inputs and state beside them); the
decode loop advances ALL live slots each step (one ragged
``decode_step`` over the batch), retiring slots on EOS/length and
refilling them from the queue.

Sampling is greedy (``temperature=0``, the first maximal logit, as
``argmax`` in both frameworks) or from ``softmax(logits / temperature)``
with a ``torch.Generator`` seeded from ``EngineConfig.seed`` on the
engine's device (so not JAX's draws).  ``keep_logits=True`` keeps each
request's float32 logits at every sampled position in ``Request.logits``
(on the host), for checks against a reference path.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.api import get_model


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    latency_s: float = 0.0
    logits: Optional[List[np.ndarray]] = None   # with keep_logits


@dataclasses.dataclass
class EngineConfig:
    slots: int = 4
    max_len: int = 512
    temperature: float = 0.0         # 0 = greedy
    seed: int = 0
    keep_logits: bool = False


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params, ecfg: EngineConfig,
                 device="cuda"):
        if cfg.family == "audio":
            raise NotImplementedError("engine serves decoder-only archs")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.mb = get_model(cfg)
        self.queue: deque = deque()
        self.done: Dict[int, Request] = {}

        b, m = ecfg.slots, ecfg.max_len
        self.cache = transformer.init_cache(cfg, b, m, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * b
        self.slot_pos = np.zeros(b, np.int32)     # tokens generated so far
        self.slot_len = np.zeros(b, np.int32)     # prompt+generated length
        self.last_token = np.zeros(b, np.int32)
        self._gen = torch.Generator(device=self.device).manual_seed(
            ecfg.seed)

    # -- request plumbing -----------------------------------------------------

    def add_request(self, req: Request):
        self.queue.append(req)

    def _write_slot_cache(self, slot: int, pcache, plen: int):
        """Insert a single-request prefill cache into the pool at ``slot``:
        its K/V zero past the prompt, as JAX pads it, and an SSM layer's
        conv inputs and state as they are."""
        for k in ("k", "v"):
            if k in self.cache:
                src = pcache[k]                    # (L, 1, S, K, hd)
                dst = self.cache[k]
                dst[:, slot].zero_()
                dst[:, slot, :src.shape[2]] = src[:, 0]
        for k in ("conv", "ssm"):
            if k in self.cache:
                self.cache[k][:, slot] = pcache[k][:, 0]
        self.cache["len"][slot] = plen

    def _admit(self):
        for slot in range(self.ecfg.slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                req._t0 = time.perf_counter()
                toks = torch.as_tensor(req.prompt[None, :],
                                       dtype=torch.int64, device=self.device)
                logits, pcache = self.mb.prefill(self.params,
                                                 {"tokens": toks})
                self._write_slot_cache(slot, pcache, len(req.prompt))
                tok = int(self._sample(logits)[0])
                req.output = [tok]
                if self.ecfg.keep_logits:
                    req.logits = [logits[0].cpu().numpy()]
                # the prefill-produced first token may itself be EOS
                if ((req.eos_id is not None and tok == req.eos_id)
                        or req.max_new_tokens <= 1):
                    req.latency_s = time.perf_counter() - req._t0
                    self.done[req.uid] = req
                    continue
                self.slot_req[slot] = req
                self.slot_pos[slot] = 1
                self.slot_len[slot] = len(req.prompt) + 1
                self.last_token[slot] = tok

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, -1).cpu().numpy()
        probs = torch.softmax(logits.float() / self.ecfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    # -- main loop -------------------------------------------------------------

    def step(self) -> int:
        """One decode step over all live slots.  Returns #live slots."""
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return 0
        toks = torch.as_tensor(self.last_token[:, None], dtype=torch.int64,
                               device=self.device)
        logits, self.cache = self.mb.decode_step(
            self.params, self.cache, toks, ragged=True)
        next_tok = self._sample(logits)
        kept = logits.cpu().numpy() if self.ecfg.keep_logits else None
        for slot in live:
            req = self.slot_req[slot]
            tok = int(next_tok[slot])
            req.output.append(tok)
            if kept is not None:
                req.logits.append(kept[slot])
            self.slot_pos[slot] += 1
            self.slot_len[slot] += 1
            self.last_token[slot] = tok
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if (self.slot_pos[slot] >= req.max_new_tokens or hit_eos
                    or self.slot_len[slot] >= self.ecfg.max_len):
                req.latency_s = time.perf_counter() - req._t0
                self.done[req.uid] = req
                self.slot_req[slot] = None
        return len([r for r in self.slot_req if r is not None])

    def run_until_done(self, max_steps: int = 10_000) -> dict:
        t0 = time.perf_counter()
        n_decode = 0
        for _ in range(max_steps):
            self._admit()
            if not any(r is not None for r in self.slot_req) \
                    and not self.queue:
                break
            n_decode += 1
            self.step()
        wall = time.perf_counter() - t0
        toks = sum(len(r.output or []) for r in self.done.values())
        # max_steps exhausted with work left = truncated stream; flag it
        incomplete = bool(self.queue) or any(
            r is not None for r in self.slot_req)
        return {
            "requests": len(self.done),
            "generated_tokens": toks,
            "wall_s": wall,
            "tokens_per_s": toks / max(wall, 1e-9),
            "decode_steps": n_decode,
            "incomplete": incomplete,
        }
