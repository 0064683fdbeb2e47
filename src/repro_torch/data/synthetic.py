"""Deterministic synthetic data — replayable by (seed, step) for restarts.

A copy of ``repro.data.synthetic`` (numpy only): the same (seed, step,
host) gives the same arrays bit for bit in both packages.

No datasets ship offline, so two generators stand in:

* LM token streams: Zipf-ish token draws from a counter-based RNG
  (Philox keyed by (seed, step, host)) — a restart at step k regenerates
  byte-identical batches, which is what makes checkpoint/restart exact.
* Structured vision set for the SNN benchmark: class prototypes in a
  random frequency basis + noise, mapped to [0,1] images.  Linearly
  separable enough to show the INT8≈FP32 / graceful INT4/INT2 trend the
  paper reports (Fig. 4/5) without CIFAR.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _rng(seed: int, step: int, host: int = 0) -> np.random.Generator:
    # counter-based: (seed, step, host) -> 2x64-bit Philox key, so any
    # (step, host) batch is regenerable after a restart
    key = [(seed << 32) ^ step, host]
    return np.random.Generator(np.random.Philox(key=key))


# ---------------------------------------------------------------------------
# LM streams
# ---------------------------------------------------------------------------

def lm_batch(
    vocab: int, batch: int, seq: int, *, seed: int = 0, step: int = 0,
    host: int = 0, zipf_a: float = 1.3,
) -> Dict[str, np.ndarray]:
    g = _rng(seed, step, host)
    toks = g.zipf(zipf_a, size=(batch, seq + 1)) % vocab
    toks = toks.astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def lm_iterator(vocab: int, batch: int, seq: int, *, seed: int = 0,
                start_step: int = 0, host: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield lm_batch(vocab, batch, seq, seed=seed, step=step, host=host)
        step += 1


# ---------------------------------------------------------------------------
# SNN vision set (the Fig. 4/5 reproduction task)
# ---------------------------------------------------------------------------

def make_vision_dataset(
    n_classes: int = 10, img_size: int = 32, channels: int = 3,
    n_train: int = 2048, n_test: int = 512, *, seed: int = 0,
    noise: float = 0.6,
):
    g = _rng(seed, 0)
    d = img_size * img_size * channels
    # prototypes: smooth low-frequency patterns (so conv nets have local
    # structure to exploit), scaled to unit per-pixel std
    freqs = g.normal(size=(n_classes, 8, d)).astype(np.float32)
    basis = np.cumsum(freqs, axis=-1)  # brownian-ish smooth patterns
    protos = basis.sum(axis=1)
    protos -= protos.mean(axis=-1, keepdims=True)
    protos /= protos.std(axis=-1, keepdims=True) + 1e-8

    def sample(n, part_seed):
        gg = _rng(seed, part_seed)
        y = gg.integers(0, n_classes, size=n).astype(np.int32)
        x = protos[y] + noise * gg.normal(size=(n, d)).astype(np.float32)
        # global affine map into [0,1] (same transform for every sample —
        # per-sample min/max would destroy the class signal)
        x = np.clip((x + 3.0) / 6.0, 0.0, 1.0)
        return x.reshape(n, img_size, img_size, channels).astype(np.float32), y

    x_tr, y_tr = sample(n_train, 1)
    x_te, y_te = sample(n_test, 2)
    return (x_tr, y_tr), (x_te, y_te)


def vision_batches(x, y, batch: int, *, seed: int = 0,
                   start_step: int = 0) -> Iterator[dict]:
    n = x.shape[0]
    step = start_step
    while True:
        g = _rng(seed, step, 1)
        idx = g.integers(0, n, size=batch)
        yield {"images": x[idx], "labels": y[idx]}
        step += 1
