"""Decoder-only LM backbone, dense family.

Port of ``repro.models.transformer`` for the dense decoder families
(olmo, stablelm, internlm2, gemma2's local/global alternation with its
soft caps and post-block norms).  ``params["layers"]`` is a list of
per-layer dicts and a Python loop over layers replaces ``jax.lax.scan``,
so each layer's attention window is a Python int.  The KV cache keeps the
JAX package's stacked layout, ``(n_layers, B, S, K, hd)`` (or packed
words and scales when ``kv_cache_bits != 16``), and decode steps write
into it in place (the JAX version returns a new cache; in place saves a
copy of the whole cache per step).

The spiking FFN (``cfg.spiking``) replaces the MLP where it is set, and
``cfg.remat`` recomputes activations in the backward pass of
:func:`forward_hidden`: ``"full"`` checkpoints each layer, ``"dots"``
keeps the matmul outputs of each layer (``aten.mm``/``bmm``/``addmm``,
through ``torch.utils.checkpoint``'s selective checkpointing) and
recomputes the rest, in place of ``jax.checkpoint`` and its
``dots_with_no_batch_dims_saveable`` policy.

Left out, each raising ``NotImplementedError`` where it would be needed:
MoE, SSM and hybrid blocks and the vision prefix.

Forward modes:
  forward_hidden  full sequence (train / prefill), chunked flash-style
                  attention for long sequences
  loss_fn         forward + sequence-chunked cross-entropy; each chunk's
                  (B, chunk, vocab) logits are recomputed in the backward
                  pass instead of being saved
  prefill         forward + KV-cache emission, last-token logits
  decode_step     one token per slot against the cache, ragged (per-slot
                  lengths, the serving engine) or uniform
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.kv_attention import ops as kv_ops
from repro_torch.kernels.kv_attention import ref as kv_ref
from repro_torch.models import layers as L


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` naming the first feature of ``cfg``
    that the port does not have yet."""
    missing = [
        (cfg.family == "audio", "the audio (whisper) family"),
        (cfg.moe is not None, "MoE blocks"),
        (cfg.family == "ssm", "SSM (mamba2) blocks"),
        (cfg.hybrid_parallel_ssm, "hybrid attention + SSM layers"),
        (bool(cfg.vision_prefix_len), "the vision prefix (VLM family)"),
    ]
    for hit, what in missing:
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported to repro_torch yet "
                f"(dense decoder families only)")


def window_schedule(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (0 = global)."""
    w = np.zeros((cfg.n_layers,), np.int32)
    if cfg.local_global_period:
        for i in range(cfg.n_layers):
            if i % cfg.local_global_period == 0:  # even layers local (gemma2)
                w[i] = cfg.sliding_window
    elif cfg.hybrid_parallel_ssm:
        w[:] = cfg.sliding_window or 0
        for i in cfg.global_attn_layers:
            w[i] = 0
    return w


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ArchConfig, device=None):
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "ln1": L.norm_init(cfg.norm, d, dt, device),
        "ln2": L.norm_init(cfg.norm, d, dt, device),
        "attn": {
            "wq": L.linear_init(gen, d, cfg.n_heads * hd, dt, cfg.qkv_bias,
                                device),
            "wk": L.linear_init(gen, d, cfg.n_kv * hd, dt, cfg.qkv_bias,
                                device),
            "wv": L.linear_init(gen, d, cfg.n_kv * hd, dt, cfg.qkv_bias,
                                device),
            "wo": L.linear_init(gen, cfg.n_heads * hd, d, dt, device=device),
        },
    }
    if cfg.d_ff > 0:
        p["mlp"] = L.ffn_init(gen, d, cfg.d_ff, cfg.ffn, dt, device)
    if cfg.post_block_norms:
        p["post_ln1"] = L.norm_init(cfg.norm, d, dt, device)
        p["post_ln2"] = L.norm_init(cfg.norm, d, dt, device)
    return p


def init(seed: int, cfg: ArchConfig, device="cuda"):
    """Random params from ``seed`` on ``device``: the JAX package's shapes
    and scales (embeddings N(0, 0.02), He-normal linears, unit norms),
    drawn from a ``torch.Generator`` (so not JAX's numbers)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = _dtype(cfg)
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=dev)
    params = {
        "embed": (emb * 0.02).to(dt),
        "final_norm": L.norm_init(cfg.norm, cfg.d_model, dt, dev),
        "layers": [init_layer(gen, cfg, dev) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(gen, cfg.d_model, cfg.vocab, dt,
                                          device=dev)
    return params


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------


def _attn_scale(cfg: ArchConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else \
        cfg.head_dim ** -0.5


def _attn_block(lp, cfg: ArchConfig, x, *, window: int, q_offset=0, cache_kv=None, cache_len=None, ragged=False,
                kv_len: Optional[int] = None):
    """Self-attention (full sequence or decode).  Returns (out, (k, v)).

    In decode, ``cache_kv`` holds this layer's cache tensors, which are
    written in place; ``kv_len`` (>= every slot's length) bounds the part
    of a bf16 cache the attention reads (the rest is masked anyway).
    """
    pc, mode = cfg.precision, cfg.quant_mode
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = L.linear(lp["wq"], x, pc, mode).reshape(b, s, cfg.n_heads, hd)
    k = L.linear(lp["wk"], x, pc, mode).reshape(b, s, cfg.n_kv, hd)
    v = L.linear(lp["wv"], x, pc, mode).reshape(b, s, cfg.n_kv, hd)
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    off = torch.as_tensor(q_offset, dtype=torch.int32, device=x.device)
    pos = off[:, None] + ar[None] if off.ndim == 1 else off + ar
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    scale = _attn_scale(cfg)

    if cache_kv is None:
        o = L.attention(q, k, v, scale=scale, causal=True, window=window,
                        logit_cap=cfg.attn_logit_softcap)
    elif cfg.kv_cache_bits != 16:
        if ragged:
            raise NotImplementedError(
                "packed KV cache + ragged slot lengths is not implemented; "
                "serve either with kv_cache_bits=16 or uniform batches")
        kp, ks_, vp, vs_ = cache_kv
        bits = cfg.kv_cache_bits
        lens = torch.as_tensor(cache_len, dtype=torch.int32,
                               device=x.device).reshape(-1)
        ins0 = (lens[:1] - 1).to(torch.int64)       # uniform: one position
        knew, ksc = kv_ref.quantize_kv(k[:, 0], bits)   # (B,K,w), (B,K,1)
        vnew, vsc = kv_ref.quantize_kv(v[:, 0], bits)
        kp.index_copy_(1, ins0, knew[:, None])
        vp.index_copy_(1, ins0, vnew[:, None])
        ks_.index_copy_(1, ins0, ksc[:, None])
        vs_.index_copy_(1, ins0, vsc[:, None])
        o = kv_ops.quant_kv_decode_attention(
            q, kp, ks_, vp, vs_, bits=bits, scale=scale,
            cache_len=cache_len, window=window,
            logit_cap=cfg.attn_logit_softcap)
        o = L.linear(lp["wo"], o.reshape(b, s, cfg.n_heads * hd), pc, mode)
        return o, (kp, ks_, vp, vs_)
    else:
        k_cache, v_cache = cache_kv
        s_len = k_cache.shape[1]
        lens = torch.broadcast_to(
            torch.as_tensor(cache_len, dtype=torch.int32,
                            device=x.device).reshape(-1), (b,))
        if ragged:
            # per-slot insert; a row whose position is past the cache (a
            # retired slot that keeps counting) is dropped, as JAX's
            # scatter drops it
            ins = (lens - 1).to(torch.int64)
            rows = torch.arange(b, device=x.device)
            ok = (ins < s_len)[:, None, None]
            ins_c = torch.clamp(ins, max=s_len - 1)
            k_cache[rows, ins_c] = torch.where(
                ok, k[:, 0].to(k_cache.dtype), k_cache[rows, ins_c])
            v_cache[rows, ins_c] = torch.where(
                ok, v[:, 0].to(v_cache.dtype), v_cache[rows, ins_c])
        else:
            ins0 = (lens[:1] - 1).to(torch.int64)
            k_cache.index_copy_(1, ins0, k.to(k_cache.dtype))
            v_cache.index_copy_(1, ins0, v.to(v_cache.dtype))
        n = s_len if kv_len is None else min(kv_len, s_len)
        o = L.decode_attention(
            q, k_cache[:, :n], v_cache[:, :n], scale=scale,
            cache_len=cache_len, window=window,
            logit_cap=cfg.attn_logit_softcap)
        k, v = k_cache, v_cache
    o = L.linear(lp["wo"], o.reshape(b, s, cfg.n_heads * hd), pc, mode)
    return o, (k, v)


def _mlp_block(lp, cfg: ArchConfig, x):
    pc, mode = cfg.precision, cfg.quant_mode
    if cfg.spiking is not None:
        return L.spiking_ffn_apply(
            lp, x, cfg.act, timesteps=cfg.spiking.timesteps,
            leak_shift=cfg.spiking.leak_shift,
            threshold=cfg.spiking.threshold, pc=pc, mode=mode)
    return L.ffn_apply(lp, x, cfg.ffn, cfg.act, pc, mode)


def _residual_tail(lp, cfg: ArchConfig, x, a):
    """x + attn (post-norm'd), then the MLP half of the block."""
    if cfg.post_block_norms:
        a = L.apply_norm(cfg.norm, lp["post_ln1"], a)
    x = x + a
    if "mlp" in lp:
        h2 = L.apply_norm(cfg.norm, lp["ln2"], x)
        m = _mlp_block(lp["mlp"], cfg, h2)
        if cfg.post_block_norms:
            m = L.apply_norm(cfg.norm, lp["post_ln2"], m)
        x = x + m
    return x


def _embed_tokens(params, cfg: ArchConfig, tokens):
    x = params["embed"][tokens].to(_dtype(cfg))
    if cfg.name.startswith(("gemma", "paligemma")):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _block_full(lp, cfg: ArchConfig, x, window: int):
    """One full-sequence layer (train / prefill path)."""
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    a, _ = _attn_block(lp["attn"], cfg, h, window=window)
    return _residual_tail(lp, cfg, x, a)


#: what ``remat="dots"`` keeps for the backward pass: the matmul outputs
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def forward_hidden(params, cfg: ArchConfig, tokens, vision_embeds=None):
    """tokens: (B, S) -> (hidden (B, S, d), aux_loss 0)."""
    check_supported(cfg)
    if vision_embeds is not None:
        raise NotImplementedError("vision_embeds: the VLM family is not "
                                  "ported to repro_torch yet")
    x = _embed_tokens(params, cfg, tokens)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    for lp, window in zip(params["layers"], window_schedule(cfg)):
        if cfg.remat == "none":
            x = _block_full(lp, cfg, x, int(window))
        else:
            x = checkpoint(_block_full, lp, cfg, x, int(window),
                           use_reentrant=False, **kw)
    return L.apply_norm(cfg.norm, params["final_norm"], x), 0.0


def _logits_chunk(params, cfg: ArchConfig, h):
    if cfg.tie_embeddings:
        logits = h.to(torch.float32) @ params["embed"].to(torch.float32).T
    else:
        logits = L.linear(params["lm_head"], h).to(torch.float32)
    return L.softcap(logits, cfg.final_logit_softcap)


def _chunk_loss(params, cfg: ArchConfig, hb, lb):
    """Summed cross-entropy of one sequence chunk and its count of
    unmasked labels."""
    logits = _logits_chunk(params, cfg, hb)
    mask = (lb >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1,
                       torch.clamp(lb, min=0).to(torch.int64)[..., None])
    return torch.sum((lse - tgt[..., 0]) * mask), torch.sum(mask)


def loss_fn(params, cfg: ArchConfig, batch, *, ce_chunk: int = 512):
    """Sequence-chunked cross-entropy.  batch: tokens (B, S), labels
    (B, S) with -1 = masked.  ``S`` splits into ``max(1, S // ce_chunk)``
    chunks, one fewer until the count divides ``S`` (JAX's rule); each
    chunk's logits are recomputed in the backward pass
    (``torch.utils.checkpoint`` in place of ``jax.checkpoint``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = forward_hidden(params, cfg, tokens,
                            batch.get("vision_embeds"))
    s_len = h.shape[1]
    nc = max(1, s_len // ce_chunk)
    while s_len % nc:             # nc must divide S
        nc -= 1
    cs = s_len // nc
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        t, n = checkpoint(_chunk_loss, params, cfg, h[:, c * cs:(c + 1) * cs],
                          labels[:, c * cs:(c + 1) * cs],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt, 1.0) + aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    # per-slot lengths: the serving engine keeps ragged sequences in one
    # shared pool
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.kv_cache_bits != 16:
        # sub-word packed cache: int32 words along head_dim + one f32
        # absmax scale per (position, head), kernels/kv_attention
        w = cfg.head_dim * cfg.kv_cache_bits // 32
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv)
        cache["k"] = torch.zeros(shape + (w,), dtype=torch.int32, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
        cache["k_scale"] = torch.zeros(shape + (1,), dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros_like(cache["k_scale"])
    else:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    return cache


def prefill(params, cfg: ArchConfig, tokens, vision_embeds=None):
    """tokens (B, S) -> (last-token logits (B, vocab) f32, cache with
    ``len`` = S and per-layer K/V of length S)."""
    check_supported(cfg)
    if vision_embeds is not None:
        raise NotImplementedError("vision_embeds: the VLM family is not "
                                  "ported to repro_torch yet")
    x = _embed_tokens(params, cfg, tokens)
    bsz, s_len = tokens.shape
    outs = {"k": [], "v": [], "k_scale": [], "v_scale": []}
    for lp, window in zip(params["layers"], window_schedule(cfg)):
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        a, (k, v) = _attn_block(lp["attn"], cfg, h, window=int(window))
        if cfg.kv_cache_bits != 16:
            for name, t in (("k", k), ("v", v)):
                words, scale = kv_ref.quantize_kv(t, cfg.kv_cache_bits)
                outs[name].append(words)
                outs[f"{name}_scale"].append(scale)
        else:
            outs["k"].append(k)
            outs["v"].append(v)
        x = _residual_tail(lp, cfg, x, a)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _logits_chunk(params, cfg, x[:, -1:])[:, 0]
    cache = {"len": torch.full((bsz,), s_len, dtype=torch.int32,
                               device=x.device)}
    for key, vals in outs.items():
        if vals:
            cache[key] = torch.stack(vals)
    return logits, cache


def decode_step(params, cfg: ArchConfig, cache, tokens, *, ragged=False):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, vocab) f32,
    cache), the cache updated in place.

    ragged=True takes per-slot cache lengths (continuous batching); the
    uniform path writes one position for the whole batch.  A live slot
    never runs past the cache: the uniform path raises when the cache is
    full (JAX would clamp the write onto the last position), and the
    ragged path leaves that to the engine, which retires a slot at
    ``max_len``."""
    check_supported(cfg)
    x = _embed_tokens(params, cfg, tokens)   # a gather: the same bits as
    #                                          JAX's one-hot contraction
    s_len = cache["k"].shape[2]
    new_len = cache["len"] + 1
    longest = int(new_len.max())
    if not ragged and longest > s_len:
        raise ValueError(f"decode_step: the cache holds {s_len} positions "
                         f"and is full; pad the prefill cache to max_len")
    packed = cfg.kv_cache_bits != 16
    for i, (lp, window) in enumerate(zip(params["layers"],
                                         window_schedule(cfg))):
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        if packed:
            ckv = (cache["k"][i], cache["k_scale"][i], cache["v"][i],
                   cache["v_scale"][i])
        else:
            ckv = (cache["k"][i], cache["v"][i])
        a, _ = _attn_block(lp["attn"], cfg, h, window=int(window),
                           q_offset=new_len - 1,
                           cache_kv=ckv, cache_len=new_len, ragged=ragged,
                           kv_len=longest)
        x = _residual_tail(lp, cfg, x, a)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _logits_chunk(params, cfg, x)[:, 0]
    cache["len"] = new_len
    return logits, cache
