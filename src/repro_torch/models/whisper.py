"""Whisper-style encoder-decoder backbone (the conv frontend is a stub).

Port of ``repro.models.whisper``.  The inputs are precomputed frame
embeddings ``(B, T_enc, d)`` standing in for the two strided conv
layers' output.  Positions are sinusoidal in both stacks (the original
learns the decoder's).  ``params["enc_layers"]`` and
``params["dec_layers"]`` are lists of per-layer dicts, as ``layers`` is
in :mod:`repro_torch.models.transformer`; a Python loop over layers
replaces ``jax.lax.scan``.

Every linear goes through :func:`~repro_torch.models.layers.linear`
(``packed_qmatmul`` when packed): ``wq``, ``wv`` and ``wo`` have a bias,
``wk`` has none.  The decode cache holds the decoder's self-attention
K/V ``(n_layers, B, S, K, hd)``, which the caller pads past the prompt
before decoding, the cross-attention K/V of the encoder states
(``xk``/``xv``, read over all ``T_enc`` positions, unmasked) and one
length ``len`` for the whole batch; decode steps write the self-attention
cache in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import generator, resolve_device
from repro_torch.models import layers as L


def _dt(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def sinusoid(seq: int, d: int, offset=0, device=None) -> torch.Tensor:
    """(seq, d) float32: sin then cos of ``pos / 10000 ** (2i / d)``."""
    off = torch.as_tensor(offset, device=device).to(torch.float32)
    pos = off + torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_init(gen, cfg: ArchConfig, dt, device):
    d, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": L.linear_init(gen, d, cfg.n_heads * hd, dt, bias=True,
                            device=device),
        "wk": L.linear_init(gen, d, cfg.n_kv * hd, dt, device=device),
        "wv": L.linear_init(gen, d, cfg.n_kv * hd, dt, bias=True,
                            device=device),
        "wo": L.linear_init(gen, cfg.n_heads * hd, d, dt, bias=True,
                            device=device),
    }


def init_enc_layer(gen: torch.Generator, cfg: ArchConfig, device=None):
    dt = _dt(cfg)
    return {
        "ln1": L.norm_init("layernorm", cfg.d_model, dt, device),
        "attn": _attn_init(gen, cfg, dt, device),
        "ln2": L.norm_init("layernorm", cfg.d_model, dt, device),
        "mlp": L.ffn_init(gen, cfg.d_model, cfg.d_ff, "mlp", dt, device),
    }


def init_dec_layer(gen: torch.Generator, cfg: ArchConfig, device=None):
    p = init_enc_layer(gen, cfg, device)
    p["ln_x"] = L.norm_init("layernorm", cfg.d_model, _dt(cfg), device)
    p["xattn"] = _attn_init(gen, cfg, _dt(cfg), device)
    return p


def init(seed: int, cfg: ArchConfig, device="cuda"):
    """Random params from ``seed`` on ``device``: the JAX package's shapes
    and scales, drawn from a ``torch.Generator`` (so not JAX's numbers)."""
    dev = resolve_device(device)
    gen = generator(dev, seed)
    dt = _dt(cfg)
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                      dtype=torch.float32, device=dev)
    return {
        "embed": (emb * 0.02).to(dt),
        "enc_layers": [init_enc_layer(gen, cfg, dev)
                       for _ in range(cfg.encdec.n_layers)],
        "enc_norm": L.norm_init("layernorm", cfg.d_model, dt, dev),
        "dec_layers": [init_dec_layer(gen, cfg, dev)
                       for _ in range(cfg.n_layers)],
        "dec_norm": L.norm_init("layernorm", cfg.d_model, dt, dev),
    }


def _mha(lp, cfg: ArchConfig, q_in, kv_in, *, causal, cache_kv=None,
         cache_len=None):
    """Multi-head attention.  Without ``cache_kv``: full attention of
    ``q_in`` over ``kv_in``, returning (out, (k, v)).  With it, one
    decode token: self-attention (``kv_in`` given) writes its K/V at
    ``cache_len - 1`` in place and attends the first ``cache_len``
    positions; cross-attention (``kv_in`` None) attends the whole
    cross cache.  Returns (out, None) then."""
    pc, mode = cfg.precision, cfg.quant_mode
    b, sq, _ = q_in.shape
    hd = cfg.head_dim
    q = L.linear(lp["wq"], q_in, pc, mode).reshape(b, sq, cfg.n_heads, hd)
    if kv_in is not None:
        sk = kv_in.shape[1]
        k = L.linear(lp["wk"], kv_in, pc, mode).reshape(b, sk, cfg.n_kv, hd)
        v = L.linear(lp["wv"], kv_in, pc, mode).reshape(b, sk, cfg.n_kv, hd)
    scale = hd ** -0.5
    out_kv = None
    if cache_kv is not None:
        k_c, v_c = cache_kv
        if kv_in is not None:       # decode self-attention: write, attend
            ins = (torch.as_tensor(cache_len, device=q.device)
                   .reshape(1).to(torch.int64) - 1)
            k_c.index_copy_(1, ins, k.to(k_c.dtype))
            v_c.index_copy_(1, ins, v.to(v_c.dtype))
            o = L.decode_attention(q, k_c, v_c, scale=scale,
                                   cache_len=cache_len)
        else:                       # decode cross-attention: fixed cache
            o = L.decode_attention(q, k_c, v_c, scale=scale,
                                   cache_len=k_c.shape[1])
    else:
        o = L.attention(q, k, v, scale=scale, causal=causal)
        out_kv = (k, v)
    return L.linear(lp["wo"], o.reshape(b, sq, cfg.n_heads * hd), pc,
                    mode), out_kv


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_enc, d) stub embeddings -> encoder states."""
    x = frames.to(_dt(cfg))
    x = x + sinusoid(x.shape[1], cfg.d_model, device=x.device).to(
        x.dtype)[None]
    for lp in params["enc_layers"]:
        h = L.apply_norm("layernorm", lp["ln1"], x)
        a, _ = _mha(lp["attn"], cfg, h, h, causal=False)
        x = x + a
        h = L.apply_norm("layernorm", lp["ln2"], x)
        x = x + L.ffn_apply(lp["mlp"], h, "mlp", cfg.act, cfg.precision,
                            cfg.quant_mode)
    return L.apply_norm("layernorm", params["enc_norm"], x)


def _dec_block(x, lp, cfg: ArchConfig, enc_out, *, cache=None,
               cache_len=None):
    """One decoder layer.  Full sequence (``cache`` None): returns (x, its
    cache {"k", "v", "xk", "xv"}); decode: (x, None), ``cache``'s
    self-attention K/V written in place."""
    new_cache = None
    h = L.apply_norm("layernorm", lp["ln1"], x)
    if cache is None:
        a, (k, v) = _mha(lp["attn"], cfg, h, h, causal=True)
        new_cache = {"k": k, "v": v}
    else:
        a, _ = _mha(lp["attn"], cfg, h, h, causal=True,
                    cache_kv=(cache["k"], cache["v"]), cache_len=cache_len)
    x = x + a
    h = L.apply_norm("layernorm", lp["ln_x"], x)
    if cache is None:
        xa, (xk, xv) = _mha(lp["xattn"], cfg, h, enc_out, causal=False)
        new_cache["xk"], new_cache["xv"] = xk, xv
    else:
        xa, _ = _mha(lp["xattn"], cfg, h, None, causal=False,
                     cache_kv=(cache["xk"], cache["xv"]))
    x = x + xa
    h = L.apply_norm("layernorm", lp["ln2"], x)
    x = x + L.ffn_apply(lp["mlp"], h, "mlp", cfg.act, cfg.precision,
                        cfg.quant_mode)
    return x, new_cache


def _embed(params, cfg: ArchConfig, tokens, offset=0):
    x = params["embed"][tokens].to(_dt(cfg))
    return x + sinusoid(x.shape[1], cfg.d_model, offset=offset,
                        device=x.device).to(x.dtype)[None]


def decode_train(params, cfg: ArchConfig, tokens, enc_out):
    """Teacher-forced decoder forward -> hidden (B, S, d).  With
    ``cfg.remat`` other than ``"none"`` each layer is recomputed whole in
    the backward pass (JAX's ``jax.checkpoint`` without a policy)."""
    x = _embed(params, cfg, tokens)
    for lp in params["dec_layers"]:
        if cfg.remat == "none":
            x, _ = _dec_block(x, lp, cfg, enc_out)
        else:
            x, _ = checkpoint(_dec_block, x, lp, cfg, enc_out,
                              use_reentrant=False)
    return L.apply_norm("layernorm", params["dec_norm"], x)


def _logits(params, h):
    return h.to(torch.float32) @ params["embed"].to(torch.float32).T


def loss_fn(params, cfg: ArchConfig, batch, *, ce_chunk: int = 512):
    """Sequence-chunked cross-entropy of the decoder over ``frames``;
    labels -1 are masked.  Chunks as in the decoder-only ``loss_fn``."""
    enc_out = encode(params, cfg, batch["frames"])
    h = decode_train(params, cfg, batch["tokens"], enc_out)
    labels = batch["labels"]
    s_len = h.shape[1]
    nc = max(1, s_len // ce_chunk)
    while s_len % nc:
        nc -= 1
    cs = s_len // nc
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        logits = _logits(params, h[:, c * cs:(c + 1) * cs])
        lb = labels[:, c * cs:(c + 1) * cs]
        mask = (lb >= 0).to(torch.float32)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1,
                           torch.clamp(lb, min=0).to(torch.int64)[..., None])
        tot = tot + torch.sum((lse - tgt[..., 0]) * mask)
        cnt = cnt + torch.sum(mask)
    return tot / torch.clamp_min(cnt, 1.0)


def prefill(params, cfg: ArchConfig, tokens, frames):
    """Encode + teacher-forced decoder pass.  Returns (last-token logits
    (B, vocab) f32, cache): ``k``/``v`` of the prompt's length, ``xk``/
    ``xv`` of ``T_enc``, ``len`` = S (a 0-d int32)."""
    enc_out = encode(params, cfg, frames)
    x = _embed(params, cfg, tokens)
    caches = []
    for lp in params["dec_layers"]:
        x, c = _dec_block(x, lp, cfg, enc_out)
        caches.append(c)
    x = L.apply_norm("layernorm", params["dec_norm"], x)
    logits = _logits(params, x[:, -1])
    cache = {key: torch.stack([c[key] for c in caches])
             for key in ("k", "v", "xk", "xv")}
    cache["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=x.device)
    return logits, cache


def decode_step(params, cfg: ArchConfig, cache, tokens, *,
                kv_len: Optional[int] = None):
    """One decode step for the whole batch.  tokens: (B, 1).  Returns
    (logits (B, vocab) f32, cache), the self-attention cache written in
    place at position ``len``; raises when the cache is full (JAX would
    clamp the write onto the last position).  ``kv_len``, the length
    after this step known on the host, replaces the read of ``len`` in
    that check (as in ``transformer.decode_step``)."""
    s_len = cache["k"].shape[2]
    if (int(cache["len"]) + 1 if kv_len is None else kv_len) > s_len:
        raise ValueError(f"decode_step: the cache holds {s_len} positions "
                         f"and is full; pad the prefill cache")
    x = _embed(params, cfg, tokens, offset=cache["len"])
    new_len = cache["len"] + 1
    for i, lp in enumerate(params["dec_layers"]):
        lc = {key: cache[key][i] for key in ("k", "v", "xk", "xv")}
        x, _ = _dec_block(x, lp, cfg, None, cache=lc, cache_len=new_len)
    x = L.apply_norm("layernorm", params["dec_norm"], x)
    logits = _logits(params, x[:, 0])
    cache["len"] = new_len
    return logits, cache
