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

``loss_fn(tp=)``, ``prefill(tp=)`` and ``decode_step(tp=)`` run both
stacks tensor-parallel over a mesh's ``model`` axis
(``distributed.tensor_parallel``; the params are the rank's shards, the
sharded steps pass the context): the attention as the decoder-only
families' (``wq``, ``wk``, ``wv`` and their biases column-parallel where
the heads split, ``wo`` row-parallel with its bias added once after the
reduce, heads run whole where they do not split), the MLP split on
``d_ff``, the embedding and the tied head split on the vocab; the
layernorms and the sinusoids stay whole.  A serve step's self cache is
the rank's share as ``tp.cache`` says and its cross cache as
``tp.xcache`` says.  With ``tp=None`` nothing of this module changes.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


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
         cache_len=None, tp=None, route=None):
    """Multi-head attention.  Without ``cache_kv``: full attention of
    ``q_in`` over ``kv_in``, returning (out, (k, v)).  With it, one
    decode token: self-attention (``kv_in`` given) writes its K/V at
    ``cache_len - 1`` in place and attends the first ``cache_len``
    positions; cross-attention (``kv_in`` None) attends the whole
    cross cache.  Returns (out, None) then.

    ``tp``: the tensor-parallel context.  Where it splits the heads,
    ``lp`` holds the rank's query heads (and KV heads, or ``wk``/``wv``
    whole) and ``wo`` is row-parallel; ``q_in`` passes ``tp.copy_in``
    here, once for the self-attention's three projections, and a
    cross-attention's ``kv_in`` (the encoder states) has passed it once
    for every layer.  ``route``: where the serve step's cache of this
    attention lies (``"heads"``, ``"seq"`` or ``"whole"``;
    ``tp.cache`` or ``tp.xcache``): the full-sequence path returns that
    share as (k, v), a decode step writes and attends over it.
    """
    pc, mode = cfg.precision, cfg.quant_mode
    b, sq, _ = q_in.shape
    hd = cfg.head_dim
    nh, nkv, kvp = cfg.n_heads, cfg.n_kv, lp
    split = tp is not None and tp.heads
    if split:
        same = kv_in is q_in
        q_in = tp.copy_in(q_in)
        kv_in = q_in if same else kv_in
        nh = tp.n_heads
        # a decode step over a cache of every KV head computes them all
        if cache_kv is None or route == "heads":
            kvp, nkv = tp.attn_shard(lp), tp.n_kv
    q = L.linear(lp["wq"], q_in, pc, mode).reshape(b, sq, nh, hd)
    k = v = None
    if kv_in is not None:
        sk = kv_in.shape[1]
        k = L.linear(kvp["wk"], kv_in, pc, mode).reshape(b, sk, nkv, hd)
        v = L.linear(kvp["wv"], kv_in, pc, mode).reshape(b, sk, nkv, hd)
    scale = hd ** -0.5
    out_kv = None
    if cache_kv is not None:
        k_c, v_c = cache_kv
        if kv_in is None:           # decode cross-attention: fixed cache,
            #                         every position of it read
            cache_len = k_c.shape[1] * (tp.size if route == "seq" else 1)
        if route == "seq":
            o = T._seq_decode(q, k, v, cache_kv, cfg, tp, split, cache_len,
                              0, None, False, scale)
        else:
            if kv_in is not None:   # decode self-attention: write, attend
                ins = (torch.as_tensor(cache_len, device=q.device)
                       .reshape(1).to(torch.int64) - 1)
                k_c.index_copy_(1, ins, k.to(k_c.dtype))
                v_c.index_copy_(1, ins, v.to(v_c.dtype))
            if split and route == "whole":
                k_c, v_c = tp.kv_view(k_c), tp.kv_view(v_c)
            o = L.decode_attention(q, k_c, v_c, scale=scale,
                                   cache_len=cache_len)
    else:
        ka, va = (tp.expand_kv(k), tp.expand_kv(v)) if split else (k, v)
        o = L.attention(q, ka, va, scale=scale, causal=causal)
        if route not in (None, "heads"):
            k, v = T._cache_share(lp, cfg, kv_in, None, k, v, tp, split,
                                  route)
        out_kv = (k, v)
    return L.linear(lp["wo"], o.reshape(b, sq, nh * hd), pc, mode,
                    tp=tp if split else None), out_kv


def _enc_for_xattn(enc_out, tp):
    """The encoder states as every decoder layer's cross-attention reads
    them: through one ``tp.copy_in`` where the heads split, so their
    gradient sums every layer's ``wk``/``wv`` reads before one
    all-reduce, in the order the unsharded graph sums them."""
    return tp.copy_in(enc_out) if tp is not None and tp.heads else enc_out


def encode(params, cfg: ArchConfig, frames: torch.Tensor, tp=None
           ) -> torch.Tensor:
    """frames: (B, T_enc, d) stub embeddings -> encoder states.  ``tp``:
    the tensor-parallel context."""
    x = frames.to(_dt(cfg))
    x = x + sinusoid(x.shape[1], cfg.d_model, device=x.device).to(
        x.dtype)[None]
    for lp in params["enc_layers"]:
        h = L.apply_norm("layernorm", lp["ln1"], x)
        a, _ = _mha(lp["attn"], cfg, h, h, causal=False, tp=tp)
        x = x + a
        h = L.apply_norm("layernorm", lp["ln2"], x)
        x = x + L.ffn_apply(lp["mlp"], h, "mlp", cfg.act, cfg.precision,
                            cfg.quant_mode, tp=tp and tp.on("mlp"))
    return L.apply_norm("layernorm", params["enc_norm"], x)


def _dec_block(x, lp, cfg: ArchConfig, enc_out, *, cache=None,
               cache_len=None, tp=None):
    """One decoder layer.  Full sequence (``cache`` None): returns (x, its
    cache {"k", "v", "xk", "xv"}); decode: (x, None), ``cache``'s
    self-attention K/V written in place.  ``tp``: the tensor-parallel
    context (``enc_out`` through :func:`_enc_for_xattn`); a serve
    step's cache entries are the rank's shares."""
    new_cache = None
    self_at, cross_at = (tp.cache, tp.xcache) if tp is not None else \
        (None, None)
    h = L.apply_norm("layernorm", lp["ln1"], x)
    if cache is None:
        a, (k, v) = _mha(lp["attn"], cfg, h, h, causal=True, tp=tp,
                         route=self_at)
        new_cache = {"k": k, "v": v}
    else:
        a, _ = _mha(lp["attn"], cfg, h, h, causal=True,
                    cache_kv=(cache["k"], cache["v"]), cache_len=cache_len,
                    tp=tp, route=self_at)
    x = x + a
    h = L.apply_norm("layernorm", lp["ln_x"], x)
    if cache is None:
        xa, (xk, xv) = _mha(lp["xattn"], cfg, h, enc_out, causal=False,
                            tp=tp, route=cross_at)
        new_cache["xk"], new_cache["xv"] = xk, xv
    else:
        xa, _ = _mha(lp["xattn"], cfg, h, None, causal=False,
                     cache_kv=(cache["xk"], cache["xv"]), tp=tp,
                     route=cross_at)
    x = x + xa
    h = L.apply_norm("layernorm", lp["ln2"], x)
    x = x + L.ffn_apply(lp["mlp"], h, "mlp", cfg.act, cfg.precision,
                        cfg.quant_mode, tp=tp and tp.on("mlp"))
    return x, new_cache


def _embed(params, cfg: ArchConfig, tokens, offset=0, tp=None):
    """Token embeddings (the decoder-only families' lookup: a vocab-split
    table with ``tp``) plus sinusoids."""
    x = T._embed_tokens(params, cfg, tokens, tp=tp)
    return x + sinusoid(x.shape[1], cfg.d_model, offset=offset,
                        device=x.device).to(x.dtype)[None]


def decode_train(params, cfg: ArchConfig, tokens, enc_out, tp=None):
    """Teacher-forced decoder forward -> hidden (B, S, d).  With
    ``cfg.remat`` other than ``"none"`` each layer is recomputed whole in
    the backward pass (JAX's ``jax.checkpoint`` without a policy).
    ``tp``: the tensor-parallel context."""
    x = _embed(params, cfg, tokens, tp=tp)
    enc_out = _enc_for_xattn(enc_out, tp)
    for lp in params["dec_layers"]:
        if cfg.remat == "none":
            x, _ = _dec_block(x, lp, cfg, enc_out, tp=tp)
        else:
            x, _ = checkpoint(_dec_block, x, lp, cfg, enc_out,
                              use_reentrant=False, tp=tp)
    return L.apply_norm("layernorm", params["dec_norm"], x)


def loss_fn(params, cfg: ArchConfig, batch, *, ce_chunk: int = 512,
            tp=None):
    """Sequence-chunked cross-entropy of the decoder over ``frames``;
    labels -1 are masked.  Chunks as in the decoder-only ``loss_fn``,
    each through its ``_chunk_loss`` (the tied head; with ``tp``, over
    vocab-split logits), not recomputed in the backward pass.  ``tp``:
    the tensor-parallel context of the sharded train step."""
    enc_out = encode(params, cfg, batch["frames"], tp=tp)
    h = decode_train(params, cfg, batch["tokens"], enc_out, tp=tp)
    labels = batch["labels"]
    s_len = h.shape[1]
    nc = max(1, s_len // ce_chunk)
    while s_len % nc:
        nc -= 1
    cs = s_len // nc
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        t, n = T._chunk_loss(params, cfg, h[:, c * cs:(c + 1) * cs],
                             labels[:, c * cs:(c + 1) * cs],
                             tp and tp.on("vocab"))
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def prefill(params, cfg: ArchConfig, tokens, frames, tp=None):
    """Encode + teacher-forced decoder pass.  Returns (last-token logits
    (B, vocab) f32, cache): ``k``/``v`` of the prompt's length, ``xk``/
    ``xv`` of ``T_enc``, ``len`` = S (a 0-d int32).  ``tp``: the
    tensor-parallel context of the sharded prefill; the logits are then
    the rank's vocab slice where the vocab splits, and the K/V the
    rank's shares of the caches (``tp.cache``, ``tp.xcache``)."""
    enc_out = _enc_for_xattn(encode(params, cfg, frames, tp=tp), tp)
    x = _embed(params, cfg, tokens, tp=tp)
    caches = []
    for lp in params["dec_layers"]:
        x, c = _dec_block(x, lp, cfg, enc_out, tp=tp)
        caches.append(c)
    x = L.apply_norm("layernorm", params["dec_norm"], x)
    logits = T._logits_chunk(params, cfg, x[:, -1], tp and tp.on("vocab"))
    cache = {key: torch.stack([c[key] for c in caches])
             for key in ("k", "v", "xk", "xv")}
    cache["len"] = torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=x.device)
    return logits, cache


def decode_step(params, cfg: ArchConfig, cache, tokens, *,
                kv_len: Optional[int] = None, tp=None):
    """One decode step for the whole batch.  tokens: (B, 1).  Returns
    (logits (B, vocab) f32, cache), the self-attention cache written in
    place at position ``len``; raises when the cache is full (JAX would
    clamp the write onto the last position).  ``kv_len``, the length
    after this step known on the host, replaces the read of ``len`` in
    that check (as in ``transformer.decode_step``).  ``tp``: the
    tensor-parallel context of the sharded decode step; the logits are
    then the rank's vocab slice where the vocab splits, the caches the
    rank's shares (``tp.cache``, ``tp.xcache``)."""
    s_len = cache["k"].shape[2] * (
        tp.size if tp is not None and tp.cache == "seq" else 1)
    if (int(cache["len"]) + 1 if kv_len is None else kv_len) > s_len:
        raise ValueError(f"decode_step: the cache holds {s_len} positions "
                         f"and is full; pad the prefill cache")
    x = _embed(params, cfg, tokens, offset=cache["len"], tp=tp)
    new_len = cache["len"] + 1
    for i, lp in enumerate(params["dec_layers"]):
        lc = {key: cache[key][i] for key in ("k", "v", "xk", "xv")}
        x, _ = _dec_block(x, lp, cfg, None, cache=lc, cache_len=new_len,
                          tp=tp)
    x = L.apply_norm("layernorm", params["dec_norm"], x)
    logits = T._logits_chunk(params, cfg, x[:, 0], tp and tp.on("vocab"))
    cache["len"] = new_len
    return logits, cache
