"""Decoder-only LM backbone: every decoder family of the JAX package.

Port of ``repro.models.transformer``: the dense families (olmo, stablelm,
internlm2, gemma2's local/global alternation with its soft caps and
post-block norms), MoE (``cfg.moe``: :mod:`repro_torch.models.moe` in
place of the MLP), SSM (``family == "ssm"``: a Mamba-2 mixer,
:mod:`repro_torch.models.mamba2`, in place of attention), the hybrid
(``hybrid_parallel_ssm``: attention and a Mamba-2 mixer side by side,
their outputs mixed per channel by ``mix_scale``) and the VLM prefix
(``vision_prefix_len``: ``vision_proj`` of the image embeddings
prepended to the text, attended bidirectionally).  The audio family is
:mod:`repro_torch.models.whisper`.  ``params["layers"]`` is a list of
per-layer dicts and a Python loop over layers replaces ``jax.lax.scan``,
so each layer's attention window is a Python int.  The cache keeps the
JAX package's stacked layout: K/V ``(n_layers, B, S, K, hd)`` (or packed
words and scales when ``kv_cache_bits != 16``), and for SSM layers the
conv inputs ``(n_layers, B, W - 1, C)`` in the model dtype and the state
``(n_layers, B, nh, hp, N)`` in float32.  Decode steps write into it in
place (the JAX version returns a new cache; in place saves a copy of the
whole cache per step).

The spiking FFN (``cfg.spiking``) replaces the MLP where it is set, and
``cfg.remat`` recomputes activations in the backward pass of
:func:`forward_hidden`: ``"full"`` checkpoints each layer, ``"dots"``
keeps the matmul outputs of each layer (``aten.mm``/``bmm``/``addmm``,
through ``torch.utils.checkpoint``'s selective checkpointing) and
recomputes the rest, in place of ``jax.checkpoint`` and its
``dots_with_no_batch_dims_saveable`` policy.

``loss_fn(tp=)``, ``prefill(tp=)`` and ``decode_step(tp=)`` run the
dense, MoE, SSM and hybrid layers tensor-parallel over a mesh's
``model`` axis (``distributed.tensor_parallel``: the params are the
rank's shards, the sharded steps pass the context; a serve step's K/V
cache is the rank's share, split as ``tp.cache`` says, its SSM state
the rank's heads' where they split and its conv inputs whole).  Each
mixer's output is reduced over ``model`` before the hybrid mixes them.
With ``tp=None`` nothing of this module changes.

Forward modes:
  forward_hidden  full sequence (train / prefill), chunked flash-style
                  attention for long sequences; returns the summed MoE
                  load-balance loss beside the hidden states
  loss_fn         forward + sequence-chunked cross-entropy over the text
                  positions; each chunk's (B, chunk, vocab) logits are
                  recomputed in the backward pass instead of being saved
  prefill         forward + cache emission, last-token logits
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
from repro_torch.device import generator, resolve_device
from repro_torch.kernels.kv_attention import ops as kv_ops
from repro_torch.kernels.kv_attention import ref as kv_ref
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config this module does not
    build: the audio family, which is :mod:`repro_torch.models.whisper`."""
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the audio (whisper) family is an encoder-decoder; "
            f"build it with repro_torch.models.whisper (api.get_model does)")


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
    }
    if cfg.family != "ssm":
        p["attn"] = {
            "wq": L.linear_init(gen, d, cfg.n_heads * hd, dt, cfg.qkv_bias,
                                device),
            "wk": L.linear_init(gen, d, cfg.n_kv * hd, dt, cfg.qkv_bias,
                                device),
            "wv": L.linear_init(gen, d, cfg.n_kv * hd, dt, cfg.qkv_bias,
                                device),
            "wo": L.linear_init(gen, cfg.n_heads * hd, d, dt, device=device),
        }
    if cfg.moe is not None:
        p["mlp"] = MOE.moe_init(gen, d, cfg.moe, cfg.ffn, dt, device)
    elif cfg.d_ff > 0:
        p["mlp"] = L.ffn_init(gen, d, cfg.d_ff, cfg.ffn, dt, device)
    if cfg.post_block_norms:
        p["post_ln1"] = L.norm_init(cfg.norm, d, dt, device)
        p["post_ln2"] = L.norm_init(cfg.norm, d, dt, device)
    if cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        p["ssm"] = M2.mamba2_init(gen, d, cfg.ssm, dt, device)
        if cfg.hybrid_parallel_ssm:       # learnable attn/ssm mix
            p["mix_scale"] = torch.ones((2, d), dtype=dt, device=device)
    return p


def init(seed: int, cfg: ArchConfig, device="cuda"):
    """Random params from ``seed`` on ``device``: the JAX package's shapes
    and scales (embeddings N(0, 0.02), He-normal linears, unit norms),
    drawn from a ``torch.Generator`` (so not JAX's numbers)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = generator(dev, seed)
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
    if cfg.vision_prefix_len:
        params["vision_proj"] = L.linear_init(gen, cfg.d_model, cfg.d_model,
                                              dt, device=dev)
    return params


# ---------------------------------------------------------------------------
# block bodies
# ---------------------------------------------------------------------------


def _attn_scale(cfg: ArchConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else \
        cfg.head_dim ** -0.5


def _attn_block(lp, cfg: ArchConfig, x, *, window: int, prefix_len: int = 0,
                q_offset=0, cache_kv=None, cache_len=None, ragged=False,
                kv_len: Optional[int] = None, tp=None, copied=False):
    """Self-attention (full sequence or decode).  Returns (out, (k, v)).
    ``prefix_len`` leading positions are attended bidirectionally (the
    VLM prefix) in the full-sequence path.

    In decode, ``cache_kv`` holds this layer's cache tensors, which are
    written in place; ``kv_len`` (>= every slot's length) bounds the part
    of a bf16 cache the attention reads (the rest is masked anyway).

    ``tp``: the tensor-parallel context.  Where it splits the heads,
    ``lp`` holds the rank's query heads (and KV heads, or ``wk``/``wv``
    whole) and ``wo`` is row-parallel; elsewhere the heads run whole.  A
    serve step's ``tp.cache`` says which share of the cache the rank
    holds: the full-sequence path then returns that share as (k, v),
    and a decode step writes and attends over it.  ``copied``: ``x`` has
    passed ``tp.copy_in`` already.
    """
    pc, mode = cfg.precision, cfg.quant_mode
    b, s, _ = x.shape
    hd = cfg.head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv
    split = tp is not None and tp.heads
    route = tp.cache if tp is not None else None
    kvp = lp                # the weights of the K/V computed here
    if split:
        x = x if copied else tp.copy_in(x)
        nh = tp.n_heads
        # a decode step over a cache of every KV head computes them all
        if cache_kv is None or route == "heads":
            kvp, nkv = tp.attn_shard(lp), tp.n_kv
    q = L.linear(lp["wq"], x, pc, mode).reshape(b, s, nh, hd)
    k = L.linear(kvp["wk"], x, pc, mode).reshape(b, s, nkv, hd)
    v = L.linear(kvp["wv"], x, pc, mode).reshape(b, s, nkv, hd)
    ar = torch.arange(s, dtype=torch.int32, device=x.device)
    off = torch.as_tensor(q_offset, dtype=torch.int32, device=x.device)
    pos = off[:, None] + ar[None] if off.ndim == 1 else off + ar
    q = L.rope(q, pos, cfg.rope_theta)
    k = L.rope(k, pos, cfg.rope_theta)
    scale = _attn_scale(cfg)
    wo_tp = tp if split else None

    if cache_kv is None:
        ka, va = (tp.expand_kv(k), tp.expand_kv(v)) if split else (k, v)
        o = L.attention(q, ka, va, scale=scale, causal=True, window=window,
                        prefix_len=prefix_len,
                        logit_cap=cfg.attn_logit_softcap)
        if route not in (None, "heads"):
            k, v = _cache_share(lp, cfg, x, pos, k, v, tp, split)
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
        read = (kp, ks_, vp, vs_)
        if split and route == "whole":
            read = tuple(tp.kv_view(t) for t in read)
        o = kv_ops.quant_kv_decode_attention(
            q, *read, bits=bits, scale=scale,
            cache_len=cache_len, window=window,
            logit_cap=cfg.attn_logit_softcap)
        o = L.linear(lp["wo"], o.reshape(b, s, nh * hd), pc, mode, tp=wo_tp)
        return o, (kp, ks_, vp, vs_)
    elif route == "seq":
        o = _seq_decode(q, k, v, cache_kv, cfg, tp, split, cache_len,
                        window, kv_len, ragged, scale)
        k, v = cache_kv
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
        kr, vr = k_cache[:, :n], v_cache[:, :n]
        if split and route == "whole":
            kr, vr = tp.kv_view(kr), tp.kv_view(vr)
        o = L.decode_attention(
            q, kr, vr, scale=scale, cache_len=cache_len, window=window,
            logit_cap=cfg.attn_logit_softcap)
        k, v = k_cache, v_cache
    o = L.linear(lp["wo"], o.reshape(b, s, nh * hd), pc, mode, tp=wo_tp)
    return o, (k, v)


def _cache_share(lp, cfg: ArchConfig, x, pos, k, v, tp, split, route=None):
    """A prefill's K/V of every KV head at the rank's share of the
    positions (``route``, default ``tp.cache``, ``"seq"``) or at all of
    them (``"whole"``): sliced from ``k``/``v`` where they hold every KV
    head, else computed from ``wk``/``wv`` (gathered whole, with their
    biases) on those positions of ``x``, the K/V input, alone.  ``pos``
    ``None``: the keys are not rotated (whisper's)."""
    s = x.shape[1]
    lo, hi = tp.seq_range(s) if (route or tp.cache) == "seq" else (0, s)
    if not split:
        return k[:, lo:hi], v[:, lo:hi]
    pc, mode = cfg.precision, cfg.quant_mode
    xs = x[:, lo:hi]
    shape = (x.shape[0], hi - lo, cfg.n_kv, cfg.head_dim)
    k = L.linear(lp["wk"], xs, pc, mode).reshape(shape)
    if pos is not None:
        k = L.rope(k, pos[..., lo:hi], cfg.rope_theta)
    return k, L.linear(lp["wv"], xs, pc, mode).reshape(shape)


def _seq_decode(q, k, v, cache_kv, cfg: ArchConfig, tp, split, cache_len,
                window, kv_len, ragged, scale):
    """A decode step's attention over a bf16 cache whose sequence splits
    over ``model`` (``"seq"``): the rank writes the new position where
    its share holds it (``k`` ``None``: a cross-attention's fixed cache,
    nothing to write), attends with every query head over its positions
    (the softmax merged over ``model``) and returns its own query heads'
    output where the heads split."""
    if ragged:
        raise NotImplementedError(
            "ragged slot lengths over a sequence-split cache are not "
            "implemented; the sharded decode step is uniform")
    k_cache, v_cache = cache_kv
    s_loc = k_cache.shape[1]
    lo, _ = tp.seq_range(s_loc * tp.size)
    if k is not None:
        # the uniform step's one new position, written where this rank
        # holds it
        at = torch.as_tensor(cache_len, dtype=torch.int64,
                             device=q.device).reshape(-1)[:1] - 1 - lo
        ok = ((at >= 0) & (at < s_loc))[:, None, None, None]
        at = torch.clamp(at, 0, s_loc - 1)
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache.index_copy_(1, at, torch.where(
                ok, new.to(cache.dtype), cache.index_select(1, at)))
    n = s_loc if kv_len is None else min(max(kv_len - lo, 1), s_loc)
    qa = tp.gather_heads(q) if split else q
    o = L.decode_attention(
        qa, k_cache[:, :n], v_cache[:, :n], scale=scale,
        cache_len=cache_len, window=window,
        logit_cap=cfg.attn_logit_softcap, k_offset=lo, tp=tp)
    if split:
        o = o[:, :, tp.rank * tp.n_heads:(tp.rank + 1) * tp.n_heads]
    return o


def _mlp_block(lp, cfg: ArchConfig, x, *, decode=False, tp=None):
    """The MLP half's mixer: (y, aux) with the MoE load-balance loss as
    ``aux`` (0 for the other FFNs).  MoE takes the dense-mix path at
    decode and the dispatch path otherwise.  ``tp`` (the tensor-parallel
    context) splits a dense or spiking FFN's ``d_ff``, or the experts'
    ``d_ff_expert`` (``models/moe.py``)."""
    pc, mode = cfg.precision, cfg.quant_mode
    if cfg.moe is not None:
        return MOE.moe_apply(lp, x, cfg.moe, ffn_kind=cfg.ffn, act=cfg.act,
                             pc=pc, mode=mode, decode=decode, tp=tp)
    tp = tp and tp.on("mlp")
    if cfg.spiking is not None:
        return L.spiking_ffn_apply(
            lp, x, cfg.act, timesteps=cfg.spiking.timesteps,
            leak_shift=cfg.spiking.leak_shift,
            threshold=cfg.spiking.threshold, pc=pc, mode=mode, tp=tp), 0.0
    return L.ffn_apply(lp, x, cfg.ffn, cfg.act, pc, mode, tp=tp), 0.0


def _mix(lp, parts, dtype):
    """One mixer's output, or the hybrid's per-channel mix of attention
    and SSM: ``(attn * mix[0] + ssm * mix[1]) * 0.5``.  On the
    tensor-parallel route both parts are whole: each mixer's row-parallel
    output projection reduced them over ``model``."""
    if len(parts) == 1:
        return parts[0]
    mix = lp["mix_scale"].to(dtype)
    return (parts[0] * mix[0][None, None] + parts[1] * mix[1][None, None]) \
        * 0.5


def _residual_tail(lp, cfg: ArchConfig, x, a, *, decode=False, tp=None):
    """x + the mixers' output (post-norm'd), then the MLP half of the
    block (``tp``: the tensor-parallel context).  Returns (x, aux)."""
    if cfg.post_block_norms:
        a = L.apply_norm(cfg.norm, lp["post_ln1"], a)
    x = x + a
    aux = 0.0
    if "mlp" in lp:
        h2 = L.apply_norm(cfg.norm, lp["ln2"], x)
        m, aux = _mlp_block(lp["mlp"], cfg, h2, decode=decode, tp=tp)
        if cfg.post_block_norms:
            m = L.apply_norm(cfg.norm, lp["post_ln2"], m)
        x = x + m
    return x, aux


def _embed_tokens(params, cfg: ArchConfig, tokens, vision_embeds=None,
                  tp=None):
    """Token embeddings (scaled by sqrt(d) for the gemma families), with
    ``vision_proj`` of the image embeddings prepended (VLM).  ``tp``
    looks the tokens up in a vocab-split table and runs ``vision_proj``
    column-parallel, where those split."""
    if tp is not None and tp.vocab:
        x = tp.embed(params["embed"], tokens).to(_dtype(cfg))
    else:
        x = params["embed"][tokens].to(_dtype(cfg))
    if cfg.name.startswith(("gemma", "paligemma")):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if cfg.vision_prefix_len and vision_embeds is not None:
        if tp is not None and tp.vision:
            ve = tp.gather_last(L.linear(params["vision_proj"], tp.copy_in(
                vision_embeds.to(x.dtype))))
        else:
            ve = L.linear(params["vision_proj"], vision_embeds.to(x.dtype))
        x = torch.cat([ve, x], dim=1)
    return x


def _block_full(lp, cfg: ArchConfig, x, window: int, emit=None, tp=None):
    """One full-sequence layer (train / prefill path).  Returns (x, aux);
    with ``emit`` (a dict), also puts the layer's cache entries there:
    ``k``/``v`` (quantized when ``kv_cache_bits != 16``) and the SSM's
    ``conv``/``ssm``.  ``tp``: the tensor-parallel context (train, and
    a prefill's, whose emitted K/V are the rank's share of the cache,
    its SSM state the rank's heads' where they split, its conv inputs
    whole)."""
    pc, mode = cfg.precision, cfg.quant_mode
    h = L.apply_norm(cfg.norm, lp["ln1"], x)
    parts = []
    ssm_tp = tp.on("ssm") if tp is not None and "ssm" in lp else None
    # the hybrid's attention and mixer, both split, read one copy_in node
    # of h: its gradient sums both readers' before one all-reduce, as the
    # unsharded graph sums them at h (a one-rank step stays bit-equal)
    copied = ssm_tp is not None and cfg.family != "ssm" and tp.heads
    if copied:
        h = tp.copy_in(h)
    if cfg.family != "ssm":
        a, (k, v) = _attn_block(lp["attn"], cfg, h, window=window,
                                prefix_len=cfg.vision_prefix_len, tp=tp,
                                copied=copied)
        parts.append(a)
        if emit is not None and cfg.kv_cache_bits != 16:
            emit["k"], emit["k_scale"] = kv_ref.quantize_kv(
                k, cfg.kv_cache_bits)
            emit["v"], emit["v_scale"] = kv_ref.quantize_kv(
                v, cfg.kv_cache_bits)
        elif emit is not None:
            emit["k"], emit["v"] = k, v
    if "ssm" in lp:
        if emit is None:
            s = M2.mamba2_apply(lp["ssm"], h, cfg.ssm, cfg.d_model, pc=pc,
                                mode=mode, tp=ssm_tp, copied=copied)
        else:
            s, st = M2.mamba2_apply(lp["ssm"], h, cfg.ssm, cfg.d_model,
                                    pc=pc, mode=mode, return_state=True,
                                    tp=ssm_tp, copied=copied)
            emit["conv"], emit["ssm"] = st["conv"], st["ssm"]
        parts.append(s)
    return _residual_tail(lp, cfg, x, _mix(lp, parts, x.dtype), tp=tp)


#: what ``remat="dots"`` keeps for the backward pass: the outputs of
#: matmuls without batch dims (JAX's ``dots_with_no_batch_dims_saveable``:
#: the linears); batched ones (attention's ``bmm``) are recomputed
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def forward_hidden(params, cfg: ArchConfig, tokens, vision_embeds=None,
                   tp=None):
    """tokens: (B, S_text) -> (hidden (B, S, d), summed aux loss), S the
    text and any vision prefix.  ``tp``: the tensor-parallel context."""
    check_supported(cfg)
    x = _embed_tokens(params, cfg, tokens, vision_embeds, tp=tp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    for lp, window in zip(params["layers"], window_schedule(cfg)):
        if cfg.remat == "none":
            x, aux_l = _block_full(lp, cfg, x, int(window), tp=tp)
        else:
            x, aux_l = checkpoint(_block_full, lp, cfg, x, int(window),
                                  use_reentrant=False, tp=tp, **kw)
        aux = aux + aux_l
    return L.apply_norm(cfg.norm, params["final_norm"], x), aux


def _logits_chunk(params, cfg: ArchConfig, h, tp=None):
    """float32 logits of ``h``; with ``tp``, the rank's vocab slice."""
    if tp is not None:
        h = tp.copy_in(h)
    if cfg.tie_embeddings:
        logits = h.to(torch.float32) @ params["embed"].to(torch.float32).T
    else:
        logits = L.linear(params["lm_head"], h).to(torch.float32)
    return L.softcap(logits, cfg.final_logit_softcap)


def _chunk_loss(params, cfg: ArchConfig, hb, lb, tp=None):
    """Summed cross-entropy of one sequence chunk and its count of
    unmasked labels; with ``tp``, over vocab-split logits."""
    logits = _logits_chunk(params, cfg, hb, tp)
    if tp is not None:
        return tp.cross_entropy(logits, lb)
    mask = (lb >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1,
                       torch.clamp(lb, min=0).to(torch.int64)[..., None])
    return torch.sum((lse - tgt[..., 0]) * mask), torch.sum(mask)


def loss_fn(params, cfg: ArchConfig, batch, *, ce_chunk: int = 512,
            tp=None):
    """Sequence-chunked cross-entropy plus the MoE aux loss.  batch:
    tokens (B, S), labels (B, S) with -1 = masked; VLM batches add
    vision_embeds, whose positions carry no loss.  ``S`` splits into
    ``max(1, S // ce_chunk)`` chunks, one fewer until the count divides
    ``S`` (JAX's rule); each chunk's logits are recomputed in the
    backward pass (``torch.utils.checkpoint`` in place of
    ``jax.checkpoint``).  ``tp``: the tensor-parallel context of the
    sharded train step (``distributed.tensor_parallel``)."""
    tokens, labels = batch["tokens"], batch["labels"]
    h, aux = forward_hidden(params, cfg, tokens,
                            batch.get("vision_embeds"), tp=tp)
    if cfg.vision_prefix_len:
        h = h[:, cfg.vision_prefix_len:]
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
                          tp and tp.on("vocab"), use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp_min(cnt, 1.0) + aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

#: the cache entries a layer carries, in the stacked cache's key order
_CACHE_KEYS = ("k", "v", "k_scale", "v_scale", "conv", "ssm")


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    # per-slot lengths: the serving engine keeps ragged sequences in one
    # shared pool
    cache = {"len": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family != "ssm" and cfg.kv_cache_bits != 16:
        # sub-word packed cache: int32 words along head_dim + one f32
        # absmax scale per (position, head), kernels/kv_attention
        w = cfg.head_dim * cfg.kv_cache_bits // 32
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv)
        cache["k"] = torch.zeros(shape + (w,), dtype=torch.int32, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
        cache["k_scale"] = torch.zeros(shape + (1,), dtype=torch.float32,
                                       device=dev)
        cache["v_scale"] = torch.zeros_like(cache["k_scale"])
    elif cfg.family != "ssm":
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros_like(cache["k"])
    if cfg.family == "ssm" or cfg.hybrid_parallel_ssm:
        per = M2.mamba2_init_cache(batch, cfg.d_model, cfg.ssm, dt, dev)
        for key, t in per.items():
            cache[key] = t[None].repeat((cfg.n_layers,) + (1,) * t.ndim)
    return cache


def prefill(params, cfg: ArchConfig, tokens, vision_embeds=None, tp=None):
    """tokens (B, S_text) -> (last-token logits (B, vocab) f32, cache with
    ``len`` = S and each layer's K/V of length S and SSM state), S the
    text and any vision prefix.  ``tp``: the tensor-parallel context of
    the sharded prefill; the logits are then the rank's vocab slice
    where the vocab splits, and the K/V the rank's share of the cache
    (``tp.cache``)."""
    check_supported(cfg)
    x = _embed_tokens(params, cfg, tokens, vision_embeds, tp=tp)
    bsz, s_len = x.shape[:2]
    outs = {}
    for lp, window in zip(params["layers"], window_schedule(cfg)):
        emit = {}
        x, _ = _block_full(lp, cfg, x, int(window), emit=emit, tp=tp)
        for key, t in emit.items():
            outs.setdefault(key, []).append(t)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _logits_chunk(params, cfg, x[:, -1:],
                           tp and tp.on("vocab"))[:, 0]
    cache = {"len": torch.full((bsz,), s_len, dtype=torch.int32,
                               device=x.device)}
    for key in _CACHE_KEYS:
        if key in outs:
            cache[key] = torch.stack(outs[key])
    return logits, cache


def decode_step(params, cfg: ArchConfig, cache, tokens, *, ragged=False,
                kv_len: Optional[int] = None, tp=None):
    """One decode step.  tokens: (B, 1).  Returns (logits (B, vocab) f32,
    cache), the cache updated in place.

    ``kv_len``, when given, is the longest slot's length after this step,
    known on the host (at most the cache's length; the dry run passes
    the whole cache's): the step then reads no length off the device.
    Without it the step reads ``max(len) + 1``.  Either way the attention
    reads the first ``kv_len`` positions and masks each slot past its
    own length, so the results are the same.

    ragged=True takes per-slot cache lengths (continuous batching); the
    uniform path writes one position for the whole batch.  A live slot
    never runs past the cache: the uniform path raises when the K/V
    cache is full (JAX would clamp the write onto the last position),
    and the ragged path leaves that to the engine, which retires a slot
    at ``max_len``.  SSM layers step their conv/state cache, which has
    no length.

    ``tp``: the tensor-parallel context of the sharded decode step; the
    logits are then the rank's vocab slice where the vocab splits, the
    K/V cache the rank's share (``tp.cache``), the SSM state the rank's
    heads' where they split and the conv inputs whole."""
    check_supported(cfg)
    pc, mode = cfg.precision, cfg.quant_mode
    x = _embed_tokens(params, cfg, tokens, tp=tp)   # a gather: the same
    #                                  bits as JAX's one-hot contraction
    new_len = cache["len"] + 1
    attn = cfg.family != "ssm"
    longest = None
    if attn:
        s_len = cache["k"].shape[2] * (
            tp.size if tp is not None and tp.cache == "seq" else 1)
        longest = int(new_len.max()) if kv_len is None else kv_len
        if not ragged and longest > s_len:
            raise ValueError(f"decode_step: the cache holds {s_len} "
                             f"positions and is full; pad the prefill "
                             f"cache to max_len")
    packed = cfg.kv_cache_bits != 16
    for i, (lp, window) in enumerate(zip(params["layers"],
                                         window_schedule(cfg))):
        h = L.apply_norm(cfg.norm, lp["ln1"], x)
        parts = []
        if attn:
            if packed:
                ckv = (cache["k"][i], cache["k_scale"][i], cache["v"][i],
                       cache["v_scale"][i])
            else:
                ckv = (cache["k"][i], cache["v"][i])
            a, _ = _attn_block(lp["attn"], cfg, h, window=int(window),
                               q_offset=new_len - 1,
                               cache_kv=ckv, cache_len=new_len,
                               ragged=ragged, kv_len=longest, tp=tp)
            parts.append(a)
        if "ssm" in lp:
            s, st = M2.mamba2_decode_step(
                lp["ssm"], h, {"conv": cache["conv"][i],
                               "ssm": cache["ssm"][i]},
                cfg.ssm, cfg.d_model, pc=pc, mode=mode,
                tp=tp and tp.on("ssm"))
            cache["conv"][i] = st["conv"]
            cache["ssm"][i] = st["ssm"]
            parts.append(s)
        x, _ = _residual_tail(lp, cfg, x, _mix(lp, parts, x.dtype),
                              decode=True, tp=tp)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    logits = _logits_chunk(params, cfg, x, tp and tp.on("vocab"))[:, 0]
    cache["len"] = new_len
    return logits, cache
