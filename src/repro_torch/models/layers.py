"""Primitive layers: norms, rotary, quantized linears, attention, FFN and
the spiking FFN.

Port of ``repro.models.layers``.  Params are plain dicts of tensors, and
every linear routes through :func:`linear`, the L-SPINE multi-precision
datapath: dense, fake-quant (QAT), or packed low-bit weights through the
``packed_qmatmul`` kernel (kernels/csrc/packed_qmatmul.cu on a CUDA
tensor).  Attention, norms, rotary and the spiking FFN's LIF rollout
are plain PyTorch, as the JAX package leaves them to XLA; every function
here is differentiable (the fake-quant's straight-through estimator and
the LIF's surrogate spike are ``torch.autograd.Function``s).  Only the
context-parallel attention hint (:func:`set_attention_cp`) is not
ported.

Numerics follow the JAX package: norms and rotary compute in float32 and
cast back; attention products take their (bfloat16) operands up to
float32 and accumulate there, as JAX's ``preferred_element_type`` does
(a bfloat16 product is exact in float32).  On a card this is full float32
only with ``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's
default.  ``window`` is a Python int per layer (0 = global).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.packed_qmatmul import ops as packed_qmatmul_ops
from repro_torch.quant.formats import PrecisionConfig, QuantizedTensor
from repro_torch.quant.qat import fake_quant

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def he_init(gen: torch.Generator, shape, dtype, fan_in=None, device=None):
    fan_in = fan_in or shape[0]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (2.0 / fan_in) ** 0.5).to(dtype)


def linear_init(gen: torch.Generator, d_in, d_out, dtype, bias=False,
                device=None):
    p = {"w": he_init(gen, (d_in, d_out), dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# the multi-precision linear (the paper's datapath, framework-wide)
# ---------------------------------------------------------------------------


def linear(p, x: torch.Tensor, pc: Optional[PrecisionConfig] = None,
           mode: str = "fake") -> torch.Tensor:
    """y = x @ W (+ b), through the precision-selected path.

    p["w"] is either a dense (d_in, d_out) tensor, or, in packed serving
    mode, a QuantizedTensor holding (d_out, d_in) sub-word packed codes.
    """
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        y = packed_qmatmul_ops.qmatmul(x, w)
    else:
        if pc is not None and pc.quantized and mode == "fake":
            # fake-quant along the contraction: groups run over d_in
            w = fake_quant(w.T, pc).T
        y = x @ w.to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(kind: str, d: int, dtype, device=None):
    if kind == "rmsnorm":
        return {"g": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"g": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "nonparam_ln":   # olmo: no learnable affine
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, p, x: torch.Tensor, eps=1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        return (y * p["g"].to(torch.float32)).to(x.dtype)
    mu = torch.mean(xf, -1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * p["g"].to(torch.float32) + p["b"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,) int."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions.to(torch.float32)[..., None] * freq     # (B?, S, half)
    if ang.ndim == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

NEG_INF = -2.0e38


def set_attention_cp(hint=None, q_chunk=None, kv_chunk=None) -> None:
    """The context-parallel attention hint of the JAX package (a GSPMD
    sharding hook) is not ported."""
    raise NotImplementedError(
        "set_attention_cp: the context-parallel attention hint is not "
        "ported to repro_torch")


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: int, prefix_len: int = 0) -> torch.Tensor:
    """(Sq, Sk) additive bias in float32 (0 or NEG_INF)."""
    qi = q_pos[:, None]
    kj = k_pos[None, :]
    # padded keys carry a 2**30 sentinel position: always masked
    ok = kj < 2 ** 29
    if causal:
        c = kj <= qi
        if prefix_len:
            c = c | (kj < prefix_len)
        ok = ok & c
    if window:
        ok = ok & (kj > qi - window)
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, K, hd)
    v: torch.Tensor,            # (B, Sk, K, hd)
    *,
    scale: float,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    logit_cap: Optional[float] = None,
    q_offset: int = 0,
    kv_chunk: int = 1024,
    q_chunk: int = 512,
    chunked: Optional[bool] = None,
) -> torch.Tensor:
    """GQA attention, un-chunked or with a chunked online softmax over key
    blocks (flash-style), chosen by size as in the JAX package."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    if chunked is None:
        chunked = sq * sk > 4096 * 4096 // 4 and sq > 1
    dev = q.device
    q_pos = q_offset + torch.arange(sq, dtype=torch.int32, device=dev)
    k_pos = torch.arange(sk, dtype=torch.int32, device=dev)
    qg = q.reshape(b, sq, kh, g, hd).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    if not chunked:
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kf) * scale
        s = softcap(s, logit_cap)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window,
                           prefix_len=prefix_len)[None, None, None]
        p = torch.softmax(s, dim=-1)
        pv = p.to(v.dtype).to(torch.float32)
        o = torch.einsum("bkgqs,bskh->bqkgh", pv, vf)
        return o.reshape(b, sq, h, hd).to(q.dtype)

    # ---- chunked path: fold q chunks into batch, loop over kv chunks ------
    nq = -(-sq // q_chunk)
    pad_q = nq * q_chunk - sq
    if pad_q:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad_q))
        q_pos_p = torch.cat([q_pos, q_pos[-1:].expand(pad_q)])
    else:
        q_pos_p = q_pos
    qc = qg.reshape(b, nq, q_chunk, kh, g, hd)
    qpc = q_pos_p.reshape(nq, q_chunk)

    nk = -(-sk // kv_chunk)
    pad_k = nk * kv_chunk - sk
    kc = F.pad(kf, (0, 0, 0, 0, 0, pad_k)).reshape(b, nk, kv_chunk, kh, hd)
    vc = F.pad(vf, (0, 0, 0, 0, 0, pad_k)).reshape(b, nk, kv_chunk, kh, hd)
    kpc = torch.cat([k_pos, torch.full((pad_k,), 2 ** 30, dtype=torch.int32,
                                       device=dev)]).reshape(nk, kv_chunk)

    m = torch.full((b, nq, kh, g, q_chunk), NEG_INF, dtype=torch.float32,
                   device=dev)
    l_sum = torch.zeros_like(m)
    acc = torch.zeros((b, nq, kh, g, q_chunk, hd), dtype=torch.float32,
                      device=dev)
    for c in range(nk):
        s = torch.einsum("bnqkgh,bskh->bnkgqs", qc, kc[:, c]) * scale
        s = softcap(s, logit_cap)
        bias = torch.stack([
            _mask_bias(qpc[i], kpc[c], causal=causal, window=window,
                       prefix_len=prefix_len) for i in range(nq)])
        s = s + bias[None, :, None, None]
        m_blk = torch.amax(s, dim=-1)
        m_new = torch.maximum(m, m_blk)
        # guard fully-masked rows: keep m_new finite
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        corr = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m) - m_safe)
        corr = torch.where(m <= NEG_INF / 2, 0.0, corr)
        l_sum = l_sum * corr + torch.sum(p, dim=-1)
        pv = p.to(v.dtype).to(torch.float32)
        o_blk = torch.einsum("bnkgqs,bskh->bnkgqh", pv, vc[:, c])
        acc = acc * corr[..., None] + o_blk
        m = m_new
    o = acc / torch.clamp_min(l_sum, 1e-20)[..., None]
    o = o.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * q_chunk, kh * g, hd)
    return o[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (B, 1, H, hd)
    k_cache: torch.Tensor,      # (B, S, K, hd)
    v_cache: torch.Tensor,
    *,
    scale: float,
    cache_len,                  # int, () or (B,): valid prefix per slot
    window: int = 0,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention against a bf16 (or float32) KV cache, with
    per-slot ``cache_len`` (the serving engine's ragged slots)."""
    b, _, h, hd = q.shape
    s_len, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, hd).to(k_cache.dtype).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg,
                     k_cache.to(torch.float32)) * scale
    s = softcap(s, logit_cap)
    kj = torch.arange(s_len, dtype=torch.int32, device=q.device)[None, :]
    clen = torch.broadcast_to(
        torch.as_tensor(cache_len, dtype=torch.int32,
                        device=q.device).reshape(-1, 1), (b, 1))
    qi = clen - 1
    ok = kj < clen
    if window:
        ok = ok & (kj > qi - window)
    s = torch.where(ok[:, None, None, :], s,
                    torch.full_like(s[:1, :1, :1, :1], NEG_INF))
    p = torch.softmax(s, dim=-1)
    pv = p.to(v_cache.dtype).to(torch.float32)
    o = torch.einsum("bkgs,bskh->bkgh", pv, v_cache.to(torch.float32))
    return o.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def ffn_init(gen: torch.Generator, d: int, d_ff: int, kind: str, dtype,
             device=None):
    if kind == "glu":
        return {
            "wi": linear_init(gen, d, d_ff, dtype, device=device),
            "wg": linear_init(gen, d, d_ff, dtype, device=device),
            "wo": linear_init(gen, d_ff, d, dtype, device=device),
        }
    return {
        "wi": linear_init(gen, d, d_ff, dtype, device=device),
        "wo": linear_init(gen, d_ff, d, dtype, device=device),
    }


def ffn_apply(p, x: torch.Tensor, kind: str, act: str, pc=None,
              mode="fake") -> torch.Tensor:
    a = act_fn(act)
    if kind == "glu":
        h = a(linear(p["wg"], x, pc, mode)) * linear(p["wi"], x, pc, mode)
    else:
        h = a(linear(p["wi"], x, pc, mode))
    return linear(p["wo"], h, pc, mode)


# ---------------------------------------------------------------------------
# spiking FFN (L-SPINE execution of the MLP block, beyond the paper for LMs)
# ---------------------------------------------------------------------------


def spiking_ffn_apply(p, x: torch.Tensor, act: str, *, timesteps: int,
                      leak_shift: int, threshold: float, pc=None,
                      mode="fake") -> torch.Tensor:
    """FFN whose hidden activation is a LIF population run for T
    timesteps on the direct-encoded current; the output integrates the
    hidden spikes' rate.

    Rate-coded twin of the dense FFN: the forward uses core/lif.py's
    shift-add leak dynamics (float twin, fast-sigmoid surrogate gradient
    for training).  ``act`` is unused, as in the JAX package; so is a GLU
    FFN's ``wg``.
    """
    from repro_torch.core.lif import LIFConfig, lif_rollout_float

    cfg = LIFConfig(leak_shift=leak_shift, threshold=threshold,
                    timesteps=timesteps)
    cur = linear(p["wi"], x, pc, mode)                    # (..., d_ff)
    cur_t = cur.expand(timesteps, *cur.shape)
    v0 = torch.zeros_like(cur)
    _, s_t = lif_rollout_float(v0, cur_t, cfg)            # (T, ..., d_ff)
    rate = torch.mean(s_t, dim=0)                         # firing rate
    return linear(p["wo"], rate.to(x.dtype), pc, mode)
