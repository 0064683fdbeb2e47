"""Plain PyTorch version of decode attention over a PACKED quantized KV
cache.

Port of ``repro.kernels.kv_attention.ref``: the KV cache is stored
sub-word packed (INT2/4/8 along head_dim, one absmax scale per (position,
head)) and dequantized on the fly, rounded to bfloat16 as the JAX
package's ``dequantize_kv`` does by default.  Scores and the weighted sum
accumulate in float32 (bfloat16 products are exact in float32, so
casting the operands up reproduces JAX's ``preferred_element_type``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import packing

NEG_INF = -2.0e38


def quantize_kv(x: torch.Tensor, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) -> (packed int32 (..., hd*bits/32), scale (..., 1)
    f32).  Symmetric absmax over head_dim, one scale per (position,
    head)."""
    qmax = (1 << (bits - 1)) - 1
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / qmax, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -qmax - 1, qmax)
    return packing.pack(q.to(torch.int32), bits), scale.to(torch.float32)


def dequantize_kv(packed: torch.Tensor, scale: torch.Tensor, bits: int,
                  hd: int, dtype=torch.bfloat16) -> torch.Tensor:
    q = packing.unpack(packed, bits, hd).to(torch.float32)
    return (q * scale).to(dtype)


def _lens(cache_len, b: int, device) -> torch.Tensor:
    """``cache_len`` (int, () or (B,)) as a (B, 1) int32 tensor."""
    c = torch.as_tensor(cache_len, dtype=torch.int32, device=device)
    return torch.broadcast_to(c.reshape(-1, 1), (b, 1))


def quant_kv_decode_attention_ref(
    q: torch.Tensor,            # (B, 1, H, hd)
    k_packed: torch.Tensor,     # (B, S, K, hd*bits/32) int32
    k_scale: torch.Tensor,      # (B, S, K, 1) f32
    v_packed: torch.Tensor,
    v_scale: torch.Tensor,
    *,
    bits: int,
    scale: float,
    cache_len,
    window: int = 0,
    logit_cap: Optional[float] = None,
) -> torch.Tensor:
    b, _, h, hd = q.shape
    s_len, kh = k_packed.shape[1], k_packed.shape[2]
    g = h // kh
    k = dequantize_kv(k_packed, k_scale, bits, hd).to(torch.float32)
    v = dequantize_kv(v_packed, v_scale, bits, hd).to(torch.float32)
    qg = q.reshape(b, kh, g, hd).to(torch.bfloat16).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) * scale
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    kj = torch.arange(s_len, dtype=torch.int32, device=q.device)[None, :]
    clen = _lens(cache_len, b, q.device)
    qi = clen - 1
    ok = (kj < clen) & ((window == 0) | (kj > qi - window))
    s = torch.where(ok[:, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=torch.float32,
                                 device=q.device))
    p = torch.softmax(s, dim=-1)
    pb = p.to(torch.bfloat16).to(torch.float32)
    o = torch.einsum("bkgs,bskh->bkgh", pb, v)
    return o.reshape(b, 1, h, hd).to(q.dtype)
