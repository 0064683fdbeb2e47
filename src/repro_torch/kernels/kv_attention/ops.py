"""Public entry point of packed-KV decode attention, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel
  ``csrc/kv_attention.cu``, or raises.  There is no fallback from one to
  the other.

The kernel covers every variant the plain version does: a sliding
``window`` (a Python int, 0 = global), ``logit_cap`` (tanh soft cap),
per-batch ``cache_len`` and any cache length S.  It needs head_dim <= 256
and at most 8 query heads per KV head.  One difference in a case no
decode step reaches: with ``cache_len`` 0 the kernel returns zeros where
the plain version averages every (masked) position.

Each (batch row, KV head) is one thread-block cluster of
:func:`_split` blocks, block r taking the r-th contiguous share of the
live keys.

``quant_kv_decode_attention.launches`` counts kernel launches (and
nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.kv_attention import ref as _ref
from repro_torch.kernels.smem import N_SMS

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_HEAD_DIM = 256
MAX_GROUP = 8


def _split(pairs: int) -> int:
    """Blocks per (batch row, KV head) for ``pairs`` of them: the most of
    8, 4 and 2 that keeps the grid within 2 blocks (of 8 warps) per SM, so
    every cluster is resident in one wave; 2 beyond that."""
    for split in (8, 4):
        if pairs * split <= 2 * N_SMS:
            return split
    return 2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_attention")
    lib.kv_attention_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 +
        [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    lib.kv_attention_launch.restype = ctypes.c_int
    lib.kv_attention_error_string.argtypes = [ctypes.c_int]
    lib.kv_attention_error_string.restype = ctypes.c_char_p
    return lib


def quant_kv_decode_attention(
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
    """One-token GQA attention over the packed cache.  Returns
    (B, 1, H, hd) in ``q``'s dtype."""
    b, one, h, hd = q.shape
    s_len, kh, wpp = k_packed.shape[1:]
    if one != 1:
        raise ValueError(f"decode attention takes one query token, got {one}")
    if h % kh:
        raise ValueError(f"{h} query heads over {kh} KV heads")
    if bits not in (2, 4, 8) or wpp != -(-hd * bits // 32):
        raise ValueError(f"cache words {wpp} per head do not hold {hd} "
                         f"{bits}-bit codes")
    dev = q.device
    if dev.type == "cpu":
        return _ref.quant_kv_decode_attention_ref(
            q, k_packed, k_scale, v_packed, v_scale, bits=bits, scale=scale,
            cache_len=cache_len, window=window, logit_cap=logit_cap)
    if dev.type != "cuda":
        raise ValueError(f"quant_kv_decode_attention: unsupported device "
                         f"{dev}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"quant_kv_decode_attention: q dtype {q.dtype}")
    g = h // kh
    if hd > MAX_HEAD_DIM or g > MAX_GROUP:
        raise ValueError(f"quant_kv_decode_attention: head_dim {hd} (max "
                         f"{MAX_HEAD_DIM}) or {g} query heads per KV head "
                         f"(max {MAX_GROUP}) has no kernel variant")
    for name, t in (("k_packed", k_packed), ("k_scale", k_scale),
                    ("v_packed", v_packed), ("v_scale", v_scale)):
        if t.device != dev:
            raise ValueError(f"quant_kv_decode_attention: {name} on "
                             f"{t.device}, q on {dev}")
    lens = torch.broadcast_to(
        torch.as_tensor(cache_len, dtype=torch.int32, device=dev).reshape(-1),
        (b,)).contiguous()
    qc = q.contiguous()
    kp, vp = k_packed.contiguous(), v_packed.contiguous()
    ks = k_scale.to(torch.float32).contiguous()
    vs = v_scale.to(torch.float32).contiguous()
    out = torch.empty_like(qc)
    if b == 0 or kh == 0:
        return out
    vec16 = int(wpp % 4 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (kp, vp)))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.kv_attention_launch(
            qc.data_ptr(), kp.data_ptr(), ks.data_ptr(), vp.data_ptr(),
            vs.data_ptr(), lens.data_ptr(), out.data_ptr(), b, s_len, kh, g,
            hd, bits, int(window), int(logit_cap is not None), float(scale),
            float(logit_cap or 0.0), _DTYPES[q.dtype], vec16, _split(b * kh),
            stream)
    if err != 0:
        raise RuntimeError(
            f"kv_attention kernel launch failed: CUDA error {err} "
            f"({lib.kv_attention_error_string(err).decode()})")
    _build.count_launch(quant_kv_decode_attention)
    return out


quant_kv_decode_attention.launches = 0
