"""Mamba-2 (SSD, state-space duality) mixer, arXiv:2405.21060.

Port of ``repro.models.mamba2``.  Train / prefill run the chunked
algorithm: within a chunk the SSD operator is a masked, decay-weighted
attention-like product; across chunks a small float32 state
``(B, nh, hp, N)`` is carried.  A Python loop over the chunks replaces
``jax.lax.scan``, so peak memory is O(chunk^2) per head.  Decode is the
exact O(1) recurrent step, with the last ``conv_width - 1`` raw conv
inputs and the SSM state as its cache.

The in/out projections go through
:func:`~repro_torch.models.layers.linear` (``packed_qmatmul`` when
packed); the depthwise causal conv, the scan and the gated norm are plain
PyTorch, as the JAX package leaves them to XLA.

``tp=`` (the sharded steps' ``distributed.tensor_parallel`` context,
where the heads divide the mesh's ``model`` axis) runs the rank's heads,
as XLA splits JAX's pjit'd mixer: ``in_proj`` and the conv narrowed to
the z, x and dt of those heads with B and C whole, the scan on those
heads, the gated norm's mean reduced over ``model``, ``out_proj``
row-parallel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import he_init, linear
from repro_torch.quant.formats import PrecisionConfig


def mamba2_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, dtype,
                device=None):
    """Random params: He-normal projections, conv taps N(0, 0.1), ``A_log``
    the log of a uniform draw in [1, 16), and ``dt_bias`` the inverse
    softplus of a log-uniform draw in [dt_min, dt_max]."""
    din = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    g_n = cfg.n_groups * cfg.d_state
    conv_ch = din + 2 * g_n
    d_in_proj = 2 * din + 2 * g_n + nh

    def uniform(n):
        return torch.rand((n,), generator=gen, dtype=torch.float32,
                          device=device)

    in_proj = he_init(gen, (d_model, d_in_proj), dtype, device=device)
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=gen,
                         dtype=torch.float32, device=device) * 0.1
    a_log = torch.log(1.0 + 15.0 * uniform(nh))
    lo, hi = math.log(cfg.dt_min), math.log(cfg.dt_max)
    dt = torch.exp(uniform(nh) * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))             # inverse softplus
    out_proj = he_init(gen, (din, d_model), dtype, device=device)
    return {
        "in_proj": {"w": in_proj},
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": a_log,
        "dt_bias": dt_bias,
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "norm_g": torch.ones((din,), dtype=dtype, device=device),
        "out_proj": {"w": out_proj},
    }


def _widths(cfg: SSMConfig, d_model: int, tp) -> Tuple[int, int]:
    """(d_inner, heads) the mixer runs: the whole ones, or with ``tp``
    the rank's."""
    if tp is None:
        return cfg.d_inner(d_model), cfg.n_heads(d_model)
    return tp.ssm_heads * cfg.head_dim, tp.ssm_heads


def _split_zxbcdt(z_x_b_c_dt, din, nh, cfg: SSMConfig):
    g_n = cfg.n_groups * cfg.d_state
    z = z_x_b_c_dt[..., :din]
    xbc = z_x_b_c_dt[..., din:2 * din + 2 * g_n]
    dt = z_x_b_c_dt[..., 2 * din + 2 * g_n:]
    if dt.shape[-1] != nh:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt heads, not {nh}")
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b):
    """Depthwise causal conv along seq.  xbc: (B, L, C); conv_w: (W, C)."""
    w = conv_w.shape[0]
    n = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = pad[:, 0:n] * conv_w[0][None, None]
    for i in range(1, w):
        out = out + pad[:, i:i + n] * conv_w[i][None, None]
    return F.silu(out + conv_b[None, None])


def _gated_norm(y, z, g, eps=1e-6, tp=None):
    """RMSNorm(y * silu(z)) * g, mamba2's gated output norm.  With ``tp``
    the channels are the rank's heads' and the mean runs over the whole
    ``d_inner``: each rank's mean over its channels, weighed by its share
    ``1 / model``, summed over ``model`` (:meth:`~repro_torch.distributed.
    tensor_parallel.TensorParallel.sum_over`).  On a one-rank ``model``
    axis that is ``torch.mean`` times 1.0 and a sum over one rank: the
    unsharded arithmetic, bit for bit."""
    yf = (y * F.silu(z.to(torch.float32))).to(torch.float32)
    ms = torch.mean(yf * yf, -1, keepdim=True)
    if tp is not None:
        ms = tp.sum_over(ms * (1.0 / tp.size))
    r = yf * torch.rsqrt(ms + eps)
    return (r * g.to(torch.float32)).to(y.dtype)


def _whole_conv(raw, din, tp):
    """The rank's raw conv inputs ``(..., din + 2 g N)`` (its heads' x
    channels, B and C) -> every channel's, the x channels gathered over
    ``model``; ``raw`` itself without ``tp``."""
    if tp is None:
        return raw
    return torch.cat([tp.gather_last(raw[..., :din]), raw[..., din:]], -1)


def ssd_chunked(
    x: torch.Tensor,     # (B, L, nh, hp)
    dt: torch.Tensor,    # (B, L, nh), post-softplus
    a: torch.Tensor,     # (nh,), negative
    b_in: torch.Tensor,  # (B, L, g, N)
    c_in: torch.Tensor,  # (B, L, g, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  Returns (y (B, L, nh, hp), h_final (B, nh, hp, N)).
    ``L`` must be a multiple of ``chunk``."""
    bb, n_len, nh, hp = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    hpg = nh // g                                  # heads per group
    nc = n_len // chunk
    if nc * chunk != n_len:
        raise ValueError(f"ssd_chunked: seq {n_len} is not a multiple of "
                         f"the chunk {chunk}")
    h = (torch.zeros((bb, nh, hp, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    # i >= j within a chunk; the exponent is masked BEFORE the exp: for
    # i < j it is positive and overflows, and its gradient turns to NaN
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        xb, dtb, bb_, cb = x[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl]
        da = dtb * a[None, None]                   # (B, c, nh), negative
        cum = torch.cumsum(da, dim=1)              # (B, c, nh)
        # ----- intra-chunk (masked decay attention) -----
        diff = cum[:, :, None] - cum[:, None, :]   # (B, c, c, nh)
        diff = torch.where(mask, diff, torch.full_like(diff[:1, :1, :1],
                                                       -1e9))
        lmat = torch.exp(diff)
        # scores (C_i . B_j) per group, repeated over the group's heads
        cbm = torch.einsum("bign,bjgn->bijg", cb.to(torch.float32),
                           bb_.to(torch.float32))  # (B, c, c, g)
        cbm = torch.repeat_interleave(cbm, hpg, dim=-1)   # (B, c, c, nh)
        w = cbm * lmat * dtb[:, None, :, :]        # weight of x_j on y_i
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xb.to(torch.float32))
        # ----- contribution of the carried state -----
        decay_in = torch.exp(cum)                  # exp(cum_i)
        ch = torch.repeat_interleave(cb, hpg, dim=2).to(torch.float32)
        y_off = torch.einsum("bihn,bhpn->bihp", ch * decay_in[..., None], h)
        # ----- state update -----
        total = cum[:, -1]                         # (B, nh)
        decay_st = torch.exp(total[:, None] - cum)  # (B, c, nh)
        bh = torch.repeat_interleave(bb_, hpg, dim=2).to(torch.float32)
        dx = (dtb * decay_st)[..., None] * xb.to(torch.float32)
        h = h * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bchp,bchn->bhpn", dx, bh)
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), h


def mamba2_apply(
    p,
    x: torch.Tensor,            # (B, L, d_model)
    cfg: SSMConfig,
    d_model: int,
    *,
    pc: Optional[PrecisionConfig] = None,
    mode: str = "fake",
    return_state: bool = False,
    tp=None,
    copied: bool = False,
):
    """Full mixer forward (train / prefill).  With ``return_state`` also
    returns the decode cache {"conv": the last conv_width - 1 raw conv
    inputs, "ssm": the final state}.  The chunk is
    ``min(chunk_size, L)``.

    ``tp`` (a ``TensorParallel`` whose ``ssm`` flag is set) runs the
    rank's heads: ``p`` holds its shards of ``out_proj``'s rows,
    ``A_log``, ``dt_bias``, ``D`` and ``norm_g``, and ``in_proj`` and the
    conv whole, which :meth:`~repro_torch.distributed.tensor_parallel.
    TensorParallel.ssm_shard` narrows; the input passes ``copy_in``
    (unless ``copied``: the caller passed it already), the conv and the
    scan need no collective, the gated norm sums over ``model`` and
    ``out_proj`` is row-parallel.  The state returned is the rank's
    heads', the conv inputs every channel's."""
    din, nh = _widths(cfg, d_model, tp)
    g, n = cfg.n_groups, cfg.d_state
    bb, n_len, _ = x.shape
    if tp is not None:
        x, p = x if copied else tp.copy_in(x), tp.ssm_shard(p)

    zxbcdt = linear(p["in_proj"], x, pc, mode)
    z, xbc_raw, dt = _split_zxbcdt(zxbcdt, din, nh, cfg)
    xbc = _causal_conv(xbc_raw, p["conv_w"], p["conv_b"])
    xs = xbc[..., :din].reshape(bb, n_len, nh, cfg.head_dim)
    b_in = xbc[..., din:din + g * n].reshape(bb, n_len, g, n)
    c_in = xbc[..., din + g * n:].reshape(bb, n_len, g, n)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None])
    a = -torch.exp(p["A_log"])

    chunk = min(cfg.chunk_size, n_len)
    y, h_final = ssd_chunked(xs, dt, a, b_in, c_in, chunk)
    y = y + p["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(bb, n_len, din).to(x.dtype)
    y = _gated_norm(y, z, p["norm_g"], tp=tp)
    out = linear(p["out_proj"], y, pc, mode, tp=tp)
    if return_state:
        return out, {"conv": _whole_conv(
            xbc_raw[:, -(cfg.conv_width - 1):], din, tp), "ssm": h_final}
    return out


# ---------------------------------------------------------------------------
# decode: the O(1) recurrent step with a (conv state, ssm state) cache
# ---------------------------------------------------------------------------


def mamba2_init_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                      device=None):
    din = cfg.d_inner(d_model)
    nh = cfg.n_heads(d_model)
    conv_ch = din + 2 * cfg.n_groups * cfg.d_state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode_step(
    p,
    x: torch.Tensor,            # (B, 1, d_model)
    cache: dict,
    cfg: SSMConfig,
    d_model: int,
    *,
    pc: Optional[PrecisionConfig] = None,
    mode: str = "fake",
    tp=None,
):
    """One token: returns (out (B, 1, d_model), new cache).  ``tp`` as in
    :func:`mamba2_apply`: the cache's state is the rank's heads', its
    conv inputs every channel's, in and out."""
    din, nh = _widths(cfg, d_model, tp)
    g, n = cfg.n_groups, cfg.d_state
    hpg = nh // g
    bb = x.shape[0]
    if tp is not None:
        x, p = tp.copy_in(x), tp.ssm_shard(p)

    zxbcdt = linear(p["in_proj"], x[:, 0], pc, mode)        # (B, dproj)
    z, xbc, dt = _split_zxbcdt(zxbcdt, din, nh, cfg)
    # the conv over the cached W-1 inputs and the current one
    conv = cache["conv"] if tp is None else tp.ssm_channels(cache["conv"])
    win = torch.cat([conv, xbc[:, None]], dim=1)            # (B, W, C)
    conv_out = torch.sum(win * p["conv_w"][None], dim=1) + p["conv_b"][None]
    xbc_t = F.silu(conv_out)
    new_conv = torch.cat([cache["conv"][:, 1:],
                          _whole_conv(xbc, din, tp)[:, None]], dim=1)

    xs = xbc_t[..., :din].reshape(bb, nh, cfg.head_dim)
    b_in = xbc_t[..., din:din + g * n].reshape(bb, g, n)
    c_in = xbc_t[..., din + g * n:].reshape(bb, g, n)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None])
    a = -torch.exp(p["A_log"])

    da = torch.exp(dt * a[None])                            # (B, nh)
    bh = torch.repeat_interleave(b_in, hpg, dim=1).to(torch.float32)
    ch = torch.repeat_interleave(c_in, hpg, dim=1).to(torch.float32)
    h = cache["ssm"] * da[:, :, None, None] + (
        (dt[..., None] * xs.to(torch.float32))[..., None]
        * bh[:, :, None, :])                                # (B, nh, hp, N)
    y = torch.einsum("bhpn,bhn->bhp", h, ch)
    y = y + p["D"][None, :, None] * xs.to(torch.float32)
    y = y.reshape(bb, din).to(x.dtype)
    y = _gated_norm(y, z, p["norm_g"], tp=tp)
    out = linear(p["out_proj"], y, pc, mode, tp=tp)[:, None]  # (B, 1, d)
    return out, {"conv": new_conv, "ssm": h}
