"""Gradient compression: int8 error-feedback all-reduce over a DP group.

Port of ``repro.distributed.compression`` on ``torch.distributed``.  A
ring float32 all-reduce moves ~2x4 bytes an element over the slowest
link; :func:`ef_int8_allreduce_mean` moves int8 codes: a reduce-scatter
of the codes (``all_to_all_single`` plus a local float32 sum), then an
all-gather of the re-quantized result, ~2x1 bytes an element.  The
quantization error is kept in an error-feedback buffer and re-injected
next step (EF-SGD, Karimireddy et al. 2019).

The arithmetic is the one JAX's compiled step (``jit`` over
``shard_map``) carries out, so codes, errors and outputs are JAX's bit
for bit (an output could differ only where a float64 sum rounds twice):
``x = g + err`` in float32; one float32 scale
``max(absmax, 1e-12) / 127`` over the rank's whole buffer, the division
by the constant done as XLA does it, a multiply by float32 ``1/127``;
codes ``clip(round_half_even(x / scale), -127, 127)``; the new error
``x - codes * scale`` and the partial sum of the received chunks over
peers in rank order as fused multiply-adds (one rounding each; in
float64 here, where product and sum are exact); the sum times float32
``1/n``; then the same quantization per chunk.  :func:`ef_int8_plain`
is the same arithmetic over every rank's inputs in one process, with
the collectives taken out.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten_like


def _recip(n: int, like: torch.Tensor) -> torch.Tensor:
    """float32 ``1/n``: XLA's rewrite of a division by a constant."""
    return torch.tensor(1.0 / n, dtype=torch.float32, device=like.device)


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp_min(torch.amax(torch.abs(x)), 1e-12) * _recip(127, x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _encode(g: torch.Tensor, err: torch.Tensor, n: int):
    """(codes (n, chunk), scale, new_err) of one rank's buffer."""
    x = g.to(torch.float32) + err.to(torch.float32)
    q, scale = _quant_int8(x.reshape(n, -1))
    # x - q * scale, one rounding
    sent = q.to(torch.float64) * scale.to(torch.float64)
    new_err = (x.to(torch.float64) - sent.reshape(g.shape)).to(
        torch.float32).to(err.dtype)
    return q, scale, new_err


def _reduce_chunk(qt: torch.Tensor, scales: torch.Tensor, n: int):
    """A rank's reduced chunk from every peer's codes for it, re-quantized."""
    acc = torch.zeros(qt.shape[1], dtype=torch.float64, device=qt.device)
    for i in range(n):                 # a multiply-add per peer, in order
        acc = (acc + qt[i].to(torch.float64) * scales[i].to(torch.float64)
               ).to(torch.float32).to(torch.float64)
    return _quant_int8(acc.to(torch.float32) * _recip(n, qt))


def ef_int8_allreduce_mean(g: torch.Tensor, err: torch.Tensor, group=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``g`` over ``group`` with an int8 wire format and error
    feedback.  ``err`` is the float32 error buffer of ``g``'s shape.
    Returns (mean gradient float32, new_err).  ``g.numel()`` must be a
    multiple of the group size (:func:`tree_ef_allreduce_mean` pads)."""
    n = dist.get_world_size(group)
    q, scale, new_err = _encode(g, err, n)
    qt = torch.empty_like(q)
    dist.all_to_all_single(qt, q.contiguous(), group=group)
    scales = _all_gather(scale.reshape(1), n, group)[:, 0]
    pq, ps = _reduce_chunk(qt, scales, n)
    full_q = _all_gather(pq, n, group)
    full_s = _all_gather(ps.reshape(1), n, group)[:, 0]
    out = (full_q.to(torch.float32) * full_s[:, None]).reshape(g.shape)
    return out, new_err


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def ef_int8_plain(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """:func:`ef_int8_allreduce_mean` over ``len(gs)`` ranks in one
    process: rank ``r``'s inputs are ``gs[r]``, ``errs[r]``.  Returns
    every rank's (out, new_err) lists."""
    n = len(gs)
    enc = [_encode(g, e, n) for g, e in zip(gs, errs)]
    scales = torch.stack([s for _, s, _ in enc])
    red = [_reduce_chunk(torch.stack([q[r] for q, _, _ in enc]), scales, n)
           for r in range(n)]
    full_q = torch.stack([pq for pq, _ in red])
    full_s = torch.stack([ps for _, ps in red])
    out = (full_q.to(torch.float32) * full_s[:, None]).reshape(gs[0].shape)
    return [out] * n, [ne for _, _, ne in enc]


def _pad(t: torch.Tensor, n: int) -> torch.Tensor:
    flat = t.reshape(-1).to(torch.float32)
    return torch.cat([flat, flat.new_zeros((-flat.numel()) % n)])


def tree_ef_allreduce_mean(grads, errs, group=None):
    """:func:`ef_int8_allreduce_mean` leaf by leaf over a tree, each leaf
    padded with zeros to a multiple of the group size.  Returns
    (mean grads, new errs), trees of ``grads``' structure."""
    n = dist.get_world_size(group)
    outs, new_errs = [], []
    for g, e in zip(leaves(grads), leaves(errs)):
        out, ne = ef_int8_allreduce_mean(_pad(g, n), _pad(e, n), group)
        outs.append(out[:g.numel()].reshape(g.shape))
        new_errs.append(ne[:g.numel()].reshape(g.shape).to(e.dtype))
    return unflatten_like(grads, outs), unflatten_like(errs, new_errs)


def tree_ef_plain(grads_per_rank, errs_per_rank):
    """:func:`tree_ef_allreduce_mean` over every rank's trees in one
    process, with the collectives taken out.  Returns each rank's
    (mean grads, new errs) trees."""
    n = len(grads_per_rank)
    flat_g = [leaves(t) for t in grads_per_rank]
    flat_e = [leaves(t) for t in errs_per_rank]
    outs = [[] for _ in range(n)]
    new_errs = [[] for _ in range(n)]
    for i, g0 in enumerate(flat_g[0]):
        o, ne = ef_int8_plain([_pad(fg[i], n) for fg in flat_g],
                              [_pad(fe[i], n) for fe in flat_e])
        for r in range(n):
            outs[r].append(o[r][:g0.numel()].reshape(g0.shape))
            new_errs[r].append(ne[r][:g0.numel()].reshape(g0.shape)
                               .to(flat_e[r][i].dtype))
    return ([unflatten_like(grads_per_rank[r], outs[r]) for r in range(n)],
            [unflatten_like(errs_per_rank[r], new_errs[r])
             for r in range(n)])
