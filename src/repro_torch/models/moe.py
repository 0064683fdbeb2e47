"""Mixture-of-Experts block: a top-k router with capacity-based dispatch.

Port of ``repro.models.moe``.  Two execution paths:

* **dispatch** (train / prefill): each (token, choice) slot is scattered
  into its expert's capacity buffer ``(B, E, C, d)``, the buffers run
  through the batched expert FFNs, and the slots are gathered back and
  combined with their gates.  Slots are slot-major (token 0's k choices,
  then token 1's) and a slot's position is the running count of earlier
  slots sent to its expert, per batch row.  A slot past the capacity is
  dropped: its input is zeroed and *added* at position ``C - 1``
  (``index_put_(accumulate=True)``, as JAX's ``.at[].add(mode="drop")``:
  a write there would overwrite the slot kept at ``C - 1``) and its
  output is masked out.
* **dense-mix** (decode): every expert runs on every token and the
  outputs are mixed with the top-k gates scattered into an ``(B, S, E)``
  weight.

Expert weights are stacked ``(E, d, f)`` dense tensors and, whenever the
precision is quantized, fake-quantized per expert along ``d`` whatever
the mode (as the JAX package does); the shared experts go through
:func:`~repro_torch.models.layers.linear`, so packed serving sends them
through ``packed_qmatmul``.  The expert products are plain batched
matmuls (``torch.einsum``), which the JAX package also leaves to XLA.

``tp`` (a ``distributed.tensor_parallel.TensorParallel``, the sharded
steps' tensor-parallel route) splits the experts over a mesh's ``model``
axis as JAX's sharding rules do: each rank holds a slice of every
expert's ``d_ff_expert`` (``wi``/``wg`` ``(E, d, f / m)``, ``wo``
``(E, f / m, d)``) and of the shared experts' hidden units.  The router
runs on the replicated input outside ``copy_in``, so every rank computes
the same gates, top-k and aux loss (whose gradient is then whole on
every rank); capacity and the dropped-slot rule depend only on that
routing.  The experts' input (``x`` before the dispatch, which is linear
and the same on every rank, so its backward all-reduces a ``(B, S, d)``
gradient, not the ``(B, E, C, d)`` buffer's), the shared experts' input
and the gates pass ``tp.copy_in``: a gate multiplies the rank's partial
expert output, so its gradient is a partial sum too.  The gate-combined
partial outputs and the shared experts' partial are summed, then
reduced once a layer (``tp.reduce_out`` on ``(B, S, d)``); the gate
product and the sum over the ``k`` choices are linear, so the order
changes only rounding, and on a one-rank ``model`` axis the op order is
the unsharded one, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import act_fn, he_init, linear
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.quant.qat import fake_quant

# Optional sharding pin for the dispatch buffers, installed by launch code
# (the JAX package's ``distributed/sharding.py`` installs one).
_BUF_HINT = None


def set_buffer_hint(fn) -> None:
    """fn(buf, kind) -> buf with a sharding constraint; None disables."""
    global _BUF_HINT
    _BUF_HINT = fn


def _hint(x, kind: str):
    return _BUF_HINT(x, kind) if _BUF_HINT is not None else x


# The mean over a batch split across ranks, installed by a sharded train
# step while its loss and gradient run (:func:`batch_mean`)
_BATCH_MEAN = None


@contextlib.contextmanager
def batch_mean(fn):
    """While entered, the aux loss's batch means (the mean router
    probability and top-1 load of each expert) pass ``fn``, which turns
    the mean over the rank's rows into the mean over the global batch:
    JAX computes them over the whole batch of its pjit'd step, and the
    product of two means is not the mean of the ranks' products.
    ``None`` leaves them local."""
    global _BATCH_MEAN
    before, _BATCH_MEAN = _BATCH_MEAN, fn
    try:
        yield
    finally:
        _BATCH_MEAN = before


def moe_init(gen: torch.Generator, d: int, cfg: MoEConfig, ffn_kind: str,
             dtype, device=None):
    """Random params: He-normal router (float32), stacked experts and, with
    ``n_shared_experts``, the shared experts' dense matrices."""
    e, f = cfg.n_experts, cfg.d_ff_expert
    p = {
        "router": he_init(gen, (d, e), torch.float32, fan_in=d,
                          device=device),
        "wi": he_init(gen, (e, d, f), dtype, fan_in=d, device=device),
        "wo": he_init(gen, (e, f, d), dtype, fan_in=f, device=device),
    }
    if ffn_kind == "glu":
        p["wg"] = he_init(gen, (e, d, f), dtype, fan_in=d, device=device)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = he_init(gen, (d, fs), dtype, fan_in=d,
                                 device=device)
        p["shared_wo"] = he_init(gen, (fs, d), dtype, fan_in=fs,
                                 device=device)
        if ffn_kind == "glu":
            p["shared_wg"] = he_init(gen, (d, fs), dtype, fan_in=d,
                                     device=device)
    return p


def _maybe_fq_expert(w, pc: Optional[PrecisionConfig], tp=None):
    """Fake-quant stacked expert weights (E, a, b): groups along a.  With
    ``tp``, ``a`` is the rank's share of a contraction split over
    ``model`` (``tp.fake_quant_rows``'s rule)."""
    if pc is None or not pc.quantized:
        return w
    if tp is not None:
        return tp.fake_quant_rows(w, pc)
    return fake_quant(w.transpose(-1, -2), pc).transpose(-1, -2)


def _router(p, x, cfg: MoEConfig):
    """x: (..., d) -> (gates (..., k), idx (..., k), aux_loss scalar)."""
    logits = x.to(torch.float32) @ p["router"]              # (..., E)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k puts the lower index first on a tie; torch.topk does
    # not (on the CPU it gave the higher one), a stable descending sort does
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True), 1e-9)
    # Switch-style load-balance aux loss over the top-1 choice
    e = cfg.n_experts
    me = torch.mean(probs.reshape(-1, e), dim=0)            # mean router prob
    ce = torch.mean(F.one_hot(idx.reshape(-1, cfg.top_k)[..., 0], e)
                    .to(torch.float32), dim=0)              # top-1 load frac
    if _BATCH_MEAN is not None:
        me, ce = _BATCH_MEAN(me), _BATCH_MEAN(ce)
    aux = torch.sum(me * ce) * e * cfg.aux_loss_weight
    return gates, idx, aux


def _expert_ffn(p, buf, ffn_kind: str, act: str, pc, compute_dtype,
                tp=None):
    """buf: (..., E, C, d) -> (..., E, C, d) through per-expert FFN; with
    ``tp``, the rank's ``f`` slice, whose output is a partial sum over
    ``model``."""
    a = act_fn(act)
    wi = _maybe_fq_expert(p["wi"], pc).to(compute_dtype)
    wo = _maybe_fq_expert(p["wo"], pc, tp).to(compute_dtype)
    if ffn_kind == "glu":
        wg = _maybe_fq_expert(p["wg"], pc).to(compute_dtype)
        h = a(torch.einsum("...ecd,edf->...ecf", buf, wg)) * torch.einsum(
            "...ecd,edf->...ecf", buf, wi)
    else:
        h = a(torch.einsum("...ecd,edf->...ecf", buf, wi))
    return torch.einsum("...ecf,efd->...ecd", h, wo)


def _shared_ffn(p, x, ffn_kind: str, act: str, pc, mode, tp=None):
    """The shared experts; with ``tp``, ``x`` has passed ``copy_in`` and
    the hidden units are the rank's slice: the output is a partial sum
    over ``model``, which the caller reduces with the experts'."""
    a = act_fn(act)
    if ffn_kind == "glu":
        h = a(linear({"w": p["shared_wg"]}, x, pc, mode)) * linear(
            {"w": p["shared_wi"]}, x, pc, mode)
    else:
        h = a(linear({"w": p["shared_wi"]}, x, pc, mode))
    if tp is None:
        return linear({"w": p["shared_wo"]}, h, pc, mode)
    w = p["shared_wo"]
    if pc is not None and pc.quantized and mode == "fake":
        w = tp.fake_quant_rows(w, pc)
    return h @ w.to(h.dtype)


def _split_parts(tp, x):
    """(context of the experts, of the shared experts, the input of the
    split ones): each context ``tp`` where its part splits over
    ``model``, else ``None``; the input ``x`` passed through
    ``tp.copy_in`` once where either splits."""
    if tp is None:
        return None, None, x
    ex, sh = tp.on("experts"), tp.on("shared")
    if _BUF_HINT is not None and ex is not None:
        raise NotImplementedError(
            "models.moe: a dispatch-buffer hint (set_buffer_hint) lays out "
            "whole buffers, and on the tensor-parallel route the expert "
            "outputs are partial sums over 'model'; run the hint on the "
            "FSDP route (tensor_parallel=False) or drop it")
    return ex, sh, (tp.copy_in(x) if ex or sh else x)


def _combine(y, shared, sh, tp):
    """``y`` (the experts' combined output) plus the shared experts'
    output, reduced over ``model`` once: the split parts summed before
    the reduce, the whole ones added after it, in the unsharded order
    (experts, then shared)."""
    if tp is not None and tp.experts:
        if shared is not None and sh is not None:
            y = y + shared
            shared = None
        y = tp.reduce_out(y)
    elif shared is not None and sh is not None:
        shared = tp.reduce_out(shared)
    return y if shared is None else y + shared


def capacity(cfg: MoEConfig, s_len: int) -> int:
    """Slots per expert and batch row for ``s_len`` tokens."""
    return max(1, int(s_len * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))


def _slots(flat_e: torch.Tensor, n_experts: int, cap: int):
    """Capacity positions of the slots ``flat_e`` (B, S*k) sends to their
    experts: each slot's running count among the earlier slots of its
    batch row with the same expert.  Returns (kept (B, S*k) bool, the
    position clipped to [0, cap - 1] as int64)."""
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)   # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) * onehot              # running count
    pos = torch.sum(pos, dim=-1) - 1                        # (B, S*k)
    keep = (pos < cap) & (pos >= 0)
    return keep, torch.clamp(pos, 0, cap - 1).to(torch.int64)


def moe_apply_dispatch(
    p,
    x: torch.Tensor,            # (B, S, d)
    cfg: MoEConfig,
    *,
    ffn_kind: str,
    act: str,
    pc: Optional[PrecisionConfig] = None,
    mode: str = "fake",
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch path, grouped along B.  Returns (y, aux_loss).
    ``tp``: the tensor-parallel context (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    ex, sh, xe = _split_parts(tp, x)

    gates, idx, aux = _router(p, x, cfg)                    # (B, S, k)
    flat_e = idx.reshape(b, s * k)                          # expert of a slot
    gate_f = gates.reshape(b, s * k)
    if ex is not None:
        gate_f = ex.copy_in(gate_f)

    keep, pos_c = _slots(flat_e, e, c)

    xk = torch.repeat_interleave(xe if ex else x, k, dim=1)  # slot-major
    xk = xk * keep[..., None].to(x.dtype)
    b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, c, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((b_idx, flat_e, pos_c), xk, accumulate=True)
    buf = _hint(buf, "dispatch")

    out_buf = _hint(_expert_ffn(p, buf, ffn_kind, act, pc, x.dtype, ex),
                    "dispatch")

    y_slots = out_buf[b_idx, flat_e, pos_c]                 # (B, S*k, d)
    y_slots = y_slots * (keep.to(torch.float32) * gate_f)[..., None].to(
        x.dtype)
    y = torch.sum(y_slots.reshape(b, s, k, d), dim=2)

    shared = None
    if cfg.n_shared_experts:
        shared = _shared_ffn(p, xe if sh else x, ffn_kind, act, pc, mode, sh)
    return _combine(y, shared, sh, tp), aux


def moe_apply_dense(
    p,
    x: torch.Tensor,            # (B, S, d); decode: S == 1
    cfg: MoEConfig,
    *,
    ffn_kind: str,
    act: str,
    pc: Optional[PrecisionConfig] = None,
    mode: str = "fake",
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-mixture path (decode): all experts on all tokens,
    gate-combined.  ``tp``: the tensor-parallel context (module
    docstring); the float32 gate mix is cast to the model dtype before
    the reduce over ``model``, which then runs in that dtype, as the
    dispatch path's."""
    b, s, d = x.shape
    e = cfg.n_experts
    ex, sh, xe = _split_parts(tp, x)
    gates, idx, aux = _router(p, x, cfg)                    # (B, S, k)
    # the top-k gates scattered into a dense (B, S, E) weight
    dense_g = torch.sum(F.one_hot(idx, e).to(torch.float32)
                        * gates[..., None], dim=2)          # (B, S, E)
    if ex is not None:
        dense_g = ex.copy_in(dense_g)
    buf = (xe if ex else x)[:, None].expand(b, e, s, d)     # (B, E, C=S, d)
    out = _expert_ffn(p, buf, ffn_kind, act, pc, x.dtype,
                      ex)                                   # (B, E, S, d)
    y = torch.einsum("besd,bse->bsd", out.to(torch.float32),
                     dense_g).to(x.dtype)
    shared = None
    if cfg.n_shared_experts:
        shared = _shared_ffn(p, xe if sh else x, ffn_kind, act, pc, mode, sh)
    return _combine(y, shared, sh, tp), aux


def moe_apply(p, x, cfg, *, ffn_kind, act, pc=None, mode="fake",
              decode: bool = False, tp=None):
    fn = (moe_apply_dense if (decode or cfg.force_dense)
          else moe_apply_dispatch)
    return fn(p, x, cfg, ffn_kind=ffn_kind, act=act, pc=pc, mode=mode,
              tp=tp)
