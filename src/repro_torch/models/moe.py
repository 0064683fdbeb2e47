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
"""

from __future__ import annotations

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


def _maybe_fq_expert(w, pc: Optional[PrecisionConfig]):
    """Fake-quant stacked expert weights (E, a, b): groups along a."""
    if pc is None or not pc.quantized:
        return w
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
    aux = torch.sum(me * ce) * e * cfg.aux_loss_weight
    return gates, idx, aux


def _expert_ffn(p, buf, ffn_kind: str, act: str, pc, compute_dtype):
    """buf: (..., E, C, d) -> (..., E, C, d) through per-expert FFN."""
    a = act_fn(act)
    wi = _maybe_fq_expert(p["wi"], pc).to(compute_dtype)
    wo = _maybe_fq_expert(p["wo"], pc).to(compute_dtype)
    if ffn_kind == "glu":
        wg = _maybe_fq_expert(p["wg"], pc).to(compute_dtype)
        h = a(torch.einsum("...ecd,edf->...ecf", buf, wg)) * torch.einsum(
            "...ecd,edf->...ecf", buf, wi)
    else:
        h = a(torch.einsum("...ecd,edf->...ecf", buf, wi))
    return torch.einsum("...ecf,efd->...ecd", h, wo)


def _shared_ffn(p, x, ffn_kind: str, act: str, pc, mode):
    a = act_fn(act)
    if ffn_kind == "glu":
        h = a(linear({"w": p["shared_wg"]}, x, pc, mode)) * linear(
            {"w": p["shared_wi"]}, x, pc, mode)
    else:
        h = a(linear({"w": p["shared_wi"]}, x, pc, mode))
    return linear({"w": p["shared_wo"]}, h, pc, mode)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-dispatch path, grouped along B.  Returns (y, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)

    gates, idx, aux = _router(p, x, cfg)                    # (B, S, k)
    flat_e = idx.reshape(b, s * k)                          # expert of a slot
    gate_f = gates.reshape(b, s * k)

    keep, pos_c = _slots(flat_e, e, c)

    xk = torch.repeat_interleave(x, k, dim=1)               # slot-major
    xk = xk * keep[..., None].to(x.dtype)
    b_idx = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    buf = torch.zeros((b, e, c, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((b_idx, flat_e, pos_c), xk, accumulate=True)
    buf = _hint(buf, "dispatch")

    out_buf = _hint(_expert_ffn(p, buf, ffn_kind, act, pc, x.dtype),
                    "dispatch")

    y_slots = out_buf[b_idx, flat_e, pos_c]                 # (B, S*k, d)
    y_slots = y_slots * (keep.to(torch.float32) * gate_f)[..., None].to(
        x.dtype)
    y = torch.sum(y_slots.reshape(b, s, k, d), dim=2)

    if cfg.n_shared_experts:
        y = y + _shared_ffn(p, x, ffn_kind, act, pc, mode)
    return y, aux


def moe_apply_dense(
    p,
    x: torch.Tensor,            # (B, S, d); decode: S == 1
    cfg: MoEConfig,
    *,
    ffn_kind: str,
    act: str,
    pc: Optional[PrecisionConfig] = None,
    mode: str = "fake",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-mixture path (decode): all experts on all tokens,
    gate-combined."""
    b, s, d = x.shape
    e = cfg.n_experts
    gates, idx, aux = _router(p, x, cfg)                    # (B, S, k)
    # the top-k gates scattered into a dense (B, S, E) weight
    dense_g = torch.sum(F.one_hot(idx, e).to(torch.float32)
                        * gates[..., None], dim=2)          # (B, S, E)
    buf = x[:, None].expand(b, e, s, d)                     # (B, E, C=S, d)
    out = _expert_ffn(p, buf, ffn_kind, act, pc, x.dtype)   # (B, E, S, d)
    y = torch.einsum("besd,bse->bsd", out.to(torch.float32),
                     dense_g).to(x.dtype)
    if cfg.n_shared_experts:
        y = y + _shared_ffn(p, x, ffn_kind, act, pc, mode)
    return y, aux


def moe_apply(p, x, cfg, *, ffn_kind, act, pc=None, mode="fake",
              decode: bool = False):
    fn = (moe_apply_dense if (decode or cfg.force_dense)
          else moe_apply_dispatch)
    return fn(p, x, cfg, ffn_kind=ffn_kind, act=act, pc=pc, mode=mode)
