"""Public entry point of the multi-layer fused-group rollout, by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/fused_group.cu``,
  or raises.  There is no fallback from one to the other, and a chain
  whose shared memory exceeds the budget raises (it never drops to a
  per-layer chain).

Member encoding (shared with ref.py and core.snn_layers):

    ("conv", qct: QuantizedConvTensor, threshold_q: scalar | (c_out,))
    ("pool", window: int)

The chain contract, checked before any kernel runs: at least two members,
the first a conv, every conv stride-1 SAME with square taps and the same
weight precision, channels threading exactly (member i's c_out is member
i+1's c_in, pools keeping channels), and every pool dividing its plane.
The graph-level planner (``repro_torch.graph.fusion``) front-runs these
rules with layer names, so executor-driven calls never trip them.

Around the kernel, the wrapper pads each member's weights and thresholds
to a multiple of 32 output channels (zero rows, masked by ``n_out``
inside the kernel), lays the packed words out [group][word][lane], and
allocates the members' membrane scratch; the last conv member's scratch
is the returned membrane.

``fused_group_rollout.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector
from repro_torch.kernels import build as _build
from repro_torch.kernels import smem as _smem
from repro_torch.kernels.fused_group import ref as _ref

_GEOM_INTS = 8      # ints per member row passed to the kernel
_MAX_MEMBERS = 16   # the kernel's member table


def _round32(x: int) -> int:
    return -(-x // 32) * 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_group")
    lib.fused_group_launch.argtypes = ([ctypes.c_void_p] * 5 +
                                       [ctypes.POINTER(ctypes.c_int)] +
                                       [ctypes.c_int] * 6 +
                                       [ctypes.c_void_p])
    lib.fused_group_launch.restype = ctypes.c_int
    lib.fused_group_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int),
                                           ctypes.c_int]
    lib.fused_group_smem_bytes.restype = ctypes.c_size_t
    lib.fused_group_error_string.argtypes = [ctypes.c_int]
    lib.fused_group_error_string.restype = ctypes.c_char_p
    return lib


def _normalize_members(members: Sequence[Tuple], h: int, w: int,
                       win: int, device=None) -> Tuple[Tuple, ...]:
    """Validate the chain and normalize thresholds to (c_out,) vectors.

    Tracks the plane through the chain so the errors carry concrete
    geometry; raises ValueError on any chain contract violation.
    """
    if len(members) < 2:
        raise ValueError(
            f"a fusion group fuses 2+ members, got {len(members)}; use "
            f"fused_conv_rollout for a single layer")
    if members[0][0] != "conv":
        raise ValueError("a fusion group must start at a conv member "
                         f"(got {members[0][0]!r})")
    norm = []
    ch = None
    bits = None
    for mi, m in enumerate(members):
        if m[0] == "conv":
            _, qct, theta = m
            if mi == 0:
                if win != packing.packed_last_dim(qct.c_in, 1):
                    raise ValueError(
                        f"spike plane carries {win} channel words, the "
                        f"first member expects "
                        f"{packing.packed_last_dim(qct.c_in, 1)} "
                        f"(c_in={qct.c_in})")
                if qct.c_in_pad != win * 32:
                    raise ValueError(
                        "quantize_conv cin_pad drifted from the spike "
                        "word layout; requantize the weights")
            elif qct.c_in != ch:
                raise ValueError(
                    f"member {mi}: conv expects c_in={qct.c_in} but the "
                    f"chain carries {ch} channels; fusion members must "
                    f"thread channels exactly")
            if bits is None:
                bits = qct.bits
            elif qct.bits != bits:
                raise ValueError(
                    f"member {mi}: w{qct.bits} weights in a w{bits} "
                    f"group; a fusion group runs ONE datapath width "
                    f"(precision-mixed chains must stay unfused)")
            if qct.kh != qct.kw:
                raise ValueError(
                    f"member {mi}: non-square kernel "
                    f"{qct.kh}x{qct.kw} is not fusable")
            norm.append(("conv", qct,
                         as_theta_vector(theta, qct.c_out, device=device)))
            ch = qct.c_out
        elif m[0] == "pool":
            _, window = m
            if ch is None:
                raise ValueError("a pool cannot lead a fusion group")
            if h % window or w % window:
                raise ValueError(
                    f"member {mi}: pool window {window} does not divide "
                    f"the {h}x{w} plane it receives")
            h, w = h // window, w // window
            norm.append(("pool", window))
        else:
            raise ValueError(f"unknown group member kind {m[0]!r}")
    return tuple(norm)


def _chain_geoms(members: Sequence[Tuple], h: int,
                 w: int) -> Tuple[Tuple, ...]:
    """Static geometry rows, walking the plane through the chain:
    ("conv", bits, k, cin_pad, h, w, n_pad, n_out) and
    ("pool", window, h, w, c_pad), h/w each member's input dims.  A conv's
    padded c_out IS the next member's cin_pad (quantize_conv's rounding)."""
    geoms = []
    for m in members:
        if m[0] == "conv":
            _, qct, _ = m
            geoms.append(("conv", qct.bits, qct.kh, qct.c_in_pad, h, w,
                          _round32(qct.c_out), qct.c_out))
        else:
            _, window = m
            cp = geoms[-1][6]   # the previous conv's padded width
            geoms.append(("pool", window, h, w, cp))
            h, w = h // window, w // window
    return tuple(geoms)


def geom_smem_dicts(geoms: Sequence[Tuple]) -> List[Dict]:
    """Geometry rows -> the dicts ``smem.group_rollout_smem_bytes`` and
    the planner share."""
    out = []
    for g in geoms:
        if g[0] == "conv":
            _, _, k, cin_pad, h, w, _, _ = g
            out.append({"kind": "conv", "h": h, "w": w, "cin_pad": cin_pad,
                        "kh": k, "kw": k})
        else:
            _, _, h, w, c_pad = g
            out.append({"kind": "pool", "h": h, "w": w, "c": c_pad})
    return out


def _geom_ints(geoms: Sequence[Tuple]):
    rows = []
    for g in geoms:
        row = [0, *g[1:]] if g[0] == "conv" else [1, *g[1:]]
        rows.extend(row + [0] * (_GEOM_INTS - len(row)))
    return (ctypes.c_int * len(rows))(*rows)


def fused_group_rollout(
    spikes_packed_t: torch.Tensor,  # (T, B, H, W, ceil(c_in/32)) int32
    members: Sequence[Tuple],
    *,
    leak_shift: int,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All T timesteps of a whole fusion-group chain in one fused pass.

    Returns (v_T: (B, Ho, Wo, c_out) int32, the LAST conv member's final
    membrane, pre-pool if a pool ends the chain, and out_spikes_packed:
    (T, B, HoF, WoF, ceil(c_outF/32)) int32), bit-exact with the per-layer
    composition of ref.py.  A chain whose shared memory exceeds
    ``SMEM_LIMIT`` raises ValueError on every device.
    """
    t_steps, b, h, w, win = spikes_packed_t.shape
    dev = spikes_packed_t.device
    members = _normalize_members(members, h, w, win, device=dev)
    convs = [m for m in members if m[0] == "conv"]
    last_qct = convs[-1][1]
    geoms = _chain_geoms(members, h, w)
    need = _smem.group_rollout_smem_bytes(geom_smem_dicts(geoms))
    if need > _smem.SMEM_LIMIT:
        raise ValueError(
            f"fused group chain of {len(members)} members ({len(convs)} "
            f"convs, input {h}x{w}x{convs[0][1].c_in}, w{last_qct.bits}) "
            f"needs {_smem.format_bytes(need)} of shared memory > budget "
            f"{_smem.format_bytes(_smem.SMEM_LIMIT)}; split the chain")
    if len(members) > _MAX_MEMBERS:
        raise ValueError(f"fused group chain of {len(members)} members; "
                         f"the kernel takes at most {_MAX_MEMBERS}")
    if dev.type == "cpu":
        return _ref.fused_group_rollout_torch(
            spikes_packed_t, members, leak_shift=leak_shift,
            v_reset_q=v_reset_q, soft_reset=soft_reset)
    if dev.type != "cuda":
        raise ValueError(f"fused_group_rollout: unsupported device {dev}")
    for mi, m in enumerate(convs):
        if m[1].data.device != dev:
            raise ValueError(f"fused_group_rollout: conv member {mi} "
                             f"weights on {m[1].data.device}, spikes on "
                             f"{dev}")

    # output geometry (convs are stride-1 SAME)
    hf, wf, h_lc, w_lc = h, w, h, w
    for m in members:
        if m[0] == "conv":
            h_lc, w_lc = hf, wf
        else:
            hf, wf = hf // m[1], wf // m[1]
    n_lc = _round32(last_qct.c_out)
    if t_steps == 0:    # an empty rollout launches nothing
        return (torch.zeros((b, h_lc, w_lc, last_qct.c_out),
                            dtype=torch.int32, device=dev),
                torch.zeros((0, b, hf, wf, n_lc // 32), dtype=torch.int32,
                            device=dev))

    lib = _lib()
    geom_c = _geom_ints(geoms)
    kernel_smem = lib.fused_group_smem_bytes(geom_c, len(geoms))
    if kernel_smem != need:
        raise ValueError(
            f"fused_group: the kernel holds {kernel_smem} bytes of shared "
            f"memory for chain {geoms}, kernels/smem.py budgets {need}")

    words, thetas, v_sizes = [], [], []
    for g, (_, qct, theta) in zip((g for g in geoms if g[0] == "conv"),
                                  convs):
        n_pad = g[6]
        wpk = F.pad(qct.data.to(torch.int32), (0, 0, 0, n_pad - qct.c_out))
        # (n_pad, wpr) -> (n_pad/32, wpr, 32): lane-fast words
        words.append(wpk.reshape(n_pad // 32, 32, -1).transpose(1, 2)
                     .reshape(-1))
        thetas.append(F.pad(theta, (0, n_pad - qct.c_out)))
        v_sizes.append(b * g[4] * g[5] * n_pad)
    w_all = torch.cat(words).contiguous()
    th_all = torch.cat(thetas).contiguous()
    vmem = torch.empty((sum(v_sizes),), dtype=torch.int32, device=dev)
    sp = spikes_packed_t.to(torch.int32).contiguous()
    out = torch.empty((t_steps, b, hf * wf, n_lc // 32), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_group_launch(
            sp.data_ptr(), w_all.data_ptr(), th_all.data_ptr(),
            vmem.data_ptr(), out.data_ptr(), geom_c, len(geoms), t_steps, b,
            leak_shift, int(v_reset_q), int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_group kernel launch failed: CUDA error {err} "
            f"({lib.fused_group_error_string(err).decode()})")
    fused_group_rollout.launches += 1
    v = vmem[sum(v_sizes[:-1]):].reshape(b, h_lc, w_lc, n_lc)
    return (v[..., :last_qct.c_out],
            out.reshape(t_steps, b, hf, wf, n_lc // 32))


fused_group_rollout.launches = 0
