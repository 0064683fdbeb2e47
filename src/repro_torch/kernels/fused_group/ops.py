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

Around the kernel, the wrapper plans the launch (:func:`_launch_plan`):
the cluster size (:func:`_cluster_size`), the T chunk, which members
stage their codes in shared memory and whether warps may split a unit's
k-steps (:func:`_plan`), all within ``SMEM_LIMIT``.  It passes each conv
member's packed words and thresholds as they are (no re-layout: channels
past ``c_out`` are masked by ``n_out`` inside the kernel) and allocates
the membrane scratch the chunks need; the last conv member's membrane is
returned.

``fused_group_rollout.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector
from repro_torch.kernels import build as _build
from repro_torch.kernels import smem as _smem
from repro_torch.kernels.fused_group import ref as _ref

_GEOM_INTS = 8      # ints per member row passed to the kernel
_MAX_MEMBERS = 16   # the kernel's member table
_CLUSTERS = tuple(range(16, 7, -1))  # blocks per batch element
_RED_WORDS = 4 * 4 * 16 * 32   # the kernel's K-split tiles (kRedWords)


def _round32(x: int) -> int:
    return -(-x // 32) * 32


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_group")
    lib.fused_group_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_void_p)] * 3 +
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)] +
        [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.fused_group_launch.restype = ctypes.c_int
    lib.fused_group_smem_bytes.argtypes = [ctypes.POINTER(ctypes.c_int)] + \
        [ctypes.c_int] * 5
    lib.fused_group_smem_bytes.restype = ctypes.c_size_t
    lib.fused_group_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_size_t]
    lib.fused_group_max_clusters.restype = ctypes.c_int
    lib.fused_group_error_string.argtypes = [ctypes.c_int]
    lib.fused_group_error_string.restype = ctypes.c_char_p
    return lib


# --- the launch plan (csrc/fused_group.cu must agree) ----------------------


def _conv_wpr(g: Tuple) -> int:
    """Packed words per output channel of a conv geometry row."""
    _, bits, k, cin_pad, _, _, _, _ = g
    return k * k * cin_pad * bits // 32


def _stage_words(g: Tuple, cl: int) -> int:
    """Staged code words of a conv member per block: the most 32-channel
    groups one block of a ``cl``-block cluster owns."""
    return -(-(g[6] // 32) // cl) * 32 * _smem.staged_stride(_conv_wpr(g))


def _group_smem_bytes(geoms: Sequence[Tuple], tc: int, cl: int,
                      stage: Sequence[bool], ksplit: bool) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the kernel):
    two plane buffers of ``tc`` steps, each step the chain's largest
    stored plane, then (16-byte aligned) the largest staged code slab,
    then with ``ksplit`` the K-split tiles.  At tc = 1 with nothing
    staged and no K split it is the planner's formula."""
    bw = max(_smem.stored_plane_words(d) for d in geom_smem_dicts(geoms))
    w = max((_stage_words(g, cl) for g, st in zip(geoms, stage)
             if g[0] == "conv" and st), default=0)
    if not w and not ksplit:
        return 4 * 2 * tc * bw
    return 4 * (-(-2 * tc * bw // 4) * 4 + w + (_RED_WORDS if ksplit
                                                else 0))


def _plan(geoms: Sequence[Tuple], t_steps: int,
          cl: int) -> Tuple[int, Tuple[bool, ...], bool]:
    """(tc, stage, ksplit): the T chunk, which conv members stage their
    codes, and whether warps may split a unit's k-steps (the K-split
    tiles).  In that priority: every conv member stages, then the K
    split, then the largest chunk that fits beside them; only when not
    even one step fits beside every slab does a member keep its codes in
    L2 (then every member whose slab fits beside one step still stages,
    without a K split).  A chain the planner admits always fits at
    tc = 1 with nothing staged and no K split."""
    every = tuple(g[0] == "conv" for g in geoms)
    for ksplit in (True, False):
        for tc in range(max(t_steps, 1), 0, -1):
            if _group_smem_bytes(geoms, tc, cl, every,
                                 ksplit) <= _smem.SMEM_LIMIT:
                return tc, every, ksplit
    alone = tuple(
        g[0] == "conv" and _group_smem_bytes(
            geoms, 1, cl, [j == i for j in range(len(geoms))], False)
        <= _smem.SMEM_LIMIT for i, g in enumerate(geoms))
    return 1, alone, False


def _cluster_size(b: int, active: Dict[int, int]) -> int:
    """The cluster size that runs ``b`` batch elements in the fewest
    waves, the largest of those: ``active[cl]`` is how many clusters of
    ``cl`` blocks the card runs at once (cudaOccupancyMaxActiveClusters).
    A wave costs more than its share of the work (barriers, staging and
    pools do not shrink with the cluster): on an H100 SXM, which runs 7
    clusters of 16 blocks at once, ``tools/kernel_probe.py snn`` timed
    the vgg9 chain at B=8 at 211 us as two waves of 16-block clusters and
    130 us as one wave of 8-block ones."""
    return min((cl for cl in _CLUSTERS if active.get(cl, 0) >= 1),
               key=lambda cl: (-(-b // active[cl]), -cl))


def _stage_mask(stage: Sequence[bool]) -> int:
    return sum(1 << i for i, st in enumerate(stage) if st)


@functools.cache
def _launch_plan(geoms: Tuple[Tuple, ...], t_steps: int,
                 b: int) -> Tuple[int, int, Tuple[bool, ...], bool, int]:
    """(cl, tc, stage, ksplit, smem) for a launch, cached per chain
    geometry, T and B.  Holds the kernel's own size function against the
    wrapper's (the minimum against the planner's formula) and never
    exceeds ``SMEM_LIMIT``.  The geometry rows the kernel reads are
    cached beside it (:func:`_geom_c`)."""
    lib = _lib()
    geom_c = _geom_c(geoms)
    need = _smem.group_rollout_smem_bytes(geom_smem_dicts(geoms))
    kernel_min = lib.fused_group_smem_bytes(geom_c, len(geoms), 1,
                                            _CLUSTERS[0], 0, 0)
    if kernel_min != need:
        raise ValueError(
            f"fused_group: the kernel's least shared memory is "
            f"{kernel_min} bytes for chain {geoms}, kernels/smem.py "
            f"budgets {need}")
    bits = next(g[1] for g in geoms if g[0] == "conv")
    plans, active = {}, {}
    for cl in _CLUSTERS:
        tc, stage, ksplit = _plan(geoms, t_steps, cl)
        smem = _group_smem_bytes(geoms, tc, cl, stage, ksplit)
        kernel = lib.fused_group_smem_bytes(geom_c, len(geoms), tc, cl,
                                            _stage_mask(stage), int(ksplit))
        if kernel != smem or smem > _smem.SMEM_LIMIT:
            raise ValueError(
                f"fused_group: the kernel holds {kernel} bytes of shared "
                f"memory at tc={tc}, cl={cl}, stage={stage}, "
                f"ksplit={ksplit}, the wrapper planned {smem} (limit "
                f"{_smem.SMEM_LIMIT})")
        plans[cl] = (cl, tc, stage, ksplit, smem)
        active[cl] = lib.fused_group_max_clusters(bits, cl, smem)
    if max(active.values()) < 1:
        raise RuntimeError(f"fused_group: no cluster of {_CLUSTERS} blocks "
                           f"fits on this card for chain {geoms} "
                           f"(active clusters {active})")
    return plans[_cluster_size(b, active)]


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


@functools.cache
def _geom_c(geoms: Tuple[Tuple, ...]):
    """The kernel's geometry rows as a ctypes int array (read-only, so
    one array per chain serves every launch)."""
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

    cl, tc, stage, ksplit, _ = _launch_plan(geoms, t_steps, b)
    lib = _lib()
    geom_c = _geom_c(geoms)
    n = len(members)
    chunked = tc < t_steps
    null = ctypes.c_void_p()
    w_p, th_p, v_p = ([null] * n for _ in range(3))
    vec_mask = 0
    keep = []           # tensors the launch reads, alive until it is queued
    v_out = None
    last_ci = max(i for i, m in enumerate(members) if m[0] == "conv")
    for i, (g, m) in enumerate(zip(geoms, members)):
        if m[0] != "conv":
            continue
        _, qct, theta = m
        wq = qct.data.to(torch.int32).contiguous()
        th = theta.to(torch.int32).contiguous()
        if i == last_ci:
            scr = v_out = torch.empty((b, g[4] * g[5], g[6]),
                                      dtype=torch.int32, device=dev)
        elif chunked:
            scr = torch.empty((b, g[4] * g[5], g[6]), dtype=torch.int32,
                              device=dev)
        else:
            scr = None
        keep += [wq, th, scr]
        w_p[i] = ctypes.c_void_p(wq.data_ptr())
        th_p[i] = ctypes.c_void_p(th.data_ptr())
        v_p[i] = null if scr is None else ctypes.c_void_p(scr.data_ptr())
        if _conv_wpr(g) % 4 == 0 and wq.data_ptr() % 16 == 0:
            vec_mask |= 1 << i
    sp = spikes_packed_t.to(torch.int32).contiguous()
    out = torch.empty((t_steps, b, hf * wf, n_lc // 32), dtype=torch.int32,
                      device=dev)
    arr = ctypes.c_void_p * n
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_group_launch(
            sp.data_ptr(), arr(*w_p), arr(*th_p), arr(*v_p), out.data_ptr(),
            geom_c, n, t_steps, b, tc, cl, _stage_mask(stage), int(ksplit),
            vec_mask,
            leak_shift, int(v_reset_q), int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_group kernel launch failed: CUDA error {err} "
            f"({lib.fused_group_error_string(err).decode()})")
    _build.count_launch(fused_group_rollout)
    v = v_out.reshape(b, h_lc, w_lc, n_lc)
    return (v[..., :last_qct.c_out],
            out.reshape(t_steps, b, hf, wf, n_lc // 32))


fused_group_rollout.launches = 0
