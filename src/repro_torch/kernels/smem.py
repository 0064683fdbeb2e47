"""Shared-memory budget of the port's fused kernels on Hopper.

Counterpart of ``repro.kernels.vmem``.  Two numbers and one formula:

  * :data:`SMEM_LIMIT`, the largest dynamic shared memory one block may
    opt into on an H100 (227 KB);
  * :data:`N_SMS`, the H100 SXM's 132 SMs, against which the LM kernels'
    wrappers size their grids;
  * :func:`group_rollout_smem_bytes`, what the ``fused_group`` kernel
    (``csrc/fused_group.cu``) holds in shared memory for a chain.  The
    fusion planner (``repro_torch.graph.fusion``) budgets with it and the
    wrapper (``kernels/fused_group/ops.py``) checks that the kernel's own
    size function agrees with it, so the planner never admits a chain the
    kernel refuses.

The kernel keeps only the 1-bit inter-member spike planes in shared
memory: a ping-pong pair of buffers, each large enough for the largest
plane of the chain stored with the zero halo its consumer needs (a conv
of kernel ``k`` reads its input with ``k - 1`` rows and columns of SAME
padding; a pool reads its input without one).  Membranes live in a global
scratch and weights are read from global memory, so neither is counted.
"""

from __future__ import annotations

from typing import Dict, Sequence

# largest dynamic shared memory a Hopper block may opt into (227 KB)
SMEM_LIMIT = 232448
# streaming multiprocessors of an H100 SXM, which the LM kernels' wrappers
# size their grids against
N_SMS = 132


def staged_stride(words: int) -> int:
    """Staged words per row of packed codes in the kernels' shared memory
    (``int8_mma.cuh`` ``staged_stride``): ``words`` padded to 4 mod 32, so
    the 8 rows of a tensor-core B fragment load sit in distinct banks."""
    return words + ((4 - words) & 31)


def stored_plane_words(m: Dict) -> int:
    """Words of one member's input plane as the kernel stores it: the
    plane plus its consumer's zero halo, ``ceil(c/32)`` words a pixel."""
    if m["kind"] == "conv":
        return ((m["h"] + m["kh"] - 1) * (m["w"] + m["kw"] - 1)
                * m["cin_pad"] // 32)
    if m["kind"] == "pool":
        return m["h"] * m["w"] * m["c"] // 32
    raise ValueError(f"unknown member kind {m['kind']!r}")


def group_rollout_smem_bytes(members: Sequence[Dict]) -> int:
    """Dynamic shared memory of one ``fused_group`` block for a chain.

    ``members`` are geometry dicts, in chain order:

      {"kind": "conv", "h", "w", "cin_pad", "kh", "kw"}
          h/w the member's input (= output) plane dims, ``cin_pad`` its
          32-padded input channels;
      {"kind": "pool", "h", "w", "c"}
          h/w the pooled plane's input dims, ``c`` its padded channels.

    Two int32 plane buffers, each the largest stored input plane.  The
    chain's final plane goes to global memory and is not counted.
    """
    if not members:
        raise ValueError("a fusion group has at least one member")
    return 2 * 4 * max(stored_plane_words(m) for m in members)


def format_bytes(n: int) -> str:
    """Human-readable byte count for error messages and summaries."""
    if n >= 1024 * 1024:
        return f"{n / (1024 * 1024):.1f} MiB"
    if n >= 1024:
        return f"{n / 1024:.1f} KiB"
    return f"{n} B"
