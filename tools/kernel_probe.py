#!/usr/bin/env python3
"""Closer looks at the LM kernels on one NVIDIA GPU than chip_smoke.py's.

    python3 tools/kernel_probe.py

1. ``packed_qmatmul`` per linear of olmo-1b's shapes (2048->2048,
   2048->8192, 8192->2048, W4, bf16 x) at M = 1, 8, 256 and 4096: device
   time per call (chip_smoke.py's ``_device_ms``), cold (8 weight sets
   cycled, 16-67 MB, beyond the 50 MB L2 at the larger widths), with the
   variant and tile the wrapper picks.
2. Clock stamps inside the kernels, from copies of the sources with
   stamps added at named lines, built with the flags of
   ``repro_torch.kernels.build`` into ``build/kernel_probe/``: the mma
   variant's main loop (SM clocks of each phase of K steps 8-15 of block
   (0, 0)) at M=4096 and M=256, and ``kv_attention``'s phases
   (globaltimer ns from the first block's start, median over every 64th
   block) with 8 and 2 blocks per (batch row, KV head), launched through
   the library's C entry point.

Prints the card's name and power limit first.  Needs a card and nvcc.
"""

import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from chip_smoke import _device_ms  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

OUT = build.BUILD_DIR.parent / "kernel_probe"


def linears(dev):
    import torch

    from repro_torch.kernels.packed_qmatmul import ops
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize

    for k, n in ((2048, 2048), (2048, 8192), (8192, 2048)):
        gen = torch.Generator(device=dev).manual_seed(k + n)
        ws = [quantize(torch.randn((n, k), generator=gen, device=dev) * 0.05,
                       PrecisionConfig(bits=4)) for _ in range(8)]
        for m in (1, 8, 256, 4096):
            x = torch.randn((m, k), generator=gen, device=dev,
                            dtype=torch.bfloat16)
            order = itertools.cycle(ws)
            us = 1e3 * _device_ms(lambda: ops.qmatmul(x, next(order)),
                                  "qmatmul_", reps=20, per_call=1)
            var = ops._variant(m, x.dtype, -1)
            tile = "" if var == "gemv" else " %dx%d" % ops._mma_tile(m, n)
            print(f"packed_qmatmul m={m} {k}->{n} ({var}{tile}): {us:.2f} us "
                  f"({2 * m * k * n / us / 1e6:.1f} TFLOP/s)", flush=True)


def _patch(src, pairs):
    for old, new in pairs:
        if src.count(old) != 1:
            raise AssertionError(f"probe anchor not found once: {old[:50]}")
        src = src.replace(old, new)
    return src


def _build(name, src):
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def stamps(dev):
    import numpy as np
    import torch

    from repro_torch.kernels.kv_attention import ref as kv_ref
    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    # -- the mma variant's main loop --------------------------------------
    src = (csrc / "packed_qmatmul.cu").read_text()
    src = _patch(src, [
        ("namespace {\n", "namespace {\n__device__ long long g_q[8][8];\n"
         "#define QST(i) if (threadIdx.x == 0 && blockIdx.x == 0 && "
         "blockIdx.y == 0 && kt >= 8 && kt < 16) g_q[kt - 8][i] = "
         "clock64();\n"),
        ("    fence_proxy_async();\n    __syncthreads();                "
         "// tile kt's x and decoded B are ready\n",
         "    QST(0)\n    fence_proxy_async();\n    __syncthreads();\n"
         "    QST(1)\n"),
        ("    wgmma_commit();\n    // refill", "    wgmma_commit();\n"
         "    QST(2)\n    // refill"),
        ("      wait_tile(kt + 1);\n      decode(",
         "      QST(3)\n      wait_tile(kt + 1);\n      QST(4)\n"
         "      decode("),
        ("    wgmma_wait0();\n    fence_acc(acc);\n",
         "    QST(5)\n    wgmma_wait0();\n    fence_acc(acc);\n"
         "    QST(6)\n"),
        ("}  // namespace\n", "}  // namespace\nextern \"C\" int "
         "probe_read(void* d) { return (int)cudaMemcpyFromSymbol(d, g_q, "
         "sizeof(g_q)); }\n")])
    lib = _build("qmm_stamps", src)
    lib.packed_qmatmul_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                          [ctypes.c_int] * 12 +
                                          [ctypes.c_void_p])
    lib.probe_read.argtypes = [ctypes.c_void_p]
    names = ("barrier", "wgmma issue", "copy issue", "wait next tile",
             "decode next tile", "wgmma wait")
    for m, k, n in ((4096, 2048, 2048), (256, 2048, 2048)):
        qt = quantize(torch.randn((n, k), device=dev) * 0.05,
                      PrecisionConfig(bits=4))
        x = torch.randn((m, k), device=dev, dtype=torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        tm, tn = qmm_ops._mma_tile(m, n)
        for _ in range(3):
            err = lib.packed_qmatmul_launch(
                x.data_ptr(), qt.data.data_ptr(), qt.scale.data_ptr(),
                out.data_ptr(), m, n, k, 4, k, 1, 1, 1, tm, tn, k, 1,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        torch.cuda.synchronize()
        t = np.zeros((8, 8), np.int64)
        lib.probe_read(t.ctypes.data)
        seg = np.median(np.diff(t[:, :7], axis=1), axis=0)
        step = np.median(t[1:, 0] - t[:-1, 0])
        print(f"mma main loop m={m} {k}->{n} tile {tm}x{tn}: {step:.0f} "
              f"clocks a K step; " + ", ".join(
                  f"{nm} {v:.0f}" for nm, v in zip(names, seg)), flush=True)
    # -- kv_attention's phases ---------------------------------------------
    src = (csrc / "kv_attention.cu").read_text()
    src = _patch(src, [
        ("namespace {\n", "namespace {\n__device__ unsigned long long "
         "g_t[64][8];\n__device__ __forceinline__ unsigned long long gt() "
         "{ unsigned long long t; asm volatile(\"mov.u64 %0, "
         "%globaltimer;\" : \"=l\"(t)); return t; }\n#define STAMP(i) if "
         "(threadIdx.x == 0 && blockIdx.x % 64 == 0 && blockIdx.x / 64 < "
         "64) g_t[blockIdx.x / 64][i] = gt();\n"),
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  cg::cluster_group cluster = cg::this_cluster();\n  STAMP(0)\n"),
        ("    cp_async_wait_all();\n", "    cp_async_wait_all();\n"
         "    STAMP(1)\n"),
        ("    // ---- online softmax over the tile",
         "    STAMP(2)\n    // ---- online softmax over the tile"),
        ("    // ---- P.V from shared memory",
         "    STAMP(3)\n    // ---- P.V from shared memory"),
        ("  // ---- this block's partial, then",
         "  STAMP(4)\n  // ---- this block's partial, then"),
        ("  cluster.sync();\n  if (rank == 0) {",
         "  STAMP(5)\n  cluster.sync();\n  if (rank == 0) {"),
        ("  cluster.sync();                   // peers keep",
         "  STAMP(6)\n  cluster.sync();                   // peers keep"),
        ("}  // namespace\n", "}  // namespace\nextern \"C\" int "
         "probe_read(void* d) { return (int)cudaMemcpyFromSymbol(d, g_t, "
         "sizeof(g_t)); }\n")])
    lib = _build("kv_stamps", src)
    lib.kv_attention_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 +
        [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.probe_read.argtypes = [ctypes.c_void_p]
    names = ("copies landed", "scores (last tile)", "softmax",
             "P.V (last tile)", "partial written", "merged")
    b, kh, hd, s_len, live = 8, 16, 128, 1024, 544
    q = torch.randn((b, 1, kh, hd), device=dev, dtype=torch.bfloat16)
    kp, ks = kv_ref.quantize_kv(torch.randn((b, s_len, kh, hd), device=dev),
                                4)
    lens = torch.full((b,), live, dtype=torch.int32, device=dev)
    out = torch.empty_like(q)
    for split in (8, 2):
        for _ in range(3):
            err = lib.kv_attention_launch(
                q.data_ptr(), kp.data_ptr(), ks.data_ptr(), kp.data_ptr(),
                ks.data_ptr(), lens.data_ptr(), out.data_ptr(), b, s_len, kh,
                1, hd, 4, 0, 0, hd ** -0.5, 0.0, 1, 1, split,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        torch.cuda.synchronize()
        t = np.zeros((64, 8), np.uint64)
        lib.probe_read(t.ctypes.data)
        t = t[:max(1, b * kh * split // 64)].astype(np.int64)
        rel = t - t[:, 0].min()
        med = np.median(rel, axis=0)
        print(f"kv_attention phases, {split} blocks per (row, head): start "
              f"{med[0]:.0f} ns (latest {rel[:, 0].max():.0f}); " +
              ", ".join(f"{nm} {v:.0f}" for nm, v in zip(names, med[1:])) +
              f"; last block done {rel[:, 6].max():.0f} ns", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    dev = torch.device("cuda", 0)
    linears(dev)
    stamps(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
