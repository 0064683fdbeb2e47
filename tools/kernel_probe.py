#!/usr/bin/env python3
"""Closer looks at the kernels on one NVIDIA GPU than chip_smoke.py's.

    python3 tools/kernel_probe.py          # items 1-7
    python3 tools/kernel_probe.py snn      # the fused_group probe alone
    python3 tools/kernel_probe.py nce conv loops clocks  # 4-7
    python3 tools/kernel_probe.py state                  # 8
    python3 tools/kernel_probe.py async                  # 9
    python3 tools/kernel_probe.py finish [TREE ...]      # 10

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
3. ``fused_group`` at w4, T=4, B=8: the vgg9 chain before and after 3 s
   of back-to-back launches with the SM clock from ``nvidia-smi``; each
   served chain under forced launch plans; the vgg9 and blocks.7 chains
   with variants of the MMA loop that each change or drop one part of a
   k-step's work (a runtime test per step, the code decode, the spike
   expansion, the mma.sync; timing only), in three interleaved rounds;
   and per member the phases of block (0, 0) (globaltimer) and warp 0's
   clocks in its MMA loops and its LIF + store epilogues.

4. ``spike_matmul`` at vgg9's fc1 (m=8, 4096->512, w4) and kernel_bench's
   NCE step (m=64, 2048->2048, w8): per-block phases of a stamped copy
   (globaltimer: entry, codes and spikes staged, product done, first
   cluster barrier passed, rows stored, exit), then timed variants: the
   codes staged by 4-byte copies (the first design), and each
   contraction split forced.
5. ``fused_conv`` at w4, T=4, B=8, at vgg9's convs.1 and convs.3 and
   resnet18's blocks.6.conv2 and blocks.6.proj: per-block phases of a
   stamped copy (globaltimer: entry, codes staged, the last warp done)
   and warp 0's clocks in its MMA loops and team sums against its whole
   life, then each team size forced.
6. ``loops``: variants of the two kernels' MMA loops, each changing or
   dropping one part of a k-step's work (timing only where marked: those
   give wrong results), timed in three interleaved rounds: ``fused_conv``
   at the four geometries of item 5 (the next k-step's spike words
   loaded ahead, the k-step loop unrolled by 4, no spike loads, adds in
   place of mma.sync) and ``spike_matmul`` at fc1 and bench (codes staged
   by 4-byte copies, the k-step loop unrolled by 2, adds in place of
   mma.sync, no spike expansion).
7. ``clocks``: ``spike_matmul`` bench and ``fused_conv`` convs.1 timed as
   chip_smoke.py times them (``_device_ms``) after 1 s with the card
   idle and after 1 s of back-to-back launches, with the SM clock
   ``nvidia-smi`` reads just before each timing.
8. ``state`` (run it in a process of its own): ``spike_matmul`` bench and
   the ``fused_group`` vgg9 chain timed first in a fresh process, then
   again after each of: 20 ``fused_nce`` fc1 launches, 20 ``fused_conv``
   convs.1 launches, building a second library from the same
   ``spike_matmul.cu``, and 20 launches of that copy; then the bench
   launch timed dense (10 launches a profiled call straight through the
   library's C entry point, a few microseconds apart) beside the
   wrapper's (one a call, tens of microseconds apart), with the SM and
   memory clocks, performance state and power ``nvidia-smi`` reads.

9. ``async`` (run it in a process of its own): vgg9 ``fusion=()`` at
   full width, INT4, buckets pinned to (8,): a forward's wall time on a
   thread's first call and its second, on a fresh thread each; the sync
   engine over 3 rounds of 64 requests; then ``AsyncSNNServeEngine``
   with 1 and 2 workers, and 1 worker with the interpreter's switch
   interval at 0.1 ms, each over 3 rounds of 64 requests submitted at
   once into the started tier (images/s, batches and compute a batch
   per round; round 1 holds the workers' first forwards).
10. ``finish``: ``SNNServeEngine.finish_step``'s host time a batch of 8,
   the registry off, in each TREE given (default: this one), each in a
   process of its own with ``TREE/src`` first on the path, in the order
   given (pass ``PARENT . . PARENT`` to compare a change with its
   parent): 5 rounds of 2000 batches each with the logits on the card
   (the served path: the event is already complete, the copy to the
   host included) and on the host (the bookkeeping alone); prints the
   median round's microseconds a batch.

Prints the card's name and power limit first.  Needs a card and nvcc.
"""

import ctypes
import itertools
import subprocess
import sys
import time
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
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
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


def _group_case(dev, hw, c_in, spec, seed):
    """A chain of chip_smoke.py's group phase at w4: planes (T=4, B=8,
    20% density), members with random codes and thresholds."""
    import torch

    from repro_torch.core import packing
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize_conv

    gen = torch.Generator().manual_seed(seed)
    s = torch.rand((4, 8, hw, hw, c_in), generator=gen) < 0.2
    planes = packing.pack_bool(s).to(dev)
    members, c = [], c_in
    for item in spec:
        if item == "P":
            members.append(("pool", 2))
            continue
        wf = torch.randn((3, 3, c, item), generator=gen) * 0.1
        qct = quantize_conv(wf.to(dev), PrecisionConfig(bits=4))
        members.append(("conv", qct, torch.randint(
            1, 60, (item,), generator=gen).to(torch.int32).to(dev)))
        c = item
    return planes, members


def snn(dev):
    """The vgg9 chain's time and the SM clock before and after 3 s of
    launches; each served chain timed under forced launch plans (the
    wrapper's plan, 16- and 8-block clusters, no K split, no staging)
    beside the card's active clusters of 8-16 blocks; the vgg9 and
    blocks.7 chains timed with variants of the MMA loop that change or
    drop one part of a k-step's work each (timing only: most give wrong
    results), in three interleaved rounds; then fused_group per member
    (globaltimer stamps of block (0, 0): the block barrier that opens a
    member, codes staged, the cluster barrier, the member's work done by
    every warp of the block; clock64 of warp 0 inside its units: the MMA
    loop with the K split's team sums, and the LIF + store epilogue)."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_group import ops

    chains = {"vgg9": (32, 64, [64, "P", 128, 128, "P", 256, "P"]),
              "blocks.0": (32, 64, [64, 64]),
              "blocks.5": (8, 256, [256, 256]),
              "blocks.7": (4, 512, [512, 512])}
    kw = dict(leak_shift=3, v_reset_q=-2, soft_reset=True)
    lib = ops._lib()
    plan = ops._launch_plan
    # the card's SM clock before and after 3 s of back-to-back launches,
    # with the vgg9 chain's time at each
    planes, members = _group_case(dev, *chains["vgg9"], 4)

    def run():
        ops.fused_group_rollout(planes, members, **kw)

    for when in ("cold", "after 3 s of launches"):
        if when != "cold":
            t_end = time.perf_counter() + 3.0
            while time.perf_counter() < t_end:
                for _ in range(50):
                    run()
                torch.cuda.synchronize()
        us = 1e3 * _device_ms(run, "fused_group_kernel")
        clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"fused_group vgg9 {when}: {us:.1f} us, SM clock {clk}",
              flush=True)
    for name, (hw, c_in, spec) in chains.items():
        planes, members = _group_case(dev, hw, c_in, spec, len(name))
        geoms = ops._chain_geoms(members, hw, hw)
        cl, tc, stage, ksplit, smem = plan(geoms, 4, 8)
        act = {c: lib.fused_group_max_clusters(4, c, smem)
               for c in ops._CLUSTERS}
        forced = {"plan": (cl, tc, stage, ksplit, smem)}
        for c in (16, 8):
            tcc, st, kx = ops._plan(geoms, 4, c)
            forced[f"cl={c}"] = (c, tcc, st, kx, ops._group_smem_bytes(
                geoms, tcc, c, st, kx))
        none = (False,) * len(geoms)
        forced["no K split"] = (cl, tc, stage, False, ops._group_smem_bytes(
            geoms, tc, cl, stage, False))
        forced["no staging"] = (cl, 4, none, ksplit, ops._group_smem_bytes(
            geoms, 4, cl, none, ksplit))
        times = []
        for label, fp in forced.items():
            ops._launch_plan = lambda *a, fp=fp: fp
            try:
                us = 1e3 * _device_ms(lambda: ops.fused_group_rollout(
                    planes, members, **kw), "fused_group_kernel",
                    per_call=1)
            finally:
                ops._launch_plan = plan
            times.append(f"{label} {us:.1f} us")
        print(f"fused_group {name}: active clusters {act}, plan cl={cl}; " +
              ", ".join(times), flush=True)

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    base = (csrc / "fused_group.cu").read_text()
    # variants of the MMA loop (mma_ksteps), timed only (all but the
    # first give wrong results): where a k-step's time goes
    step = "      const int32_t* s = sw + i * buf_words;\n"
    decode = ("      bf[j][0] = int8mma::codes_s8<BITS>(rows[j] + kb, 0, "
              "tq);\n      bf[j][1] = int8mma::codes_s8<BITS>(rows[j] + kb, "
              "1, tq);\n")
    mma = ("        int8mma::mma_s8(acc[i][j], a0, a1, a2, a3, bf[j][0], "
           "bf[j][1]);\n")
    expand = ("      const unsigned a0 = int8mma::spikes_s8(lo, tq);\n"
              "      const unsigned a1 = int8mma::spikes_s8(hi, tq);\n"
              "      const unsigned a2 = int8mma::spikes_s8(lo, tq + 4);\n"
              "      const unsigned a3 = int8mma::spikes_s8(hi, tq + 4);\n")
    dispatch = base[base.index("      if (ns == 4) {\n"):
                    base.index("      if (ks > 1) {\n")]
    variants = {
        # the 4-step loop alone, without the dispatch on the step count
        # (right only where the chunk is a multiple of 4 steps)
        "the 4-step loop alone (T=4 only)": [(dispatch, (
            "      mma_ksteps<BITS, 4>(acc, rows, st, buf_words, k0, k1, m, "
            "ps, off_lo, off_hi, tq);\n"))],
        # a uniform test per step that the compiler cannot drop, as the
        # first design's `tg + i < nt`
        "a runtime test per step": [(step, (
            "      if (i >= (k1 >= 0 ? NS : 0)) break;\n" + step))],
        "raw code words as B (no decode)": [(decode, (
            "      bf[j][0] = rows[j][kb];\n"
            "      bf[j][1] = rows[j][kb + (BITS > 1)];\n"))],
        "raw spike words as A (no expansion)": [(expand, (
            "      const unsigned a0 = lo, a1 = hi, a2 = lo >> 16, "
            "a3 = hi >> 16;\n"))],
        "adds in place of mma.sync": [(mma, (
            "        acc[i][j][0] += a0 ^ bf[j][0];\n"
            "        acc[i][j][1] += a1 ^ bf[j][1];\n"
            "        acc[i][j][2] += a2;\n"
            "        acc[i][j][3] += a3;\n"))],
    }
    real_lib = ops._lib
    libs = {"as built": lib}
    for i, (label, pairs) in enumerate(variants.items()):
        # one file name per variant: dlopen hands back a library already
        # loaded from the same path
        vlib = _build(f"group_variant{i}", _patch(base, pairs))
        for fn in ("fused_group_launch", "fused_group_smem_bytes",
                   "fused_group_max_clusters", "fused_group_error_string"):
            getattr(vlib, fn).argtypes = getattr(lib, fn).argtypes
            getattr(vlib, fn).restype = getattr(lib, fn).restype
        libs[label] = vlib
    cases = {name: _group_case(dev, *chains[name], len(name))
             for name in ("vgg9", "blocks.7")}
    # three rounds, the variants in turn within each, so a drift of the
    # card's clocks over the call spreads over all of them
    times = {label: {name: [] for name in cases} for label in libs}
    try:
        for _ in range(3):
            for label, vlib in libs.items():
                ops._lib = lambda vlib=vlib: vlib
                for name, (planes, members) in cases.items():
                    times[label][name].append(1e3 * _device_ms(
                        lambda: ops.fused_group_rollout(planes, members,
                                                        **kw),
                        "fused_group_kernel"))
    finally:
        ops._lib = real_lib
    for label, per in times.items():
        print(f"fused_group MMA loop variant, {label}: " + ", ".join(
            f"{name} " + " / ".join(f"{us:.1f}" for us in v) + " us"
            for name, v in per.items()), flush=True)

    src = base
    hdr = ("namespace {\n__device__ unsigned long long g_t[16][4];\n"
           "__device__ long long g_c[16][2];\n__device__ long long "
           "g_acc[2];\n__device__ __forceinline__ unsigned long long gt() "
           "{ unsigned long long t; asm volatile(\"mov.u64 %0, "
           "%globaltimer;\" : \"=l\"(t)); return t; }\n#define ONE "
           "(threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)\n"
           "#define GST(i) if (ONE && c == 0) g_t[mi][i] = gt();\n")
    src = _patch(src, [
        ("namespace {\n", hdr),
        ("    for (int tg = 0; tg < nt; tg += kTr) {\n",
         "    long long c0 = 0, c1 = 0;\n"
         "    for (int tg = 0; tg < nt; tg += kTr) {\n"),
        ("      // this warp's k-steps [k0, k1)",
         "      c0 = clock64();\n      // this warp's k-steps [k0, k1)"),
        ("      // the LIF scan over the steps, in registers; pack, store\n",
         "      c1 = clock64();\n"
         "      if (ONE) g_acc[0] += c1 - c0;\n"),
        ("    // membranes: to the scratch for the next chunk",
         "    if (ONE) g_acc[1] += clock64() - c1;\n"
         "    // membranes: to the scratch for the next chunk"),
        ("      __syncthreads();   // this block is done with the previous "
         "member\n", "      __syncthreads();\n      GST(0)\n"),
        ("      int8mma::cp_async_wait_all();\n",
         "      int8mma::cp_async_wait_all();\n      __syncthreads();\n"
         "      GST(1)\n"),
        ("      if (m.conv && m.w_stride) {\n",
         "      GST(2)\n      if (m.conv && m.w_stride) {\n"),
        ("      cur ^= 1;\n", "      __syncthreads();\n      GST(3)\n"
         "      if (ONE && c == 0) { g_c[mi][0] = g_acc[0]; g_c[mi][1] = "
         "g_acc[1]; g_acc[0] = g_acc[1] = 0; }\n      cur ^= 1;\n"),
        ("}  // namespace\n", "}  // namespace\nextern \"C\" int "
         "probe_read(void* d, void* c) { int e = (int)cudaMemcpyFromSymbol("
         "d, g_t, sizeof(g_t)); return e ? e : (int)cudaMemcpyFromSymbol("
         "c, g_c, sizeof(g_c)); }\n")])
    stamped = _build("group_stamps", src)
    for fn in ("fused_group_launch", "fused_group_smem_bytes",
               "fused_group_max_clusters", "fused_group_error_string"):
        getattr(stamped, fn).argtypes = getattr(lib, fn).argtypes
        getattr(stamped, fn).restype = getattr(lib, fn).restype
    stamped.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    ops._lib = lambda: stamped
    try:
        for name in ("vgg9", "blocks.7"):
            hw, c_in, spec = chains[name]
            planes, members = _group_case(dev, hw, c_in, spec, len(name))
            for _ in range(3):
                ops.fused_group_rollout(planes, members, **kw)
            torch.cuda.synchronize()
            t = np.zeros((16, 4), np.uint64)
            c = np.zeros((16, 2), np.int64)
            stamped.probe_read(t.ctypes.data, c.ctypes.data)
            t = t[:len(spec)].astype(np.int64)
            t0 = t[0, 0]
            for mi, item in enumerate(spec):
                kind = "pool" if item == "P" else f"conv {item}"
                print(f"fused_group {name} member {mi} ({kind}): open "
                      f"{t[mi, 0] - t0} ns, staged +{t[mi, 1] - t[mi, 0]}, "
                      f"cluster barrier +{t[mi, 2] - t[mi, 1]}, work "
                      f"+{t[mi, 3] - t[mi, 2]}; warp 0 clocks: MMA loops and "
                      f"team sums {c[mi, 0]}, LIF + stores {c[mi, 1]}",
                      flush=True)
    finally:
        ops._lib = real_lib


_GT = ("__device__ __forceinline__ unsigned long long gt() { unsigned long "
       "long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t)); "
       "return t; }\n")


def _phases(t, names):
    """Median per-block phase durations (ns) from per-block stamps, the
    spread of block starts, and the span first entry -> last exit."""
    import numpy as np

    t = t.astype(np.int64)
    d = np.diff(t, axis=1)
    return (", ".join(f"{nm} {np.median(d[:, i]):.0f}" for i, nm in
                      enumerate(names)) +
            f" ns (median per block); block starts spread "
            f"{t[:, 0].max() - t[:, 0].min()} ns; first entry to last exit "
            f"{t[:, -1].max() - t[:, 0].min()} ns")

# the first design's staging of the NCE product's codes: 4-byte copies only
_FOUR_BYTE = [("  if (wpr % 4 == 0 && wk % 4 == 0 &&\n"
               "      (reinterpret_cast<uintptr_t>(w) & 15) == 0) {\n",
               "  if (false) {\n")]


def nce(dev):
    """spike_matmul's phases and variants (item 4 of the docstring)."""
    import numpy as np
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.spike_matmul import ops
    from repro_torch.kernels.spike_matmul.ref import spike_matmul_ref
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    hdr = (csrc / "nce_product.cuh").read_text()
    base = (csrc / "spike_matmul.cu").read_text()
    lib = ops._lib()

    def variant(name, hdr_pairs, cu_pairs):
        src = _patch(base, [("#include \"nce_product.cuh\"\n",
                             _patch(hdr, hdr_pairs))] + cu_pairs)
        vlib = _build(name, src)
        for fn in ("spike_matmul_launch", "spike_matmul_smem_bytes",
                   "spike_matmul_error_string"):
            getattr(vlib, fn).argtypes = getattr(lib, fn).argtypes
            getattr(vlib, fn).restype = getattr(lib, fn).restype
        return vlib

    st = "if (threadIdx.x == 0) g_t[(blockIdx.z * gridDim.y + blockIdx.y) " \
         "* gridDim.x + blockIdx.x][%d] = gt();\n"

    def kst(i):   # a stamp in the kernel, outside the header's namespace
        return "  " + (st % i).replace("g_t", "nceprod::g_t").replace(
            "gt()", "nceprod::gt()")

    stamped = variant("sm_stamps", [
        ("namespace nceprod {\n", "namespace nceprod {\n__device__ unsigned "
         "long long g_t[4096][6];\n" + _GT),
        ("  const int tid = threadIdx.x;\n",
         "  const int tid = threadIdx.x;\n" + st % 0),
        ("  int8mma::cp_async_wait_all();\n  __syncthreads();\n",
         "  int8mma::cp_async_wait_all();\n  __syncthreads();\n" + st % 1),
        ("  return part;\n", "  __syncthreads();\n" + st % 2 +
         "  return part;\n")], [
        ("  cluster.sync();   // every block's partials are complete\n",
         "  cluster.sync();\n" + kst(3)),
        ("  cluster.sync();   // peers keep their partials until every "
         "block read them\n", "  __syncthreads();\n" + kst(4) +
         "  cluster.sync();\n" + kst(5)),
        ("extern \"C\" const char* spike_matmul_error_string",
         "extern \"C\" int probe_read(void* d) { return (int)"
         "cudaMemcpyFromSymbol(d, nceprod::g_t, sizeof(nceprod::g_t)); }\n"
         "extern \"C\" const char* spike_matmul_error_string")])
    stamped.probe_read.argtypes = [ctypes.c_void_p]
    four = variant("sm_four", _FOUR_BYTE, [])
    real_lib, real_plan = ops._lib, ops._launch_plan
    for name, (m, d_in, d_out, bits) in (("fc1", (8, 4096, 512, 4)),
                                         ("bench", (64, 2048, 2048, 8))):
        gen = torch.Generator().manual_seed(d_in + m)
        s = torch.rand((m, d_in), generator=gen) < 0.2
        sp = packing.pack_bool(s).to(dev)
        qt = quantize((torch.randn((d_out, d_in), generator=gen) * 0.05)
                      .to(dev), PrecisionConfig(bits=bits))
        want = spike_matmul_ref(sp, qt, d_in=d_in)
        rb, split = ops._launch_plan(m, sp.shape[-1], bits, d_out)
        try:
            ops._lib = lambda: stamped
            for _ in range(3):
                got = ops.spike_matmul(sp, qt, d_in=d_in)
            torch.cuda.synchronize()
            blocks = (d_out // 32) * -(-m // rb) * split
            t = np.zeros((4096, 6), np.uint64)
            stamped.probe_read(t.ctypes.data)
            print(f"spike_matmul {name} (rb {rb}, split {split}, {blocks} "
                  f"blocks) phases: " + _phases(t[:blocks], (
                      "staged", "product", "cluster barrier",
                      "rows stored", "last barrier")) +
                  f"; bit-exact {torch.equal(got, want)}", flush=True)
            times = []
            for label, vlib in (("as built", real_lib()),
                                ("4-byte code staging", four)):
                ops._lib = lambda vlib=vlib: vlib
                ok = torch.equal(ops.spike_matmul(sp, qt, d_in=d_in), want)
                us = 1e3 * _device_ms(lambda: ops.spike_matmul(
                    sp, qt, d_in=d_in), "spike_matmul_kernel", per_call=1)
                times.append(f"{label} {us:.2f} us (bit-exact {ok})")
            ops._lib = real_lib
            for sp_n in (1, 2, 4, 8, 16):
                ops._launch_plan = lambda *a, sp_n=sp_n: (rb, sp_n)
                ok = torch.equal(ops.spike_matmul(sp, qt, d_in=d_in), want)
                us = 1e3 * _device_ms(lambda: ops.spike_matmul(
                    sp, qt, d_in=d_in), "spike_matmul_kernel", per_call=1)
                times.append(f"split {sp_n} {us:.2f} us (bit-exact {ok})")
        finally:
            ops._lib, ops._launch_plan = real_lib, real_plan
        print(f"spike_matmul {name} variants: " + ", ".join(times),
              flush=True)


def conv(dev):
    """fused_conv's phases and team sizes (item 5 of the docstring)."""
    import numpy as np
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.fused_conv import ops
    from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize_conv

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    lib = ops._lib()
    one = "(threadIdx.x == 0 && blockIdx.x == 0)"
    stamped = _build("conv_stamps", _patch((csrc / "fused_conv.cu")
                                           .read_text(), [
        ("namespace {\n", "namespace {\n__device__ unsigned long long "
         "g_t[4096][3];\n__device__ long long g_c[2];\n" + _GT),
        ("  extern __shared__ __align__(16) int32_t smem[];\n",
         "  extern __shared__ __align__(16) int32_t smem[];\n"
         "  const long long c_in = clock64();\n"
         "  if (threadIdx.x == 0) g_t[blockIdx.x][0] = g_t[blockIdx.x][1] "
         "= gt();\n"),
        ("    int8mma::cp_async_wait_all();\n    __syncthreads();\n  }\n",
         "    int8mma::cp_async_wait_all();\n    __syncthreads();\n"
         "    if (threadIdx.x == 0) g_t[blockIdx.x][1] = gt();\n  }\n"),
        ("    const int ns = min(kTr, g.T - tg);\n",
         "    const long long c0 = clock64();\n"
         "    const int ns = min(kTr, g.T - tg);\n"),
        ("    if (!leader) continue;\n",
         "    if " + one + " g_c[0] += clock64() - c0;\n"
         "    if (!leader) continue;\n"),
        ("  if (!leader) return;\n  // the final membranes",
         "  if ((threadIdx.x & 31) == 0) atomicMax(&g_t[blockIdx.x][2], "
         "gt());\n  if " + one + " g_c[1] += clock64() - c_in;\n"
         "  if (!leader) return;\n  // the final membranes"),
        ("extern \"C\" const char* fused_conv_error_string",
         "extern \"C\" int probe_read(void* d, void* c) { int e = (int)"
         "cudaMemcpyFromSymbol(d, g_t, sizeof(g_t)); return e ? e : (int)"
         "cudaMemcpyFromSymbol(c, g_c, sizeof(g_c)); }\n"
         "extern \"C\" int probe_clear() { static unsigned long long z[4096]"
         "[3]; static long long zc[2]; int e = (int)cudaMemcpyToSymbol(g_t, "
         "z, sizeof(z)); return e ? e : (int)cudaMemcpyToSymbol(g_c, zc, "
         "sizeof(zc)); }\n"
         "extern \"C\" const char* fused_conv_error_string")]))
    for fn in ("fused_conv_launch", "fused_conv_smem_bytes",
               "fused_conv_error_string"):
        getattr(stamped, fn).argtypes = getattr(lib, fn).argtypes
        getattr(stamped, fn).restype = getattr(lib, fn).restype
    stamped.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    geoms = {"convs.1": (32, 32, 64, 64, 3, 1),
             "convs.3": (16, 16, 128, 128, 3, 1),
             "blocks.6.conv2": (4, 4, 512, 512, 3, 1),
             "blocks.6.proj": (8, 8, 256, 512, 1, 2)}
    real_lib, real_plan = ops._lib, ops._launch_plan
    for name, (h, w, c_in, c_out, k, stride) in geoms.items():
        gen = torch.Generator().manual_seed(h * c_out)
        s = torch.rand((4, 8, h, w, c_in), generator=gen) < 0.2
        planes = packing.pack_bool(s).to(dev)
        qct = quantize_conv((torch.randn((k, k, c_in, c_out), generator=gen)
                             * 0.1).to(dev), PrecisionConfig(bits=4))
        theta = torch.randint(1, 40 * k, (c_out,), generator=gen).to(
            torch.int32).to(dev)
        kw = dict(stride=stride, padding="SAME", leak_shift=3,
                  threshold_q=theta)
        pv, ps = fused_conv_rollout_torch(planes, qct, **kw)
        ho, wo = pv.shape[1:3]
        npix, groups = ho * wo, c_out // 32
        nk, wpr = k * k * planes.shape[-1], qct.data.shape[1]
        ks, bpg, staged, _ = ops._launch_plan(8, npix, groups, nk, wpr)
        try:
            ops._lib = lambda: stamped
            for _ in range(3):
                stamped.probe_clear()
                kv, kspk = ops.fused_conv_rollout(planes, qct, **kw)
            torch.cuda.synchronize()
            t = np.zeros((4096, 3), np.uint64)
            c = np.zeros(2, np.int64)
            stamped.probe_read(t.ctypes.data, c.ctypes.data)
            print(f"fused_conv {name} (ks {ks}, {groups * bpg} blocks) "
                  f"phases: " + _phases(t[:groups * bpg], (
                      "staged", "warps done")) +
                  f"; warp 0 of block 0: MMA loops and team sums {c[0]} of "
                  f"{c[1]} clocks; bit-exact "
                  f"{torch.equal(kv, pv) and torch.equal(kspk, ps)}",
                  flush=True)
            ops._lib = real_lib
            times = []
            for kf in (1, 2, 4, 8):
                if kf > nk:
                    continue
                bf = -(-(-(-npix // 16) * 8) // (8 // kf))
                ops._launch_plan = lambda *a, kf=kf, bf=bf: (
                    kf, bf, staged, 0)
                kv, kspk = ops.fused_conv_rollout(planes, qct, **kw)
                ok = torch.equal(kv, pv) and torch.equal(kspk, ps)
                us = 1e3 * _device_ms(lambda: ops.fused_conv_rollout(
                    planes, qct, **kw), "fused_conv_kernel")
                times.append(f"ks {kf} ({groups * bf} blocks) {us:.2f} us "
                             f"(bit-exact {ok})")
        finally:
            ops._lib, ops._launch_plan = real_lib, real_plan
        print(f"fused_conv {name} team sizes: " + ", ".join(times),
              flush=True)


_AHEAD = r"""template <int BITS, int NS>
__device__ __forceinline__ void mma_ksteps(
    int (&acc)[kTr][4][4], const uint32_t* const (&rows)[4],
    const int32_t* __restrict__ plane, size_t step_words, int k0, int k1,
    const Geom& g, int y_lo, int x_lo, int y_hi, int x_hi, int tq) {
  const int wc = g.wc;
  int tap = k0 / wc;
  int q = k0 - tap * wc;
  Tap tp = tap_at(g, tap, y_lo, x_lo, y_hi, x_hi);
  unsigned lo[NS], hi[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    lo[i] = k0 < k1 && tp.ok_lo ? static_cast<unsigned>(__ldg(
        plane + tp.off_lo + q + i * step_words)) : 0u;
    hi[i] = k0 < k1 && tp.ok_hi ? static_cast<unsigned>(__ldg(
        plane + tp.off_hi + q + i * step_words)) : 0u;
  }
#pragma unroll 2
  for (int kk = k0; kk < k1; ++kk) {
    const int kb = kk * BITS;
    unsigned bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf[j][0] = int8mma::codes_s8<BITS>(rows[j] + kb, 0, tq);
      bf[j][1] = int8mma::codes_s8<BITS>(rows[j] + kb, 1, tq);
    }
    unsigned clo[NS], chi[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      clo[i] = lo[i];
      chi[i] = hi[i];
    }
    if (++q == wc) {
      q = 0;
      ++tap;
      tp = tap_at(g, tap, y_lo, x_lo, y_hi, x_hi);
    }
    const bool more = kk + 1 < k1;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      lo[i] = more && tp.ok_lo ? static_cast<unsigned>(__ldg(
          plane + tp.off_lo + q + i * step_words)) : 0u;
      hi[i] = more && tp.ok_hi ? static_cast<unsigned>(__ldg(
          plane + tp.off_hi + q + i * step_words)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const unsigned a0 = int8mma::spikes_s8(clo[i], tq);
      const unsigned a1 = int8mma::spikes_s8(chi[i], tq);
      const unsigned a2 = int8mma::spikes_s8(clo[i], tq + 4);
      const unsigned a3 = int8mma::spikes_s8(chi[i], tq + 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int8mma::mma_s8(acc[i][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
  }
}
"""


def _interleaved(libs, cases, time_one):
    """Three rounds, each variant in turn within a round, so a drift of the
    card over the call spreads over all of them; us per call."""
    times = {label: {name: [] for name in cases} for label in libs}
    for _ in range(3):
        for label, vlib in libs.items():
            for name, case in cases.items():
                times[label][name].append(time_one(vlib, case))
    return times


def loops(dev):
    """MMA-loop variants of fused_conv and spike_matmul (item 6)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
    from repro_torch.kernels.spike_matmul import ops as sm_ops
    from repro_torch.kernels.spike_matmul.ref import spike_matmul_ref
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize, quantize_conv

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

    def with_fns(vlib, lib, fns):
        for fn in fns:
            getattr(vlib, fn).argtypes = getattr(lib, fn).argtypes
            getattr(vlib, fn).restype = getattr(lib, fn).restype
        return vlib

    # -- fused_conv -----------------------------------------------------
    base = (csrc / "fused_conv.cu").read_text()
    lib = conv_ops._lib()
    fns = ("fused_conv_launch", "fused_conv_smem_bytes",
           "fused_conv_error_string")
    loop_fn = base[base.index("template <int BITS, int NS>\n"):
                   base.index("__device__ __forceinline__ void team_barrier")]
    ldg = ("      const unsigned lo =\n          tp.ok_lo ? static_cast"
           "<unsigned>(__ldg(pl + i * step_words)) : 0u;\n      const "
           "unsigned hi =\n          tp.ok_hi ? static_cast<unsigned>(__ldg"
           "(ph + i * step_words)) : 0u;\n")
    mma = ("        int8mma::mma_s8(acc[i][j], a0, a1, a2, a3, bf[j][0], "
           "bf[j][1]);\n")
    variants = {
        "next k-step's spike words loaded ahead": [(loop_fn, _AHEAD)],
        "k-step loop unrolled by 4": [("#pragma unroll 2\n  for (int kk",
                                       "#pragma unroll 4\n  for (int kk")],
        "no spike loads (timing only)": [(ldg, (
            "      const unsigned lo = kk * 0x9E3779B1u + i;\n"
            "      const unsigned hi = lo * 0x85EBCA6Bu;\n"))],
        "adds in place of mma.sync (timing only)": [(mma, (
            "        acc[i][j][0] += a0 ^ bf[j][0];\n"
            "        acc[i][j][1] += a1 ^ bf[j][1];\n"
            "        acc[i][j][2] += a2;\n        acc[i][j][3] += a3;\n"))],
    }
    libs = {"as built": lib}
    for i, (label, pairs) in enumerate(variants.items()):
        libs[label] = with_fns(_build(f"conv_loop{i}", _patch(base, pairs)),
                               lib, fns)
    geoms = {"convs.1": (32, 32, 64, 64, 3, 1),
             "convs.3": (16, 16, 128, 128, 3, 1),
             "blocks.6.conv2": (4, 4, 512, 512, 3, 1),
             "blocks.6.proj": (8, 8, 256, 512, 1, 2)}
    cases = {}
    for name, (h, w, c_in, c_out, k, stride) in geoms.items():
        gen = torch.Generator().manual_seed(h * c_out)
        s = torch.rand((4, 8, h, w, c_in), generator=gen) < 0.2
        planes = packing.pack_bool(s).to(dev)
        qct = quantize_conv((torch.randn((k, k, c_in, c_out), generator=gen)
                             * 0.1).to(dev), PrecisionConfig(bits=4))
        kw = dict(stride=stride, padding="SAME", leak_shift=3,
                  threshold_q=torch.randint(1, 40 * k, (c_out,),
                                            generator=gen).to(dev))
        cases[name] = (planes, qct, kw,
                       fused_conv_rollout_torch(planes, qct, **kw))
    real = conv_ops._lib
    exact = {}

    def time_conv(vlib, case):
        planes, qct, kw, (pv, ps) = case
        conv_ops._lib = lambda: vlib
        kv, ks = conv_ops.fused_conv_rollout(planes, qct, **kw)
        exact[vlib] = exact.get(vlib, True) and bool(
            torch.equal(kv, pv) and torch.equal(ks, ps))
        return 1e3 * _device_ms(lambda: conv_ops.fused_conv_rollout(
            planes, qct, **kw), "fused_conv_kernel")

    try:
        times = _interleaved(libs, cases, time_conv)
    finally:
        conv_ops._lib = real
    for label, per in times.items():
        print(f"fused_conv MMA loop, {label} (bit-exact "
              f"{exact[libs[label]]}): " + ", ".join(
                  f"{name} " + " / ".join(f"{us:.2f}" for us in v) + " us"
                  for name, v in per.items()), flush=True)

    # -- spike_matmul ---------------------------------------------------
    hdr = (csrc / "nce_product.cuh").read_text()
    base = (csrc / "spike_matmul.cu").read_text()
    lib = sm_ops._lib()
    fns = ("spike_matmul_launch", "spike_matmul_smem_bytes",
           "spike_matmul_error_string")
    qloop = "    for (int q = k_lo; q < k_hi; ++q) {\n"
    expand = ("          int8mma::mma_s8(acc[i], int8mma::spikes_s8(lo, tq),\n"
              "                          int8mma::spikes_s8(hi, tq),\n"
              "                          int8mma::spikes_s8(lo, tq + 4),\n"
              "                          int8mma::spikes_s8(hi, tq + 4), b0, "
              "b1);\n")
    variants = {
        "4-byte code staging": _FOUR_BYTE,
        "k-step loop unrolled by 2": [(qloop, "#pragma unroll 2\n" + qloop)],
        "adds in place of mma.sync (timing only)": [(
            expand, "          acc[i][0] += lo ^ b0; acc[i][1] += hi ^ b1;\n"
                    "          acc[i][2] += lo; acc[i][3] += hi;\n")],
        "no spike expansion (timing only)": [(
            expand, "          int8mma::mma_s8(acc[i], lo, hi, lo >> 16, "
                    "hi >> 16, b0, b1);\n")],
    }
    libs = {"as built": lib}
    for i, (label, pairs) in enumerate(variants.items()):
        src = _patch(base, [("#include \"nce_product.cuh\"\n",
                             _patch(hdr, pairs))])
        libs[label] = with_fns(_build(f"sm_loop{i}", src), lib, fns)
    cases = {}
    for name, (m, d_in, d_out, bits) in (("fc1", (8, 4096, 512, 4)),
                                         ("bench", (64, 2048, 2048, 8))):
        gen = torch.Generator().manual_seed(d_in + m)
        sp = packing.pack_bool(torch.rand((m, d_in), generator=gen) < 0.2
                               ).to(dev)
        qt = quantize((torch.randn((d_out, d_in), generator=gen) * 0.05)
                      .to(dev), PrecisionConfig(bits=bits))
        cases[name] = (sp, qt, d_in, spike_matmul_ref(sp, qt, d_in=d_in))
    real = sm_ops._lib
    exact = {}

    def time_sm(vlib, case):
        sp, qt, d_in, want = case
        sm_ops._lib = lambda: vlib
        exact[vlib] = exact.get(vlib, True) and bool(torch.equal(
            sm_ops.spike_matmul(sp, qt, d_in=d_in), want))
        return 1e3 * _device_ms(lambda: sm_ops.spike_matmul(
            sp, qt, d_in=d_in), "spike_matmul_kernel")

    try:
        times = _interleaved(libs, cases, time_sm)
    finally:
        sm_ops._lib = real
    for label, per in times.items():
        print(f"spike_matmul MMA loop, {label} (bit-exact "
              f"{exact[libs[label]]}): " + ", ".join(
                  f"{name} " + " / ".join(f"{us:.2f}" for us in v) + " us"
                  for name, v in per.items()), flush=True)


def clocks(dev):
    """The same launches timed after the card idled and after it ran
    (item 7 of the docstring)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.spike_matmul import ops as sm_ops
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize, quantize_conv

    gen = torch.Generator().manual_seed(0)
    sp = packing.pack_bool(torch.rand((64, 2048), generator=gen) < 0.2
                           ).to(dev)
    qt = quantize((torch.randn((2048, 2048), generator=gen) * 0.05).to(dev),
                  PrecisionConfig(bits=8))
    planes = packing.pack_bool(torch.rand((4, 8, 32, 32, 64), generator=gen)
                               < 0.2).to(dev)
    qct = quantize_conv((torch.randn((3, 3, 64, 64), generator=gen) * 0.1)
                        .to(dev), PrecisionConfig(bits=4))
    theta = torch.randint(1, 120, (64,), generator=gen).to(dev)
    runs = {
        "spike_matmul bench": (lambda: sm_ops.spike_matmul(
            sp, qt, d_in=2048), "spike_matmul_kernel"),
        "fused_conv convs.1": (lambda: conv_ops.fused_conv_rollout(
            planes, qct, leak_shift=3, threshold_q=theta),
            "fused_conv_kernel"),
    }

    def sm_clock():
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()

    for _ in range(2):
        for name, (fn, match) in runs.items():
            fn()
            torch.cuda.synchronize()
            time.sleep(1.0)
            clk = sm_clock()
            cold = 1e3 * _device_ms(fn, match)
            t_end = time.perf_counter() + 1.0
            while time.perf_counter() < t_end:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            clk_warm = sm_clock()
            warm = 1e3 * _device_ms(fn, match)
            print(f"{name}: after 1 s idle {cold:.2f} us (SM clock {clk} "
                  f"just before), after 1 s of launches {warm:.2f} us "
                  f"({clk_warm})", flush=True)


def state(dev):
    """What a launch's time depends on besides its inputs (item 8)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.fused_group import ops as group_ops
    from repro_torch.kernels.fused_nce import ops as nce_ops
    from repro_torch.kernels.spike_matmul import ops as sm_ops
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize, quantize_conv

    gen = torch.Generator().manual_seed(0)
    sp = packing.pack_bool(torch.rand((64, 2048), generator=gen) < 0.2
                           ).to(dev)
    qt = quantize((torch.randn((2048, 2048), generator=gen) * 0.05).to(dev),
                  PrecisionConfig(bits=8))
    sp1 = packing.pack_bool(torch.rand((4, 8, 4096), generator=gen) < 0.2
                            ).to(dev)
    qt1 = quantize((torch.randn((512, 4096), generator=gen) * 0.05).to(dev),
                   PrecisionConfig(bits=4))
    planes = packing.pack_bool(torch.rand((4, 8, 32, 32, 64), generator=gen)
                               < 0.2).to(dev)
    qct = quantize_conv((torch.randn((3, 3, 64, 64), generator=gen) * 0.1)
                        .to(dev), PrecisionConfig(bits=4))
    theta = torch.randint(1, 120, (64,), generator=gen).to(dev)
    g_planes, members = _group_case(dev, 32, 64,
                                    [64, "P", 128, 128, "P", 256, "P"], 4)

    def sm():
        return sm_ops.spike_matmul(sp, qt, d_in=2048)

    def timings(when):
        a = 1e3 * _device_ms(sm, "spike_matmul_kernel")
        b = 1e3 * _device_ms(lambda: group_ops.fused_group_rollout(
            g_planes, members, leak_shift=3), "fused_group_kernel")
        print(f"state, {when}: spike_matmul bench {a:.2f} us, fused_group "
              f"vgg9 {b:.2f} us", flush=True)

    def twenty(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()

    timings("fresh process")
    timings("fresh process, again")
    twenty(lambda: nce_ops.fused_nce_rollout(sp1, qt1, d_in=4096,
                                             leak_shift=3, threshold_q=40))
    timings("after 20 fused_nce launches")
    twenty(lambda: conv_ops.fused_conv_rollout(planes, qct, leak_shift=3,
                                               threshold_q=theta))
    timings("after 20 fused_conv launches")
    lib = sm_ops._lib()
    copy = _build("sm_copy", (ROOT / "src" / "repro_torch" / "kernels" /
                              "csrc" / "spike_matmul.cu").read_text())
    for fn in ("spike_matmul_launch", "spike_matmul_smem_bytes",
               "spike_matmul_error_string"):
        getattr(copy, fn).argtypes = getattr(lib, fn).argtypes
        getattr(copy, fn).restype = getattr(lib, fn).restype
    timings("after building and loading a copy of spike_matmul.cu")
    real = sm_ops._lib
    sm_ops._lib = lambda: copy
    try:
        twenty(sm)
        c = 1e3 * _device_ms(sm, "spike_matmul_kernel")
    finally:
        sm_ops._lib = real
    print(f"state, the copy: spike_matmul bench {c:.2f} us", flush=True)
    timings("after 20 launches of the copy")

    def card():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,pstate,"
             "power.draw", "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()

    rb, split = sm_ops._launch_plan(64, 64, 8, 2048)
    out = torch.empty((64, 2048), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def dense():
        for _ in range(10):
            lib.spike_matmul_launch(sp.data_ptr(), qt.data.data_ptr(),
                                    out.data_ptr(), 64, 64, 2048, 512, 8,
                                    2048, rb, split, stream)

    for _ in range(2):
        clk = card()
        one = 1e3 * _device_ms(sm, "spike_matmul_kernel")
        ten = 1e3 * _device_ms(dense, "spike_matmul_kernel") / 10
        print(f"state, spike_matmul bench: one wrapper call a launch "
              f"{one:.2f} us, 10 dense launches {ten:.2f} us a launch "
              f"(card: {clk})", flush=True)


def async_tier(dev):
    import threading

    import numpy as np
    import torch

    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config)
    from repro_torch.models import snn_cnn
    from repro_torch.serve_async import AsyncEngineConfig, AsyncSNNServeEngine

    torch.backends.cudnn.allow_tf32 = False
    cfg = deploy_config("vgg9", 4, smoke=False)
    model = deploy(snn_cnn.init(0, cfg, device=dev), cfg, device=dev)
    images = np.random.default_rng(1).random(
        (64, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)
    ecfg = SNNEngineConfig(max_batch=8, buckets=(8,))
    x = torch.from_numpy(images[:8]).to(dev)

    def forward():
        with torch.inference_mode():
            model.apply(x)
        torch.cuda.synchronize()

    forward()
    for _ in range(2):
        times = []

        def twice():
            for _ in range(2):
                t0 = time.perf_counter()
                forward()
                times.append((time.perf_counter() - t0) * 1e3)

        th = threading.Thread(target=twice)
        th.start()
        th.join(timeout=60)
        print(f"async: a forward on a fresh thread: first call "
              f"{times[0]:.3f} ms, second {times[1]:.3f} ms", flush=True)

    eng = SNNServeEngine(model, ecfg, device=dev)
    eng.warmup()
    for rnd in range(3):
        for uid in range(64):
            eng.add_request(SNNRequest(uid=uid, image=images[uid]))
        t0 = time.perf_counter()
        st = eng.run_until_done()
        wall = time.perf_counter() - t0
        for uid in range(64):
            eng.pop_result(uid)
        print(f"async: sync engine round {rnd}: {64 / wall:.1f} images/s, "
              f"{st['compute_avg_ms']:.3f} ms compute a batch (running)",
              flush=True)

    for workers, switch in ((1, None), (2, None), (1, 1e-4)):
        old = sys.getswitchinterval()
        if switch is not None:
            sys.setswitchinterval(switch)
        try:
            aeng = AsyncSNNServeEngine(SNNServeEngine(model, ecfg,
                                                      device=dev),
                                       AsyncEngineConfig(workers=workers))
            aeng.warmup()
            aeng.start()
            for rnd in range(3):
                b0 = aeng.engine.total_batches
                c0 = aeng.engine.total_compute_s
                t0 = time.perf_counter()
                futs = [aeng.submit(im) for im in images]
                if not all(f.result(timeout=60).ok for f in futs):
                    raise AssertionError("async probe: a request failed")
                wall = time.perf_counter() - t0
                nb = aeng.engine.total_batches - b0
                comp = (aeng.engine.total_compute_s - c0) / nb
                print(f"async: {workers} worker(s), switch interval "
                      f"{sys.getswitchinterval() * 1e3:g} ms, round {rnd}: "
                      f"{64 / wall:.1f} images/s, {nb} batches, "
                      f"{comp * 1e3:.3f} ms compute a batch", flush=True)
            aeng.close(timeout=60)
        finally:
            sys.setswitchinterval(old)


_FINISH = r"""
import dataclasses, json, statistics, sys, time
import torch
from repro_torch.deploy import (SNNEngineConfig, SNNRequest, SNNServeEngine,
                                deploy, deploy_config)
from repro_torch.deploy.engine import InflightStep
from repro_torch.models import snn_cnn
dev = torch.device("cuda", 0)
cfg = deploy_config("vgg9", 4, smoke=True)
model = deploy(snn_cnn.init(0, cfg, device=dev), cfg, device=dev)
eng = SNNServeEngine(model, SNNEngineConfig(max_batch=8, buckets=(8,)),
                     device=dev)
has_pad = "pad_frac" in {f.name for f in dataclasses.fields(InflightStep)}
done = torch.cuda.Event()
done.record()
torch.cuda.synchronize()
def step(logits):
    t = time.perf_counter()
    batch = []
    for uid in range(8):
        r = SNNRequest(uid=uid, image=None)
        r._t0, r.queue_s = t, 0.0
        batch.append(r)
    kw = dict(batch=batch, bucket=8, n=8, logits=logits, t0=t,
              done=done if logits.is_cuda else None)
    if has_pad:
        kw["pad_frac"] = 0.0
    return InflightStep(**kw)
out = {}
for where in ("cuda", "cpu"):
    logits = torch.randn(8, 10, device=where)
    rounds = []
    for _ in range(5):
        steps = [step(logits) for _ in range(2000)]
        t0 = time.perf_counter()
        for st in steps:
            eng.finish_step(st, sink=lambda r: None)
        rounds.append((time.perf_counter() - t0) / len(steps) * 1e6)
    out[where] = statistics.median(rounds)
print(json.dumps(out))
"""


def finish_step(trees):
    import json
    import os

    for tree in trees or [str(ROOT)]:
        tree = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        res = subprocess.run([sys.executable, "-c", _FINISH], cwd=tree,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        if res.returncode:
            raise RuntimeError(f"finish probe in {tree}: {res.stderr}")
        us = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"finish: {tree.name or tree}: finish_step "
              f"{us['cuda']:.3f} us a batch of 8 (logits on the card), "
              f"{us['cpu']:.3f} us (on the host)", flush=True)


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
    if sys.argv[1:2] == ["finish"]:
        finish_step(sys.argv[2:])
        return 0
    dev = torch.device("cuda", 0)
    probes = {"linears": linears, "stamps": stamps, "snn": snn, "nce": nce,
              "conv": conv, "loops": loops, "clocks": clocks,
              "state": state, "async": async_tier}
    if not sys.argv[1:]:
        del probes["state"], probes["async"]
    for name in sys.argv[1:] or probes:
        probes[name](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
