#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and builds the CUDA kernels from ``src/repro_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel).
2. One phase per kernel: holds the hand-written kernel against its plain
   PyTorch version on the card, on random packed planes at ~20% spike
   density, random codes and thetas, B=8, T=4, bits 2/4/8 and both
   resets, at every geometry the served paths launch it at (full-width
   vgg9, vgg16 and resnet18) plus stride-2 and ragged cases.  Membranes and
   packed words must be bit-exact.  Times the kernel, the plain version
   and one library call that does only the accumulate, each as device
   time per call from torch.profiler (the wrapper's wall time per call
   from CUDA events is printed beside), and works out the bound (bytes
   over 3.35 TB/s vs the adds this data needs over 1979 T/s, the H100
   data-sheet rates ``repro_torch.perfmodel.roofline`` holds).  The
   ``fused_group`` phase also times the per-layer ``fused_conv`` + pool
   chain that fusion replaces, on the same input (``chain_ms`` in the
   record), and prints each chain's launch plan (cluster size, T chunk,
   staged codes, K split); the ``fused_nce`` phase prints its grid; the
   ``fused_conv`` phase prints each geometry's launch plan (blocks, warps
   per unit, staged or L2 codes) and asserts, with one torch.profiler
   pass over one wrapper call, that the call runs exactly one CUDA
   kernel (no pad or copy).
3. End to end, four paths, each ``graph_init`` (seed 0) -> ``deploy`` ->
   ``save`` -> ``load`` at full width, INT4, then
   ``SNNServeEngine(max_batch=8)`` serves 16 requests with every launch
   count set to 0 just before and read just after:
   - vgg9 ``fusion=()``: 4 ``fused_conv`` + 1 ``fused_nce`` per batch;
   - vgg9 ``fusion="auto"``: 1 ``fused_group`` + 1 ``fused_nce``, logits
     also equal to the ``fusion=()`` engine's;
   - resnet18 ``fusion="auto"``: 5 ``fused_group`` + 9 ``fused_conv``;
   - vgg16 ``fusion=()`` (the paper's Table II network), its params
     balanced by ``calibrate`` on 32 images (seed 1) first, since an
     uncalibrated 13-conv SNN goes silent: 12 ``fused_conv`` + 1
     ``fused_nce``.
   Every request's logits must equal the same forward walked layer by
   layer with the plain versions on the card (TF32 off for both), and
   every packed layer's input spike rate there must be > 0.
   Last of all (after 6.), the sampled observability passes
   (``obs_phase``): for vgg9
   ``fusion=()``, vgg9 ``"auto"`` and resnet18 ``"auto"`` at full width
   (INT4, seed 0, 2 sample images) ``instrumented_forward``'s rates equal
   ``apply_with_rates``'s within one float32 ulp (division against a
   multiply by the rounded reciprocal; a fused group's row exactly: its
   output plane's rate on the plain path), each pass launches one
   forward's kernels (vgg9
   auto: 1 ``fused_group`` + 1 ``fused_nce``), the logits equal the
   unwrapped forward's, and ``timed_forward`` gives one row per executed
   node with ``wall_us > 0``; the per-node table (wall, H100 roofline
   prediction, ratio, bottleneck) is printed beside the unwrapped
   forward's blocked wall and each pass's cost.  Then ``serve_snn.main``
   with ``--full --fusion auto --metrics --trace --profile``: the JSONL
   validates with the ``layer_telemetry``, ``predicted_vs_measured`` and
   ``code_utilization`` spans, the watchdog's calibration equals the
   telemetry rates, and the profiler trace holds ``snn_serve_step/b8``
   and ``fused_group``/``fused_nce`` kernels; and ``launch.train.main``
   (olmo-1b ``--smoke --steps 3 --profile``) writes a trace with device
   kernels.
4. The NCE step path (``NeuronComputeEngine.step`` = ``spike_matmul`` ->
   ``lif_step``'s packed entry, which writes the spike words itself) at
   vgg9's fc1 geometry (T=4, B=8, 4096->512, W2/4/8), kernel_bench's NCE
   geometry (T=8, B=64, 2048->2048, W8/2/4) and a ragged one (T=4, B=8,
   1000->100, W2/4/8), 20% input density, both resets: each kernel and
   both ``lif_step`` entries bit-exact against their plain versions
   (the packed entry against ``lif_step_ref`` + ``pack_bool``),
   ``rollout_unfused`` equal bit for bit to ``rollout`` (``fused_nce``)
   and to the plain rollout, one profiled ``step`` running exactly two
   device kernels, and T launches of each kernel per unfused rollout;
   ``spike_matmul``'s (rb, split) printed and one CUDA kernel a call
   asserted, as for ``fused_conv``.  Times both ``lif_step`` entries,
   the plain version and the bounds, and the step's device and wall time
   beside the earlier step (int32 entry, then ``pack_bool``).
   Then the async tier: vgg9 ``fusion=()`` at full width, INT4, through
   ``AsyncSNNServeEngine`` (2 workers, bucket 8), 64 requests from 4
   threads and 64 through loadgen's open loop (Poisson, 1000/s, seed 0):
   every logit vector equal to the sync engine's, 4 ``fused_conv`` + 1
   ``fused_nce`` a batch, no timeouts, registry and engine totals
   reconciled, a Chrome trace that passes ``obs.validate``; images/s and
   p50/p95/p99 printed with the card.
   Then vgg9 trained on the card (``snn_train_phase``): W4 QAT at full
   width, ``calibrate`` on 32 images (in float64, gains within rtol
   1e-3 of the host's float64 calibration; float32 printed), the
   calibrated float forward and the
   first step's gradients at batch 8 against the host in float64
   (logits relative RMS <= 0.02, >= 99.5% of each layer's spikes equal,
   gradients relative RMS <= 0.05; beside them, PyTorch's TF32 backward
   and TF32 throughout, with the ms of a forward and backward), 1 + 30
   BPTT steps at batch 64 with AdamW (losses finite and falling; ms a
   step, images/s, peak memory, a profiled step's device-busy share),
   then the trained params deployed at INT4 and served with
   ``fusion=()`` and ``"auto"`` as in 3., equal to the per-call
   ``IntExecutor`` forward; QAT and deployed test accuracy printed.
5. olmo-1b at full width (16 layers, d 2048, d_ff 8192, vocab 50304,
   bf16), random weights from seed 0, every linear packed to W4 (one
   scale per output row) with the port's ``quantize``:
   - served by ``ServeEngine(slots=8, max_len=1024)`` with a bf16 KV
     cache: 16 requests, prompts of 16-256 tokens from
     ``numpy.random.default_rng(0)``, 32 new tokens each; 112
     ``packed_qmatmul`` launches per prefill and per decode step, each
     prefill's counted apart by the variant its prompt length selects;
   - with an INT4 KV cache: a uniform batch of 8 prompts of 512 tokens,
     the prefill cache padded to 1024, 32 ``decode_step(ragged=False)``
     steps; 16 ``kv_attention`` launches per step;
   every logit vector is compared with the same request re-run
   teacher-forced through the plain versions on the card (TF32 off):
   relative RMS error and max error over the plain logits' largest
   magnitude <= 0.10 / 0.15 with the bf16 cache and <= 0.25 / 0.30 with
   the INT4 cache, at every step (bf16 rounding noise through 16 layers,
   which flips INT4 KV codes; a wrong kernel is off by ~1); beside it the
   same measures of a float64-summed plain re-run against the float32
   one (the floor summation order alone makes), the greedy-token
   agreement, the share of packed KV words that differ after prefill,
   and a profile of a decode step.  Each LM kernel is also held against
   its plain version and timed at the shapes of the served path:
   ``packed_qmatmul`` for one layer's 7 linears at M=8 (a decode step,
   the CUDA-core variant), at each of the serve phase's prompt lengths
   (summed by variant), at M=256 and at M=4096 (the INT4-KV prefill; the
   chosen variant and tile are printed), ``kv_attention`` at a decode
   step (also with a sliding window and a logit cap).  The same for the
   other LM families at their served shapes (``families_kernel_phase``,
   right after olmo's; see 7.).

6. olmo-1b training (``train_phase``, after the serve phases' params
   are freed), every line beside the card's name and power limit:
   - one ``make_train_step`` at full width and depth, bf16, W4 QAT,
     batch 8 x 128: 1 warm and 5 timed steps, every loss and grad norm
     finite, ms a step, tokens/s, ``max_memory_allocated``, and the
     device-busy share of 3 profiled steps;
   - ``Trainer`` at full width cut to 2 layers (~2.4 GB a checkpoint):
     8 steps, a checkpoint every 4 (async, keep 1), then the same run
     failed at step 6 by a ``FailureInjector`` and restarted by
     ``run_with_restarts`` from the step-4 checkpoint, its losses at steps
     4-7 within rtol 1e-3 of the uninterrupted run's;
   - 2 steps with the spiking FFN (``SpikingConfig()``) at 2 layers;
   - the step-8 checkpoint restored, packed to W4 (absmax scales, the
     grid QAT trained on) and served by ``ServeEngine`` (4 requests, bf16
     KV): 14 ``packed_qmatmul`` launches a forward, 8 greedy tokens a
     request, first-token logits within 0.10 / 0.15 relative RMS / max of
     the fake-quant forward of the same checkpoint, its quantizer in
     float32 (printed beside: the bf16 fake-quant forward, not
     asserted); the checkpoint directories are deleted.

7. The LM families beyond the dense ones (``families_phase``, after 6.
   and before the obs phase), each at full width, bf16, random weights
   from seed 0, its linears packed to W4 (``pack_lm``: every
   ``layers.linear`` weight; MoE's stacked experts, the router and the
   SSM conv taps stay dense), every line beside the card:
   - granite-moe-3b-a800m (128 ``packed_qmatmul`` a forward; prefills
     on the dispatch path, decode steps on the dense mix), mamba2-1.3b
     (96) and hymba-1.5b (288), each served by ``ServeEngine(slots=8,
     max_len=1024)`` with a bf16 KV cache, 8 requests of
     ``serve_prompts`` and 16 new tokens: tokens/s, p50 / p95, every
     logit vector within 0.10 / 0.15 of the same requests re-served on
     the plain path, fed the same tokens and, for MoE, routed to the
     experts the served run chose (``forced_engine``, ``routing_log``;
     printed beside: the share of (token, layer) top-k sets the plain
     path's own router would have picked otherwise);
   - hymba-1.5b with an INT4 KV cache, a uniform batch of 4 x 1024
     tokens and 16 decode steps across its 1024 window (32
     ``kv_attention`` a step), paligemma-3b with an INT4 KV cache, 4 x
     (256 random vision embeddings + 64 tokens) and 16 steps (127
     ``packed_qmatmul`` at prefill, 126 and 18 ``kv_attention`` at
     head_dim 256, G 8 a step), both within 0.25 / 0.30; whisper-base,
     ``encode`` of 4 x 1500 stub frames in the prefill of a 4-token
     prompt, the cache padded to 448, 32 decode steps, bf16 KV (96 at
     prefill, 48 a step), within 0.10 / 0.15;
   - a profiled decode step of each engine run.
   Each family's decode-layer linears at M=8 and ``kv_attention`` at
   Hymba's and PaliGemma's caches are held against the plain versions
   and timed, and the linears held against the plain version at every
   other M these runs give them (prefills, encode, uniform decode at
   M=4), by ``families_kernel_phase``, which runs beside olmo's kernel
   phase: after the serving and training phases the profiler misses
   launches.
   moonshot-v1-16b-a3b (~56 GB in bf16) is held only on the CPU.

8. The distributed layer as one NCCL rank (``distributed_phase``, last,
   so that no earlier number moves): a one-rank NCCL group from a
   ``FileStore`` and a (1, 1) ``("data", "model")`` mesh; olmo-1b at full
   width (bf16, W4 QAT, batch 8 x 128) for 3 ``make_train_step(
   tensor_parallel=True)`` steps on params placed by ``to_shardings``
   (the tensor-parallel route, its collectives on a one-rank ``model``
   group), losses within rtol 1e-5 of 3 unsharded steps from the same
   params and params within 1e-2 of the leaf's largest (ms a step, peak
   memory), and one ``grad_accum=2`` step on the mesh against the
   unsharded ``grad_accum=2`` step under the same gates;
   ``tree_ef_allreduce_mean`` over NCCL on one step's gradient
   tree, bit-exact against ``tree_ef_plain`` (two rounds, ms); the placed
   params saved from the mesh and ``restore(shardings=)``d, bit-equal;
   vgg9 INT4 ``fusion=()`` / ``"auto"`` and resnet18 ``"auto"`` through
   ``SNNServeEngine(data_parallel=True)``: logits bit-equal and launch
   counts equal to ``data_parallel=False``, images/s of both; olmo-1b
   (bf16 params) prefilled over 8 x 512 tokens and decoded 32 steps by
   ``make_prefill_step`` / ``make_decode_step`` (tensor-parallel on
   placed params) over a bf16 and an INT4 KV cache (16
   ``kv_attention`` a step), logits and cache bit-equal to the
   unsharded steps, ms a decode step and peak memory of both; then the
   MoE, SSM and hybrid families on the same route at full width
   (``_tp_family``): mamba2-1.3b (3 W4 QAT train steps at full depth),
   hymba-1.5b and granite-moe-3b-a800m (at 8 of 32 layers) against the
   unsharded step (the olmo case's gates), and their prefill and 32
   decode steps (mamba2 and hymba at full depth, granite at 8 layers;
   granite and hymba over bf16 and INT4 KV, a ``kv_attention`` a layer
   a step; mamba2 with no KV cache), bit-equal, every router call's
   experts the unsharded run's.  More
   than one rank on a mesh axis needs more cards: the CPU tests run
   those over gloo.

9. The dry run (``dryrun_phase``, after 8.): ``python -m
   repro_torch.launch.dryrun`` of olmo-1b ``train_4k`` on a fake 16 x 16
   mesh at full depth (tensor-parallel: arguments + temp under 80 GB a
   device, ``flops_per_device`` beside a 256th of the cell's FLOPs) and
   its roofline, then the card cell dry-run on one fake rank against the
   real step on the card (FLOPs equal, peak within 25%).  The host work
   (the CLI and the one-rank dry run, subprocesses that need no card)
   runs beside the kernel build (``start_dryrun_host``), and the
   script waits for it before the first timed phase.

Exits non-zero on any failure and without a card.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import atexit
import contextlib
import json
import os
import shlex
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _median_ms(fn, iters=20, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def _device_ms(fn, match="", reps=10, per_call=None):
    """Device time per call of ``fn``: the summed time of the CUDA kernels
    (and copies) it runs, from torch.profiler, counting only events whose
    name contains ``match``.  Each profile holds ``reps`` calls between
    two ~10 ms spins of the card (``window``): a profile that starts
    with the kept calls loses the first launch (69 of 70 on the H100).
    Late in a run, after the serving and training phases, profiles lose
    launches whatever the spin (31 of 40, 78 of 90, the same count at
    each try, with spins up to ~160 ms and with ``gc.collect()`` before
    each; why is not known), so the kernel phases run first.  A profile
    is taken again (5 tries, a try after the first printed) when it holds
    no device time or, with ``per_call`` (the launches under ``match``
    one call makes), not ``reps * per_call`` of them.  Raises when the
    profiler saw device time but none under ``match`` (a renamed kernel)
    or never the expected count; falls back to the CUDA-event wall time
    only when the profiler reports no device time at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window():
        """The reps between two ~10 ms spins of the card (CUDA's
        ``spin_kernel``, left out of every count and sum)."""
        torch.cuda._sleep(20_000_000)
        for _ in range(reps):
            fn()
        torch.cuda._sleep(20_000_000)
        torch.cuda.synchronize()

    tries, counts = 5, []
    for attempt in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            window()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.key]
        hits = [e for e in events if match in e.key]
        us = sum(e.self_device_time_total for e in hits)
        seen = sum(e.count for e in hits)
        counts.append(seen)
        if us > 0 and per_call in (None, seen / reps):
            if attempt:
                print(f"  (profiler caught {counts} launches under "
                      f"{match!r} in {attempt + 1} tries)", flush=True)
            return us / reps / 1e3
        if us <= 0 and any(e.self_device_time_total > 0 for e in events):
            raise AssertionError(
                f"profiler saw device time but no kernel matching "
                f"{match!r}: " + ", ".join(e.key[:60] for e in events))
    if us > 0:
        raise AssertionError(f"profiler caught {counts} launches under "
                             f"{match!r} in {tries} tries, expected "
                             f"{reps * per_call}")
    print(f"  (profiler gave no device time for {match or 'call'}; "
          f"CUDA-event wall time instead)", flush=True)
    return _median_ms(fn)


def _only_kernels(fn, kernels, calls=10):
    """Assert that a call of ``fn`` runs exactly the CUDA kernels named in
    ``kernels``, one each (and no copy or fill): torch.profiler over
    ``calls`` calls (after a warm-up call) must show those kernels alone,
    each at most once a call (the launch counters show they run once a
    call).  A profile that caught no event is taken again (5
    tries)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, e.count) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    names = sorted(kernels)
    found = sorted(next((k for k in names if k in key), key)
                   for key, _ in events)
    if found != names or not all(1 <= c <= calls for _, c in events):
        raise AssertionError(f"{calls} calls ran {events} on the device; "
                             f"expected {names} alone, each once a call")


def _bound_ms(nbytes, ops, ops_per_s=None):
    """The least time for ``nbytes`` and ``ops`` on the card, with the
    H100 data-sheet rates of ``repro_torch.perfmodel.roofline``: HBM
    bandwidth, and ``ops_per_s`` (default the int8 tensor-core peak).
    Returns (bound, bytes term, ops term) in ms."""
    from repro_torch.perfmodel.roofline import HBM_BW, PEAK_INT8_OPS

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = ops / (ops_per_s or PEAK_INT8_OPS) * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def _thetas(gen, codes, k_real, n, dev):
    """Random per-channel thresholds scaled to the expected current, so a
    good share of neurons fire and a good share do not."""
    import torch

    std = float(codes.float().std()) * (0.2 * k_real) ** 0.5
    hi = max(2, int(2.0 * std))
    return torch.randint(1, hi, (n,), generator=gen).to(torch.int32).to(dev)


def conv_phase(dev, gen, geometries, main_names):
    import torch
    import torch.nn.functional as F

    from repro_torch.core import packing
    from repro_torch.kernels.fused_conv import ops
    from repro_torch.kernels.fused_conv.ref import (
        conv_pads, fused_conv_rollout_torch)
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize_conv

    t_steps, b = 4, 8
    rows, checks, max_err = {}, 0, 0
    for name, (h, w, c_in, c_out, k, stride) in geometries.items():
        s = (torch.rand((t_steps, b, h, w, c_in), generator=gen) < 0.2)
        planes = packing.pack_bool(s).to(dev)
        wf = torch.randn((k, k, c_in, c_out), generator=gen) * 0.1
        for bits in (2, 4, 8):
            qct = quantize_conv(wf.to(dev), PrecisionConfig(bits=bits))
            codes = packing.unpack(qct.data, bits, qct.k_flat)
            theta = _thetas(gen, codes, k * k * c_in, c_out, dev)
            for soft in (True, False):
                kw = dict(stride=stride, padding="SAME", leak_shift=3,
                          threshold_q=theta, v_reset_q=-2, soft_reset=soft)
                pv, ps = fused_conv_rollout_torch(planes, qct, **kw)
                kv, ks = ops.fused_conv_rollout(planes, qct, **kw)
                torch.cuda.synchronize()
                err = int((kv.to(torch.int64) - pv).abs().max())
                max_err = max(max_err, err)
                if err or not torch.equal(ks, ps):
                    raise AssertionError(
                        f"fused_conv {name} w{bits} soft={soft}: kernel "
                        f"disagrees with the plain version (membrane max "
                        f"|err| {err}, spike words equal "
                        f"{torch.equal(ks, ps)})")
                rate = float(packing.unpack_bool(ps, c_out).float().mean())
                if not 0.0 < rate < 1.0:
                    raise AssertionError(f"fused_conv {name} w{bits}: "
                                         f"vacuous output rate {rate}")
                checks += 1
                run = lambda: ops.fused_conv_rollout(planes, qct, **kw)
                if bits == 4 and soft:
                    _only_kernels(run, ["fused_conv_kernel"])
                    ho, wo = pv.shape[1], pv.shape[2]
                    ks_, bpg, staged, smem = ops._launch_plan(
                        b, ho * wo, -(-c_out // 32),
                        k * k * planes.shape[-1], qct.data.shape[1])
                    print(f"  fused_conv {name:<14} launch: "
                          f"{-(-c_out // 32) * bpg} blocks, {8 // ks_} "
                          f"units of {ks_} warps a block, codes "
                          f"{'staged' if staged else 'read from L2'}, "
                          f"{smem} B of shared memory a block; one kernel "
                          f"a call", flush=True)
                if name not in main_names or bits != 4 or not soft:
                    continue
                # timing and bound at the main path's configuration
                ms = _device_ms(run, "fused_conv_kernel")
                call_ms = _median_ms(run)
                plain_ms = _device_ms(
                    lambda: fused_conv_rollout_torch(planes, qct, **kw),
                    reps=3)
                (plh, phh), (plw, phw) = conv_pads(h, w, k, k, stride,
                                                   "SAME")
                x16 = F.pad(s.reshape(t_steps * b, h, w, c_in)
                            .permute(0, 3, 1, 2).to(dev, torch.float16),
                            (plw, phw, plh, phh))
                w16 = wf.permute(3, 2, 0, 1).to(dev, torch.float16)
                lib_ms = _device_ms(lambda: F.conv2d(x16, w16, stride=stride))
                # adds this data needs: set input bits in each receptive
                # field, once per output channel
                ones = torch.ones((1, 1, k, k), device=dev)
                per_px = F.conv2d(x16.float().sum(1, keepdim=True), ones,
                                  stride=stride)
                adds = float(per_px.sum()) * c_out
                ho, wo = pv.shape[1], pv.shape[2]
                nbytes = 4 * (planes.numel() + qct.data.numel() + c_out
                              + b * ho * wo * c_out + ps.numel())
                bound, t_b, t_o = _bound_ms(nbytes, adds)
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound, bytes_ms=t_b, ops_ms=t_o)
                print(f"  fused_conv {name:<14} {h}x{w} {c_in}->{c_out} "
                      f"k{k} s{stride} w4: kernel {ms:.4f} ms (wrapper "
                      f"call {call_ms:.4f} ms wall) | plain "
                      f"{plain_ms:.4f} ms | fp16 conv2d (accumulate only) "
                      f"{lib_ms:.4f} ms | bound {bound:.4f} ms "
                      f"(bytes {t_b:.4f}, adds {t_o:.4f}; {nbytes} B, "
                      f"{adds:.3e} adds) | out rate {rate:.3f}", flush=True)
    print(f"fused_conv: {checks} checks bit-exact, each geometry's call "
          f"one kernel", flush=True)
    return rows, max_err


def nce_phase(dev, gen, geometries, main_names):
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.fused_nce import ops
    from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize

    t_steps = 4
    rows, checks, max_err = {}, 0, 0
    for name, (m, d_in, d_out) in geometries.items():
        s = (torch.rand((t_steps, m, d_in), generator=gen) < 0.2)
        spikes = packing.pack_bool(s).to(dev)
        wf = torch.randn((d_out, d_in), generator=gen) * 0.05
        for bits in (2, 4, 8):
            qt = quantize(wf.to(dev), PrecisionConfig(bits=bits))
            codes = packing.unpack(qt.data, bits, d_in)
            theta = _thetas(gen, codes, d_in, d_out, dev)
            for soft in (True, False):
                kw = dict(d_in=d_in, leak_shift=3, threshold_q=theta,
                          v_reset_q=-2, soft_reset=soft)
                pv, ps = fused_nce_rollout_torch(spikes, qt, **kw)
                kv, ks = ops.fused_nce_rollout(spikes, qt, **kw)
                torch.cuda.synchronize()
                err = int((kv.to(torch.int64) - pv).abs().max())
                max_err = max(max_err, err)
                if err or not torch.equal(ks, ps):
                    raise AssertionError(
                        f"fused_nce {name} w{bits} soft={soft}: kernel "
                        f"disagrees with the plain version (membrane max "
                        f"|err| {err}, spike words equal "
                        f"{torch.equal(ks, ps)})")
                rate = float(packing.unpack_bool(ps, d_out).float().mean())
                if not 0.0 < rate < 1.0:
                    raise AssertionError(f"fused_nce {name} w{bits}: "
                                         f"vacuous output rate {rate}")
                checks += 1
                if name not in main_names or bits != 4 or not soft:
                    continue
                run = lambda: ops.fused_nce_rollout(spikes, qt, **kw)
                ms = _device_ms(run, "fused_nce_kernel")
                call_ms = _median_ms(run)
                plain_ms = _device_ms(
                    lambda: fused_nce_rollout_torch(spikes, qt, **kw),
                    reps=3)
                x16 = s.reshape(t_steps * m, d_in).to(dev, torch.float16)
                w16 = wf.T.contiguous().to(dev, torch.float16)
                lib_ms = _device_ms(lambda: torch.matmul(x16, w16))
                adds = float(s.sum()) * d_out
                nbytes = 4 * (spikes.numel() + qt.data.numel() + d_out
                              + m * d_out + ps.numel())
                bound, t_b, t_o = _bound_ms(nbytes, adds)
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound, bytes_ms=t_b, ops_ms=t_o)
                rb, split = ops._nce_plan(t_steps, m, spikes.shape[-1], bits,
                                          -(-d_out // 32) * 32)
                print(f"  fused_nce {name:<6} launch: {-(-d_out // 32)} "
                      f"groups x {-(-m // rb)} row chunks of {rb} x a "
                      f"{split}-block cluster", flush=True)
                print(f"  fused_nce {name:<6} m={m} {d_in}->{d_out} w4: "
                      f"kernel {ms:.4f} ms (wrapper call {call_ms:.4f} ms "
                      f"wall) | plain {plain_ms:.4f} ms | fp16 "
                      f"matmul (accumulate only) {lib_ms:.4f} ms | bound "
                      f"{bound:.4f} ms (bytes {t_b:.4f}, adds {t_o:.4f}; "
                      f"{nbytes} B, {adds:.3e} adds) | out rate {rate:.3f}",
                      flush=True)
    print(f"fused_nce: {checks} checks bit-exact", flush=True)
    return rows, max_err


def group_phase(dev, gen, chains, main_names):
    """fused_group against its plain version on every chain, and, at the
    main path's configuration (w4, soft reset), its time beside the plain
    version's, the per-layer fused_conv + pool chain's it replaces, the
    summed fp16 conv2d of the members (accumulate only) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import packing
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
    from repro_torch.kernels.fused_group import ops
    from repro_torch.kernels.fused_group.ref import (
        fused_group_rollout_torch, maxpool_packed)
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize_conv

    t_steps, b = 4, 8
    rows, checks, max_err = {}, 0, 0
    for name, (hw, c_in, spec) in chains.items():
        s = (torch.rand((t_steps, b, hw, hw, c_in), generator=gen) < 0.2)
        planes = packing.pack_bool(s).to(dev)
        wfs, c = [], c_in
        for item in spec:
            if item != "P":
                wfs.append(torch.randn((3, 3, c, item), generator=gen) * 0.1)
                c = item
        for bits in (2, 4, 8):
            members, wi, thetas = [], iter(wfs), []
            for item in spec:
                if item == "P":
                    members.append(("pool", 2))
                    continue
                wf = next(wi)
                qct = quantize_conv(wf.to(dev), PrecisionConfig(bits=bits))
                codes = packing.unpack(qct.data, bits, qct.k_flat)
                theta = _thetas(gen, codes, 9 * wf.shape[2], item, dev)
                members.append(("conv", qct, theta))
            c_last = members[-1][1].c_out if members[-1][0] == "conv" \
                else members[-2][1].c_out
            for soft in (True, False):
                kw = dict(leak_shift=3, v_reset_q=-2, soft_reset=soft)
                pv, ps = fused_group_rollout_torch(planes, members, **kw)
                kv, ks = ops.fused_group_rollout(planes, members, **kw)
                torch.cuda.synchronize()
                err = int((kv.to(torch.int64) - pv).abs().max())
                max_err = max(max_err, err)
                if err or not torch.equal(ks, ps):
                    raise AssertionError(
                        f"fused_group {name} w{bits} soft={soft}: kernel "
                        f"disagrees with the plain version (membrane max "
                        f"|err| {err}, spike words equal "
                        f"{torch.equal(ks, ps)})")
                rate = float(packing.unpack_bool(ps, c_last).float().mean())
                if not 0.0 < rate < 1.0:
                    raise AssertionError(f"fused_group {name} w{bits}: "
                                         f"vacuous output rate {rate}")
                checks += 1
                if name not in main_names or bits != 4 or not soft:
                    continue

                def per_layer():
                    x, ch = planes, c_in
                    for m in members:
                        if m[0] == "conv":
                            _, x = conv_ops.fused_conv_rollout(
                                x, m[1], stride=1, padding="SAME",
                                threshold_q=m[2], **kw)
                            ch = m[1].c_out
                        else:
                            x = maxpool_packed(x, ch, m[1])
                    return x

                if not torch.equal(per_layer(), ks):
                    raise AssertionError(f"fused_group {name}: the per-"
                                         f"layer fused_conv chain differs")
                run = lambda: ops.fused_group_rollout(planes, members, **kw)
                ms = _device_ms(run, "fused_group_kernel")
                call_ms = _median_ms(run)
                plain_ms = _device_ms(
                    lambda: fused_group_rollout_torch(planes, members, **kw),
                    reps=3)
                chain_ms = _device_ms(per_layer)
                chain_kernel_ms = _device_ms(per_layer, "fused_conv_kernel")
                # each conv member's real input plane, from the plain chain
                ins, x, ch = [], planes, c_in
                for m in members:
                    if m[0] == "conv":
                        ins.append(packing.unpack_bool(x, m[1].c_in))
                        _, x = fused_conv_rollout_torch(
                            x, m[1], stride=1, padding="SAME",
                            threshold_q=m[2], **kw)
                        ch = m[1].c_out
                    else:
                        x = maxpool_packed(x, ch, m[1])
                x16 = [F.pad(i.reshape(t_steps * b, *i.shape[2:])
                             .permute(0, 3, 1, 2).to(torch.float16),
                             (1, 1, 1, 1)) for i in ins]
                w16 = [wf.permute(3, 2, 0, 1).to(dev, torch.float16)
                       for wf in wfs]
                lib_ms = _device_ms(
                    lambda: [F.conv2d(xi, wi) for xi, wi in zip(x16, w16)])
                ones = torch.ones((1, 1, 3, 3), device=dev)
                adds = sum(float(F.conv2d(xi.float().sum(1, keepdim=True),
                                          ones).sum()) * wi.shape[0]
                           for xi, wi in zip(x16, w16))
                convs = [m for m in members if m[0] == "conv"]
                nbytes = 4 * (planes.numel()
                              + sum(m[1].data.numel() + m[1].c_out
                                    for m in convs)
                              + pv.numel() + ps.numel())
                bound, t_b, t_o = _bound_ms(nbytes, adds)
                rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                  bound_ms=bound, bytes_ms=t_b, ops_ms=t_o,
                                  chain_ms=chain_ms)
                geoms = ops._chain_geoms(members, hw, hw)
                cl, tc, stage, ksplit, smem = ops._launch_plan(
                    geoms, t_steps, b)
                print(f"  fused_group {name:<9} launch: clusters of {cl} "
                      f"blocks, T chunk {tc}, codes staged for "
                      f"{sum(stage)} of {len(convs)} convs, K split "
                      f"{'on' if ksplit else 'off'}, {smem} B of shared "
                      f"memory a block", flush=True)
                print(f"  fused_group {name:<9} {hw}x{hw}x{c_in} {spec} "
                      f"w4: kernel {ms:.4f} ms (wrapper call {call_ms:.4f} "
                      f"ms wall) | plain {plain_ms:.4f} ms | per-layer "
                      f"fused_conv+pool chain {chain_ms:.4f} ms (its "
                      f"fused_conv kernels {chain_kernel_ms:.4f}) | fp16 "
                      f"conv2d of the members (accumulate only) "
                      f"{lib_ms:.4f} ms | bound {bound:.5f} ms (bytes "
                      f"{t_b:.5f}, adds {t_o:.5f}; {nbytes} B, {adds:.3e} "
                      f"adds) | out rate {rate:.3f}", flush=True)
    print(f"fused_group: {checks} checks bit-exact", flush=True)
    return rows, max_err


def nce_step_phase(dev, gen):
    """The NCE step path: spike_matmul and both lif_step entries against
    their plain versions, the unfused rollout (T steps of spike_matmul
    and the packed LIF entry) against the fused one and the plain one,
    all bit-exact; one profiled ``NeuronComputeEngine.step`` runs exactly
    those two kernels; then the main-path run (one unfused rollout per
    geometry at its main precision) with the launch counts, and each
    kernel's time, bound and yardsticks at those shapes, with the step's
    device and wall time beside the earlier step (the int32 entry, then
    ``pack_bool``)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.core.nce import NCEConfig, NeuronComputeEngine
    from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch
    from repro_torch.kernels.lif_step import ops as lif_ops
    from repro_torch.perfmodel.roofline import PEAK_FP32_FLOPS
    from repro_torch.kernels.lif_step.ref import lif_step_ref
    from repro_torch.kernels.spike_matmul import ops as sm_ops
    from repro_torch.kernels.spike_matmul.ref import spike_matmul_ref
    from repro_torch.quant.formats import PrecisionConfig

    # name: (T, B, d_in, d_out, widths, the width timed and counted or
    # None where no path runs the geometry)
    geoms = {"fc1": (4, 8, 4096, 512, (2, 4, 8), 4),
             "bench": (8, 64, 2048, 2048, (8, 2, 4), 8),
             "ragged": (4, 8, 1000, 100, (2, 4, 8), None)}
    checks, main = 0, {}
    for name, (t_steps, b, d_in, d_out, widths, main_bits) in geoms.items():
        s = torch.rand((t_steps, b, d_in), generator=gen) < 0.2
        sp = packing.pack_bool(s).to(dev)
        wf = (torch.randn((d_in, d_out), generator=gen) * 0.05).to(dev)
        for bits in widths:
            pc = PrecisionConfig(bits=bits)
            weights = NeuronComputeEngine.from_float(NCEConfig(precision=pc),
                                                     wf).weights
            codes = packing.unpack(weights.data, bits, d_in).float()
            # one threshold for the layer, at the expected current's spread
            theta = max(2, int(float(codes.std()) * (0.2 * d_in) ** 0.5))
            for soft in (True, False):
                eng = NeuronComputeEngine(
                    NCEConfig(precision=pc, threshold_q=theta,
                              soft_reset=soft), weights)
                label = f"NCE {name} w{bits} soft={soft}"
                ik = sm_ops.spike_matmul(sp[0], weights, d_in=d_in)
                ip = spike_matmul_ref(sp[0], weights, d_in=d_in)
                v = torch.randint(-2 * theta, 2 * theta, (b, d_out),
                                  generator=gen).to(torch.int32).to(dev)
                kw = dict(leak_shift=3, threshold_q=theta, v_reset_q=-3,
                          soft_reset=soft)
                lv, ls = lif_ops.lif_step(v, ik, **kw)
                kv, kwords = lif_ops.lif_step_packed(v, ik, **kw)
                pv, ps = lif_step_ref(v, ip, **kw)
                uv, us = eng.rollout_unfused(sp)
                fv, fs = eng.rollout(sp)
                qv, qs = fused_nce_rollout_torch(
                    sp, weights, d_in=d_in, leak_shift=3, threshold_q=theta,
                    soft_reset=soft)
                torch.cuda.synchronize()
                for what, a, c in (("spike_matmul", ik, ip),
                                   ("lif_step v", lv, pv),
                                   ("lif_step s", ls, ps),
                                   ("lif_step_packed v", kv, pv),
                                   ("lif_step_packed words", kwords,
                                    packing.pack_bool(ps)),
                                   ("unfused v vs fused", uv, fv),
                                   ("unfused s vs fused", us, fs),
                                   ("unfused v vs plain", uv, qv),
                                   ("unfused s vs plain", us, qs)):
                    if not torch.equal(a, c):
                        raise AssertionError(f"{label}: {what} differ")
                rate = float(packing.unpack_bool(us, d_out).float().mean())
                if not 0.0 < rate < 1.0 or not 0 < int(ls.sum()) < ls.numel():
                    raise AssertionError(f"{label}: vacuous output rates "
                                         f"{rate}, {float(ls.float().mean())}")
                checks += 1
                if bits == main_bits and soft:
                    main[name] = (eng, s, sp, rate)
    print(f"NCE step path: {checks} configurations bit-exact (spike_matmul, "
          f"lif_step int32 and packed entries, rollout_unfused == rollout == "
          f"plain) at fc1, bench and ragged (B=8, 1000->100)", flush=True)

    # one step on the card is two kernels: the product and the packed LIF
    for name, (eng, _, sp, _) in main.items():
        v0 = torch.zeros((sp.shape[1], eng.d_out), dtype=torch.int32,
                         device=dev)
        _only_kernels(lambda: eng.step(v0, sp[0]),
                      ["spike_matmul_kernel", "lif_step_packed_kernel"])
    print("NCE step: one profiled NeuronComputeEngine.step runs exactly two "
          "device kernels (spike_matmul_kernel, lif_step_packed_kernel) at "
          "fc1 and bench", flush=True)

    # the main path: NeuronComputeEngine.step over T, counts read around it
    sm_ops.spike_matmul.launches = lif_ops.lif_step.launches = 0
    for eng, _, sp, _ in main.values():
        eng.rollout_unfused(sp)
    torch.cuda.synchronize()
    launches = {"spike_matmul": sm_ops.spike_matmul.launches,
                "lif_step": lif_ops.lif_step.launches}
    want = sum(geoms[n][0] for n in main)
    if launches != {"spike_matmul": want, "lif_step": want}:
        raise AssertionError(f"NCE main path: launches {launches}, expected "
                             f"T = {want} of each over the rollouts")
    print(f"NCE main path (rollout_unfused, fc1 w4 + bench w8): launches "
          f"{launches}", flush=True)

    rows = {"spike_matmul": {}, "lif_step": {}}
    for name, (eng, s, sp, rate) in main.items():
        t_steps, b, d_in, d_out = geoms[name][:4]
        qt = eng.weights
        run = lambda: sm_ops.spike_matmul(sp[0], qt, d_in=d_in)
        _only_kernels(run, ["spike_matmul_kernel"])
        rb, split = sm_ops._launch_plan(b, sp.shape[-1], qt.bits,
                                        -(-d_out // 32) * 32)
        print(f"  spike_matmul {name:<5} launch: {-(-d_out // 32)} groups x "
              f"{-(-b // rb)} row chunks of {rb} x a {split}-block "
              f"cluster; one kernel a call", flush=True)
        ms = _device_ms(run, "spike_matmul_kernel")
        plain_ms = _device_ms(lambda: spike_matmul_ref(sp[0], qt, d_in=d_in),
                              reps=3)
        x16 = s[0].to(dev, torch.float16)
        w16 = packing.unpack(qt.data, qt.bits, d_in).T.to(torch.float16) \
            .contiguous()
        lib_ms = _device_ms(lambda: torch.matmul(x16, w16))
        adds = float(s[0].sum()) * d_out
        nbytes = 4 * (sp[0].numel() + qt.data.numel() + b * d_out)
        bound, t_b, t_o = _bound_ms(nbytes, adds)
        rows["spike_matmul"][name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bytes_ms=t_b, ops_ms=t_o)
        print(f"  spike_matmul {name:<5} m={b} {d_in}->{d_out} w{qt.bits}: "
              f"kernel {ms:.4f} ms (wrapper call {_median_ms(run):.4f} ms "
              f"wall) | plain {plain_ms:.4f} ms | fp16 matmul {lib_ms:.4f} "
              f"ms | bound {bound:.5f} ms (bytes {t_b:.5f}, adds {t_o:.5f}; "
              f"{nbytes} B, {adds:.3e} adds) | rollout out rate {rate:.3f}",
              flush=True)
        theta = eng.cfg.threshold_q
        v = torch.randint(-2 * theta, 2 * theta, (b, d_out),
                          generator=gen).to(torch.int32).to(dev)
        i = run()
        kw = dict(leak_shift=3, threshold_q=theta)
        packed = lambda: lif_ops.lif_step_packed(v, i, **kw)
        ms = _device_ms(packed, "lif_step_packed_kernel")
        int32_ms = _device_ms(lambda: lif_ops.lif_step(v, i, **kw),
                              "lif_step_kernel")
        plain_ms = _device_ms(
            lambda: packing.pack_bool(lif_step_ref(v, i, **kw)[1]), reps=3)
        words = -(-d_out // 32)
        # read v and i, write v' and the words
        nbytes = 12 * v.numel() + 4 * b * words
        # float32 outside the tensor cores stands in for the elementwise
        # int32 LIF step, for which the data sheet gives no rate
        bound, t_b, t_o = _bound_ms(nbytes, 5 * v.numel(), PEAK_FP32_FLOPS)
        int32_bound = _bound_ms(16 * v.numel(), 5 * v.numel(),
                                PEAK_FP32_FLOPS)[0]
        rows["lif_step"][name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
            bytes_ms=t_b, ops_ms=t_o, int32_ms=int32_ms)
        print(f"  lif_step {name:<5} ({b}, {d_out}): packed entry {ms:.4f} ms "
              f"(wrapper call {_median_ms(packed):.4f} ms wall) | int32 "
              f"entry {int32_ms:.4f} ms | plain (lif_step_ref + pack_bool) "
              f"{plain_ms:.4f} ms | bound {bound:.6f} ms ({nbytes} B; int32 "
              f"entry's {int32_bound:.6f})", flush=True)

        # the step, now and as it was (int32 entry, then pack_bool)
        v0 = torch.zeros((b, d_out), dtype=torch.int32, device=dev)
        step = lambda: eng.step(v0, sp[0])

        def step_before():
            ii = sm_ops.spike_matmul(sp[0], qt, d_in=d_in)
            vv, ss = lif_ops.lif_step(v0, ii, leak_shift=3,
                                      threshold_q=theta)
            return vv, packing.pack_bool(ss)

        if not all(torch.equal(a, c) for a, c in zip(step(), step_before())):
            raise AssertionError(f"NCE {name}: step differs from the int32 "
                                 f"entry + pack_bool step")
        for label, fn in (("step", step), ("earlier step", step_before)):
            dev_ms = _device_ms(fn)
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / 50
            rows["lif_step"][name][label.replace(" ", "_") + "_ms"] = dev_ms
            rows["lif_step"][name][label.replace(" ", "_") + "_wall_ms"] = \
                wall_ms
            print(f"  NCE {label:<12} {name:<5}: device {dev_ms:.4f} ms, wall "
                  f"{wall_ms:.4f} ms a step (50 steps, host clock)",
                  flush=True)
    return rows, launches


def pack_lm(params, bits, clip_search=True):
    """Every linear of the LM packed to ``bits`` with one scale per output
    row (the port's ``quantize`` on W.T, as NeuronComputeEngine.from_float
    packs): each ``{"w": ...}`` dict of a 2-D weight (attention, dense
    MLP, SSM in/out projections, ``vision_proj``, whisper's attention,
    cross-attention and MLP) and MoE's shared experts, all of which go
    through ``layers.linear``; the stacked experts, router, conv taps,
    norms, embeddings and an untied ``lm_head`` stay dense.  The dense
    weights are dropped as each is packed.  ``clip_search=False`` keeps
    each row's absmax scale, the grid QAT's fake-quant trains against
    (the search moves a W2/W4 row's clip to its MSE optimum).  Returns
    ``params``."""
    import torch

    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize

    pc = PrecisionConfig(bits=bits, group_size=-1, clip_search=clip_search)

    def walk(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for key, v in list(items):
            if key == "lm_head":
                continue
            if isinstance(v, dict) and torch.is_tensor(v.get("w")) \
                    and v["w"].ndim == 2:
                v["w"] = quantize(v["w"].T.float(), pc)
            elif isinstance(v, (dict, list)):
                walk(v)
            elif isinstance(key, str) and key.startswith("shared_w"):
                tree[key] = quantize(v.T.float(), pc)

    walk(params)
    return params


@contextlib.contextmanager
def plain_kernels(dtype=None):
    """Route the LM's two kernel wrappers to their plain versions: the
    model code is unchanged and calls them through their modules.  The
    plain qmatmul keeps each tensor's dequantized float32 weight (what
    ``dequant_w`` returns every call, computed once: 4.3 GB for olmo-1b)
    so the teacher-forced runs do not unpack 537 MB of codes per step.
    ``dtype=torch.float64`` sums the packed matmuls in float64 instead:
    the difference between that run and the float32 one is the noise a
    change of summation alone makes, the floor any kernel is held to."""
    import torch

    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.kernels.kv_attention import ref as kv_ref
    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
    from repro_torch.kernels.packed_qmatmul import ref as qmm_ref

    dtype = dtype or torch.float32
    dense = {}

    def qmatmul(x, qt):
        w = dense.get(id(qt))
        if w is None:
            w = dense[id(qt)] = qmm_ref.dequant_w(qt).to(dtype)
        return torch.matmul(x.to(dtype), w.T).to(x.dtype)

    saved = (qmm_ops.qmatmul, kv_ops.quant_kv_decode_attention)
    qmm_ops.qmatmul = qmatmul
    kv_ops.quant_kv_decode_attention = kv_ref.quant_kv_decode_attention_ref
    try:
        yield
    finally:
        qmm_ops.qmatmul, kv_ops.quant_kv_decode_attention = saved


def _pad_cache(cache, max_len):
    """The K/V entries of a prefill cache padded to ``max_len`` positions;
    an SSM layer's conv inputs and state and whisper's cross cache have
    no length and stay as they are."""
    import torch.nn.functional as F

    out = dict(cache)
    for k in ("k", "v", "k_scale", "v_scale"):
        if k in cache:
            v = cache[k]
            out[k] = F.pad(v, (0, 0) * (v.ndim - 3) +
                           (0, max_len - v.shape[2]))
    return out


class LogitCheck:
    """Kernel-path logits against the plain path's, step by step: the
    relative RMS error (over the vocabulary) and the max |error| over the
    plain logits' largest magnitude must stay within ``rms`` and ``mx``.

    Both paths are bf16 models.  Their packed matmuls sum in other orders,
    a bf16 output then sometimes rounds to its neighbour (2^-8 relative),
    and that noise grows through 16 layers; with a packed KV cache it
    also flips INT4 codes (a whole code step) wherever a K or V value sits
    near a rounding boundary.  The limits are stated per phase; beside
    each, the same check of a float64-summed plain run against the
    float32 one shows the floor that summation order alone makes.  A
    wrong kernel is off by ~1."""

    def __init__(self, label, rms, mx):
        self.label, self.lim_rms, self.lim_max = label, rms, mx
        self.rms, self.max, self.agree, self.n = 0., 0., 0, 0

    def add(self, got, ref, where):
        import numpy as np

        got = np.asarray(got, np.float64)
        ref = np.asarray(ref, np.float64)
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"{self.label} {where}: bad logits "
                                 f"{got.shape}")
        d = got - ref
        rms = float(np.sqrt((d ** 2).mean() / (ref ** 2).mean()))
        mx = float(np.abs(d).max() / np.abs(ref).max())
        if self.lim_rms is not None and (rms > self.lim_rms
                                         or mx > self.lim_max):
            raise AssertionError(
                f"{self.label} {where}: logits off the plain path's by "
                f"relative RMS {rms:.4f} (limit {self.lim_rms}), max "
                f"{mx:.4f} (limit {self.lim_max})")
        self.rms, self.max = max(self.rms, rms), max(self.max, mx)
        self.agree += int(np.argmax(got) == np.argmax(ref))
        self.n += 1

    def summary(self):
        within = ("" if self.lim_rms is None else
                  f" within tolerance (relative RMS <= {self.lim_rms}, max "
                  f"<= {self.lim_max})")
        return (f"{self.n} logit vectors{within} of the plain path "
                f"(worst relative RMS {self.rms:.4f}, worst max "
                f"{self.max:.4f}); greedy-token agreement "
                f"{self.agree}/{self.n} ({100 * self.agree / self.n:.1f}%)")


def serve_prompts(cfg):
    """The 16 prompts of the bf16-KV serve phase: 16-256 tokens, seed 0."""
    import numpy as np

    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(16):
        plen = int(rng.integers(16, 257))
        prompts.append(rng.integers(0, cfg.vocab, plen).astype(np.int32))
    return prompts


def lm_serve_phase(dev, cfg, params):
    """olmo-1b W4 served by the engine (bf16 KV): 16 requests, counts of
    packed_qmatmul launches (each prefill's counted apart, by the variant
    its prompt length selects), throughput, latency, and every request's
    logits against a teacher-forced plain-path re-run.  Returns the
    launches, the prefills' share of them and the end-to-end metrics."""
    import numpy as np
    import torch

    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
    from repro_torch.models import transformer
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(slots=8, max_len=1024,
                                                keep_logits=True),
                      device=dev)
    eng.add_request(Request(uid=-1, prompt=np.arange(16, dtype=np.int32),
                            max_new_tokens=2))      # warm-up, not counted
    eng.run_until_done()
    eng.done.clear()
    reqs = [Request(uid=uid, prompt=p, max_new_tokens=32)
            for uid, p in enumerate(serve_prompts(cfg))]

    class CountedPrefill:
        """The engine's model, with the packed_qmatmul launches of each
        prefill counted by the variant its M (the prompt length; bf16 x,
        per-row scales) selects."""

        def __init__(self, mb):
            self.mb = mb
            self.launches = {"gemv": 0, "mma": 0}
            self.prompts = {"gemv": 0, "mma": 0}

        def __getattr__(self, name):
            return getattr(self.mb, name)

        def prefill(self, params_, batch):
            n0 = qmm_ops.qmatmul.launches
            out = self.mb.prefill(params_, batch)
            variant = qmm_ops._variant(batch["tokens"].numel(),
                                       torch.bfloat16, -1)
            self.launches[variant] += qmm_ops.qmatmul.launches - n0
            self.prompts[variant] += 1
            return out

    eng.mb = counted = CountedPrefill(eng.mb)
    per_fwd = 7 * cfg.n_layers
    qmm_ops.qmatmul.launches = 0
    kv_ops.quant_kv_decode_attention.launches = 0
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"packed_qmatmul": qmm_ops.qmatmul.launches,
                "kv_attention": kv_ops.quant_kv_decode_attention.launches}
    steps = stats["decode_steps"]
    want = {"packed_qmatmul": per_fwd * (len(reqs) + steps),
            "kv_attention": 0}
    if launches != want or stats["incomplete"] or stats["requests"] != 16:
        raise AssertionError(f"olmo serve: launches {launches} (expected "
                             f"{want}: {per_fwd} per prefill and per decode "
                             f"step), stats {stats}")
    if any(counted.launches[v] != per_fwd * counted.prompts[v]
           for v in counted.launches):
        raise AssertionError(f"olmo serve prefills: launches "
                             f"{counted.launches} for prompts "
                             f"{counted.prompts}, expected {per_fwd} each")
    n_qmm = launches["packed_qmatmul"]
    lat = sorted(r.latency_s * 1e3 for r in reqs)
    p50 = float(np.percentile(lat, 50))
    p95 = float(np.percentile(lat, 95))
    print(f"olmo-1b W4 serve (bf16 KV, slots=8, max_len=1024): 16 requests, "
          f"prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, "
          f"{stats['generated_tokens']} tokens in {steps} decode steps: "
          f"{stats['generated_tokens'] / wall:.1f} tokens/s end to end "
          f"({wall * 1e3:.1f} ms wall), request latency p50 {p50:.1f} ms, "
          f"p95 {p95:.1f} ms; packed_qmatmul launches {n_qmm}: prefills "
          f"gemv {counted.launches['gemv']} ({counted.prompts['gemv']} "
          f"prompts) + mma {counted.launches['mma']} "
          f"({counted.prompts['mma']} prompts), decode "
          f"{(n_qmm - sum(counted.launches.values())) / steps:.0f} per "
          f"step x {steps}", flush=True)

    def teacher_forced(dtype=None):
        """Each request re-run alone through the plain path, fed the
        engine's tokens: its logits at every sampled position."""
        out = []
        with plain_kernels(dtype):
            for r in reqs:
                toks = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                                       device=dev)
                logits, cache = transformer.prefill(params, cfg, toks)
                seq = [logits[0].cpu().numpy()]
                cache = _pad_cache(cache, len(r.prompt) + len(r.output))
                for t in range(1, len(r.output)):
                    tok = torch.tensor([[r.output[t - 1]]],
                                       dtype=torch.int64, device=dev)
                    logits, cache = transformer.decode_step(params, cfg,
                                                            cache, tok)
                    seq.append(logits[0].cpu().numpy())
                out.append(seq)
        return out

    check = LogitCheck("olmo serve", 0.10, 0.15)
    floor = LogitCheck("olmo serve float64 plain", None, None)
    for r, ref, ref64 in zip(reqs, teacher_forced(),
                             teacher_forced(torch.float64)):
        for t, (got, want, want64) in enumerate(zip(r.logits, ref, ref64)):
            check.add(got, want, f"request {r.uid} position {t}")
            floor.add(want64, want, f"request {r.uid} position {t}")
    print(f"olmo serve teacher-forced on the plain path: {check.summary()}",
          flush=True)
    print(f"  floor, the float64-summed plain path against the float32 one: "
          f"{floor.summary()}", flush=True)
    toks = torch.as_tensor(eng.last_token[:, None], dtype=torch.int64,
                           device=dev)
    print("olmo-1b decode step, 8 ragged slots, bf16 KV:", flush=True)
    profile_calls(lambda: transformer.decode_step(params, cfg, eng.cache,
                                                  toks, ragged=True),
                  "decode step")
    prefill = {"packed_qmatmul": sum(counted.launches.values())}
    return launches, prefill, dict(
        tokens_per_s=stats["generated_tokens"] / wall, p50_ms=p50,
        p95_ms=p95)


def lm_int4_kv_phase(dev, cfg, params):
    """olmo-1b W4 with an INT4 KV cache: a uniform batch of 8 x 512-token
    prompts, prefill padded to 1024, 32 uniform decode steps; launch
    counts, throughput, and the logits against the plain path."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
    from repro_torch.models import transformer

    cfg4 = dataclasses.replace(cfg, kv_cache_bits=4)
    b, s_len, max_len, n_steps = 8, 512, 1024, 32
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, s_len)), dtype=torch.int64, device=dev)

    prefill_launches = []

    def run(feed=None):
        """Prefill, pad, n_steps uniform decode steps (greedy, or fed the
        tokens ``feed``).  Returns the logits at each step, the tokens
        fed, the decode seconds, the prefill cache and the final cache."""
        # (the plain versions that plain_kernels swaps in count nothing)
        count = lambda: getattr(qmm_ops.qmatmul, "launches", 0)
        n0 = count()
        logits, pre = transformer.prefill(params, cfg4, toks)
        prefill_launches.append(count() - n0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = _pad_cache(pre, max_len)
        out, fed = [logits.cpu().numpy()], []
        for i in range(n_steps):
            tok = (torch.argmax(logits, -1) if feed is None
                   else feed[i]).reshape(b, 1)
            fed.append(tok)
            logits, cache = transformer.decode_step(params, cfg4, cache, tok)
            out.append(logits.cpu().numpy())
        torch.cuda.synchronize()
        return out, fed, time.perf_counter() - t1, pre, cache

    run()                                              # warm-up
    per_fwd = 7 * cfg.n_layers
    qmm_ops.qmatmul.launches = 0
    kv_ops.quant_kv_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, fed, decode_s, pre, cache = run()
    wall = time.perf_counter() - t0
    launches = {"packed_qmatmul": qmm_ops.qmatmul.launches,
                "kv_attention": kv_ops.quant_kv_decode_attention.launches}
    prefill = {"packed_qmatmul": prefill_launches[-1]}
    want = {"packed_qmatmul": per_fwd * (1 + n_steps),
            "kv_attention": cfg.n_layers * n_steps}
    if launches != want or prefill["packed_qmatmul"] != per_fwd:
        raise AssertionError(f"olmo INT4 KV: launches {launches} (prefill "
                             f"{prefill}), expected {want} ({per_fwd} in "
                             f"the prefill)")
    print(f"olmo-1b W4 + INT4 KV, uniform batch {b} x {s_len} prompt, "
          f"{n_steps} decode steps: prefill {(wall - decode_s) * 1e3:.1f} "
          f"ms, decode {decode_s / n_steps * 1e3:.2f} ms/step "
          f"({b * n_steps / decode_s:.1f} tokens/s); launches {launches} "
          f"(prefill {prefill['packed_qmatmul']} packed_qmatmul; "
          f"{launches['kv_attention'] // n_steps} kv_attention per step)",
          flush=True)
    with plain_kernels():
        ref, _, _, ref_pre, _ = run(feed=fed)
    with plain_kernels(torch.float64):
        ref64, _, _, _, _ = run(feed=fed)
    flips = {k: float((pre[k] != ref_pre[k]).float().mean())
             for k in ("k", "v")}
    # INT4 codes flip where the two paths' bf16 K/V straddle a rounding
    # boundary, so the limits are wider than with the bf16 cache
    check = LogitCheck("olmo INT4 KV", 0.25, 0.30)
    floor = LogitCheck("olmo INT4 KV float64 plain", None, None)
    for i, (g, r, r64) in enumerate(zip(got, ref, ref64)):
        for row in range(b):
            check.add(g[row], r[row], f"step {i} row {row}")
            floor.add(r64[row], r[row], f"step {i} row {row}")
    print(f"olmo INT4 KV teacher-forced on the plain path: "
          f"{check.summary()}; packed KV words after prefill that differ "
          f"from the plain path's: K {100 * flips['k']:.2f}%, V "
          f"{100 * flips['v']:.2f}%", flush=True)
    print(f"  floor, the float64-summed plain path against the float32 one: "
          f"{floor.summary()}", flush=True)
    tok = fed[-1]
    print("olmo-1b decode step, uniform batch 8, INT4 KV:", flush=True)
    profile_calls(lambda: transformer.decode_step(params, cfg4, cache, tok),
                  "decode step")
    return launches, prefill, dict(
        decode_tokens_per_s=b * n_steps / decode_s)


class LayerLinears:
    """A model's packed linears, one list a layer: ``check`` holds them
    against the plain version at M rows of bf16 x, ``at`` also times them
    cold: each timed call takes the next layer's weights, so the data
    comes from HBM as on the served path.  ``library_ms`` is bf16
    ``torch.matmul`` on the dequantized weights."""

    def __init__(self, dev, gen, layers):
        import itertools

        self.dev, self.gen, self.layers = dev, gen, layers
        self.order = itertools.cycle(range(len(layers)))
        self.dense = None          # the dequantized weights, made by ``at``

    def check(self, m, check_all=False):
        """Every linear of every layer (or of layer 0) at M=m against the
        plain version, at the CUDA test's tolerance: a bf16 ulp + 1e-4 of
        the scale.  Returns (x a linear, the variants, max |err|)."""
        import torch

        from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
        from repro_torch.kernels.packed_qmatmul import ref as qmm_ref

        layers = self.layers
        xs = [torch.randn((m, qt.shape[1]), generator=self.gen,
                          device=self.dev, dtype=torch.bfloat16)
              for qt in layers[0]]
        variants = sorted({
            qmm_ops._variant(m, x.dtype, qt.group_size) +
            ("" if m < qmm_ops.MMA_MIN_M else " %dx%d" % qmm_ops._mma_tile(
                m, qt.shape[0], qt.n_groups > 1))
            for x, qt in zip(xs, layers[0])})
        err = 0.0
        for qts in (layers if check_all else layers[:1]):
            for x, qt in zip(xs, qts):
                got = qmm_ops.qmatmul(x, qt).float()
                ref = qmm_ref.qmatmul_ref(x, qt).float()
                bad = float(((got - ref).abs() - 2.0 ** -7 * ref.abs()).max())
                if bad > 1e-4 * float(ref.abs().max()):
                    raise AssertionError(f"packed_qmatmul m={m} {qt.shape}: "
                                         f"off the plain version")
                err = max(err, float((got - ref).abs().max()))
        return xs, variants, err

    def at(self, m, check_all=False):
        """One layer's linears at M=m: checked (``check``), then timed
        cold.  Returns (row, max |err|, the timed call, bytes)."""
        import torch

        from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
        from repro_torch.kernels.packed_qmatmul import ref as qmm_ref
        from repro_torch.perfmodel.roofline import PEAK_FLOPS

        layers, order = self.layers, self.order
        xs, variants, err = self.check(m, check_all)
        run = lambda: [qmm_ops.qmatmul(x, qt)
                       for x, qt in zip(xs, layers[next(order)])]
        # both variants' kernels are named qmatmul_<variant>_kernel
        r = dict(ms=_device_ms(run, "qmatmul_", per_call=len(xs)))
        r["plain_ms"] = _device_ms(
            lambda: [qmm_ref.qmatmul_ref(x, qt)
                     for x, qt in zip(xs, layers[next(order)])], reps=3)
        if self.dense is None:
            self.dense = [[qmm_ref.dequant_w(qt).T.to(torch.bfloat16)
                           .contiguous() for qt in qts] for qts in layers]
        r["library_ms"] = _device_ms(lambda: [
            torch.matmul(x, w) for x, w in zip(xs, self.dense[next(order)])])
        nbytes = sum(4 * (qt.data.numel() + qt.scale.numel())
                     + 2 * m * (qt.shape[0] + qt.shape[1])
                     for qt in layers[0])
        flops = sum(2 * m * qt.shape[0] * qt.shape[1] for qt in layers[0])
        r["bound_ms"], r["bytes_ms"], r["ops_ms"] = _bound_ms(
            nbytes, flops, PEAK_FLOPS)
        r["variant"] = ", ".join(variants)
        return r, err, run, nbytes


def lm_kernel_phase(dev, cfg, params):
    """packed_qmatmul and kv_attention against their plain versions and
    timed at the served path's shapes: the 7 linears of one layer at M=8
    (a decode step), at each prompt length of the bf16-KV serve phase
    (its prefills; summed by the variant each selects), at M=256 (a
    fixed prefill geometry, kept to compare kernel versions) and at
    M=4096 (the INT4-KV phase's 8 x 512 prefill), bf16 x; and one
    kv_attention call over an INT4 cache like the uniform-batch phase's
    (8 x 544 live keys of 1024), with a sliding window and a logit cap
    checked beside.  As on
    the served path, the data is cold: each timed call takes the next
    layer's weights (33.6 MB a layer, 537 MB in all) or the next of 8
    caches (144 MB), more than the 50 MB L2 holds."""
    import torch

    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops

    gen = torch.Generator(device=dev).manual_seed(2)
    layers = [[lin["w"] for blk in ("attn", "mlp") for lin in lp[blk].values()]
              for lp in params["layers"]]
    linears = LayerLinears(dev, gen, layers)

    rows, errs = {"packed_qmatmul": {}}, {"packed_qmatmul": 0.0}
    for m, geo in ((8, "decode layer"), (256, "prefill layer m256"),
                   (4096, "prefill layer m4096")):
        r, err, run, nbytes = linears.at(m, check_all=m == 8)
        checked = f"all {len(layers)} layers" if m == 8 else "layer 0"
        print(f"  packed_qmatmul layer (7 linears) m={m} w4 bf16, cold, "
              f"variant {r['variant']}: kernel {r['ms']:.4f} ms (wrapper "
              f"calls {_median_ms(run):.4f} ms wall) | plain "
              f"{r['plain_ms']:.4f} ms | bf16 matmul on dequantized weights "
              f"{r['library_ms']:.4f} ms | bound {r['bound_ms']:.5f} ms "
              f"(bytes {r['bytes_ms']:.5f}, flops {r['ops_ms']:.5f}; "
              f"{nbytes} B) | max |err| {err:.3e} ({checked})", flush=True)
        rows["packed_qmatmul"][geo] = r
        errs["packed_qmatmul"] = max(errs["packed_qmatmul"], err)
    # the serve phase's prefills: one layer at each of its prompt lengths,
    # summed by variant
    by_variant = {}
    for m in sorted(len(p) for p in serve_prompts(cfg)):
        r, err, _, _ = linears.at(m)
        print(f"  packed_qmatmul layer m={m} (a serve prefill), variant "
              f"{r['variant']}: kernel {r['ms']:.4f} ms | plain "
              f"{r['plain_ms']:.4f} ms | library {r['library_ms']:.4f} ms | "
              f"bound {r['bound_ms']:.5f} ms", flush=True)
        errs["packed_qmatmul"] = max(errs["packed_qmatmul"], err)
        kind = qmm_ops._variant(m, torch.bfloat16, -1)
        acc = by_variant.setdefault(kind, dict(
            ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
            ops_ms=0.0, lens=[], variants=set()))
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms",
                  "ops_ms"):
            acc[k] += r[k]
        acc["lens"].append(m)
        acc["variants"].update(r["variant"].split(", "))
    for kind in ("gemv", "mma"):
        acc = by_variant.get(kind)
        if acc is None:
            raise AssertionError(f"no serve prompt selects {kind}: the "
                                 f"serve prefills no longer cover both "
                                 f"variants")
        lens, variants = acc.pop("lens"), acc.pop("variants")
        acc["variant"] = (f"{', '.join(sorted(variants))}; {len(lens)} "
                          f"prompts of {lens[0]}-{lens[-1]} tokens")
        rows["packed_qmatmul"][f"serve prefills {kind}"] = acc
        print(f"  packed_qmatmul serve prefills, {kind}: {acc['variant']}: "
              f"kernel {acc['ms']:.4f} ms per layer, summed over the "
              f"prompts | plain {acc['plain_ms']:.4f} | library "
              f"{acc['library_ms']:.4f} | bound {acc['bound_ms']:.5f}",
              flush=True)
    del linears

    rows["kv_attention"], errs["kv_attention"] = {}, 0.0
    r, errs["kv_attention"] = kv_row(
        dev, gen, "olmo-1b", b=8, s_len=1024, live=544, h=cfg.n_heads,
        kh=cfg.n_kv, hd=cfg.head_dim, checks=((256, None), (0, 50.0),
                                              (256, 50.0)))
    rows["kv_attention"]["decode"] = r
    return rows, errs


def kv_row(dev, gen, label, *, b, s_len, live, h, kh, hd, window=0,
           checks=()):
    """``kv_attention`` over an INT4 cache of B x s_len positions, ``live``
    of them filled, at the served ``window``: held against the plain
    version (also at each (window, logit cap) of ``checks``) and timed
    cold (each call takes the next of 8 caches).  ``library_ms`` is SDPA
    on the dequantized bf16 cache, its KV heads repeated to the query
    heads and the window as a mask.  The bound counts the keys the
    window leaves.  Returns (row, max |err|)."""
    import itertools

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.kernels.kv_attention import ref as kv_ref
    from repro_torch.perfmodel.roofline import PEAK_FLOPS

    bits = 4
    q = torch.randn((b, 1, h, hd), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    caches = []
    for _ in range(8):
        k = torch.randn((b, s_len, kh, hd), generator=gen, device=dev)
        v = torch.randn((b, s_len, kh, hd), generator=gen, device=dev)
        caches.append(kv_ref.quantize_kv(k, bits) + kv_ref.quantize_kv(v, bits))
    kp, ks, vp, vs = caches[0]
    err = 0.0
    for win, cap in ((window, None),) + tuple(checks):
        kw = dict(bits=bits, scale=hd ** -0.5, cache_len=live, window=win,
                  logit_cap=cap)
        got = kv_ops.quant_kv_decode_attention(q, kp, ks, vp, vs, **kw)
        ref = kv_ref.quant_kv_decode_attention_ref(q, kp, ks, vp, vs, **kw)
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=2e-2)
        if (win, cap) == (window, None):
            err = float((got.float() - ref.float()).abs().max())
    kw = dict(bits=bits, scale=hd ** -0.5, cache_len=live, window=window)
    order = itertools.cycle(range(len(caches)))
    run = lambda: kv_ops.quant_kv_decode_attention(
        q, *caches[next(order)], **kw)
    ms = _device_ms(run, "kv_attention_kernel", per_call=1)
    plain_ms = _device_ms(lambda: kv_ref.quant_kv_decode_attention_ref(
        q, *caches[next(order)], **kw), reps=3)
    dense = [[kv_ref.dequantize_kv(p[:, :live], sc[:, :live], bits, hd)
              .transpose(1, 2).repeat_interleave(h // kh, dim=1)
              .contiguous() for p, sc in ((c[0], c[1]), (c[2], c[3]))]
             for c in caches]
    keys = min(live, window) if window else live
    mask = None
    if keys < live:
        mask = (torch.arange(live, device=dev) >= live - keys)[None, None,
                                                               None]
    qd = q.transpose(1, 2).contiguous()
    lib_ms = _device_ms(lambda: F.scaled_dot_product_attention(
        qd, *dense[next(order)], attn_mask=mask, scale=hd ** -0.5))
    nbytes = (b * keys * kh * (2 * kp.shape[-1] * 4 + 2 * 4)
              + 2 * q.numel() * 2)
    flops = 4 * b * h * keys * hd
    bound, t_b, t_o = _bound_ms(nbytes, flops, PEAK_FLOPS)
    print(f"  kv_attention {label} B={b} H={h} K={kh} hd={hd} int4, {live} "
          f"of {s_len} keys live, window {window or 'none'}, cold: kernel "
          f"{ms:.4f} ms (wrapper call {_median_ms(run):.4f} ms wall) | plain "
          f"{plain_ms:.4f} ms | sdpa on the dequantized bf16 cache "
          f"{lib_ms:.4f} ms | bound {bound:.5f} ms (bytes {t_b:.5f}, flops "
          f"{t_o:.6f}; {nbytes} B) | max |err| {err:.3e}"
          + (f"; (window, logit cap) {list(checks)} within tolerance"
             if checks else ""), flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bytes_ms=t_b, ops_ms=t_o), err


def _lm_counters():
    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops

    return {"packed_qmatmul": qmm_ops.qmatmul,
            "kv_attention": kv_ops.quant_kv_decode_attention}


def _lm_launches():
    """The two LM kernels' launch counts (the plain versions that
    ``plain_kernels`` swaps in count nothing)."""
    return {k: getattr(f, "launches", 0) for k, f in _lm_counters().items()}


def _zero_lm_launches():
    for f in _lm_counters().values():
        f.launches = 0


@contextlib.contextmanager
def routing_log(replay=None):
    """Record the top-k experts (a ``(..., k)`` index tensor on the card)
    of every MoE router call, in call order.  With ``replay``, such a log
    of another run, each call takes the recorded call's experts instead
    of its own: the gates are this run's router probabilities at those
    experts, renormalized as ``moe._router`` does, so two runs that sum
    in other orders still run the same experts on every token.  The log
    then holds the run's own choices; the shapes and the number of calls
    must match the replayed run's."""
    import torch

    from repro_torch.models import moe

    log, orig = [], moe._router
    calls = None if replay is None else iter(replay)

    def routed(p, x, cfg):
        gates, idx, aux = orig(p, x, cfg)
        log.append(idx)
        if calls is None:
            return gates, idx, aux
        want = next(calls, None)
        if want is None or want.shape != idx.shape:
            theirs = None if want is None else tuple(want.shape)
            raise AssertionError(f"router call {len(log)}: "
                                 f"{tuple(idx.shape)} routings, the "
                                 f"replayed run's {theirs}")
        probs = torch.softmax(x.to(torch.float32) @ p["router"], dim=-1)
        gates = torch.gather(probs, -1, want)
        gates = gates / torch.clamp_min(torch.sum(gates, -1, keepdim=True),
                                        1e-9)
        return gates, want, aux

    moe._router = routed
    try:
        yield log
    finally:
        moe._router = orig
    if replay is not None and len(log) != len(replay):
        raise AssertionError(f"{len(log)} router calls, the replayed run "
                             f"made {len(replay)}")


def routing_flips(own, replayed):
    """The (token, layer) routings of a replaying run whose own top-k set
    differs from the replayed one's, and the routings in all."""
    import torch

    flips = sum(int((torch.sort(a, -1).values != torch.sort(b, -1).values)
                    .any(-1).sum()) for a, b in zip(own, replayed))
    return flips, sum(a.numel() // a.shape[-1] for a in own)


class PrefillLaunches:
    """An engine's model with the LM kernels' launches in its prefills
    counted apart."""

    def __init__(self, mb):
        self.mb = mb
        self.launches = {k: 0 for k in _lm_counters()}
        self.prompts = 0

    def __getattr__(self, name):
        return getattr(self.mb, name)

    def prefill(self, params_, batch):
        n0 = _lm_launches()
        out = self.mb.prefill(params_, batch)
        for k, n in _lm_launches().items():
            self.launches[k] += n - n0[k]
        self.prompts += 1
        return out


def _layer_linears(lp):
    """A layer's packed linears in tree order."""
    from repro_torch.quant.formats import QuantizedTensor

    out = []
    for v in lp.values():
        if isinstance(v, QuantizedTensor):
            out.append(v)
        elif isinstance(v, dict):
            out += _layer_linears(v)
    return out


def forced_engine(params, cfg, reqs, dev, dtype=None, routes=()):
    """``reqs`` served again by a ``ServeEngine`` like the one that served
    them (8 slots, so all are admitted at once and decode in the same
    ragged batches), each fed the tokens it was given, through the plain
    versions (``plain_kernels(dtype)``), each MoE router call taking the
    experts of the served run's (``routes``, ``routing_log``).  Returns
    the logits at every sampled position and the run's own routing
    log."""
    import numpy as np

    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    class Forced(ServeEngine):
        admitted = 0

        def _sample(self, logits):
            if logits.shape[0] == 1:           # a prefill, in queue order
                self.admitted += 1
                return np.array([reqs[self.admitted - 1].output[0]])
            return np.array([0 if r is None else
                             tokens[r.uid][self.slot_pos[i]]
                             for i, r in enumerate(self.slot_req)])

    tokens = {r.uid: r.output for r in reqs}
    eng = Forced(cfg, params, EngineConfig(slots=len(reqs), max_len=1024,
                                           keep_logits=True), device=dev)
    for r in reqs:
        eng.add_request(Request(uid=r.uid, prompt=r.prompt,
                                max_new_tokens=len(r.output)))
    with plain_kernels(dtype), routing_log(routes) as own:
        eng.run_until_done()
    if any(eng.done[r.uid].output != r.output for r in reqs):
        raise AssertionError("forced engine run left the given tokens")
    return [eng.done[r.uid].logits for r in reqs], own


def family_serve_run(dev, card, name, cfg, params, per_fwd):
    """``ServeEngine(slots=8, max_len=1024)``, bf16 KV: 8 requests of
    ``serve_prompts`` (16-256 tokens; one SSM chunk), 16 new tokens each.
    ``per_fwd`` ``packed_qmatmul`` launches a prefill and a decode step
    and no ``kv_attention``, asserted; tokens/s, p50 / p95; every logit
    vector held against the same requests re-served on the plain path,
    fed the same tokens and, for MoE, routed to the same experts
    (``forced_engine``): a change of summation order flips the top-k set
    of a router's near ties, and a token sent to other experts is off by
    as much as a wrong kernel.  The limits are 0.10 / 0.15 relative
    RMS / max.  Returns (decode launches, prefill launches, metrics)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    eng = ServeEngine(cfg, params, EngineConfig(slots=8, max_len=1024,
                                                keep_logits=True),
                      device=dev)
    eng.add_request(Request(uid=-1, prompt=np.arange(16, dtype=np.int32),
                            max_new_tokens=2))      # warm-up, not counted
    eng.run_until_done()
    eng.done.clear()
    reqs = [Request(uid=uid, prompt=p, max_new_tokens=16)
            for uid, p in enumerate(serve_prompts(cfg)[:8])]
    eng.mb = counted = PrefillLaunches(eng.mb)
    _zero_lm_launches()
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routing_log() as routes:
        stats = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _lm_launches()
    steps = stats["decode_steps"]
    want = {"packed_qmatmul": per_fwd * (len(reqs) + steps),
            "kv_attention": 0}
    want_pre = {"packed_qmatmul": per_fwd * len(reqs), "kv_attention": 0}
    if (launches != want or counted.launches != want_pre
            or stats["incomplete"] or stats["requests"] != len(reqs)):
        raise AssertionError(f"{name} serve: launches {launches} (prefills "
                             f"{counted.launches}), expected {want} "
                             f"({per_fwd} a prefill and a decode step), "
                             f"stats {stats}")
    lat = sorted(r.latency_s * 1e3 for r in reqs)
    p50 = float(np.percentile(lat, 50))
    p95 = float(np.percentile(lat, 95))
    tps = stats["generated_tokens"] / wall
    print(f"{name} W4 serve (bf16 KV, slots=8, max_len=1024; {card}): "
          f"{len(reqs)} requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens, "
          f"{stats['generated_tokens']} tokens in {steps} decode steps: "
          f"{tps:.1f} tokens/s end to end ({wall * 1e3:.1f} ms wall), "
          f"request latency p50 {p50:.1f} ms, p95 {p95:.1f} ms; launches "
          f"{launches} ({per_fwd} packed_qmatmul a prefill x {len(reqs)} "
          f"+ a decode step x {steps})", flush=True)

    ref, own = forced_engine(params, cfg, reqs, dev, routes=routes)
    ref64, own64 = forced_engine(params, cfg, reqs, dev, torch.float64,
                                 routes)
    check = LogitCheck(f"{name} serve", 0.10, 0.15)
    floor = LogitCheck(f"{name} float64 plain", None, None)
    for r, want, want64 in zip(reqs, ref, ref64):
        for t, (got, w, w64) in enumerate(zip(r.logits, want, want64)):
            check.add(got, w, f"request {r.uid} position {t}")
            floor.add(w64, w, f"request {r.uid} position {t}")
    print(f"{name} serve, the same tokens fed on the plain path"
          f"{', routed to the same experts' if routes else ''}: "
          f"{check.summary()}", flush=True)
    print(f"  floor, the float64-summed plain path against the float32 one: "
          f"{floor.summary()}", flush=True)
    if routes:
        flips, total = routing_flips(own, routes)
        flips64, _ = routing_flips(own64, routes)
        print(f"  routing: {total} (token, layer) routings replayed; the "
              f"plain path's own router would have picked another "
              f"top-{cfg.moe.top_k} set in {flips} ({100 * flips / total:.3f}"
              f"%), the float64-summed one in {flips64} "
              f"({100 * flips64 / total:.3f}%)", flush=True)
    toks = torch.as_tensor(eng.last_token[:, None], dtype=torch.int64,
                           device=dev)
    print(f"{name} decode step, 8 ragged slots, bf16 KV:", flush=True)
    profile_calls(lambda: transformer.decode_step(params, cfg, eng.cache,
                                                  toks, ragged=True),
                  "decode step")
    decode = {k: launches[k] - want_pre[k] for k in launches}
    return decode, want_pre, dict(tokens_per_s=tps, p50_ms=p50, p95_ms=p95,
                                  rms=check.rms, max=check.max)


def family_uniform_run(dev, card, name, prefill, decode, *, b, max_len,
                       n_steps, per_prefill, per_step, limits):
    """A uniform batch: ``prefill()``, the cache padded to ``max_len``
    (6 positions beyond the run's for a profile of its decode step),
    ``n_steps`` greedy ``decode(cache, tokens)`` steps; the launches of
    both kernels asserted (``per_prefill``, ``per_step`` dicts), prefill
    ms, decode ms a step (p50 / p95) and tokens/s, and the logits at
    every step held against the same steps re-run on the plain path
    (fed the same tokens) within ``limits`` (relative RMS, max), beside
    the float64 floor.  Returns (decode launches, prefill launches,
    metrics)."""
    import numpy as np
    import torch

    pre_launches = []

    def run(feed=None, steps=n_steps):
        n0 = _lm_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, pre = prefill()
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        pre_launches.append({k: n - n0[k] for k, n in _lm_launches().items()})
        cache = _pad_cache(pre, max_len)
        out, fed, step_s = [logits.float().cpu().numpy()], [], []
        for i in range(steps):
            tok = (torch.argmax(logits, -1) if feed is None
                   else feed[i]).reshape(b, 1)
            fed.append(tok)
            t1 = time.perf_counter()
            logits, cache = decode(cache, tok)
            out.append(logits.float().cpu().numpy())
            step_s.append(time.perf_counter() - t1)
        return out, fed, pre_s, step_s, pre, cache

    run(steps=2)                                       # warm-up
    _zero_lm_launches()
    got, fed, pre_s, step_s, pre, cache = run()
    launches, pre_n = _lm_launches(), pre_launches[-1]
    want = {k: per_prefill[k] + n_steps * per_step[k] for k in per_step}
    if launches != want or pre_n != per_prefill:
        raise AssertionError(f"{name}: launches {launches} (prefill "
                             f"{pre_n}), expected {want} "
                             f"(prefill {per_prefill}, a step {per_step})")
    step_ms = sorted(t * 1e3 for t in step_s)
    p50 = float(np.percentile(step_ms, 50))
    p95 = float(np.percentile(step_ms, 95))
    tps = b * n_steps / sum(step_s)
    print(f"{name} ({card}): prefill {pre_s * 1e3:.1f} ms, decode step "
          f"p50 {p50:.2f} ms, p95 {p95:.2f} ms ({tps:.1f} tokens/s over "
          f"{n_steps} steps of batch {b}); launches {launches} (prefill "
          f"{per_prefill}, a step {per_step})", flush=True)
    with plain_kernels():
        ref, _, _, _, ref_pre, _ = run(feed=fed)
    with plain_kernels(torch.float64):
        ref64 = run(feed=fed)[0]
    check = LogitCheck(name, *limits)
    floor = LogitCheck(f"{name} float64 plain", None, None)
    for i, (g, r, r64) in enumerate(zip(got, ref, ref64)):
        for row in range(b):
            check.add(g[row], r[row], f"step {i} row {row}")
            floor.add(r64[row], r[row], f"step {i} row {row}")
    flips = ""
    if pre["k"].dtype == torch.int32:
        share = {k: 100 * float((pre[k] != ref_pre[k]).float().mean())
                 for k in ("k", "v")}
        flips = (f"; packed KV words after prefill that differ from the "
                 f"plain path's: K {share['k']:.2f}%, V {share['v']:.2f}%")
    print(f"{name} teacher-forced on the plain path: {check.summary()}"
          f"{flips}", flush=True)
    print(f"  floor, the float64-summed plain path against the float32 one: "
          f"{floor.summary()}", flush=True)
    # 6 more steps into the cache's spare positions
    print(f"{name} decode step:", flush=True)
    profile_calls(lambda: decode(cache, fed[-1]), "decode step")
    decode_launches = {k: n - pre_n[k] for k, n in launches.items()}
    return decode_launches, pre_n, dict(
        decode_tokens_per_s=tps, step_p50_ms=p50, step_p95_ms=p95,
        prefill_ms=pre_s * 1e3, rms=check.rms, max=check.max)


# the families' uniform runs: batch, hymba's prompt, paligemma's text
# tokens, whisper's frames and prompt, and decode steps
FAM_B, HYMBA_LEN, PALI_TEXT, WHISPER_FRAMES, WHISPER_PROMPT = 4, 1024, 64, \
    1500, 4
FAM_STEPS, WHISPER_STEPS, WHISPER_MAX_LEN = 16, 32, 448


def _build_family(dev, arch):
    """``arch`` at full width from seed 0, every linear packed to W4."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer, whisper

    cfg = get_config(arch)
    init = whisper.init if cfg.encdec is not None else transformer.init
    t0 = time.perf_counter()
    params = pack_lm(init(0, cfg, device=dev), 4)
    torch.cuda.synchronize()
    print(f"{arch} full width ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; {cfg.n_params() / 1e9:.2f} B "
          f"parameters): init from seed 0 and W4 packing in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
          f"card", flush=True)
    return cfg, params


def _whisper_step_linears(params):
    """Whisper's decoder linears a decode step runs, one list a layer: the
    cross-attention's wq and wo only (its wk and wv project the encoder
    states, at prefill)."""
    return [[lp["attn"][k]["w"] for k in ("wq", "wk", "wv", "wo")]
            + [lp["xattn"][k]["w"] for k in ("wq", "wo")]
            + [lp["mlp"][k]["w"] for k in ("wi", "wo")]
            for lp in params["dec_layers"]]


def families_kernel_phase(dev):
    """The kernels at the LM families' served shapes, full width, random
    weights from seed 0, W4 (``pack_lm``): each family's decode-layer
    linears held against the plain version and timed at M=8
    (``LayerLinears``), and held against it at every other M the
    families phase gives them (the engine's prefills and warm-up,
    hymba's 4 x 1024 prefill, paligemma's 4 x (256 + 64) and
    ``vision_proj``'s 4 x 256, whisper's 4 x 1500 encoder states and
    4 x 4 prompt, the uniform decode at M=4); ``kv_attention`` held
    against its plain version and timed at Hymba's (hd 64, 5 query
    heads a KV head, window 1024) and PaliGemma's (hd 256, G 8) served
    caches and at granite's (hd 64, G 3, 8 x 1024 positions, 544 live)
    and hymba's (G 5, window 1024, the same cache) as the distributed
    phase's tensor-parallel decode reads them.  It
    runs beside the other kernel phases, before the serving and
    training phases, after which the profiler misses launches (PERF.md
    §7).  Returns (rows, errs) for the kernel record."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = {"packed_qmatmul": {}, "kv_attention": {}}
    errs = {"packed_qmatmul": 0.0, "kv_attention": 0.0}
    b = FAM_B

    def layer_row(short, layers):
        """Time one decode layer's linears (``layers``: one list a
        layer)."""
        r, err, run, nbytes = LayerLinears(dev, gen, layers).at(
            8, check_all=True)
        shapes = sorted({tuple(qt.shape) for qt in layers[0]})
        print(f"  packed_qmatmul {short} decode layer ({len(layers[0])} "
              f"linears, (n, k) {shapes}) m=8 w4 bf16, cold, variant "
              f"{r['variant']}: kernel {r['ms']:.4f} ms (wrapper calls "
              f"{_median_ms(run):.4f} ms wall) | plain {r['plain_ms']:.4f} ms "
              f"| bf16 matmul on dequantized weights {r['library_ms']:.4f} ms "
              f"| bound {r['bound_ms']:.5f} ms (bytes {r['bytes_ms']:.5f}, "
              f"flops {r['ops_ms']:.5f}; {nbytes} B) | max |err| {err:.3e} "
              f"(all {len(layers)} layers)", flush=True)
        rows["packed_qmatmul"][f"{short} decode layer"] = r
        errs["packed_qmatmul"] = max(errs["packed_qmatmul"], err)

    def check_served(short, layers, ms):
        """Hold layer 0's linears of ``layers`` against the plain version
        at each M (rows) that the served path runs them at."""
        ms, variants, err = sorted(set(ms)), set(), 0.0
        linears = LayerLinears(dev, gen, layers)
        for m in ms:
            _, v, e = linears.check(m)
            variants.update(v)
            err = max(err, e)
        print(f"  packed_qmatmul {short}: layer 0's {len(layers[0])} "
              f"linears within tolerance of the plain version at the served "
              f"M {ms} (variants {', '.join(sorted(variants))}; max |err| "
              f"{err:.3e})", flush=True)
        errs["packed_qmatmul"] = max(errs["packed_qmatmul"], err)

    def kv(arch, short, cfg, live, window=0, checks=()):
        r, err = kv_row(dev, gen, arch, b=b, s_len=live, live=live,
                        h=cfg.n_heads, kh=cfg.n_kv, hd=cfg.head_dim,
                        window=window, checks=checks)
        rows["kv_attention"][f"{short} decode"] = r
        errs["kv_attention"] = max(errs["kv_attention"], err)

    for arch, short in (("granite-moe-3b-a800m", "granite"),
                        ("mamba2-1.3b", "mamba2"), ("hymba-1.5b", "hymba"),
                        ("paligemma-3b", "paligemma")):
        cfg, params = _build_family(dev, arch)
        layers = [_layer_linears(lp) for lp in params["layers"]]
        layer_row(short, layers)
        engine = [16] + [len(p) for p in serve_prompts(cfg)[:8]]
        if short == "paligemma":
            check_served("paligemma prefill and decode", layers,
                         [b * (cfg.vision_prefix_len + PALI_TEXT), b])
            check_served("paligemma vision_proj",
                         [[params["vision_proj"]["w"]]],
                         [b * cfg.vision_prefix_len])
            kv(arch, short, cfg,
               cfg.vision_prefix_len + PALI_TEXT + FAM_STEPS)
        elif short == "hymba":
            check_served("hymba prefills and uniform decode", layers,
                         engine + [b * HYMBA_LEN, b])
            kv(arch, short, cfg, HYMBA_LEN + FAM_STEPS, cfg.sliding_window,
               ((0, None),))
            # the distributed phase's tensor-parallel decode over INT4 KV
            r, err = kv_row(dev, gen, "hymba tp", b=8, s_len=1024,
                            live=512 + 32, h=cfg.n_heads, kh=cfg.n_kv,
                            hd=cfg.head_dim, window=cfg.sliding_window,
                            checks=((0, None),))
            rows["kv_attention"]["hymba tp decode"] = r
            errs["kv_attention"] = max(errs["kv_attention"], err)
        else:
            check_served(f"{short} prefills", layers, engine)
        if short == "granite":
            # the distributed phase's tensor-parallel decode over INT4 KV:
            # 8 x 512 prefilled into a 1024-position cache, 32 steps
            r, err = kv_row(dev, gen, "granite tp", b=8, s_len=1024,
                            live=512 + 32, h=cfg.n_heads, kh=cfg.n_kv,
                            hd=cfg.head_dim)
            rows["kv_attention"]["granite tp decode"] = r
            errs["kv_attention"] = max(errs["kv_attention"], err)
        del params, layers
        torch.cuda.empty_cache()

    cfg, params = _build_family(dev, "whisper-base")
    dec_step = _whisper_step_linears(params)
    layer_row("whisper", dec_step)
    check_served("whisper decoder prefill and decode", dec_step,
                 [b * WHISPER_PROMPT, b])
    check_served("whisper cross-attention K/V", [
        [lp["xattn"][k]["w"] for k in ("wk", "wv")]
        for lp in params["dec_layers"]], [b * WHISPER_FRAMES])
    check_served("whisper encoder", [_layer_linears(lp)
                                     for lp in params["enc_layers"]],
                 [b * WHISPER_FRAMES])
    del params, dec_step
    torch.cuda.empty_cache()
    return rows, errs


def families_phase(dev, card):
    """The LM families beyond the dense ones served at full width, bf16,
    random weights from seed 0, every linear packed to W4 (``pack_lm``;
    their kernels at these shapes: ``families_kernel_phase``):

    - granite-moe-3b-a800m, mamba2-1.3b and hymba-1.5b by the engine
      (``family_serve_run``; MoE prefills on the dispatch path, decodes
      on the dense mix): 128, 96 and 288 ``packed_qmatmul`` a forward;
    - hymba-1.5b with an INT4 KV cache, a uniform batch of 4 x 1024-token
      prompts and 16 decode steps that cross its 1024 window: 288 a
      forward, 32 ``kv_attention`` a step;
    - paligemma-3b, INT4 KV, a uniform batch of 4 x (256 vision
      embeddings + 64 text tokens), 16 decode steps: 127 at prefill
      (``vision_proj`` the 127th), 126 and 18 ``kv_attention`` (head_dim
      256, 8 query heads a KV head) a step;
    - whisper-base, bf16 KV: ``encode`` of 4 x 1500 stub frames inside
      the prefill of a 4-token prompt, the cache padded to 448, 32
      uniform decode steps: 96 at prefill (36 in ``encode``), 48 a step.

    moonshot-v1-16b-a3b (28.1 B parameters, ~56 GB in bf16) is held only
    on the CPU.  Returns the runs' launches for the kernel record."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import transformer, whisper

    t_phase = time.perf_counter()
    runs = {}
    b, n_steps = FAM_B, FAM_STEPS

    def served(path, result):
        runs[path], runs[f"{path} prefill"] = result[:2]

    def per_forward(cfg, params):
        return len(_layer_linears(params["layers"][0])) * cfg.n_layers

    for arch, short, name in (("granite-moe-3b-a800m", "granite",
                               "granite-moe"),
                              ("mamba2-1.3b", "mamba2", "mamba2")):
        cfg, params = _build_family(dev, arch)
        served(f"{short} serve", family_serve_run(
            dev, card, name, cfg, params, per_forward(cfg, params)))
        del params
        torch.cuda.empty_cache()

    cfg, params = _build_family(dev, "hymba-1.5b")
    per = per_forward(cfg, params)
    served("hymba serve", family_serve_run(dev, card, "hymba", cfg, params,
                                           per))
    cfg4 = dataclasses.replace(cfg, kv_cache_bits=4)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, HYMBA_LEN)), dtype=torch.int64, device=dev)
    served("hymba int4-kv", family_uniform_run(
        dev, card, f"hymba W4 + INT4 KV, uniform batch {b} x {HYMBA_LEN}",
        lambda: transformer.prefill(params, cfg4, toks),
        lambda c, t: transformer.decode_step(params, cfg4, c, t),
        b=b, max_len=HYMBA_LEN + n_steps + 6, n_steps=n_steps,
        per_prefill={"packed_qmatmul": per, "kv_attention": 0},
        per_step={"packed_qmatmul": per, "kv_attention": cfg.n_layers},
        limits=(0.25, 0.30)))
    del params, toks
    torch.cuda.empty_cache()

    cfg, params = _build_family(dev, "paligemma-3b")
    per = per_forward(cfg, params)
    cfg4 = dataclasses.replace(cfg, kv_cache_bits=4)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, PALI_TEXT)),
                           dtype=torch.int64, device=dev)
    vis = torch.as_tensor(rng.standard_normal(
        (b, cfg.vision_prefix_len, cfg.d_model)), dtype=torch.bfloat16,
        device=dev)
    s_all = cfg.vision_prefix_len + PALI_TEXT
    served("paligemma int4-kv", family_uniform_run(
        dev, card, f"paligemma W4 + INT4 KV, uniform batch {b} x "
        f"({cfg.vision_prefix_len} vision + {PALI_TEXT} text)",
        lambda: transformer.prefill(params, cfg4, toks, vis),
        lambda c, t: transformer.decode_step(params, cfg4, c, t),
        b=b, max_len=s_all + n_steps + 6, n_steps=n_steps,
        per_prefill={"packed_qmatmul": per + 1, "kv_attention": 0},
        per_step={"packed_qmatmul": per, "kv_attention": cfg.n_layers},
        limits=(0.25, 0.30)))
    del params, toks, vis
    torch.cuda.empty_cache()

    cfg, params = _build_family(dev, "whisper-base")
    per = len(_whisper_step_linears(params)[0])
    per_step = per * cfg.n_layers
    per_enc = len(_layer_linears(params["enc_layers"][0])) \
        * cfg.encdec.n_layers
    per_pre = per_enc + (per + 2) * cfg.n_layers
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.standard_normal(
        (b, WHISPER_FRAMES, cfg.d_model)), dtype=torch.bfloat16, device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (b, WHISPER_PROMPT)),
                           dtype=torch.int64, device=dev)
    served("whisper decode", family_uniform_run(
        dev, card, f"whisper-base W4, bf16 KV, encode {b} x "
        f"{WHISPER_FRAMES} frames + a {WHISPER_PROMPT}-token prompt",
        lambda: whisper.prefill(params, cfg, toks, frames),
        lambda c, t: whisper.decode_step(params, cfg, c, t),
        b=b, max_len=WHISPER_MAX_LEN, n_steps=WHISPER_STEPS,
        per_prefill={"packed_qmatmul": per_pre, "kv_attention": 0},
        per_step={"packed_qmatmul": per_step, "kv_attention": 0},
        limits=(0.10, 0.15)))
    print(f"  whisper prefill: {per_pre} packed_qmatmul ({per_enc} in "
          f"encode)", flush=True)
    del params, frames, toks
    torch.cuda.empty_cache()
    print(f"families phase: {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return runs


def plain_forward(model, images):
    """The packaged forward walked layer by layer with the plain kernel
    versions (fusion groups lowered member by member), recording each
    packed layer's input spike rate (the float32 mean ``repro`` takes)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.core.snn_layers import (
        maxpool_t, readout_apply, spiking_conv_apply)
    from repro_torch.graph import build_graph
    from repro_torch.graph.executors import mean_f32
    from repro_torch.graph.spec import (
        Conv, Dense, Encode, Pool, Readout, Residual, get_path)
    from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
    from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch

    cfg, lif = model.cfg, model.cfg.lif
    rates = {}

    def conv(name, x):
        lp = model.layers[name]
        rates[name] = float(mean_f32(x))
        _, out = fused_conv_rollout_torch(
            packing.pack_bool(x), lp.qt, stride=lp.stride, padding="SAME",
            leak_shift=lif.leak_shift, threshold_q=lp.theta_q,
            soft_reset=lif.soft_reset)
        return packing.unpack_bool(out, lp.qt.c_out)

    x = images
    for node in build_graph(cfg).nodes:
        if isinstance(node, Encode):
            x = x.expand(node.timesteps, *x.shape)
        elif isinstance(node, Conv) and node.stem:
            p = get_path(model.float_params, node.name)
            x = spiking_conv_apply(p, x, lif, cfg.precision,
                                   stride=node.stride).to(torch.int32)
        elif isinstance(node, Conv):
            x = conv(node.name, x)
        elif isinstance(node, Pool):
            x = maxpool_t(x, node.window)
        elif isinstance(node, Residual):
            h = x
            for body_conv in node.body:
                h = conv(body_conv.name, h)
            sc = conv(node.proj.name, x) if node.proj is not None else x
            x = torch.maximum(h, sc)
        elif isinstance(node, Dense):
            lp = model.layers[node.name]
            x = x.reshape(x.shape[0], x.shape[1], -1)
            rates[node.name] = float(mean_f32(x))
            _, out = fused_nce_rollout_torch(
                packing.pack_bool(x), lp.qt, d_in=node.d_in,
                leak_shift=lif.leak_shift, threshold_q=lp.theta_q,
                soft_reset=lif.soft_reset)
            x = packing.unpack_bool(out, node.d_out)
            rates[f"{node.name}.out"] = float(mean_f32(x))
        elif isinstance(node, Readout):
            if node.spatial_mean:
                x = torch.mean(x.to(torch.float32), dim=(2, 3))
            return readout_apply(get_path(model.float_params, node.name),
                                 x), rates
    raise AssertionError("graph has no readout")


def profile_calls(fn, what, reps=5):
    """Where ``fn`` spends device time: torch.profiler over ``reps`` calls
    (after one warm-up call), the top kernels by device time, and the
    device's busy share of the wall time.  Returns the wall and device
    busy us per call (busy None when the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print("profile: no device time reported (not measured)", flush=True)
        return wall_us / reps, None
    print(f"profile of {reps} {what}s: wall {wall_us / reps:.1f} us per "
          f"{what}, device busy {busy_us / reps:.1f} us "
          f"({100 * busy_us / wall_us:.1f}% of wall, the profiler's own "
          f"host cost included); top kernels (us per {what}, launches "
          f"per {what}):", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / reps:9.1f}  {count // reps:4d}  {key[:90]}",
              flush=True)
    return wall_us / reps, busy_us / reps


def profile_batch(model, x, reps=5):
    """Where a B=8 packaged forward spends device time."""
    import torch

    def forward():
        with torch.inference_mode():
            model.apply(x)

    profile_calls(forward, "B=8 forward", reps)


def _kernel_counters():
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.fused_group import ops as group_ops
    from repro_torch.kernels.fused_nce import ops as nce_ops

    return {"fused_conv": conv_ops.fused_conv_rollout,
            "fused_nce": nce_ops.fused_nce_rollout,
            "fused_group": group_ops.fused_group_rollout}


def serve_phase(dev, model_name, fusion, per_batch, same_as=None,
                params=None, images=None, what="trained"):
    """Serve 16 full-width INT4 requests of ``model_name`` with ``fusion``
    through the engine (max_batch=8); assert ``per_batch`` launches of
    each kernel per batch (counts set to 0 just before, read just after)
    and every request's logits equal to the plain path's (and to
    ``same_as``, another path's logits, when given).  ``params`` (default
    ``graph_init`` from seed 0) is the float tree deployed, ``images``
    (default uniform noise from seed 0) the 16 requests; ``what`` names
    given params in the output.  Returns the launch counts and the
    logits."""
    import numpy as np
    import torch

    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config,
        load)
    from repro_torch.models import snn_cnn

    trained = params is not None
    label = f"{(what + ' ') * trained}{model_name} fusion={fusion!r}"
    cfg = deploy_config(model_name, 4, smoke=False, fusion=fusion)
    if not trained:
        params = snn_cnn.init(0, cfg, device=dev)
    model = deploy(params, cfg, device=dev)
    pkg_dir = ROOT / "build" / "chip_smoke"
    pkg_dir.mkdir(parents=True, exist_ok=True)
    tag = ((what + "_") * trained) + ("auto" if fusion else "off")
    path = model.save(str(pkg_dir / f"{model_name}_w4_{tag}_full.npz"))
    model = load(path, device=dev)
    print(f"{label} INT4 full width: {len(model.layers)} packed layers, "
          f"{model.nbytes_packed() / 1e6:.3f} MB packed, saved and reloaded "
          f"({Path(path).stat().st_size} B npz)", flush=True)

    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=8), device=dev)
    if fusion:
        print(eng.graph_summary(), flush=True)
    eng.warmup()
    if images is None:
        images = np.random.default_rng(0).random(
            (16, cfg.img_size, cfg.img_size,
             cfg.in_channels)).astype(np.float32)
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for uid in range(len(images)):
        eng.add_request(SNNRequest(uid=uid, image=images[uid]))
    stats = eng.run_until_done()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    batches = stats["batches"]
    want = {k: per_batch.get(k, 0) * batches for k in counters}
    if batches != 2 or launches != want:
        raise AssertionError(f"{label}: launches {launches} over "
                             f"{batches} batches; expected {per_batch} per "
                             f"batch")

    all_rates, logits = [], []
    for start in range(0, len(images), 8):
        x = torch.from_numpy(images[start:start + 8]).to(dev)
        with torch.inference_mode():
            ref, rates = plain_forward(model, x)
        ref = ref.cpu().numpy()
        all_rates.append(rates)
        for i in range(ref.shape[0]):
            got = eng.done[start + i].logits
            if got.shape != (cfg.n_classes,) or not np.isfinite(got).all():
                raise AssertionError(f"{label} request {start + i}: bad "
                                     f"logits {got}")
            if not np.array_equal(got, ref[i]):
                raise AssertionError(
                    f"{label} request {start + i}: kernel-path logits "
                    f"{got} != plain-path logits {ref[i]}")
            logits.append(got)
    logits = np.stack(logits)
    if same_as is not None and not np.array_equal(logits, same_as):
        raise AssertionError(f"{label}: logits differ from the unfused "
                             f"engine's")
    rates = {k: sum(r[k] for r in all_rates) / len(all_rates)
             for k in all_rates[0]}
    print(f"{label} spike rates (input of each packed layer, plain path): "
          + ", ".join(f"{k} {v:.4f}" for k, v in rates.items()), flush=True)
    for k, v in rates.items():
        if not k.endswith(".out") and not v > 0.0:
            raise AssertionError(f"{label}: {k} input spike rate is 0: the "
                                 f"kernel comparison would be vacuous")
    profile_batch(model, torch.from_numpy(images[:8]).to(dev))
    print(f"{label}: served 16 requests in {batches} batches: "
          f"{16 / wall:.1f} images/s end to end ({wall * 1e3:.2f} ms wall), "
          f"latency p50 {stats['latency_p50_ms']:.3f} ms, p95 "
          f"{stats['latency_p95_ms']:.3f} ms, compute avg "
          f"{stats['compute_avg_ms']:.3f} ms/batch; launches {launches}; "
          f"all 16 logit vectors equal to the plain path"
          + ("" if same_as is None else " and to the unfused engine"),
          flush=True)
    return launches, logits


def vgg16_serve_phase(dev):
    """vgg16 (the paper's Table II network) ``fusion=()`` at full width,
    INT4, served as ``serve_phase`` serves: 12 ``fused_conv`` + 1
    ``fused_nce`` a batch, logits bit-equal to the plain path.  An
    uncalibrated 13-conv SNN goes silent after ~6 layers (its input rate
    check would fail), so the ``graph_init`` (seed 0) params are first
    balanced by ``calibrate`` on 32 uniform-noise images (seed 1), the
    paper's deploy flow."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.deploy import deploy_config
    from repro_torch.models import snn_cnn

    cfg = deploy_config("vgg16", 4, smoke=False)
    calib = torch.from_numpy(np.random.default_rng(1).random(
        (32, cfg.img_size, cfg.img_size,
         cfg.in_channels)).astype(np.float32)).to(dev)
    params = snn_cnn.calibrate(snn_cnn.init(0, cfg, device=dev),
                               dataclasses.replace(cfg, int_deploy=False),
                               calib)
    launches, _ = serve_phase(dev, "vgg16", (),
                              {"fused_conv": 12, "fused_nce": 1},
                              params=params, what="calibrated")
    return launches

def _drive_async(aeng, images):
    """64 requests submitted from 4 threads into a started tier, then
    64 through loadgen's open loop (Poisson, 1000 requests/s, seed 0),
    then ``close``.  Returns the (image index, result) pairs, the open
    loop's report, the burst's seconds, the wall seconds and the final
    stats."""
    import threading

    from repro_torch.serve_async import poisson_schedule, run_open_loop_async

    t0 = time.perf_counter()
    submitted = [None] * 64

    def client(tid):
        for i in range(tid * 16, tid * 16 + 16):
            submitted[i] = aeng.submit(images[i])

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    if any(th.is_alive() for th in threads) or None in submitted:
        raise AssertionError("async phase: a submitting thread did not "
                             "finish within 60 s")
    results = [(i, f.result(timeout=60)) for i, f in enumerate(submitted)]
    t_burst = time.perf_counter() - t0

    class Recorder:
        """loadgen's open loop submits images[i % 64]: keep each future
        with its image's index."""

        def __init__(self):
            self.futures = []

        def submit(self, image, deadline_ms=None):
            fut = aeng.submit(image, deadline_ms=deadline_ms)
            self.futures.append((len(self.futures) % 64, fut))
            return fut

    rec = Recorder()
    report = run_open_loop_async(rec, images,
                                 poisson_schedule(1000.0, 64, seed=0),
                                 result_timeout_s=60.0)
    results += [(i, f.result(timeout=60)) for i, f in rec.futures]
    stats = aeng.close(timeout=60)
    return results, report, t_burst, time.perf_counter() - t0, stats


def async_serve_phase(dev, card):
    """vgg9 ``fusion=()`` at full width, INT4, T=4 through
    ``AsyncSNNServeEngine`` (2 workers, max_batch 8, buckets pinned to
    (8,)): 64 requests submitted from 4 threads, then 64 through
    loadgen's open loop at a Poisson rate of 1000 requests/s (seed 0).
    Every request's logits must equal the synchronous engine's for the
    same image (same pinned bucket), each batch must launch 4
    ``fused_conv`` and 1 ``fused_nce`` (counts set to 0 just before the
    tier starts, read after it closes), no request may time out, the
    registry's counters must reconcile with the engine's totals, and the
    exported Chrome trace must pass the port's ``obs.validate``.
    The sync engine's images/s over its 64 are printed beside.  Returns
    the launch counts."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config,
        load)
    from repro_torch.models import snn_cnn
    from repro_torch.obs import validate as obs_validate
    from repro_torch.serve_async import (
        AsyncEngineConfig, AsyncSNNServeEngine)

    t_phase = time.perf_counter()
    cfg = deploy_config("vgg9", 4, smoke=False)
    model = deploy(snn_cnn.init(0, cfg, device=dev), cfg, device=dev)
    pkg_dir = ROOT / "build" / "chip_smoke"
    pkg_dir.mkdir(parents=True, exist_ok=True)
    model = load(model.save(str(pkg_dir / "vgg9_w4_async_full.npz")),
                 device=dev)
    images = np.random.default_rng(1).random(
        (64, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)
    ecfg = dict(max_batch=8, buckets=(8,))

    sync = SNNServeEngine(model, SNNEngineConfig(**ecfg), device=dev)
    sync.warmup()
    for uid, img in enumerate(images):
        sync.add_request(SNNRequest(uid=uid, image=img))
    t0 = time.perf_counter()
    sync_stats = sync.run_until_done()
    sync_wall = time.perf_counter() - t0
    ref = np.stack([sync.pop_result(uid).logits for uid in range(64)])
    sync.close()

    reg = obs.MetricsRegistry()
    eng = SNNServeEngine(model, SNNEngineConfig(**ecfg), device=dev,
                         registry=reg)
    aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(workers=2))
    aeng.warmup()
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    aeng.start()
    results, report, t_burst, wall, stats = _drive_async(aeng, images)
    launches = {k: fn.launches for k, fn in counters.items()}

    bad = [(i, r.status) for i, r in results if not r.ok]
    if bad or report.timeouts or stats["async"]["timeouts"] or \
            stats["async"]["errors"]:
        raise AssertionError(f"async phase: requests not ok: {bad[:5]}, "
                             f"timeouts {stats['async']['timeouts']}, "
                             f"errors {stats['async']['errors']}")
    for i, r in results:
        if r.logits.shape != (cfg.n_classes,) or \
                not np.isfinite(r.logits).all():
            raise AssertionError(f"async request {r.uid}: bad logits")
        if not np.array_equal(r.logits, ref[i]):
            raise AssertionError(
                f"async request {r.uid} (image {i}): logits {r.logits} != "
                f"the sync engine's {ref[i]}")
    batches = eng.total_batches
    want = {"fused_conv": 4 * batches, "fused_nce": batches,
            "fused_group": 0}
    if launches != want:
        raise AssertionError(f"async phase: launches {launches} over "
                             f"{batches} batches; expected 4 fused_conv "
                             f"and 1 fused_nce a batch")
    a = stats["async"]
    reconcile = {
        "snn_serve_requests_total": (reg.find(
            "snn_serve_requests_total").value, eng.total_requests),
        "snn_serve_submitted_total": (reg.find(
            "snn_serve_submitted_total").value, a["submitted"]),
        "snn_serve_batches_total": (reg.find(
            "snn_serve_batches_total").value, batches),
        "completed": (a["completed"], 128),
        "engine requests": (eng.total_requests, 128)}
    off = {k: v for k, v in reconcile.items() if v[0] != v[1]}
    if off:
        raise AssertionError(f"async phase: counts do not reconcile: {off}")
    trace = obs.export_chrome_trace(reg, str(pkg_dir / "async.trace.json"),
                                    meta={"entry": "chip_smoke async"})
    if obs_validate.main([trace, "--trace"]) != 0:
        raise AssertionError(f"async phase: {trace} fails obs.validate")
    print(f"vgg9 fusion=() INT4 full width, async tier (2 workers, bucket "
          f"8) on {card}: 128 requests in {batches} batches, every logit "
          f"vector equal to the sync engine's; launches {launches}; "
          f"registry and engine totals reconcile; Chrome trace "
          f"{len(reg.spans())} spans valid", flush=True)
    print(f"  4 submitting threads: 64 requests in {t_burst * 1e3:.2f} ms "
          f"({64 / t_burst:.1f} images/s); open loop: {report.summary()}",
          flush=True)
    print(f"  all 128: {128 / wall:.1f} images/s over {wall * 1e3:.2f} ms "
          f"wall, latency p50 {stats['latency_p50_ms']:.3f} / p95 "
          f"{stats['latency_p95_ms']:.3f} / p99 "
          f"{stats['latency_p99_ms']:.3f} ms, queue avg "
          f"{stats['queue_avg_ms']:.3f} ms, compute avg "
          f"{stats['compute_avg_ms']:.3f} ms, padding waste "
          f"{stats['padding_waste']:.3f}, {a['slots_recycled']} slot "
          f"recycles", flush=True)

    # beside it, outside the counted run: the sync engine's own 64 (the
    # tier at 1 and 2 workers: tools/kernel_probe.py async)
    print(f"  beside it: sync engine 64 requests in {sync_wall * 1e3:.2f} "
          f"ms ({64 / sync_wall:.1f} images/s, p50 "
          f"{sync_stats['latency_p50_ms']:.3f} ms, compute avg "
          f"{sync_stats['compute_avg_ms']:.3f} ms/batch); phase "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    return {k: v for k, v in launches.items() if v}


def _counted(fn):
    """Run ``fn`` with the SNN kernels' launch counts set to 0 just
    before; returns its result and the counts read just after."""
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items() if c.launches}


def _blocked_ms(fn, reps=5):
    """Median wall ms of ``fn`` to its last device op (one warm call
    first): the host clock around a call that ends in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _trace_events(prof_dir):
    """The events of the one torch.profiler trace in ``prof_dir``."""
    files = sorted(Path(prof_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {prof_dir}, found "
                             f"{[f.name for f in files]}")
    return json.loads(files[0].read_text())["traceEvents"]


def obs_phase(dev, card):
    """The serve path's sampled observability passes on the card.

    1. For vgg9 ``fusion=()``, vgg9 ``"auto"`` and resnet18 ``"auto"``
       (full width, INT4, ``graph_init`` seed 0, 2 sample images):
       ``instrumented_forward``'s records equal the plain forward's
       ``apply_with_rates`` at every instrumentation point within one
       float32 ulp (the two means round ``count / n`` two ways, as
       ``repro``'s jitted and op-by-op ``jnp.mean`` do; a fused group's
       row exactly: the same mean of its output plane on the plain
       path), and
       the telemetry and attribution passes each launch the kernels of
       one forward (vgg9 auto: 1 ``fused_group`` + 1 ``fused_nce``);
       ``timed_forward`` gives one row per executed node, each with
       ``wall_us > 0``; each node's median wall over 5 more timed
       passes (and its spread) is printed beside its H100 roofline
       prediction, with the unwrapped forward's blocked wall and what
       each sampled pass costs (medians).
    2. ``serve_snn.main([--full, --fusion auto, --metrics, --trace,
       --profile])``: its JSONL passes ``obs.validate`` with the
       ``layer_telemetry``, ``predicted_vs_measured`` and
       ``code_utilization`` spans, the watchdog's calibration equals the
       telemetry rates, and the profiler trace holds
       ``snn_serve_step/b8`` and device events of ``fused_group`` and
       ``fused_nce``.
    3. ``launch.train.main([--arch olmo-1b --smoke --steps 3 --profile])``
       writes a trace with device kernels.
    Returns the launch counts of each counted run."""
    import shutil

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.deploy import deploy, deploy_config
    from repro_torch.graph import build_graph
    from repro_torch.graph.spec import Conv, Dense, Residual
    from repro_torch.launch import serve_snn
    from repro_torch.launch import train as train_launcher
    from repro_torch.models import snn_cnn
    from repro_torch.obs import validate as obs_validate

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke" / "obs"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    runs = {}
    for name, fusion, per_pass in (
            ("vgg9", (), {"fused_conv": 4, "fused_nce": 1}),
            ("vgg9", "auto", {"fused_group": 1, "fused_nce": 1}),
            ("resnet18", "auto", {"fused_group": 5, "fused_conv": 9})):
        label = f"{name} fusion={fusion!r}"
        cfg = deploy_config(name, 4, smoke=False, fusion=fusion)
        model = deploy(snn_cnn.init(0, cfg, device=dev), cfg, device=dev)
        x = torch.from_numpy(np.random.default_rng(0).random(
            (2, cfg.img_size, cfg.img_size,
             cfg.in_channels)).astype(np.float32)).to(dev)
        graph = build_graph(cfg)
        with torch.inference_mode():
            plain_logits, plain_rates = model.apply_with_rates(x)
            _, input_rates = plain_forward(model, x)
        points = [n.name for n in graph.nodes
                  if isinstance(n, (Conv, Residual, Dense))]
        want = dict(zip(points, plain_rates))
        top = {n.name: i for i, n in enumerate(graph.nodes)}
        groups = set()
        for g in graph.groups:
            if g.members[0] in top:         # a top-level chain: its output
                nxt = graph.nodes[top[g.members[-1]] + 1].name
                want[g.name] = input_rates[nxt]     # is the next's input
                groups.add(g.name)

        reg = obs.MetricsRegistry()
        (logits, records), tel_launches = _counted(
            lambda: obs.instrumented_forward(
                cfg, model.float_params, x, package=model, registry=reg))
        (t_logits, timed), att_launches = _counted(
            lambda: obs.timed_forward(
                cfg, model.float_params, x, package=model, registry=reg))
        for what, launches in (("telemetry", tel_launches),
                               ("attribution", att_launches)):
            if launches != per_pass:
                raise AssertionError(f"obs {label}: the {what} pass "
                                     f"launched {launches}; expected "
                                     f"{per_pass} (one forward)")
        runs[f"obs {name} {'auto' if fusion else 'off'}"] = {
            k: tel_launches.get(k, 0) + att_launches.get(k, 0)
            for k in per_pass}
        with torch.inference_mode():
            unwrapped = model.apply(x)
        for what, got in (("telemetry", logits), ("attribution", t_logits)):
            if not torch.equal(got, unwrapped):
                raise AssertionError(f"obs {label}: the {what} pass's "
                                     f"logits differ from the forward's")
        # telemetry's float32 mean multiplies by the rounded reciprocal
        # (repro's jitted jnp.mean), apply_with_rates divides (jnp.mean
        # op by op): one float32 ulp apart at most; a group's row is held
        # exactly against the plain path's mean_f32 of its output plane
        got = {r["layer"]: r["rate"] for r in records}
        off = {k: (v, want.get(k)) for k, v in got.items()
               if k not in want or abs(v - want[k]) > (0 if k in groups else
                   float(np.spacing(np.float32(max(v, want[k])))))}
        if off:
            raise AssertionError(f"obs {label}: telemetry rates off the "
                                 f"plain forward's: {off}")
        n_exec = len(graph.nodes) - sum(
            len(g.members) - 1 for g in graph.groups if g.members[0] in top)
        if len(timed) != n_exec or not all(r["wall_us"] > 0 for r in timed):
            raise AssertionError(f"obs {label}: {len(timed)} attributed "
                                 f"nodes of {n_exec}, walls "
                                 f"{[r['wall_us'] for r in timed]}")

        def fwd():
            with torch.inference_mode():
                model.apply(x)

        fwd_ms = _blocked_ms(fwd)
        tel_ms = _blocked_ms(lambda: obs.instrumented_forward(
            cfg, model.float_params, x, package=model,
            registry=obs.MetricsRegistry()))
        # 5 more timed passes: each node's median wall, its spread, and
        # the median pass (the counted pass above ran first)
        walls, att = {}, []
        for _ in range(5):
            t0 = time.perf_counter()
            _, rows = obs.timed_forward(cfg, model.float_params, x,
                                        package=model,
                                        registry=obs.MetricsRegistry())
            torch.cuda.synchronize()
            att.append((time.perf_counter() - t0) * 1e3)
            for r in rows:
                walls.setdefault(r["layer"], []).append(r["wall_us"])
        med = [dict(r, wall_us=sorted(walls[r["layer"]])[2]) for r in timed]
        for r in med:
            r["ratio"] = round(r["wall_us"] / r["predicted_us"], 2) \
                if r["predicted_us"] else None
        summ = obs.attribution_summary(med)
        print(f"obs {label} INT4 full width, B=2, on {card}: telemetry "
              f"rates equal apply_with_rates (one ulp) at all {len(records)} "
              f"rows; launches a pass {tel_launches}; forward {fwd_ms:.3f} "
              f"ms blocked wall, telemetry pass {tel_ms:.3f} ms, attribution "
              f"pass {sorted(att)[2]:.3f} ms (medians); per node, the median "
              f"of 5 timed passes: {summ['wall_us']:.1f} us in all against "
              f"an H100 roofline of {summ['predicted_us']:.1f} us "
              f"({summ['host_over_roofline_x']}x), hottest "
              f"{summ['hottest_layer']} {summ['hottest_wall_us']:.1f} us",
              flush=True)
        print(f"  {'layer':<16} {'kind':<12} {'wall_us':>10} {'min-max':>17} "
              f"{'predicted_us':>13} {'ratio':>10}  bottleneck", flush=True)
        for r in med:
            pred, ratio = (("-" if r[k] is None else r[k])
                           for k in ("predicted_us", "ratio"))
            spread = (f"{min(walls[r['layer']]):.2f}-"
                      f"{max(walls[r['layer']]):.2f}")
            print(f"  {r['layer']:<16} {r['kind']:<12} {r['wall_us']:>10.2f} "
                  f"{spread:>17} {pred:>13} {ratio:>10}  "
                  f"{r['bottleneck'] or '-'}", flush=True)
        for r in records:
            print(f"  telemetry {r['layer']:<14} rate {r['rate']:.6f} "
                  f"saturation {r['saturation']:.6f} silent "
                  f"{r['silent']:.6f} resets {r['resets']}", flush=True)
        del model

    # the launcher, as a user runs it
    jsonl, trace = out_dir / "serve_snn.jsonl", out_dir / "serve_snn.trace.json"
    prof = out_dir / "serve_profile"
    watchdogs = []

    class Recording(obs.Watchdog):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            watchdogs.append(self)

    real = obs.Watchdog
    obs.Watchdog = Recording
    try:
        t0 = time.perf_counter()
        stats, launches = _counted(lambda: serve_snn.main(
            ["--full", "--fusion", "auto", "--requests", "16",
             "--metrics", str(jsonl), "--trace", str(trace),
             "--profile", str(prof)]))
        launcher_s = time.perf_counter() - t0
    finally:
        obs.Watchdog = real
        obs.disable_default()
    runs["obs launcher vgg9 auto"] = launches
    if stats["requests"] != 16 or set(launches) != {"fused_group",
                                                    "fused_nce"}:
        raise AssertionError(f"obs launcher: {stats['requests']} requests, "
                             f"launches {launches}")
    spans = "layer_telemetry,predicted_vs_measured,code_utilization"
    if obs_validate.main([str(jsonl), "--require-spans", spans]) != 0 or \
            obs_validate.main([str(trace), "--trace"]) != 0:
        raise AssertionError(f"obs launcher: {jsonl} or {trace} fails "
                             f"obs.validate")
    rates = {s["layer"]: s["rate"] for s in obs.read_jsonl(str(jsonl))
             ["spans"] if s.get("event") == "layer_telemetry"}
    if len(watchdogs) != 1 or watchdogs[0].calibration != rates or \
            not rates:
        raise AssertionError(f"obs launcher: watchdog calibration "
                             f"{[w.calibration for w in watchdogs]} != the "
                             f"telemetry rates {rates}")
    events = _trace_events(prof)
    steps = [e for e in events if e.get("name") == "snn_serve_step/b8"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in n for n in kernels)
             for k in ("fused_group_kernel", "fused_nce_kernel")}
    if not steps or not all(found.values()):
        raise AssertionError(f"obs launcher: profiler trace holds "
                             f"{len(steps)} snn_serve_step/b8 ranges and "
                             f"kernels {found}")
    print(f"obs launcher (serve_snn --full --fusion auto --metrics --trace "
          f"--profile, 16 requests) on {card}: {launcher_s:.2f} s, "
          f"{stats['images_per_s']:.1f} images/s served under the "
          f"profiler; JSONL valid with {spans}; watchdog calibration = the "
          f"{len(rates)} telemetry rates; trace: {len(steps)} "
          f"snn_serve_step/b8 ranges, {len(kernels)} kernel events "
          f"({found}); launches {launches}", flush=True)

    tprof = out_dir / "train_profile"
    t0 = time.perf_counter()
    train_launcher.main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                         "--ckpt-dir", str(out_dir / "ckpt"),
                         "--profile", str(tprof)])
    kernels = [e for e in _trace_events(tprof) if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("obs train --profile: no kernel in the trace")
    print(f"obs train launcher (olmo-1b --smoke --steps 3 --profile) on "
          f"{card}: {time.perf_counter() - t0:.2f} s, {len(kernels)} kernel "
          f"events in the trace; phase {time.perf_counter() - t_phase:.2f} "
          f"s", flush=True)
    shutil.rmtree(out_dir / "ckpt", ignore_errors=True)
    return runs


def _snn_ce(logits, y):
    """Mean cross-entropy, as the JAX package's SNN training computes it."""
    import torch

    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - logits.gather(1, y[:, None])[:, 0])


def _rel_rms(got, want):
    """Relative RMS error of ``got`` against ``want`` (tensors, or lists of
    tensors taken together), in float64 on the host."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    num = den = 0.0
    for g, w in zip(got, want):
        w = w.detach().to("cpu", torch.float64)
        num += float(torch.sum((g.detach().to("cpu", torch.float64) - w)
                               ** 2))
        den += float(torch.sum(w ** 2))
    return (num / den) ** 0.5


def _snn_forward_and_grads(params, cfg, x, y):
    """The float/BPTT forward of ``params`` (leaves requiring grad): its
    logits, every conv and dense layer's output spikes, and the gradient
    of the cross-entropy on every leaf (zeros where the loss does not
    reach: the head's gain)."""
    import torch

    from repro_torch.graph import FloatExecutor, build_graph, run_graph
    from repro_torch.tree import leaves

    spikes = {}

    class Recorder(FloatExecutor):
        def conv(self, spec, h):
            out = super().conv(spec, h)
            spikes[spec.name] = out.detach()
            return out

        def dense(self, spec, h):
            out = super().dense(spec, h)
            spikes[spec.name] = out.detach()
            return out

    graph = build_graph(cfg)
    logits = run_graph(graph, Recorder(graph, params), x)
    grads = torch.autograd.grad(_snn_ce(logits, y), leaves(params),
                                allow_unused=True, materialize_grads=True)
    return logits.detach(), spikes, list(grads)


@contextlib.contextmanager
def _conv_variant(name):
    """The float conv under test, with PyTorch's default
    ``cudnn.allow_tf32=True`` set globally: ``"exact"`` is the port's
    (TF32 off forward and backward whatever the global flags);
    ``"tf32 backward"`` the conv before the port made its backward exact
    (forward under the exact flags, backward under the global ones);
    ``"tf32"`` TF32 forward and backward, and in the dense einsums."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import snn_layers
    from repro_torch.kernels.fused_conv.ref import conv_pads

    def conv(x, w, stride=1, padding="SAME"):
        kh, kw = w.shape[0], w.shape[1]
        (plh, phh), (plw, phw) = conv_pads(x.shape[1], x.shape[2], kh, kw,
                                           stride, padding)
        xn = F.pad(x.permute(0, 3, 1, 2), (plw, phw, plh, phh))
        flags = torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=False) if name == "tf32 backward" \
            else contextlib.nullcontext()
        with flags:
            y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride)
        return y.permute(0, 2, 3, 1)

    saved = (snn_layers._conv2d, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
        if name != "exact":
            snn_layers._conv2d = conv
        yield
    finally:
        (snn_layers._conv2d, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def snn_train_phase(dev, card):
    """vgg9 at full width trained on the card, then deployed and served:
    ``deploy_config("vgg9", 4, smoke=False)`` with ``int_deploy=False``
    (32x32x3, convs 64-64-P-128-128-P-256-P, fc1 4096->512, T=4, 10
    classes, W4 QAT, a scale per output channel), random weights from
    seed 0, ``make_vision_dataset`` (seed 0) for data:

    1. ``calibrate`` on 32 training images on the card (ms printed),
       in float64 its gains within rtol 1e-3 of the same calibration on
       the host CPU in float64; beside it, not asserted, the float32
       calibration's error and the host's float32 one (the floor that
       float32 threshold flips set: at fc1 both sit ~1e-2 off, PERF.md
       §6); training starts from the float32 gains, as a float32 user's
       would;
    2. on one batch of 8, the calibrated float QAT forward on the card
       (float32, the port's exact conv: TF32 off forward and backward)
       against the same params' forward on the host in float64: logits
       relative RMS <= 0.02, >= 99.5% of every conv and dense layer's
       spikes equal (each layer firing), the first step's gradients
       within a global relative RMS of 0.05; beside them, not asserted,
       the same figures and the ms of a forward and backward at batch 64
       with PyTorch's TF32 backward and with TF32 throughout
       (``_conv_variant``).  Calibration comes first because an
       uncalibrated deep SNN is near silent, which would make the spike
       comparison vacuous;
    3. 1 warm-up and 30 timed BPTT steps at batch 64 with the port's
       AdamW (lr 3e-4, 10 warm-up steps, no weight decay, clip 5.0):
       every loss finite, the mean of the last 3 below the mean of the
       first 3; ms a step, images/s, ``max_memory_allocated`` and the
       device-busy share and top kernels of one profiled step (on a copy
       of the params); beside it, the same 31 steps at the example's lr
       1e-3, which at full width stays at chance (PERF.md §6);
    4. the trained params deployed at INT4 with ``fusion=()`` and
       ``"auto"`` and served (16 test images, ``serve_phase``): logits
       equal to ``plain_forward`` and to each other bit for bit, 4
       ``fused_conv`` + 1 ``fused_nce`` or 1 ``fused_group`` + 1
       ``fused_nce`` a batch, and equal to the per-call ``IntExecutor``
       forward of the same params; the QAT and deployed test accuracies
       over 512 images printed (synthetic data: not asserted).

    Returns the two serve runs' launches."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.data import synthetic
    from repro_torch.deploy import deploy, deploy_config
    from repro_torch.graph.spec import get_path
    from repro_torch.models import snn_cnn
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import leaves, map_tree, unflatten_like

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(deploy_config("vgg9", 4, smoke=False),
                              int_deploy=False)
    int_cfg = dataclasses.replace(cfg, int_deploy=True)
    (x_tr, y_tr), (x_te, y_te) = synthetic.make_vision_dataset(
        n_classes=cfg.n_classes, img_size=cfg.img_size, n_train=2048,
        n_test=512)

    def on(d, x, y=None):
        xb = torch.from_numpy(x).to(d)
        return xb if y is None else (xb, torch.from_numpy(y).to(
            d, torch.int64))

    def host64(tree):
        return map_tree(lambda t: t.detach().to("cpu", torch.float64),
                        tree)

    def with_grad(tree):
        return map_tree(lambda t: t.detach().clone().requires_grad_(True),
                        tree)

    # 1. calibration, card against host float64
    init = snn_cnn.init(0, cfg, device=dev)
    calib = on(dev, x_tr[:32])
    params = snn_cnn.calibrate(init, cfg, calib)
    cal_ms = _median_ms(lambda: snn_cnn.calibrate(init, cfg, calib),
                        iters=1, reps=3)
    host = snn_cnn.calibrate(host64(init), cfg, on("cpu", x_tr[:32]))
    init64 = map_tree(lambda t: t.to(torch.float64), init)
    card64 = snn_cnn.calibrate(init64, cfg, calib)
    cal64_ms = _median_ms(lambda: snn_cnn.calibrate(init64, cfg, calib),
                          iters=1, reps=3)
    host32 = snn_cnn.calibrate(map_tree(lambda t: t.cpu(), init), cfg,
                               on("cpu", x_tr[:32]))
    names = ("convs.0", "convs.1", "convs.2", "convs.3", "convs.4", "fc1")

    def gain_err(tree):
        errs = {}
        for name in names:
            g = get_path(tree, name)["g"].to("cpu", torch.float64)
            h = get_path(host, name)["g"]
            rel = torch.abs(g - h) / torch.abs(h)
            errs[name] = (float(rel.max()), int((rel > 1e-3).sum()))
        return errs

    errs = {"card float64": gain_err(card64),
            "card float32": gain_err(params),
            "host float32": gain_err(host32)}
    print(f"vgg9 full width calibrate on 32 images [{card}]: {cal_ms:.2f} "
          f"ms on the card in float32, {cal64_ms:.2f} ms in float64; gains "
          f"against the host's float64 calibration, max relative error "
          f"(channels over 1e-3) by layer:", flush=True)
    for what, e in errs.items():
        print(f"  {what}: " + ", ".join(
            f"{k} {v:.3g} ({n})" for k, (v, n) in e.items())
            + (" (limit 1e-3)" if what == "card float64" else
               " (not asserted: float32 spikes at threshold flip against "
               "float64 ones and the flips compound layer by layer)"),
            flush=True)
    if not max(v for v, _ in errs["card float64"].values()) <= 1e-3:
        raise AssertionError(f"snn calibrate: gains off the host's by "
                             f"{errs['card float64']}")
    del init64, card64, host32

    # 2. forward and gradients, card against host float64
    x8, y8 = on(dev, x_tr[:8], y_tr[:8])
    h_logits, h_spikes, h_grads = _snn_forward_and_grads(
        with_grad(host64(params)), cfg, x8.cpu(), y8.cpu())
    rates = {k: float(v.mean()) for k, v in h_spikes.items()}
    xb, yb = on(dev, x_tr[:64], y_tr[:64])
    figures = {}
    for variant in ("exact", "tf32 backward", "tf32"):
        with _conv_variant(variant):
            logits, spikes, grads = _snn_forward_and_grads(
                with_grad(params), cfg, x8, y8)
            tp = with_grad(params)

            def fwd_bwd():
                loss = _snn_ce(snn_cnn.apply(tp, cfg, xb), yb)
                torch.autograd.grad(loss, leaves(tp), allow_unused=True,
                                    materialize_grads=True)

            ms = _median_ms(fwd_bwd, iters=3, reps=3)
        same = {k: float((spikes[k].cpu() == h_spikes[k]).float().mean())
                for k in h_spikes}
        figures[variant] = (_rel_rms(logits, h_logits), same,
                            _rel_rms(grads, h_grads), ms, logits, grads)
        exact = figures["exact"]
        print(f"vgg9 float QAT forward on the card, {variant} conv "
              f"(cudnn.allow_tf32=True globally) against the host in "
              f"float64, batch 8 [{card}]: logits relative RMS "
              f"{figures[variant][0]:.3g} (limit 0.02), spikes equal by "
              f"layer " + ", ".join(f"{k} {v:.5f}" for k, v in same.items())
              + f" (limit 0.995; host rates "
              + ", ".join(f"{k} {v:.4f}" for k, v in rates.items())
              + f"), gradients global relative RMS "
              f"{figures[variant][2]:.3g} (limit 0.05); against the exact "
              f"conv on the card: logits {_rel_rms(logits, exact[4]):.3g}, "
              f"gradients {_rel_rms(grads, exact[5]):.3g}; forward + "
              f"backward at batch 64 {ms:.2f} ms", flush=True)
    rms, same, grad_rms = figures["exact"][:3]
    if not (rms <= 0.02 and min(same.values()) >= 0.995
            and grad_rms <= 0.05 and min(rates.values()) > 0):
        raise AssertionError(f"snn float forward on the card: logits "
                             f"{rms}, spikes {same}, gradients {grad_rms}, "
                             f"host rates {rates}")

    # 3. BPTT training
    def ocfg(lr):
        return opt.OptConfig(lr=lr, warmup_steps=10, total_steps=31,
                             weight_decay=0.0, clip_norm=5.0)

    def step(p, s, x, y, o):
        loss = _snn_ce(snn_cnn.apply(p, cfg, x), y)
        grads = torch.autograd.grad(loss, leaves(p), allow_unused=True,
                                    materialize_grads=True)
        opt.update(unflatten_like(p, list(grads)), s, p, o)
        return loss.detach()

    @torch.no_grad()
    def qat_accuracy(p):
        hits = 0
        for i in range(0, len(x_te), 64):
            logits = snn_cnn.apply(p, cfg, on(dev, x_te[i:i + 64]))
            hits += int((logits.argmax(-1).cpu()
                         == torch.from_numpy(y_te[i:i + 64])).sum())
        return hits / len(x_te)

    torch.cuda.reset_peak_memory_stats()
    tp = with_grad(params)
    state = opt.init(tp)
    batches = [on(dev, x_tr[i:i + 64], y_tr[i:i + 64])
               for i in range(0, 31 * 64, 64)]
    losses = [step(tp, state, *batches[0], ocfg(3e-4))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:]:
        losses.append(step(tp, state, *b, ocfg(3e-4)))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / (len(batches) - 1)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    print(f"vgg9 full width BPTT (T=4, W4 QAT, AdamW lr 3e-4), batch 64 "
          f"[{card}]: {wall * 1e3:.2f} ms a step over {len(batches) - 1} "
          f"steps after 1 warm-up, {64 / wall:.1f} images/s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated); losses "
          + ", ".join(f"{v:.4f}" for v in losses), flush=True)
    if not (np.isfinite(losses).all()
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"snn BPTT: losses {losses}")
    pp = with_grad(tp)
    ps = opt.init(pp)
    wall_us, busy_us = profile_calls(
        lambda: step(pp, ps, *batches[1], ocfg(3e-4)), "BPTT step", reps=1)
    if busy_us is not None:
        print(f"vgg9 BPTT step device busy {100 * busy_us / wall_us:.1f}% "
              f"of {wall_us / 1e3:.2f} ms wall (profiled) [{card}]",
              flush=True)
    # beside it, not asserted: the example's lr 1e-3 (sized for its
    # quarter-width model) from the same calibrated params
    pp = with_grad(params)
    ps = opt.init(pp)
    fast = [float(step(pp, ps, *b, ocfg(1e-3))) for b in batches]
    print(f"  beside it, lr 1e-3 from the same params: losses "
          + ", ".join(f"{v:.4f}" for v in fast)
          + f"; W4 QAT test accuracy {100 * qat_accuracy(pp):.1f}% against "
          f"lr 3e-4's {100 * qat_accuracy(tp):.1f}%", flush=True)
    del pp, ps, batches

    # 4. deploy and serve the trained params
    x16 = x_te[:16]
    runs = {}
    runs["vgg9 trained off"], flat = serve_phase(
        dev, "vgg9", (), {"fused_conv": 4, "fused_nce": 1}, params=tp,
        images=x16)
    runs["vgg9 trained auto"], _ = serve_phase(
        dev, "vgg9", "auto", {"fused_group": 1, "fused_nce": 1},
        same_as=flat, params=tp, images=x16)
    with torch.no_grad():
        percall = torch.cat([snn_cnn.apply(tp, int_cfg, on(dev, x16[i:i + 8]))
                             for i in (0, 8)]).cpu().numpy()
        if not np.array_equal(percall, flat):
            raise AssertionError("trained vgg9: served logits differ from "
                                 "the per-call IntExecutor forward")
        model = deploy(tp, int_cfg, device=dev)
        int_hits = sum(
            int((model.apply(on(dev, x_te[i:i + 64])).argmax(-1).cpu()
                 == torch.from_numpy(y_te[i:i + 64])).sum())
            for i in range(0, len(x_te), 64))
    print(f"trained vgg9 [{card}]: served logits equal to the per-call "
          f"IntExecutor forward (16 requests); test accuracy over "
          f"{len(x_te)} synthetic images: W4 QAT forward "
          f"{100 * qat_accuracy(tp):.1f}%, deployed INT4 "
          f"{100 * int_hits / len(x_te):.1f}% (not asserted); phase "
          f"{time.perf_counter() - t_phase:.2f} s", flush=True)
    return runs


def _lm_batch(cfg, batch, seq, step, dev):
    """A synthetic LM batch on ``dev``: tokens and labels, and for an
    encoder-decoder (whisper) ``WHISPER_FRAMES`` stub frames a row
    (standard normal, bf16, from seed ``step``)."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic

    b = synthetic.lm_batch(cfg.vocab, batch, seq, seed=0, step=step)
    out = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in b.items()}
    if cfg.encdec is not None:
        out["frames"] = torch.as_tensor(np.random.default_rng(step)
                                        .standard_normal((batch,
                                                          WHISPER_FRAMES,
                                                          cfg.d_model)),
                                        dtype=torch.bfloat16, device=dev)
    return out


def train_phase(dev, card):
    """olmo-1b training on the card, then the trained weights served
    through ``packed_qmatmul``:

    1. one ``make_train_step`` at full width and depth (16 layers, bf16,
       W4 QAT), batch 8 x 128 tokens: 1 warm and 5 timed steps (loss and
       grad norm finite), tokens/s, peak memory, a profile of 3 more
       steps for the device-busy share, and the AdamW update's time
       alone;
    2. ``Trainer`` at full width cut to 2 layers, 8 steps, a checkpoint
       every 4 (keep 1, async), then again with a ``FailureInjector`` at
       step 6 under ``run_with_restarts``: the restarted run resumes from
       step 4 and its losses at steps 4-7 agree with the uninterrupted
       run's within rtol 1e-3 (the measured difference is printed);
    3. 2 steps of the 2-layer model with ``SpikingConfig()``;
    4. the uninterrupted run's step-8 checkpoint restored, every linear
       packed to W4 with ``pack_lm`` on the absmax grid the QAT trained
       against (no clip search), 4 requests served by ``ServeEngine``
       (8 slots, bf16 KV): ``packed_qmatmul`` launched 14 times a forward,
       8 greedy tokens a request, and each request's first-token logits
       within 0.10 / 0.15 relative RMS / max of the fake-quant forward of
       the same checkpoint with its quantizer in float32 (the grid
       ``quantize`` packs); beside it, not asserted, the same measures
       against the bf16 fake-quant forward QAT trains with, whose
       ``w / scale`` rounds to bf16 before the round and so flips codes.

    Returns the serve run's launches."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.fault_tolerance import (
        FailureInjector,
        run_with_restarts,
    )
    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.qat import fake_quant
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import leaves, unflatten_like

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("olmo-1b"),
                              precision=PrecisionConfig(bits=4,
                                                        group_size=-1))
    bsz, seq = 8, 128
    ocfg = TrainConfig().opt

    # 1. the full-size step
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init(0, cfg, device=dev)
    state = opt.init(params)
    step = make_train_step(cfg, ocfg)
    metrics = [step(params, state, _lm_batch(cfg, bsz, seq, 0, dev))[2]]
    batches = [_lm_batch(cfg, bsz, seq, i, dev) for i in range(1, 6)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        metrics.append(step(params, state, b)[2])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / len(batches)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    if not np.isfinite(losses + norms).all():
        raise AssertionError(f"olmo train: losses {losses}, grad norms "
                             f"{norms}")
    peak = torch.cuda.max_memory_allocated()
    print(f"olmo-1b train step, full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"bf16, W4 QAT, AdamW), batch {bsz} x {seq} tokens [{card}]: "
          f"losses (warm step first) "
          f"{', '.join(f'{x:.4f}' for x in losses)}; grad norms "
          f"{', '.join(f'{x:.4f}' for x in norms)}; {wall * 1e3:.1f} ms a "
          f"step over {len(batches)} steps, {bsz * seq / wall:.1f} tokens/s, "
          f"peak memory {peak / 2 ** 30:.2f} GiB "
          f"(max_memory_allocated)", flush=True)
    batch = batches[0]
    wall_us, busy_us = profile_calls(
        lambda: step(params, state, batch), "train step", reps=3)
    if busy_us is not None:
        print(f"olmo-1b train step device busy {100 * busy_us / wall_us:.1f}"
              f"% of {wall_us / 1e3:.1f} ms wall (profiled) [{card}]",
              flush=True)
    # the AdamW update alone, on gradients of the params' shapes
    grads = [torch.randn_like(p) * 1e-3 for p in leaves(params)]
    grads = unflatten_like(params, grads)
    upd_ms = _median_ms(lambda: opt.update(grads, state, params, ocfg),
                        iters=2, reps=3)
    print(f"olmo-1b AdamW update alone: {upd_ms:.1f} ms a step "
          f"({100 * upd_ms / (wall * 1e3):.0f}% of the step's wall) "
          f"[{card}]", flush=True)
    del params, state, step, metrics, batches, batch, grads
    torch.cuda.empty_cache()

    # 2. checkpoint and restart at 2 layers
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    quiet = lambda *_: None  # noqa: E731

    def tcfg(name):
        return TrainConfig(steps=8, batch=bsz, seq=seq, ckpt_dir=str(
            root / name), ckpt_every=4, ckpt_keep=1, log_every=100,
            opt=opt.OptConfig(warmup_steps=2, total_steps=8))

    t0 = time.perf_counter()
    ref = Trainer(cfg2, tcfg("ref"), log=quiet, device=dev).run()
    t_ref = time.perf_counter() - t0
    inj = FailureInjector(fail_at_steps=(6,))
    logs, attempts = [], []

    def attempt(a):
        attempts.append(a)
        tr = Trainer(cfg2, tcfg("restart"), injector=inj, log=logs.append,
                     device=dev)
        try:
            return tr.run()
        finally:
            tr.ckpt.wait()   # the failed attempt's step-4 write commits

    t0 = time.perf_counter()
    out = run_with_restarts(attempt, max_restarts=1)
    t_restart = time.perf_counter() - t0
    logs = [line for line in logs if "restored" in line]
    got, want = np.array(out["losses"]), np.array(ref["losses"][4:])
    rel = float(np.max(np.abs(got - want) / np.abs(want))) \
        if got.shape == want.shape else float("inf")
    print(f"olmo-1b Trainer, full width cut to 2 layers, 8 steps of {bsz} x "
          f"{seq} tokens, checkpoint every 4 (async, keep 1, ~"
          f"{sum(f.stat().st_size for f in (root / 'ref').rglob('*.npy')) / 2 ** 30:.2f}"
          f" GiB each) [{card}]: losses {', '.join(f'{x:.4f}' for x in ref['losses'])}"
          f" in {t_ref:.1f} s; the run failed at step 6 and restarted "
          f"({attempts}, {logs}) in {t_restart:.1f} s: steps 4-7 "
          f"{', '.join(f'{x:.4f}' for x in got)}, max relative difference "
          f"{rel:.3g} (limit 1e-3; {free / 2 ** 30:.0f} GiB free on disk "
          f"before)", flush=True)
    if (attempts != [0, 1] or logs != ["[trainer] restored checkpoint "
                                       "step=4"] or not rel <= 1e-3):
        raise AssertionError(f"olmo restart: attempts {attempts}, logs "
                             f"{logs}, losses {out['losses']} against "
                             f"{ref['losses'][4:]}")

    # 3. the spiking FFN at 2 layers
    cfg_s = dataclasses.replace(cfg2, spiking=SpikingConfig())
    params = transformer.init(1, cfg_s, device=dev)
    state = opt.init(params)
    step = make_train_step(cfg_s, ocfg)
    t0 = time.perf_counter()
    spk = [step(params, state, _lm_batch(cfg_s, bsz, seq, i, dev))[2]
           for i in range(2)]
    spk = [(float(m["loss"]), float(m["grad_norm"])) for m in spk]
    torch.cuda.synchronize()
    if not np.isfinite(spk).all():
        raise AssertionError(f"olmo spiking FFN: (loss, grad norm) {spk}")
    print(f"olmo-1b spiking FFN (T=4, leak shift 3, threshold 1.0), 2 "
          f"layers, 2 steps [{card}]: (loss, grad norm) "
          f"{', '.join(f'({a:.4f}, {b:.4f})' for a, b in spk)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    del params, state, step
    torch.cuda.empty_cache()

    # 4. the trained checkpoint served through packed_qmatmul
    ckpt = CheckpointManager(root / "ref")
    like = {"params": transformer.init(0, cfg2, device=dev)}
    dense = ckpt.restore(8, like)["params"]
    with torch.no_grad():
        packed = pack_lm(ckpt.restore(8, like)["params"], 4,
                         clip_search=False)
    del like
    shutil.rmtree(root)
    rng = np.random.default_rng(1)
    reqs = [Request(uid=i, prompt=rng.integers(
        0, cfg2.vocab, int(rng.integers(16, 65))).astype(np.int32),
        max_new_tokens=8) for i in range(4)]
    eng = ServeEngine(cfg2, packed, EngineConfig(slots=8, max_len=256,
                                                 keep_logits=True),
                      device=dev)
    qmm_ops.qmatmul.launches = 0
    kv_ops.quant_kv_decode_attention.launches = 0
    for r in reqs:
        eng.add_request(r)
    with torch.inference_mode():
        stats = eng.run_until_done()
    launches = {"packed_qmatmul": qmm_ops.qmatmul.launches,
                "kv_attention": kv_ops.quant_kv_decode_attention.launches}
    per_fwd = 7 * cfg2.n_layers
    want = {"packed_qmatmul": per_fwd * (len(reqs) + stats["decode_steps"]),
            "kv_attention": 0}
    if (launches != want or stats["incomplete"]
            or any(len(r.output) != 8 for r in reqs)):
        raise AssertionError(f"olmo train -> serve: launches {launches} "
                             f"(expected {want}), stats {stats}, outputs "
                             f"{[r.output for r in reqs]}")
    # the fake-quant forward with its quantizer in float32 (the grid
    # quantize packs): each linear's W4 weights computed once
    pc = cfg2.precision
    grid = {**dense, "layers": [
        {**lp, **{blk: {n: {**lin, "w": fake_quant(
            lin["w"].float().T, pc).T.to(lin["w"].dtype)}
            for n, lin in lp[blk].items()} for blk in ("attn", "mlp")}}
        for lp in dense["layers"]]}
    cfg_dense = dataclasses.replace(cfg2, precision=PrecisionConfig(bits=16))
    check = LogitCheck("olmo train -> serve", 0.10, 0.15)
    qat = LogitCheck("olmo train -> serve against bf16 QAT", None, None)
    with torch.no_grad():
        for r in reqs:
            toks = torch.as_tensor(r.prompt[None], dtype=torch.int64,
                                   device=dev)
            ref_logits, _ = transformer.prefill(grid, cfg_dense, toks)
            check.add(r.logits[0], ref_logits[0].cpu().numpy(),
                      f"request {r.uid}")
            ref_logits, _ = transformer.prefill(dense, cfg2, toks)
            qat.add(r.logits[0], ref_logits[0].cpu().numpy(),
                    f"request {r.uid}")
    print(f"olmo-1b trained checkpoint (step 8) packed to W4, served "
          f"(bf16 KV, 8 slots) [{card}]: 4 requests of "
          f"{', '.join(str(len(r.prompt)) for r in reqs)} prompt tokens, "
          f"{stats['generated_tokens']} greedy tokens in "
          f"{stats['decode_steps']} decode steps, packed_qmatmul launches "
          f"{launches['packed_qmatmul']} ({per_fwd} a forward); first-token "
          f"logits against the fake-quant forward of the same checkpoint, "
          f"its quantizer in float32: {check.summary()}", flush=True)
    met = qat.rms <= 0.10 and qat.max <= 0.15
    print(f"  against the bf16 fake-quant forward QAT trains with (its "
          f"w / scale rounds to bf16 before the round, which flips codes; "
          f"not asserted, 0.10 / 0.15 {'met' if met else 'MISSED'}): "
          f"{qat.summary()} [{card}]", flush=True)
    print(f"train phase: {time.perf_counter() - t_phase:.2f} s", flush=True)
    return {k: v for k, v in launches.items() if v}


def _dp_serve(dev, model, images, data_parallel):
    """16 requests through ``SNNServeEngine(max_batch=8)``: (launches,
    logits, images/s, engine)."""
    import numpy as np

    from repro_torch.deploy import SNNEngineConfig, SNNRequest, SNNServeEngine

    eng = SNNServeEngine(model, SNNEngineConfig(
        max_batch=8, data_parallel=data_parallel), device=dev)
    eng.warmup()
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for uid in range(len(images)):
        eng.add_request(SNNRequest(uid=uid, image=images[uid]))
    eng.run_until_done()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    logits = np.stack([eng.pop_result(u).logits for u in range(len(images))])
    return launches, logits, len(images) / wall, eng


def _train_run(cfg, ocfg, mesh, params, placed, batches, accum=1):
    """``len(batches)`` steps of ``make_train_step(tensor_parallel=True)``
    from ``params`` (placed on ``mesh``, or not: the unsharded step):
    (params, losses, seconds a step, peak GiB)."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optimizer as opt

    step = make_train_step(cfg, ocfg, accum, tensor_parallel=True)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for b in batches:
        if placed:
            b = {k: shd.place(v, shd.NamedSharding(
                mesh, shd.batch_spec(k, v.shape, mesh)))
                for k, v in b.items()}
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    return params, losses, times, torch.cuda.max_memory_allocated() / 2 ** 30


def _agree(params, ref):
    """(share of bit-equal elements, max |diff| over the leaf's max
    |value|) of ``params`` (placed or not) against ``ref``."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import leaves

    eq = n = 0
    worst = 0.0
    for a, b in zip(leaves(params), leaves(ref)):
        a = a.full_tensor() if isinstance(a, DTensor) else a
        a, b = a.detach(), b.detach()
        eq += int(torch.sum(a == b))
        n += b.numel()
        worst = max(worst, float(torch.max(torch.abs(
            a.float() - b.float())) / torch.max(torch.abs(
                b.float())).clamp_min(1e-30)))
    return eq / n, worst


def _tp_train_vs_unsharded(dev, mesh, cfg, ocfg, batches, contexts):
    """The tensor-parallel train step on params placed on ``mesh`` against
    the unsharded step from the same initial params (seed 0), and a
    second unsharded run (the embedding's backward, an ``index_put``
    with ``accumulate``, and the MoE dispatch's are atomic on the card:
    no two runs are bit-equal): losses within rtol 1e-5, params within
    1e-2 of the leaf's largest |value| (asserted); ``contexts`` (the
    wrapped ``tp_for_step``'s list) one a step.  Returns (the unsharded
    run's params, the placed run's, a dict of figures)."""
    import numpy as np
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed import sharding as shd
    from repro_torch.models.api import get_model
    from repro_torch.tree import leaves, map_tree

    ref = get_model(cfg).init(0, device=dev)
    sharded = shd.distribute(
        map_tree(lambda t: t.clone(), ref),
        shd.to_shardings(shd.param_specs(ref, mesh), mesh))
    contexts.clear()
    ref, ref_l, ref_t, ref_mem = _train_run(cfg, ocfg, mesh, ref, False,
                                            batches)
    if contexts:
        raise AssertionError("the unsharded step made a TP context")
    sharded, sh_l, sh_t, sh_mem = _train_run(cfg, ocfg, mesh, sharded, True,
                                             batches)
    if not isinstance(leaves(sharded)[0], DTensor):
        raise AssertionError("the sharded step dropped the placements")
    if len(contexts) != len(batches) or None in contexts:
        raise AssertionError(f"{cfg.name}: the sharded step took the FSDP "
                             f"route: {contexts}")
    again = get_model(cfg).init(0, device=dev)
    again, again_l, _, _ = _train_run(cfg, ocfg, mesh, again, False,
                                      batches)
    sh_eq, sh_worst = _agree(sharded, ref)
    re_eq, re_worst = _agree(again, ref)
    del again
    if not np.allclose(sh_l, ref_l, rtol=1e-5, atol=0) or sh_worst > 1e-2:
        raise AssertionError(f"{cfg.name} sharded step: losses {sh_l} vs "
                             f"unsharded {ref_l}; params max diff "
                             f"{sh_worst:.3e} of the leaf's largest")
    ms = lambda ts: ", ".join(f"{t * 1e3:.1f}" for t in ts)
    loss = lambda ls: ", ".join(f"{x:.6f}" for x in ls)
    return ref, sharded, (
        f"losses {loss(sh_l)} vs {loss(ref_l)} (a second unsharded run: "
        f"{loss(again_l)}); params after {len(batches)} steps bit-equal at "
        f"{sh_eq:.6f} of elements, max diff {sh_worst:.3e} of the leaf's "
        f"largest (second unsharded run: {re_eq:.6f}, {re_worst:.3e}); ms "
        f"a step (first step warm) sharded {ms(sh_t)}, unsharded "
        f"{ms(ref_t)}; peak {sh_mem:.2f} / {ref_mem:.2f} GiB")


def _tp_serve(dev, card, mesh, arch, layers=None):
    """The tensor-parallel serve steps on the (1, 1) mesh: ``arch`` at
    full width (bf16 params; ``layers`` deep, default its own depth), a
    prefill of 8 x 512 tokens padded to 1024 (whisper: 8 x
    ``WHISPER_PROMPT`` tokens over 8 x ``WHISPER_FRAMES`` frames, padded
    to ``WHISPER_MAX_LEN``) and 32 decode steps of
    ``make_prefill_step`` / ``make_decode_step`` (their tensor-parallel
    route) on params placed by ``to_shardings``, once over a bf16 KV
    cache and once over an INT4 one (once for an attention-free config,
    which has no KV cache, and for whisper, whose cache is bf16),
    against the unsharded ``prefill`` / ``decode_step`` from the same
    params, fed the same (greedy) tokens: logits and cache bit-equal,
    the SSM's ``conv`` and ``ssm`` entries and whisper's ``xk`` and
    ``xv`` included (on one rank the KV-head split and the SSM-head
    split are the unsharded arithmetic), the route's contexts asserted
    (one a step, each cache split by KV heads, SSM heads split where the
    config has them), ``n_layers`` ``kv_attention`` launches a step on the INT4
    route, and for a MoE config every router call's top-k experts equal
    to the unsharded run's; ms a decode step and peak memory of both.
    Returns (the INT4 route's decode launches under ``"dist tp <arch>
    int4-kv"``, the last context)."""
    import dataclasses

    import numpy as np
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.kv_attention import ops as kv_ops
    from repro_torch.launch import steps as St
    from repro_torch.models import moe as MOE
    from repro_torch.models.api import get_model

    base = get_config(arch)
    if layers is not None:
        base = dataclasses.replace(base, n_layers=layers)
    mb = get_model(base)
    params = mb.init(0, device=dev)
    placed = shd.distribute(params, shd.to_shardings(
        shd.param_specs(params, mesh), mesh))
    audio = base.encdec is not None
    b, s_len, max_len, n_steps = (8, WHISPER_PROMPT, WHISPER_MAX_LEN, 32) \
        if audio else (8, 512, 1024, 32)
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, base.vocab, (b, s_len)), dtype=torch.int64, device=dev)}
    if audio:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (b, WHISPER_FRAMES, base.d_model)), dtype=torch.bfloat16,
            device=dev)
    contexts, for_step, router = [], St.tp_for_step, MOE._router
    routed = []

    def counted_for_step(c, m):
        contexts.append(for_step(c, m))
        return contexts[-1]

    def recorded_router(p, x, c):
        out = router(p, x, c)
        routed.append(out[1])
        return out

    def put(t, spec_of):
        return shd.place(t, shd.NamedSharding(mesh, spec_of(t.shape)))

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def run(cfg, sharded, feed=None):
        """(logits of the prefill and each step, the tokens fed, the
        prefill's and the last step's cache, decode ms a step, peak GiB
        over what was allocated before, kv_attention launches of the
        decode steps, the router calls' top-k experts)."""
        routed.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        with torch.no_grad():
            if sharded:
                logits, pre = St.make_prefill_step(cfg)(placed, {
                    k: put(v, lambda sh, k=k: shd.batch_spec(k, sh, mesh))
                    for k, v in batch.items()})
            else:
                logits, pre = get_model(cfg).prefill(params, batch)
            pre = {k: whole(v) for k, v in pre.items()}
            # the decode steps write the cache in place, and _pad_cache
            # passes the SSM entries through: decode a copy
            cache = _pad_cache({k: v.clone() for k, v in pre.items()},
                               max_len)
            if sharded:
                cache = {k: put(v, lambda sh, k=k: shd.cache_entry_spec(
                    k, sh, mesh)) for k, v in cache.items()}
                step = St.make_decode_step(cfg)
            out, fed = [whole(logits)], []
            torch.cuda.synchronize()
            kv_ops.quant_kv_decode_attention.launches = 0
            t0 = time.perf_counter()
            for i in range(n_steps):
                tok = (torch.argmax(out[-1], -1).reshape(b, 1)
                       if feed is None else feed[i])
                fed.append(tok)
                if sharded:
                    logits, cache = step(placed, cache, put(
                        tok, lambda sh: shd.batch_spec("tokens", sh, mesh)))
                else:
                    logits, cache = get_model(cfg).decode_step(
                        params, cache, tok)
                out.append(whole(logits))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / n_steps
            launches = kv_ops.quant_kv_decode_attention.launches
        return (out, fed, pre, {k: whole(v) for k, v in cache.items()}, ms,
                (torch.cuda.max_memory_allocated() - before) / 2 ** 30,
                launches, list(routed))

    runs = {}
    route = None if base.is_attention_free else "heads"
    ssm = base.ssm is not None
    St.tp_for_step, MOE._router = counted_for_step, recorded_router
    try:
        for bits in (16,) if route is None or audio else (16, 4):
            cfg = dataclasses.replace(base, kv_cache_bits=bits)
            ref = run(cfg, False)
            contexts.clear()
            mine = run(cfg, True, ref[1])
            routes = [c and c.cache for c in contexts]
            xroutes = [c and c.xcache for c in contexts]
            label = f"tensor-parallel serve {arch} (KV {bits})"
            if (routes != [route] * (1 + n_steps) or None in contexts
                    or xroutes != [route if audio else None] * (1 + n_steps)
                    or any(c.ssm != ssm for c in contexts)):
                raise AssertionError(f"{label}: routes {routes}, contexts "
                                     f"{contexts}")
            same = (all(torch.equal(a, w) for a, w in zip(mine[0], ref[0]))
                    and all(torch.equal(mine[k][key], ref[k][key])
                            for k in (2, 3) for key in ref[k]))
            if not same:
                raise AssertionError(f"{label}: logits or cache differ "
                                     f"from the unsharded steps")
            want = cfg.n_layers * n_steps if bits != 16 else 0
            if mine[6] != want or ref[6] != want:
                raise AssertionError(f"{label}: kv_attention launches "
                                     f"{mine[6]} (unsharded {ref[6]}), "
                                     f"expected {want}")
            if len(mine[7]) != len(ref[7]) or not all(
                    torch.equal(a, w) for a, w in zip(mine[7], ref[7])):
                raise AssertionError(f"{label}: the routed experts differ "
                                     f"from the unsharded run's")
            if bits != 16:
                runs[f"dist tp {arch} int4-kv"] = {"kv_attention": mine[6]}
            kv = ("no KV" if route is None else "bf16 KV" if bits == 16
                  else "INT4 KV")
            experts = (f", {len(mine[7])} router calls' top-"
                       f"{cfg.moe.top_k} experts equal, "
                       f"experts split {contexts[-1].experts}"
                       if cfg.moe else "")
            if ssm:
                experts += (f", SSM heads split {contexts[-1].ssm} (cache "
                            f"entries {sorted(mine[3])})")
            if audio:
                kv = (f"bf16 self and cross ({WHISPER_FRAMES} frames, "
                      f"{cfg.encdec.n_layers} encoder layers, route "
                      f"{xroutes[0]}) KV")
                experts += f" (cache entries {sorted(mine[3])})"
            print(f"distributed: {arch} full width ({cfg.n_layers} "
                  f"layers, d {cfg.d_model}, {cfg.dtype} params), "
                  f"{kv} cache, prefill {b} x {s_len} padded to "
                  f"{max_len} and {n_steps} decode steps of "
                  f"make_prefill_step / make_decode_step (tensor-parallel) "
                  f"on the (1, 1) mesh vs the unsharded steps "
                  f"[{card}]: route {routes[0]} ({len(routes)} contexts), "
                  f"logits and cache bit-equal{experts}, kv_attention "
                  f"launches {mine[6]} ({mine[6] // n_steps} a step); ms a "
                  f"decode step {mine[4]:.2f} vs {ref[4]:.2f} unsharded; "
                  f"peak over the memory held before {mine[5]:.2f} / "
                  f"{ref[5]:.2f} GiB", flush=True)
            del ref, mine
            torch.cuda.empty_cache()
    finally:
        St.tp_for_step, MOE._router = for_step, router
    return runs, contexts[-1]


def _time_all_reduce(dev, card, ctx, shape):
    """ms of one all-reduce of a bf16 activation of ``shape`` over the
    context's one-rank NCCL ``model`` group, over 100 calls."""
    import torch

    x = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    ctx.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        ctx.all_reduce(x)
    torch.cuda.synchronize()
    print(f"distributed: one all-reduce of the route's {tuple(shape)} bf16 "
          f"activation over the one-rank NCCL 'model' group: "
          f"{(time.perf_counter() - t0) * 10:.3f} ms a call, host to "
          f"device done, over 100 calls [{card}]", flush=True)


def _tp_family(dev, card, mesh, arch, part, layers=None, serve_layers=None):
    """One family on the tensor-parallel route, on the (1, 1) mesh, at
    full width (bf16):

    1. 3 steps of ``make_train_step(tensor_parallel=True)``, W4 QAT per
       channel, batch 8 x 128, at ``layers`` of the arch's layers
       (default all), against 3 unsharded steps and a second unsharded
       run under the olmo-1b case's gates (:func:`_tp_train_vs_unsharded`),
       the context made once a step with ``part`` split (``"experts"``:
       the MoE's ``d_ff_expert``; ``"ssm"``: the Mamba-2 heads;
       ``"mlp"``: a dense FFN's ``d_ff``), over ``WHISPER_FRAMES``
       frames a row for whisper;
    2. its prefill and decode steps at ``serve_layers`` (default all)
       over each KV cache it has (:func:`_tp_serve`): bit-equal,
       ``n_layers`` ``kv_attention`` launches a step on the INT4 route.

    Prints each part's seconds.  Returns the INT4 route's decode
    launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import steps as St
    from repro_torch.perfmodel.roofline import override_depth
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.train.trainer import TrainConfig

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(
        override_depth(full, layers or full.n_layers),
        precision=PrecisionConfig(bits=4, group_size=-1))
    contexts, for_step = [], St.tp_for_step

    def counted_for_step(c, m):
        contexts.append(for_step(c, m))
        return contexts[-1]

    St.tp_for_step = counted_for_step
    try:
        batches = [_lm_batch(cfg, 8, 128, i, dev) for i in range(3)]
        ref, sharded, figures = _tp_train_vs_unsharded(
            dev, mesh, cfg, TrainConfig().opt, batches, contexts)
    finally:
        St.tp_for_step = for_step
    if not all(getattr(c, part) for c in contexts):
        raise AssertionError(f"{arch} train: {part} did not split")
    del ref, sharded
    torch.cuda.empty_cache()
    c = contexts[-1]
    print(f"distributed: {arch} full width ({cfg.n_layers} of "
          f"{full.n_layers} layers, {cfg.dtype}, W4 QAT), batch 8 x 128, "
          f"3 steps on params placed by to_shardings on the (1, 1) mesh vs "
          f"unsharded [{card}]: {figures}; route tensor-parallel "
          f"({len(contexts)} contexts: heads {c.heads}, kv {c.kv}, mlp "
          f"{c.mlp}, experts {c.experts}, SSM heads {c.ssm}, vocab "
          f"{c.vocab})", flush=True)
    t1 = time.perf_counter()
    runs, _ = _tp_serve(dev, card, mesh, arch, serve_layers)
    print(f"distributed: {arch} tensor-parallel train {t1 - t0:.1f} s, "
          f"serve {time.perf_counter() - t1:.1f} s", flush=True)
    return runs


def distributed_phase(dev, card):
    """The distributed layer on the card, as one NCCL rank:

    1. a one-rank NCCL group from a ``FileStore`` in a temp dir and a
       (1, 1) ``("data", "model")`` mesh on the card (``make_host_mesh``);
    2. olmo-1b at full width (16 layers, bf16, W4 QAT), batch 8 x 128:
       3 steps of ``make_train_step(tensor_parallel=True)`` on params and
       moments placed by ``to_shardings`` and a batch placed by
       ``batch_spec`` (the tensor-parallel route: its context made once
       a step, asserted), against 3 unsharded steps from the same
       initial params: losses within rtol 1e-5; the params' share of
       bit-equal elements and largest difference printed beside a second
       unsharded run's (the embedding's backward accumulates atomically,
       so no two runs are bit-equal), the largest asserted under 1e-2 of
       the leaf's largest |value|; ms a step and peak memory of each;
       then one ``grad_accum=2`` step of each from fresh params, under
       the same gates;
    3. ``tree_ef_allreduce_mean`` over NCCL on one step's gradient tree,
       twice (the second round re-injects the first's error), bit-exact
       against ``tree_ef_plain`` (the same arithmetic, no collectives),
       with its ms;
    4. the placed params saved from the mesh and ``restore(shardings=)``d
       onto it: bit-equal, the placements asked for;
    5. vgg9 INT4 ``fusion=()`` and ``"auto"`` and resnet18 ``"auto"`` at
       full width, 16 requests through ``SNNServeEngine(data_parallel=
       True)`` (one replica: one card) and with ``data_parallel=False``:
       logits bit-equal, the same launch counts, images/s of both;
    6. the tensor-parallel prefill and decode steps of olmo-1b over a
       bf16 and an INT4 KV cache against the unsharded ones, bit-equal
       (:func:`_tp_serve`), and the ms of one all-reduce on the route;
    7. the MoE family on the route: granite-moe-3b-a800m's train, prefill
       and decode steps at 8 of its 32 layers against the unsharded ones
       (:func:`_tp_family`), with the seconds they took;
    8. the SSM and hybrid families on the route: mamba2-1.3b's and
       hymba-1.5b's (:func:`_tp_family`), with the seconds they took;
    9. the audio family on the route: whisper-base's train, prefill and
       decode steps at full depth (6 + 6 layers), the cross-attention
       cache on its own route (:func:`_tp_family`), with the seconds
       they took.

    The group is destroyed at the end.  Returns the data-parallel serve
    runs' launches and the INT4 tensor-parallel decode steps'."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.deploy import deploy, deploy_config
    from repro_torch.distributed import compression as C
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import snn_cnn, transformer
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.tree import leaves, map_tree, unflatten_like

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    tp_for_step = St.tp_for_step    # wrapped below to count TP contexts
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        print(f"distributed: backend {dist.get_backend()}, world "
              f"{dist.get_world_size()}, mesh {mesh} [{card}]", flush=True)

        # 2. the sharded step against the unsharded one
        cfg = dataclasses.replace(get_config("olmo-1b"),
                                  precision=PrecisionConfig(bits=4,
                                                            group_size=-1))
        ocfg = TrainConfig().opt
        contexts = []

        def counted_for_step(c, m):
            contexts.append(tp_for_step(c, m))
            return contexts[-1]

        St.tp_for_step = counted_for_step
        batches = [_lm_batch(cfg, 8, 128, i, dev) for i in range(3)]
        ref, sharded, figures = _tp_train_vs_unsharded(
            dev, mesh, cfg, ocfg, batches, contexts)
        print(f"distributed: olmo-1b full width ({cfg.n_layers} layers, "
              f"{cfg.dtype}, W4 QAT), batch 8 x 128, 3 steps on params placed by "
              f"to_shardings on the (1, 1) mesh vs unsharded [{card}]: "
              f"{figures}; route tensor-parallel ({len(contexts)} contexts: "
              f"heads {contexts[-1].heads}, kv {contexts[-1].kv}, mlp "
              f"{contexts[-1].mlp}, vocab {contexts[-1].vocab})",
              flush=True)

        # grad_accum=2 on the mesh against the unsharded grad_accum=2
        acc_ref = transformer.init(0, cfg, device=dev)
        acc_sh = shd.distribute(
            map_tree(lambda t: t.clone(), acc_ref),
            shd.to_shardings(shd.param_specs(acc_ref, mesh), mesh))
        acc_ref, acc_ref_l, acc_ref_t, acc_ref_mem = _train_run(
            cfg, ocfg, mesh, acc_ref, False, batches[:1], 2)
        acc_sh, acc_sh_l, acc_sh_t, acc_sh_mem = _train_run(
            cfg, ocfg, mesh, acc_sh, True, batches[:1], 2)
        acc_eq, acc_worst = _agree(acc_sh, acc_ref)
        del acc_ref, acc_sh
        torch.cuda.empty_cache()
        if not np.allclose(acc_sh_l, acc_ref_l, rtol=1e-5, atol=0) or \
                acc_worst > 1e-2:
            raise AssertionError(f"grad_accum=2 on the mesh: loss "
                                 f"{acc_sh_l} vs unsharded {acc_ref_l}; "
                                 f"params max diff {acc_worst:.3e}")
        ms = lambda ts: ", ".join(f"{t * 1e3:.1f}" for t in ts)
        print(f"distributed: olmo-1b full width, W4 QAT, one grad_accum=2 "
              f"step (2 microbatches of 4 x 128) on the (1, 1) mesh, "
              f"tensor-parallel, vs unsharded grad_accum=2 [{card}]: loss "
              f"{acc_sh_l[0]:.6f} vs {acc_ref_l[0]:.6f}; params bit-equal "
              f"at {acc_eq:.6f} of elements, max diff {acc_worst:.3e} of "
              f"the leaf's largest; ms {ms(acc_sh_t)} vs {ms(acc_ref_t)} "
              f"(a first step, cold); peak {acc_sh_mem:.2f} / "
              f"{acc_ref_mem:.2f} GiB", flush=True)
        St.tp_for_step = tp_for_step

        # 3. EF-int8 over NCCL on one step's gradients
        flat = leaves(ref)
        for p in flat:
            p.requires_grad_(True)
        loss = transformer.loss_fn(ref, cfg, batches[0])
        grads = unflatten_like(ref, [g.float() for g in torch.autograd.grad(
            loss, flat, materialize_grads=True)])
        for p in flat:
            p.requires_grad_(False)
        del loss
        errs = map_tree(torch.zeros_like, grads)
        group = mesh.get_group("data")
        n_el = sum(g.numel() for g in leaves(grads))
        for rnd in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, new_errs = C.tree_ef_allreduce_mean(grads, errs, group)
            torch.cuda.synchronize()
            t_ef = time.perf_counter() - t0
            (p_out,), (p_err,) = C.tree_ef_plain([grads], [errs])
            same = all(torch.equal(a, b) for a, b in zip(
                leaves(out) + leaves(new_errs),
                leaves(p_out) + leaves(p_err)))
            if not same:
                raise AssertionError(f"EF-int8 round {rnd}: NCCL result "
                                     f"differs from the plain version")
            rel = float(torch.sqrt(sum(torch.sum((a - b) ** 2) for a, b in
                                       zip(leaves(out), leaves(grads))))
                        / torch.sqrt(sum(torch.sum(b ** 2)
                                         for b in leaves(grads))))
            print(f"distributed: tree_ef_allreduce_mean over NCCL, round "
                  f"{rnd} ({len(leaves(grads))} leaves, {n_el} elements): "
                  f"bit-exact against tree_ef_plain, {t_ef * 1e3:.1f} ms, "
                  f"relative error of the mean gradient {rel:.3e} [{card}]",
                  flush=True)
            errs = new_errs
        del grads, out, new_errs, p_out, p_err, errs

        # 4. save from the mesh, restore onto it
        ck = ROOT / "build" / "chip_smoke_dist"
        shutil.rmtree(ck, ignore_errors=True)
        cm = CheckpointManager(ck)
        t0 = time.perf_counter()
        cm.save(1, sharded)
        t_save = time.perf_counter() - t0
        shs = shd.to_shardings(shd.param_specs(sharded, mesh), mesh)
        like = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), sharded)
        t0 = time.perf_counter()
        back = cm.restore(1, like, shardings=shs)
        t_restore = time.perf_counter() - t0
        for a, b, s in zip(leaves(back), leaves(sharded), leaves(shs)):
            if tuple(a.placements) != s.placements or \
                    not torch.equal(a.full_tensor(), b.full_tensor()):
                raise AssertionError("restore(shardings=) differs")
        shutil.rmtree(ck, ignore_errors=True)
        print(f"distributed: {len(leaves(sharded))} placed leaves "
              f"({sum(t.numel() * t.element_size() for t in leaves(ref)) / 1e9:.2f} GB) "
              f"saved from the mesh in {t_save:.1f} s and restored with "
              f"shardings in {t_restore:.1f} s: bit-equal, placements as "
              f"asked", flush=True)
        del ref, sharded, back, like
        torch.cuda.empty_cache()

        # 5. data-parallel serving
        runs = {}
        for name, fusion in (("vgg9", ()), ("vgg9", "auto"),
                             ("resnet18", "auto")):
            scfg = deploy_config(name, 4, smoke=False, fusion=fusion)
            model = deploy(snn_cnn.init(0, scfg, device=dev), scfg,
                           device=dev)
            images = np.random.default_rng(0).random(
                (16, scfg.img_size, scfg.img_size,
                 scfg.in_channels)).astype(np.float32)
            l0, y0, r0, _ = _dp_serve(dev, model, images, False)
            l1, y1, r1, eng = _dp_serve(dev, model, images, True)
            label = f"{name} fusion={fusion!r}"
            if l1 != l0 or not np.array_equal(y1, y0):
                raise AssertionError(f"data-parallel {label}: launches "
                                     f"{l1} vs {l0}, logits equal "
                                     f"{np.array_equal(y1, y0)}")
            runs[f"dp {name} {'auto' if fusion else 'off'}"] = l1
            print(f"distributed: {label} INT4 full width, 16 requests, "
                  f"SNNServeEngine(data_parallel=True) on "
                  f"{len(eng.devices)} replica(s) {eng.devices}, buckets "
                  f"{eng.buckets}: logits bit-equal to data_parallel="
                  f"False, launches {l1} (the same); {r1:.1f} images/s vs "
                  f"{r0:.1f} images/s [{card}]", flush=True)

        # 6. the tensor-parallel serve steps
        tp_runs, ctx = _tp_serve(dev, card, mesh, "olmo-1b")
        runs.update(tp_runs)
        # a decode step makes 2 all-reduces a layer and one for the
        # embedding
        _time_all_reduce(dev, card, ctx, (8, 1, cfg.d_model))

        # 7. the MoE family on the route: granite-moe-3b-a800m (d 1536,
        # 40 experts top-8, d_ff_expert 512) at 8 of its 32 layers, train
        # and serve (the command's time: the SSM and hybrid steps below
        # run at the depths their gates ask for)
        t_moe = time.perf_counter()
        runs.update(_tp_family(dev, card, mesh, "granite-moe-3b-a800m",
                               "experts", 8, 8))
        print(f"distributed: the MoE steps {time.perf_counter() - t_moe:.1f} "
              f"s", flush=True)

        # 8. the SSM and hybrid families on the route: mamba2-1.3b (64
        # SSM heads, in_proj 2048 -> 8512) at full depth, hymba-1.5b's
        # train step at 8 of its 32 layers (the command's time)
        t_ssm = time.perf_counter()
        runs.update(_tp_family(dev, card, mesh, "mamba2-1.3b", "ssm"))
        runs.update(_tp_family(dev, card, mesh, "hymba-1.5b", "ssm", 8))
        print(f"distributed: the SSM and hybrid steps "
              f"{time.perf_counter() - t_ssm:.1f} s", flush=True)

        # 9. the audio family on the route: whisper-base (6 encoder and 6
        # decoder layers, d 512, 8 heads) at full depth, its encoder over
        # WHISPER_FRAMES frames a row
        t_audio = time.perf_counter()
        runs.update(_tp_family(dev, card, mesh, "whisper-base", "mlp"))
        print(f"distributed: the audio steps "
              f"{time.perf_counter() - t_audio:.1f} s", flush=True)
    finally:
        St.tp_for_step = tp_for_step
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return runs


def _dryrun_cell():
    """The dry run's card cell: the distributed phase's olmo-1b (full
    width, 16 layers, bf16, W4 QAT), batch 8 x 128, with the dry run's
    cell rules (remat ``"dots"`` for a train step)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import cell_config
    from repro_torch.quant.formats import PrecisionConfig

    shape = ShapeConfig("chip_8x128", 128, 8, "train")
    cfg = dataclasses.replace(get_config("olmo-1b"), precision=PrecisionConfig(
        bits=4, group_size=-1))
    return cell_config(cfg, shape), shape


def dryrun_one_rank(out_path):
    """``python chip_smoke.py --dryrun-one-rank OUT``: the card cell
    (:func:`_dryrun_cell`) dry-run on a one-rank fake group and a (1, 1)
    mesh, through the counting functions ``run_cell_cfg`` uses; writes
    the counts and the FLOPs of each op to ``OUT`` (JSON).  Runs in a
    process of its own: the fake group must not meet the card's NCCL
    one."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh

    cfg, shape = _dryrun_cell()
    D.fake_group(1)
    mesh = make_host_mesh(1)
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args, _ = D.place_cell(cfg, shape, mesh)
        walker = D.CellWalker(args)
        with walker:
            fn(*args)
    rec = {"flops_per_device": walker.flops,
           "hbm_bytes_est": walker.hbm,
           "argument_size_in_bytes": walker.arg_bytes,
           "temp_size_in_bytes": walker.peak,
           "collective_bytes": walker.colls,
           "flops_by_op": walker.flops_by_op,
           "wall_s": time.perf_counter() - t0}
    Path(out_path).write_text(json.dumps(rec))
    return 0


def start_dryrun_host():
    """Start the dry run's host work, which needs no card: ``python -m
    repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --force``
    then ``--roofline`` (one shell), and the one-rank dry run
    (:func:`dryrun_one_rank`) beside them; subprocesses, as a fake
    process group must not meet this process's NCCL group.  Their output
    goes to a temporary directory.  :func:`main` starts them beside the
    kernel build and waits for them before the first timed phase, so
    that no timed phase shares the host's CPU with them."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    atexit.register(shutil.rmtree, tmp, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cli = shlex.join([sys.executable, "-m", "repro_torch.launch.dryrun",
                      "--arch", "olmo-1b", "--shape", "train_4k"])
    out = {k: shlex.quote(str(tmp / f"{k}.out"))
           for k in ("force", "roofline")}
    procs = {"cli": subprocess.Popen(
        ["/bin/sh", "-c", f"{cli} --force > {out['force']} 2>&1 && "
                          f"{cli} --roofline > {out['roofline']} 2>&1"],
        env=env, cwd=ROOT)}
    with open(tmp / "one_rank.err", "w") as err:
        procs["one_rank"] = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--dryrun-one-rank", str(tmp / "one_rank.json")],
            stdout=subprocess.DEVNULL, stderr=err, env=env, cwd=ROOT)
    return {"tmp": tmp, "procs": procs}


def stop_dryrun_host(host):
    """Kill what :func:`start_dryrun_host` started and is still running."""
    for proc in host["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dryrun_phase(dev, card, host):
    """The device-free dry run (``launch/dryrun.py``), then the dry run
    held against the card.

    1. ``python -m repro_torch.launch.dryrun --arch olmo-1b --shape
       train_4k --force``, then ``--roofline`` for the same cell (its
       record reused): subprocesses (a fake process group of 256 ranks
       must not meet this process's NCCL group), full depth, the fake
       16 x 16 mesh, on the host.  Gate: exit 0, ``ok`` records and the
       ``[ROOF]`` line, and arguments + temp under 80 GB a device (the
       step is tensor-parallel over ``model``).  Prints the record's
       numbers (a host run of a device-free tool: its wall time is the
       host's) and ``flops_per_device`` over a 256th of the cell's
       global FLOPs (the roofline's ``hlo_flops_global``).
    2. The card cell (:func:`_dryrun_cell`) dry-run on a one-rank fake
       group (:func:`dryrun_one_rank`, a subprocess), then the real
       sharded step on the card as one NCCL rank on a (1, 1) mesh, the
       same params, moments and batch placed by the same specs.  Gates:
       ``flops_per_device`` equal to ``count_fn_flops`` of the real step
       (where the card dispatches other ATen ops, they are named and the
       two held within 1e-3); ``argument_size_in_bytes`` equal to the
       real inputs' bytes; the predicted peak (arguments + temp) within
       25% of the step's ``max_memory_allocated`` over what was
       allocated before the inputs.  Prints the dry run's ``t_comp``
       and ``t_mem`` on one H100 beside the step's device ms
       (torch.profiler)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.perfmodel import flops as F
    from repro_torch.perfmodel.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.train import optimizer as opt

    t_phase = time.perf_counter()
    gib = 2 ** 30
    tmp, procs = host["tmp"], host["procs"]

    # 1. the CLI on the fake 16 x 16 mesh
    for extra in ("force", "roofline"):
        log = tmp / f"{extra}.out"
        text = log.read_text() if log.exists() else ""
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("[OK ]", "[FAIL]", "[ROOF"))]
        if procs["cli"].returncode or not lines:
            raise AssertionError(f"dryrun --{extra}: exit "
                                 f"{procs['cli'].returncode}\n"
                                 f"{text[-3000:]}")
        print(f"dryrun: python -m repro_torch.launch.dryrun --arch olmo-1b "
              f"--shape train_4k --{extra} (run beside the kernel build): "
              + " | ".join(lines), flush=True)
    rec = json.loads((D.RESULTS_DIR / "olmo-1b__train_4k__pod16x16.json")
                     .read_text())
    roof = json.loads((D.RESULTS_DIR.parent / "roofline" /
                       "olmo-1b__train_4k__16x16.json").read_text())
    if not (rec.get("ok") and roof.get("ok")) or \
            not any(ln.startswith("[ROOF]") for ln in lines):
        raise AssertionError(f"dryrun: record ok {rec.get('ok')} "
                             f"({rec.get('error')}), roofline ok "
                             f"{roof.get('ok')} ({roof.get('error')})")
    colls = ", ".join(f"{k} {v / gib:.3f} GiB" for k, v in
                      rec["collective_bytes"].items())
    held = rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"]
    split = rec["flops_per_device"] / (roof["hlo_flops_global"] / 256)
    print(f"dryrun: olmo-1b train_4k on the fake 16 x 16 mesh, full depth "
          f"(a host run of the device-free tool; wall {rec['wall_s']} s, "
          f"build {rec['lower_s']} s, walk {rec['compile_s']} s): "
          f"flops_per_device {rec['flops_per_device']:.4e}, hbm_bytes_est "
          f"{rec['hbm_bytes_est']:.4e}, collectives: {colls}; arguments "
          f"{rec['argument_size_in_bytes'] / gib:.2f} GiB, temp "
          f"{rec['temp_size_in_bytes'] / gib:.2f} GiB a device, "
          f"{held / 1e9:.2f} GB in all (the H100 holds 80 GB); "
          f"flops_per_device / (the cell's {roof['hlo_flops_global']:.4e} "
          f"/ 256) = {split:.4f}; roofline on 256 H100s (data-sheet "
          f"rates): compute {roof['compute_s']:.4f} s, memory "
          f"{roof['memory_s']:.4f} s, collective {roof['collective_s']:.4f}"
          f" s -> {roof['bottleneck']}", flush=True)
    if held >= 80e9:
        raise AssertionError(f"dryrun: olmo-1b train_4k holds "
                             f"{held / 1e9:.2f} GB a device, over 80 GB")

    # 2. the dry run against the card, one rank
    if procs["one_rank"].returncode:
        raise AssertionError(
            f"one-rank dry run: exit {procs['one_rank'].returncode}\n"
            f"{(tmp / 'one_rank.err').read_text()[-3000:]}")
    fake = json.loads((tmp / "one_rank.json").read_text())
    cfg, shape = _dryrun_cell()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        params = transformer.init(0, cfg, device=dev)
        params = shd.distribute(params, shd.to_shardings(
            shd.param_specs(params, mesh), mesh))
        ostate = opt.init(params)
        batch = {k: shd.place(v.to(torch.int32), shd.NamedSharding(
            mesh, shd.batch_spec(k, v.shape, mesh)))
            for k, v in _lm_batch(cfg, shape.global_batch,
                                  shape.seq_len, 0, dev).items()}
        args = (params, ostate, batch)
        step = make_train_step(cfg, opt.OptConfig(),
                               tensor_parallel=True)
        arg_bytes = D.nbytes(args)

        real_flops = F.count_fn_flops(step, *args)
        by_op = {}
        if real_flops != fake["flops_per_device"]:
            class Tally(F._FlopCounter):
                """The FLOPs of each op, by name."""

                def charge(self, func, a, o):
                    f = F._op_flops(func, a, o)
                    key = func.overloadpacket.__name__
                    by_op[key] = by_op.get(key, 0) + f

            with Tally():
                step(*args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        dev_ms = _device_ms(lambda: step(*args), reps=2)
        del params, ostate, batch, args
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    rel = abs(real_flops - fake["flops_per_device"]) / real_flops
    differ = {k: (fake["flops_by_op"].get(k, 0), by_op.get(k, 0))
              for k in set(by_op) | set(fake["flops_by_op"]) if by_op
              and fake["flops_by_op"].get(k, 0) != by_op.get(k, 0)}
    predicted = fake["argument_size_in_bytes"] + fake["temp_size_in_bytes"]
    t_comp = fake["flops_per_device"] / PEAK_FLOPS * 1e3
    t_mem = fake["hbm_bytes_est"] / HBM_BW * 1e3
    print(f"dryrun: olmo-1b full width ({cfg.n_layers} layers, {cfg.dtype}, "
          f"W4 QAT, remat {cfg.remat}), batch {shape.global_batch} x "
          f"{shape.seq_len}, one rank: dry run (a walk of "
          f"{fake['wall_s']:.1f} s on the host, beside the kernel build, a "
          f"one-rank fake group) against the sharded step on the card "
          f"[{card}]: flops {fake['flops_per_device']:.6e} vs "
          f"{real_flops:.6e} (relative {rel:.2e}; ops that differ: "
          f"{differ or 'none'}); argument bytes "
          f"{fake['argument_size_in_bytes']} vs {arg_bytes}; predicted "
          f"peak {predicted / gib:.3f} GiB (arguments "
          f"{fake['argument_size_in_bytes'] / gib:.3f} + temp "
          f"{fake['temp_size_in_bytes'] / gib:.3f}) vs "
          f"max_memory_allocated {peak / gib:.3f} GiB over the "
          f"{before / gib:.3f} GiB held before ({(predicted - peak) / peak:+.1%}"
          f"); t_comp {t_comp:.2f} ms and t_mem {t_mem:.2f} ms on one H100's "
          f"data-sheet rates vs the step's device time {dev_ms:.2f} ms "
          f"(torch.profiler)", flush=True)
    if rel > 1e-3:
        raise AssertionError(f"dry-run flops {fake['flops_per_device']} vs "
                             f"the card's {real_flops}: {differ}")
    if fake["argument_size_in_bytes"] != arg_bytes:
        raise AssertionError("dry-run argument bytes differ from the card's")
    if abs(predicted - peak) > 0.25 * peak:
        raise AssertionError(f"predicted peak {predicted} vs "
                             f"max_memory_allocated {peak}: over 25%")
    print(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # full fp32 for the float stem and readout on both paths
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from repro_torch.kernels import build

    # the dry run's host work needs no card: it runs beside the build,
    # and is done before the first timed phase
    dry_host = start_dryrun_host()
    try:
        t0 = time.perf_counter()
        logs = build.build_all()
        print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, "
              f"sm_90a, {len(logs)} sources in parallel; the dry run's "
              f"host work beside it)", flush=True)
        t0 = time.perf_counter()
        for proc in dry_host["procs"].values():
            proc.wait(timeout=600)
        print(f"the dry run's host work: done {time.perf_counter() - t0:.1f}"
              f" s after the build", flush=True)
    finally:
        stop_dryrun_host(dry_host)
    for name, log in logs.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # the mangled kernel name, up to its template arguments
                entry = line.split("'")[1][:90]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}", flush=True)

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    # (h, w, c_in, c_out, k, stride), h/w the input plane
    conv_geoms = {
        "convs.1": (32, 32, 64, 64, 3, 1),
        "convs.2": (16, 16, 64, 128, 3, 1),
        "convs.3": (16, 16, 128, 128, 3, 1),  # also resnet18 blocks.2.conv2
        "convs.4": (8, 8, 128, 256, 3, 1),
        "blocks.2.conv1": (32, 32, 64, 128, 3, 2),
        "blocks.2.proj": (32, 32, 64, 128, 1, 2),
        "blocks.4.conv1": (16, 16, 128, 256, 3, 2),
        "blocks.4.conv2": (8, 8, 256, 256, 3, 1),
        "blocks.4.proj": (16, 16, 128, 256, 1, 2),
        "blocks.6.conv1": (8, 8, 256, 512, 3, 2),
        "blocks.6.conv2": (4, 4, 512, 512, 3, 1),
        "blocks.6.proj": (8, 8, 256, 512, 1, 2),
        "s2_3x3": (16, 16, 64, 128, 3, 2),
        "s2_1x1": (16, 16, 64, 128, 1, 2),
        "vgg16.convs.7": (4, 4, 256, 512, 3, 1),
        "vgg16.convs.10": (2, 2, 512, 512, 3, 1),   # also .11, .12
        "ragged": (9, 7, 40, 36, 3, 1),
    }
    nce_geoms = {"fc1": (8, 4096, 512), "vgg16.fc1": (8, 2048, 512),
                 "ragged": (8, 1000, 100)}
    # (hw, c_in, members): the vgg9 chain and each distinct resnet18 body
    group_chains = {
        "vgg9": (32, 64, [64, "P", 128, 128, "P", 256, "P"]),
        "blocks.0": (32, 64, [64, 64]),       # also blocks.1
        "blocks.3": (16, 128, [128, 128]),
        "blocks.5": (8, 256, [256, 256]),
        "blocks.7": (4, 512, [512, 512]),
        "ragged": (12, 20, [40, "P", 36, "P"]),
    }
    # the geometries each main path launches a kernel at, per forward
    paths = {
        "vgg9 off": {"fused_conv": ["convs.1", "convs.2", "convs.3",
                                    "convs.4"], "fused_nce": ["fc1"]},
        "vgg9 auto": {"fused_group": ["vgg9"], "fused_nce": ["fc1"]},
        "vgg9 async": {"fused_conv": ["convs.1", "convs.2", "convs.3",
                                      "convs.4"], "fused_nce": ["fc1"]},
        "vgg9 trained off": {"fused_conv": ["convs.1", "convs.2", "convs.3",
                                            "convs.4"], "fused_nce": ["fc1"]},
        "vgg9 trained auto": {"fused_group": ["vgg9"], "fused_nce": ["fc1"]},
        # convs.5-6 and .8-9 at resnet18's blocks.4.conv2 / .6.conv2
        "vgg16 off": {"fused_conv": [
            "convs.1", "convs.2", "convs.3", "convs.4", "blocks.4.conv2",
            "blocks.4.conv2", "vgg16.convs.7", "blocks.6.conv2",
            "blocks.6.conv2", "vgg16.convs.10", "vgg16.convs.10",
            "vgg16.convs.10"], "fused_nce": ["vgg16.fc1"]},
        # the obs phase: a telemetry and an attribution pass of B=2 each;
        # the launcher: warmup, both passes and 16 requests
        "obs vgg9 off": {"fused_conv": ["convs.1", "convs.2", "convs.3",
                                        "convs.4"], "fused_nce": ["fc1"]},
        "obs vgg9 auto": {"fused_group": ["vgg9"], "fused_nce": ["fc1"]},
        "obs resnet18 auto": {
            "fused_group": ["blocks.0", "blocks.0", "blocks.3", "blocks.5",
                            "blocks.7"],
            "fused_conv": ["blocks.2.conv1", "convs.3", "blocks.2.proj",
                           "blocks.4.conv1", "blocks.4.conv2",
                           "blocks.4.proj", "blocks.6.conv1",
                           "blocks.6.conv2", "blocks.6.proj"]},
        "obs launcher vgg9 auto": {"fused_group": ["vgg9"],
                                   "fused_nce": ["fc1"]},
        # the distributed phase: SNNServeEngine(data_parallel=True)
        "dp vgg9 off": {"fused_conv": ["convs.1", "convs.2", "convs.3",
                                       "convs.4"], "fused_nce": ["fc1"]},
        "dp vgg9 auto": {"fused_group": ["vgg9"], "fused_nce": ["fc1"]},
        "dp resnet18 auto": {
            "fused_group": ["blocks.0", "blocks.0", "blocks.3", "blocks.5",
                            "blocks.7"],
            "fused_conv": ["blocks.2.conv1", "convs.3", "blocks.2.proj",
                           "blocks.4.conv1", "blocks.4.conv2",
                           "blocks.4.proj", "blocks.6.conv1",
                           "blocks.6.conv2", "blocks.6.proj"]},
        "resnet18 auto": {
            "fused_group": ["blocks.0", "blocks.0", "blocks.3", "blocks.5",
                            "blocks.7"],
            "fused_conv": ["blocks.2.conv1", "convs.3", "blocks.2.proj",
                           "blocks.4.conv1", "blocks.4.conv2",
                           "blocks.4.proj", "blocks.6.conv1",
                           "blocks.6.conv2", "blocks.6.proj"]},
        # per unfused rollout step of each geometry; per decode step
        "nce step": {"spike_matmul": ["fc1", "bench"],
                     "lif_step": ["fc1", "bench"]},
        "olmo serve": {"packed_qmatmul": ["decode layer"] * 16},
        "olmo int4-kv": {"packed_qmatmul": ["decode layer"] * 16,
                         "kv_attention": ["decode"] * 16},
        # the distributed phase's tensor-parallel decode steps (float
        # linears): the same cache geometry as olmo int4-kv's
        "dist tp olmo-1b int4-kv": {"kv_attention": ["decode"] * 16},
        "dist tp granite-moe-3b-a800m int4-kv": {
            "kv_attention": ["granite tp decode"] * 8},
        "dist tp hymba-1.5b int4-kv": {
            "kv_attention": ["hymba tp decode"] * 32},
        # the serve phase's 16 prefills (36-251 tokens at seed 0; those
        # under 64 tokens take the gemv variant), the uniform 8 x 512 one
        "olmo serve prefill": {"packed_qmatmul": [
            "serve prefills gemv", "serve prefills mma"] * 16},
        "olmo int4-kv prefill": {
            "packed_qmatmul": ["prefill layer m4096"] * 16},
        # the trained 2-layer checkpoint served: its prefills and decode
        # steps counted together, ms per decode step
        "olmo train → serve": {"packed_qmatmul": ["decode layer"] * 2},
        # the families phase, per decode step (its prefills' launches are
        # counted under "<path> prefill", with no geometry of their own)
        "granite serve": {"packed_qmatmul": ["granite decode layer"] * 32},
        "mamba2 serve": {"packed_qmatmul": ["mamba2 decode layer"] * 48},
        "hymba serve": {"packed_qmatmul": ["hymba decode layer"] * 32},
        "hymba int4-kv": {"packed_qmatmul": ["hymba decode layer"] * 32,
                          "kv_attention": ["hymba decode"] * 32},
        "paligemma int4-kv": {
            "packed_qmatmul": ["paligemma decode layer"] * 18,
            "kv_attention": ["paligemma decode"] * 18},
        "whisper decode": {"packed_qmatmul": ["whisper decode layer"] * 6},
    }

    def main_names(kernel):
        return {n for p in paths.values() for n in p.get(kernel, [])}

    rows, errs = {}, {}
    rows["fused_conv"], errs["fused_conv"] = conv_phase(
        dev, gen, conv_geoms, main_names("fused_conv"))
    rows["fused_nce"], errs["fused_nce"] = nce_phase(
        dev, gen, nce_geoms, main_names("fused_nce"))
    rows["fused_group"], errs["fused_group"] = group_phase(
        dev, gen, group_chains, main_names("fused_group"))
    rows_nce, runs = nce_step_phase(dev, gen)
    rows.update(rows_nce)
    errs["spike_matmul"] = errs["lif_step"] = 0   # asserted bit-exact
    runs = {"nce step": runs}
    runs["vgg9 off"], flat_logits = serve_phase(
        dev, "vgg9", (), {"fused_conv": 4, "fused_nce": 1})
    runs["vgg9 auto"], _ = serve_phase(
        dev, "vgg9", "auto", {"fused_group": 1, "fused_nce": 1},
        same_as=flat_logits)
    runs["resnet18 auto"], _ = serve_phase(
        dev, "resnet18", "auto", {"fused_group": 5, "fused_conv": 9})
    runs["vgg16 off"] = vgg16_serve_phase(dev)
    runs["vgg9 async"] = async_serve_phase(dev, smi)
    runs.update(snn_train_phase(dev, smi))

    from repro_torch.configs import get_config
    from repro_torch.models import transformer

    cfg = get_config("olmo-1b")
    t0 = time.perf_counter()
    params = pack_lm(transformer.init(0, cfg, device=dev), 4)
    torch.cuda.synchronize()
    print(f"olmo-1b full width ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}): init from seed "
          f"0 and W4 packing of the {7 * cfg.n_layers} linears in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    lm_rows, lm_errs = lm_kernel_phase(dev, cfg, params)
    fam_rows, fam_errs = families_kernel_phase(dev)
    for name, geos in fam_rows.items():
        lm_rows[name].update(geos)
        lm_errs[name] = max(lm_errs[name], fam_errs[name])
    rows.update(lm_rows)
    errs.update(lm_errs)
    for path, phase in (("olmo serve", lm_serve_phase),
                        ("olmo int4-kv", lm_int4_kv_phase)):
        launches, pre, _ = phase(dev, cfg, params)
        # the prefills' launches, counted in the phase, apart
        runs[f"{path} prefill"] = pre
        runs[path] = {k: v - pre.get(k, 0) for k, v in launches.items()}
    del params
    torch.cuda.empty_cache()
    runs["olmo train → serve"] = train_phase(dev, smi)
    runs.update(families_phase(dev, smi))
    # last: it profiles whole launcher runs (every host thread), after
    # the phases whose profiles count kernel events
    runs.update(obs_phase(dev, smi))
    # after every other phase, so that their numbers do not move
    runs.update(distributed_phase(dev, smi))
    dryrun_phase(dev, smi, dry_host)
    print("kernel record: ms, plain_ms, library_ms and bound_ms are device "
          "time per call (torch.profiler), summed over the distinct "
          "geometries the main paths launch the kernel at (one call each; "
          "packed_qmatmul: the 7 linears of one olmo-1b layer at M=8, at "
          "each serve prompt length and at M=4096; geometries also holds "
          "M=256, which no path launches); launches are summed over the "
          "paths that launch the kernel (the four served SNN paths, 16 "
          "requests in 2 batches each, and the distributed phase's three "
          "data-parallel ones, the same; the async vgg9 path, 128 requests; "
          "the obs phase's telemetry and attribution passes, one B=2 "
          "forward each, on vgg9 off/auto and resnet18 auto, and its "
          "launcher run, vgg9 auto: 4 warmup forwards, both passes and 16 "
          "requests; "
          "the vgg9 trained on the card, served unfused and fused, 16 "
          "requests in 2 batches each; "
          "the NCE step path's unfused rollouts, whose lif_step row times "
          "the packed entry they launch; the two olmo-1b runs, their "
          "prefills counted apart; the trained 2-layer olmo served, its "
          "prefills and decode steps together; the families phase's six "
          "runs, their prefills counted apart; packed_qmatmul also one "
          "decode layer of each family at M=8, kv_attention also Hymba's "
          "and PaliGemma's INT4 caches and the distributed phase's 32 "
          "tensor-parallel olmo-1b, granite-moe and hymba decode steps "
          "over INT4 KV, granite's and hymba's at their own geometry); "
          "paths gives each path's launches and its kernel ms per B=8 "
          "forward (NCE: per step of each geometry; olmo and the families: "
          "per decode step, per INT4-KV prefill, and over the serve "
          "phase's 16 prefills)", flush=True)

    def record(name, source, replaces):
        kr = {g: r for g, r in rows[name].items() if g in main_names(name)}
        t_b = sum(r["bytes_ms"] for r in kr.values())
        t_o = sum(r["ops_ms"] for r in kr.values())
        lib = [r["library_ms"] for r in kr.values()]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(run.get(name, 0) for run in runs.values()),
                "max_abs_err": errs[name],
                "ms": sum(r["ms"] for r in kr.values()),
                "plain_ms": sum(r["plain_ms"] for r in kr.values()),
                "bound_ms": sum(r["bound_ms"] for r in kr.values()),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": None if None in lib else sum(lib),
                "paths": {p: {"launches": runs[p].get(name, 0),
                              "ms": sum(kr[g]["ms"] for g in geo[name])}
                          for p, geo in paths.items() if name in geo},
                "geometries": {g: {k: r[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "variant",
                    "chain_ms", "int32_ms", "step_ms", "step_wall_ms",
                    "earlier_step_ms", "earlier_step_wall_ms")
                    if k in r} for g, r in rows[name].items()}}

    print(json.dumps({"kernels": [
        record("fused_conv", "src/repro_torch/kernels/csrc/fused_conv.cu",
               "src/repro/kernels/fused_conv/kernel.py:197"),
        record("fused_nce", "src/repro_torch/kernels/csrc/fused_nce.cu",
               "src/repro/kernels/fused_nce/kernel.py:136"),
        record("fused_group", "src/repro_torch/kernels/csrc/fused_group.cu",
               "src/repro/kernels/fused_group/kernel.py:234"),
        record("spike_matmul",
               "src/repro_torch/kernels/csrc/spike_matmul.cu",
               "src/repro/kernels/spike_matmul/kernel.py:81"),
        record("lif_step", "src/repro_torch/kernels/csrc/lif_step.cu",
               "src/repro/kernels/lif_step/kernel.py:67"),
        record("packed_qmatmul",
               "src/repro_torch/kernels/csrc/packed_qmatmul.cu",
               "src/repro/kernels/packed_qmatmul/kernel.py:108"),
        record("kv_attention",
               "src/repro_torch/kernels/csrc/kv_attention.cu",
               "src/repro/kernels/kv_attention/kernel.py:120"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-one-rank"]:
        sys.exit(dryrun_one_rank(sys.argv[2]))
    sys.exit(main())
