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
   vgg9 and resnet18) plus stride-2 and ragged cases.  Membranes and
   packed words must be bit-exact.  Times the kernel, the plain version
   and one library call that does only the accumulate, each as device
   time per call from torch.profiler (the wrapper's wall time per call
   from CUDA events is printed beside), and works out the bound (bytes
   over 3.35 TB/s vs the adds this data needs over 1979 T/s).  The
   ``fused_group`` phase also times the per-layer ``fused_conv`` + pool
   chain that fusion replaces, on the same input.
3. End to end, three paths, each ``graph_init`` (seed 0) -> ``deploy`` ->
   ``save`` -> ``load`` at full width, INT4, then
   ``SNNServeEngine(max_batch=8)`` serves 16 requests with every launch
   count set to 0 just before and read just after:
   - vgg9 ``fusion=()``: 4 ``fused_conv`` + 1 ``fused_nce`` per batch;
   - vgg9 ``fusion="auto"``: 1 ``fused_group`` + 1 ``fused_nce``, logits
     also equal to the ``fusion=()`` engine's;
   - resnet18 ``fusion="auto"``: 5 ``fused_group`` + 9 ``fused_conv``.
   Every request's logits must equal the same forward walked layer by
   layer with the plain versions on the card (TF32 off for both), and
   every packed layer's input spike rate there must be > 0.

Exits non-zero on any failure and without a card.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, same source


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


def _device_ms(fn, match="", reps=10):
    """Device time per call of ``fn``: the summed time of the CUDA kernels
    (and copies) it runs, from torch.profiler, counting only events whose
    name contains ``match``.  Falls back to the CUDA-event wall time when
    the profiler reports no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and match in e.key)
    if us <= 0:
        print(f"  (profiler gave no device time for {match or 'call'}; "
              f"CUDA-event wall time instead)", flush=True)
        return _median_ms(fn)
    return us / reps / 1e3


def _bound_ms(nbytes, adds):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = adds / H100_INT8_OPS_PER_S * 1e3
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
                if name not in main_names or bits != 4 or not soft:
                    continue
                # timing and bound at the main path's configuration
                run = lambda: ops.fused_conv_rollout(planes, qct, **kw)
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
    print(f"fused_conv: {checks} checks bit-exact", flush=True)
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


def plain_forward(model, images):
    """The packaged forward walked layer by layer with the plain kernel
    versions (fusion groups lowered member by member), recording each
    packed layer's input spike rate."""
    import torch

    from repro_torch.core import packing
    from repro_torch.core.snn_layers import (
        maxpool_t, readout_apply, spiking_conv_apply)
    from repro_torch.graph import build_graph
    from repro_torch.graph.spec import (
        Conv, Dense, Encode, Pool, Readout, Residual, get_path)
    from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch
    from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch

    cfg, lif = model.cfg, model.cfg.lif
    rates = {}

    def conv(name, x):
        lp = model.layers[name]
        rates[name] = float(x.float().mean())
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
            rates[node.name] = float(x.float().mean())
            _, out = fused_nce_rollout_torch(
                packing.pack_bool(x), lp.qt, d_in=node.d_in,
                leak_shift=lif.leak_shift, threshold_q=lp.theta_q,
                soft_reset=lif.soft_reset)
            x = packing.unpack_bool(out, node.d_out)
            rates[f"{node.name}.out"] = float(x.float().mean())
        elif isinstance(node, Readout):
            if node.spatial_mean:
                x = torch.mean(x.to(torch.float32), dim=(2, 3))
            return readout_apply(get_path(model.float_params, node.name),
                                 x), rates
    raise AssertionError("graph has no readout")


def profile_batch(model, x, reps=5):
    """Where a B=8 packaged forward spends device time: torch.profiler
    over ``reps`` forwards, the top ops by device time, and the device's
    busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model.apply(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model.apply(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    if not rows:
        print("profile: no device time reported (not measured)", flush=True)
        return
    print(f"profile of {reps} B=8 forwards: wall {wall_us / reps:.1f} us "
          f"per forward, device busy {busy_us / reps:.1f} us "
          f"({100 * busy_us / wall_us:.1f}% of wall, the profiler's own "
          f"host cost included); top kernels (us per forward, launches "
          f"per forward):", flush=True)
    for dev_us, count, key in rows[:12]:
        print(f"  {dev_us / reps:9.1f}  {count // reps:4d}  {key[:90]}",
              flush=True)


def serve_phase(dev, model_name, fusion, per_batch, same_as=None):
    """Serve 16 full-width INT4 requests of ``model_name`` with ``fusion``
    through the engine (max_batch=8); assert ``per_batch`` launches of
    each kernel per batch (counts set to 0 just before, read just after)
    and every request's logits equal to the plain path's (and to
    ``same_as``, another path's logits, when given).  Returns the launch
    counts and the logits."""
    import numpy as np
    import torch

    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config,
        load)
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.fused_group import ops as group_ops
    from repro_torch.kernels.fused_nce import ops as nce_ops
    from repro_torch.models import snn_cnn

    label = f"{model_name} fusion={fusion!r}"
    cfg = deploy_config(model_name, 4, smoke=False, fusion=fusion)
    params = snn_cnn.init(0, cfg, device=dev)
    model = deploy(params, cfg, device=dev)
    pkg_dir = ROOT / "build" / "chip_smoke"
    pkg_dir.mkdir(parents=True, exist_ok=True)
    tag = "auto" if fusion else "off"
    path = model.save(str(pkg_dir / f"{model_name}_w4_{tag}_full.npz"))
    model = load(path, device=dev)
    print(f"{label} INT4 full width: {len(model.layers)} packed layers, "
          f"{model.nbytes_packed() / 1e6:.3f} MB packed, saved and reloaded "
          f"({Path(path).stat().st_size} B npz)", flush=True)

    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=8), device=dev)
    if fusion:
        print(eng.graph_summary(), flush=True)
    eng.warmup()
    rng = np.random.default_rng(0)
    images = rng.random((16, cfg.img_size, cfg.img_size,
                         cfg.in_channels)).astype(np.float32)
    counters = {"fused_conv": conv_ops.fused_conv_rollout,
                "fused_nce": nce_ops.fused_nce_rollout,
                "fused_group": group_ops.fused_group_rollout}
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

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(logs)} sources in parallel)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

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
        "ragged": (9, 7, 40, 36, 3, 1),
    }
    nce_geoms = {"fc1": (8, 4096, 512), "ragged": (8, 1000, 100)}
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
        "resnet18 auto": {
            "fused_group": ["blocks.0", "blocks.0", "blocks.3", "blocks.5",
                            "blocks.7"],
            "fused_conv": ["blocks.2.conv1", "convs.3", "blocks.2.proj",
                           "blocks.4.conv1", "blocks.4.conv2",
                           "blocks.4.proj", "blocks.6.conv1",
                           "blocks.6.conv2", "blocks.6.proj"]},
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
    runs = {}
    runs["vgg9 off"], flat_logits = serve_phase(
        dev, "vgg9", (), {"fused_conv": 4, "fused_nce": 1})
    runs["vgg9 auto"], _ = serve_phase(
        dev, "vgg9", "auto", {"fused_group": 1, "fused_nce": 1},
        same_as=flat_logits)
    runs["resnet18 auto"], _ = serve_phase(
        dev, "resnet18", "auto", {"fused_group": 5, "fused_conv": 9})
    print("kernel record: ms, plain_ms, library_ms and bound_ms are device "
          "time per call (torch.profiler), summed over the distinct "
          "geometries the main paths launch the kernel at (one call each); "
          "launches are summed over the three served paths (16 requests, "
          "2 batches each); paths gives each path's launches and its "
          "kernel ms per B=8 forward", flush=True)

    def record(name, source, replaces):
        kr = rows[name]
        t_b = sum(r["bytes_ms"] for r in kr.values())
        t_o = sum(r["ops_ms"] for r in kr.values())
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(run[name] for run in runs.values()),
                "max_abs_err": errs[name],
                "ms": sum(r["ms"] for r in kr.values()),
                "plain_ms": sum(r["plain_ms"] for r in kr.values()),
                "bound_ms": sum(r["bound_ms"] for r in kr.values()),
                "bound_by": "bytes" if t_b >= t_o else "operations",
                "library_ms": sum(r["library_ms"] for r in kr.values()),
                "paths": {p: {"launches": runs[p][name],
                              "ms": sum(kr[g]["ms"] for g in geo[name])}
                          for p, geo in paths.items() if name in geo}}

    print(json.dumps({"kernels": [
        record("fused_conv", "src/repro_torch/kernels/csrc/fused_conv.cu",
               "src/repro/kernels/fused_conv/kernel.py:197"),
        record("fused_nce", "src/repro_torch/kernels/csrc/fused_nce.cu",
               "src/repro/kernels/fused_nce/kernel.py:136"),
        record("fused_group", "src/repro_torch/kernels/csrc/fused_group.cu",
               "src/repro/kernels/fused_group/kernel.py:234"),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
