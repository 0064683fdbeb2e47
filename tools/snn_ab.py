#!/usr/bin/env python3
"""chip_smoke.py's SNN measurements, for checkouts compared on one NVIDIA
GPU: the ``fused_nce`` fc1 phase and the ``fused_group`` phase over the
served chains (each kernel against its plain version at bits 2/4/8 and
both resets, then timed at w4, soft reset, B=8, T=4: kernel ms and the
per-layer ``fused_conv`` + pool chain's ms), the ``fused_conv`` phase at
the 12 geometries the served paths launch it at (kernel ms each), the
NCE step phase (``spike_matmul`` and ``lif_step`` ms at vgg9's fc1 and
kernel_bench's NCE geometry, and the step's device and wall ms where the
checkout's phase reports them), then the three served SNN
paths (vgg9 ``fusion=()``, vgg9 ``fusion="auto"``, resnet18
``fusion="auto"``, full width, INT4, ``SNNServeEngine(max_batch=8)``):
images/s of each of 5 rounds of 64 requests (8 batches a round, wall
clock around ``run_until_done``), and p50 / p95 request latency over the
5 rounds.

    python3 tools/snn_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (``.`` for
this one); each runs in a process of its own, in the order given, with
its own ``chip_smoke.py`` and its own build of the kernels (a pair of
runs in the order old, new, new, old cancels a drift of the card or host
over the call).  A checkout's lines are printed after a header naming it
and its run.  Needs a card and nvcc.
"""

import subprocess
import sys
from pathlib import Path

CHILD = r"""
import sys, time
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import numpy as np
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.deploy import (
    SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config)
from repro_torch.kernels import build
from repro_torch.models import snn_cnn

t0 = time.perf_counter()
build.build_all(("fused_conv", "fused_nce", "fused_group",
                 "spike_matmul", "lif_step"))
print(f"build {time.perf_counter() - t0:.2f} s", flush=True)
dev = torch.device("cuda", 0)
gen = torch.Generator().manual_seed(0)
rows, _ = chip_smoke.nce_phase(dev, gen, {"fc1": (8, 4096, 512)}, {"fc1"})
print(f"AB fused_nce fc1 kernel {rows['fc1']['ms']:.4f} ms", flush=True)
chains = {
    "vgg9": (32, 64, [64, "P", 128, 128, "P", 256, "P"]),
    "blocks.0": (32, 64, [64, 64]),
    "blocks.3": (16, 128, [128, 128]),
    "blocks.5": (8, 256, [256, 256]),
    "blocks.7": (4, 512, [512, 512]),
}
rows, _ = chip_smoke.group_phase(dev, gen, chains, set(chains))
for name, r in rows.items():
    print(f"AB fused_group {name} kernel {r['ms']:.4f} ms, per-layer chain "
          f"{r['chain_ms']:.4f} ms", flush=True)
print(f"AB fused_group 5 chains kernel "
      f"{sum(r['ms'] for r in rows.values()):.4f} ms (blocks.0 once)",
      flush=True)
convs = {
    "convs.1": (32, 32, 64, 64, 3, 1),
    "convs.2": (16, 16, 64, 128, 3, 1),
    "convs.3": (16, 16, 128, 128, 3, 1),
    "convs.4": (8, 8, 128, 256, 3, 1),
    "blocks.2.conv1": (32, 32, 64, 128, 3, 2),
    "blocks.2.proj": (32, 32, 64, 128, 1, 2),
    "blocks.4.conv1": (16, 16, 128, 256, 3, 2),
    "blocks.4.conv2": (8, 8, 256, 256, 3, 1),
    "blocks.4.proj": (16, 16, 128, 256, 1, 2),
    "blocks.6.conv1": (8, 8, 256, 512, 3, 2),
    "blocks.6.conv2": (4, 4, 512, 512, 3, 1),
    "blocks.6.proj": (8, 8, 256, 512, 1, 2),
}
rows, _ = chip_smoke.conv_phase(dev, gen, convs, set(convs))
for name, r in rows.items():
    print(f"AB fused_conv {name} kernel {r['ms']:.4f} ms", flush=True)
print(f"AB fused_conv 12 geometries kernel "
      f"{sum(r['ms'] for r in rows.values()):.4f} ms", flush=True)
rows, _ = chip_smoke.nce_step_phase(dev, gen)
for kernel, per in rows.items():
    for name, r in per.items():
        print(f"AB {kernel} {name} kernel {r['ms']:.4f} ms", flush=True)
        if "step_ms" in r:      # checkouts whose step packs in the kernel
            print(f"AB NCE step {name} device {r['step_ms']:.4f} ms, wall "
                  f"{r['step_wall_ms']:.4f} ms", flush=True)

rng = np.random.default_rng(0)
for model_name, fusion in (("vgg9", ()), ("vgg9", "auto"),
                           ("resnet18", "auto")):
    cfg = deploy_config(model_name, 4, smoke=False, fusion=fusion)
    model = deploy(snn_cnn.init(0, cfg, device=dev), cfg, device=dev)
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=8), device=dev)
    eng.warmup()
    images = rng.random((64, cfg.img_size, cfg.img_size,
                         cfg.in_channels)).astype(np.float32)
    ips, lats = [], []
    for rnd in range(5):
        for uid in range(64):
            eng.add_request(SNNRequest(uid=uid, image=images[uid]))
        t = time.perf_counter()
        eng.run_until_done()
        ips.append(64 / (time.perf_counter() - t))
        lats += [eng.done.pop(uid).latency_s * 1e3 for uid in range(64)]
    lats.sort()
    p50 = lats[int(np.ceil(0.5 * len(lats))) - 1]
    p95 = lats[int(np.ceil(0.95 * len(lats))) - 1]
    print(f"AB serve {model_name} fusion={fusion!r}: images/s "
          + " ".join(f"{x:.1f}" for x in ips)
          + f" (median {sorted(ips)[2]:.1f}); latency p50 {p50:.3f} ms, "
          f"p95 {p95:.3f} ms over {len(lats)} requests", flush=True)
"""


def main():
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for i, tree in enumerate(sys.argv[1:], 1):
        root = Path(tree).resolve()
        print(f"=== run {i}: {tree}", flush=True)
        rc = subprocess.run([sys.executable, "-c", CHILD, str(root)],
                            cwd=root).returncode
        if rc:
            print(f"=== run {i}: {tree} failed (exit {rc})", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
