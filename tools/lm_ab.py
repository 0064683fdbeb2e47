#!/usr/bin/env python3
"""chip_smoke.py's two olmo-1b measurements, for checkouts compared on one
NVIDIA GPU: the LM kernel phase (``packed_qmatmul`` and ``kv_attention``
against their plain versions, timed cold) and the INT4-KV phase (8 x 512
prefill, 32 decode steps: prefill ms, decode ms per step, a profiled
decode step).

    python3 tools/lm_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout of this repository (``.`` for
this one); each runs in a process of its own, in the order given, with
its own ``chip_smoke.py`` and its own build of the two kernels (a pair of
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
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import transformer

t0 = time.perf_counter()
build.build_all(("packed_qmatmul", "kv_attention"))
print(f"build {time.perf_counter() - t0:.2f} s", flush=True)
dev = torch.device("cuda", 0)
cfg = get_config("olmo-1b")
params = chip_smoke.pack_lm(transformer.init(0, cfg, device=dev), 4)
chip_smoke.lm_kernel_phase(dev, cfg, params)
chip_smoke.lm_int4_kv_phase(dev, cfg, params)
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
