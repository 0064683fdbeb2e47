"""Pipeline-parallel dry run: a train step with the pod axis as GPipe
stages on the fake (pod=2, data=16, model=16) production mesh.

Port of ``repro.launch.pipeline_dryrun``:

  PYTHONPATH=src python -m repro_torch.launch.pipeline_dryrun \\
      [--arch internlm2-20b] [--n-micro 8]

JAX compiles one SPMD program for all 512 devices.  On a fake process
group each rank runs only its own stage, so the tool runs one rank of
each stage, rank 0 (stage 0) and rank 256 (stage 1), each in a process
of its own (``--rank``), through ``distributed/pipeline.py``'s
``make_pipeline_loss`` and AdamW, walked by ``launch/dryrun.py``'s
``CellWalker``.  Each stage's record holds its per-device counts; a
point-to-point receive is a ``collective-permute``, and the two stages'
receives summed are ``inter_pod_bytes``.  Beside them, JAX's formulas:
the data-parallel alternative's inter-pod bytes (``2 * n_params * 4``,
fp32 gradients twice), its ratio to the pipeline's, and the bubble
fraction ``(pods - 1) / (n_micro + pods - 1)``.  Like the dry run, the
tool allocates nothing on any device (no ``device=``).

The record goes to
``build/results_torch/dryrun/<arch>__train_4k__pipeline.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

#: one rank of each stage of the (2, 16, 16) mesh
STAGE_RANKS = (0, 256)


def stage_record(cfg, n_micro: int, rank: int) -> dict:
    """Walk one pipeline train step as ``rank`` of the fake 512-rank
    group: its stage's layers (replicated over ``data`` and ``model``),
    the train_4k batch sliced over ``data``, the GPipe loss, its
    gradients and an AdamW update of the stage's params."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES
    from repro_torch.distributed import pipeline as PP
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as S
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import leaves, unflatten_like

    mesh = D.fake_world(multi_pod=True, rank=rank)
    ocfg = opt.OptConfig()
    with FakeTensorMode():
        params = PP.stage_params(D.fake_tensors(S.param_specs_struct(cfg)),
                                 cfg, mesh)
        ostate = opt.init(params)
        batch = D.fake_tensors(S.train_batch_specs(cfg, SHAPES["train_4k"]))
        loss_fn = PP.make_pipeline_loss(cfg, mesh, n_micro=n_micro,
                                        data_axis="data")

        def train_step(p, o, b):
            flat = leaves(p)
            for t in flat:
                t.requires_grad_(True)
            loss = loss_fn(p, b)
            grads = torch.autograd.grad(loss, flat, materialize_grads=True)
            for t in flat:
                t.requires_grad_(False)
            p, o, m = opt.update(unflatten_like(p, list(grads)), o, p, ocfg)
            m["loss"] = loss.detach()
            return p, o, m

        t0 = time.time()
        _, counts = D.count_step(train_step, (params, ostate, batch))
    stage, lo, hi = PP.stage_bounds(cfg, mesh)
    return {"rank": rank, "stage": stage, "layers": [lo, hi], **counts,
            "wall_s": round(time.time() - t0, 1)}


def pipeline_record(arch: str, cfg, n_micro: int, stages) -> dict:
    """JAX's record from the stages' records: collectives summed over
    the stage ranks, ``inter_pod_bytes`` their ``collective-permute``
    bytes, and JAX's formulas."""
    from repro_torch.launch.dryrun import COLL_KINDS

    n_stages = len(stages)
    colls = {k: sum(s["collective_bytes"].get(k, 0) for s in stages)
             for k in COLL_KINDS + ("total",)}
    permute = colls["collective-permute"]
    # the DP alternative moves ~2x fp32 grads across pods per step
    dp_bytes = 2 * cfg.n_params() * 4
    return {
        "cell": f"{arch}__train_4k__pipeline_pod2x16x16",
        "n_micro": n_micro, "ok": True,
        "hbm_bytes_est": max(s["hbm_bytes_est"] for s in stages),
        "collectives": {k: v for k, v in colls.items() if v},
        "inter_pod_bytes": permute,
        "dp_alternative_inter_pod_bytes": dp_bytes,
        "inter_pod_reduction": dp_bytes / max(permute, 1),
        "bubble_fraction": (n_stages - 1) / (n_micro + n_stages - 1),
        "stages": stages,
    }


def _config(arch: str):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), remat="dots")
    if cfg.norm != "rmsnorm" or cfg.family not in ("dense",):
        raise SystemExit("pipeline demo covers dense rmsnorm archs")
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-20b")
    ap.add_argument("--n-micro", type=int, default=8)
    ap.add_argument("--rank", type=int, default=None,
                    help="walk this one rank and print its stage's record "
                         "(the tool runs one process a stage rank)")
    args = ap.parse_args(argv)
    cfg = _config(args.arch)

    if args.rank is not None:
        print(json.dumps(stage_record(cfg, args.n_micro, args.rank)))
        return

    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pipeline_dryrun",
         "--arch", args.arch, "--n-micro", str(args.n_micro),
         "--rank", str(rank)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in STAGE_RANKS]
    stages = []
    for rank, proc in zip(STAGE_RANKS, procs):
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"stage rank {rank} failed:\n{err[-3000:]}")
        stages.append(json.loads(out.strip().splitlines()[-1]))
    rec = pipeline_record(args.arch, cfg, args.n_micro, stages)
    rec["wall_s"] = round(time.time() - t0, 1)
    from repro_torch.launch.dryrun import RESULTS_DIR

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out = RESULTS_DIR / f"{args.arch}__train_4k__pipeline.json"
    out.write_text(json.dumps(rec, indent=2))
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
