"""The port's dry run (``launch/dryrun.py``) on the CPU.

Anything that starts a fake process group runs in a subprocess under a
timeout (the group is process-global), as ``tests/test_distributed.py``
runs JAX's dry run; each subprocess does several checks and prints one
JSON line, which module-scoped fixtures hand to the tests:

* the walker: a Python loop of 12 matmuls charged 2-4x the HBM bytes of
  a loop of 4 (the counterpart of ``tests/test_perfmodel.py``'s scan
  case), no collectives on one rank, the live-storage peak of a loop
  that frees as it goes; a DTensor split 256 ways: its elementwise op
  charged at the rank's (16, 4) shard, a known all-gather and
  reduce-scatter at their exact output bytes and kinds; the 512-rank
  mesh;
* cells on the fake 16 x 16 mesh: whisper-base ``train_4k`` at full
  depth (``argument_size_in_bytes`` equal to the per-device bytes of
  JAX's param, optimizer and batch specs on an abstract 16 x 16 mesh),
  an olmo-1b prefill and decode at depth 1, a cell the sharding rules
  refuse (recorded, not raised), the record cache and ``force``, and
  the CLI.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest

from repro.configs import SHAPES, get_config as jget_config
from repro.distributed import sharding as jshd
from repro.launch import specs as JS
from repro.launch.mesh import make_abstract_mesh as jmake_abstract_mesh

ROOT = Path(__file__).resolve().parents[1]


def run_py(code: str, timeout: int) -> dict:
    """Run ``code`` in a fresh interpreter (the port only); returns the
    JSON object it prints last."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# --- the walker --------------------------------------------------------------


@pytest.fixture(scope="module")
def walks():
    return run_py("""
        import json
        import torch
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard, distribute_tensor)
        from repro_torch.launch import dryrun as D

        out = {}

        def loop(n):
            def f(x, w):
                for _ in range(n):
                    x = x @ w
                return x
            return f

        x, w = torch.randn(64, 64), torch.randn(64, 64)
        for n in (4, 12):
            _, out[f"loop{n}"] = D.count_step(loop(n), (x, w))

        mesh = D.fake_world()
        out["mesh"] = [mesh.size(), list(mesh.mesh_dim_names)]
        with FakeTensorMode():
            t = distribute_tensor(torch.empty(256, 64), mesh,
                                  [Shard(0), Shard(1)], src_data_rank=None)
            _, out["mul"] = D.count_step(lambda d: d * 2.0, (t,))
            rows = distribute_tensor(torch.empty(256, 64), mesh,
                                     [Shard(0), Replicate()],
                                     src_data_rank=None)
            _, out["gather"] = D.count_step(lambda d: d.full_tensor(),
                                            (rows,))
            _, out["scatter"] = D.count_step(
                lambda p: DTensor.from_local(
                    p, mesh, [Partial(), Replicate()], run_check=False)
                .redistribute(mesh, [Shard(0), Replicate()]),
                (torch.empty(256, 64),))
        mesh = D.fake_world(multi_pod=True)
        out["mesh_mp"] = [mesh.size(), list(mesh.mesh_dim_names)]
        print(json.dumps(out))
    """, timeout=120)


def test_walker_charges_each_trip_of_a_python_loop(walks):
    four, twelve = walks["loop4"], walks["loop12"]
    assert 2 <= twelve["hbm_bytes_est"] / four["hbm_bytes_est"] <= 4
    assert twelve["flops_per_device"] == 12 * 2 * 64 ** 3
    assert four["flops_per_device"] == 4 * 2 * 64 ** 3
    # one rank, one device: no collectives; inputs read once, each
    # product written and read again
    assert four["collective_bytes"] == {"total": 0}
    assert four["hbm_bytes_est"] == 2 * 64 * 64 * 4 * (1 + 4)
    assert four["argument_size_in_bytes"] == 2 * 64 * 64 * 4
    # the loop frees each product once the next exists: two alive at most
    assert twelve["temp_size_in_bytes"] == 2 * 64 * 64 * 4


def test_walker_charges_a_256_way_dtensor_at_the_rank_shard(walks):
    shard = 16 * 4 * 4                 # (256, 64) f32 over 16 x 16
    mul = walks["mul"]
    assert mul["flops_per_device"] == 16 * 4
    assert mul["argument_size_in_bytes"] == shard
    assert mul["hbm_bytes_est"] == shard + 2 * shard
    assert mul["temp_size_in_bytes"] == shard
    assert mul["collective_bytes"] == {"total": 0}
    assert walks["mesh"] == [256, ["data", "model"]]
    assert walks["mesh_mp"] == [512, ["pod", "data", "model"]]


def test_walker_charges_collectives_at_their_output_bytes(walks):
    # rows (16, 64) gathered over data: a (256, 64) f32 output
    assert walks["gather"]["collective_bytes"] == {
        "all-gather": 256 * 64 * 4, "total": 256 * 64 * 4}
    # a (256, 64) partial sum reduce-scattered over data: (16, 64) out
    assert walks["scatter"]["collective_bytes"] == {
        "reduce-scatter": 16 * 64 * 4, "total": 16 * 64 * 4}
    assert walks["gather"]["flops_per_device"] == 0


# --- cells -------------------------------------------------------------------


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    return run_py(f"""
        import json
        from pathlib import Path
        from repro_torch.configs import get_config
        from repro_torch.launch import dryrun as D
        from repro_torch.perfmodel.roofline import override_depth

        D.RESULTS_DIR = Path({str(d)!r})
        out = {{"train": D.run_cell("whisper-base", "train_4k")}}
        olmo1 = override_depth(get_config("olmo-1b"), 1)
        for shape in ("prefill_32k", "decode_32k"):
            out[shape] = D.run_cell_cfg(olmo1, "olmo-1b", shape,
                                        tag_suffix="__depth1")
        out["refused"] = D.run_cell("hymba-1.5b", "long_500k")

        # the record cache: an ok record of this schema is reused ...
        f = D.RESULTS_DIR / "olmo-1b__decode_32k__pod16x16__depth1.json"
        def again(**kw):
            return D.run_cell_cfg(olmo1, "olmo-1b", "decode_32k",
                                  tag_suffix="__depth1", **kw)
        def mark(**fields):
            f.write_text(json.dumps({{**json.loads(f.read_text()),
                                     "marker": 1, **fields}}))
        mark()
        out["reused"] = "marker" in again()
        out["forced"] = "marker" in again(force=True)
        # ... a failure or an older schema is not
        mark(ok=False)
        out["failure_reused"] = "marker" in again()
        mark(schema=3)
        out["old_schema_reused"] = "marker" in again()
        print(json.dumps(out))
    """, timeout=240)


def _per_device_bytes(struct, specs, mesh) -> int:
    """Global bytes of each leaf over the product of its spec's axis
    sizes (every spec splits evenly)."""
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree.leaves(struct)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(s, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        split = 1
        for entry in spec:
            for axis in (entry if isinstance(entry, tuple) else (entry,)):
                if axis is not None:
                    split *= mesh.shape[axis]
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        assert n % split == 0
        total += n // split
    return total


def test_whisper_train_cell_on_the_fake_16x16_mesh(cells):
    rec = cells["train"]
    assert rec["ok"], rec.get("traceback")
    assert rec["schema"] == 4 and rec["n_devices"] == 256
    assert rec["collective_bytes"]["total"] > 0
    assert rec["collective_bytes"]["all-gather"] > 0
    assert rec["collective_bytes"]["reduce-scatter"] > 0
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_est"] > 0
    assert rec["temp_size_in_bytes"] > 0
    # JAX's specs on an abstract 16 x 16 mesh give the same bytes a device
    from jax.sharding import PartitionSpec as P

    cfg = dataclasses.replace(jget_config("whisper-base"), remat="dots")
    mesh = jmake_abstract_mesh((16, 16), ("data", "model"))
    params = JS.param_specs_struct(cfg)
    pspecs = jshd.param_specs(params, mesh)
    ostruct = JS.opt_specs_struct(params)
    batch = JS.train_batch_specs(cfg, SHAPES["train_4k"])
    bspecs = {k: jshd.batch_spec(k, v.shape, mesh, ("data",))
              for k, v in batch.items()}
    want = (_per_device_bytes(params, pspecs, mesh)
            + _per_device_bytes(ostruct, {"m": pspecs, "v": pspecs,
                                          "step": P()}, mesh)
            + _per_device_bytes(batch, bspecs, mesh))
    assert rec["argument_size_in_bytes"] == want


def test_prefill_and_decode_cells_at_depth_one(cells):
    for shape in ("prefill_32k", "decode_32k"):
        rec = cells[shape]
        assert rec["ok"], rec.get("traceback")
        assert rec["cell"] == f"olmo-1b__{shape}__pod16x16__depth1"
        assert rec["flops_per_device"] > 0
        # the params are gathered over data (each keeps its model split)
        assert rec["collective_bytes"]["all-gather"] > 0
    # the tensor-parallel decode step attends over the rank's KV heads
    # where they lie: it gathers less than the rank's own share of one
    # layer of K and V (8 rows x 32768 x 1 head x 128, bf16)
    assert cells["decode_32k"]["collective_bytes"]["all-gather"] < \
        2 * 8 * 32768 * 1 * 128 * 2


def test_a_refused_cell_is_recorded_not_raised(cells):
    rec = cells["refused"]
    assert rec["ok"] is False
    assert "out of mesh order" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert rec["cell"] == "hymba-1.5b__long_500k__pod16x16"


def test_record_cache_and_force(cells):
    assert cells["reused"] is True
    assert cells["forced"] is False
    assert cells["failure_reused"] is False
    assert cells["old_schema_reused"] is False


def test_cli_prints_each_cell_and_the_count(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(f"""
            from pathlib import Path
            from repro_torch.launch import dryrun as D
            D.RESULTS_DIR = Path({str(tmp_path)!r})
            D.main(["--arch", "hymba-1.5b", "--shape", "long_500k",
                    "--multi-pod"])
        """)], capture_output=True, text=True, timeout=60, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[FAIL] hymba-1.5b__long_500k__pod2x16x16" in out.stdout
    assert out.stdout.strip().endswith("0 cells OK")
    rec = json.loads((tmp_path / "hymba-1.5b__long_500k__pod2x16x16.json")
                     .read_text())
    assert rec["ok"] is False
