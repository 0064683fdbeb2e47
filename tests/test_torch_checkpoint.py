"""Fault tolerance in the port: ``distributed/checkpoint.py`` (atomic,
async, retention, bfloat16 leaves), ``distributed/fault_tolerance.py``
and the Trainer's restart, mirroring ``tests/test_fault_tolerance.py``
and held against ``repro``'s modules on the CPU.

Tolerances: checkpoints round-trip bit for bit, and the port writes the
same files as JAX's ``CheckpointManager`` (one manifest, shapes, dtypes
and checksums alike); the restarted trainer's losses agree with the
uninterrupted run's within rtol 1e-4 (JAX's own test's tolerance: a
restored tensor sits at another address, and the CPU's GEMMs may take
another path for it).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import fault_tolerance as jft
from repro.distributed.checkpoint import CheckpointManager as JCheckpoint
from repro_torch import configs
from repro_torch.data import synthetic
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault_tolerance import (
    FailureInjector,
    StepWatchdog,
    WatchdogConfig,
    run_with_restarts,
)
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tree import leaves, map_tree


def _np_tree():
    g = np.random.default_rng(0)
    return {"a": g.standard_normal((8, 16)).astype(np.float32),
            "h": g.standard_normal((4, 6)).astype(np.float32),
            "nested": {"b": np.arange(7, dtype=np.int32),
                       "c": np.float32(3.5)},
            "layers": [{"w": g.standard_normal((3,)).astype(np.float32)},
                       {"w": g.standard_normal((3,)).astype(np.float32)}]}


def _tree():
    """float32, bfloat16 ("h"), int32, a 0-d leaf and a list of layers."""
    t = {"a": torch.from_numpy(_np_tree()["a"]),
         "h": torch.from_numpy(_np_tree()["h"]).to(torch.bfloat16),
         "nested": {"b": torch.arange(7, dtype=torch.int32),
                    "c": torch.tensor(3.5)},
         "layers": [{"w": torch.from_numpy(lp["w"])}
                    for lp in _np_tree()["layers"]]}
    return t


def _assert_equal_trees(got, want):
    for a, b in zip(leaves(got), leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoint_roundtrip(tmp_path):
    """Bit for bit, bfloat16 included, into ``meta`` tensors (JAX's
    ``eval_shape``) placed with ``device=``, and into real ones."""
    cm = CheckpointManager(tmp_path)
    t = _tree()
    cm.save(5, t)
    meta = _meta(t)
    out = cm.restore(5, meta, device="cpu")
    _assert_equal_trees(out, t)
    _assert_equal_trees(cm.restore(5, t), t)
    man = json.loads((tmp_path / "step_5" / "MANIFEST.json").read_text())
    assert man["leaves"]["h"]["dtype"] == "bfloat16"
    assert "layers__1__w" in man["leaves"]
    with pytest.raises(ValueError, match="device="):
        cm.restore(5, meta)


def _meta(tree):
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def test_checkpoint_files_equal_repro(tmp_path):
    """The port writes JAX's files for the same tree (bf16 as ``<V2``
    words), and restores a checkpoint JAX wrote."""
    np_tree = _np_tree()
    jtree = jax.tree.map(jnp.asarray, np_tree)
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    JCheckpoint(tmp_path / "j").save(3, jtree)
    CheckpointManager(tmp_path / "t").save(3, _tree())
    jman = json.loads((tmp_path / "j" / "step_3" / "MANIFEST.json")
                      .read_text())
    tman = json.loads((tmp_path / "t" / "step_3" / "MANIFEST.json")
                      .read_text())
    assert tman["leaves"] == jman["leaves"]
    assert list(tman["leaves"]) == list(jman["leaves"])
    for key in jman["leaves"]:
        assert ((tmp_path / "t" / "step_3" / f"{key}.npy").read_bytes()
                == (tmp_path / "j" / "step_3" / f"{key}.npy").read_bytes())
    out = CheckpointManager(tmp_path / "j").restore(3, _tree())
    _assert_equal_trees(out, _tree())


def test_checkpoint_async_and_retention(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        cm.save_async(s, _tree())
    cm.wait()
    cm.save(5, _tree())
    assert cm.all_steps() == [4, 5]
    assert cm.latest_step() == 5
    jcm = JCheckpoint(tmp_path / "j", keep=2)
    for s in (1, 2, 3, 4):
        jcm.save_async(s, jax.tree.map(jnp.asarray, _np_tree()))
    jcm.wait()
    jcm.save(5, jax.tree.map(jnp.asarray, _np_tree()))
    assert jcm.all_steps() == cm.all_steps()


def test_checkpoint_async_snapshots_before_the_writer_runs(tmp_path,
                                                           monkeypatch):
    """An in-place update right after ``save_async`` (the optimizer's
    next step) must not reach the checkpoint: the writer is held until
    the tree has been overwritten."""
    from repro_torch.distributed import checkpoint as ckpt_mod

    gate = threading.Event()
    real_write = CheckpointManager._write

    def gated_write(self, step, host):
        gate.wait(timeout=30)
        real_write(self, step, host)

    monkeypatch.setattr(ckpt_mod.CheckpointManager, "_write", gated_write)
    cm = CheckpointManager(tmp_path)
    t = _tree()
    want = map_tree(torch.clone, t)
    cm.save_async(1, t)
    with torch.no_grad():
        for leaf in leaves(t):
            leaf.add_(1)
    gate.set()
    cm.wait()
    _assert_equal_trees(cm.restore(1, t), want)


def test_checkpoint_wait_reraises_the_writers_error(tmp_path, monkeypatch):
    from repro_torch.distributed import checkpoint as ckpt_mod

    def broken(fn, leaf):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_save_leaf", broken)
    cm = CheckpointManager(tmp_path)
    cm.save_async(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        cm.wait()
    cm.wait()                        # raised once
    assert cm.all_steps() == []      # nothing committed


def test_checkpoint_atomic_no_partial(tmp_path, monkeypatch):
    """A leftover .tmp dir from a crash is never listed as a checkpoint,
    and a write that dies midway leaves only its .tmp."""
    from repro_torch.distributed import checkpoint as ckpt_mod

    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree())
    (tmp_path / "step_2.tmp").mkdir()
    (tmp_path / "step_3").mkdir()   # no manifest -> incomplete
    assert cm.all_steps() == [1]
    calls = []
    real = ckpt_mod._save_leaf

    def dies_late(fn, leaf):
        calls.append(fn.name)
        if len(calls) == 3:
            raise RuntimeError("killed mid-write")
        return real(fn, leaf)

    monkeypatch.setattr(ckpt_mod, "_save_leaf", dies_late)
    with pytest.raises(RuntimeError, match="mid-write"):
        cm.save(4, _tree())
    assert cm.all_steps() == [1]
    assert not (tmp_path / "step_4").exists()
    assert (tmp_path / "step_4.tmp").exists()


def test_checkpoint_restore_checks_and_refuses_shardings(tmp_path):
    cm = CheckpointManager(tmp_path)
    cm.save(1, _tree())
    with pytest.raises(NotImplementedError, match="sharding"):
        cm.restore(1, _tree(), shardings=object())
    with pytest.raises(KeyError, match="missing leaf extra"):
        cm.restore(1, {**_tree(), "extra": torch.zeros(2)})
    np.save(tmp_path / "step_1" / "a.npy", np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="corrupt leaf a"):
        cm.restore(1, _tree())


def test_data_replay_deterministic():
    b1 = synthetic.lm_batch(1000, 4, 16, seed=7, step=42)
    b2 = synthetic.lm_batch(1000, 4, 16, seed=7, step=42)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = synthetic.lm_batch(1000, 4, 16, seed=7, step=43)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def _tcfg(d, async_ckpt=False):
    return TrainConfig(steps=12, batch=2, seq=32, ckpt_dir=str(d),
                       ckpt_every=4, log_every=100, async_ckpt=async_ckpt,
                       opt=opt.OptConfig(warmup_steps=2, total_steps=12))


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_trainer_restart_exactness(tmp_path, async_ckpt):
    """Kill training mid-run; resume must reproduce the uninterrupted
    trajectory exactly (checkpoint + deterministic data replay)."""
    cfg = configs.get_config("olmo-1b", smoke=True)
    ref = Trainer(cfg, _tcfg(tmp_path / "ref", async_ckpt),
                  log=lambda *_: None, device="cpu").run()

    # interrupted at step 6 (after the step-4 checkpoint), then restarted
    inj = FailureInjector(fail_at_steps=(6,))
    logs = []

    def attempt(_):
        t = Trainer(cfg, _tcfg(tmp_path / "ft", async_ckpt), injector=inj,
                    log=logs.append, device="cpu")
        return t.run()

    out = run_with_restarts(attempt, max_restarts=2)
    assert "[trainer] restored checkpoint step=4" in logs
    np.testing.assert_allclose(out["final_loss"], ref["final_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(out["losses"], ref["losses"][4:], rtol=1e-4)


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(WatchdogConfig(min_samples=3, straggler_factor=2.5))
    for s in range(10):
        v = wd.observe(s, 0.1)
        assert v == "ok"
    assert wd.observe(10, 0.25) == "ok"        # within factor
    assert wd.observe(11, 0.5) == "straggler"  # 5x
    assert wd.observe(12, 5.0) == "hang"
    assert wd.straggler_steps == [11, 12]
    # outliers must not poison the EMA baseline
    assert wd.ema < 0.2


def test_watchdog_and_injector_match_repro():
    g = np.random.default_rng(4)
    times = np.abs(g.standard_normal(60)) * 0.05 + 0.1
    times[[20, 33, 34, 50]] *= (3.5, 12.0, 4.0, 30.0)
    wd, jwd = StepWatchdog(), jft.StepWatchdog()
    for s, dt in enumerate(times):
        assert wd.observe(s, float(dt)) == jwd.observe(s, float(dt))
    assert wd.events == jwd.events and wd.ema == jwd.ema
    inj, jinj = FailureInjector((2, 5)), jft.FailureInjector((2, 5))
    for s in (0, 2, 2, 5, 6):
        got = want = None
        try:
            inj.check(s)
        except RuntimeError as e:
            got = str(e)
        try:
            jinj.check(s)
        except RuntimeError as e:
            want = str(e)
        assert got == want


def test_restart_protocol_gives_up():
    calls = []
    restarts = []

    def run(attempt):
        calls.append(attempt)
        raise RuntimeError("dead node")

    with pytest.raises(RuntimeError):
        run_with_restarts(run, max_restarts=2,
                          on_restart=lambda a, e: restarts.append(a))
    assert calls == [0, 1, 2]
    assert restarts == [1, 2]
