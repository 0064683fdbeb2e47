"""The port's async continuous-batching tier (``repro_torch.serve_async``).

The served package is one that ``repro`` deploys and saves, loaded by
the port's ``load`` on the CPU (plain kernel versions).  The contract
under test is ``tests/test_serve_async.py``'s, against the port:

  * **bit-exactness** — a request served through the async tier scores
    exactly like the same image through the port's synchronous engine
    with the bucket pinned; against JAX's ``AsyncSNNServeEngine`` on the
    same package the logits agree within rtol 1e-5 / atol 1e-5, the
    port's logit tolerance against ``repro`` (the float stem and readout
    sum in another order);
  * **no lost or duplicated results** under concurrent submitters, with
    totals that reconcile, and launch counters that stay exact when
    several threads launch at once;
  * **deadlines** resolve as explicit ``timeout`` results, never a hung
    future; **graceful drain** and **cancel** on close; a rollout that
    raises resolves its own requests as ``error`` and the tier serves on
    (the port's addition);
  * the tier's ``evict`` / ``recycle`` spans and slot / queue gauges;
  * ``poisson_schedule`` gives JAX's schedule for a seed;
  * the launcher's ``--async`` and the loadgen CLI on ``--device cpu``.

Every wait has its own timeout, so a future that never resolves fails
its test instead of hanging the suite.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.deploy import SNNEngineConfig as JEngineConfig
from repro.deploy import SNNServeEngine as JServeEngine
from repro.deploy import deploy as jdeploy
from repro.models import snn_cnn as jsnn
from repro.quant.formats import PrecisionConfig as JPC
from repro.serve_async import AsyncEngineConfig as JAsyncConfig
from repro.serve_async import AsyncSNNServeEngine as JAsyncEngine
from repro.serve_async import poisson_schedule as jpoisson_schedule
from repro_torch import obs
from repro_torch.deploy import (
    SNNEngineConfig, SNNRequest, SNNServeEngine, load)
from repro_torch.serve_async import (
    AsyncEngineConfig,
    AsyncSNNServeEngine,
    Closed,
    Full,
    QueueEntry,
    RequestQueue,
    SlotManager,
    SNNFuture,
    poisson_schedule,
    run_open_loop_async,
    run_open_loop_sync,
)
from repro_torch.serve_async.futures import AsyncResult

ROOT = pathlib.Path(__file__).resolve().parents[1]
WAIT = 120.0          # seconds any one future may take on the CPU


# ---------------------------------------------------------------------------
# unit: queue / slots / futures / schedule (no model)
# ---------------------------------------------------------------------------

def _entry(uid, deadline=None):
    return QueueEntry(req=SNNRequest(uid=uid, image=None),
                      future=SNNFuture(uid), deadline=deadline)


def test_queue_fifo_and_cohort_take():
    q = RequestQueue()
    for uid in range(5):
        q.put(_entry(uid))
    ready, expired = q.take(3, timeout=0)
    assert [e.req.uid for e in ready] == [0, 1, 2] and not expired
    ready, _ = q.take(3, timeout=0)
    assert [e.req.uid for e in ready] == [3, 4]
    assert len(q) == 0


def test_queue_bounded_admission_and_close():
    q = RequestQueue(maxsize=2)
    q.put(_entry(0))
    q.put(_entry(1))
    with pytest.raises(Full):
        q.put(_entry(2))
    q.close()
    with pytest.raises(Closed):
        q.put(_entry(3))
    ready, _ = q.take(4, timeout=0)
    assert [e.req.uid for e in ready] == [0, 1]


def test_queue_requeue_goes_to_front_even_when_closed():
    q = RequestQueue()
    q.put(_entry(0))
    q.close()
    q.requeue(_entry(7))
    ready, _ = q.take(2, timeout=0)
    assert [e.req.uid for e in ready] == [7, 0]


def test_queue_take_splits_expired_entries():
    q = RequestQueue()
    now = time.perf_counter()
    q.put(_entry(0, deadline=now - 1.0))
    q.put(_entry(1, deadline=now + 60.0))
    q.put(_entry(2))
    ready, expired = q.take(3, timeout=0)
    assert [e.req.uid for e in ready] == [1, 2]
    assert [e.req.uid for e in expired] == [0]


def test_queue_put_wakes_blocked_taker_and_close_wakes_all():
    q = RequestQueue()
    got = []

    def taker():
        ready, _ = q.take(1, timeout=5.0)
        got.extend(ready)

    th = threading.Thread(target=taker)
    th.start()
    time.sleep(0.02)
    q.put(_entry(9))
    th.join(timeout=5.0)
    assert not th.is_alive() and got[0].req.uid == 9
    waiters = [threading.Thread(target=q.take, args=(1, None))
               for _ in range(3)]
    for w in waiters:
        w.start()
    time.sleep(0.02)
    q.close()
    for w in waiters:
        w.join(timeout=5.0)
    assert not any(w.is_alive() for w in waiters)
    assert q.drain_all() == []


def test_slot_manager_backpressure_and_recycling():
    sm = SlotManager(2)
    a, b = sm.acquire(10), sm.acquire(11)
    assert {a, b} == {0, 1}
    assert sm.acquire(12) is None
    uid, held = sm.release(a)
    assert uid == 10 and held >= 0.0
    assert sm.occupied() == 1 and sm.free_count() == 1
    assert sm.acquire(12) == a
    assert sm.total_acquired == 3 and sm.total_recycled == 1
    assert sm.occupancy() == 1.0
    with pytest.raises(ValueError):
        SlotManager(0)


def test_future_resolves_once_and_caller_timeout_is_not_request_timeout():
    f = SNNFuture(0)
    assert not f.done()
    with pytest.raises(TimeoutError):
        f.result(timeout=0.01)
    assert f.resolve(AsyncResult(uid=0, status="ok"))
    assert not f.resolve(AsyncResult(uid=0, status="timeout"))
    assert f.done() and f.result(timeout=0).ok


@pytest.mark.parametrize("rate,n,seed", [(50.0, 200, 3), (1000.0, 64, 0),
                                         (8.0, 24, 0), (0.5, 5, 11)])
def test_poisson_schedule_equals_repro(rate, n, seed):
    got = poisson_schedule(rate, n, seed=seed)
    np.testing.assert_array_equal(got, jpoisson_schedule(rate, n, seed=seed))
    assert np.all(np.diff(got) > 0)
    with pytest.raises(ValueError):
        poisson_schedule(0.0, 4)


def test_launch_counters_stay_exact_under_concurrent_launches():
    """Worker threads launch forwards at once: ``count_launch`` must not
    lose an update (the counts chip_smoke asserts)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_conv import ops as conv_ops

    before = conv_ops.fused_conv_rollout.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            build.count_launch(conv_ops.fused_conv_rollout)
            for _ in range(3000)]) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert conv_ops.fused_conv_rollout.launches == before + 8 * 3000
    conv_ops.fused_conv_rollout.launches = before


# ---------------------------------------------------------------------------
# integration: the tier over a package repro deployed and saved
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    cfg = jsnn.SNNConfig(model="vgg9", img_size=16, timesteps=2,
                         scale=0.15, n_classes=4, int_deploy=True,
                         precision=JPC(bits=4))
    jmodel = jdeploy(jsnn.init(jax.random.PRNGKey(0), cfg), cfg)
    path = jmodel.save(str(tmp_path_factory.mktemp("pkg") / "vgg9.npz"))
    return jmodel, load(path, device="cpu")


@pytest.fixture
def model(packages):
    return packages[1]


def _images(cfg, n, seed=0):
    return np.random.default_rng(seed).random(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


def _engine(model, registry=None, **ecfg):
    return SNNServeEngine(model, SNNEngineConfig(**ecfg), device="cpu",
                          registry=registry)


def test_async_results_bit_exact_with_sync_engine(model):
    images = _images(model.cfg, 8, seed=1)
    eng = _engine(model, max_batch=4, buckets=(4,))
    eng.warmup()
    for i in range(8):
        eng.add_request(SNNRequest(uid=i, image=images[i]))
    eng.run_until_done()
    ref = {i: eng.pop_result(i) for i in range(8)}
    eng.close()

    eng2 = _engine(model, max_batch=4, buckets=(4,))
    with AsyncSNNServeEngine(eng2, AsyncEngineConfig(workers=2)) as aeng:
        futs = [aeng.submit(images[i]) for i in range(8)]
        res = [f.result(timeout=WAIT) for f in futs]
    for i, r in enumerate(res):
        assert r.ok and r.uid == i
        np.testing.assert_array_equal(r.logits, ref[i].logits)
        assert r.pred == ref[i].pred
        assert r.latency_s >= r.compute_s > 0


def test_async_matches_repro_async_engine(packages):
    jmodel, model = packages
    images = _images(model.cfg, 6, seed=8)
    jeng = JServeEngine(jmodel, JEngineConfig(max_batch=4, buckets=(4,)))
    with JAsyncEngine(jeng, JAsyncConfig(workers=2)) as jaeng:
        jres = [f.result(timeout=WAIT)
                for f in [jaeng.submit(im) for im in images]]
    eng = _engine(model, max_batch=4, buckets=(4,))
    with AsyncSNNServeEngine(eng, AsyncEngineConfig(workers=2)) as aeng:
        res = [f.result(timeout=WAIT)
               for f in [aeng.submit(im) for im in images]]
    for r, jr in zip(res, jres):
        assert r.ok and jr.ok and r.uid == jr.uid
        np.testing.assert_allclose(r.logits, np.asarray(jr.logits),
                                   rtol=1e-5, atol=1e-5)
    direct = np.asarray(jmodel.apply(jnp.asarray(images)))
    np.testing.assert_allclose(np.stack([r.logits for r in res]), direct,
                               rtol=1e-5, atol=1e-5)
    assert set(aeng.stats()) == set(jaeng.stats())
    # the port's one addition: failed rollouts' requests (status "error")
    assert set(aeng.stats()["async"]) == \
        set(jaeng.stats()["async"]) | {"errors"}
    assert set(aeng.health()["async"]) == \
        set(jaeng.health()["async"]) | {"errors"}


def test_concurrent_submitters_lose_nothing(model):
    """8 threads x 6 submissions into 4 workers, with a short switch
    interval: every future resolves ok exactly once, each with its own
    image's logits, and the totals reconcile."""
    images = _images(model.cfg, 4, seed=2)
    ref_eng = _engine(model, max_batch=4, buckets=(4,))
    for i, im in enumerate(images):
        ref_eng.add_request(SNNRequest(uid=i, image=im))
    ref_eng.run_until_done()
    ref = {i: ref_eng.done[i].logits for i in range(4)}
    n_threads, per_thread = 8, 6
    total = n_threads * per_thread
    reg = obs.MetricsRegistry()
    eng = _engine(model, reg, max_batch=4, buckets=(4,))
    aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(workers=4))
    aeng.warmup()
    warm = eng.compile_count
    aeng.start()
    results, lock = {}, threading.Lock()

    def client(tid):
        futs = [(i, aeng.submit(images[(tid + i) % 4]))
                for i in range(per_thread)]
        for i, f in futs:
            r = f.result(timeout=WAIT)
            with lock:
                results[(tid, i)] = r

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=2 * WAIT)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    stats = aeng.close()
    assert len(results) == total
    assert len({r.uid for r in results.values()}) == total
    for (tid, i), r in results.items():
        assert r.ok
        np.testing.assert_array_equal(r.logits, ref[(tid + i) % 4])
    a = stats["async"]
    assert a["submitted"] == a["completed"] == total
    assert a["timeouts"] == a["cancelled"] == 0
    assert eng.total_requests == total == stats["requests"]
    assert eng.compile_count == warm
    assert aeng.slots.total_acquired == total
    # the registry and the engine totals reconcile
    assert reg.find("snn_serve_requests_total").value == total
    assert reg.find("snn_serve_submitted_total").value == total
    assert reg.find("snn_serve_batches_total").value == eng.total_batches
    assert sum(eng.per_bucket.values()) == eng.total_batches


@pytest.mark.parametrize("hook,started", [
    ("begin_step", True), ("finish_step", True), ("finish_step", False)],
    ids=["begin-worker", "finish-worker", "finish-inline"])
def test_raising_rollout_fails_its_requests_not_the_worker(model, hook,
                                                           started):
    """A rollout whose dispatch or collection raises (a kernel launch
    that fails) resolves its own requests as ``error`` with the
    exception, frees their slots, and the tier serves on: no future
    hangs, on a worker or on the closing thread."""
    reg = obs.MetricsRegistry()
    eng = _engine(model, reg, max_batch=2, buckets=(2,))
    real, calls = getattr(eng, hook), []

    def first_call_raises(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected launch failure")
        return real(*args, **kw)

    setattr(eng, hook, first_call_raises)
    aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(workers=1))
    futs = [aeng.submit(im) for im in _images(model.cfg, 4, seed=9)]
    if started:
        aeng.start()
        res = [f.result(timeout=WAIT) for f in futs]
        assert aeng.health()["async"]["workers_alive"] == 1
        stats = aeng.close()
    else:
        stats = aeng.close(drain=True)
        res = [f.result(timeout=0) for f in futs]
    assert [r.status for r in res] == ["error", "error", "ok", "ok"]
    for r in res[:2]:
        assert not r.ok and r.logits is None
        assert r.detail == "RuntimeError: injected launch failure"
    a = stats["async"]
    assert (a["errors"], a["completed"], a["slots_held"]) == (2, 2, 0)
    assert aeng.slots.total_acquired == 4 and aeng.slots.occupied() == 0
    assert reg.find("snn_serve_errors_total").value == 2
    assert any(e["event"] == "error" for e in reg.spans())


def test_deadline_exceeded_resolves_as_timeout_not_hang(model):
    eng = _engine(model, max_batch=2, buckets=(2,))
    aeng = AsyncSNNServeEngine(eng)       # workers not started yet
    img = _images(model.cfg, 1)[0]
    fut = aeng.submit(img, deadline_ms=5.0)
    live = aeng.submit(img)
    time.sleep(0.05)
    aeng.start()
    r = fut.result(timeout=WAIT)
    assert r.status == "timeout" and not r.ok and "deadline" in r.detail
    assert live.result(timeout=WAIT).ok
    stats = aeng.close()
    assert stats["async"]["timeouts"] == 1
    assert stats["async"]["completed"] == 1


def test_default_deadline_and_queue_limit(model):
    eng = _engine(model, max_batch=2, buckets=(2,))
    aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(
        queue_limit=2, default_deadline_ms=1.0))
    img = _images(model.cfg, 1)[0]
    futs = [aeng.submit(img) for _ in range(3)]
    full = futs[2].result(timeout=0)
    assert full.status == "cancelled" and "capacity" in full.detail
    time.sleep(0.02)
    aeng.start()
    assert [f.result(timeout=WAIT).status for f in futs[:2]] == \
        ["timeout", "timeout"]
    stats = aeng.close()
    assert (stats["async"]["timeouts"], stats["async"]["cancelled"]) == (2, 1)


def test_close_drain_flushes_queue_and_pipeline(model):
    eng = _engine(model, max_batch=4, buckets=(4,))
    aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(workers=1))
    images = _images(model.cfg, 6, seed=3)
    futs = [aeng.submit(im) for im in images]
    aeng.start()
    stats = aeng.close(drain=True)
    assert all(f.result(timeout=WAIT).ok for f in futs)
    assert stats["async"]["completed"] == len(futs)
    with pytest.raises(Closed):
        aeng.submit(images[0])
    # a second close returns the same stats at once
    again = aeng.close()
    assert again["async"] == stats["async"]


def test_close_drain_serves_inline_when_never_started(model):
    aeng = AsyncSNNServeEngine(_engine(model, max_batch=2, buckets=(2,)))
    futs = [aeng.submit(im) for im in _images(model.cfg, 3, seed=4)]
    stats = aeng.close(drain=True)
    assert all(f.result(timeout=0).ok for f in futs)
    assert stats["async"]["completed"] == 3


def test_close_without_drain_cancels_backlog(model):
    aeng = AsyncSNNServeEngine(_engine(model, max_batch=2, buckets=(2,)))
    futs = [aeng.submit(im) for im in _images(model.cfg, 3, seed=5)]
    stats = aeng.close(drain=False)
    for f in futs:
        r = f.result(timeout=0)
        assert r.status == "cancelled" and not r.ok
    assert stats["async"]["cancelled"] == 3
    assert stats["async"]["completed"] == 0


def test_context_manager_cancels_when_the_block_raises(model):
    aeng = AsyncSNNServeEngine(_engine(model, max_batch=2, buckets=(2,)))
    with pytest.raises(RuntimeError, match="boom"):
        with aeng:                       # starts the workers
            futs = [aeng.submit(im) for im in _images(model.cfg, 2)]
            raise RuntimeError("boom")
    for f in futs:
        assert f.result(timeout=WAIT).status in ("ok", "cancelled")
    assert aeng.stats()["async"]["closed"] is True
    assert aeng.health()["async"]["workers_alive"] == 0


def test_async_tier_emits_recycle_spans_and_gauges(model, tmp_path):
    reg = obs.MetricsRegistry()
    eng = _engine(model, reg, max_batch=2, buckets=(2,))
    aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(workers=1))
    images = _images(model.cfg, 4, seed=6)
    timed_out = aeng.submit(images[0], deadline_ms=1.0)
    time.sleep(0.01)
    aeng.start()
    futs = [aeng.submit(im) for im in images]
    assert all(f.result(timeout=WAIT).ok for f in futs)
    aeng.close()
    assert timed_out.result(timeout=0).status == "timeout"

    events = [ev["event"] for ev in reg.spans()]
    assert events.count("enqueue") == 5
    assert events.count("recycle") == 4
    assert events.count("evict") == 1
    assert events.count("close") == 1
    recycles = [ev for ev in reg.spans() if ev["event"] == "recycle"]
    assert all(ev["held_us"] > 0 for ev in recycles)
    assert {ev["uid"] for ev in recycles} == {f.uid for f in futs}
    assert reg.counter("snn_serve_evictions_total").value == 1
    assert reg.counter("snn_serve_submitted_total").value == 5
    assert reg.gauge("snn_serve_slot_occupancy").value == 0.0
    assert reg.gauge("snn_serve_queue_depth").value == 0.0
    assert reg.gauge("snn_serve_inflight").value == 0.0

    from repro_torch.obs.chrometrace import TRACKS, span_to_events

    slot_rows = [e for ev in recycles for e in span_to_events(ev)]
    assert all(e["tid"] == TRACKS["slots"] and e["ph"] == "X"
               for e in slot_rows)
    path = obs.export_chrome_trace(reg, str(tmp_path / "t.trace.json"))
    assert obs.validate_chrome_trace(path) == []


def test_open_loop_drivers_share_one_schedule(model):
    images = _images(model.cfg, 4, seed=7)
    schedule = poisson_schedule(200.0, 10, seed=1)
    eng = _engine(model, max_batch=4, buckets=(1, 2, 4))
    eng.warmup()
    rep_s = run_open_loop_sync(eng, images, schedule)
    eng.close()
    aeng = AsyncSNNServeEngine(_engine(model, max_batch=4,
                                       buckets=(1, 2, 4)),
                               AsyncEngineConfig(workers=1))
    aeng.warmup()
    aeng.start()
    rep_a = run_open_loop_async(aeng, images, schedule,
                                result_timeout_s=WAIT)
    aeng.close()
    for rep in (rep_s, rep_a):
        assert rep.completed == rep.requests == 10
        assert rep.timeouts == 0 and rep.cancelled == 0
        assert rep.offered_rps == pytest.approx(10 / float(schedule[-1]))
        assert 0 < rep.achieved_rps <= rep.offered_rps * 1.01
        assert rep.latency_p50_ms <= rep.latency_p95_ms \
            <= rep.latency_p99_ms <= rep.latency_max_ms
        assert rep.queue_avg_ms >= 0 and rep.compute_avg_ms > 0
        assert rep.mode in rep.summary()
    assert rep_s.mode == "sync" and rep_a.mode == "async"


def _run(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_launcher_async_on_cpu_writes_a_valid_trace(tmp_path):
    trace = tmp_path / "serve.trace.json"
    metrics = tmp_path / "serve.jsonl"
    out = _run("repro_torch.launch.serve_snn", "--device", "cpu", "--async",
               "--workers", "2", "--requests", "12", "--trace", str(trace),
               "--metrics", str(metrics), "--show-graph")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "12/12 futures resolved ok" in out.stdout
    assert "2 workers, 12 submitted / 12 completed" in out.stdout
    assert "[obs] watchdog: 0 trips" in out.stdout
    check = _run("repro_torch.obs.validate", str(trace), "--trace")
    assert check.returncode == 0, check.stderr
    check = _run("repro_torch.obs.validate", str(metrics),
                 "--require-spans", "enqueue,admit,step,drain,recycle",
                 "--require-metrics",
                 "snn_serve_requests_total,snn_watchdog_checks_total")
    assert check.returncode == 0, check.stderr


def test_launcher_async_open_loop_in_process(capsys):
    from repro_torch.launch import serve_snn

    try:
        stats = serve_snn.main(["--device", "cpu", "--async", "--rate",
                                "400", "--requests", "6", "--workers", "1",
                                "--deadline-ms", "60000"])
    finally:
        obs.disable_default()
    assert stats["requests"] == 6 and stats["async"]["completed"] == 6
    assert "[async] offered=" in capsys.readouterr().out


def test_loadgen_cli_on_cpu(tmp_path):
    metrics = tmp_path / "lg.jsonl"
    out = _run("repro_torch.serve_async.loadgen", "--device", "cpu",
               "--rate", "200", "--requests", "8", "--mode", "both",
               "--metrics", str(metrics))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[sync] offered=" in out.stdout and "[async] offered=" in \
        out.stdout and "(8/8 ok" in out.stdout
    assert _run("repro_torch.obs.validate", str(metrics)).returncode == 0
