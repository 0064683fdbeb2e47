"""The port's observability layer (``repro_torch.obs``) against ``repro.obs``.

The same instrument, span and watchdog sequences go through both
packages' registries: the Prometheus text must be identical, the JSONL
snapshots identical apart from timestamps (``emitted_unix``, ``ts_us``),
the Chrome trace of one span list identical (its ``otherData.producer``
names the module that wrote it), and the watchdog trips identical.  The
port's engine must emit the JAX engine's instruments and span events for
the same request stream.  The HTTP server is exercised on 127.0.0.1 with
a timeout on every request, and the validator CLI's exit codes are
checked in-process and as ``python -m repro_torch.obs.validate``.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro_torch import obs

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _drive(o, reg):
    """One sequence of instruments and spans, shaped like an engine run,
    through the package ``o``'s API on ``reg``."""
    reg.counter("snn_serve_requests_total", "requests completed").inc(3)
    reg.counter("snn_serve_compile_total", "builds",
                labels={"result": "miss"}).inc()
    reg.counter("snn_serve_compile_total", "hits",
                labels={"result": "hit"}).inc(2)
    reg.gauge("snn_serve_queue_depth", "depth").set(4)
    reg.gauge("weird", 'help with "quotes" and \\ slash\nnewline',
              labels={"path": 'a"b\\c\nd'}).set(0.25)
    h = reg.histogram("snn_serve_latency_us", o.LATENCY_EDGES_US, "lat")
    for v in (40.0, 50.0, 51.0, 999.0, 2e6):
        h.observe(v)
    f = reg.histogram("frac", o.FRACTION_EDGES, "fractions")
    for v in (0.0, 0.015, 0.5, 1.0):
        f.observe(v)
    reg.event("enqueue", uid=0, queue_depth=1)
    reg.event("admit", n=1, bucket=1, pad_frac=0.0, queue_depth=0)
    reg.event("step", bucket=1, n=1, pad_frac=0.0, compute_us=800.0)
    reg.event("drain", uid=0, queue_us=10.0, compute_us=800.0,
              latency_us=900.0)
    return reg


def _strip_times(rows):
    return [{k: v for k, v in r.items() if k not in ("ts_us",
                                                     "emitted_unix")}
            for r in rows]


def test_prometheus_text_is_identical():
    mine = obs.to_prometheus(_drive(obs, obs.MetricsRegistry()))
    theirs = jobs.to_prometheus(_drive(jobs, jobs.MetricsRegistry()))
    assert mine == theirs
    assert 'le="+Inf"' in mine and 'path="a\\"b\\\\c\\nd"' in mine


@pytest.mark.parametrize("enabled", [True, False])
def test_jsonl_is_identical_apart_from_timestamps(tmp_path, enabled):
    mine = obs.write_jsonl(_drive(obs, obs.MetricsRegistry(enabled)),
                           str(tmp_path / "port.jsonl"), meta={"x": 1})
    theirs = jobs.write_jsonl(_drive(jobs, jobs.MetricsRegistry(enabled)),
                              str(tmp_path / "jax.jsonl"), meta={"x": 1})
    rows = [_strip_times(json.loads(ln) for ln in open(p))
            for p in (mine, theirs)]
    assert rows[0] == rows[1]
    assert len(rows[0]) == (1 + 7 + 4 if enabled else 1)
    # each package reads and validates the other's file
    assert obs.validate_jsonl(theirs) == [] == jobs.validate_jsonl(mine)
    a, b = obs.read_jsonl(mine), jobs.read_jsonl(theirs)
    assert a["metrics"] == b["metrics"]
    assert _strip_times(a["spans"]) == _strip_times(b["spans"])


def _golden_spans():
    """Every span kind the trace maps, at fixed timestamps."""
    evs = [("enqueue", dict(uid=0, queue_depth=1)),
           ("enqueue", dict(uid=1, queue_depth=2)),
           ("admit", dict(n=2, bucket=2, pad_frac=0.0, queue_depth=0)),
           ("compile", dict(bucket=2, result="miss", compile_us=1500.0)),
           ("step", dict(bucket=2, n=2, pad_frac=0.0, compute_us=800.0)),
           ("drain", dict(uid=0, queue_us=100.0, compute_us=800.0,
                          latency_us=950.0)),
           ("evict", dict(uid=1, waited_us=5000.0)),
           ("recycle", dict(slot=3, uid=0, held_us=1200.0)),
           ("watchdog", dict(rule="latency_slo", key="latency_slo")),
           ("watchdog_clear", dict(rule="latency_slo", key="latency_slo")),
           ("train_step", dict(step=1, dt_us=10.0)),
           ("something_new", dict(a=1))]
    return [{"event": name, "ts_us": 1000.0 * (i + 1) + 0.123456,
             "seq": i + 1, **fields} for i, (name, fields) in enumerate(evs)]


def test_chrome_trace_golden_is_identical(tmp_path):
    spans = _golden_spans()
    mine = obs.to_chrome_trace(spans, meta={"entry": "t"})
    theirs = jobs.to_chrome_trace(spans, meta={"entry": "t"})
    assert mine["traceEvents"] == theirs["traceEvents"]
    assert mine["displayTimeUnit"] == theirs["displayTimeUnit"]
    assert mine["otherData"].pop("producer") == \
        "repro_torch.obs.chrometrace"
    theirs["otherData"].pop("producer")
    assert mine["otherData"] == theirs["otherData"]
    names = {e["name"] for e in mine["traceEvents"]}
    assert {"request/0", "evict/1", "slot/3", "compile/b2",
            "step/b2", "something_new"} <= names
    path = obs.export_chrome_trace(spans, str(tmp_path / "t.trace.json"))
    assert obs.validate_chrome_trace(path) == []
    assert jobs.validate_chrome_trace(path) == []
    # the registry source gives the same events as its span list
    reg = _drive(obs, obs.MetricsRegistry())
    assert obs.to_chrome_trace(reg)["traceEvents"] == \
        obs.to_chrome_trace(reg.spans())["traceEvents"]


def test_chrome_trace_validator_rejects_what_repro_rejects(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "pid": 1, "ts": -5, "dur": 1, "name": "x"},
        {"ph": "X", "pid": 1, "ts": 5, "name": "nodur"},
        {"ph": "f", "pid": 1, "ts": 1, "id": 9, "cat": "request",
         "name": "orphan"},
        {"pid": 1, "ts": 1},
    ]}))
    problems = obs.validate_chrome_trace(str(p))
    assert problems == jobs.validate_chrome_trace(str(p))
    assert len(problems) == 4
    for text in ("[]", "not json"):
        p.write_text(text)
        assert obs.validate_chrome_trace(str(p))
    assert obs.validate_chrome_trace(str(tmp_path / "missing.json"))


def test_registry_semantics_match_repro():
    for o in (obs, jobs):
        reg = o.MetricsRegistry(max_spans=3)
        c = reg.counter("c", "h", {"a": "1"})
        assert reg.counter("c", "other help", {"a": "1"}) is c
        with pytest.raises(ValueError):
            reg.gauge("c", labels={"a": "1"})
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            reg.histogram("h", edges=(2.0, 1.0))
        reg.histogram("h2", edges=(1.0, 2.0))
        with pytest.raises(ValueError):
            reg.histogram("h2", edges=(1.0, 3.0))
        for i in range(5):
            reg.event("e", i=i)
        assert reg.span_stats() == {"appended": 5, "retained": 3,
                                    "dropped": 2}
        assert [ev["i"] for ev in reg.spans_since(3)] == [3, 4]
        c.inc(2)
        reg.reset()
        c.inc()
        assert reg.find("c", {"a": "1"}).value == 1.0
        assert reg.spans() == []
        off = o.MetricsRegistry(enabled=False)
        assert off.counter("x") is o.NULL_INSTRUMENT
        off.event("nothing")
        assert off.snapshot() == {"metrics": [], "spans": []}


def test_default_registry_toggles_like_repro():
    try:
        assert not obs.default_registry().enabled
        reg = obs.enable_default(max_spans=7)
        assert obs.default_registry() is reg and reg.enabled
        assert obs.disable_default() is obs.default_registry()
        assert not obs.default_registry().enabled
    finally:
        obs.disable_default()


def test_concurrent_increments_lose_nothing():
    reg = obs.MetricsRegistry()
    c = reg.counter("n")
    h = reg.histogram("h", edges=(1.0,))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                c.inc()
                h.observe(0.5)
                reg.event("e")
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert c.value == 16000 and h.count == 16000
    assert reg.span_stats()["appended"] == 16000


def _watchdog_run(o, tmp_path=None):
    """Injected drift, p95 burn, queue growth and padding waste, with a
    recovery, through package ``o``; returns the trips and health."""
    reg = o.MetricsRegistry()
    g = reg.gauge("snn_layer_spike_rate", "rate", {"layer": "convs.1"})
    g.set(0.05)
    h = reg.histogram("snn_serve_latency_us", o.LATENCY_EDGES_US, "lat")
    q = reg.gauge("snn_serve_queue_depth", "depth")
    p = reg.gauge("snn_serve_padding_waste", "waste")
    wd = o.Watchdog(reg, calibration={"convs.1": 0.05},
                    cfg=o.WatchdogConfig(
                        slo_p95_ms=50.0, queue_depth_limit=10.0,
                        padding_ceiling=0.5,
                        artifact_dir=str(tmp_path) if tmp_path else None))
    seq = []
    for step in range(14):
        g.set(0.5 if 2 <= step < 5 or step >= 11 else 0.05)
        for _ in range(50):
            h.observe(400_000.0 if step in (6, 7) else 1_000.0)
        q.set(100 if step == 8 else 2)
        p.set(0.9 if step in (9, 10) else 0.1)
        seq.append(wd.check())
    health = wd.health()
    for trip in (t for fired in seq for t in fired):
        trip.pop("artifacts", None)
    health.pop("artifacts")
    if health["last_trip"]:
        health["last_trip"].pop("artifacts", None)
    events = [(ev["event"], ev.get("rule")) for ev in reg.spans()]
    return seq, health, events, wd, o.to_prometheus(reg)


def test_watchdog_trips_are_identical(tmp_path):
    mine = _watchdog_run(obs, tmp_path / "port")
    theirs = _watchdog_run(jobs, tmp_path / "jax")
    assert mine[0] == theirs[0]          # the trips each check fired
    assert mine[1] == theirs[1]          # health(), artifacts aside
    assert mine[2] == theirs[2]          # watchdog / watchdog_clear spans
    assert mine[4] == theirs[4]          # the trip counters
    rules = sorted({t["rule"] for fired in mine[0] for t in fired})
    assert rules == ["latency_slo", "padding_waste", "queue_growth",
                     "spike_rate_drift"]
    assert ("watchdog_clear", "spike_rate_drift") in mine[2]
    wd = mine[3]
    assert len(wd.artifacts) == 2 * wd.trips_total
    from repro_torch.obs import validate as vcli
    for path in wd.artifacts:
        args = [path, "--trace"] if path.endswith(".trace.json") else \
            [path, "--require-spans", "watchdog"]
        assert vcli.main(args) == 0


def test_histogram_quantile_matches_repro():
    for o in (obs, jobs):
        reg = o.MetricsRegistry()
        h = reg.histogram("lat", edges=(10.0, 100.0, 1000.0))
        for v in (5.0,) * 90 + (500.0,) * 10:
            h.observe(v)
        got = [o.histogram_quantile(h, q) for q in (0.5, 0.9, 0.95, 1.0)]
        assert got == [10.0, 10.0, 1000.0, 1000.0]
        assert o.histogram_quantile(h.snapshot(), 0.95) == 1000.0


def test_server_endpoints_match_repro_and_shut_down():
    mine = obs.ObsServer(_drive(obs, obs.MetricsRegistry()), port=0,
                         health_fn=lambda: {"queue_depth": 3})
    theirs = jobs.ObsServer(_drive(jobs, jobs.MetricsRegistry()), port=0,
                            health_fn=lambda: {"queue_depth": 3})
    base = f"http://127.0.0.1:{mine.start()}"
    jbase = f"http://127.0.0.1:{theirs.start()}"
    try:
        status, ctype, body = _get(base + "/metrics")
        assert status == 200 and ctype == obs.PROMETHEUS_CONTENT_TYPE
        assert body == _get(jbase + "/metrics")[2]
        status, ctype, body = _get(base + "/healthz")
        hz = json.loads(body)
        assert status == 200 and "application/json" in ctype
        jhz = json.loads(_get(jbase + "/healthz")[2])
        assert set(hz) == set(jhz) and hz["queue_depth"] == 3
        assert hz["status"] == "ok" and hz["spans"] == jhz["spans"]
        page = json.loads(_get(base + "/spans?since=0")[2])
        assert [ev["event"] for ev in page["spans"]] == \
            ["enqueue", "admit", "step", "drain"]
        cursor = page["next_since"]
        assert json.loads(_get(base + f"/spans?since={cursor}")[2])[
            "spans"] == []
        page = json.loads(_get(base + "/spans?since=0&limit=2")[2])
        assert len(page["spans"]) == 2 and page["next_since"] == 2
        for bad, code in (("/spans?since=abc", 400), ("/nope", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + bad)
            assert e.value.code == code
        assert _get(base + "/")[2].startswith(b"repro_torch.obs")
    finally:
        mine.stop()
        theirs.stop()
    with pytest.raises(OSError):
        _get(base + "/metrics")


def test_healthz_degrades_and_reports_trips():
    def boom():
        raise RuntimeError("engine fell over")

    for fn, status in ((boom, "degraded"),
                       (lambda: {"watchdog": {"trips_total": 2}},
                        "tripped")):
        srv = obs.ObsServer(obs.MetricsRegistry(), port=0, health_fn=fn)
        try:
            hz = json.loads(_get(f"http://127.0.0.1:{srv.start()}"
                                 "/healthz")[2])
        finally:
            srv.stop()
        assert hz["status"] == status


def _validate(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.validate", *args],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def test_validate_cli_exit_codes(tmp_path):
    from repro_torch.obs import validate as vcli

    path = obs.write_jsonl(_drive(obs, obs.MetricsRegistry()),
                           str(tmp_path / "m.jsonl"))
    assert vcli.main([path]) == 0
    assert vcli.main([path, "--require-spans", "enqueue,drain",
                      "--require-metrics",
                      "snn_serve_requests_total,frac"]) == 0
    assert vcli.main([path, "--require-spans", "missing_event"]) == 1
    assert vcli.main([path, "--require-metrics", "missing_metric"]) == 1
    assert vcli.main([str(tmp_path / "nope.jsonl")]) == 1
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"kind": "counter", "name": "x",
                               "labels": {}, "value": 1}) + "\n")
    assert vcli.main([str(bad)]) == 1
    trace = obs.export_chrome_trace(_golden_spans(),
                                    str(tmp_path / "t.trace.json"))
    out = _validate(trace, "--trace")
    assert out.returncode == 0 and "valid Chrome trace" in out.stdout
    out = _validate(str(bad))
    assert out.returncode == 1 and "first line must be kind=meta" in \
        out.stderr
    assert _validate(path, "--require-spans", "admit").returncode == 0


# ---------------------------------------------------------------------------
# the engine's instruments and spans against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    from repro.deploy import deploy as jdeploy
    from repro.deploy import deploy_config as jdeploy_config
    from repro.models import snn_cnn as jsnn
    from repro_torch.deploy import deploy, deploy_config
    from repro_torch.models import snn_cnn

    jcfg = jdeploy_config("vgg9", 4)
    jmodel = jdeploy(jsnn.init(jax.random.PRNGKey(0), jcfg), jcfg)
    cfg = deploy_config("vgg9", 4)
    model = deploy(snn_cnn.init(0, cfg, device="cpu"), cfg, device="cpu")
    return jmodel, model


def _serve(pkg, model, reg, images, **kw):
    eng = pkg.SNNServeEngine(model, pkg.SNNEngineConfig(max_batch=2),
                             registry=reg, **kw)
    eng.warmup()
    for uid, img in enumerate(images):
        eng.add_request(pkg.SNNRequest(uid=uid, image=img))
    eng.run_until_done()
    eng.close()
    return eng


_TIMED = ("ts_us", "seq", "compile_us", "compute_us", "queue_us",
          "latency_us")


def test_engine_instruments_and_spans_match_repro(engines):
    import repro.deploy as jdeploy_pkg
    import repro_torch.deploy as deploy_pkg

    jmodel, model = engines
    images = np.random.default_rng(0).random(
        (3, model.cfg.img_size, model.cfg.img_size,
         model.cfg.in_channels)).astype(np.float32)
    jreg, reg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    _serve(jdeploy_pkg, jmodel, jreg, images)
    eng = _serve(deploy_pkg, model, reg, images, device="cpu")

    def metrics(r):
        out = {}
        for m in r.snapshot()["metrics"]:
            key = (m["name"], tuple(sorted(m["labels"].items())))
            out[key] = (m["kind"], m.get("value"), m.get("count"),
                        m.get("edges"))
        return out
    mine, theirs = metrics(reg), metrics(jreg)
    assert mine == theirs
    assert mine[("snn_serve_requests_total", ())][1] == 3
    assert mine[("snn_serve_compile_total", (("result", "miss"),))][1] == 2
    assert mine[("snn_serve_compile_total", (("result", "hit"),))][1] == 2
    spans = [{k: v for k, v in ev.items() if k not in _TIMED}
             for ev in reg.spans()]
    jspans = [{k: v for k, v in ev.items() if k not in _TIMED}
              for ev in jreg.spans()]
    assert spans == jspans
    assert [s["event"] for s in spans] == [
        "compile", "compile", "enqueue", "enqueue", "enqueue", "admit",
        "step", "drain", "drain", "admit", "step", "drain", "close"]
    # the histograms' counts reconcile with the engine's totals
    assert reg.find("snn_serve_latency_us").count == eng.total_requests
    assert reg.find("snn_serve_batches_total").value == eng.total_batches


def test_engine_default_registry_records_nothing(engines):
    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine)

    _, model = engines
    obs.disable_default()
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=1), device="cpu")
    assert eng.obs is obs.default_registry() and not eng.obs.enabled
    assert eng._m_requests is obs.NULL_INSTRUMENT
    img = np.zeros((model.cfg.img_size, model.cfg.img_size,
                    model.cfg.in_channels), np.float32)
    eng.add_request(SNNRequest(uid=0, image=img))
    assert eng.run_until_done()["requests"] == 1
    assert eng.obs.snapshot() == {"metrics": [], "spans": []}


def test_concurrent_scrape_and_watchdog_while_engine_steps(engines):
    """A scraper hammers /metrics and /healthz while the engine steps;
    an absurd SLO makes the engine's per-microbatch check trip, and
    health() carries the watchdog's state."""
    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine)

    _, model = engines
    cfg = model.cfg
    reg = obs.MetricsRegistry()
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=4), device="cpu",
                         registry=reg)
    wd = obs.Watchdog(reg, cfg=obs.WatchdogConfig(slo_p95_ms=1e-6))
    eng.attach_watchdog(wd)
    srv = obs.ObsServer(reg, port=0, health_fn=eng.health)
    base = f"http://127.0.0.1:{srv.start()}"
    eng.warmup()
    failures, stop = [], threading.Event()

    def scrape():
        while not stop.is_set():
            try:
                status, _, body = _get(base + "/metrics")
                if status != 200 or b"snn_serve" not in body:
                    failures.append((status, body[:100]))
                _get(base + "/healthz")
            except Exception as e:      # noqa: BLE001 — record, don't die
                failures.append(repr(e))

    t = threading.Thread(target=scrape, daemon=True)
    t.start()
    rng = np.random.default_rng(0)
    try:
        for uid in range(8):
            eng.add_request(SNNRequest(uid=uid, image=rng.random(
                (cfg.img_size, cfg.img_size,
                 cfg.in_channels)).astype(np.float32)))
            eng.step()
    finally:
        stop.set()
        t.join(timeout=10)
    try:
        assert not t.is_alive() and not failures, failures[:3]
        assert wd.trips_total >= 1
        hz = json.loads(_get(base + "/healthz")[2])
        assert hz["status"] == "tripped"
        assert hz["watchdog"]["trips_total"] == wd.trips_total
        assert hz["requests_total"] == 8
        assert hz["compile_cache"]["compiles"] == len(eng.buckets)
        text = _get(base + "/metrics")[2].decode()
        assert "snn_serve_requests_total 8.0" in text
        assert 'snn_watchdog_trips_total{rule="latency_slo"} 1.0' in text
    finally:
        srv.stop()


def test_health_watchdog_key_matches_repro(engines):
    import repro.deploy as jdeploy_pkg
    import repro_torch.deploy as deploy_pkg

    jmodel, model = engines
    jeng = jdeploy_pkg.SNNServeEngine(
        jmodel, jdeploy_pkg.SNNEngineConfig(max_batch=2),
        registry=jobs.MetricsRegistry())
    eng = deploy_pkg.SNNServeEngine(
        model, deploy_pkg.SNNEngineConfig(max_batch=2), device="cpu",
        registry=obs.MetricsRegistry())
    assert "watchdog" not in eng.health()
    jeng.attach_watchdog(jobs.Watchdog(jeng.obs))
    eng.attach_watchdog(obs.Watchdog(eng.obs))
    h, jh = eng.health(), jeng.health()
    assert set(h) == set(jh)
    assert h["watchdog"] == jh["watchdog"]
