"""SNN serving launcher: packed spiking inference on a synthetic stream.

Packs a randomly initialized model (seeded) once with ``deploy`` and
serves a synthetic request stream through :class:`SNNServeEngine`.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_snn [--full]
      [--model vgg9|vgg16|resnet18] [--fusion off|auto] [--bits 4]
      [--requests 32] [--max-batch 8] [--package PATH] [--show-graph]
      [--metrics [PATH]] [--trace [PATH]] [--profile [DIR]]
      [--device cuda|cpu]

``--fusion auto`` plans the model's fusion groups (vgg9: one chain of
convs.1-4 and the pools; resnet18: the five stride-1 block bodies), each
served by one launch of the ``fused_group`` kernel.  vgg16 is the
paper's Table II network.

``--async`` routes the stream through the continuous-batching tier
(``repro_torch.serve_async``): per-request futures, ``--workers``
threads, ``--deadline-ms`` admission deadlines, graceful drain on exit.
``--rate R`` switches submission to an open-loop Poisson arrival
process at R requests/s (with ``--async``); the sync-vs-async open-loop
comparison lives in ``python -m repro_torch.serve_async.loadgen``.

The observability plane hangs off four flags: ``--metrics [PATH]``
writes a JSONL snapshot on exit, ``--metrics-port`` starts the
in-process HTTP server (/metrics, /healthz, /spans) for scraping during
the run, ``--trace [PATH]`` exports the span ring as a Chrome/Perfetto
trace on exit, and ``--hold S`` keeps the server (and process) alive S
extra seconds after serving.  Any of ``--metrics``/``--metrics-port``/
``--trace`` enables the registry and, before serving, runs two sampled
forwards of 2 images: the telemetry pass (per-layer spike rate,
saturation, silence and resets, ``layer_telemetry`` spans), whose rates
become the SLO watchdog's spike-rate calibration, and the attribution
pass (blocked wall time per node beside its H100 roofline prediction,
``snn_layer_time_us`` and ``predicted_vs_measured`` spans).  After
serving, the packed weights' code utilization is emitted
(``code_utilization`` spans).  The watchdog takes ``--slo-p95-ms`` and
writes flight-recorder artifacts to ``--watchdog-dir``.  With none of
these flags the hot path keeps its no-op instruments.

``--profile [DIR]`` traces the serving loop (sync or async) with
``torch.profiler`` into DIR (default ``build/trace/serve_snn``): a
Chrome/Perfetto JSON with the card's kernels and one
``snn_serve_step/b<bucket>`` range per microbatch.
``--data-parallel`` is not ported yet.

``--device`` defaults to ``cuda``; without a card the launcher raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    from repro_torch import obs
    from repro_torch.launch.profiling import (
        TRACE_DIR, add_profile_flag, maybe_trace,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vgg9",
                    choices=("vgg9", "vgg16", "resnet18"))
    ap.add_argument("--fusion", default="off", choices=("off", "auto"),
                    help="multi-layer fusion groups (fused_group kernel)")
    ap.add_argument("--bits", type=int, default=4, choices=(2, 4, 8))
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    default=True, help="reduced model geometry (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="paper-size model geometry")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--package", default="",
                    help="save the packed model npz here and reload it "
                         "before serving, exercising the artifact path")
    ap.add_argument("--show-graph", action="store_true",
                    help="print the model graph, with fusion-group "
                         "membership and each group's shared memory")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="serve through the continuous-batching async "
                         "tier (repro_torch.serve_async): emplace-on-"
                         "arrival admission, pipelined rollouts, "
                         "per-request futures, graceful drain on exit")
    ap.add_argument("--workers", type=int, default=1,
                    help="async-tier worker threads (with --async)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="async admission deadline; expired requests "
                         "resolve as explicit timeout results "
                         "(with --async)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="offered load in requests/s; >0 submits on a "
                         "seeded Poisson arrival schedule (open loop) "
                         "instead of enqueueing everything up front "
                         "(with --async)")
    add_profile_flag(ap, str(TRACE_DIR / "serve_snn"))
    obs.add_metrics_flag(ap, str(obs.ARTIFACT_DIR / "serve_snn.jsonl"))
    obs.add_server_flag(ap)
    ap.add_argument("--trace", nargs="?",
                    const=str(obs.ARTIFACT_DIR / "serve_snn.trace.json"),
                    default=None, metavar="PATH",
                    help="export the span ring as a Chrome trace_event "
                         "JSON on exit; validate with python -m "
                         "repro_torch.obs.validate PATH --trace")
    ap.add_argument("--slo-p95-ms", type=float, default=250.0,
                    help="watchdog p95 latency SLO (ms)")
    ap.add_argument("--watchdog-dir", default="",
                    help="flight-recorder artifact directory; empty = no "
                         "artifacts on trip")
    ap.add_argument("--hold", type=float, default=0.0, metavar="S",
                    help="keep the process (and --metrics-port server) "
                         "alive S seconds after serving, for external "
                         "scrapes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.deploy import (
        SNNEngineConfig, SNNServeEngine, deploy, deploy_config, load,
    )
    from repro_torch.device import resolve_device
    from repro_torch.models import snn_cnn

    device = resolve_device(args.device)
    # enable BEFORE building the engine: instruments bind at construction
    metrics_on = bool(args.metrics or args.trace
                      or args.metrics_port is not None)
    registry = obs.enable_default() if metrics_on else None

    cfg = deploy_config(args.model, args.bits, smoke=args.smoke,
                        fusion="auto" if args.fusion == "auto" else ())
    params = snn_cnn.init(0, cfg, device=device)
    t0 = time.perf_counter()
    model = deploy(params, cfg, device=device)
    print(f"packed {cfg.model} W{args.bits} on {device} in "
          f"{time.perf_counter() - t0:.2f}s: {len(model.layers)} layers, "
          f"{model.nbytes_packed() / 1e6:.2f} MB packed "
          f"({model.compression_ratio():.1f}x vs fp32)")
    if args.package:
        model.save(args.package)
        model = load(args.package, device=device)
        print(f"saved + reloaded package: {args.package}")

    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=args.max_batch),
                         device=device)
    if cfg.fusion or args.show_graph:
        print(eng.graph_summary())
    aeng = None
    if args.use_async:
        from repro_torch.serve_async import (
            AsyncEngineConfig, AsyncSNNServeEngine,
        )

        aeng = AsyncSNNServeEngine(eng, AsyncEngineConfig(
            workers=args.workers, default_deadline_ms=args.deadline_ms))
    server = None
    if args.metrics_port is not None:
        server = obs.ObsServer(registry, port=args.metrics_port,
                               health_fn=(aeng or eng).health)
        port = server.start()
        print(f"[obs] serving http://127.0.0.1:{port}/metrics "
              f"(/healthz, /spans?since=N)")
    watchdog = None
    try:
        n_warm = eng.warmup()
        print(f"warmup ran {n_warm} bucket forwards: {eng.buckets}")
        rng = np.random.default_rng(0)
        sample = rng.random((2, cfg.img_size, cfg.img_size,
                             cfg.in_channels)).astype(np.float32)
        images = [rng.random((cfg.img_size, cfg.img_size,
                              cfg.in_channels)).astype(np.float32)
                  for _ in range(min(args.requests, 16))]
        if metrics_on:
            # before serving: the telemetry rates are the watchdog's
            # calibration, and the attribution pass puts
            # snn_layer_time_us on /metrics before the first scrape
            watchdog = obs.Watchdog(
                registry, calibration=_sampled_passes(
                    cfg, model, sample, registry, device),
                cfg=obs.WatchdogConfig(
                    slo_p95_ms=args.slo_p95_ms,
                    artifact_dir=args.watchdog_dir or None))
            eng.attach_watchdog(watchdog)
        with maybe_trace(args.profile, device):
            stats = _serve(args, eng, aeng, images)
        if metrics_on:
            util = obs.package_code_utilization(model, registry=registry)
            for name, h in util.items():
                print(f"[obs] {name:<12} W{h['bits']} code util "
                      f"{h['utilization']:.2f} clip {h['clip_frac']:.3f}")
            tripped = sorted({t["rule"] for t in watchdog.trips})
            print(f"[obs] watchdog: {watchdog.trips_total} trips"
                  + (f" ({', '.join(tripped)})" if tripped else ""))
        if args.hold > 0:
            print(f"[obs] holding {args.hold:.0f}s for external scrapes")
            time.sleep(args.hold)
        meta = {"entry": "serve_snn", "model": args.model,
                "bits": args.bits, "device": str(device)}
        if args.metrics:
            out = obs.write_jsonl(registry, args.metrics, meta=meta)
            print(f"[obs] metrics written to {out}; validate with "
                  f"`python -m repro_torch.obs.validate {out}`")
        if args.trace:
            out = obs.export_chrome_trace(registry, args.trace, meta=meta)
            print(f"[obs] Chrome trace written to {out}; validate with "
                  f"`python -m repro_torch.obs.validate {out} --trace`")
    finally:
        if aeng is not None:
            aeng.close(drain=False)      # no-op after the graceful close
        if server is not None:
            server.stop()
    return stats


def _sampled_passes(cfg, model, sample, registry, device):
    """The sampled observability forwards over ``sample`` (2 images): the
    telemetry pass, then the attribution pass, each printed.  Returns
    the telemetry's per-layer spike rates, the watchdog's calibration:
    live drift is judged against what the model did at deploy time."""
    import torch

    from repro_torch import obs

    x = torch.from_numpy(sample).to(device)
    _, layer_records = obs.instrumented_forward(
        cfg, model.float_params, x, package=model, registry=registry)
    for row in layer_records:
        print(f"[obs] {row['layer']:<12} rate={row['rate']:.3f} "
              f"saturation={row['saturation']:.3f} "
              f"silent={row['silent']:.3f} resets={row['resets']}")
    _, timed_records = obs.timed_forward(
        cfg, model.float_params, x, package=model, registry=registry)
    summ = obs.attribution_summary(timed_records)
    print(f"[obs] attribution: {summ['nodes']} nodes, "
          f"{summ['wall_us'] / 1e3:.3f} ms measured vs "
          f"{summ['predicted_us']:.1f} us H100 roofline "
          f"(hottest {summ['hottest_layer']} "
          f"{summ['hottest_wall_us'] / 1e3:.3f} ms)")
    return {row["layer"]: row["rate"] for row in layer_records}


def _serve(args, eng, aeng, images):
    """Serve the synthetic stream (sync or async) on a warm engine and
    print the stats line.  Returns the stats."""
    from repro_torch.deploy import SNNRequest

    if aeng is not None:
        from repro_torch.serve_async import (
            poisson_schedule, run_open_loop_async,
        )

        aeng.start()
        t0 = time.perf_counter()
        if args.rate > 0:
            rep = run_open_loop_async(
                aeng, np.stack(images),
                poisson_schedule(args.rate, args.requests),
                deadline_ms=args.deadline_ms)
            print(rep.summary())
        else:
            futs = [aeng.submit(images[uid % len(images)])
                    for uid in range(args.requests)]
            done = sum(f.result(timeout=300).ok for f in futs)
            print(f"{done}/{args.requests} futures resolved ok")
        aeng.close()            # graceful drain: flushes queue + pipeline
        stats = aeng.stats(wall_s=time.perf_counter() - t0)
        a = stats["async"]
        print(f"async tier: {a['workers']} workers, "
              f"{a['submitted']} submitted / {a['completed']} completed "
              f"/ {a['timeouts']} timeout / {a['cancelled']} cancelled, "
              f"{a['slots_recycled']} slot recycles "
              f"(capacity {a['slot_capacity']}), "
              f"p99={stats['latency_p99_ms']:.2f}ms")
    else:
        for uid in range(args.requests):
            eng.add_request(SNNRequest(uid=uid,
                                       image=images[uid % len(images)]))
        t0 = time.perf_counter()
        eng.run_until_done(max_steps=args.requests)
        stats = eng.stats(wall_s=time.perf_counter() - t0)
    print(f"served {stats['requests']} requests in {stats['wall_s']:.3f}s "
          f"({stats['images_per_s']:.1f} img/s, {stats['batches']} batches, "
          f"latency p50={stats['latency_p50_ms']:.2f}ms "
          f"p95={stats['latency_p95_ms']:.2f}ms, "
          f"queue avg={stats['queue_avg_ms']:.2f}ms vs "
          f"compute avg={stats['compute_avg_ms']:.2f}ms, "
          f"padding waste={stats['padding_waste']:.0%})")
    return stats


if __name__ == "__main__":
    main()
