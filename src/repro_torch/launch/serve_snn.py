"""SNN serving launcher: packed spiking inference on a synthetic stream.

Packs a randomly initialized model (seeded) once with ``deploy`` and
serves a synthetic request stream through :class:`SNNServeEngine`.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve_snn [--full]
      [--model vgg9|resnet18] [--fusion off|auto] [--bits 4]
      [--requests 32] [--max-batch 8] [--package PATH]
      [--device cuda|cpu]

``--fusion auto`` plans the model's fusion groups (vgg9: one chain of
convs.1-4 and the pools; resnet18: the five stride-1 block bodies), each
served by one launch of the ``fused_group`` kernel.

``--device`` defaults to ``cuda``; without a card the launcher raises
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vgg9", choices=("vgg9", "resnet18"))
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config,
        load,
    )
    from repro_torch.device import resolve_device
    from repro_torch.models import snn_cnn

    device = resolve_device(args.device)
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
    if cfg.fusion:
        print(eng.graph_summary())
    n_warm = eng.warmup()
    print(f"warmup ran {n_warm} bucket forwards: {eng.buckets}")

    rng = np.random.default_rng(0)
    images = [rng.random((cfg.img_size, cfg.img_size,
                          cfg.in_channels)).astype(np.float32)
              for _ in range(min(args.requests, 16))]
    for uid in range(args.requests):
        eng.add_request(SNNRequest(uid=uid, image=images[uid % len(images)]))
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
