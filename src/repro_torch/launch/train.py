"""Training launcher: the Trainer on synthetic token streams.

Port of ``repro.launch.train``, with the same flags plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        [--smoke] [--steps 50] [--batch 8] [--seq 128] [--lr 3e-4] \
        [--quant-bits 16|2|4|8] [--spiking-ffn] [--ckpt-dir DIR] \
        [--resume] [--metrics [PATH]] [--metrics-port PORT] \
        [--profile [DIR]] [--device cuda|cpu]

``--quant-bits 2|4|8`` trains with QAT fake-quant (one scale per output
channel), ``--spiking-ffn`` runs every FFN as a LIF population.  Without
``--resume`` the checkpoint directory (default ``build/ckpt/train``) is
emptied first; with it, training resumes from its newest checkpoint.
``--profile [DIR]`` traces the whole ``Trainer.run()`` with
``torch.profiler`` into DIR (default ``build/trace/train``), a
Chrome/Perfetto JSON with the card's kernels.  ``--device`` defaults to
``cuda``; without a card the launcher raises unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch import obs
    from repro_torch.launch.profiling import (
        TRACE_DIR, add_profile_flag, maybe_trace,
    )
    from repro_torch.train.trainer import DEFAULT_CKPT_DIR

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--quant-bits", type=int, default=16,
                    help="L-SPINE datapath: 2/4/8 = QAT fake-quant")
    ap.add_argument("--spiking-ffn", action="store_true",
                    help="L-SPINE spiking execution of FFN blocks")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    add_profile_flag(ap, str(TRACE_DIR / "train"))
    obs.add_metrics_flag(ap, str(obs.ARTIFACT_DIR / "train.jsonl"))
    obs.add_server_flag(ap)
    args = ap.parse_args(argv)

    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SpikingConfig
    from repro_torch.device import resolve_device
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quant_bits != 16:
        cfg = dataclasses.replace(
            cfg, precision=PrecisionConfig(bits=args.quant_bits,
                                           group_size=-1))
    if args.spiking_ffn:
        cfg = dataclasses.replace(cfg, spiking=SpikingConfig())

    tcfg = TrainConfig(
        steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        opt=opt.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                          total_steps=args.steps),
    )
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    # enable BEFORE constructing the trainer: instruments bind at
    # construction time.  --metrics-port implies the registry.
    metrics_on = bool(args.metrics or args.metrics_port is not None)
    registry = obs.enable_default() if metrics_on else None
    server = None
    if args.metrics_port is not None:
        server = obs.ObsServer(registry, port=args.metrics_port)
        port = server.start()
        print(f"[obs] serving http://127.0.0.1:{port}/metrics "
              f"(/healthz, /spans?since=N)")
    try:
        trainer = Trainer(cfg, tcfg, device=device)
        with maybe_trace(args.profile, device):
            out = trainer.run()
        print(f"first loss {out['first_loss']:.4f} -> "
              f"final loss {out['final_loss']:.4f}")
        if args.metrics:
            path = obs.write_jsonl(registry, args.metrics,
                                   meta={"entry": "train", "arch": args.arch,
                                         "steps": args.steps})
            print(f"[obs] metrics written to {path}; validate with "
                  f"`python -m repro_torch.obs.validate {path}`")
    finally:
        if server is not None:
            server.stop()
    return out


if __name__ == "__main__":
    main()
