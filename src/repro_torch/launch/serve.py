"""LM serving launcher: the continuous-batching engine on synthetic
prompts.

Port of ``repro.launch.serve``, with the same flags plus ``--device``:

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch olmo-1b]
        [--smoke | --full] [--requests 8] [--slots 4] [--max-new 16]
        [--quant-bits 16] [--device cuda|cpu]

``--arch`` takes every decoder family (dense, MoE, Mamba-2, the Hymba
hybrid, PaliGemma's decoder without an image); the engine refuses the
audio family, as JAX's does.  ``--quant-bits 2|4|8`` sets the model's precision to that width with one
scale per output channel, which (as in the JAX launcher) runs every
linear fake-quantized.  Params are random from seed 0.  ``--device``
defaults to ``cuda``; without a card the launcher raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.configs import add_geometry_flags

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    add_geometry_flags(ap)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant-bits", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models.api import get_model
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quant_bits != 16:
        cfg = dataclasses.replace(
            cfg, precision=PrecisionConfig(bits=args.quant_bits,
                                           group_size=-1))
    params = get_model(cfg).init(0, device=device)
    eng = ServeEngine(cfg, params, EngineConfig(slots=args.slots,
                                                max_len=256), device=device)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = int(rng.integers(4, 24))
        eng.add_request(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab, plen).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    stats = eng.run_until_done()
    print(stats)
    return stats


if __name__ == "__main__":
    main()
