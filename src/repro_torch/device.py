"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Turn a ``device=`` argument into a ``torch.device``.

    The entry points default to ``"cuda"``.  A CUDA device on a host
    without a usable card raises: the port never drops to the CPU on its
    own, the caller has to ask for ``device="cpu"``.
    """
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(d)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions on "
            f"the CPU")
    if d.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(d)!r} (cuda, cpu or "
                         f"meta)")
    return d


def generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator for random init on ``device`` (a CPU one for
    ``meta``, which has none and draws nothing)."""
    dev = "cpu" if device.type == "meta" else device
    return torch.Generator(device=dev).manual_seed(seed)
