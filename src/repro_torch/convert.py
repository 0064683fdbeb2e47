"""Carry float params across from the JAX package.

``repro``'s params are a nested dict/list tree of arrays; pass it through
``jax.tree.map(np.asarray, params)`` on the JAX side and hand the numpy
tree here.  The layout is unchanged (HWIO conv weights, (in, out) dense
weights), so the port's ``deploy`` packs the same words from it.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_numpy(tree, device="cuda"):
    """Nested dict/list tree of numpy arrays -> the same tree of tensors on
    ``device``; non-array leaves (Python ints such as a block stride) are
    kept as they are."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree
