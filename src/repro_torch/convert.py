"""Carry params across from the JAX package.

``repro``'s params are nested dict/list trees of arrays; pass one through
``jax.tree.map(np.asarray, params)`` on the JAX side and hand the numpy
tree here.  Layouts are unchanged (HWIO conv weights, (in, out) dense
weights), so the port's ``deploy`` packs the same words from them.

A ``QuantizedTensor`` of the JAX package survives ``jax.tree.map`` as an
object with numpy ``data``/``scale``/``zero`` and its ``shape``, ``bits``
and ``group_size``; :func:`quantized_from_numpy` turns one into the port's
:class:`~repro_torch.quant.formats.QuantizedTensor` (an NCE engine's
weights, or a packed LM linear).  :func:`lm_params_from_numpy` turns an
LM param tree of any family, whose layer stacks (``layers``, and
whisper's ``enc_layers``/``dec_layers``) are stacked along a leading
layer axis (as ``jax.lax.scan`` wants them), into the port's lists of
per-layer dicts; every leaf is sliced along that axis, so MoE's stacked
experts ``(L, E, d, f)`` become ``(E, d, f)`` per layer, and a stacked
packed linear (data ``(L, n, kw)``, scale ``(L, n, g)``, per-layer
logical ``shape``) splits into one tensor per layer.
:func:`lm_params_to_numpy` is its inverse for dense trees (params,
gradients, optimizer moments): per-layer lists back to stacked numpy.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.quant.formats import QuantizedTensor


def params_from_numpy(tree, device="cuda"):
    """Nested dict/list tree of numpy arrays -> the same tree of tensors on
    ``device``; non-array leaves (Python ints such as a block stride) are
    kept as they are."""
    device = resolve_device(device)
    if _is_quantized(tree):
        return quantized_from_numpy(tree, device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.array(tree)).to(device)
    return tree


def _is_quantized(obj) -> bool:
    return all(hasattr(obj, a) for a in ("data", "scale", "zero", "shape",
                                         "bits", "group_size"))


def quantized_from_numpy(qt, device="cuda") -> QuantizedTensor:
    """A JAX ``QuantizedTensor`` with numpy leaves -> the port's, on
    ``device``."""
    device = resolve_device(device)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a)).to(
            device)

    return QuantizedTensor(data=t(qt.data), scale=t(qt.scale),
                           zero=t(qt.zero), shape=tuple(qt.shape),
                           bits=int(qt.bits), group_size=int(qt.group_size))


def _layer_slice(tree, i: int):
    """Layer ``i`` of a tree stacked along a leading layer axis."""
    if _is_quantized(tree):
        return types.SimpleNamespace(
            data=tree.data[i], scale=tree.scale[i],
            zero=None if tree.zero is None else tree.zero[i],
            shape=tree.shape, bits=tree.bits, group_size=tree.group_size)
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


#: the keys of an LM tree that hold a stack of layers
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def lm_params_from_numpy(tree, device="cuda"):
    """A JAX LM param tree (numpy leaves, layers stacked) -> the port's
    params: the same dict with each layer stack a list of per-layer
    dicts."""
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in LAYER_STACKS:
            out[k] = [params_from_numpy(_layer_slice(v, i), device)
                      for i in range(_first_leaf(v).shape[0])]
        else:
            out[k] = params_from_numpy(v, device)
    return out


def _first_leaf(tree):
    if _is_quantized(tree):
        return tree.data
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    return np.asarray(tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:      # numpy has no bfloat16; exact
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def _stack_layers(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers]) for k in first}
    if not isinstance(first, torch.Tensor):
        raise TypeError(f"lm_params_to_numpy: {type(first).__name__} "
                        f"leaf (dense tensors only)")
    return np.stack([_to_numpy(t) for t in layers])


def lm_params_to_numpy(params):
    """The port's LM tree (params, gradients or AdamW moments; each layer
    stack a list of per-layer dicts of dense tensors) -> JAX's layout:
    numpy leaves, each layer stack stacked along a leading layer axis.
    bfloat16 leaves come out as float32 (exact; numpy has no
    bfloat16)."""
    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return _to_numpy(tree)

    return {k: _stack_layers(v) if k in LAYER_STACKS else conv(v)
            for k, v in params.items()}
