"""Sharding rules: param/batch/cache specs for the 2D (+pod) mesh.

Port of ``repro.distributed.sharding``, on ``torch.distributed``'s
``DeviceMesh`` and DTensor placements.  The strategy is JAX's:

* weights: FSDP over ``data`` on the contraction dim x TP over ``model``
  on the output/head/ff dim ("train"); TP only ("serve");
* activations/batch: batch over ``data`` (``pod`` in front of it);
* KV cache / SSM state: resident, sharded over both axes.

Every rule checks divisibility: a dim that does not divide its axis
stays replicated.

Where the compute splits as these specs lay the weights out: the train
step (``launch/steps.py``, ``make_train_step(tensor_parallel=True)``)
and the prefill and decode steps of every family (olmo-1b,
stablelm-1.6b, gemma2-2b, internlm2-20b, paligemma-3b,
granite-moe-3b-a800m, moonshot-v1-16b-a3b, mamba2-1.3b, hymba-1.5b,
whisper-base) gather each weight over ``data`` only and run
column/row-parallel over ``model`` (``distributed/tensor_parallel``;
the stacked experts split on ``d_ff_expert``, the Mamba-2 mixer on its
heads, whisper's ``xattn/`` as ``attn/``; heads that do not divide
``model``, gemma2-2b's, paligemma-3b's and whisper-base's 8 and
granite's 24 on 16 ranks, run whole on every rank); the train step
without ``tensor_parallel=True`` gathers every weight whole (FSDP):
there ``model`` holds shards but does not split the compute.

A spec is :class:`P`, a tuple whose entries are ``None``, an axis name
or a tuple of names, so ``tuple(spec) == tuple(jax_spec)`` compares it
with JAX's ``PartitionSpec``.  The port keeps an LM's layer stack as a
list of per-layer dicts, so a leaf ``layers/<i>/...`` has no leading
stack dim: its spec is JAX's stacked spec without the leading ``None``.

:func:`to_shardings` is ``NamedSharding``: each mesh dim becomes
``Shard(d)`` where its name appears in entry ``d`` and ``Replicate()``
otherwise.  A tuple entry must name its axes in mesh order: JAX shards a
dim under ``("model", "data")`` model-major, DTensor shards one dim in
mesh-dim order, so on a (data, model) mesh the two would give different
ranks different rows.  :func:`to_shardings` raises for such an entry
(``cache_entry_spec`` emits one for a KV cache whose heads do not divide
``model``).  :func:`distribute` is ``jax.device_put(tree, shardings)``.
"""

from __future__ import annotations

import dataclasses
import re

from repro_torch.launch.mesh import axis_sizes
from repro_torch.tree import map_tree, map_tree_with_path


class P(tuple):
    """A partition spec: one entry per tensor dim (``None``, an axis name
    or a tuple of axis names)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return axis_sizes(mesh)[name]


def _fits(mesh, dim: int, axis) -> bool:
    return dim % _axis_size(mesh, axis) == 0 and dim >= _axis_size(mesh, axis)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


# --- sharding variant ---------------------------------------------------------
# "train": FSDP x TP (ZeRO-style); "serve": TP only (no optimizer state, so
# the per-layer FSDP all-gathers leave the serve path)
_VARIANT = "train"


def set_variant(name: str) -> None:
    global _VARIANT
    if name not in ("train", "serve"):
        raise ValueError(name)
    _VARIANT = name


def get_variant() -> str:
    return _VARIANT


# --- parameter rules --------------------------------------------------------
# (regex on path, spec for the TRAILING dims; leading dims get None)
_PARAM_RULES = [
    (r"embed$", ("model", None)),            # vocab sharded (memory + logits)
    (r"lm_head/w$", ("data", "model")),
    (r"vision_proj/w$", ("data", "model")),
    (r"attn/w[qkv]/w$", ("data", "model")),
    (r"attn/w[qkv]/b$", ("model",)),
    (r"attn/wo/w$", ("model", "data")),
    (r"attn/wo/b$", (None,)),
    (r"xattn/w[qkv]/w$", ("data", "model")),
    (r"xattn/w[qkv]/b$", ("model",)),
    (r"xattn/wo/w$", ("model", "data")),
    (r"xattn/wo/b$", (None,)),
    (r"mlp/w[ig]/w$", ("data", "model")),
    (r"mlp/wo/w$", ("model", "data")),
    (r"mlp/router$", (None, None)),
    (r"mlp/w[ig]$", (None, "data", "model")),   # moe stacked (E, d, f)
    (r"mlp/wo$", (None, "model", "data")),      # moe stacked (E, f, d)
    (r"mlp/shared_w[ig]$", ("data", "model")),
    (r"mlp/shared_wo$", ("model", "data")),
    (r"ssm/in_proj/w$", ("data", "model")),
    (r"ssm/out_proj/w$", ("model", "data")),
    (r"ssm/conv_w$", (None, "model")),
    (r"ssm/conv_b$", ("model",)),
    (r"ssm/(A_log|dt_bias|D)$", ("model",)),
    (r"ssm/norm_g$", ("model",)),
    (r"mix_scale$", (None, None)),
]


def param_spec(path, leaf, mesh) -> P:
    """Spec of one param leaf (``path`` a tuple of keys and indices)."""
    ps = _path_str(path)
    shape = tuple(leaf.shape)
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, ps):
            if _VARIANT == "serve":
                # drop the FSDP ('data') factor: weights stay TP-sharded
                trailing = tuple(None if a == "data" else a
                                 for a in trailing)
            n_lead = len(shape) - len(trailing)
            return P(*([None] * n_lead), *(
                a if a is not None and _fits(mesh, shape[n_lead + i], a)
                else None
                for i, a in enumerate(trailing)))
    # fallback: replicate small things (norms, scalars)
    return P(*([None] * len(shape)))


def param_specs(params_shape, mesh):
    return map_tree_with_path(lambda p, l: param_spec(p, l, mesh),
                              params_shape)


# --- batch / cache rules ----------------------------------------------------

def batch_spec(name: str, shape, mesh, dp_axes=("data",)) -> P:
    """tokens/labels (B, S); frames/vision_embeds (B, S, d)."""
    b = shape[0]
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    first = dp if _fits(mesh, b, dp) else (
        dp_axes[0] if _fits(mesh, b, dp_axes[0]) else None)
    return P(first, *([None] * (len(shape) - 1)))


def cache_entry_spec(name: str, shape, mesh, dp_axes=("data",)) -> P:
    """KV cache (L, B, S, K, hd) / conv (L, B, W, C) / ssm (L, B, nh, hp,
    N), the JAX package's stacked layout.

    Greedy: B takes data if divisible; model goes to the first divisible
    of the preferred dims; leftover axes stack onto the seq dim when
    possible."""
    if name == "len" or len(shape) == 0:
        return P()
    dims = list(shape)
    spec: list = [None] * len(dims)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    used_data = False
    # dim 1 is batch for all cache entries
    if len(dims) >= 2 and _fits(mesh, dims[1], dp):
        spec[1] = dp
        used_data = True
    if name in ("k", "v", "xk", "xv", "k_scale", "v_scale"):
        _, _, s_, k_, _ = dims
        if _fits(mesh, k_, "model"):
            spec[3] = "model"
        elif not used_data and _fits(mesh, s_, ("model",) + tuple(dp_axes)):
            spec[2] = ("model",) + tuple(dp_axes)
        elif _fits(mesh, s_, "model"):
            spec[2] = "model"
        if not used_data and spec[2] is None and _fits(mesh, s_, dp):
            spec[2] = dp
    elif name == "ssm":
        _, _, nh_, hp_, n_ = dims
        if _fits(mesh, nh_, "model"):
            spec[2] = "model"
        elif _fits(mesh, hp_, "model"):
            spec[3] = "model"
        if not used_data:
            if spec[3] is None and _fits(mesh, hp_, dp):
                spec[3] = dp
            elif _fits(mesh, n_, dp):
                spec[4] = dp
    elif name == "conv":
        if _fits(mesh, dims[-1], "model"):
            spec[-1] = "model"
    return P(*spec)


def cache_specs(cache_shape, mesh, dp_axes=("data",)):
    return {k: cache_entry_spec(k, v.shape, mesh, dp_axes)
            for k, v in cache_shape.items()}


def logits_spec(cfg, batch_size: int, mesh) -> P:
    """Serving logits ``(B, vocab)``: the batch over ``data`` and the
    vocab over ``model``, each where it divides (JAX's dry run gives
    its prefill and decode steps this out sharding)."""
    sizes = axis_sizes(mesh)
    return P("data" if batch_size % sizes["data"] == 0 else None,
             "model" if cfg.vocab % sizes["model"] == 0 else None)


def opt_state_specs(pspecs, mesh):
    return {"m": pspecs, "v": _map_specs(lambda s: s, pspecs), "step": P()}


# --- placements ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: JAX's ``NamedSharding``.  ``placements`` holds
    one DTensor placement per mesh dim."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(axis_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            pos = [names.index(a) for a in axes]
            if pos != sorted(pos):
                raise ValueError(
                    f"spec {self.spec}: dim {d} names {axes} out of mesh "
                    f"order {tuple(names)}; DTensor would shard it "
                    f"mesh-major where JAX shards it in the order given")
            for i in pos:
                out[i] = Shard(d)
        return tuple(out)


def _map_specs(fn, specs):
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    raise TypeError(f"not a spec tree leaf: {specs!r}")


def to_shardings(specs, mesh):
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def place(t, sh: NamedSharding):
    """One tensor (or DTensor) laid out as ``sh`` says.  A plain tensor
    (the same full value on every rank) is split without communication;
    a DTensor is redistributed on its mesh, or gathered whole and split
    onto another mesh."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        if t.device_mesh == sh.mesh:
            return t.redistribute(sh.mesh, sh.placements)
        t = t.full_tensor()
    return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)


def distribute(tree, shardings):
    """``jax.device_put(tree, shardings)``: every leaf of ``tree`` placed
    by the matching leaf of ``shardings`` (same structure)."""
    return map_tree(place, tree, shardings)
