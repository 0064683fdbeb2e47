"""Pipeline parallelism over the pod axis (GPipe schedule).

Port of ``repro.distributed.pipeline`` on ``torch.distributed``.  The
``pod`` mesh axis becomes pipeline stages: stage ``s`` owns layers
``[s*L/n, (s+1)*L/n)`` of the layer list; the embedding (and the final
norm) is replicated on every stage.

Each rank runs the GPipe schedule eagerly: ``n_micro + n_stages - 1``
ticks; at tick ``t`` stage ``s`` runs microbatch ``t - s`` when that is
in range (stage 0 embeds its microbatch, the others take what the
previous stage sent), sends its activations to stage ``s + 1`` and, on
the last stage, adds the microbatch's cross-entropy through the tied
embedding (after the final norm for rmsnorm only, as in JAX).  The
point-to-point send/recv on the ``pod`` group is an
``autograd.Function``, so ``loss.backward()`` sends each activation's
gradient back along the reverse permutation, which is what JAX gets from
``ppermute``'s transpose.  The loss is the summed cross-entropy over
``pod`` (and ``data_axis``) over the batch's label count.

Gradients land on the stage that owns the layers: a stage's tree holds
only its layers.  Each stage's layer gradients are summed over
``data_axis``; the replicated embedding's and final norm's over ``pod``
and ``data_axis`` (JAX's shard_map transpose of a replicated input).

Bubble fraction = (n_stages-1)/(n_micro + n_stages - 1).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.launch.mesh import axis_sizes
from repro_torch.tree import leaves, map_tree_with_path, unflatten_like


def stage_fwd(stage_layers, cfg: ArchConfig, x, windows):
    """Run this stage's layers on activations ``x``; returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, w in zip(stage_layers, windows):
        if cfg.remat != "none":
            x, a = checkpoint(T._block_full, lp, cfg, x, int(w),
                              use_reentrant=False)
        else:
            x, a = T._block_full(lp, cfg, x, int(w))
        aux = aux + a
    return x, aux


class _Send(torch.autograd.Function):
    """Send ``x`` to global rank ``peer``; backward receives its gradient
    from there.  Returns a zero scalar that ties the send to the loss."""

    @staticmethod
    def forward(ctx, x, peer: int, group):
        ctx.peer, ctx.group = peer, group
        ctx.like = x.new_empty(x.shape)
        dist.send(x.detach().contiguous(), peer, group=group)
        return x.new_zeros((), dtype=torch.float32)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty_like(ctx.like)
        dist.recv(g, ctx.peer, group=ctx.group)
        return g, None, None


class _Recv(torch.autograd.Function):
    """Receive into ``buf`` from global rank ``peer``;
    backward sends its gradient back there.  ``anchor`` (a scalar that
    requires grad) puts the receive on the graph."""

    @staticmethod
    def forward(ctx, anchor, buf, peer: int, group):
        ctx.peer, ctx.group = peer, group
        dist.recv(buf, peer, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.peer, group=ctx.group)
        return None, None, None, None


class _GradSum(torch.autograd.Function):
    """Identity on ``tensors``; backward all-reduces (sums) each one's
    gradient over ``groups`` in order.  The extra zero output is added
    to the loss so that every rank runs this backward, used or not."""

    @staticmethod
    def forward(ctx, groups, *tensors):
        ctx.groups = groups
        return (*(t.view_as(t) for t in tensors),
                tensors[0].new_zeros((), dtype=torch.float32))

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads[:-1]:
            g = g.contiguous()
            for grp in ctx.groups:
                dist.all_reduce(g, group=grp)
            out.append(g)
        return (None, *out)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) a scalar over ``groups``; backward is the
    identity (every rank seeds the replicated loss with 1)."""

    @staticmethod
    def forward(ctx, x, groups):
        x = x.detach().clone()
        for grp in groups:
            dist.all_reduce(x, group=grp)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_grads(groups, tensors: Sequence[torch.Tensor]):
    if not groups or not tensors:
        return list(tensors), None
    *out, anchor = _GradSum.apply(tuple(groups), *tensors)
    return out, anchor


def stage_bounds(cfg: ArchConfig, mesh) -> tuple:
    """This rank's stage and the layer range ``[lo, hi)`` it owns."""
    per = cfg.n_layers // axis_sizes(mesh)["pod"]
    stage = mesh.get_local_rank("pod")
    return stage, stage * per, (stage + 1) * per


def stage_params(params, cfg: ArchConfig, mesh):
    """What a stage holds: ``params`` with only its own layers."""
    _, lo, hi = stage_bounds(cfg, mesh)
    return {**params, "layers": params["layers"][lo:hi]}


def make_pipeline_loss(cfg: ArchConfig, mesh, n_micro: int,
                       data_axis: Optional[str] = None):
    """Returns ``loss_fn(params, batch)`` running the GPipe schedule over
    the ``pod`` axis of ``mesh`` (a ``DeviceMesh``).  ``params`` is the
    stage's tree (:func:`stage_params`) or the full tree, of which the
    stage takes its layers.  ``batch`` holds the global tokens/labels
    (the same on every rank); with ``data_axis`` each rank takes its
    slice of it along that axis (DP inside each stage)."""
    n_stages = axis_sizes(mesh)["pod"]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers over {n_stages} stages")
    windows_all = T.window_schedule(cfg)
    pod = mesh.get_group("pod")
    dgroups = (mesh.get_group(data_axis),) if data_axis else ()
    act_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def loss_fn(params, batch):
        stage, lo, hi = stage_bounds(cfg, mesh)
        layers = params["layers"]
        if len(layers) == cfg.n_layers:
            layers = layers[lo:hi]
        windows = windows_all[lo:hi]
        tokens, labels = batch["tokens"], batch["labels"]
        count = torch.clamp_min(torch.sum(labels >= 0).to(torch.float32),
                                1.0)
        if data_axis:
            j = mesh.get_local_rank(data_axis)
            per = tokens.shape[0] // axis_sizes(mesh)[data_axis]
            tokens = tokens[j * per:(j + 1) * per]
            labels = labels[j * per:(j + 1) * per]
        embed = params["embed"]
        norm_g = params["final_norm"].get("g")
        if norm_g is None:
            norm_g = torch.ones((cfg.d_model,), device=embed.device)
        # the stage's layers: gradients summed over data; the replicated
        # embedding and norm: over pod, then data
        flat, a_layers = _sum_grads(dgroups, leaves(layers))
        layers = unflatten_like(layers, flat)
        (embed, norm_g), a_rep = _sum_grads((pod,) + dgroups,
                                            [embed, norm_g])
        anchors = [a for a in (a_layers, a_rep) if a is not None]

        bm = tokens.shape[0] // n_micro
        toks_m = tokens.reshape(n_micro, bm, -1)
        lbls_m = labels.reshape(n_micro, bm, -1)
        prev = dist.get_global_rank(pod, stage - 1) if stage else None
        nxt = (dist.get_global_rank(pod, stage + 1)
               if stage < n_stages - 1 else None)
        shape = (bm, toks_m.shape[2], cfg.d_model)
        loss_sum = torch.zeros((), dtype=torch.float32, device=embed.device)
        for t in range(n_micro + n_stages - 1):
            if not 0 <= t - stage < n_micro:
                continue                      # this stage's bubble
            if stage == 0:
                x_in = T._embed_tokens({"embed": embed}, cfg,
                                       toks_m[t]).to(act_dtype)
            else:                             # what stage - 1 sent at t - 1
                x_in = _Recv.apply(a_rep, torch.empty(
                    shape, dtype=act_dtype, device=embed.device), prev, pod)
            x_out, _ = stage_fwd(layers, cfg, x_in, windows)
            if nxt is not None:
                anchors.append(_Send.apply(x_out, nxt, pod))
                continue
            h = (L.apply_norm(cfg.norm, {"g": norm_g}, x_out)
                 if cfg.norm == "rmsnorm" else x_out)
            logits = h.to(torch.float32) @ embed.to(torch.float32).T
            lb = lbls_m[t - (n_stages - 1)]
            mask = (lb >= 0).to(torch.float32)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, torch.clamp(lb, min=0).to(
                torch.int64)[..., None])[..., 0]
            loss_sum = loss_sum + torch.sum((lse - tgt) * mask)
        local = loss_sum / count + sum(anchors)
        return _SumOver.apply(local, (pod,) + dgroups)

    return loss_fn


def pipeline_param_specs(params, mesh):
    """Specs for pipeline mode: every leaf of the layer list ``P("pod")``
    (the list splits over ``pod``, stage ``s`` holding its contiguous
    ``L/n`` layers), the rest replicated."""
    return map_tree_with_path(
        lambda path, _: P("pod") if path[0] == "layers" else P(), params)
