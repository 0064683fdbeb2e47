"""One rank of a multi-rank case of ``test_torch_distributed.py`` (and
of ``test_torch_tensor_parallel.py``: :func:`case_tp`; of
``test_torch_tp_serve.py``: :func:`case_tp_serve`; of
``test_torch_tp_moe.py``: :func:`case_tp_moe`; of
``test_torch_tp_ssm.py``: :func:`case_tp_ssm`,
:func:`case_tp_one_rank`; of ``test_torch_tp_audio.py``:
:func:`case_tp_audio`, :func:`case_tp_one_rank`).

Run as ``python tests/_torch_dist_ranks.py CASE RANK WORLD DIR``: joins a
gloo group through ``file://DIR/store``, reads the case's inputs from
``DIR/inputs.pt``, runs the case and writes what it got to
``DIR/rank<RANK>.pt``.  Imports no JAX (the ranks are the port alone).
"""

import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import convert
from repro_torch.tree import leaves, unflatten_like


def case_ef(rank, world, inp):
    from repro_torch.distributed import compression as C

    g, e = inp["g"][rank], inp["err"][rank]
    out, new_err = C.ef_int8_allreduce_mean(g, e)
    codes, _, _ = C._encode(g, e, world)
    tg, te = C.tree_ef_allreduce_mean(inp["tree_g"][rank],
                                      inp["tree_e"][rank])
    return {"out": out, "new_err": new_err, "codes": codes,
            "tree_out": tg, "tree_err": te}


def case_pipe(rank, world, inp):
    from repro_torch.distributed import pipeline as PP

    cfg = inp["cfg"]
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("pod", "data"))
    params = convert.lm_params_from_numpy(inp["params"], device="cpu")
    held = PP.stage_params(params, cfg, mesh)
    flat = leaves(held)
    for p in flat:
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).long() for k, v in inp["batch"].items()}
    loss = PP.make_pipeline_loss(cfg, mesh, n_micro=2,
                                 data_axis="data")(held, batch)
    grads = torch.autograd.grad(loss, flat)
    stage, lo, hi = PP.stage_bounds(cfg, mesh)
    # JAX's own call: all four data ranks run the whole batch
    with torch.no_grad():
        loss_rep = PP.make_pipeline_loss(cfg, mesh, n_micro=4)(params,
                                                               batch)
    gt = unflatten_like(held, list(grads))
    return {"loss": loss.item(), "loss_rep": loss_rep.item(),
            "stage": stage, "layers": (lo, hi),
            "grads": convert.lm_params_to_numpy(
                {"layers": gt["layers"], "embed": gt["embed"]})}


def case_step(rank, world, inp):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optimizer as opt

    cfg = inp["cfg"]
    mesh = make_host_mesh(2)
    params = convert.lm_params_from_numpy(inp["params"], device="cpu")
    pshard = shd.to_shardings(shd.param_specs(params, mesh), mesh)
    params = shd.distribute(params, pshard)
    ostate = opt.init(params)
    batch = {k: shd.place(torch.from_numpy(v).long(), shd.NamedSharding(
        mesh, shd.batch_spec(k, v.shape, mesh)))
        for k, v in inp["batch"].items()}
    step = make_train_step(cfg, inp["opt"])
    losses = []
    for _ in range(2):
        params, ostate, m = step(params, ostate, batch)
        losses.append(m["loss"].item())
    full = [p.full_tensor() for p in leaves(params)]
    placed = [(tuple(p.placements), tuple(p.to_local().shape))
              for p in leaves(params)]
    moments = [(tuple(m.placements) == tuple(p.placements))
               for m, p in zip(leaves(ostate["m"]), leaves(params))]
    return {"losses": losses, "placed": placed, "moments": moments,
            "params": convert.lm_params_to_numpy(unflatten_like(params, full))
            if rank == 0 else None}


def case_restore(rank, world, inp):
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_production_mesh

    d = Path(inp["dir"])
    mesh_a = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    tree = inp["tree"]
    specs = {"w": shd.P("data", "model"), "b": shd.P("model"),
             "h": shd.P(None, "data")}
    placed = shd.distribute(tree, shd.to_shardings(specs, mesh_a))
    cm = CheckpointManager(d / "mesh")
    cm.save(1, placed)
    if rank == 0:
        CheckpointManager(d / "single").save(1, tree)
    dist.barrier()
    like = {k: torch.empty_like(v, device="meta") for k, v in tree.items()}
    sh_b = shd.to_shardings(specs, mesh_b)
    out = cm.restore(1, like, shardings=sh_b)
    # jax.device_put's resharding: the mesh-a tree put onto mesh b
    moved = shd.distribute(placed, sh_b)
    moved_ok = all(
        tuple(moved[k].placements) == sh_b[k].placements
        and torch.equal(moved[k].to_local(), out[k].to_local())
        for k in tree)
    refused = []
    for multi_pod in (False, True):
        try:
            make_production_mesh(multi_pod=multi_pod)
        except RuntimeError as e:
            refused.append(str(e))
    return {"refused": refused, "moved_ok": moved_ok, "full": {k: v.full_tensor() for k, v in out.items()},
            "placements": {k: (tuple(v.placements),
                               tuple(sh_b[k].placements))
                           for k, v in out.items()},
            "local": {k: tuple(v.to_local().shape) for k, v in out.items()}}


def case_cp(rank, world, inp):
    """The CP hint as JAX's test sets it: the chunked query layout laid
    out ``(data, model, ...)`` on a (2, 4) mesh and gathered back."""
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    params = convert.lm_params_from_numpy(inp["params"], device="cpu")
    toks = torch.from_numpy(inp["tokens"]).long()
    seen = []

    def hint(x):
        seen.append(tuple(x.shape))
        d = distribute_tensor(x, mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        seen.append(tuple(d.to_local().shape))
        return d.full_tensor()

    L.set_attention_cp(hint=hint, q_chunk=16, kv_chunk=16)
    try:
        with torch.no_grad():
            loss = T.loss_fn(params, inp["cfg"], {"tokens": toks,
                                                  "labels": toks})
    finally:
        L.set_attention_cp()
    return {"loss": loss.item(), "seen": seen}


#: what :func:`_record` saw in the current case: each leaf's ``model``
#: placements (forward, gradient) by path, and each MoE router call's
#: (tensor-parallel, top-k indices)
_SEEN, _ROUTED = {}, []


def _record() -> None:
    """Record in :data:`_SEEN` every placement a tensor-parallel context
    gives and in :data:`_ROUTED` every MoE router call's top-k indices,
    with whether the call ran on the tensor-parallel route."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import moe as MOE

    if getattr(TP.TensorParallel.placements, "recorded", False):
        return
    placements, apply, router = (TP.TensorParallel.placements,
                                 MOE.moe_apply, MOE._router)
    on_tp = [False]

    def recorded(self, path):
        out = placements(self, path)
        _SEEN["/".join(str(k) for k in path)] = tuple(repr(p) for p in out)
        return out

    def moe_apply(*args, tp=None, **kw):
        on_tp[0] = tp is not None
        return apply(*args, tp=tp, **kw)

    def routed(p, x, cfg):
        gates, idx, aux = router(p, x, cfg)
        _ROUTED.append((on_tp[0], idx.detach().clone()))
        return gates, idx, aux

    recorded.recorded = True
    TP.TensorParallel.placements = recorded
    MOE.moe_apply, MOE._router = moe_apply, routed


def _serve_run(mesh, cfg, params, placed, batch, steps_, pad=2):
    """A prefill and a decode step for each of ``steps_`` on ``placed``
    (params placed on ``mesh``) against the unsharded steps on
    ``params``, from the prefill's cache padded by ``pad`` positions:
    for each step, (max |got - want| / max |want|, placements, the
    spec's placements) of the logits and every cache entry; and each
    step's whole outputs."""
    import torch.nn.functional as F

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.tree import map_tree

    def put(tree, spec_of):
        return {k: shd.place(v, shd.NamedSharding(mesh, spec_of(k, v)))
                for k, v in tree.items()}

    def check(got, want):
        """(max |got - want| / max |want|, placements)."""
        full = got.full_tensor()
        err = float(torch.max(torch.abs(full.double() - want.double()))
                    / torch.clamp_min(torch.max(torch.abs(
                        want.double())), 1e-30)) if want.numel() else 0.0
        return err, tuple(got.placements)

    def checks(logits, cache, want_logits, want_cache):
        res = {"logits": check(logits, want_logits) + (
            shd.NamedSharding(mesh, shd.logits_spec(
                cfg, want_logits.shape[0], mesh)).placements,)}
        for k, v in want_cache.items():
            res[k] = check(cache[k], v) + (shd.NamedSharding(
                mesh, shd.cache_entry_spec(k, v.shape, mesh)).placements,)
        return res

    def whole(logits, cache):
        return {"logits": logits.full_tensor(),
                **{k: v.full_tensor() for k, v in cache.items()}}

    prefill = make_prefill_step(cfg)
    with torch.no_grad():
        ref_logits, ref_cache = prefill(params, batch)
        logits, cache = prefill(placed, put(
            batch, lambda k, v: shd.batch_spec(k, v.shape, mesh)))
    res = {"prefill": checks(logits, cache, ref_logits, ref_cache)}
    outs = {"prefill": whole(logits, cache)}

    # decode from the prefill cache padded by ``pad`` positions
    padded = {k: (F.pad(v, (0, 0) * (v.ndim - 3) + (0, pad))
                  if k in ("k", "v", "k_scale", "v_scale") else v)
              for k, v in ref_cache.items()}
    ref = map_tree(lambda t: t.clone(), padded)
    mine = put(map_tree(lambda t: t.clone(), padded),
               lambda k, v: shd.cache_entry_spec(k, v.shape, mesh))
    decode = make_decode_step(cfg)
    for t, toks in enumerate(steps_):
        toks = torch.from_numpy(toks)
        with torch.no_grad():
            ref_logits, ref = decode(params, ref, toks)
            logits, mine = decode(placed, mine, shd.place(
                toks, shd.NamedSharding(mesh, shd.batch_spec(
                    "tokens", toks.shape, mesh))),
                kv_len=padded["k"].shape[2] if "k" in padded else None)
        res[f"decode{t}"] = checks(logits, mine, ref_logits, ref)
        outs[f"decode{t}"] = whole(logits, mine)
    return res, outs


def case_serve(rank, world, inp):
    """The sharded prefill and decode steps on a (4, 2) mesh against the
    unsharded ones from the same params (made from seed 0 on every rank):
    the largest |difference| over the largest |value| of each output, and
    each output's placements beside the ones its spec gives."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model

    mesh = make_host_mesh(2)
    out = {}
    for name, cfg in inp["cfgs"].items():
        params = get_model(cfg).init(0, device="cpu")
        placed = shd.distribute(params, shd.to_shardings(
            shd.param_specs(params, mesh), mesh))
        batch = {k: torch.from_numpy(v) for k, v in inp["batch"][name].items()}
        out[name], _ = _serve_run(mesh, cfg, params, placed, batch,
                                  inp["steps"][name])
    return out


def case_tp_serve(rank, world, inp):
    """``tests/test_torch_tp_serve.py``: for each ``model`` size of
    ``inp["meshes"]``, on a (world / model, model) mesh, each case's
    prefill and decode steps on the tensor-parallel route from the
    case's params (numpy), placed by the sharding rules, against the
    unsharded steps (:func:`_serve_run`).  Also returns the KV cache
    route each step took (``None``: FSDP) and whisper's cross cache's
    (``xroutes``), the placements of each cache
    entry a decode step saw through ``_LayerRows`` (a gather), and on
    rank 0 for the cases in ``inp["keep"]`` the whole outputs."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh

    contexts, gathered = [], []
    for_step, layer_rows = St.tp_for_step, St._LayerRows

    def counted_for_step(cfg, mesh):
        contexts.append(for_step(cfg, mesh))
        return contexts[-1]

    class Counted(layer_rows):
        def __init__(self, placed, mesh, rows):
            gathered.append(tuple(repr(p) for p in rows))
            super().__init__(placed, mesh, rows)

    St.tp_for_step, St._LayerRows = counted_for_step, Counted
    _record()
    out = {}
    for mp, named in inp["meshes"].items():
        mesh = make_host_mesh(mp)
        for name, case in named.items():
            cfg = case["cfg"]
            params = convert.lm_params_from_numpy(case["params"],
                                                  device="cpu")
            placed = shd.distribute(params, shd.to_shardings(
                shd.param_specs(params, mesh), mesh))
            batch = {k: torch.from_numpy(v) for k, v in
                     case["batch"].items()}
            contexts.clear()
            gathered.clear()
            _SEEN.clear()
            _ROUTED.clear()
            res, outs = _serve_run(mesh, cfg, params, placed, batch,
                                   case["steps"], case["pad"])
            out[name] = {
                "checks": res,
                "routes": [c and c.cache for c in contexts],
                "xroutes": [c and c.xcache for c in contexts],
                "heads": [c and c.heads for c in contexts],
                "experts": [c and c.experts for c in contexts],
                "ssm": [c and c.ssm for c in contexts],
                "gathered": list(gathered),
                "split": dict(_SEEN), "routed": list(_ROUTED),
                "outs": outs if rank == 0 and name in inp["keep"] else None}
    return out


def _matmul_flops(fn, *args) -> int:
    """The matmul FLOPs of one call of ``fn`` on this rank."""
    from repro_torch.perfmodel import flops as F

    class Matmuls(F._FlopCounter):
        def charge(self, func, a, o):
            if func.overloadpacket in F._MATMULS:
                super().charge(func, a, o)

    with Matmuls() as c:
        fn(*args)
    return c.total


def case_tp(rank, world, inp):
    """``tests/test_torch_tensor_parallel.py``: for each ``model`` size of
    ``inp["meshes"]``, on a (world / model, model) mesh, each case's 2
    steps of ``make_train_step`` (the case's ``grad_accum`` and route)
    from the case's params, placed by the sharding rules.  Returns the
    losses, the ``model`` placement each leaf took in the forward and
    backward, and on rank 0 the whole params and moments after each
    step; with ``flops``, the rank's matmul FLOPs of one step on each
    route and of the unsharded step on the rank's rows, on a
    (world / 2, 2) mesh."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import map_tree

    _record()

    def whole(tree):
        # every rank gathers; a copy, as a replicated leaf's full_tensor
        # is the moment itself, which the next step updates in place
        full = map_tree(lambda t: t.full_tensor().clone(), tree)
        return convert.lm_params_to_numpy(full) if rank == 0 else None

    def placed(mesh, params, batch):
        params = convert.lm_params_from_numpy(params, device="cpu")
        params = shd.distribute(params, shd.to_shardings(
            shd.param_specs(params, mesh), mesh))
        batch = {k: shd.place(torch.from_numpy(v).to(
            torch.float32 if v.dtype.kind == "f" else torch.int64),
            shd.NamedSharding(mesh, shd.batch_spec(k, v.shape, mesh)))
            for k, v in batch.items()}
        return params, batch

    out = {}
    cases = [(make_host_mesh(mp), name, case)
             for mp, named in inp["meshes"].items()
             for name, case in named.items()]
    for mesh, name, case in cases:
        cfg = case["cfg"]
        params, batch = placed(mesh, case["params"], case["batch"])
        ostate = opt.init(params)
        step = make_train_step(cfg, case["opt"], case.get("grad_accum", 1),
                               tensor_parallel=case["tp"])
        _SEEN.clear()
        _ROUTED.clear()
        res = {"losses": [], "steps": []}
        for _ in range(2):
            params, ostate, m = step(params, ostate, batch)
            res["losses"].append(m["loss"].item())
            res["steps"].append({"params": whole(params),
                                 "m": whole(ostate["m"]),
                                 "v": whole(ostate["v"])})
        res["split"] = dict(_SEEN)
        res["routed"] = list(_ROUTED)
        res["placed"] = all(tuple(a.placements) == tuple(b.placements)
                            for a, b in zip(leaves(params),
                                            leaves(ostate["m"])))
        out[name] = res
    if "flops" in inp:
        case = inp["flops"]
        cfg = case["cfg"]
        mesh = make_host_mesh(2)
        got = {}
        for route in (True, False):
            params, batch = placed(mesh, case["params"], case["batch"])
            step = make_train_step(cfg, case["opt"], tensor_parallel=route)
            got["tp" if route else "fsdp"] = _matmul_flops(
                step, params, opt.init(params), batch)
        whole_p = convert.lm_params_from_numpy(case["params"], device="cpu")
        rows = {k: v.to_local() for k, v in batch.items()}
        step = make_train_step(cfg, case["opt"])
        got["unsharded"] = _matmul_flops(step, whole_p, opt.init(whole_p),
                                         rows)
        out["flops"] = got
    return out


def case_tp_moe(rank, world, inp):
    """``tests/test_torch_tp_moe.py``: the MoE family's train cases
    (:func:`case_tp` on ``inp["train"]``) and serve cases
    (:func:`case_tp_serve` on ``inp["serve"]``), each case's result with
    its leaves' placements and its router calls' top-k indices."""
    return {"train": case_tp(rank, world, inp["train"]),
            "serve": case_tp_serve(rank, world, inp["serve"])}


def case_tp_ssm(rank, world, inp):
    """``tests/test_torch_tp_ssm.py``: the SSM and hybrid families' train
    cases (:func:`case_tp` on ``inp["train"]``) and serve cases
    (:func:`case_tp_serve` on ``inp["serve"]``)."""
    return {"train": case_tp(rank, world, inp["train"]),
            "serve": case_tp_serve(rank, world, inp["serve"])}


def case_tp_audio(rank, world, inp):
    """``tests/test_torch_tp_audio.py``: whisper's train cases
    (:func:`case_tp` on ``inp["train"]``) and serve cases
    (:func:`case_tp_serve` on ``inp["serve"]``)."""
    return {"train": case_tp(rank, world, inp["train"]),
            "serve": case_tp_serve(rank, world, inp["serve"])}


def case_tp_one_rank(rank, world, inp):
    """``tests/test_torch_tp_ssm.py`` (hymba) and
    ``tests/test_torch_tp_audio.py`` (whisper, whose batch carries
    ``frames``): on a one-rank group and its (1, 1) mesh, ``inp["cfg"]``'s tensor-parallel train step (2 steps) and its
    prefill and 2 decode steps, from params placed as JAX's specs say,
    and the unsharded ones from the same params: each run's losses,
    params after the steps, and logits and cache entries."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch import steps as St
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import map_tree

    cfg, batch, steps_ = inp["cfg"], inp["batch"], inp["steps"]
    mesh = make_host_mesh(1)
    tp = TP.for_step(cfg, mesh)
    flags = {k: getattr(tp, k) for k in ("heads", "kv", "mlp", "ssm",
                                         "vocab")}

    def put(t, spec):
        return shd.place(t, shd.NamedSharding(mesh, spec))

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    got = {}
    for placed in (False, True):
        params = get_model(cfg).init(0, device="cpu")
        if placed:
            params = shd.distribute(params, shd.to_shardings(
                shd.param_specs(params, mesh), mesh))
        serve = map_tree(torch.clone, params)   # the train step updates
        #                                         params in place
        b = {k: put(v, shd.batch_spec(k, v.shape, mesh)) if placed else v
             for k, v in batch.items()}
        step = St.make_train_step(cfg, opt.OptConfig(**inp["lr"]),
                                  tensor_parallel=True)
        state, losses = opt.init(params), []
        for _ in range(2):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        out = {"losses": losses,
               "params": [whole(p).clone() for p in leaves(params)]}
        with torch.no_grad():
            logits, cache = St.make_prefill_step(cfg)(
                serve, {k: v for k, v in b.items() if k != "labels"})
            cache = {k: (torch.nn.functional.pad(
                whole(v), (0, 0, 0, 0, 0, 2)) if k in ("k", "v") else
                whole(v).clone()) for k, v in cache.items()}
            if placed:
                cache = {k: put(v, shd.cache_entry_spec(k, v.shape, mesh))
                         for k, v in cache.items()}
            out["serve"] = [whole(logits)]
            decode = St.make_decode_step(cfg)
            for toks in steps_:
                t = put(toks, shd.batch_spec("tokens", toks.shape, mesh)) \
                    if placed else toks
                logits, cache = decode(serve, cache, t)
                out["serve"].append(whole(logits))
            out["serve"] += [whole(v) for v in cache.values()]
        got["tp" if placed else "unsharded"] = out
    return {"flags": flags, **got}


CASES = {"cp": case_cp, "ef": case_ef, "pipe": case_pipe, "step": case_step,
         "restore": case_restore, "serve": case_serve, "tp": case_tp,
         "tp_serve": case_tp_serve, "tp_moe": case_tp_moe,
         "tp_ssm": case_tp_ssm, "tp_audio": case_tp_audio,
         "tp_one_rank": case_tp_one_rank}


def main(case, rank, world, d):
    rank, world, d = int(rank), int(world), Path(d)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        inp = torch.load(d / "inputs.pt", weights_only=False)
        out = CASES[case](rank, world, inp)
        torch.save(out, d / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
