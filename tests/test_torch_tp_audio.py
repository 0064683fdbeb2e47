"""The tensor-parallel route of the audio family (whisper-base):
``make_train_step(tensor_parallel=True)``, ``make_prefill_step`` and
``make_decode_step`` on DTensor params, the encoder's and decoder's
attention (the cross-attention included), the MLP, the embedding and
the tied head split over ``model`` (``distributed/tensor_parallel.py``,
``models/whisper.py``'s ``tp=``), on 8 gloo ranks on the CPU, against
the port's unsharded steps and JAX's.

One spawn of 8 ranks (``run_ranks`` of ``test_torch_distributed``,
``case_tp_audio`` of ``tests/_torch_dist_ranks.py``) runs every case on
its mesh from JAX's initial params (whisper smoke: 2 + 2 layers, 4
heads, float32), while this process computes the references on one
thread (the ranks hold the cores).

Train (2 steps, batch 8 x 32 over 48 frames, labels partly masked):

* 4 x 2 (``model`` = 2): heads, KV heads, ``d_ff`` and the vocab split;
  the same with W4 QAT per channel (``wo``'s absmax a max over
  ``model``);
* 2 x 4 (``model`` = 4): 1 head a rank; and ``n_heads`` = ``n_kv`` = 2
  (head_dim 32, the same ``dataclasses.replace`` in both packages): the
  heads whole on every rank, ``d_ff`` and the vocab split.

Serve (batch 8, a prefill of 16 tokens over 48 frames, 2 decode steps;
the self cache padded by ``pad`` positions): the smoke config on 4 x 2
and 2 x 4 (both caches split by KV heads); the ``n_kv`` = 2 config on
2 x 4 over 48 frames (``k``/``v`` and ``xk``/``xv`` split by sequence,
the cross-attention's softmax merged over ``model``) and over 50 frames
(``k``/``v`` by sequence, ``xk``/``xv`` whole: 50 does not divide 4).
Each output is placed as ``logits_spec`` / ``cache_specs`` say.

Besides, on a one-rank gloo group (what the card's check runs; a spawn
of its own, ``case_tp_one_rank``, beside the first): whisper's route
bit-equal to the unsharded train, prefill and decode steps.

Tolerances, each with its reason:

* the train step: ``test_torch_tensor_parallel.py``'s (split
  contractions sum in another order, AdamW divides by
  ``sqrt(v_hat)``); the QAT case holds JAX's losses only (under ``jit``
  XLA rewrites fake-quant's ``absmax / qmax``);
* the serve steps: ``test_torch_tp_serve.py``'s (1e-5 of each output's
  largest |value| against the port's unsharded steps; rtol 1e-4 and an
  atol of 1e-6 of the largest |value| against JAX's jitted steps).

Time: ~39 s alone (budget 40 s).
"""

import dataclasses
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.distributed import sharding as jshd
from repro.launch.mesh import make_abstract_mesh as jmake_abstract_mesh
from repro.models import api as japi
from repro.quant.formats import PrecisionConfig as JPC
from repro_torch import configs
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.api import get_model
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves_with_path
from test_torch_distributed import run_ranks
from test_torch_tensor_parallel import LR, _check, _port
from test_torch_tensor_parallel import _jax as _jax_train
from test_torch_tp_serve import _jax as _jax_serve
from test_torch_tp_ssm import _Mesh

# the first multi-threaded CPU exp of a process can be 1e-4 off (see
# test_torch_mamba2.py); one parallel exp at import takes it
torch.exp(torch.zeros(1 << 20))

WHISPER = "whisper-base"
#: two heads of 32 (both packages): on 4 ranks the heads run whole
H2 = {"n_heads": 2, "n_kv": 2, "head_dim": 32}

# name -> (model axis, precision (bits, group) or None, config changes)
TRAIN = {
    "whisper": (2, None, {}),
    "whisper_m4": (4, None, {}),
    "whisper_w4": (2, (4, -1), {}),
    "whisper_h2": (4, None, H2),
}

# name -> (model axis, frames, config changes, routes of (k/v, xk/xv))
SERVE = {
    "whisper": (2, 48, {}, ("heads", "heads")),
    "whisper_m4": (4, 48, {}, ("heads", "heads")),
    "whisper_h2_seq": (4, 48, H2, ("seq", "seq")),
    "whisper_h2_whole": (4, 50, H2, ("seq", "whole")),
}
N_TEXT, N_FRAMES, B = 16, 48, 8


def _configs(prec=None, changes=None):
    """JAX's and the port's smoke configs with the same changes."""
    out = []
    for get, pc in ((jconfigs.get_config, JPC), (configs.get_config,
                                                 PrecisionConfig)):
        c = dataclasses.replace(get(WHISPER, smoke=True), **(changes or {}))
        if prec is not None:
            c = dataclasses.replace(c, precision=pc(*prec))
        out.append(c)
    return out


def _train_batch(cfg, seed):
    g = np.random.default_rng(seed)
    labels = g.integers(0, cfg.vocab, (B, 32)).astype(np.int32)
    labels[0, :5] = -1
    return {"tokens": g.integers(0, cfg.vocab, (B, 32)).astype(np.int32),
            "labels": labels,
            "frames": g.standard_normal((B, N_FRAMES, cfg.d_model)).astype(
                np.float32)}


def _serve_inputs(cfg, frames, seed):
    g = np.random.default_rng(seed)
    batch = {"tokens": g.integers(0, cfg.vocab, (B, N_TEXT)),
             "frames": g.standard_normal((B, frames, cfg.d_model)).astype(
                 np.float32)}
    return batch, [g.integers(0, cfg.vocab, (B, 1)) for _ in range(2)]


def _init(jcfg):
    return japi.get_model(jcfg).init(jax.random.PRNGKey(0))


def _one_rank_inputs():
    """``case_tp_one_rank``'s inputs: whisper smoke, batch 4 x 32 over
    48 frames, 2 decode steps."""
    cfg = configs.get_config(WHISPER, smoke=True)
    g = np.random.default_rng(0)
    batch = {k: torch.from_numpy(g.integers(0, cfg.vocab, (4, 32)))
             for k in ("tokens", "labels")}
    batch["frames"] = torch.from_numpy(g.standard_normal(
        (4, N_FRAMES, cfg.d_model)).astype(np.float32))
    steps_ = [torch.from_numpy(g.integers(0, cfg.vocab, (4, 1)))
              for _ in range(2)]
    return {"cfg": cfg, "batch": batch, "steps": steps_, "lr": LR}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (two spawns, the 8 ranks' and the one rank's,
    running while this process computes the references on one thread):
    ``(ranks, train refs, serve refs, the one rank's)``."""
    inp = {"train": {"meshes": {2: {}, 4: {}}},
           "serve": {"meshes": {2: {}, 4: {}}, "keep": tuple(SERVE)}}
    made_t, made_s = {}, {}
    for name, (mp, prec, changes) in TRAIN.items():
        jcfg, cfg = _configs(prec, changes)
        jp = _init(jcfg)
        made_t[name] = (jcfg, cfg, jp, _train_batch(cfg, seed=3))
        inp["train"]["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": made_t[name][3], "tp": True, "grad_accum": 1,
            "opt": opt.OptConfig(**LR)}
    for name, (mp, frames, changes, _) in SERVE.items():
        jcfg, cfg = _configs(changes=changes)
        jp = _init(jcfg)
        batch, steps = _serve_inputs(cfg, frames, seed=5)
        made_s[name] = (jcfg, jp, batch, steps, mp)
        inp["serve"]["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": batch, "steps": steps, "pad": mp}
    threads = torch.get_num_threads()
    with ThreadPoolExecutor(2) as pool:
        spawn = pool.submit(run_ranks, "tp_audio", 8,
                            tmp_path_factory.mktemp("tp_audio"), inp,
                            timeout=300)
        one = pool.submit(run_ranks, "tp_one_rank", 1,
                          tmp_path_factory.mktemp("tp_one_rank"),
                          _one_rank_inputs())
        # the ranks hold every core: one thread here
        torch.set_num_threads(1)
        try:
            train, serve = _references(made_t, made_s)
        finally:
            torch.set_num_threads(threads)
        got, (one_rank,) = spawn.result(), one.result()
    return got, train, serve, one_rank


def _references(made_t, made_s):
    """The port's unsharded train steps and JAX's jitted train and serve
    steps of each case."""
    train, done = {}, {}
    for name, (jcfg, cfg, jp, batch) in made_t.items():
        key = (TRAIN[name][1], tuple(TRAIN[name][2].items()))
        if key not in done:         # the same step on another mesh
            npp = jax.tree.map(np.asarray, jp)
            done[key] = {"port": _port(cfg, npp, batch, 1),
                         "jax": _jax_train(jcfg, jp, batch, 1)}
        train[name] = done[key]
    serve = {name: _jax_serve(jcfg, jp, batch, steps, pad)
             for name, (jcfg, jp, batch, steps, pad) in made_s.items()}
    return train, serve


def _ranks(runs, kind, name):
    return [r[kind][name] for r in runs[0]]


# --- the train step ----------------------------------------------------------


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_audio_step_against_the_unsharded_step(runs, name):
    ref = runs[1][name]["port"]
    ranks = _ranks(runs, "train", name)
    for o in ranks:
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-5)
        assert o["placed"]
    _check(ranks[0]["steps"], ref["steps"], ref["steps"][0]["v"], 1e-5,
           1e-5, name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_audio_step_against_jax(runs, name):
    ref = runs[1][name]
    for o in _ranks(runs, "train", name):
        np.testing.assert_allclose(o["losses"], ref["jax"]["losses"],
                                   rtol=1e-4)
    if TRAIN[name][1] is not None:
        return      # jitted QAT: see the module docstring
    _check(_ranks(runs, "train", name)[0]["steps"][:1],
           ref["jax"]["steps"][:1], ref["port"]["steps"][0]["v"], 1e-4,
           1e-4, name)


SHARD = {d: (f"Shard(dim={d})", f"Shard(dim={d})") for d in (0, 1)}
REPL = ("Replicate()", "Replicate()")


def _want_split(heads, leaf):
    """The (forward, gradient) placement on ``model`` of a whisper smoke
    leaf: both attentions' projections and their biases split where the
    heads split (``wo``'s bias added once, whole), the MLP and the
    vocab-split embedding always, the norms whole."""
    if re.search(r"attn/w[qkv]/w$", leaf):
        return SHARD[1] if heads else REPL
    if re.search(r"attn/(w[qkv]/b|wo/w)$", leaf):
        return SHARD[0] if heads else REPL
    if leaf.endswith("mlp/wi/w"):
        return SHARD[1]
    if leaf.endswith("mlp/wo/w") or leaf == "embed":
        return SHARD[0]
    return REPL


@pytest.mark.parametrize("kind,name", [("train", n) for n in TRAIN] +
                         [("serve", n) for n in SERVE])
def test_tp_audio_holds_the_split(runs, kind, name):
    """Each leaf is held as the route says in the train step's forward
    and backward and in the serve steps, ``xattn/`` as ``attn/``."""
    model, changes = (TRAIN[name][0], TRAIN[name][2]) if kind == "train" \
        else (SERVE[name][0], SERVE[name][2])
    heads = _configs(changes=changes)[1].n_heads % model == 0
    for o in _ranks(runs, kind, name):
        split = o["split"]
        assert any(k.endswith("xattn/wv/b") for k in split), name
        for leaf, got in split.items():
            assert got == _want_split(heads, leaf), (name, leaf, got)


# --- the serve steps ---------------------------------------------------------


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_audio_serve_against_the_unsharded_steps(runs, name):
    """Each step on the route, each cache on its own route, nothing of
    the cache gathered, every output within 1e-5 and placed as its spec
    says."""
    route, xroute = SERVE[name][3]
    for o in _ranks(runs, "serve", name):
        assert o["routes"] == [route] * 3, (name, o["routes"])
        assert o["xroutes"] == [xroute] * 3, (name, o["xroutes"])
        assert o["gathered"] == [], (name, o["gathered"])
        assert set(o["checks"]) == {"prefill", "decode0", "decode1"}
        for step, entries in o["checks"].items():
            assert set(entries) == {"logits", "len", "k", "v", "xk", "xv"}
            for key, (err, placed, want) in entries.items():
                assert err <= 1e-5, (name, step, key, err)
                assert placed == want, (name, step, key, placed, want)


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_audio_serve_against_jax(runs, name):
    got = _ranks(runs, "serve", name)[0]["outs"]
    want = runs[2][name]
    assert set(got) == set(want)
    for step, entries in want.items():
        for key, w in entries.items():
            a = got[step][key].numpy()
            assert a.shape == w.shape, (name, step, key)
            if key == "len":
                np.testing.assert_array_equal(a, w)
                continue
            np.testing.assert_allclose(
                a, w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                err_msg=f"{name} {step} {key}")


# --- the placements against JAX's specs, the one-rank route ------------------


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_placements_are_jax_param_specs(data, model):
    """On 4 x 2 and 2 x 4, each whisper smoke leaf's forward placement on
    ``model`` is ``Shard(d)`` exactly where JAX's ``param_spec`` names
    ``model`` at dim ``d`` (the stacked layer dim dropped), else
    ``Replicate()``: the route computes on the shards JAX's specs lay
    out, ``xattn/`` included."""
    jcfg, cfg = _configs()
    mesh = jmake_abstract_mesh((data, model), ("data", "model"))
    jparams = jax.eval_shape(lambda: _init(jcfg))
    specs = dict(jax.tree_util.tree_flatten_with_path(
        jshd.param_specs(jparams, mesh),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0])
    jspec = {jshd._path_str(p): s for p, s in specs.items()}
    tp = TP.TensorParallel(cfg, _Mesh(model, 0))
    seen = set()
    for path, t in leaves_with_path(get_model(cfg).init(0, device="meta")):
        ps = "/".join(str(k) for k in path)
        key = re.sub(r"^(\w+layers)/\d+/", r"\1/", ps)
        spec = tuple(jspec[key])[len(jspec[key]) - t.ndim:]
        want = [f"Shard(dim={d})" for d, a in enumerate(spec)
                if a == "model"] or ["Replicate()"]
        assert [repr(tp.placements(path)[0])] == want, (ps, spec)
        seen.add(key)
    assert seen == set(jspec)


def test_one_rank_route_is_the_unsharded_arithmetic(runs):
    """On a one-rank gloo group and its (1, 1) mesh, what the card's check
    runs: whisper's tensor-parallel train step (2 steps) and its prefill
    and 2 decode steps are bit-equal to the unsharded ones, with every
    part split (the encoder states pass ``copy_in`` once for every
    layer's cross-attention).  In a spawned rank of one CPU thread
    (``case_tp_one_rank``): a multi-threaded CPU run is not
    bit-reproducible run to run."""
    got = runs[3]
    assert got["flags"] == {"heads": True, "kv": True, "mlp": True,
                            "ssm": False, "vocab": True}
    ref, mine = got["unsharded"], got["tp"]
    assert mine["losses"] == ref["losses"]
    assert all(torch.equal(a, b) for a, b in zip(mine["params"],
                                                 ref["params"]))
    # logits of the prefill and 2 steps, then k, v, xk, xv and len
    assert len(mine["serve"]) == len(ref["serve"]) == 8
    assert all(torch.equal(a, b) for a, b in zip(mine["serve"],
                                                 ref["serve"]))
