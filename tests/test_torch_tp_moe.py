"""The tensor-parallel route of the MoE family (granite-moe-3b-a800m,
moonshot-v1-16b-a3b): ``make_train_step(tensor_parallel=True)``,
``make_prefill_step`` and ``make_decode_step`` on DTensor params, the
experts split on ``d_ff_expert`` (``distributed/tensor_parallel.py``,
``models/moe.py``'s ``tp=``), on 8 gloo ranks on the CPU, against the
port's unsharded steps and JAX's.

One spawn of 8 ranks (``run_ranks`` of ``test_torch_distributed``,
``case_tp_moe`` of ``tests/_torch_dist_ranks.py``) runs every case on its
mesh from JAX's initial params (smoke configs, 2 layers, float32), while
this process computes the references.

Train (2 steps, batch 8 x 32, labels partly masked):

* 4 x 2 (``model`` = 2): granite (4 heads, 2 KV heads, 8 experts
  top-2, ``f`` 64: 32 a rank), moonshot (untied head, ``f`` 96), moonshot
  W4 QAT per channel (the expert ``wo``'s absmax is a max over
  ``model``), moonshot with ``n_shared_experts=1`` (the shared experts
  split as a dense MLP; no config has them);
* 2 x 4 (``model`` = 4): granite (1 query head a rank, the 2 KV heads
  gathered; ``f`` 16 a rank).

Serve (batch 8, a prefill of 16 tokens, 2 decode steps from the cache
padded by ``pad`` positions): moonshot over a bf16 and an INT4 cache
(the KV heads split, route ``"heads"``) and granite with
``force_dense`` (the dense-mix path in the prefill too) on 4 x 2;
granite on 2 x 4 (route ``"seq"``, the KV heads gathered).

Tolerances, each with its reason:

* the train step: ``test_torch_tensor_parallel.py``'s (split
  contractions sum in another order, AdamW divides by ``sqrt(v_hat)``),
  the FSDP case's too (its aux loss's batch means are averaged over the
  data ranks, another order than the unsharded mean).  The W4 QAT case
  holds JAX's first loss only: under ``jit`` XLA rewrites fake-quant's
  ``absmax / qmax`` into a multiply by the reciprocal, which moves
  channels across the clip bound, and the routing carries that into
  the second step's loss (4.2e-4 relative; the port's unsharded step
  gives JAX's op-by-op second loss, 5.828789 both, which costs ~30 s of
  op-by-op JAX here);
* the serve steps: against the port's unsharded steps
  ``test_torch_tp_serve.py``'s (1e-5 of each output's largest |value|);
  against JAX rtol 1e-4 and an atol of 1e-5 of the output's largest
  |value| (``test_torch_moe.py``'s atol on the block's outputs): the
  port's unsharded MoE steps already miss the dense cases' 1e-6 at one
  logit of 2048 (moonshot's prefill 1.5e-6 of the largest, granite's
  second decode step 2.0e-6), the gate products summing in another
  order than XLA's.

Besides, in every case the ``model`` ranks of a data group route every
token to the same experts (the router runs on the replicated input; two
ranks a rounding apart would mix different experts' partial products
and nothing would raise), and in the serve cases those experts are the
unsharded steps' on the rank's rows.

Time: ~55 s alone, ~100 s beside the suite's 6 workers (budget 120 s).
"""

import dataclasses
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import transformer as JT
from repro.quant.formats import PrecisionConfig as JPC
from repro_torch import configs
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models.api import get_model
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves_with_path
from test_torch_distributed import run_ranks
from test_torch_tensor_parallel import LR, _batch, _check, _port
from test_torch_tensor_parallel import _jax as _jax_train
from test_torch_tp_serve import _inputs
from test_torch_tp_serve import _jax as _jax_serve
from test_torch_tp_ssm import SSM_INTENDED

# the first multi-threaded CPU exp of a process can be 1e-4 off (see
# test_torch_mamba2.py); one parallel exp at import takes it
torch.exp(torch.zeros(1 << 20))

GRANITE, MOONSHOT = "granite-moe-3b-a800m", "moonshot-v1-16b-a3b"

# name -> (arch, model axis, precision (bits, group) or None, MoE changes,
#          tensor-parallel)
TRAIN = {
    "granite": (GRANITE, 2, None, {}, True),
    "moonshot": (MOONSHOT, 2, None, {}, True),
    "moonshot_w4": (MOONSHOT, 2, (4, -1), {}, True),
    "granite_m4": (GRANITE, 4, None, {}, True),
    "moonshot_shared": (MOONSHOT, 2, None, {"n_shared_experts": 1}, True),
    "granite_fsdp": (GRANITE, 2, None, {}, False),
}
TP_TRAIN = [k for k, c in TRAIN.items() if c[4]]

# name -> (arch, model axis, kv_cache_bits, MoE changes,
#          cache route of (prefill, decode), query heads split)
SERVE = {
    "moonshot": (MOONSHOT, 2, 16, {}, ("heads", "heads"), True),
    "moonshot_int4": (MOONSHOT, 2, 4, {}, ("heads", "heads"), True),
    "granite_dense": (GRANITE, 2, 16, {"force_dense": True},
                      ("heads", "heads"), True),
    "granite_seq": (GRANITE, 4, 16, {}, ("seq", "seq"), True),
}
N_TEXT, B = 16, 8


def _configs(arch, prec=None, bits=16, moe=None):
    """JAX's and the port's smoke configs with the same changes."""
    out = []
    for get, pc in ((jconfigs.get_config, JPC), (configs.get_config,
                                                 PrecisionConfig)):
        c = get(arch, smoke=True)
        c = dataclasses.replace(c, kv_cache_bits=bits, moe=dataclasses.replace(
            c.moe, **(moe or {})))
        if prec is not None:
            c = dataclasses.replace(c, precision=pc(*prec))
        out.append(c)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (one spawn, running while this process computes
    the references): ``(ranks, train refs, serve refs)``."""
    inp = {"train": {"meshes": {2: {}, 4: {}}},
           "serve": {"meshes": {2: {}, 4: {}}, "keep": tuple(SERVE)}}
    made_t, made_s = {}, {}
    for name, (arch, mp, prec, moe, tp) in TRAIN.items():
        jcfg, cfg = _configs(arch, prec, moe=moe)
        jp = JT.init(jax.random.PRNGKey(0), jcfg)
        made_t[name] = (jcfg, cfg, jp, _batch(cfg, seed=3))
        inp["train"]["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": made_t[name][3], "tp": tp, "grad_accum": 1,
            "opt": opt.OptConfig(**LR)}
    for name, (arch, mp, bits, moe, _, _) in SERVE.items():
        jcfg, cfg = _configs(arch, bits=bits, moe=moe)
        jp = japi.get_model(jcfg).init(jax.random.PRNGKey(0))
        batch, steps = _inputs(cfg, N_TEXT, seed=5)
        made_s[name] = (jcfg, jp, batch, steps, mp)
        inp["serve"]["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": batch, "steps": steps, "pad": mp}
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_ranks, "tp_moe", 8,
                            tmp_path_factory.mktemp("tp_moe"), inp,
                            timeout=300)
        train, done = {}, {}
        for name, (jcfg, cfg, jp, batch) in made_t.items():
            key = TRAIN[name][:4:2] + (tuple(TRAIN[name][3].items()),)
            if key not in done:         # the same step on another mesh
                npp = jax.tree.map(np.asarray, jp)
                done[key] = {"port": _port(cfg, npp, batch, 1),
                             "jax": _jax_train(jcfg, jp, batch, 1)}
            train[name] = done[key]
        serve = {name: _jax_serve(jcfg, jp, batch, steps, pad)
                 for name, (jcfg, jp, batch, steps, pad) in made_s.items()}
        got = spawn.result()
    return got, train, serve


def _ranks(runs, kind, name):
    return [r[kind][name] for r in runs[0]]


# --- the train step ----------------------------------------------------------


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_moe_step_against_the_unsharded_step(runs, name):
    ref = runs[1][name]["port"]
    ranks = _ranks(runs, "train", name)
    for o in ranks:
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-5)
        assert o["placed"]
    _check(ranks[0]["steps"], ref["steps"], ref["steps"][0]["v"], 1e-5,
           1e-5, name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_moe_step_against_jax(runs, name):
    ref = runs[1][name]
    qat = TRAIN[name][2] is not None
    for o in _ranks(runs, "train", name):
        n = 1 if qat else 2     # jitted QAT: see the module docstring
        np.testing.assert_allclose(o["losses"][:n], ref["jax"]["losses"][:n],
                                   rtol=1e-4)
    if qat:
        return
    _check(_ranks(runs, "train", name)[0]["steps"][:1],
           ref["jax"]["steps"][:1], ref["port"]["steps"][0]["v"], 1e-4,
           1e-4, name)


SHARD = {d: (f"Shard(dim={d})", f"Shard(dim={d})") for d in (0, 1, 2)}
REPL = ("Replicate()", "Replicate()")
GATHERED = ("Replicate()", "Partial(sum)")


def _want_split(model, leaf):
    """The (forward, gradient) placement on ``model`` of a smoke MoE
    config's leaf: the experts on ``f``, the shared experts as a dense
    MLP, the router replicated, attention as the dense rules (granite's
    2 KV heads gathered on 4 ranks), the vocab split."""
    if leaf == "embed":
        return SHARD[0]
    if leaf == "lm_head/w":
        return SHARD[1]
    if re.search(r"mlp/w[ig]$", leaf):
        return SHARD[2]
    if re.search(r"mlp/(wo|shared_w[ig])$", leaf):
        return SHARD[1]
    if leaf.endswith("mlp/shared_wo"):
        return SHARD[0]
    if leaf.endswith(("attn/wq/w", "attn/wo/w")):
        return SHARD[1] if leaf.endswith("wq/w") else SHARD[0]
    if leaf.endswith(("attn/wk/w", "attn/wv/w")):
        return GATHERED if model == 4 else SHARD[1]
    return REPL


@pytest.mark.parametrize("kind,name", [("train", n) for n in TP_TRAIN] +
                         [("serve", n) for n in SERVE])
def test_tp_moe_keeps_the_experts_split(runs, kind, name):
    """Each expert leaf is held as ``Shard`` on ``f`` and the router
    replicated, in the train step's forward and backward and in the
    serve steps."""
    model = (TRAIN if kind == "train" else SERVE)[name][1]
    for o in _ranks(runs, kind, name):
        split = o["split"]
        assert any(k.endswith("mlp/router") for k in split), name
        assert any(k.endswith("mlp/wo") for k in split), name
        for leaf, got in split.items():
            assert got == _want_split(model, leaf), (name, leaf, got)
        if name == "moonshot_shared":
            assert any("shared_w" in k for k in split)


@pytest.mark.parametrize("kind,name", [("train", n) for n in TRAIN] +
                         [("serve", n) for n in SERVE])
def test_tp_moe_ranks_route_alike(runs, kind, name):
    """The ``model`` ranks of each data group pick the same top-k experts
    at every router call of the step's route; in the serve cases they
    are also the unsharded steps' on the rank's rows."""
    case = (TRAIN if kind == "train" else SERVE)[name]
    model, tp = case[1], kind == "serve" or case[4]
    ranks = _ranks(runs, kind, name)
    for r, o in enumerate(ranks):
        mine = [idx for on_tp, idx in o["routed"] if on_tp == tp]
        first = [idx for on_tp, idx in ranks[r - r % model]["routed"]
                 if on_tp == tp]
        assert mine and len(mine) == len(first), (name, r)
        for a, b in zip(mine, first):
            assert torch.equal(a, b), (name, r)
        if kind == "serve":
            whole = [idx for on_tp, idx in o["routed"] if not on_tp]
            assert len(whole) == len(mine), (name, len(whole), len(mine))
            rows = B // (8 // model)
            lo = (r // model) * rows
            for a, w in zip(mine, whole):
                assert torch.equal(a, w[lo:lo + rows]), (name, r)


# --- the serve steps ---------------------------------------------------------


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_moe_serve_against_the_unsharded_steps(runs, name):
    _, _, _, _, (pre, dec), heads = SERVE[name]
    for o in _ranks(runs, "serve", name):
        assert o["routes"] == [pre, dec, dec], (name, o["routes"])
        assert o["heads"] == [heads] * 3 and o["experts"] == [True] * 3
        assert o["gathered"] == [], (name, o["gathered"])
        assert set(o["checks"]) == {"prefill", "decode0", "decode1"}
        for step, entries in o["checks"].items():
            for key, (err, placed, want) in entries.items():
                assert err <= 1e-5, (name, step, key, err)
                assert placed == want, (name, step, key, placed, want)


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_moe_serve_against_jax(runs, name):
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
                a, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                err_msg=f"{name} {step} {key}")


# --- the split patterns ------------------------------------------------------

#: each leaf kind (the path with its layer index dropped) -> the part of
#: ``_SPLITS`` that should match it and the dim it splits; kinds not
#: listed match no pattern.  whisper's leaves match the attention and
#: dense MLP rules (as JAX's rules match them), its cross-attention's
#: ``xattn/`` the ``attn/`` ones.  The Mamba-2 leaves' rows:
#: ``test_torch_tp_ssm.py``, which checks their shapes
INTENDED = {
    **SSM_INTENDED,
    "embed": ("vocab", 0),
    "lm_head/w": ("vocab", 1),
    "vision_proj/w": ("vision", 1),
    "attn/wq/w": ("heads", 1), "attn/wq/b": ("heads", 0),
    "attn/wk/w": ("kv", 1), "attn/wk/b": ("kv", 0),
    "attn/wv/w": ("kv", 1), "attn/wv/b": ("kv", 0),
    "attn/wo/w": ("heads", 0),
    "xattn/wq/w": ("heads", 1), "xattn/wq/b": ("heads", 0),
    "xattn/wk/w": ("kv", 1), "xattn/wv/w": ("kv", 1),
    "xattn/wv/b": ("kv", 0), "xattn/wo/w": ("heads", 0),
    "mlp/wi/w": ("mlp", 1), "mlp/wg/w": ("mlp", 1), "mlp/wo/w": ("mlp", 0),
    "mlp/wi": ("experts", 2), "mlp/wg": ("experts", 2),
    "mlp/wo": ("experts", 1),
    "mlp/shared_wi": ("shared", 1), "mlp/shared_wg": ("shared", 1),
    "mlp/shared_wo": ("shared", 0),
}


def _kind(path: str) -> str:
    return re.sub(r"^\w*layers/\d+/", "", path)


def test_split_patterns_match_the_intended_leaves():
    """Every leaf of the 10 archs (and moonshot with shared experts)
    matches exactly its intended ``_SPLITS`` pattern: the dense MLP
    patterns never a stacked expert leaf, the expert patterns never a
    dense leaf, and the split dim is a dim of the leaf that holds the
    part."""
    cfgs = [configs.get_config(a, smoke=True) for a in configs.ARCH_IDS]
    cfgs.append(_configs(MOONSHOT, moe={"n_shared_experts": 1})[1])
    matched = set()
    for cfg in cfgs:
        for path, t in leaves_with_path(get_model(cfg).init(0,
                                                            device="meta")):
            ps = "/".join(str(k) for k in path)
            hits = [(part, dim) for pat, part, dim in TP._SPLITS
                    if re.search(pat, ps)]
            want = INTENDED.get(_kind(ps))
            assert hits == ([want] if want else []), (cfg.name, ps, hits)
            if want is None:
                continue
            matched.add(_kind(ps))
            part, dim = want
            if part == "ssm":
                continue
            assert t.ndim == (3 if part == "experts" else
                              1 if ps.endswith("/b") else 2), (ps, t.shape)
            if part == "experts":
                f = cfg.moe.d_ff_expert
                assert t.shape[dim] == f and t.shape[0] == cfg.moe.n_experts
            if part == "shared":
                assert t.shape[dim] == cfg.moe.d_ff_expert
    assert matched == set(INTENDED)


def test_buffer_hint_raises_on_the_tensor_parallel_route():
    """A dispatch-buffer hint (``perf.py --moe-buf-shard``) lays out whole
    buffers; with the experts split over ``model`` the expert outputs are
    partial sums, so the MoE block raises rather than pass them to it
    (the unsharded block takes the hint)."""
    from repro_torch.models import moe as MOE

    class Split:
        experts, shared = True, False

        def on(self, part):
            return self if getattr(self, part) else None

    cfg = configs.get_config(GRANITE, smoke=True)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                     cfg.ffn, torch.float32)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    seen = []
    MOE.set_buffer_hint(lambda buf, kind: seen.append(kind) or buf)
    try:
        MOE.moe_apply(p, x, cfg.moe, ffn_kind=cfg.ffn, act=cfg.act)
        assert seen == ["dispatch", "dispatch"]
        with pytest.raises(NotImplementedError, match="set_buffer_hint"):
            MOE.moe_apply(p, x, cfg.moe, ffn_kind=cfg.ffn, act=cfg.act,
                          tp=Split())
    finally:
        MOE.set_buffer_hint(None)
