"""The tensor-parallel route of the SSM and hybrid families (mamba2-1.3b,
hymba-1.5b): ``make_train_step(tensor_parallel=True)``,
``make_prefill_step`` and ``make_decode_step`` on DTensor params, the
Mamba-2 mixer's heads split over ``model`` (``distributed/
tensor_parallel.py``, ``models/mamba2.py``'s ``tp=``), on 8 gloo ranks on
the CPU, against the port's unsharded steps and JAX's.

One spawn of 8 ranks (``run_ranks`` of ``test_torch_distributed``,
``case_tp_ssm`` of ``tests/_torch_dist_ranks.py``) runs every case on its
mesh from JAX's initial params (smoke configs, 2 layers, float32), while
this process computes the references.

Train (2 steps, batch 8 x 32, labels partly masked):

* 4 x 2 (``model`` = 2): mamba2 (8 SSM heads, 4 a rank; ``in_proj``'s
  296 columns stored 148 a rank, a split that is not the 164 its heads
  read: their z, x and dt, B and C whole), mamba2 W4 QAT per channel
  (``out_proj``'s absmax a max over ``model``), hymba (heads, KV heads,
  SSM heads and ``d_ff`` split);
* 2 x 4 (``model`` = 4): mamba2 (2 SSM heads a rank), hymba (1 query
  head a rank, the 2 KV heads gathered), and mamba2 with
  ``ssm.head_dim=64`` (2 SSM heads, which 4 does not divide: the mixer
  whole on every rank, its state split on ``hp`` as hymba-1.5b's is on
  16), the same ``dataclasses.replace`` in both packages.

Serve (batch 8, a prefill of 16 tokens, 2 decode steps; the KV cache
padded by ``pad`` positions): mamba2 on 4 x 2 and 2 x 4, mamba2 with
``head_dim=64`` on 2 x 4, hymba over a bf16 and an INT4 cache on 4 x 2.
Each output is placed as ``logits_spec`` / ``cache_specs`` say, the
``conv`` and ``ssm`` entries included.

Besides, on a one-rank gloo group (what the card's check runs; a spawn
of its own, ``case_tp_one_rank``): hymba's route bit-equal to the
unsharded train, prefill and decode steps.

Tolerances, each with its reason:

* the train step: ``test_torch_tensor_parallel.py``'s (split
  contractions and the gated norm's mean sum in another order, AdamW
  divides by ``sqrt(v_hat)``); the QAT case holds JAX's losses only
  (under ``jit`` XLA rewrites fake-quant's ``absmax / qmax``);
* the serve steps: ``test_torch_tp_serve.py``'s (1e-5 of each output's
  largest |value| against the port's unsharded steps; rtol 1e-4 and an
  atol of 1e-6 of the largest |value| against JAX's jitted steps).

Time: ~45 s alone (budget 120 s beside the suite's 6 workers).
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

# the first multi-threaded CPU exp of a process can be 1e-4 off (see
# test_torch_mamba2.py); one parallel exp at import takes it
torch.exp(torch.zeros(1 << 20))

MAMBA, HYMBA = "mamba2-1.3b", "hymba-1.5b"

# name -> (arch, model axis, precision (bits, group) or None, SSM changes)
TRAIN = {
    "mamba2": (MAMBA, 2, None, {}),
    "mamba2_m4": (MAMBA, 4, None, {}),
    "mamba2_w4": (MAMBA, 2, (4, -1), {}),
    "hymba": (HYMBA, 2, None, {}),
    "hymba_m4": (HYMBA, 4, None, {}),
    "mamba2_hd64": (MAMBA, 4, None, {"head_dim": 64}),
}

# name -> (arch, model axis, kv_cache_bits, SSM changes, KV cache route)
SERVE = {
    "mamba2": (MAMBA, 2, 16, {}, None),
    "mamba2_m4": (MAMBA, 4, 16, {}, None),
    "mamba2_hd64": (MAMBA, 4, 16, {"head_dim": 64}, None),
    "hymba": (HYMBA, 2, 16, {}, "heads"),
    "hymba_int4": (HYMBA, 2, 4, {}, "heads"),
}
N_TEXT, B = 16, 8


def _configs(arch, prec=None, bits=16, ssm=None):
    """JAX's and the port's smoke configs with the same changes."""
    out = []
    for get, pc in ((jconfigs.get_config, JPC), (configs.get_config,
                                                 PrecisionConfig)):
        c = get(arch, smoke=True)
        c = dataclasses.replace(c, kv_cache_bits=bits, ssm=dataclasses.replace(
            c.ssm, **(ssm or {})))
        if prec is not None:
            c = dataclasses.replace(c, precision=pc(*prec))
        out.append(c)
    return out


def _ssm_split(cfg, model):
    """Whether ``cfg``'s SSM heads split over ``model`` ranks."""
    return cfg.ssm.n_heads(cfg.d_model) % model == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (one spawn, running while this process computes
    the references): ``(ranks, train refs, serve refs)``."""
    inp = {"train": {"meshes": {2: {}, 4: {}}},
           "serve": {"meshes": {2: {}, 4: {}}, "keep": tuple(SERVE)}}
    made_t, made_s = {}, {}
    for name, (arch, mp, prec, ssm) in TRAIN.items():
        jcfg, cfg = _configs(arch, prec, ssm=ssm)
        jp = JT.init(jax.random.PRNGKey(0), jcfg)
        made_t[name] = (jcfg, cfg, jp, _batch(cfg, seed=3))
        inp["train"]["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": made_t[name][3], "tp": True, "grad_accum": 1,
            "opt": opt.OptConfig(**LR)}
    for name, (arch, mp, bits, ssm, _) in SERVE.items():
        jcfg, cfg = _configs(arch, bits=bits, ssm=ssm)
        jp = japi.get_model(jcfg).init(jax.random.PRNGKey(0))
        batch, steps = _inputs(cfg, N_TEXT, seed=5)
        made_s[name] = (jcfg, jp, batch, steps, mp)
        inp["serve"]["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": batch, "steps": steps, "pad": mp}
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_ranks, "tp_ssm", 8,
                            tmp_path_factory.mktemp("tp_ssm"), inp,
                            timeout=300)
        train, done = {}, {}
        for name, (jcfg, cfg, jp, batch) in made_t.items():
            key = (TRAIN[name][0], TRAIN[name][2],
                   tuple(TRAIN[name][3].items()))
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
def test_tp_ssm_step_against_the_unsharded_step(runs, name):
    ref = runs[1][name]["port"]
    ranks = _ranks(runs, "train", name)
    for o in ranks:
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-5)
        assert o["placed"]
    _check(ranks[0]["steps"], ref["steps"], ref["steps"][0]["v"], 1e-5,
           1e-5, name)


@pytest.mark.parametrize("name", list(TRAIN))
def test_tp_ssm_step_against_jax(runs, name):
    ref = runs[1][name]
    for o in _ranks(runs, "train", name):
        np.testing.assert_allclose(o["losses"], ref["jax"]["losses"],
                                   rtol=1e-4)
    if TRAIN[name][2] is not None:
        return      # jitted QAT: see the module docstring
    _check(_ranks(runs, "train", name)[0]["steps"][:1],
           ref["jax"]["steps"][:1], ref["port"]["steps"][0]["v"], 1e-4,
           1e-4, name)


SHARD = {d: (f"Shard(dim={d})", f"Shard(dim={d})") for d in (0, 1)}
REPL = ("Replicate()", "Replicate()")
GATHERED = ("Replicate()", "Partial(sum)")


def _want_split(model, ssm, leaf):
    """The (forward, gradient) placement on ``model`` of a smoke SSM or
    hybrid config's leaf: the mixer's ``in_proj`` and conv gathered and
    narrowed (a partial gradient), its per-head leaves and
    ``out_proj``'s rows split, where its heads split; hymba's attention
    as the dense rules (its 2 KV heads gathered on 4 ranks) and its MLP
    split; mamba2's 256-token vocab split."""
    if "/ssm/" in leaf:
        if not ssm:
            return REPL
        if leaf.endswith(("in_proj/w", "conv_w", "conv_b")):
            return GATHERED
        return SHARD[0]
    if leaf == "embed":
        return SHARD[0]
    if leaf.endswith(("attn/wq/w", "mlp/wi/w", "mlp/wg/w")):
        return SHARD[1]
    if leaf.endswith(("attn/wo/w", "mlp/wo/w")):
        return SHARD[0]
    if leaf.endswith(("attn/wk/w", "attn/wv/w")):
        return GATHERED if model == 4 else SHARD[1]
    return REPL


@pytest.mark.parametrize("kind,name", [("train", n) for n in TRAIN] +
                         [("serve", n) for n in SERVE])
def test_tp_ssm_holds_the_mixer_split(runs, kind, name):
    """Each mixer leaf is held as the route says in the train step's
    forward and backward and in the serve steps (``Shard`` where the
    SSM heads split, ``Replicate()`` where the mixer runs whole)."""
    case = (TRAIN if kind == "train" else SERVE)[name]
    arch, model = case[:2]
    cfg = _configs(arch, ssm=case[3])[1]
    ssm = _ssm_split(cfg, model)
    for o in _ranks(runs, kind, name):
        split = o["split"]
        assert any(k.endswith("ssm/in_proj/w") for k in split), name
        for leaf, got in split.items():
            assert got == _want_split(model, ssm, leaf), (
                name, leaf, got)


# --- the serve steps ---------------------------------------------------------


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_ssm_serve_against_the_unsharded_steps(runs, name):
    arch, model, _, ssm, route = SERVE[name]
    cfg = _configs(arch, ssm=ssm)[1]
    split = _ssm_split(cfg, model)
    for o in _ranks(runs, "serve", name):
        assert o["routes"] == [route] * 3, (name, o["routes"])
        assert o["ssm"] == [split] * 3, (name, o["ssm"])
        # the conv inputs' contiguous channel split is not the rank's
        # heads': a decode step reads each layer through _LayerRows, as
        # it does a state the rank holds whole
        want = ["conv"] if split else ["conv", "ssm"]
        assert len(o["gathered"]) == 2 * len(want), (name, o["gathered"])
        assert set(o["checks"]) == {"prefill", "decode0", "decode1"}
        for step, entries in o["checks"].items():
            assert {"logits", "len", "conv", "ssm"} <= set(entries)
            for key, (err, placed, want) in entries.items():
                assert err <= 1e-5, (name, step, key, err)
                assert placed == want, (name, step, key, placed, want)


@pytest.mark.parametrize("name", list(SERVE))
def test_tp_ssm_serve_against_jax(runs, name):
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


# --- the split patterns and the contexts --------------------------------------

#: each Mamba-2 leaf kind (the path from ``ssm/``) -> its ``_SPLITS`` row's
#: (part, dim): ``None`` for a leaf held whole and narrowed
SSM_INTENDED = {
    "ssm/in_proj/w": ("ssm", None), "ssm/conv_w": ("ssm", None),
    "ssm/conv_b": ("ssm", None), "ssm/out_proj/w": ("ssm", 0),
    "ssm/A_log": ("ssm", 0), "ssm/dt_bias": ("ssm", 0),
    "ssm/D": ("ssm", 0), "ssm/norm_g": ("ssm", 0),
}


def test_ssm_split_patterns_match_the_intended_leaves():
    """The ``ssm/`` rows of ``_SPLITS`` match exactly the Mamba-2 leaves
    of the 10 archs (mamba2's and hymba's layers), each once, and no
    other leaf; a row's split dim is the leaf's head-major dim."""
    cfgs = [configs.get_config(a, smoke=True) for a in configs.ARCH_IDS]
    rows = [(pat, part, dim) for pat, part, dim in TP._SPLITS
            if part == "ssm"]
    matched = set()
    for cfg in cfgs:
        for path, t in leaves_with_path(get_model(cfg).init(0,
                                                            device="meta")):
            ps = "/".join(str(k) for k in path)
            kind = re.sub(r"^layers/\d+/", "", ps)
            hits = [(part, dim) for pat, part, dim in rows
                    if re.search(pat, ps)]
            want = SSM_INTENDED.get(kind)
            assert hits == ([want] if want else []), (cfg.name, ps, hits)
            if want is None:
                continue
            matched.add((cfg.name, kind))
            s = cfg.ssm
            din, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
            if want[1] == 0:
                per_head = kind in ("ssm/A_log", "ssm/dt_bias", "ssm/D")
                assert t.shape[0] == (nh if per_head else din), (ps, t.shape)
    assert {k for _, k in matched} == set(SSM_INTENDED)
    assert {n for n, _ in matched} == {"mamba2-smoke", "hymba-smoke"}


class _Mesh:
    """A stand-in for a ``(data, model)`` mesh: what ``TensorParallel``
    reads of one."""

    mesh_dim_names = ("data", "model")

    def __init__(self, model, rank):
        self.model, self.rank = model, rank

    def get_group(self, name):
        return None

    def size(self, i):
        return self.model

    def get_local_rank(self, name):
        return self.rank


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_for_step_admits_the_ssm_and_hybrid_families(arch):
    """On 16 ``model`` ranks: mamba2-1.3b splits its 64 SSM heads, 4 a
    rank, which read 772 of ``in_proj``'s 8512 columns (256 of z, 256 of
    x, B and C's 256, 4 of dt) and 512 of the conv's 4352 channels, and
    no attention flag is set; hymba-1.5b splits only its MLP (25 heads,
    5 KV heads, 50 SSM heads, vocab 32001); whisper-base takes the route
    too, splitting only its MLP (8 heads, vocab 51865)."""
    cfg = configs.get_config(arch)
    tp = TP.for_step(cfg, _Mesh(16, 3))
    assert tp is not None
    if arch == "whisper-base":
        assert (tp.heads, tp.kv, tp.ssm, tp.vocab, tp.mlp) == (
            False, False, False, False, True)
        return
    if cfg.family == "ssm":
        assert not (tp.heads or tp.kv or tp.mlp or tp.vocab)
        assert tp.ssm and tp.ssm_heads == 4
        assert len(tp._ssm_cols) == 772 and len(tp._ssm_conv) == 512
        # rank 3's heads 12-15: z and x channels 768-1023, dt 8508-8511
        assert tp._ssm_cols[0] == 768 and tp._ssm_cols[-1] == 8448 + 15
        assert tp._ssm_conv[0] == 768 and tp._ssm_conv[-1] == 4351
    elif arch == HYMBA:
        assert (tp.heads, tp.kv, tp.ssm, tp.vocab, tp.mlp) == (
            False, False, False, False, True)
    else:
        assert not tp.ssm


def test_ssm_shard_narrows_in_proj_to_the_ranks_heads():
    """``ssm_shard`` on each of 2 ranks of mamba2-smoke: the narrowed
    ``in_proj`` is the whole one's z, x and dt of the rank's 4 heads and
    B and C whole, in the whole layout; the narrowed conv the same
    channels; the other leaves untouched."""
    cfg = configs.get_config(MAMBA, smoke=True)
    s = cfg.ssm
    din, nh, hp = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.head_dim
    gn = s.n_groups * s.d_state
    p = get_model(cfg).init(0, device="cpu")["layers"][0]["ssm"]
    w, cw = p["in_proj"]["w"], p["conv_w"]
    for rank in range(2):
        tp = TP.TensorParallel(cfg, _Mesh(2, rank))
        got = tp.ssm_shard(p)
        lo, hi = rank * din // 2, (rank + 1) * din // 2
        want = torch.cat([w[:, lo:hi], w[:, din + lo:din + hi],
                          w[:, 2 * din:2 * din + 2 * gn],
                          w[:, 2 * din + 2 * gn + rank * nh // 2:
                            2 * din + 2 * gn + (rank + 1) * nh // 2]], 1)
        assert torch.equal(got["in_proj"]["w"], want)
        assert torch.equal(got["conv_w"], torch.cat(
            [cw[:, lo:hi], cw[:, din:]], 1))
        assert got["A_log"] is p["A_log"] and got["norm_g"] is p["norm_g"]
        assert tp.ssm_heads * hp == hi - lo


def test_one_rank_route_is_the_unsharded_arithmetic(tmp_path):
    """On a one-rank gloo group and its (1, 1) mesh, what the card's check
    runs: hymba's tensor-parallel train step (2 steps) and its prefill
    and 2 decode steps are bit-equal to the unsharded ones, with every
    part split (its attention and mixer read one ``copy_in`` node).  In
    a spawned rank of one CPU thread (``case_tp_one_rank``): a
    multi-threaded CPU run is not bit-reproducible run to run."""
    cfg = configs.get_config(HYMBA, smoke=True)
    g = np.random.default_rng(0)
    batch = {k: torch.from_numpy(g.integers(0, cfg.vocab, (4, 32)))
             for k in ("tokens", "labels")}
    steps_ = [torch.from_numpy(g.integers(0, cfg.vocab, (4, 1)))
              for _ in range(2)]
    (got,) = run_ranks("tp_one_rank", 1, tmp_path, {
        "cfg": cfg, "batch": batch, "steps": steps_, "lr": LR})
    assert all(got["flags"].values()), got["flags"]
    ref, mine = got["unsharded"], got["tp"]
    assert mine["losses"] == ref["losses"]
    assert all(torch.equal(a, b) for a, b in zip(mine["params"],
                                                 ref["params"]))
    assert len(mine["serve"]) == len(ref["serve"])
    assert all(torch.equal(a, b) for a, b in zip(mine["serve"],
                                                 ref["serve"]))
