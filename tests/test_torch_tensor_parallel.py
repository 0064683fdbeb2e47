"""The tensor-parallel train step (``distributed/tensor_parallel.py``,
``make_train_step(tensor_parallel=True)``) and ``grad_accum`` on a mesh,
on 8 gloo ranks on the CPU, against the port's unsharded step and JAX's.

One spawn of 8 ranks (``run_ranks`` of ``test_torch_distributed``,
``case_tp`` of ``tests/_torch_dist_ranks.py``) runs every case on its
mesh: 2 steps from JAX's initial params (smoke configs, 2 layers,
float32, batch 8 x 32, labels partly masked).

* 4 x 2 (``model`` = 2): olmo-1b (tied embedding, MHA), stablelm-1.6b
  (LayerNorm, ``qkv_bias``, untied head), gemma2-2b (soft caps, sliding
  window), internlm2-20b (GQA split: 3 query and 1 KV head a rank),
  paligemma-3b (1 KV head, gathered; the vision prefix and
  ``vision_proj``), olmo-1b W4 QAT per channel (the absmax of a
  row-parallel weight is a max over ``model``), and olmo-1b with
  ``grad_accum=2`` on both routes;
* 2 x 4 (``model`` = 4): internlm2-20b (6 heads on 4 ranks: whole heads,
  the MLP and vocab split) and olmo-1b W4 QAT with groups of 128 (a
  group of ``mlp/wo`` spans two ranks' rows: quantized on the gathered
  contraction).

Tolerances, each with its reason:

* against the port's unsharded step: losses of both steps within rtol
  1e-5.  After step 1, ``m`` and ``v`` within rtol 1e-5 and an atol of
  1e-5 of the leaf's largest |value| (sums of the gradients and their
  squares: the split contractions sum in another order, ~1e-6 of the
  leaf's scale at most), and params within rtol 1e-5 and an atol of
  1e-6 of the leaf's largest |value| where AdamW's update is well
  conditioned: ``sqrt(v_hat)`` 0 or at least 1e-2 of the leaf's
  largest (at least half of every leaf), elsewhere within ``2 * lr``.
  AdamW divides by ``sqrt(v_hat)``, so where a gradient is near 0 a
  rounding of ~1e-7 of the leaf's scale moves the update by a share of
  ``lr`` (``g / (|g| + eps)`` of a gradient near ``eps``).  A float64
  unsharded step moves such elements as far from the float32 one (16 of
  olmo smoke's embedding elements, one of ``mlp/wo`` by 11x the bound
  of ``test_sharded_olmo_step_on_a_four_by_two_mesh``): no split of the
  compute meets that test's bound, which the FSDP route meets because
  its forward is the unsharded one on each rank's rows.  After step 2,
  ``m``, ``v`` and params within rtol 1e-4 in each leaf's norm: step 2's
  gradients are taken at params that moved apart where step 1 was ill
  conditioned, and a gradient element can follow its own param;
* against JAX's jitted step: losses within rtol 1e-4; after step 1,
  ``m`` and ``v`` within rtol 1e-4 and an atol of 1e-4 of the leaf's
  largest |value| (``test_torch_train.py``'s step tolerance), params on
  the well-conditioned set at an atol of 1e-5 of it (the same set and
  rule as above), every leaf: the port's AdamW decays a layer's 1-D
  norm scales and biases as JAX decays its stacked (L, d) leaves
  (``optimizer.decays``).  Step 2's moments and params are held to the
  unsharded step only.  The QAT cases hold JAX's losses only: under ``jit`` XLA rewrites
  fake-quant's ``absmax / qmax`` into a multiply by the reciprocal, which
  moves ~0.4% of the moments' elements (``test_torch_train.py`` holds
  the port's unsharded QAT step to JAX op by op, ~30 s of compiles);
* ``grad_accum=2`` on the FSDP route: ``test_sharded_olmo_step_on_a_
  four_by_two_mesh``'s tolerances, unchanged;
* the split: on the 4 x 2 mesh a rank's matmul FLOPs of olmo-1b's
  tensor-parallel step are half the unsharded step's on the rank's rows
  (within 1%), the FSDP step's equal to them;
* the dry run of olmo-1b ``train_4k`` at depth 2 on the fake 16 x 16
  mesh: ``flops_per_device`` x 256 within 10% of the unsharded step's
  count of the same cell.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as JT
from repro.quant.formats import PrecisionConfig as JPC
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.launch import steps
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import map_tree
from test_torch_distributed import _flat_np, _get, run_ranks

ROOT = Path(__file__).resolve().parents[1]
LR = dict(lr=1e-3, warmup_steps=2, total_steps=20)

# name -> (arch, model axis, precision (bits, group) or None, grad_accum,
#          tensor-parallel)
CASES = {
    "olmo": ("olmo-1b", 2, None, 1, True),
    "stablelm": ("stablelm-1.6b", 2, None, 1, True),
    "gemma2": ("gemma2-2b", 2, None, 1, True),
    "internlm2": ("internlm2-20b", 2, None, 1, True),
    "paligemma": ("paligemma-3b", 2, None, 1, True),
    "olmo_w4": ("olmo-1b", 2, (4, -1), 1, True),
    "olmo_accum": ("olmo-1b", 2, None, 2, True),
    "olmo_accum_fsdp": ("olmo-1b", 2, None, 2, False),
    "internlm2_whole_heads": ("internlm2-20b", 4, None, 1, True),
    "olmo_w4_g128": ("olmo-1b", 4, (4, 128), 1, True),
}
TP_CASES = [k for k, c in CASES.items() if c[4]]


def _configs(name):
    arch, _, prec, _, _ = CASES[name]
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    if prec is not None:
        jcfg = dataclasses.replace(jcfg, precision=JPC(*prec))
        cfg = dataclasses.replace(cfg, precision=PrecisionConfig(*prec))
    return jcfg, cfg


def _batch(cfg, seed):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels = g.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels[0, :5] = -1
    b = {"tokens": toks, "labels": labels}
    if cfg.vision_prefix_len:
        b["vision_embeds"] = g.standard_normal(
            (8, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
    return b


def _port(cfg, npp, batch, grad_accum):
    """The port's unsharded step, 2 steps: losses and each step's whole
    params, ``m`` and ``v`` (numpy)."""
    tp = convert.lm_params_from_numpy(npp, device="cpu")
    state = opt.init(tp)
    step = steps.make_train_step(cfg, opt.OptConfig(**LR), grad_accum)
    tb = {k: torch.from_numpy(v).to(torch.float32 if v.dtype.kind == "f"
                                    else torch.int64)
          for k, v in batch.items()}
    out = {"losses": [], "steps": []}
    for _ in range(2):
        tp, state, m = step(tp, state, tb)
        out["losses"].append(m["loss"].item())
        out["steps"].append({k: convert.lm_params_to_numpy(map_tree(
            torch.clone, t)) for k, t in (("params", tp), ("m", state["m"]),
                                          ("v", state["v"]))})
    return out


def _jax(jcfg, jp, batch, grad_accum):
    """JAX's jitted step, 2 steps: losses and each step's params, ``m``,
    ``v``."""
    step = jax.jit(jmake_train_step(jcfg, jopt.OptConfig(**LR), grad_accum))
    state = jopt.init(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"losses": [], "steps": []}
    for _ in range(2):
        jp, state, m = step(jp, state, jb)
        out["losses"].append(float(m["loss"]))
        out["steps"].append(jax.tree.map(np.asarray, {
            "params": jp, "m": state["m"], "v": state["v"]}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's ranks (one spawn, running while this process computes
    the references), the port's unsharded step and JAX's, from the same
    params and batch."""
    inp = {"meshes": {2: {}, 4: {}}}
    made = {}
    for name, (arch, mp, prec, ga, tp) in CASES.items():
        jcfg, cfg = _configs(name)
        jp = JT.init(jax.random.PRNGKey(0), jcfg)
        made[name] = (jcfg, cfg, jp, _batch(cfg, seed=3), ga)
        inp["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": made[name][3], "tp": tp, "grad_accum": ga,
            "opt": opt.OptConfig(**LR)}
    inp["flops"] = dict(inp["meshes"][2]["olmo"])
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_ranks, "tp", 8, tmp_path_factory.mktemp("tp"),
                            inp, timeout=300)
        refs, done = {}, {}
        for name, (jcfg, cfg, jp, batch, ga) in made.items():
            key = (CASES[name][0], CASES[name][2], ga)   # same step
            if key not in done:
                npp = jax.tree.map(np.asarray, jp)
                done[key] = {"port": _port(cfg, npp, batch, ga),
                             "jax": _jax(jcfg, jp, batch, ga)}
            refs[name] = done[key]
        got = spawn.result()
    return got, refs


def _ranks(runs, name):
    return [r[name] for r in runs[0]]


def _well_conditioned(v, name):
    """Elements whose first AdamW update is well conditioned:
    ``sqrt(v_hat)`` 0 (no gradient: the update is the weight decay) or
    at least 1e-2 of the leaf's largest."""
    r = np.sqrt(_get(v, name) / (1 - opt.OptConfig().b2))
    return (r == 0) | (r >= 1e-2 * r.max())


def _check(mine, want, v1, rtol, atol_frac, where):
    """Step 1 element by element (params on the well-conditioned set,
    within ``2 * lr`` elsewhere), step 2 within rtol 1e-4 in each leaf's
    norm."""
    lr1 = float(opt.schedule(opt.OptConfig(**LR), torch.tensor(1)))
    for t, (got, ref) in enumerate(zip(mine, want), start=1):
        for key in ("params", "m", "v"):
            for leaf, a in _flat_np(got[key]):
                w = _get(ref[key], leaf)
                msg = f"{where}: step {t} {key}{leaf}"
                if t == 2:
                    err = np.linalg.norm(a - w) / max(np.linalg.norm(w),
                                                      1e-30)
                    assert err <= 1e-4, (msg, err)
                    continue
                big = np.abs(w).max()
                if key != "params":
                    np.testing.assert_allclose(a, w, rtol=rtol,
                                               atol=atol_frac * big,
                                               err_msg=msg)
                    continue
                well = _well_conditioned(v1, leaf)
                close = np.abs(a - w) <= rtol * np.abs(w) + \
                    atol_frac / 10 * big
                assert well.mean() >= 0.5, (msg, well.mean())
                assert close[well].all(), (msg, (a - w)[well & ~close])
                assert np.all(np.abs(a - w) <= 2 * lr1), msg


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_step_against_the_unsharded_step(runs, name):
    ranks = _ranks(runs, name)
    ref = runs[1][name]["port"]
    for o in ranks:
        np.testing.assert_allclose(o["losses"], ref["losses"], rtol=1e-5)
        assert o["placed"]
    _check(ranks[0]["steps"], ref["steps"], ref["steps"][0]["v"], 1e-5,
           1e-5, name)


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_step_against_jax(runs, name):
    ranks = _ranks(runs, name)
    ref = runs[1][name]
    for o in ranks:
        np.testing.assert_allclose(o["losses"], ref["jax"]["losses"],
                                   rtol=1e-4)
    if CASES[name][2] is not None:
        return      # jitted QAT: see the module docstring
    _check(ranks[0]["steps"][:1], ref["jax"]["steps"][:1],
           ref["port"]["steps"][0]["v"], 1e-4, 1e-4, name)


#: the model-axis (forward, gradient) placement each case's weights take
SHARD = {d: (f"Shard(dim={d})", f"Shard(dim={d})") for d in (0, 1)}
REPL = ("Replicate()", "Replicate()")
GATHERED = ("Replicate()", "Partial(sum)")


def _want_split(name, leaf):
    """The expected (forward, gradient) placement on ``model``."""
    whole_heads = name == "internlm2_whole_heads"
    kv_gathered = name == "paligemma"
    if leaf in ("embed",):
        return SHARD[0]
    if leaf in ("lm_head/w", "vision_proj/w"):
        return SHARD[1]
    for part, dim in (("attn/wq/w", 1), ("attn/wq/b", 0), ("attn/wo/w", 0)):
        if leaf.endswith(part):
            return REPL if whole_heads else SHARD[dim]
    for part, dim in (("attn/wk/", 1), ("attn/wv/", 1)):
        if part in leaf:
            dim = 1 if leaf.endswith("/w") else 0
            if whole_heads:
                return REPL
            return GATHERED if kv_gathered else SHARD[dim]
    if leaf.endswith(("mlp/wi/w", "mlp/wg/w")):
        return SHARD[1]
    if leaf.endswith("mlp/wo/w"):
        return SHARD[0]
    return REPL


@pytest.mark.parametrize("name", TP_CASES)
def test_tp_step_keeps_the_weights_split(runs, name):
    """Every weight of the dense layers is held split over ``model`` in
    the forward and its gradient is the rank's slice, but for whole-head
    attention (replicated) and gathered KV weights (partial sums)."""
    for o in _ranks(runs, name):
        split = o["split"]
        assert split, name
        for leaf, got in split.items():
            assert got == _want_split(name, leaf), (name, leaf, got)
        assert any(v == SHARD[1] for v in split.values())


def test_grad_accum_on_the_fsdp_route(runs):
    """``grad_accum=2`` on the FSDP route, at
    ``test_sharded_olmo_step_on_a_four_by_two_mesh``'s tolerances."""
    ranks = _ranks(runs, "olmo_accum_fsdp")
    ref = runs[1]["olmo_accum_fsdp"]
    want_t = ref["port"]["steps"][-1]["params"]
    want_j = ref["jax"]["steps"][-1]["params"]
    for o in ranks:
        np.testing.assert_allclose(o["losses"], ref["port"]["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o["losses"], ref["jax"]["losses"],
                                   rtol=1e-4)
        assert o["placed"] and not o["split"]
    for name, a in _flat_np(ranks[0]["steps"][-1]["params"]):
        w = _get(want_t, name)
        big = np.abs(w).max()
        strict = np.abs(a - w) <= 1e-5 * np.abs(w) + 1e-6 * big
        assert strict.mean() >= 0.9999, (name, strict.mean())
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5 * big,
                                   err_msg=name)
        w = _get(want_j, name)
        np.testing.assert_allclose(a, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_grad_accum_splits_global_rows_as_jax(runs):
    """``grad_accum=2`` on a mesh takes the microbatches JAX's reshape
    makes (global rows 0-3 and 4-7), not each rank's own rows split in
    two: those pair other rows (0, 2, 4, 6 and 1, 3, 5, 7 on 4 data
    ranks of 2 rows), whose loss is another mean (row 0's masked labels
    weigh otherwise), more than 1e-5 away, so the rtol 1e-5 check
    against the port's unsharded step tells the two apart."""
    name = "olmo_accum"
    jcfg, cfg = _configs(name)
    batch = _batch(cfg, seed=3)
    npp = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    paired = {k: v[[0, 2, 4, 6, 1, 3, 5, 7]] for k, v in batch.items()}
    other = _port(cfg, npp, paired, 2)["losses"][0]
    want = runs[1][name]["port"]["losses"][0]
    np.testing.assert_allclose(want, runs[1][name]["jax"]["losses"][0],
                               rtol=1e-5)
    assert abs(other - want) > 1e-5 * abs(want), (other, want)
    for o in _ranks(runs, name):
        np.testing.assert_allclose(o["losses"][0], want, rtol=1e-5)


def test_tp_halves_a_ranks_matmul_flops(runs):
    for r in runs[0]:
        f = r["flops"]
        assert f["fsdp"] == f["unsharded"]
        assert abs(f["tp"] / f["unsharded"] - 0.5) <= 0.01, f


def test_dryrun_train_cell_splits_the_flops_over_256_ranks(tmp_path):
    """olmo-1b ``train_4k`` at depth 2 on the fake 16 x 16 mesh (in a
    subprocess: the fake group is process-global)."""
    code = f"""
        import dataclasses, json
        from pathlib import Path
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import dryrun as D
        from repro_torch.launch import specs as S
        from repro_torch.launch import steps as St
        from repro_torch.perfmodel.flops import count_fn_flops
        from repro_torch.perfmodel.roofline import override_depth
        from repro_torch.train.optimizer import OptConfig

        D.RESULTS_DIR = Path({str(tmp_path)!r})
        cfg = override_depth(get_config("olmo-1b"), 2)
        rec = D.run_cell_cfg(cfg, "olmo-1b", "train_4k", force=True)
        c = D.cell_config(cfg, SHAPES["train_4k"])
        p = S.param_specs_struct(c)
        whole = count_fn_flops(St.make_train_step(c, OptConfig()), p,
                               S.opt_specs_struct(p),
                               S.train_batch_specs(c, SHAPES["train_4k"]))
        print(json.dumps({{"rec": {{k: rec.get(k) for k in (
            "ok", "error", "flops_per_device", "n_devices",
            "argument_size_in_bytes", "temp_size_in_bytes",
            "collective_bytes")}}, "whole": whole}}))
    """
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=240,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    rec = res["rec"]
    assert rec["ok"], rec["error"]
    ratio = rec["flops_per_device"] * rec["n_devices"] / res["whole"]
    assert rec["n_devices"] == 256
    assert abs(ratio - 1) <= 0.1, ratio
    # the split's all-reduces over model, beside FSDP's gathers
    assert rec["collective_bytes"]["all-reduce"] > 0
    assert rec["argument_size_in_bytes"] + rec["temp_size_in_bytes"] \
        < 80e9
