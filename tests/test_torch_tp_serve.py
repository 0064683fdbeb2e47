"""The tensor-parallel route of the prefill and decode steps
(``make_prefill_step``, ``make_decode_step`` on DTensor params of the
dense and VLM families) on 8 gloo ranks on the CPU, against the port's
unsharded steps and JAX's.

One spawn of 8 ranks (``run_ranks`` of ``test_torch_distributed``,
``case_tp_serve`` of ``tests/_torch_dist_ranks.py``) runs every case on
its mesh: JAX's initial params of the smoke configs (2 layers, float32),
batch 8, a prefill of 16 text tokens (paligemma: 8 vision positions
before them), then 2 decode steps from the cache padded by ``pad``
positions, given the whole cache's length from the host.  The KV cache
route is where ``cache_entry_spec`` puts ``model``:

* 4 x 2 (``model`` = 2): olmo-1b, stablelm-1.6b, gemma2-2b and
  internlm2-20b (3 query heads and 1 KV head a rank) split the KV heads
  (route a); paligemma-3b (1 KV head: ``wk``/``wv`` gathered) splits the
  24 positions (route b); paligemma over 15 text tokens (23 and 25
  positions, which 2 does not divide) keeps the cache whole (route c);
  olmo-1b over an INT4 cache on route a (``kv_attention``'s plain
  version);
* 2 x 4 (``model`` = 4): internlm2-20b (6 heads on 4 ranks: whole heads)
  and gemma2-2b (heads split, 2 KV heads gathered; the 16-position
  window crossed) split the 16 and 20 positions (route b); olmo-1b
  splits the KV heads (route a); paligemma-3b over an INT4 cache splits
  the positions, which a decode step gathers layer by layer (the packed
  cache's exception).

Tolerances, each with its reason:

* against the port's unsharded steps: logits and every cache entry
  within 1e-5 of the output's largest |value| (the split contractions
  and the softmax merged over ``model`` sum in another order; float32);
  each output placed as ``logits_spec`` / ``cache_specs`` say;
* against JAX's unsharded ``prefill`` / ``decode_step`` (every case,
  jitted): rtol 1e-4, and an atol of 1e-6 of the output's
  largest |value| for elements near 0, where a relative bound means
  nothing (``test_torch_lm.py``'s logits atol of 1e-5 on values ~1);
* the dry run of olmo-1b ``decode_32k`` at depth 2 on the fake 16 x 16
  mesh: against the unsharded step's count of the same cell, op by op,
  the rank's matmul FLOPs x 256 within 10%, and its other FLOPs x 256
  within 10% once the unsharded step's copies of the cache are taken
  out (``clone`` and ``_unsafe_view`` of the permuted 16-head K and V,
  charged 1 flop an element, which a rank holding one KV head does not
  make; asserted to be those copies); no all-gather over ``model``.
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

import repro.configs as jconfigs
from repro.models import api as japi
from repro_torch import configs
from test_torch_distributed import run_ranks

ROOT = Path(__file__).resolve().parents[1]

# name -> (arch, model axis, text tokens, pad, kv_cache_bits,
#          cache route of (prefill, decode), heads split)
CASES = {
    "olmo": ("olmo-1b", 2, 16, 2, 16, ("heads", "heads"), True),
    "stablelm": ("stablelm-1.6b", 2, 16, 2, 16, ("heads", "heads"), True),
    "gemma2": ("gemma2-2b", 2, 16, 2, 16, ("heads", "heads"), True),
    "internlm2": ("internlm2-20b", 2, 16, 2, 16, ("heads", "heads"), True),
    "paligemma": ("paligemma-3b", 2, 16, 2, 16, ("seq", "seq"), True),
    "paligemma_whole": ("paligemma-3b", 2, 15, 2, 16, ("whole", "whole"),
                        True),
    "olmo_int4": ("olmo-1b", 2, 16, 2, 4, ("heads", "heads"), True),
    "internlm2_whole_heads": ("internlm2-20b", 4, 16, 4, 16, ("seq", "seq"),
                              False),
    "gemma2_seq": ("gemma2-2b", 4, 16, 4, 16, ("seq", "seq"), True),
    "olmo_m4": ("olmo-1b", 4, 16, 4, 16, ("heads", "heads"), True),
    "paligemma_int4_seq": ("paligemma-3b", 4, 16, 4, 4, ("seq", "whole"),
                           True),
}
#: the cases held against JAX too: all of them
JAX_CASES = tuple(CASES)
B = 8


def _configs(name):
    arch, _, _, _, bits, _, _ = CASES[name]
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               kv_cache_bits=bits)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              kv_cache_bits=bits)
    return jcfg, cfg


def _inputs(cfg, n_text, seed):
    g = np.random.default_rng(seed)
    batch = {"tokens": g.integers(0, cfg.vocab, (B, n_text))}
    if cfg.vision_prefix_len:
        batch["vision_embeds"] = g.standard_normal(
            (B, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
    steps = [g.integers(0, cfg.vocab, (B, 1)) for _ in range(2)]
    return batch, steps


def _jax(jcfg, jp, batch, steps, pad):
    """JAX's jitted prefill and decode steps: each step's logits and
    cache (numpy)."""
    mb = japi.get_model(jcfg)
    logits, cache = jax.jit(mb.prefill)(jp, {
        k: jnp.asarray(v) for k, v in batch.items()})
    out = {"prefill": {"logits": logits, **cache}}
    cache = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, pad)] +
                         [(0, 0)] * (v.ndim - 3))
                 if k in ("k", "v", "k_scale", "v_scale") else v)
             for k, v in cache.items()}
    step = jax.jit(mb.decode_step)
    for t, toks in enumerate(steps):
        logits, cache = step(jp, cache, jnp.asarray(toks, jnp.int32))
        out[f"decode{t}"] = {"logits": logits, **cache}
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results (one spawn, running while this process computes
    JAX's references) and JAX's outputs of the cases it is held to."""
    inp = {"meshes": {2: {}, 4: {}}, "keep": JAX_CASES}
    made = {}
    for name, (arch, mp, n_text, pad, _, _, _) in CASES.items():
        jcfg, cfg = _configs(name)
        jp = japi.get_model(jcfg).init(jax.random.PRNGKey(0))
        batch, steps = _inputs(cfg, n_text, seed=5)
        made[name] = (jcfg, jp, batch, steps, pad)
        inp["meshes"][mp][name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
            "batch": batch, "steps": steps, "pad": pad}
    with ThreadPoolExecutor(1) as pool:
        spawn = pool.submit(run_ranks, "tp_serve", 8,
                            tmp_path_factory.mktemp("tp_serve"), inp,
                            timeout=240)
        refs = {name: _jax(*made[name][:2], *made[name][2:])
                for name in JAX_CASES}
        got = spawn.result()
    return got, refs


@pytest.mark.parametrize("name", list(CASES))
def test_tp_serve_against_the_unsharded_steps(runs, name):
    for o in runs[0]:
        res = o[name]["checks"]
        assert set(res) == {"prefill", "decode0", "decode1"}
        for step, entries in res.items():
            assert "logits" in entries and "len" in entries and \
                "k" in entries
            for key, (err, placed, want) in entries.items():
                assert err <= 1e-5, (name, step, key, err)
                assert placed == want, (name, step, key, placed, want)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_serve_takes_the_cache_route(runs, name):
    """Each step took the tensor-parallel route with the case's cache
    route and head split; no cache entry was gathered (``_LayerRows``)
    but the packed cache's layers on a sequence split, which are
    gathered over ``model`` only (``Replicate()`` there)."""
    _, mp, _, _, bits, (pre, dec), heads = CASES[name]
    for o in runs[0]:
        r = o[name]
        assert r["routes"] == [pre, dec, dec], (name, r["routes"])
        assert r["heads"] == [heads] * 3, (name, r["heads"])
        if bits != 16 and pre == "seq":
            assert r["gathered"], name
            # (data, model) placements of the stacked (L, B, ...) entry
            assert {g for g in r["gathered"]} == {
                ("Shard(dim=1)", "Replicate()")}, r["gathered"]
        else:
            assert r["gathered"] == [], (name, r["gathered"])


@pytest.mark.parametrize("name", JAX_CASES)
def test_tp_serve_against_jax(runs, name):
    got = runs[0][0][name]["outs"]
    want = runs[1][name]
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


def _dryrun_decode(tmp_path, arch):
    """``arch``'s ``decode_32k`` at depth 2 on the fake 16 x 16 mesh (in
    a subprocess: the fake group is process-global): the cell's record,
    its FLOPs by op on rank 0 (``mine``) and the unsharded step's on the
    cell (``whole``), the matmul FLOPs of each whose output spans the
    vocab (``head``: the logits), and the all-gathers over ``model``."""
    code = f"""
        import collections
        import json
        from pathlib import Path
        import torch
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import dryrun as D
        from repro_torch.launch import specs as S
        from repro_torch.launch import steps as St
        from repro_torch.perfmodel.roofline import override_depth
        from repro_torch.perfmodel.flops import _FlopCounter, _op_flops

        D.RESULTS_DIR = Path({str(tmp_path)!r})
        groups, gathers = {{}}, []
        mine, whole = collections.Counter(), collections.Counter()
        head = collections.Counter()
        place_cell, charge = D.place_cell, D.CellWalker.charge
        vocab = get_config({arch!r}).vocab

        def logits(func, out):
            return func.overloadpacket.__name__ in (
                "mm", "addmm", "bmm", "baddbmm") and \
                getattr(out, "shape", (0,))[-1] == vocab

        def placed(cfg, shape, mesh):
            groups["model"] = mesh.get_group("model").group_name
            return place_cell(cfg, shape, mesh)

        def counted(self, func, args, out):
            if func.overloadpacket.__name__.startswith("all_gather"):
                gathers.append(args[2])
            mine[func.overloadpacket.__name__] += _op_flops(func, args, out)
            if logits(func, out):
                head["mine"] += _op_flops(func, args, out)
            return charge(self, func, args, out)

        class ByOp(_FlopCounter):
            def charge(self, func, args, out):
                whole[func.overloadpacket.__name__] += _op_flops(
                    func, args, out)
                if logits(func, out):
                    head["whole"] += _op_flops(func, args, out)
                super().charge(func, args, out)

        D.place_cell, D.CellWalker.charge = placed, counted
        shape = SHAPES["decode_32k"]
        cfg = override_depth(get_config({arch!r}), 2)
        rec = D.run_cell_cfg(cfg, {arch!r}, "decode_32k", force=True)
        c = D.cell_config(cfg, shape)
        tokens = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                             device="meta")
        params, cache = S.param_specs_struct(c), S.cache_specs_struct(
            c, shape)
        with ByOp() as counter:
            St.make_decode_step(c)(params, cache, tokens,
                                   kv_len=shape.seq_len)
        print(json.dumps({{"rec": {{k: rec.get(k) for k in (
            "ok", "error", "flops_per_device", "n_devices",
            "collective_bytes")}}, "whole_total": counter.total,
            "mine": mine, "whole": whole, "head": head, "kv": [
                c.n_layers, shape.global_batch, shape.seq_len, c.n_kv,
                c.head_dim],
            "model_gathers": sum(g == groups["model"] for g in gathers),
            "gathers": len(gathers)}}))
    """
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=240,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dryrun_decode_cell_splits_the_flops_over_256_ranks(tmp_path):
    """olmo-1b ``decode_32k`` at depth 2 on the fake 16 x 16 mesh (in a
    subprocess: the fake group is process-global): the KV heads split,
    so nothing is gathered over ``model``, and the FLOPs split 256
    ways against the unsharded step's count of the cell (what
    ``exact_flops`` counts at full depth), op by op."""
    res = _dryrun_decode(tmp_path, "olmo-1b")
    rec, n = res["rec"], res["rec"]["n_devices"]
    assert rec["ok"], rec["error"]
    assert n == 256
    mine, whole = res["mine"], res["whole"]
    assert sum(mine.values()) == rec["flops_per_device"]
    assert sum(whole.values()) == res["whole_total"]
    # the unsharded step copies each layer's K and V once to attend
    # (``clone`` of the permuted 16-head cache, then ``_unsafe_view`` of
    # the copy, each charged 1 flop an element); a rank holding one KV
    # head permutes a size-1 dim, which copies nothing.  Those copies
    # aside, the matmuls and the rest each split 256 ways
    L, B, S, K, hd = res["kv"]
    copies = ("clone", "_unsafe_view")
    assert whole["clone"] == L * 2 * B * S * K * hd, whole["clone"]
    assert whole["_unsafe_view"] >= whole["clone"]
    assert sum(mine.get(k, 0) for k in copies) * n <= \
        0.01 * sum(whole[k] for k in copies)
    assert abs(mine["mm"] * n / whole["mm"] - 1) <= 0.1
    rest = [sum(v for k, v in counts.items() if k != "mm" and
                k not in copies) for counts in (mine, whole)]
    assert abs(rest[0] * n / rest[1] - 1) <= 0.1, rest
    # the params' gathers over data (FSDP's specs), none over model
    assert res["gathers"] > 0 and res["model_gathers"] == 0, res
    assert rec["collective_bytes"]["all-reduce"] > 0


def test_dryrun_moe_decode_cell_splits_the_flops_over_256_ranks(tmp_path):
    """moonshot-v1-16b-a3b ``decode_32k`` at depth 2 on the fake 16 x 16
    mesh: its 16 KV heads, ``d_ff_expert`` 1408 and vocab 163840 split
    on 16, so the rank's matmul FLOPs (the attention's, the dense mix of
    all 64 experts', the logits') x 256 are the unsharded step's within
    10%, and nothing is gathered over ``model``."""
    res = _dryrun_decode(tmp_path, "moonshot-v1-16b-a3b")
    rec, n = res["rec"], res["rec"]["n_devices"]
    assert rec["ok"], rec["error"]
    assert n == 256
    mine, whole = res["mine"], res["whole"]
    assert sum(mine.values()) == rec["flops_per_device"]
    mm = ("mm", "addmm", "bmm", "baddbmm")
    got, want = (sum(c.get(k, 0) for k in mm) for c in (mine, whole))
    assert whole["bmm"] > 0.5 * want     # the dense mix's expert products
    assert abs(got * n / want - 1) <= 0.1, (got * n, want)
    assert res["gathers"] > 0 and res["model_gathers"] == 0, res
    assert rec["collective_bytes"]["all-reduce"] > 0


def test_dryrun_ssm_decode_cell_splits_the_flops_over_256_ranks(tmp_path):
    """mamba2-1.3b ``decode_32k`` at depth 2 on the fake 16 x 16 mesh: its
    64 SSM heads split on 16, 4 a rank, whose z, x and dt with B and C
    whole are 772 of ``in_proj``'s 8512 columns, and ``out_proj``'s rows
    256 of 4096.  So the layers' matmul FLOPs (the logits excluded: the
    50280-wide vocab does not divide 16 and runs whole, as JAX's rules
    keep ``embed`` replicated) x 256 are the unsharded step's times 16 x
    (772 + 256) / (8512 + 4096) = 1.30, within 2% (the scan's
    ``einsum`` splits 256 ways); ``in_proj`` is gathered over ``model``
    each layer."""
    res = _dryrun_decode(tmp_path, "mamba2-1.3b")
    rec, n = res["rec"], res["rec"]["n_devices"]
    assert rec["ok"], rec["error"]
    assert n == 256
    cfg = configs.get_config("mamba2-1.3b")
    s, m = cfg.ssm, 16
    din, nh = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
    cols = 2 * din + 2 * s.n_groups * s.d_state + nh
    mine_cols = 2 * din // m + 2 * s.n_groups * s.d_state + nh // m
    want = m * (mine_cols + din // m) / (cols + din)
    assert mine_cols == 772 and abs(want - 1.3046) < 1e-4
    mine, whole, head = res["mine"], res["whole"], res["head"]
    mm = ("mm", "addmm", "bmm", "baddbmm")
    got, ref = (sum(c.get(k, 0) for k in mm) - head[key]
                for c, key in ((mine, "mine"), (whole, "whole")))
    assert head["mine"] * n == head["whole"] * m     # whole on each rank
    assert abs(got * n / ref / want - 1) <= 0.02, (got * n / ref, want)
    assert res["model_gathers"] > 0, res
    assert rec["collective_bytes"]["all-reduce"] > 0
