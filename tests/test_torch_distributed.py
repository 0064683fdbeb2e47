"""The port's distributed layer on several ranks, on the CPU over gloo.

Each multi-rank case runs its ranks as processes of
``tests/_torch_dist_ranks.py`` (``python`` subprocesses joined through a
``file://`` store under ``tmp_path``: no port, so xdist workers cannot
collide), each spawn and join under its own timeout.  JAX's sharded
functions run in a subprocess with
``--xla_force_host_platform_device_count``, as ``test_distributed.py``
runs them; JAX's unsharded functions run here.  Tolerances, each with
its reason:

* EF-int8, 8 ranks, against JAX's jitted ``shard_map``: the first-stage
  codes and the error buffer bit-equal (the port does XLA's arithmetic:
  a multiply by float32 ``1/127``, fused multiply-adds); the output
  bit-equal to the port's plain version (the same arithmetic with the
  collectives taken out), within one int8 step of its chunk's scale of
  JAX's everywhere and bit-equal to it at >= 99.9% of elements (a sum
  over peers that rounds the other way moves a re-quantized code by
  one);
* GPipe, 2 stages x 4 data: the loss within 1e-5 relative of JAX's
  ``loss_fn``, each stage's layer gradients within rtol 1e-4 (atol 1e-4
  of the leaf's largest) of the port's unsharded ones, as
  ``test_torch_train.py`` holds gradients;
* the sharded olmo step, 4 x 2 mesh, 2 steps: losses within rtol 1e-5
  of the port's unsharded step; params within rtol 1e-5 and an atol of
  1e-6 of the leaf's largest |value| at >= 99.99% of each leaf's
  elements, and everywhere within an atol of 1e-5 of it.  The gradient
  is reduce-scattered over 4 ranks, another summation order (~1e-7
  relative), and AdamW's second step divides ``m`` by ``sqrt(v)``: where
  a weight's two gradients nearly cancel, that ratio moves (one element
  of olmo smoke's ``mlp/wo/w``).  Against JAX's unsharded step: ``test_torch_train.py``'s step
  tolerance (rtol 1e-4, atol 1e-4 of the leaf's largest);
* elastic restore, data-parallel serving: bit-equal;
* attention CP: the loss within 1e-5 relative of JAX's plain loss.
"""

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import ArchConfig as JArchConfig
from repro.deploy.engine import SNNEngineConfig as JSNNEngineConfig
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.api import get_model
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, unflatten_like

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RANKS = str(ROOT / "tests" / "_torch_dist_ranks.py")


def run_ranks(case, world, d: Path, inputs, timeout=120):
    """Run ``case`` on ``world`` gloo ranks; returns each rank's output."""
    d.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, d / "inputs.pt")
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, RANKS, case, str(r),
                               str(world), str(d)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            errs.append(err)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: ranks still running after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, e[-3000:]) for r, (p, e) in enumerate(zip(procs, errs))
           if p.returncode]
    assert not bad, bad[0]
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def run_jax(code: str, devices: int, timeout=180) -> None:
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]


# --- EF-int8 gradient all-reduce ------------------------------------------------


def test_ef_int8_allreduce_matches_jax_shard_map(tmp_path):
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 1024)).astype(np.float32)
    err = (0.01 * rng.standard_normal((8, 1024))).astype(np.float32)
    np.savez(tmp_path / "in.npz", g=g, err=err)
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.distributed.compression import (
            _quant_int8, ef_int8_allreduce_mean)

        d = np.load({str(tmp_path / "in.npz")!r})
        mesh = jax.make_mesh((8,), ("data",))

        def one(gi, ei):
            out, ne = ef_int8_allreduce_mean(gi[0], ei[0], "data")
            x = gi[0] + ei[0]
            q, _ = _quant_int8(x.reshape(8, -1))
            return out[None], ne[None], q[None]

        f = jax.jit(shard_map(one, mesh=mesh, in_specs=(P("data"), P("data")),
                              out_specs=(P("data"),) * 3, check_rep=False))
        out, ne, q = f(jnp.asarray(d["g"]), jnp.asarray(d["err"]))
        np.savez({str(tmp_path / "jax.npz")!r}, out=np.asarray(out),
                 new_err=np.asarray(ne), codes=np.asarray(q))
    """, devices=8)
    want = np.load(tmp_path / "jax.npz")
    tree_g = [{"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(
        np.float32)), "b": [torch.from_numpy(rng.standard_normal(
            (7,)).astype(np.float32))]} for _ in range(8)]
    tree_e = [{"a": torch.zeros(3, 5), "b": [torch.zeros(7)]}
              for _ in range(8)]
    got = run_ranks("ef", 8, tmp_path / "ranks", {
        "g": torch.from_numpy(g), "err": torch.from_numpy(err),
        "tree_g": tree_g, "tree_e": tree_e})
    from repro_torch.distributed import compression as C

    plain_out, plain_err = C.ef_int8_plain(
        [torch.from_numpy(x) for x in g], [torch.from_numpy(x) for x in err])
    tplain_g, tplain_e = C.tree_ef_plain(tree_g, tree_e)
    for r, o in enumerate(got):
        np.testing.assert_array_equal(o["codes"].numpy(), want["codes"][r])
        np.testing.assert_array_equal(o["new_err"].numpy(),
                                      want["new_err"][r])
        np.testing.assert_array_equal(o["out"].numpy(), plain_out[r].numpy())
        np.testing.assert_array_equal(o["new_err"].numpy(),
                                      plain_err[r].numpy())
        for a, b in zip(leaves(o["tree_out"]) + leaves(o["tree_err"]),
                        leaves(tplain_g[r]) + leaves(tplain_e[r])):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        # within one step of the chunk's scale of JAX's output
        jo = want["out"][r].reshape(8, -1)
        step = np.abs(jo).max(axis=1, keepdims=True) / 127.0
        assert np.all(np.abs(o["out"].numpy().reshape(8, -1) - jo)
                      <= step * (1 + 1e-6))
        assert np.mean(o["out"].numpy() == want["out"][r]) >= 0.999
    # and it is a mean: within the wire error of the true one
    assert np.abs(plain_out[0].numpy() - g.mean(0)).max() < 0.15


# --- GPipe --------------------------------------------------------------------


def _pp_cfgs():
    kw = dict(name="pp-test", family="dense", n_layers=4, d_model=32,
              n_heads=4, n_kv=4, d_ff=64, vocab=128, norm="rmsnorm",
              dtype="float32")
    return JArchConfig(**kw), ArchConfig(**kw)


def test_gpipe_two_stages_by_four_data(tmp_path):
    jcfg, cfg = _pp_cfgs()
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                         128)).astype(np.int32)
    labels = toks.copy()
    labels[0, :3] = -1                  # masked labels count too
    want = float(JT.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                       "labels": jnp.asarray(labels)}))
    npp = jax.tree.map(np.asarray, jp)
    got = run_ranks("pipe", 8, tmp_path, {
        "cfg": cfg, "params": npp,
        "batch": {"tokens": toks, "labels": labels}})
    # the port's unsharded gradients
    tp = convert.lm_params_from_numpy(npp, device="cpu")
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    ref = T.loss_fn(tp, cfg, tb)
    gref = convert.lm_params_to_numpy(unflatten_like(
        tp, list(torch.autograd.grad(ref, flat))))
    for r, o in enumerate(got):
        assert o["stage"] == r // 4
        np.testing.assert_allclose(o["loss"], want, rtol=1e-5)
        np.testing.assert_allclose(o["loss_rep"], want, rtol=1e-5)
        lo, hi = o["layers"]
        assert (lo, hi) == (2 * o["stage"], 2 * o["stage"] + 2)
        # the stage holds gradients of its own two layers only
        for name, g in _flat_np(o["grads"]["layers"]):
            assert g.shape[0] == 2
            w = _get(gref["layers"], name)[lo:hi]
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=name)
        np.testing.assert_allclose(o["grads"]["embed"], gref["embed"],
                                   rtol=1e-4,
                                   atol=1e-4 * np.abs(gref["embed"]).max())


def _flat_np(tree, path=""):
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat_np(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


# --- the sharded train step ---------------------------------------------------


def test_sharded_olmo_step_on_a_four_by_two_mesh(tmp_path):
    jcfg = jconfigs.get_config("olmo-1b", smoke=True)
    cfg = configs.get_config("olmo-1b", smoke=True)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    g = np.random.default_rng(3)
    toks = g.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels = g.integers(0, cfg.vocab, (8, 32)).astype(np.int32)
    labels[0, :5] = -1
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    got = run_ranks("step", 8, tmp_path, {
        "cfg": cfg, "params": npp, "opt": ocfg,
        "batch": {"tokens": toks, "labels": labels}})
    # the port's unsharded step and JAX's, from the same params
    tp = convert.lm_params_from_numpy(npp, device="cpu")
    tstate = opt.init(tp)
    tstep = steps.make_train_step(cfg, ocfg)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    jstep = jax.jit(jmake_train_step(jcfg, jopt.OptConfig(
        lr=1e-3, warmup_steps=2, total_steps=20)))
    jstate = jopt.init(jp)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tl, jl = [], []
    for _ in range(2):
        tp, tstate, tm = tstep(tp, tstate, tb)
        jp, jstate, jm = jstep(jp, jstate, jb)
        tl.append(tm["loss"].item())
        jl.append(float(jm["loss"]))
    want_t = convert.lm_params_to_numpy(tp)
    want_j = jax.tree.map(np.asarray, jp)
    for o in got:
        np.testing.assert_allclose(o["losses"], tl, rtol=1e-5)
        np.testing.assert_allclose(o["losses"], jl, rtol=1e-4)
        assert all(o["moments"])
    # params stay sharded: some leaf holds a quarter or an eighth of itself
    assert any(any("Shard" in repr(p) for p in pl) for pl, _ in
               got[0]["placed"])
    for (name, a) in _flat_np(got[0]["params"]):
        w = _get(want_t, name)
        big = np.abs(w).max()
        strict = np.abs(a - w) <= 1e-5 * np.abs(w) + 1e-6 * big
        assert strict.mean() >= 0.9999, (name, strict.mean())
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-5 * big,
                                   err_msg=name)
        w = _get(want_j, name)
        np.testing.assert_allclose(a, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


# --- elastic restore ----------------------------------------------------------


def test_elastic_restore_from_four_by_two_onto_two_by_four(tmp_path):
    tree = {"w": torch.arange(64.0).reshape(8, 8),
            "b": torch.arange(8, dtype=torch.float32).to(torch.bfloat16),
            "h": torch.arange(96, dtype=torch.int32).reshape(12, 8)}
    got = run_ranks("restore", 8, tmp_path / "ranks",
                    {"tree": tree, "dir": str(tmp_path)})
    for o in got:
        for k, v in tree.items():
            assert o["full"][k].dtype == v.dtype
            np.testing.assert_array_equal(o["full"][k].float().numpy(),
                                          v.float().numpy())
            have, asked = o["placements"][k]
            assert have == asked
        assert o["local"] == {"w": (4, 2), "b": (2,), "h": (12, 4)}
        # distribute() moves the mesh-a tree onto mesh b the same way
        assert o["moved_ok"]
        # the production meshes need 256 / 512 ranks, as jax.make_mesh
        # needs 256 / 512 devices
        assert len(o["refused"]) == 2
        assert "(16, 16) mesh needs 256 ranks" in o["refused"][0]
        assert "(2, 16, 16) mesh needs 512 ranks" in o["refused"][1]
    # the mesh save wrote the files a single-device save writes
    mesh, single = tmp_path / "mesh" / "step_1", tmp_path / "single" / "step_1"
    for k in tree:
        assert (mesh / f"{k}.npy").read_bytes() == \
            (single / f"{k}.npy").read_bytes()


# --- data-parallel serving ------------------------------------------------------


@pytest.fixture(scope="module")
def snn_model():
    from repro_torch.deploy import deploy, deploy_config
    from repro_torch.models import snn_cnn

    cfg = deploy_config("vgg9", 4, smoke=True)
    return deploy(snn_cnn.init(0, cfg, device="cpu"), cfg, device="cpu")


def test_data_parallel_engine_on_four_forced_replicas(snn_model, monkeypatch):
    from repro_torch.deploy import engine as E

    cfg = snn_model.cfg
    g = np.random.default_rng(5)
    images = g.random((11, cfg.img_size, cfg.img_size, cfg.in_channels),
                      dtype=np.float32)

    def serve(dp):
        eng = E.SNNServeEngine(snn_model, E.SNNEngineConfig(
            max_batch=8, data_parallel=dp), device="cpu")
        for uid, img in enumerate(images):
            eng.add_request(E.SNNRequest(uid=uid, image=img))
        eng.run_until_done()
        return eng, np.stack([eng.pop_result(u).logits
                              for u in range(len(images))])

    _, plain = serve(False)
    monkeypatch.setattr(E, "local_devices",
                        lambda dev: [torch.device("cpu")] * 4)
    eng, dp = serve(True)
    assert len(eng._replicas) == 4 and eng.buckets == (4, 8)
    np.testing.assert_array_equal(dp, plain)
    for n in range(1, 9):
        assert E.SNNEngineConfig().resolved_buckets(n) == \
            JSNNEngineConfig().resolved_buckets(n)


def test_serve_snn_data_parallel_flag(monkeypatch):
    """``serve_snn --data-parallel``: on the CPU (one device) it serves as
    without the flag; with 2 forced replicas 5 requests at max batch 4
    pad to the device-multiple buckets (4, then 2 for the last one)."""
    from repro_torch.deploy import engine as E
    from repro_torch.launch import serve_snn

    argv = ["--device", "cpu", "--requests", "5", "--max-batch", "4"]
    plain = serve_snn.main(argv)
    one = serve_snn.main(argv + ["--data-parallel"])
    assert one["buckets"] == plain["buckets"] == {"1": 1, "4": 1}
    monkeypatch.setattr(E, "local_devices",
                        lambda dev: [torch.device("cpu")] * 2)
    two = serve_snn.main(argv + ["--data-parallel"])
    assert two["requests"] == 5 and two["buckets"] == {"2": 1, "4": 1}


# --- context-parallel attention hint -------------------------------------------


def test_attention_cp_hint_across_eight_ranks(tmp_path):
    """JAX's test's hint on its (data=2, model=4) mesh, hymba smoke: each
    rank lays the chunked queries out ``Shard(0)`` x ``Shard(1)`` (B=4
    over data, the 4 query chunks over model), holds its (2, 1, ...)
    block and gathers them back; the loss is JAX's plain loss.  (One
    rank's hint, and its removal: ``test_torch_lm.py``.)"""
    jcfg = jconfigs.get_config("hymba-1.5b", smoke=True)
    cfg = configs.get_config("hymba-1.5b", smoke=True)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0, jcfg.vocab)
    want = float(JT.loss_fn(jp, jcfg, {"tokens": toks, "labels": toks}))
    got = run_ranks("cp", 8, tmp_path, {
        "cfg": cfg, "params": jax.tree.map(np.asarray, jp),
        "tokens": np.array(toks)})
    K, G = cfg.n_kv, cfg.n_heads // cfg.n_kv
    for o in got:
        np.testing.assert_allclose(o["loss"], want, rtol=1e-5)
        assert o["seen"] == [(4, 4, 16, K, G, cfg.head_dim),
                             (2, 1, 16, K, G, cfg.head_dim)] * cfg.n_layers


# --- the sharded serve steps -------------------------------------------------


def test_sharded_serve_steps_on_a_four_by_two_mesh(tmp_path):
    """``make_prefill_step`` / ``make_decode_step`` on params, batch, cache
    and tokens placed on a (4, 2) mesh (olmo, hymba with its SSM state,
    whisper with its 0-d length; B=8, heads split over ``model``) against
    the unsharded steps from the same params: a prefill, then 2 decode
    steps given the whole cache's length from the host (the unsharded
    ones read it).  Logits and every cache entry within 1e-5 of the
    output's largest |value| (the rank computes its rows with its own
    matmul shapes), placed as ``logits_spec`` and ``cache_specs`` say."""
    g = np.random.default_rng(4)
    cfgs, batch, steps_ = {}, {}, {}
    for arch in ("olmo-1b", "hymba-1.5b", "whisper-base"):
        cfg = configs.get_config(arch, smoke=True)
        cfgs[arch] = cfg
        b = {"tokens": g.integers(0, cfg.vocab, (8, 32)).astype(np.int64)}
        if cfg.family == "audio":
            b["frames"] = g.standard_normal((8, 48, cfg.d_model)).astype(
                np.float32)
        batch[arch] = b
        steps_[arch] = [g.integers(0, cfg.vocab, (8, 1)).astype(np.int64)
                        for _ in range(2)]
    got = run_ranks("serve", 8, tmp_path, {"cfgs": cfgs, "batch": batch,
                                           "steps": steps_}, timeout=180)
    for o in got:
        assert set(o) == set(cfgs)
        for arch, res in o.items():
            assert set(res) == {"prefill", "decode0", "decode1"}
            for step, entries in res.items():
                assert "logits" in entries and "len" in entries
                for key, (err, placed, want) in entries.items():
                    assert err <= 1e-5, (arch, step, key, err)
                    assert placed == tuple(want), (arch, step, key, placed)
    # the heads of olmo's K/V cache are split over model
    assert "Shard(dim=3)" in repr(got[0]["olmo-1b"]["decode1"]["k"][1])


@pytest.mark.parametrize("arch", ["olmo-1b", "whisper-base"])
def test_decode_given_the_length_equals_one_that_reads_it(arch):
    """``decode_step(kv_len=)``: the longest length after the step, given
    from the host, in place of the read of ``max(len) + 1`` (the dry run
    gives it on fake tensors, which cannot be read).  The same value the
    step reads gives bit-equal logits and cache; the whole cache's
    length (what the dry run gives) within rtol 1e-5 (the attention's
    sums run over the masked tail too, and a later layer's K/V follows
    the earlier layer's output).  A length past the cache raises."""
    cfg = configs.get_config(arch, smoke=True)
    step = steps.make_decode_step(cfg)
    prefill = steps.make_prefill_step(cfg)
    params = get_model(cfg).init(0, device="cpu")
    g = np.random.default_rng(5)
    b = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab, (3, 12)))}
    if cfg.family == "audio":
        b["frames"] = torch.from_numpy(
            g.standard_normal((3, 20, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        _, cache = prefill(params, b)
    cache = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
                 if k in ("k", "v") else v) for k, v in cache.items()}
    toks = torch.from_numpy(g.integers(0, cfg.vocab, (3, 1)))
    outs = []
    for kv_len in (None, 13, 16):
        c = {k: v.clone() for k, v in cache.items()}
        with torch.no_grad():
            logits, c = step(params, c, toks, kv_len=kv_len)
        outs.append((logits, c))
    (l0, c0), (l1, c1), (l2, c2) = outs
    assert torch.equal(l0, l1)
    assert all(torch.equal(c0[k], c1[k]) for k in c0)
    torch.testing.assert_close(l2, l0, rtol=1e-5, atol=1e-6)
    for k in c0:
        torch.testing.assert_close(c2[k], c0[k], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        step(params, {k: v.clone() for k, v in cache.items()}, toks,
             kv_len=17)
