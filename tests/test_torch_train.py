"""LM training in the port: ``data/synthetic.py``, ``train/optimizer.py``,
the spiking FFN, ``transformer.loss_fn`` with QAT and remat,
``launch/steps.py``, ``train/trainer.py`` and ``launch/train.py``,
against ``repro`` on the CPU.

Params start as JAX's (``JT.init``) and cross with
``convert.lm_params_from_numpy``; the port's results come back with
``convert.lm_params_to_numpy``.  Smoke configs run in float32.
Tolerances, each with its reason:

* synthetic data: bit-equal (the same numpy Philox draws);
* the optimizer on given gradients: rtol 1e-6 (the same float32
  elementwise operations), with an atol of 1e-6 times the leaf's largest
  |value| on the params and moments: the global norm's sums run in
  another order (~1e-7), which moves the clip scale, and ``m``'s second
  step is a difference of two such terms where they cancel;
* losses: rtol 1e-5; gradients: rtol 1e-4 with an atol of 1e-4 times the
  leaf's largest |gradient| (XLA and PyTorch sum the products and the
  backward's reductions in other orders, ~1e-7 relative a sum, and a
  gradient element near 0 is a cancellation of such sums);
* the spiking FFN runs in float64 on both sides (JAX under
  ``jax.enable_x64``; nothing in ``repro`` changes), so that no membrane
  lands on the other side of the threshold through float32 rounding; the
  logits are float32 in both packages, so losses and gradients keep the
  tolerances above;
* JAX runs op by op (``jax.disable_jit()``) wherever QAT is on: under
  ``jit`` XLA rewrites fake-quant's ``absmax / qmax`` into a multiply by
  the rounded reciprocal (``qmax`` 7 and 127), which moves a scale by an
  ulp and, at some channels, sends the absmax weight past the clip bound
  (its gradient 0 where op by op it is 1/2).  The port follows JAX's
  op-by-op arithmetic, which ``test_torch_quant.py`` holds it to bit for
  bit; ``test_qat_against_jitted_repro_differs_only_at_the_clip_bound``
  pins the difference down;
* one train step: the new params, ``m``, ``v``, ``lr``, grad norm and
  loss at the gradients' tolerance;
* remat: the port's three modes give bit-equal losses and gradients on
  the CPU (the recompute runs the same kernels), each within the
  tolerances above of JAX's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs.base import SpikingConfig as JSpikingConfig
from repro.data import synthetic as jsyn
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant.formats import PrecisionConfig as JPC
from repro.train import optimizer as jopt
from repro_torch import configs, convert, obs
from repro_torch.configs.base import SpikingConfig
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.launch import train as train_launcher
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tree import leaves, unflatten_like

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
OPT_RTOL = 1e-6
DENSE_ARCHS = ("olmo-1b", "stablelm-1.6b", "internlm2-20b", "gemma2-2b")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _assert_tree_close(got, want, rtol, where="", atol_frac=None):
    """Walk two numpy trees of one structure; ``atol_frac`` sets each
    leaf's atol to that fraction of the leaf's largest |value|."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, f"{where}/{k}",
                               atol_frac)
        return
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, where
    atol = 0.0 if atol_frac is None or not want.size else \
        atol_frac * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=where)


def _models(arch, **changes):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               **changes)
    tchanges = dict(changes)
    for key, port_cls in (("precision", PrecisionConfig),
                          ("spiking", SpikingConfig)):
        if tchanges.get(key) is not None:
            tchanges[key] = port_cls(**dataclasses.asdict(changes[key]))
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **tchanges)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, cfg, jp, tp


def _batch(vocab, b, s, seed, masked=True):
    g = np.random.default_rng(seed)
    toks = g.integers(0, vocab, (b, s)).astype(np.int32)
    labels = g.integers(0, vocab, (b, s)).astype(np.int32)
    if masked:
        labels[0, :3] = -1
        labels[-1, -2:] = -1
    return toks, labels


def _port_value_and_grad(tp, cfg, toks, labels, **kw):
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss = T.loss_fn(tp, cfg, {"tokens": _t(toks).long(),
                               "labels": _t(labels).long()}, **kw)
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return loss.item(), unflatten_like(tp, list(grads))


def _jax_value_and_grad(jp, jcfg, toks, labels, **kw):
    """JAX's loss and gradients, op by op (see the module docstring)."""
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    with jax.disable_jit():
        loss, g = jax.value_and_grad(
            lambda p: JT.loss_fn(p, jcfg, batch, **kw))(jp)
    return float(loss), jax.tree.map(np.asarray, g)


def _check_loss_and_grads(jcfg, cfg, jp, tp, toks, labels, **kw):
    jl, jg = _jax_value_and_grad(jp, jcfg, toks, labels, **kw)
    tl, tg = _port_value_and_grad(tp, cfg, toks, labels, **kw)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_tree_close(convert.lm_params_to_numpy(tg), jg, GRAD_RTOL,
                       atol_frac=GRAD_RTOL)
    return tl, tg


# --- synthetic data ----------------------------------------------------------


def test_synthetic_is_bit_equal_to_repro():
    for seed, step, host in ((0, 0, 0), (7, 42, 0), (3, 5, 2)):
        got = synthetic.lm_batch(1000, 4, 16, seed=seed, step=step,
                                 host=host)
        want = jsyn.lm_batch(1000, 4, 16, seed=seed, step=step, host=host)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = synthetic.lm_iterator(50304, 2, 8, seed=1, start_step=3)
    jit_ = jsyn.lm_iterator(50304, 2, 8, seed=1, start_step=3)
    for _ in range(3):
        got, want = next(it), next(jit_)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["labels"], want["labels"])
    got = synthetic.make_vision_dataset(n_classes=4, img_size=8,
                                        n_train=16, n_test=8, seed=2)
    want = jsyn.make_vision_dataset(n_classes=4, img_size=8, n_train=16,
                                    n_test=8, seed=2)
    for g_part, w_part in zip(got, want):
        for g_arr, w_arr in zip(g_part, w_part):
            assert g_arr.dtype == w_arr.dtype
            np.testing.assert_array_equal(g_arr, w_arr)
    (x, y), _ = want
    vb = synthetic.vision_batches(x, y, 5, seed=3, start_step=1)
    jvb = jsyn.vision_batches(x, y, 5, seed=3, start_step=1)
    for _ in range(2):
        got, want = next(vb), next(jvb)
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["labels"], want["labels"])


# --- the optimizer -------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(10, 1000), (0, 50), (100, 100)])
def test_schedule_matches_repro(warmup, total):
    ocfg = opt.OptConfig(warmup_steps=warmup, total_steps=total)
    jcfg = jopt.OptConfig(warmup_steps=warmup, total_steps=total)
    for step in (0, 1, 5, warmup, warmup + 1, total // 2, total, total + 7):
        got = opt.schedule(ocfg, torch.tensor(step, dtype=torch.int32))
        want = jopt.schedule(jcfg, jnp.asarray(step, jnp.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=OPT_RTOL)


def _opt_tree(seed, gscale):
    g = np.random.default_rng(seed)
    p = {"w": g.standard_normal((8, 16)).astype(np.float32),
         "b": g.standard_normal((16,)).astype(np.float32),      # no decay
         "e": {"x": g.standard_normal((4, 8)).astype(np.float32)}}  # bf16
    grads = [{"w": g.standard_normal((8, 16)).astype(np.float32) * gscale,
              "b": g.standard_normal((16,)).astype(np.float32) * gscale,
              "e": {"x": g.standard_normal((4, 8)).astype(np.float32)
                    * gscale}} for _ in range(2)]
    return p, grads


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["e"]["x"] = out["e"]["x"].astype(jnp.bfloat16)
    return out


def _as_torch(tree):
    out = {"w": _t(tree["w"]).clone(), "b": _t(tree["b"]).clone(),
           "e": {"x": _t(tree["e"]["x"]).to(torch.bfloat16)}}
    return out


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(torch.float32).numpy()
    return np.asarray(tree.astype(jnp.float32))


@pytest.mark.parametrize("gscale", [0.01, 5.0], ids=["unclipped",
                                                     "clipped"])
def test_global_norm_and_update_match_repro(gscale):
    """Two AdamW steps (bias correction at steps 1 and 2) on a float32
    matrix, a 1-D leaf (no weight decay) and a bfloat16 leaf; gscale 5
    puts the global norm above clip_norm=1."""
    p_np, grads_np = _opt_tree(0, gscale)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = jopt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tp, jp = _as_torch(p_np), _as_jax(p_np)
    tstate, jstate = opt.init(tp), jopt.init(jp)
    for g_np in grads_np:
        tg, jg = _as_torch(g_np), _as_jax(g_np)
        np.testing.assert_allclose(opt.global_norm(tg).item(),
                                   float(jopt.global_norm(jg)),
                                   rtol=OPT_RTOL)
        tp2, tstate, tm = opt.update(tg, tstate, tp, ocfg)
        assert tp2 is tp
        jp, jstate, jm = jopt.update(jg, jstate, jp, jcfg)
        assert (float(jm["grad_norm"]) > 1.0) == (gscale > 1)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=OPT_RTOL)
        assert tp["e"]["x"].dtype == torch.bfloat16
        assert int(tstate["step"]) == int(jstate["step"])
        _assert_tree_close(_np_tree(tp), _np_tree(jp), OPT_RTOL,
                           "params", OPT_RTOL)
        for k in ("m", "v"):
            _assert_tree_close(_np_tree(tstate[k]), _np_tree(jstate[k]),
                               OPT_RTOL, k, OPT_RTOL)


# --- loss_fn -------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_repro(arch):
    """Masked labels (-1) and S=20 at ce_chunk=6, which JAX's rule cuts
    into 2 chunks of 10 (3 does not divide 20); gemma2's window of 16
    binds at S=20."""
    jcfg, cfg, jp, tp = _models(arch)
    toks, labels = _batch(cfg.vocab, 2, 20, seed=1)
    _check_loss_and_grads(jcfg, cfg, jp, tp, toks, labels, ce_chunk=6)


def test_loss_masks_labels_and_chunks_like_repro():
    """The loss is the mean over unmasked labels, whatever the chunking:
    one chunk, the uneven rule and all masked (JAX's max(cnt, 1))."""
    jcfg, cfg, jp, tp = _models("olmo-1b")
    toks, labels = _batch(cfg.vocab, 2, 20, seed=2)
    batch = {"tokens": _t(toks).long(), "labels": _t(labels).long()}
    with torch.no_grad():
        one = T.loss_fn(tp, cfg, batch).item()
        for chunk in (6, 4, 1):
            np.testing.assert_allclose(
                T.loss_fn(tp, cfg, batch, ce_chunk=chunk).item(), one,
                rtol=LOSS_RTOL)
        batch["labels"] = torch.full_like(batch["labels"], -1)
        dead = T.loss_fn(tp, cfg, batch).item()
    jdead = JT.loss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.full(labels.shape, -1)})
    assert dead == float(jdead) == 0.0


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qat_loss_and_grads_match_repro(bits):
    """QAT fake-quant (one scale per output channel): the same codes in
    both packages, and the STE's gradient (1/2 exactly at a clip bound,
    which each channel's absmax weight sits on at the positive end)."""
    jcfg, cfg, jp, tp = _models("olmo-1b", precision=JPC(bits=bits,
                                                          group_size=-1))
    toks, labels = _batch(cfg.vocab, 2, 16, seed=bits)
    _check_loss_and_grads(jcfg, cfg, jp, tp, toks, labels)


def test_qat_against_jitted_repro_differs_only_at_the_clip_bound():
    """Under ``jax.jit`` the scale is ``absmax * f32(1/qmax)``, an ulp off
    ``absmax / qmax`` at some channels; there the absmax weight's
    ``w / scale`` lands just above, on or just below qmax in one package
    and elsewhere in the other (STE gradient 0, 1/2 or 1).  No other
    gradient element differs, and at 2 bits (qmax 1, an exact
    reciprocal) none does; op by op the two are bit-equal."""
    from repro.quant.qat import fake_quant as jfake_quant

    from repro_torch.quant.qat import fake_quant

    w = (np.random.default_rng(0).standard_normal((64, 128)) * 0.18
         ).astype(np.float32)
    for bits in (2, 4, 8):
        jpc, pc = JPC(bits=bits, group_size=-1), PrecisionConfig(bits=bits)

        def jf(w):
            return jnp.sum(jfake_quant(w.T, jpc).T)

        jg = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(w)))
        with jax.disable_jit():
            jg_eager = np.asarray(jax.grad(jf)(jnp.asarray(w)))
        tw = _t(w).requires_grad_(True)
        tg = torch.autograd.grad(torch.sum(fake_quant(tw.T, pc).T),
                                 [tw])[0].numpy()
        np.testing.assert_array_equal(tg, jg_eager)
        diff = tg != jg
        at_max = np.abs(w) == np.abs(w).max(axis=0, keepdims=True)
        assert not np.any(diff & ~at_max)
        assert set(tg[diff]) | set(jg[diff]) <= {0.0, 0.5, 1.0}
        assert diff.any() == (bits != 2)


def test_qat_grouped_loss_and_grads_match_repro():
    jcfg, cfg, jp, tp = _models("stablelm-1.6b",
                                precision=JPC(bits=4, group_size=32))
    toks, labels = _batch(cfg.vocab, 2, 16, seed=9)
    _check_loss_and_grads(jcfg, cfg, jp, tp, toks, labels)


# --- the spiking FFN -------------------------------------------------------------


def test_spiking_ffn_apply_matches_repro():
    """Forward and gradients (wi, wo, x) of one spiking FFN in float64;
    a GLU's wg gets no gradient in either."""
    g = np.random.default_rng(0)
    p_np = {n: {"w": g.standard_normal(s) * 0.3} for n, s in
            (("wi", (16, 48)), ("wg", (16, 48)), ("wo", (48, 16)))}
    x_np = g.standard_normal((2, 5, 16))
    kw = dict(timesteps=4, leak_shift=3, threshold=1.0)
    with jax.enable_x64(True):
        def jf(p, x):
            return jnp.sum(JL.spiking_ffn_apply(p, x, "silu", **kw) ** 2)

        jp = jax.tree.map(jnp.asarray, p_np)
        jy = np.asarray(JL.spiking_ffn_apply(jp, jnp.asarray(x_np), "silu",
                                             **kw))
        jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x_np))
        jgp = jax.tree.map(np.asarray, jgp)
    tp = {n: {"w": _t(v["w"]).requires_grad_(True)}
          for n, v in p_np.items()}
    tx = _t(x_np).requires_grad_(True)
    ty = L.spiking_ffn_apply(tp, tx, "silu", **kw)
    assert ty.dtype == torch.float64
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=1e-12,
                               atol=1e-12)
    gs = torch.autograd.grad(torch.sum(ty ** 2),
                             [tp["wi"]["w"], tp["wo"]["w"], tx])
    for got, want in zip(gs, (jgp["wi"]["w"], jgp["wo"]["w"], jgx)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-10, atol=1e-12)
    assert not np.any(jgp["wg"]["w"])
    rate = (ty.detach().numpy() != 0).mean()
    assert 0.2 < rate            # the output is not all zeros


@pytest.mark.parametrize("arch", ["olmo-1b", "stablelm-1.6b"])
def test_spiking_ffn_loss_and_grads_match_repro(arch):
    """The whole model with ``SpikingConfig()`` in float64 (logits in
    float32 in both packages)."""
    with jax.enable_x64(True):
        jcfg, cfg, jp, tp = _models(arch, dtype="float64",
                                    spiking=JSpikingConfig())
        toks, labels = _batch(cfg.vocab, 2, 16, seed=5)
        tl, tg = _check_loss_and_grads(jcfg, cfg, jp, tp, toks, labels)
    assert tp["embed"].dtype == torch.float64
    assert not torch.any(tg["layers"][0]["mlp"]["wg"]["w"])
    assert torch.any(tg["layers"][0]["mlp"]["wi"]["w"] != 0)


# --- remat -------------------------------------------------------------------


def test_remat_modes_match_repro():
    """Each of none / dots / full against JAX's same mode, and the port's
    three modes bit-equal to each other."""
    toks, labels = _batch(256, 2, 16, seed=7)
    got = {}
    for remat in ("none", "dots", "full"):
        jcfg, cfg, jp, tp = _models("gemma2-2b", remat=remat,
                                    precision=JPC(bits=4, group_size=-1))
        got[remat] = _check_loss_and_grads(jcfg, cfg, jp, tp, toks, labels)
    for remat in ("dots", "full"):
        assert got[remat][0] == got["none"][0]
        for a, b in zip(leaves(got[remat][1]), leaves(got["none"][1])):
            assert torch.equal(a, b), remat


def test_remat_dots_keeps_matmuls_and_full_recomputes_them():
    """What each mode recomputes in the backward pass, counted by a
    dispatch mode around ``autograd.grad`` (an op whose output selective
    checkpointing kept never reaches it): "none" recomputes nothing,
    "dots" the layers' elementwise ops (silu) but no matmul, "full"
    both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] = self.ops.get(func, 0) + 1
            return func(*args, **(kwargs or {}))

    aten = torch.ops.aten
    toks, labels = _batch(256, 2, 16, seed=8)
    counts = {}
    for remat in ("none", "dots", "full"):
        _, cfg, _, tp = _models("olmo-1b", remat=remat)
        flat = leaves(tp)
        for p in flat:
            p.requires_grad_(True)
        loss = T.loss_fn(tp, cfg, {"tokens": _t(toks).long(),
                                   "labels": _t(labels).long()})
        with Count() as c:
            torch.autograd.grad(loss, flat)
        counts[remat] = (c.ops.get(aten.mm.default, 0),
                         c.ops.get(aten.silu.default, 0))
    assert counts["none"][1] == 0
    assert counts["dots"][0] == counts["none"][0]
    assert counts["dots"][1] == counts["full"][1] > 0
    assert counts["full"][0] > counts["none"][0]


# --- one train step ------------------------------------------------------------


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_repro(grad_accum):
    jcfg, cfg, jp, tp = _models("olmo-1b",
                                precision=JPC(bits=4, group_size=-1))
    toks, labels = _batch(cfg.vocab, 4, 16, seed=11)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jocfg = jopt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jstep = jmake_train_step(jcfg, jocfg, grad_accum)
    tstep = steps.make_train_step(cfg, ocfg, grad_accum)
    jstate, tstate = jopt.init(jp), opt.init(tp)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": _t(toks).long(), "labels": _t(labels).long()}
    for _ in range(2):
        with jax.disable_jit():
            jp, jstate, jm = jstep(jp, jstate, jb)
        tp, tstate, tm = tstep(tp, tstate, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       rtol=GRAD_RTOL, err_msg=k)
        assert int(tstate["step"]) == int(jstate["step"])
        _assert_tree_close(convert.lm_params_to_numpy(tp),
                           jax.tree.map(np.asarray, jp), GRAD_RTOL,
                           "params", GRAD_RTOL)
        for k in ("m", "v"):
            _assert_tree_close(convert.lm_params_to_numpy(tstate[k]),
                               jax.tree.map(np.asarray, jstate[k]),
                               GRAD_RTOL, k, GRAD_RTOL)


def test_prefill_and_decode_steps_are_the_models():
    _, cfg, _, tp = _models("olmo-1b")
    toks = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator()
                         .manual_seed(0))
    mb = api.get_model(cfg)
    with torch.no_grad():
        logits, cache = steps.make_prefill_step(cfg)(tp, {"tokens": toks})
        want, _ = mb.prefill(tp, {"tokens": toks})
        assert torch.equal(logits, want)
        cache = {k: v if k == "len" else torch.nn.functional.pad(
            v, (0, 0) * (v.ndim - 3) + (0, 2)) for k, v in cache.items()}
        out, cache = steps.make_decode_step(cfg)(tp, cache, toks[:, :1])
    assert out.shape == (2, cfg.vocab) and int(cache["len"][0]) == 7


def test_lm_params_to_numpy_inverts_from_numpy():
    jp = JT.init(jax.random.PRNGKey(3), jconfigs.get_config("gemma2-2b",
                                                            smoke=True))
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = convert.lm_params_to_numpy(
        convert.lm_params_from_numpy(jnp_tree, device="cpu"))
    _assert_tree_close(back, jnp_tree, 0.0)
    bf = {"embed": torch.ones(2, 3, dtype=torch.bfloat16),
          "layers": [{"w": torch.full((2,), 1.5, dtype=torch.bfloat16)}] * 3}
    out = convert.lm_params_to_numpy(bf)
    assert out["layers"]["w"].shape == (3, 2)
    assert out["layers"]["w"].dtype == np.float32


# --- the trainer -----------------------------------------------------------------


def _tcfg(d, steps_=6, **kw):
    return TrainConfig(steps=steps_, batch=2, seq=16, ckpt_dir=str(d),
                       ckpt_every=4, log_every=100, async_ckpt=False,
                       opt=opt.OptConfig(warmup_steps=2, total_steps=12),
                       **kw)


def test_trainer_tracks_the_repro_trainer(tmp_path, monkeypatch):
    """The port's Trainer and JAX's, from JAX's initial params, over 6
    steps: the same losses, lrs and grad norms reach the hooks, the same
    instruments fill, and the same checkpoints are written."""
    from repro import obs as jobs
    from repro.train import trainer as jtrainer

    cfg_j = jconfigs.get_config("olmo-1b", smoke=True)
    cfg_t = configs.get_config("olmo-1b", smoke=True)
    jrec, trec = [], []
    jreg, treg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    jt = jtrainer.Trainer(cfg_j, jtrainer.TrainConfig(
        steps=6, batch=2, seq=16, ckpt_dir=str(tmp_path / "j"), ckpt_every=4,
        log_every=100, async_ckpt=False,
        opt=jopt.OptConfig(warmup_steps=2, total_steps=12)),
        log=lambda *_: None, hooks=[jrec.append], registry=jreg)
    jout = jt.run()
    jp0 = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), cfg_j))

    def init_state(self, seed=0):
        params = convert.lm_params_from_numpy(jp0, device="cpu")
        return params, opt.init(params), 0

    monkeypatch.setattr(Trainer, "init_state", init_state)
    tt = Trainer(cfg_t, _tcfg(tmp_path / "t"), log=lambda *_: None,
                 hooks=[trec.append], registry=treg, device="cpu")
    tout = tt.run()
    np.testing.assert_allclose(tout["losses"], jout["losses"],
                               rtol=GRAD_RTOL)
    for got, want in zip(trec, jrec):
        assert set(got) == set(want) and got["step"] == want["step"]
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL)
    assert {m.name for m in treg.metrics()} == \
        {m.name for m in jreg.metrics()}
    assert treg.find("train_steps_total").value == 6
    assert [(s["event"], s["step"]) for s in treg.spans()] == \
        [(s["event"], s["step"]) for s in jreg.spans()]
    assert tt.ckpt.all_steps() == jt.ckpt.all_steps() == [4, 6]
    jman = json.loads((tmp_path / "j" / "step_6" / "MANIFEST.json")
                      .read_text())["leaves"]
    tman = json.loads((tmp_path / "t" / "step_6" / "MANIFEST.json")
                      .read_text())["leaves"]
    # JAX stacks the layers; the port keys each layer's leaf by its index
    want = {k.replace("layers__", "layers__0__") for k in jman}
    assert {k for k in tman if "layers__1__" not in k} == want


def test_trainer_refuses_a_mesh(tmp_path):
    """``Trainer(mesh=)`` no longer refuses: as JAX's, it builds
    ``_pshard`` (the param shardings of the meta-device param tree under
    the sharding rules) and, as JAX's, does not place the params with
    it."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_abstract_mesh

    cfg = configs.get_config("olmo-1b", smoke=True)
    mesh = make_abstract_mesh((4, 2), ("data", "model"))
    tr = Trainer(cfg, _tcfg(tmp_path), mesh=mesh, device="cpu")
    want = shd.param_specs(S.param_specs_struct(cfg), mesh)
    got = leaves(tr._pshard)
    assert [s.spec for s in got] == [s.spec for s in leaves(
        shd.to_shardings(want, mesh))]
    assert all(s.mesh is mesh for s in got)
    assert len(got) == len(leaves(api.get_model(cfg).init(0, device="cpu")))
    assert got[0].spec == ("model", None)           # the embedding
    assert got[0].placements == (Replicate(), Shard(0))
    params, _, _ = tr.init_state(0)
    assert all(type(p) is torch.Tensor for p in leaves(params))


def test_train_launcher_smoke_and_resume(tmp_path, capsys):
    """``--smoke --steps 3 --device cpu`` trains, checkpoints and writes
    valid metrics; ``--steps 5 --resume`` restarts from that checkpoint
    and runs steps 3 and 4 only."""
    from repro_torch.obs import validate

    ck, metrics = tmp_path / "ck", tmp_path / "train.jsonl"
    try:
        out = train_launcher.main([
            "--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(ck),
            "--metrics", str(metrics), "--quant-bits", "4",
            "--spiking-ffn"])
        assert len(out["losses"]) == 3
        assert np.all(np.isfinite(out["losses"]))
        assert sorted(p.name for p in ck.iterdir()) == ["step_3"]
        assert validate.main([str(metrics)]) == 0
        text = capsys.readouterr().out
        assert "first loss" in text and "final loss" in text
        out = train_launcher.main([
            "--arch", "olmo-1b", "--smoke", "--steps", "5", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", str(ck),
            "--resume", "--quant-bits", "4", "--spiking-ffn"])
        assert len(out["losses"]) == 2
        assert "restored checkpoint step=3" in capsys.readouterr().out
    finally:
        obs.disable_default()
