"""The port's MoE block (``models/moe.py``) against ``repro.models.moe``
on the CPU.

Params come from ``repro``'s ``moe_init`` (seed 0) and cross as numpy;
inputs come from numpy seeds.  The smoke configs of granite-moe (8
experts, top-2, GLU) run in float32.  Tolerances, each with its reason:

* router indices and the kept mask of the dispatch: equal (the same
  float32 probabilities up to ~1e-7; on an exact tie both put the lower
  expert index first, which ``torch.topk`` does not);
* gates, the aux loss and every block output: rtol 1e-4 / atol 1e-5
  (XLA and PyTorch sum the products in other orders, ~1e-7 relative a
  sum);
* fake-quantized experts: JAX runs op by op (``jax.disable_jit()``), as
  ``tests/test_torch_train.py`` explains, at the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import moe as JMOE
from repro.quant.formats import PrecisionConfig as JPC
from repro_torch import configs, convert
from repro_torch.models import moe as MOE
from repro_torch.quant.formats import PrecisionConfig

RTOL, ATOL = 1e-4, 1e-5
B, S = 2, 64

# the first multi-threaded CPU exp of a process can be 1e-4 off (see
# test_torch_mamba2.py); one parallel exp at import takes it
torch.exp(torch.zeros(1 << 20))


def _setup(arch="granite-moe-3b-a800m", seed=0, **moe_changes):
    jcfg = jconfigs.get_config(arch, smoke=True)
    cfg = configs.get_config(arch, smoke=True)
    jm = dataclasses.replace(jcfg.moe, **moe_changes)
    m = dataclasses.replace(cfg.moe, **moe_changes)
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), cfg.d_model, jm, cfg.ffn,
                       jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return cfg, jm, m, jp, tp, x


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def test_router_gates_indices_and_aux_match_repro():
    cfg, jm, m, jp, tp, x = _setup()
    jg, ji, jaux = JMOE._router(jp, jnp.asarray(x), jm)
    g, i, aux = MOE._router(tp, torch.from_numpy(x), m)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _close(g.numpy(), jg)
    _close(aux.item(), float(jaux))
    assert i.shape == (B, S, m.top_k)


def test_router_breaks_ties_to_the_lower_index_as_jax_does():
    """Two experts with equal router columns tie on every token: both
    packages put the lower index first (``torch.topk`` on the CPU put the
    higher one first at 30 of these 256 choices)."""
    cfg, jm, m, jp, tp, x = _setup()
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]
    jg, ji, _ = JMOE._router({"router": jnp.asarray(router)},
                             jnp.asarray(x), jm)
    g, i, _ = MOE._router({"router": torch.from_numpy(router)},
                          torch.from_numpy(x), m)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    both = (np.asarray(ji) == 2).any(-1) & (np.asarray(ji) == 5).any(-1)
    assert both.any()          # the tie is on the top-k path somewhere
    _close(g.numpy(), jg)


def _jax_keep(idx, n_experts, cap):
    """``repro/models/moe.py:140-145`` on JAX's own indices: which slots
    the dispatch keeps and their clipped positions."""
    b = idx.shape[0]
    flat_e = idx.reshape(b, -1)
    onehot = jax.nn.one_hot(flat_e, n_experts, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=1) * onehot, axis=-1) - 1
    return np.asarray((pos < cap) & (pos >= 0)), np.asarray(
        jnp.clip(pos, 0, cap - 1))


@pytest.mark.parametrize("capacity_factor", (1.25, 0.5))
def test_dispatch_matches_repro(capacity_factor):
    """At 0.5 a quarter or more of the slots drop; a dropped slot adds its
    zero at position C - 1, where a kept slot sits."""
    cfg, jm, m, jp, tp, x = _setup(capacity_factor=capacity_factor)
    cap = MOE.capacity(m, S)
    assert cap == max(1, int(S * m.top_k / m.n_experts * capacity_factor))
    _, ji, _ = JMOE._router(jp, jnp.asarray(x), jm)
    want_keep, want_pos = _jax_keep(ji, m.n_experts, cap)
    _, i, _ = MOE._router(tp, torch.from_numpy(x), m)
    keep, pos = MOE._slots(i.reshape(B, -1), m.n_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    dropped = 1 - want_keep.mean()
    if capacity_factor < 1:
        assert dropped >= 0.25
        # some expert keeps a slot at C - 1 and drops others onto it
        at_end = (want_pos == cap - 1)
        assert (at_end & want_keep).any() and (at_end & ~want_keep).any()
    kw = dict(ffn_kind=cfg.ffn, act=cfg.act)
    jy, jaux = jax.jit(lambda p, xx: JMOE.moe_apply_dispatch(
        p, xx, jm, **kw))(jp, jnp.asarray(x))
    y, aux = MOE.moe_apply_dispatch(tp, torch.from_numpy(x), m, **kw)
    _close(y.numpy(), jy)
    _close(aux.item(), float(jaux))


def test_dense_mix_matches_repro_and_dispatch_at_ample_capacity():
    cfg, jm, m, jp, tp, x = _setup(capacity_factor=4.0)
    kw = dict(ffn_kind=cfg.ffn, act=cfg.act)
    jy, _ = JMOE.moe_apply_dense(jp, jnp.asarray(x), jm, **kw)
    y, _ = MOE.moe_apply_dense(tp, torch.from_numpy(x), m, **kw)
    _close(y.numpy(), jy)
    # decode=True takes the dense mix; with nothing dropped the dispatch
    # path gives the same sums in another order
    y_dec, _ = MOE.moe_apply(tp, torch.from_numpy(x), m, decode=True, **kw)
    assert torch.equal(y_dec, y)
    y_disp, _ = MOE.moe_apply(tp, torch.from_numpy(x), m, **kw)
    _close(y_disp.numpy(), y.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ("granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b"))
def test_shared_expert_matches_repro(arch):
    cfg, jm, m, jp, tp, x = _setup(arch, seed=1, n_shared_experts=1)
    assert {"shared_wi", "shared_wg", "shared_wo"} <= set(tp)
    kw = dict(ffn_kind=cfg.ffn, act=cfg.act)
    for jfn, fn in ((JMOE.moe_apply_dispatch, MOE.moe_apply_dispatch),
                    (JMOE.moe_apply_dense, MOE.moe_apply_dense)):
        jy, _ = jax.jit(lambda p, xx: jfn(p, xx, jm, **kw))(jp,
                                                             jnp.asarray(x))
        y, _ = fn(tp, torch.from_numpy(x), m, **kw)
        _close(y.numpy(), jy)


@pytest.mark.parametrize("mode", ("fake", "packed"))
def test_w4_fake_quant_experts_match_repro(mode):
    """The stacked experts fake-quantize whenever the precision is
    quantized, in either mode (``repro/models/moe.py:67-72``); the
    shared experts follow ``linear``'s rule (fake-quant in "fake" mode
    only)."""
    cfg, jm, m, jp, tp, x = _setup(seed=2, n_shared_experts=1)
    jpc, pc = JPC(bits=4, group_size=16), PrecisionConfig(bits=4,
                                                         group_size=16)
    kw = dict(ffn_kind=cfg.ffn, act=cfg.act, mode=mode)
    with jax.disable_jit():
        jy, _ = JMOE.moe_apply_dispatch(jp, jnp.asarray(x), jm, pc=jpc, **kw)
        jyd, _ = JMOE.moe_apply_dense(jp, jnp.asarray(x), jm, pc=jpc, **kw)
    y, _ = MOE.moe_apply_dispatch(tp, torch.from_numpy(x), m, pc=pc, **kw)
    yd, _ = MOE.moe_apply_dense(tp, torch.from_numpy(x), m, pc=pc, **kw)
    _close(y.numpy(), jy)
    _close(yd.numpy(), jyd)
    y16, _ = MOE.moe_apply_dense(tp, torch.from_numpy(x), m, **kw)
    assert not torch.allclose(yd, y16, atol=1e-3)     # W4 moved something


def test_dispatch_gradients_match_repro():
    cfg, jm, m, jp, tp, x = _setup(seed=3, capacity_factor=0.5)
    kw = dict(ffn_kind=cfg.ffn, act=cfg.act)

    def jloss(p, xx):
        y, aux = JMOE.moe_apply_dispatch(p, xx, jm, **kw)
        return jnp.sum(y * y) + aux

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tpp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = MOE.moe_apply_dispatch(tpp, xt, m, **kw)
    (torch.sum(y * y) + aux).backward()
    for k in tpp:
        want = np.asarray(jg[k])
        _close(tpp[k].grad.numpy(), want, rtol=1e-3,
               atol=1e-4 * np.abs(want).max())
    _close(xt.grad.numpy(), jgx, rtol=1e-3,
           atol=1e-4 * np.abs(np.asarray(jgx)).max())


def test_init_shapes_and_scales():
    cfg = configs.get_config("granite-moe-3b-a800m", smoke=True)
    m = dataclasses.replace(cfg.moe, n_shared_experts=2)
    p = MOE.moe_init(torch.Generator().manual_seed(0), cfg.d_model, m,
                     "glu", torch.float32)
    jp = JMOE.moe_init(jax.random.PRNGKey(0), cfg.d_model, m, "glu",
                       jnp.float32)
    assert set(p) == set(jp)
    for k in p:
        assert tuple(p[k].shape) == jp[k].shape
    assert p["router"].dtype == torch.float32
    for k, fan_in in (("wi", cfg.d_model), ("wo", m.d_ff_expert)):
        assert abs(float(p[k].std()) * fan_in ** 0.5 - 2 ** 0.5) < 0.1
