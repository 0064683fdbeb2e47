"""The port's Mamba-2 mixer (``models/mamba2.py``) against
``repro.models.mamba2`` on the CPU.

Params come from ``repro``'s ``mamba2_init`` (seed 0) at the mamba2
smoke geometry (d_model 64, 8 heads of 16, d_state 16, chunk 32) and
cross as numpy; inputs come from numpy seeds, float32.  Tolerances:
rtol 1e-4 / atol 1e-5 against JAX (the chunk products and the decay
cumsum sum in other orders, ~1e-7 relative a sum), and the port's own
decode steps against its own full forward at rtol / atol 1e-4 (the
chunked and the recurrent forms are different sums of the same terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import mamba2 as JM2
from repro_torch import configs, convert
from repro_torch.models import mamba2 as M2

RTOL, ATOL = 1e-4, 1e-5
B = 2

# PyTorch's CPU ``exp`` (torch 2.13, 8 OpenMP threads) came out up to 1e-4
# off float32 on the first multi-threaded call of a process, in about 1
# of 4 fresh processes; every later call is right.  One parallel exp at
# import, before any test, removes it (16 of 16 processes).
torch.exp(torch.zeros(1 << 20))


def _setup(seed=0):
    cfg = configs.get_config("mamba2-1.3b", smoke=True)
    jcfg = jconfigs.get_config("mamba2-1.3b", smoke=True)
    jp = JM2.mamba2_init(jax.random.PRNGKey(seed), cfg.d_model, jcfg.ssm,
                         jnp.float32)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    return cfg, jcfg, jp, tp


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _ssd_inputs(seed, length, nh=8, hp=16, g=1, n=16):
    r = np.random.default_rng(seed)
    x = r.standard_normal((B, length, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((B, length, nh)) - 3.0)
                  ).astype(np.float32)
    a = -np.exp(r.uniform(0.0, np.log(16.0), nh)).astype(np.float32)
    # B and C at the scale a silu conv output has (|y| ~ 1)
    b_in = (r.standard_normal((B, length, g, n)) / 4).astype(np.float32)
    c_in = (r.standard_normal((B, length, g, n)) / 4).astype(np.float32)
    h0 = r.standard_normal((B, nh, hp, n)).astype(np.float32)
    return x, dt, a, b_in, c_in, h0


@pytest.mark.parametrize("with_h0", (False, True))
def test_ssd_chunked_over_three_chunks_matches_repro(with_h0):
    args = _ssd_inputs(1, 96)
    h0 = args[-1] if with_h0 else None
    jy, jh = JM2.ssd_chunked(*(jnp.asarray(t) for t in args[:-1]), 32,
                             h0=None if h0 is None else jnp.asarray(h0))
    y, h = M2.ssd_chunked(*(torch.from_numpy(t) for t in args[:-1]), 32,
                          h0=None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (B, 96, 8, 16) and h.dtype == torch.float32
    _close(y.numpy(), jy)
    _close(h.numpy(), jh)


def test_mamba2_apply_with_state_matches_repro():
    cfg, jcfg, jp, tp = _setup()
    x = np.random.default_rng(2).standard_normal(
        (B, 64, cfg.d_model)).astype(np.float32)
    jy, jst = jax.jit(lambda p, xx: JM2.mamba2_apply(
        p, xx, jcfg.ssm, cfg.d_model, return_state=True))(jp, jnp.asarray(x))
    y, st = M2.mamba2_apply(tp, torch.from_numpy(x), cfg.ssm, cfg.d_model,
                            return_state=True)
    _close(y.numpy(), jy)
    assert set(st) == {"conv", "ssm"}
    assert st["conv"].shape == (B, cfg.ssm.conv_width - 1,
                                jst["conv"].shape[-1])
    _close(st["conv"].numpy(), jst["conv"])
    _close(st["ssm"].numpy(), jst["ssm"])
    # return_state=False gives the same output alone
    assert torch.equal(M2.mamba2_apply(tp, torch.from_numpy(x), cfg.ssm,
                                       cfg.d_model), y)


def test_four_decode_steps_match_repro_and_the_full_forward():
    """Prefill the first chunk (32 tokens), then 4 recurrent steps: each
    step equals JAX's step, and the steps equal positions 32-35 of the
    full 64-token forward."""
    cfg, jcfg, jp, tp = _setup(1)
    x = np.random.default_rng(3).standard_normal(
        (B, 64, cfg.d_model)).astype(np.float32)
    full = M2.mamba2_apply(tp, torch.from_numpy(x), cfg.ssm, cfg.d_model)
    _, jc = jax.jit(lambda p, xx: JM2.mamba2_apply(
        p, xx, jcfg.ssm, cfg.d_model, return_state=True))(
            jp, jnp.asarray(x[:, :32]))
    _, c = M2.mamba2_apply(tp, torch.from_numpy(x[:, :32]), cfg.ssm,
                           cfg.d_model, return_state=True)
    jstep = jax.jit(lambda p, xx, cc: JM2.mamba2_decode_step(
        p, xx, cc, jcfg.ssm, cfg.d_model))
    for t in range(32, 36):
        jy, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        y, c = M2.mamba2_decode_step(tp, torch.from_numpy(x[:, t:t + 1]),
                                     c, cfg.ssm, cfg.d_model)
        assert y.shape == (B, 1, cfg.d_model)
        _close(y.numpy(), jy)
        _close(c["ssm"].numpy(), jc["ssm"])
        _close(c["conv"].numpy(), jc["conv"])
        _close(y[:, 0].numpy(), full[:, t].numpy(), rtol=1e-4, atol=1e-4)


def test_decode_from_an_empty_cache_matches_repro():
    cfg, jcfg, jp, tp = _setup(2)
    jc = JM2.mamba2_init_cache(B, cfg.d_model, jcfg.ssm, jnp.float32)
    c = M2.mamba2_init_cache(B, cfg.d_model, cfg.ssm, torch.float32)
    for k in ("conv", "ssm"):
        assert tuple(c[k].shape) == jc[k].shape
        assert str(c[k].dtype).split(".")[-1] == str(jc[k].dtype)
    x = np.random.default_rng(4).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    jy, _ = JM2.mamba2_decode_step(jp, jnp.asarray(x), jc, jcfg.ssm,
                                   cfg.d_model)
    y, _ = M2.mamba2_decode_step(tp, torch.from_numpy(x), c, cfg.ssm,
                                 cfg.d_model)
    _close(y.numpy(), jy)


def test_a_length_off_the_chunk_raises_as_in_repro():
    cfg, jcfg, jp, tp = _setup()
    x = np.zeros((B, 40, cfg.d_model), np.float32)    # chunk min(32, 40)
    with pytest.raises(AssertionError, match="chunk"):
        JM2.mamba2_apply(jp, jnp.asarray(x), jcfg.ssm, cfg.d_model)
    with pytest.raises(ValueError, match="chunk"):
        M2.mamba2_apply(tp, torch.from_numpy(x), cfg.ssm, cfg.d_model)
    # shorter than a chunk: the chunk is the length
    M2.mamba2_apply(tp, torch.from_numpy(x[:, :20]), cfg.ssm, cfg.d_model)


def test_gradients_are_finite_and_match_repro():
    """Masking before the exp keeps the upper triangle's gradient finite."""
    cfg, jcfg, jp, tp = _setup(3)
    x = np.random.default_rng(5).standard_normal(
        (B, 64, cfg.d_model)).astype(np.float32)

    def jloss(p):
        y = JM2.mamba2_apply(p, jnp.asarray(x), jcfg.ssm, cfg.d_model)
        return jnp.sum(y * y)

    jg = jax.jit(jax.grad(jloss))(jp)
    flat = {k: v for k, v in tp.items() if not isinstance(v, dict)}
    tpp = {k: ({"w": v["w"].clone().requires_grad_(True)}
               if isinstance(v, dict) else v.clone().requires_grad_(True))
           for k, v in tp.items()}
    y = M2.mamba2_apply(tpp, torch.from_numpy(x), cfg.ssm, cfg.d_model)
    torch.sum(y * y).backward()
    for k in tp:
        got = (tpp[k]["w"] if k not in flat else tpp[k]).grad.numpy()
        want = np.asarray(jg[k]["w"] if k not in flat else jg[k])
        assert np.isfinite(got).all()
        _close(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max())


def test_init_draws_in_the_documented_ranges():
    cfg = configs.get_config("mamba2-1.3b", smoke=True)
    p = M2.mamba2_init(torch.Generator().manual_seed(0), cfg.d_model,
                       cfg.ssm, torch.float32)
    jp = JM2.mamba2_init(jax.random.PRNGKey(0), cfg.d_model, cfg.ssm,
                         jnp.float32)
    for k in jp:
        want = jp[k]["w"] if isinstance(jp[k], dict) else jp[k]
        got = p[k]["w"] if isinstance(p[k], dict) else p[k]
        assert tuple(got.shape) == want.shape, k
    a = torch.exp(p["A_log"])
    assert (a >= 1).all() and (a < 16).all()
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert (dt >= cfg.ssm.dt_min * 0.999).all()
    assert (dt <= cfg.ssm.dt_max * 1.001).all()
