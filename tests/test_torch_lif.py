"""Port parity: repro_torch.core.lif against repro.core.lif.

Integer steps and rollouts must be identical; the float step and the
surrogate gradient must match ``jax.grad`` within 1e-6 absolute (float32
arithmetic in the same order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as jlif
from repro_torch.core import lif


@pytest.mark.parametrize("soft_reset", [True, False])
@pytest.mark.parametrize("per_channel", [False, True])
def test_int_rollout_identical(soft_reset, per_channel):
    g = np.random.default_rng(3)
    i_syn = g.integers(-40, 60, size=(5, 3, 12)).astype(np.int32)
    theta = (g.integers(1, 30, size=(12,)).astype(np.int32) if per_channel
             else 17)
    kw = dict(leak_shift=3, v_reset_q=-2, soft_reset=soft_reset)
    v0 = np.zeros((3, 12), np.int32)
    jv, js = jlif.lif_rollout_int(jnp.asarray(v0), jnp.asarray(i_syn),
                                  threshold_q=jnp.asarray(theta), **kw)
    tv, ts = lif.lif_rollout_int(
        torch.from_numpy(v0), torch.from_numpy(i_syn),
        threshold_q=lif.as_theta_vector(theta, 12), **kw)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_theta_vector_rejects_wrong_width():
    with pytest.raises(ValueError):
        lif.as_theta_vector(np.arange(5), 6)


@pytest.mark.parametrize("soft_reset", [True, False])
def test_float_step_and_surrogate_grad_match_jax(soft_reset):
    cfg_j = jlif.LIFConfig(leak_shift=3, threshold=1.0,
                           soft_reset=soft_reset)
    cfg_t = lif.LIFConfig(leak_shift=3, threshold=1.0,
                          soft_reset=soft_reset)
    g = np.random.default_rng(5)
    v0 = g.standard_normal((4, 9)).astype(np.float32)
    i_t = g.standard_normal((3, 4, 9)).astype(np.float32)

    def jloss(i):
        v, s = jlif.lif_rollout_float(jnp.asarray(v0), i, cfg_j)
        return jnp.sum(s * (jnp.arange(9.0) / 8)) + jnp.sum(v)

    jv, js = jlif.lif_rollout_float(jnp.asarray(v0), jnp.asarray(i_t), cfg_j)
    jgrad = jax.grad(jloss)(jnp.asarray(i_t))

    it = torch.from_numpy(i_t).requires_grad_(True)
    tv, ts = lif.lif_rollout_float(torch.from_numpy(v0), it, cfg_t)
    (torch.sum(ts * (torch.arange(9.0) / 8)) + torch.sum(tv)).backward()
    np.testing.assert_array_equal(ts.detach().numpy(), np.asarray(js))
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(jgrad),
                               rtol=0, atol=1e-6)
