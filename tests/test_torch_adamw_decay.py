"""AdamW's weight decay in the port against JAX's rule.

JAX decays every leaf of ``ndim >= 2`` and stacks each layer's params
into ``(L, ...)`` leaves; the port keeps each layer stack as a list of
per-layer dicts (``convert.LAYER_STACKS``), so its rule
(``optimizer.decays``) counts a leaf inside such a list one dim more.

* every leaf of the 10 archs' smoke params: the port decays it exactly
  when JAX decays its counterpart (the JAX tree carried across by
  ``convert.lm_params_from_numpy``), by the rule and by what one update
  with zero gradients moves in each package;
* two AdamW steps on gemma2-smoke's params and random gradients against
  JAX's, every leaf of params and moments within
  ``test_torch_train.py``'s optimizer tolerance (rtol 1e-6 and an atol
  of 1e-6 of the leaf's largest |value|).
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.train import optimizer as jopt
from repro_torch import configs, convert
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves_with_path
from test_torch_train import OPT_RTOL, _assert_tree_close

OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=10)
_jupdate = jax.jit(lambda g, s, p: jopt.update(g, s, p,
                                               jopt.OptConfig(**OCFG)))


def _jax_tree(arch, seed=0):
    """JAX's smoke params of ``arch`` as float32 numpy, drawn from
    ``seed`` with numpy at JAX's shapes (nothing is traced)."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    shapes = jax.eval_shape(japi.get_model(jcfg).init,
                            jax.random.PRNGKey(0))
    g = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: g.standard_normal(s.shape).astype(np.float32), shapes)


def _jax_path(path):
    """The JAX leaf of a port path: a layer stack's index dropped."""
    keys = [k for i, k in enumerate(path)
            if not (i == 1 and path[0] in convert.LAYER_STACKS)]
    return "/".join(str(k) for k in keys)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in
                _flat(tree[k], f"{path}/{k}" if path else str(k)).items()}
    return {path: tree}


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decay_follows_jax_on_every_leaf(arch):
    jtree = _jax_tree(arch)
    jflat = _flat(jtree)
    port = convert.lm_params_from_numpy(jtree, device="cpu")
    own = api.get_model(configs.get_config(arch, smoke=True)).init(
        0, device="cpu")
    got = leaves_with_path(port)
    assert [(p, tuple(t.shape)) for p, t in got] == \
        [(p, tuple(t.shape)) for p, t in leaves_with_path(own)]
    rule = {_jax_path(p): opt.decays(p, t) for p, t in got}
    assert set(rule) == set(jflat)
    for path, decayed in rule.items():
        assert decayed == (jflat[path].ndim >= 2), (arch, path)

    # what one update with zero gradients moves, in each package
    zeros = jax.tree.map(np.zeros_like, jtree)
    jp, _, _ = _jupdate(zeros, jopt.init(jtree), jtree)
    j_moved = {k for k, v in _flat(jax.tree.map(np.asarray, jp)).items()
               if not np.array_equal(v, jflat[k])}
    grads = convert.lm_params_from_numpy(zeros, device="cpu")
    before = {_jax_path(p): t.clone() for p, t in got}
    opt.update(grads, opt.init(port), port, opt.OptConfig(**OCFG))
    t_moved = {_jax_path(p) for p, t in leaves_with_path(port)
               if not torch.equal(t, before[_jax_path(p)])}
    assert t_moved == j_moved
    assert t_moved == {k for k, d in rule.items() if d}


@pytest.mark.parametrize("model", ["vgg9", "resnet18"])
def test_snn_params_decay_by_their_own_rank(model):
    """The SNN's trees hold no layer stack: each leaf decays by its own
    ``ndim``, as JAX's SNN leaves do (lists of per-layer dicts there
    too)."""
    from repro_torch.deploy.package import deploy_config
    from repro_torch.models import snn_cnn

    params = snn_cnn.init(0, deploy_config(model, smoke=True), device="cpu")
    flat = [(p, t) for p, t in leaves_with_path(params)
            if isinstance(t, torch.Tensor)]
    assert any(t.ndim == 1 for _, t in flat)
    for path, t in flat:
        assert opt.decays(path, t) == (t.ndim >= 2), path


def test_two_adamw_steps_on_gemma2_match_jax():
    jtree = _jax_tree("gemma2-2b", seed=1)
    # the leaves the rule was repaired for: a layer's norm scales
    assert {"ln1", "ln2", "post_ln1", "post_ln2"} <= set(jtree["layers"])
    assert jtree["layers"]["ln1"]["g"].ndim == 2
    g = np.random.default_rng(2)
    grads = [jax.tree.map(lambda a: (g.standard_normal(a.shape) * 0.01)
                          .astype(np.float32), jtree) for _ in range(2)]
    jp, jstate = jtree, jopt.init(jtree)
    tp = convert.lm_params_from_numpy(jtree, device="cpu")
    tstate = opt.init(tp)
    for gr in grads:
        jp, jstate, jm = _jupdate(gr, jstate, jp)
        tp, tstate, tm = opt.update(convert.lm_params_from_numpy(
            gr, device="cpu"), tstate, tp, opt.OptConfig(**OCFG))
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=OPT_RTOL)
        for key, got, want in (("params", tp, jp),
                               ("m", tstate["m"], jstate["m"]),
                               ("v", tstate["v"], jstate["v"])):
            _assert_tree_close(convert.lm_params_to_numpy(got),
                               jax.tree.map(np.asarray, want), OPT_RTOL,
                               key, OPT_RTOL)
