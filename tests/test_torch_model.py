"""Port parity for the whole slice: vgg9 at smoke geometry, INT2/4/8.

1. ``repro`` packs the model (``deploy``), saves the ``.npz``; the port
   ``load``s it and runs its packaged forward on the CPU (plain kernel
   versions), against ``repro``'s packaged forward (``jnp`` backend):
   - stem spikes identical (the stem is float: XLA and PyTorch may sum
     in different orders, so a spike sitting exactly at threshold could
     flip; the test counts flips and requires zero for its seed);
   - every packed layer's output spikes bit-exact, also when fed
     ``repro``'s own stem spikes, which makes the check independent of
     the float stem;
   - logits ``allclose(rtol=1e-5, atol=1e-5)`` (float readout sums);
   - identical executor traces.
2. The port's ``deploy`` on ``params_from_numpy(repro params)`` packs the
   same words, scales and thresholds as ``repro.deploy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import deploy as jdeploy
from repro.deploy import deploy_config as jdeploy_config
from repro.graph import executors as jex
from repro.graph import build_graph as jbuild_graph
from repro.models import snn_cnn as jsnn
from repro_torch.convert import params_from_numpy
from repro_torch.deploy import deploy, deploy_config, load
from repro_torch.graph import build_graph, executors


class _JaxRecorder(jex.PackagedExecutor):
    def __init__(self, *a):
        super().__init__(*a)
        self.outs = {}

    def conv(self, spec, x):
        y = super().conv(spec, x)
        self.outs[spec.name] = np.asarray(y)
        return y

    def dense(self, spec, x):
        y = super().dense(spec, x)
        self.outs[spec.name] = np.asarray(y)
        return y


class _TorchRecorder(executors.PackagedExecutor):
    """Records every conv/dense output; with ``stem_spikes`` it replaces
    the float stem's output by the given spikes."""

    def __init__(self, *a, stem_spikes=None):
        super().__init__(*a)
        self.outs = {}
        self.stem_spikes = stem_spikes

    def conv(self, spec, x):
        if spec.stem and self.stem_spikes is not None:
            self.trace.append(("conv", spec.name, spec.stride))
            y = torch.from_numpy(self.stem_spikes)
        else:
            y = super().conv(spec, x)
        self.outs[spec.name] = y.numpy()
        return y

    def dense(self, spec, x):
        y = super().dense(spec, x)
        self.outs[spec.name] = y.numpy()
        return y


def _images(cfg, n=3, seed=11):
    return np.random.default_rng(seed).random(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


@pytest.fixture(scope="module", params=[2, 4, 8])
def repro_package(request, tmp_path_factory):
    bits = request.param
    cfg = jdeploy_config("vgg9", bits)
    params = jsnn.init(jax.random.PRNGKey(bits), cfg)
    model = jdeploy(params, cfg)
    path = str(tmp_path_factory.mktemp("pkg") / f"vgg9_w{bits}.npz")
    model.save(path)
    return bits, params, model, path


def test_repro_npz_forward_bit_exact(repro_package):
    bits, _, jmodel, path = repro_package
    tmodel = load(path, device="cpu")
    images = _images(jmodel.cfg)

    jgraph = jbuild_graph(jmodel.cfg)
    jrec = _JaxRecorder(jgraph, jmodel.float_params, jmodel)
    jlogits = np.asarray(jex.run_graph(jgraph, jrec, jnp.asarray(images)))

    graph = build_graph(tmodel.cfg)
    trec = _TorchRecorder(graph, tmodel.float_params, tmodel)
    with torch.inference_mode():
        tlogits = executors.run_graph(graph, trec, torch.from_numpy(images))

    assert trec.trace == jrec.trace
    assert set(trec.outs) == set(jrec.outs)
    flips = int((trec.outs["convs.0"] != jrec.outs["convs.0"]).sum())
    assert flips == 0, f"{flips} stem spikes flipped at threshold (w{bits})"
    for name in jrec.outs:
        np.testing.assert_array_equal(trec.outs[name], jrec.outs[name],
                                      err_msg=f"layer {name} w{bits}")
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=1e-5,
                               atol=1e-5)

    # packed layers alone: fed repro's stem spikes, still bit-exact
    fed = _TorchRecorder(graph, tmodel.float_params, tmodel,
                         stem_spikes=jrec.outs["convs.0"].astype(np.int32))
    with torch.inference_mode():
        fed_logits = executors.run_graph(graph, fed,
                                         torch.from_numpy(images))
    for name in jrec.outs:
        np.testing.assert_array_equal(fed.outs[name], jrec.outs[name])
    np.testing.assert_allclose(fed_logits.numpy(), jlogits, rtol=1e-5,
                               atol=1e-5)
    assert np.asarray(jrec.outs["convs.3"]).any(), "vacuous: convs.3 silent"


def test_port_deploy_packs_same_words(repro_package):
    bits, params, jmodel, _ = repro_package
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tmodel = deploy(tparams, deploy_config("vgg9", bits), device="cpu")
    assert set(tmodel.layers) == set(jmodel.layers)
    for name, jl in jmodel.layers.items():
        tl = tmodel.layers[name]
        assert tl.kind == jl.kind and tl.geometry == jl.geometry
        np.testing.assert_array_equal(tl.qt.data.numpy(),
                                      np.asarray(jl.qt.data))
        np.testing.assert_array_equal(tl.qt.scale.numpy(),
                                      np.asarray(jl.qt.scale))
        np.testing.assert_array_equal(tl.theta_q.numpy(),
                                      np.asarray(jl.theta_q))


def test_topology_matches_repro():
    for smoke in (True, False):
        jcfg = jdeploy_config("vgg9", 4, smoke=smoke)
        tcfg = deploy_config("vgg9", 4, smoke=smoke)
        assert build_graph(tcfg).topology() == jbuild_graph(jcfg).topology()
        assert build_graph(tcfg).count_macs() == jbuild_graph(jcfg).count_macs()


def test_resnet18_init_shapes_match_repro():
    """graph_init gives every parameter repro's shape and He-normal scale
    and records each block's stride (the draws differ: torch.Generator is
    not jax.random).  Scale tolerance: 10% of the expected std, over at
    least 640 draws per tensor at full width."""
    from repro_torch.graph.spec import get_path
    from repro_torch.models import snn_cnn

    cfg = deploy_config("resnet18", 4, smoke=False)
    jcfg = jdeploy_config("resnet18", 4, smoke=False)
    jshapes = jax.eval_shape(lambda: jsnn.init(jax.random.PRNGKey(0), jcfg))
    tparams = snn_cnn.init(0, cfg, device="cpu")
    graph = build_graph(cfg)
    assert jax.tree.structure(jshapes) == jax.tree.structure(tparams)
    for spec in graph.param_specs():
        jp, tp = jex.get_path(jshapes, spec.name), get_path(tparams,
                                                           spec.name)
        assert tuple(tp["w"].shape) == jp["w"].shape
        assert tuple(tp["g"].shape) == jp["g"].shape
        want = (2.0 / int(np.prod(tp["w"].shape[:-1]))) ** 0.5
        assert abs(float(tp["w"].std()) - want) < 0.1 * want, spec.name
        assert torch.equal(tp["g"], torch.ones_like(tp["g"]))
    assert [b["stride"] for b in tparams["blocks"]] \
        == [n.stride for n in jbuild_graph(jcfg).nodes
            if type(n).__name__ == "Residual"]


def test_port_save_loads_in_repro(tmp_path):
    """The port writes the same v2 format: repro's load reads it back and
    its packaged forward agrees with the port's within the logit
    tolerance."""
    from repro.deploy import load as jload
    from repro_torch.models import snn_cnn

    cfg = deploy_config("vgg9", 4)
    tmodel = deploy(snn_cnn.init(3, cfg, device="cpu"), cfg, device="cpu")
    path = tmodel.save(str(tmp_path / "port.npz"))
    jmodel = jload(path)
    images = _images(cfg, n=2, seed=5)
    jlogits = np.asarray(jmodel.apply(jnp.asarray(images)))
    with torch.inference_mode():
        tlogits = tmodel.apply(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-5, atol=1e-5)


def test_load_rejects_fusion_groups(tmp_path):
    """A package that carries fusion groups (the name dates from before the
    port lowered them) loads and serves: its groups are re-planned from
    the cfg and its logits match repro's within the logit tolerance."""
    from repro_torch.deploy import SNNEngineConfig, SNNRequest, SNNServeEngine

    cfg = jdeploy_config("vgg9", 4, fusion="auto")
    jmodel = jdeploy(jsnn.init(jax.random.PRNGKey(0), cfg), cfg)
    path = jmodel.save(str(tmp_path / "fused.npz"))
    tmodel = load(path, device="cpu")
    assert [g.members for g in build_graph(tmodel.cfg).groups] \
        == [g.members for g in jbuild_graph(cfg).groups]
    images = _images(cfg, n=2, seed=4)
    eng = SNNServeEngine(tmodel, SNNEngineConfig(max_batch=2), device="cpu")
    for uid, img in enumerate(images):
        eng.add_request(SNNRequest(uid=uid, image=img))
    assert eng.run_until_done()["requests"] == 2
    jlogits = np.asarray(jmodel.apply(jnp.asarray(images)))
    for uid in range(2):
        np.testing.assert_allclose(eng.done[uid].logits, jlogits[uid],
                                   rtol=1e-5, atol=1e-5)


def test_unported_paths_raise():
    """What is still unported raises instead of running another way: the
    float/BPTT forward (executor_for without the integer path)."""
    from repro_torch.models import snn_cnn
    from repro_torch.models.snn_cnn import SNNConfig

    cfg = SNNConfig(model="resnet18", img_size=16, scale=0.15)
    with pytest.raises(NotImplementedError, match="float/BPTT"):
        snn_cnn.apply(snn_cnn.init(0, cfg, device="cpu"), cfg,
                      torch.zeros((1, 16, 16, 3)))
