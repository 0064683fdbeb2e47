"""The SNN float/BPTT path of the port against ``repro`` on the CPU:
``spiking_dense_apply``, ``avgpool_t``, the float forward and its rates
(``FloatExecutor``), ``graph_calibrate``, the surrogate BPTT gradients of
the cross-entropy loss, AdamW steps on them, and the trained params
deployed; plus the torch twin of ``examples/train_quantized_snn.py``.

Params come from JAX (``snn_cnn.init(PRNGKey(0), ...)``) and cross with
``convert.params_from_numpy``.  vgg9 and resnet18 at ``img_size=16``,
``scale=0.15``, T=3, bits 16 and 4.  Tolerances, each with its reason:

* whole-model forwards, gains and gradients run in float64 on both sides
  (JAX under ``jax.enable_x64``, the port's tree in float64): a float32
  summation-order difference can put a membrane on the other side of
  the threshold, and the flipped spike propagates through every later
  layer.  In float64 the two sides' sums differ by ~1e-16 relative, so
  no spike flips for these seeds: logits ``rtol=1e-9``, firing rates
  within 1e-12, gains ``rtol=1e-9``, gradients ``rtol=1e-7`` with an
  atol of 1e-9 times the leaf's largest |gradient| (a gradient element
  near 0 is a cancellation of such sums);
* JAX runs op by op (``jax.disable_jit()``) wherever QAT is on, as in
  ``test_torch_train.py``: under ``jit`` XLA rewrites fake-quant's
  ``absmax / qmax``;
* single layers run in float64 (spikes equal) and float32: at most 1% of
  the dense layer's spikes may differ there (a float32 sum at the
  threshold); ``avgpool_t`` ``rtol=1e-6`` in float32 (the window's sum
  order);
* AdamW runs in float32 in both packages (its moments are float32): the
  losses of three steps ``rtol=1e-5``, params ``rtol=1e-6`` with an atol
  of 1e-6 times the leaf's largest |value| (the global norm's float32
  sum order moves the clip scale by an ulp), as ``test_torch_train.py``;
* deploying one trained tree: packed words, scales and thresholds
  bit-equal; the packaged forward bit-equal to the per-call one.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.deploy import deploy as jdeploy
from repro.graph import FloatExecutor as JFloatExecutor
from repro.graph import build_graph as jbuild_graph
from repro.graph import passes as jpasses
from repro.graph import run_graph as jrun_graph
from repro.core import snn_layers as jlayers
from repro.core.lif import LIFConfig as JLIF
from repro.data import synthetic as jsyn
from repro.models import snn_cnn as jsnn
from repro.quant.formats import PrecisionConfig as JPC
from repro.train import optimizer as jopt
from repro_torch.convert import params_from_numpy
from repro_torch.core import snn_layers
from repro_torch.core.lif import LIFConfig
from repro_torch.deploy import deploy
from repro_torch.graph import (
    CalibratingExecutor,
    FloatExecutor,
    IntExecutor,
    PackagedExecutor,
    build_graph,
    graph_calibrate,
    run_graph,
)
from repro_torch.graph import passes
from repro_torch.graph.spec import Readout, get_path
from repro_torch.models import snn_cnn
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves, leaves_with_path

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLE = ROOT / "examples" / "train_quantized_snn_torch.py"

FWD_RTOL = 1e-9
RATE_ATOL = 1e-12
GAIN_RTOL = 1e-9
GRAD_RTOL = 1e-7
GRAD_ATOL_FRAC = 1e-9
LOSS_RTOL = 1e-5
OPT_RTOL = 1e-6


def _example():
    spec = importlib.util.spec_from_file_location("train_snn_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(model, bits=16, fusion=(), timesteps=3, int_deploy=False):
    kw = dict(model=model, img_size=16, timesteps=timesteps, scale=0.15,
              n_classes=4, fusion=fusion, int_deploy=int_deploy)
    return (jsnn.SNNConfig(precision=JPC(bits=bits), **kw),
            snn_cnn.SNNConfig(precision=PrecisionConfig(bits=bits), **kw))


def _f64(tree):
    """JAX params as float64 numpy (a block's int stride kept)."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64) if hasattr(a, "dtype") else a,
        tree)


def _images(n=4, seed=0):
    return np.random.default_rng(seed).random((n, 16, 16, 3))


def _ref(fn):
    """Run a ``repro`` call op by op in float64."""
    with jax.enable_x64(True), jax.disable_jit():
        return fn()


@pytest.fixture(scope="module")
def calibrated():
    """Per family: JAX's init (float64) and JAX's calibration of it on
    four images, both as numpy trees.  Every JAX call of this file runs
    batches of four at T=3, so each op compiles once."""
    out = {}
    for model in ("vgg9", "resnet18"):
        jcfg, _ = _cfgs(model)
        init = _f64(jsnn.init(jax.random.PRNGKey(0), jcfg))
        cal = _ref(lambda: _f64(jsnn.calibrate(init, jcfg,
                                               jnp.asarray(_images()))))
        out[model] = (init, cal)
    return out


# ---------------------------------------------------------------------------
# single layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bits", [16, 4])
def test_spiking_dense_apply_matches_repro(bits, dtype):
    rng = np.random.default_rng(bits)
    w = (rng.normal(size=(40, 24)) * 0.3).astype(dtype)
    g = rng.uniform(0.5, 2.0, size=24).astype(dtype)
    spikes = (rng.random((3, 5, 40)) < 0.4).astype(dtype)
    lif = dict(leak_shift=3, threshold=0.5)
    pc = PrecisionConfig(bits=bits)

    with jax.enable_x64(dtype == "float64"), jax.disable_jit():
        want = np.asarray(jlayers.spiking_dense_apply(
            {"w": jnp.asarray(w), "g": jnp.asarray(g)}, jnp.asarray(spikes),
            JLIF(**lif), JPC(bits=bits)))
    got = snn_layers.spiking_dense_apply(
        {"w": torch.from_numpy(w), "g": torch.from_numpy(g)},
        torch.from_numpy(spikes), LIFConfig(**lif), pc).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert 0.05 < want.mean() < 0.95, "vacuous: layer silent or saturated"
    if dtype == "float64":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.mean(got != want) <= 0.01


@pytest.mark.parametrize("spikes", [True, False])
def test_avgpool_t_matches_repro(spikes):
    """VALID pool of an odd plane (the last row and column dropped), in
    float32 whatever the input dtype, as ``repro``."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 9, 7, 5))
    if spikes:
        x = (x < 0.3).astype(np.int32)
    with jax.enable_x64(True):
        want = np.asarray(jlayers.avgpool_t(jnp.asarray(x), 2))
    got = snn_layers.avgpool_t(torch.from_numpy(x), 2).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (2, 3, 4, 3, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_backward_is_the_conv_gradient(stride):
    """``_ExactConv2d`` (the float conv whose backward keeps the forward's
    cuDNN flags) has the convolution's true gradients (finite differences
    in float64)."""
    gen = torch.Generator().manual_seed(stride)
    x = torch.randn((2, 7, 6, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((3, 3, 3, 4), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b: snn_layers._conv2d(a, b, stride=stride), (x, w))


def test_balance_is_population_std():
    """``_balance`` divides by the ddof-0 std (``jnp.std``), not torch's
    default ddof-1 one, which would scale every gain by sqrt(n/(n-1))."""
    rng = np.random.default_rng(5)
    i_syn = rng.normal(size=(2, 3, 4, 4, 6)) * rng.uniform(0.1, 3.0, 6)
    with jax.enable_x64(True):
        want = np.asarray(jpasses._balance(jnp.asarray(i_syn), 0.5))
    got = passes._balance(torch.from_numpy(i_syn), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=GAIN_RTOL)
    np.testing.assert_allclose(
        got, np.clip(1.1 * 0.5 / (i_syn.reshape(-1, 6).std(0) + 1e-6),
                     0.05, 100.0), rtol=GAIN_RTOL)


# ---------------------------------------------------------------------------
# the float forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fusion", [(), "auto"])
@pytest.mark.parametrize("bits", [16, 4])
@pytest.mark.parametrize("model", ["vgg9", "resnet18"])
def test_float_forward_matches_repro(calibrated, model, bits, fusion):
    """Logits and per-layer firing rates of ``apply_with_rates``, float64;
    with ``fusion="auto"`` the graph carries groups, which the float
    lowering runs member by member, as ``repro`` does."""
    jcfg, tcfg = _cfgs(model, bits, fusion)
    _, params = calibrated[model]
    x = _images(seed=1)
    jlogits, jrates = _ref(lambda: jsnn.apply_with_rates(
        params, jcfg, jnp.asarray(x)))
    assert bool(jbuild_graph(jcfg).groups) == bool(fusion)
    tparams = params_from_numpy(params, "cpu")
    logits, rates = snn_cnn.apply_with_rates(tparams, tcfg,
                                             torch.from_numpy(x))
    assert logits.dtype == torch.float64
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=FWD_RTOL, atol=0)
    np.testing.assert_allclose(rates, jrates, rtol=0, atol=RATE_ATOL)
    assert min(rates) > 0.0, f"vacuous: a silent layer {rates}"
    np.testing.assert_array_equal(
        snn_cnn.apply(tparams, tcfg, torch.from_numpy(x)).numpy(),
        logits.numpy())


@pytest.mark.parametrize("model", ["vgg9", "resnet18"])
def test_executor_traces_match_repro(calibrated, model):
    """One topology, every lowering: the port's float trace equals
    ``repro``'s ``FloatExecutor`` trace, and the port's float, per-call
    integer and packaged traces equal each other, grouped or not."""
    init, _ = calibrated[model]
    jcfg, _ = _cfgs(model)
    x = _images()
    jex = JFloatExecutor(jbuild_graph(jcfg), init)
    _ref(lambda: jrun_graph(jbuild_graph(jcfg), jex, jnp.asarray(x)))
    params = params_from_numpy(init, "cpu")
    images = torch.from_numpy(x).to(torch.float32)
    for fusion in ((), "auto"):
        _, tcfg = _cfgs(model, fusion=fusion)
        _, icfg = _cfgs(model, 4, fusion, int_deploy=True)
        ex_f = FloatExecutor(build_graph(tcfg), params)
        run_graph(build_graph(tcfg), ex_f, images.to(torch.float64))
        ex_i = IntExecutor(build_graph(icfg), params)
        pkg = deploy(params, icfg, device="cpu")
        ex_p = PackagedExecutor(build_graph(icfg), pkg.float_params, pkg)
        with torch.inference_mode():
            run_graph(build_graph(icfg), ex_i, images.to(torch.float64))
            run_graph(build_graph(icfg), ex_p, images.to(torch.float64))
        assert ex_f.trace == jex.trace == ex_i.trace == ex_p.trace, fusion
        assert bool(build_graph(icfg).groups) == bool(fusion)
    kinds = [row[0] for row in jex.trace]
    assert kinds[0] == "encode" and kinds[-1] == "readout"


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["vgg9", "resnet18"])
def test_calibrate_matches_repro_without_mutating_input(calibrated, model):
    init, want = calibrated[model]
    _, tcfg = _cfgs(model)
    params = params_from_numpy(init, "cpu")
    for leaf in leaves(params):
        if isinstance(leaf, torch.Tensor):
            leaf.requires_grad_(True)
    out = snn_cnn.calibrate(params, tcfg, torch.from_numpy(_images()))
    graph = build_graph(tcfg)
    for spec in graph.param_specs():
        p, q = get_path(params, spec.name), get_path(out, spec.name)
        assert q["w"] is p["w"], spec.name          # leaves shared
        assert torch.equal(p["g"].detach(), torch.ones_like(p["g"]))
        if isinstance(spec, Readout):
            assert q["g"] is p["g"]                 # the head untouched
            continue
        assert not q["g"].requires_grad, spec.name
        np.testing.assert_allclose(q["g"].numpy(),
                                   get_path(want, spec.name)["g"],
                                   rtol=GAIN_RTOL, atol=0, err_msg=spec.name)
        assert not np.allclose(q["g"].numpy(), 1.0), spec.name
    if model == "resnet18":
        assert [b["stride"] for b in out["blocks"]] \
            == [b["stride"] for b in init["blocks"]]


def test_calibrating_executor_skips_dense_rollout_and_readout(calibrated):
    init, _ = calibrated["vgg9"]
    _, tcfg = _cfgs("vgg9")
    graph = build_graph(tcfg)
    ex = CalibratingExecutor(graph, passes._structural_copy(
        params_from_numpy(init, "cpu")))
    out = run_graph(graph, ex, torch.from_numpy(_images()))
    assert out.shape == (3, 4, graph.nodes[-2].d_in)   # fc1's input
    assert ex.pc is None and ex.trace[-1] == ("readout", "head", 1)
    np.testing.assert_allclose(
        graph_calibrate(params_from_numpy(init, "cpu"), graph,
                        torch.from_numpy(_images()))["fc1"]["g"].numpy(),
        ex.params["fc1"]["g"].numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# BPTT, AdamW, deploy
# ---------------------------------------------------------------------------

def _jce(params, cfg, x, y):
    logits = jsnn.apply(params, cfg, x)
    lse = jax.nn.logsumexp(logits, axis=-1)
    return jnp.mean(lse - jnp.take_along_axis(logits, y[:, None], 1)[:, 0])


def _train_cfgs(bits):
    lif = dict(leak_shift=3, threshold=0.5)
    kw = dict(model="vgg9", img_size=16, timesteps=3, scale=0.15,
              n_classes=4)
    return (jsnn.SNNConfig(lif=JLIF(**lif), precision=JPC(bits=bits), **kw),
            snn_cnn.SNNConfig(lif=LIFConfig(**lif),
                              precision=PrecisionConfig(bits=bits), **kw))


def _data(n=12):
    (x, y), _ = jsyn.make_vision_dataset(n_classes=4, img_size=16,
                                         n_train=n, n_test=8)
    return x, y


def _assert_tree_close(got, want, rtol, atol_frac, what):
    for (path, g), (_, w) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().numpy(), w, rtol=rtol,
            atol=atol_frac * float(np.abs(w).max()), err_msg=f"{what} {path}")


@pytest.mark.parametrize("bits", [16, 4])
def test_bptt_gradients_match_repro(bits):
    """Every leaf's surrogate gradient of the cross-entropy loss against
    ``jax.grad``, vgg9 calibrated on the batch, float64."""
    jcfg, tcfg = _train_cfgs(bits)
    x, y = _data(4)
    init = _f64(jsnn.init(jax.random.PRNGKey(0), jcfg))

    def ref():
        p = jsnn.calibrate(init, jcfg, jnp.asarray(x))
        loss, g = jax.value_and_grad(_jce)(p, jcfg, jnp.asarray(x),
                                           jnp.asarray(y))
        return _f64(p), float(loss), _f64(g)

    params, jloss, jgrads = _ref(ref)
    tparams = params_from_numpy(params, "cpu")
    for leaf in leaves(tparams):
        leaf.requires_grad_(True)
    ce = _example().ce
    loss = ce(tparams, tcfg, torch.from_numpy(x),
              torch.from_numpy(y).to(torch.int64))
    grads = torch.autograd.grad(loss, leaves(tparams), allow_unused=True,
                                materialize_grads=True)
    assert abs(float(loss.detach()) - jloss) <= FWD_RTOL * abs(jloss)
    got = dict(zip(map(tuple, (p for p, _ in leaves_with_path(tparams))),
                   grads))
    _assert_tree_close([got[p] for p, _ in leaves_with_path(tparams)],
                       [w for _, w in leaves_with_path(jgrads)],
                       GRAD_RTOL, GRAD_ATOL_FRAC, f"grad w{bits}")
    assert float(torch.abs(got[("convs", 1, "w")]).max()) > 0, "vacuous"
    assert float(torch.abs(got[("head", "g")]).max()) == 0.0


@pytest.fixture(scope="module")
def trained():
    """Three AdamW steps on vgg9 W4 QAT (the example's recipe, batch 4),
    in both packages from the same calibrated float64 params."""
    jcfg, tcfg = _train_cfgs(4)
    x, y = _data()
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=3, weight_decay=0.0,
                clip_norm=5.0)
    init = _f64(jsnn.init(jax.random.PRNGKey(0), jcfg))

    def ref():
        p = jsnn.calibrate(init, jcfg, jnp.asarray(x[:4]))
        start = _f64(p)
        state, losses = jopt.init(p), []
        for i in range(3):
            b = slice(4 * i, 4 * i + 4)
            loss, g = jax.value_and_grad(_jce)(p, jcfg, jnp.asarray(x[b]),
                                               jnp.asarray(y[b]))
            p, state, _ = jopt.update(g, state, p, jopt.OptConfig(**ocfg))
            losses.append(float(loss))
        return start, losses, _f64(p), jax.tree.map(np.asarray, state)

    start, jlosses, jparams, jstate = _ref(ref)
    example = _example()
    params = params_from_numpy(start, "cpu")
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    state, losses = opt.init(params), []
    for i in range(3):
        b = slice(4 * i, 4 * i + 4)
        losses.append(float(example.train_step(
            params, state, torch.from_numpy(x[b]),
            torch.from_numpy(y[b]).to(torch.int64), tcfg,
            opt.OptConfig(**ocfg))))
    return {"jlosses": jlosses, "jparams": jparams, "jstate": jstate,
            "losses": losses, "params": params, "state": state,
            "x": x, "tcfg": tcfg, "jcfg": jcfg}


def test_adamw_steps_track_repro(trained):
    t = trained
    np.testing.assert_allclose(t["losses"], t["jlosses"], rtol=LOSS_RTOL)
    assert t["losses"][0] != t["losses"][-1]
    _assert_tree_close(leaves(t["params"]), leaves(t["jparams"]), OPT_RTOL,
                       OPT_RTOL, "params")
    for k in ("m", "v"):
        _assert_tree_close(leaves(t["state"][k]), leaves(t["jstate"][k]),
                           OPT_RTOL, OPT_RTOL, k)
    assert int(t["state"]["step"]) == int(t["jstate"]["step"]) == 3


@pytest.mark.parametrize("fusion", [(), "auto"])
def test_deploy_trained_params_matches_repro(trained, fusion):
    """JAX's trained tree deployed by both packages: identical words,
    scales and thresholds.  The port's own trained tree (its leaves still
    requiring grad) deployed: the packaged forward equals the per-call
    integer forward bit for bit, grouped or not."""
    t = trained
    jcfg = dataclasses.replace(t["jcfg"], int_deploy=True, fusion=fusion)
    tcfg = dataclasses.replace(t["tcfg"], int_deploy=True, fusion=fusion)
    with jax.enable_x64(True):
        jmodel = jdeploy(t["jparams"], jcfg)
    model = deploy(params_from_numpy(t["jparams"], "cpu"), tcfg,
                   device="cpu")
    assert set(model.layers) == set(jmodel.layers)
    for name, jl in jmodel.layers.items():
        tl = model.layers[name]
        np.testing.assert_array_equal(tl.qt.data.numpy(),
                                      np.asarray(jl.qt.data))
        np.testing.assert_array_equal(tl.qt.scale.numpy(),
                                      np.asarray(jl.qt.scale))
        np.testing.assert_array_equal(tl.theta_q.numpy(),
                                      np.asarray(jl.theta_q))

    own = deploy(t["params"], tcfg, device="cpu")
    x = torch.from_numpy(t["x"][:4])
    with torch.no_grad():
        percall = snn_cnn.apply(t["params"], tcfg, x)
        packaged, rates = own.apply_with_rates(x)
        ungrouped = snn_cnn.apply(t["params"],
                                  dataclasses.replace(tcfg, fusion=()), x)
    np.testing.assert_array_equal(packaged.numpy(), percall.numpy())
    np.testing.assert_array_equal(percall.numpy(), ungrouped.numpy())
    assert min(rates) > 0.0, f"vacuous: a silent layer {rates}"


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--bits", "4"],
                                  ["--bits", "16", "--fusion", "auto"]])
def test_example_trains_deploys_and_serves_on_cpu(argv, capsys):
    """The torch twin of ``examples/train_quantized_snn.py`` end to end at
    smoke geometry, 3 steps: it asserts the packaged forward bit-exact
    with the per-call one (and grouped with ungrouped) itself."""
    out = _example().main(["--smoke", "--device", "cpu", "--steps", "3",
                           *argv])
    text = capsys.readouterr().out
    assert "packaged forward == per-call integer forward" in text
    assert ("grouped forward == ungrouped forward" in text) \
        == ("auto" in argv)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["int_acc"] <= 1.0
    assert len(out["model"].layers) == 13


def test_example_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example().main(["--smoke"])
