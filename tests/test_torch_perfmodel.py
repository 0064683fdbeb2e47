"""The port's ``perfmodel`` and ``launch.profiling`` against ``repro``'s.

* ``count_fn_flops``: ``repro``'s four FLOP cases on their torch
  counterparts (an exact matmul, a loop of 7 where ``repro`` scans 7
  times, a ``torch.utils.checkpoint`` body counted once where ``repro``
  counts a remat body once, a grad with its backward), plus a
  convolution and a batched matmul, each against ``repro``'s counter on
  the same shapes; ``meta`` tensors count without computing.
* ``pick_bottleneck``'s tie-break and ``override_depth`` as ``repro``'s.
* Every public ``fpga_model`` function and table equal to ``repro``'s
  over bits 2/4/8.
* ``maybe_trace(None)`` starts no profiler; ``maybe_trace(dir, "cpu")``
  around a CPU engine step writes a Chrome trace holding
  ``snn_serve_step/b<bucket>``; ``add_profile_flag`` parses as
  ``repro``'s.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.profiler as tprof
from torch.utils.checkpoint import checkpoint

from repro.perfmodel import fpga_model as jfpga
from repro.perfmodel.flops import count_fn_flops as jcount
from repro_torch.perfmodel import fpga_model as fpga
from repro_torch.perfmodel.flops import (
    count_fn_flops,
    model_flops_2nd,
    model_flops_6nd,
)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_flops_matmul_exact():
    fl = count_fn_flops(lambda x, y: x @ y, _meta(64, 128), _meta(128, 32))
    assert fl == 2 * 64 * 128 * 32
    assert fl == jcount(lambda x, y: x @ y, _spec(64, 128), _spec(128, 32))


def test_flops_loop_counts_every_trip():
    """A Python loop of 7 matmuls: 7x the body, where ``repro`` scans."""
    def f(x, w):
        for _ in range(7):
            x = x @ w
        return x

    def jf(x, w):
        y, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=7)
        return y

    fl = count_fn_flops(f, _meta(32, 32), _meta(32, 32))
    base = 2 * 32 * 32 * 32
    assert fl == 7 * base
    assert abs(fl - jcount(jf, _spec(32, 32), _spec(32, 32))) < base * 0.01


def test_flops_checkpoint_counted_once():
    """A checkpoint body counts once in a forward (its recompute belongs
    to a backward's schedule), as ``repro`` counts a remat body once."""
    x, w = _meta(32, 32), _meta(32, 32)
    plain = count_fn_flops(lambda x, w: x @ w, x, w)
    ckpt = count_fn_flops(
        lambda x, w: checkpoint(lambda a, b: a @ b, x, w,
                                use_reentrant=False), x, w)
    assert ckpt == plain == jcount(jax.checkpoint(lambda x, w: x @ w),
                                   _spec(32, 32), _spec(32, 32))


def test_flops_grad_includes_backward():
    def fwd(w, x):
        return torch.sum(x @ w)

    def both(w, x):
        w = w.detach().requires_grad_()
        return torch.autograd.grad(fwd(w, x), w)[0]

    x, w = _meta(32, 64), _meta(64, 16)
    f, b = count_fn_flops(fwd, w, x), count_fn_flops(both, w, x)
    # grad wrt w adds one more matmul (x.T @ g): ~2x the forward
    assert 1.8 * f < b < 3.0 * f
    jf = jcount(lambda w, x: jnp.sum(x @ w), _spec(64, 16), _spec(32, 64))
    assert f == jf


def test_flops_conv_and_bmm_match_repro():
    # NCHW / OIHW here, NHWC / HWIO there: the same convolution
    conv = count_fn_flops(
        lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
        _meta(2, 5, 9, 9), _meta(7, 5, 3, 3))
    jconv = jcount(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        _spec(2, 9, 9, 5), _spec(3, 3, 5, 7))
    assert conv == jconv == 2 * (2 * 7 * 9 * 9) * (3 * 3 * 5)
    grouped = count_fn_flops(
        lambda x, w: torch.nn.functional.conv2d(x, w, groups=2),
        _meta(1, 4, 6, 6), _meta(6, 2, 3, 3))
    assert grouped == 2 * (1 * 6 * 4 * 4) * (3 * 3 * 2)
    bmm = count_fn_flops(torch.bmm, _meta(3, 8, 16), _meta(3, 16, 4))
    assert bmm == 2 * 3 * 8 * 4 * 16 == jcount(
        lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b),
        _spec(3, 8, 16), _spec(3, 16, 4))


def test_flops_count_real_tensors_too():
    x = torch.randn(4, 8)
    w = torch.randn(8, 3)
    assert count_fn_flops(lambda a, b: torch.relu(a @ b), x, w) \
        == 2 * 4 * 8 * 3 + 4 * 3


def test_model_flops_references():
    assert model_flops_6nd(10, 7) == 420
    assert model_flops_2nd(10, 7) == 140


@pytest.mark.parametrize("terms", [
    (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (1.0, 2.0, 2.0), (0.0, 0.0, 1e-9),
    (3.0, 1.0, 2.0), (1.0, 3.0, 2.0), (1.0, 2.0, 3.0), (2.0, 2.0, 1.0)])
def test_pick_bottleneck_matches_repro(terms):
    from repro.perfmodel.roofline import pick_bottleneck as jpick
    from repro_torch.perfmodel.roofline import pick_bottleneck

    assert pick_bottleneck(*terms) == jpick(*terms)


def test_pick_bottleneck_tie_break():
    from repro_torch.perfmodel.roofline import pick_bottleneck

    assert pick_bottleneck(0.0, 0.0, 0.0) == "compute"
    assert pick_bottleneck(1.0, 2.0, 2.0) == "memory"
    assert pick_bottleneck(0.0, 0.0, 1e-9) == "collective"


@pytest.mark.parametrize("arch", ["olmo-1b", "gemma2-2b", "whisper-base",
                                  "hymba-1.5b"])
@pytest.mark.parametrize("depth", [1, 2, 5])
def test_override_depth_matches_repro(arch, depth):
    from repro.configs import get_config as jget_config
    from repro.perfmodel.roofline import override_depth as joverride
    from repro_torch.configs import get_config
    from repro_torch.perfmodel.roofline import override_depth

    mine = override_depth(get_config(arch), depth)
    theirs = joverride(jget_config(arch), depth)
    assert mine.n_layers == theirs.n_layers == depth
    assert mine.global_attn_layers == theirs.global_attn_layers
    assert (mine.encdec is None) == (theirs.encdec is None)
    if mine.encdec is not None:
        assert mine.encdec.n_layers == theirs.encdec.n_layers == depth
    assert dataclasses.replace(mine, n_layers=get_config(arch).n_layers,
                               global_attn_layers=get_config(
                                   arch).global_attn_layers,
                               encdec=get_config(arch).encdec) \
        == get_config(arch)


def test_h100_constants():
    from repro_torch import perfmodel

    assert perfmodel.HBM_BW == 3.35e12
    assert perfmodel.PEAK_FLOPS == 989e12
    assert perfmodel.PEAK_INT8_OPS == 1979e12
    assert perfmodel.PEAK_FP32_FLOPS == 67e12
    assert perfmodel.LINK_BW == 450e9


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fpga_model_matches_repro(bits):
    assert fpga.neuron_resources(bits) == jfpga.neuron_resources(bits)
    assert fpga.system_resources(bits) == jfpga.system_resources(bits)
    assert fpga.system_power_w(bits) == jfpga.system_power_w(bits)
    assert fpga._raw_neuron_units(bits, fpga.EngineGeometry()) == \
        jfpga._raw_neuron_units(bits, jfpga.EngineGeometry())
    assert fpga._raw_neuron_depth(bits) == jfpga._raw_neuron_depth(bits)
    geo, jgeo = fpga.EngineGeometry(n_pe=16), jfpga.EngineGeometry(n_pe=16)
    assert fpga.neuron_resources(bits, geo) == \
        jfpga.neuron_resources(bits, jgeo)
    for macs in (1, 10 ** 6, fpga.TABLE2_REF_MACS, 313 * 10 ** 6):
        assert fpga.system_latency_ms(macs, bits) == \
            jfpga.system_latency_ms(macs, bits)
        assert fpga.system_latency_ms(macs, bits, geo, 0.2) == \
            jfpga.system_latency_ms(macs, bits, jgeo, 0.2)
        assert fpga.system_energy_mj(macs, bits) == \
            jfpga.system_energy_mj(macs, bits)
        for platform in fpga.PLATFORMS:
            assert fpga.platform_latency_s(macs, platform) == \
                jfpga.platform_latency_s(macs, platform)
            assert fpga.platform_energy_j(macs, platform) == \
                jfpga.platform_energy_j(macs, platform)


def test_fpga_tables_match_repro():
    for name in ("PAPER_NEURON", "PAPER_SYSTEM", "PAPER_TABLE1",
                 "PAPER_TABLE2", "PLATFORMS", "PAPER_LATENCIES",
                 "TABLE2_REF_MACS"):
        assert getattr(fpga, name) == getattr(jfpga, name), name
    assert dataclasses.asdict(fpga.EngineGeometry()) == \
        dataclasses.asdict(jfpga.EngineGeometry())
    public = {n for n in dir(jfpga) if not n.startswith("__")
              and n not in ("dataclasses", "annotations")}
    assert public <= set(dir(fpga))


# ---------------------------------------------------------------------------
# --profile
# ---------------------------------------------------------------------------

def test_maybe_trace_none_is_a_no_op(tmp_path, monkeypatch):
    from repro_torch.launch.profiling import maybe_trace

    monkeypatch.chdir(tmp_path)
    for off in (None, ""):
        with maybe_trace(off) as where:
            assert where is None
            assert not tprof._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []


def test_maybe_trace_writes_the_serve_step_range(tmp_path, capsys):
    from repro_torch.deploy import (
        SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config)
    from repro_torch.launch.profiling import maybe_trace
    from repro_torch.models import snn_cnn

    cfg = deploy_config("vgg9", 4)
    model = deploy(snn_cnn.init(0, cfg, device="cpu"), cfg, device="cpu")
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=4), device="cpu")
    eng.warmup()
    images = np.random.default_rng(0).random(
        (3, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)
    for uid, img in enumerate(images):
        eng.add_request(SNNRequest(uid=uid, image=img))
    out_dir = tmp_path / "trace"
    with maybe_trace(str(out_dir), device="cpu") as where:
        assert where == str(out_dir) and tprof._is_profiler_enabled
        eng.run_until_done()
    assert not tprof._is_profiler_enabled
    (path,) = out_dir.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert "snn_serve_step/b4" in names
    assert f"trace written to {path}" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [[], ["--profile"], ["--profile", "d/x"]])
def test_add_profile_flag_parses_as_repro(argv):
    from repro.launch.profiling import add_profile_flag as jadd
    from repro_torch.launch.profiling import add_profile_flag

    mine, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    add_profile_flag(mine, "build/trace/x")
    jadd(theirs, "build/trace/x")
    assert vars(mine.parse_args(argv)) == vars(theirs.parse_args(argv))
