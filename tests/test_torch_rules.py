"""Rules the port is held to.

* ``repro_torch`` (every module) imports with JAX and ``repro`` blocked;
* no source file of ``src/repro_torch`` or ``chip_smoke.py`` imports jax
  or anything of ``repro``;
* an entry point called without ``device=`` on a host without CUDA
  raises instead of dropping to the CPU;
* the kernel wrappers take the plain version only for CPU tensors and
  refuse a device they have no kernel for.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def test_port_imports_without_jax_or_repro():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k in sys.modules if sys.modules[k] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)"
    r"|import\s+jax\.)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_source_has_no_jax_or_repro_import(path):
    text = (ROOT / path).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{path} imports {hits}"


def test_scan_pattern_catches_forbidden_imports():
    bad = ["import jax", "import jax.numpy as jnp", "from jax import lax",
           "from repro.core import packing", "import repro",
           "    from repro.deploy import load"]
    ok = ["import repro_torch", "from repro_torch.core import packing",
          "# import jax is banned here"]
    assert all(_FORBIDDEN.search(s) for s in bad)
    assert not any(_FORBIDDEN.search(s) for s in ok)


def test_entry_points_without_device_raise_without_cuda(monkeypatch,
                                                        tmp_path):
    from repro_torch.deploy import (
        SNNEngineConfig, SNNServeEngine, deploy, deploy_config, load)
    from repro_torch.launch import serve_snn
    from repro_torch.models import snn_cnn

    cfg = deploy_config("vgg9", 4)
    params = snn_cnn.init(0, cfg, device="cpu")
    model = deploy(params, cfg, device="cpu")
    path = model.save(str(tmp_path / "m.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy(params, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SNNServeEngine(model, SNNEngineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_snn.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        snn_cnn.init(0, cfg)


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    """Dispatch is by the tensor's device: CPU takes the plain version,
    CUDA the kernel, anything else raises (no silent plain fallback)."""
    from repro_torch.kernels.fused_conv import ops as conv_ops
    from repro_torch.kernels.fused_group import ops as group_ops
    from repro_torch.kernels.fused_nce import ops as nce_ops
    from repro_torch.quant.formats import PrecisionConfig
    from repro_torch.quant.ptq import quantize, quantize_conv

    qct = quantize_conv(torch.randn(3, 3, 32, 32), PrecisionConfig(bits=4))
    with pytest.raises(ValueError, match="unsupported device"):
        conv_ops.fused_conv_rollout(
            torch.zeros((1, 1, 4, 4, 1), dtype=torch.int32, device="meta"),
            qct, leak_shift=3, threshold_q=3)
    qt = quantize(torch.randn(32, 64), PrecisionConfig(bits=4))
    with pytest.raises(ValueError, match="unsupported device"):
        nce_ops.fused_nce_rollout(
            torch.zeros((1, 2, 2), dtype=torch.int32, device="meta"), qt,
            d_in=64, leak_shift=3, threshold_q=3)
    with pytest.raises(ValueError, match="unsupported device"):
        group_ops.fused_group_rollout(
            torch.zeros((1, 1, 4, 4, 1), dtype=torch.int32, device="meta"),
            (("conv", qct, 3), ("conv", qct, 3)), leak_shift=3)
