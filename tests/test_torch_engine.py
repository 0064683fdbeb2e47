"""The port's SNNServeEngine on the CPU (plain kernel versions).

Per-request logits must equal a direct forward of the same image within
rtol=1e-5 / atol=1e-6, the tolerance the JAX engine's own padding test
uses: the float stem may sum in another order at another batch size.
``stats()`` must carry the JAX engine's keys.
"""

import jax
import numpy as np
import pytest
import torch

from repro.deploy import SNNEngineConfig as JEngineConfig
from repro.deploy import SNNRequest as JRequest
from repro.deploy import SNNServeEngine as JServeEngine
from repro.deploy import deploy as jdeploy
from repro.deploy import deploy_config as jdeploy_config
from repro.models import snn_cnn as jsnn
from repro_torch.deploy import (
    SNNEngineConfig, SNNRequest, SNNServeEngine, deploy, deploy_config,
)
from repro_torch.models import snn_cnn


@pytest.fixture(scope="module")
def model():
    cfg = deploy_config("vgg9", 4)
    return deploy(snn_cnn.init(1, cfg, device="cpu"), cfg, device="cpu")


def _images(cfg, n, seed=0):
    return np.random.default_rng(seed).random(
        (n, cfg.img_size, cfg.img_size, cfg.in_channels)).astype(np.float32)


def test_five_requests_across_buckets_match_direct_forward(model):
    cfg = model.cfg
    images = _images(cfg, 5)
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=4), device="cpu")
    assert eng.buckets == (1, 2, 4)
    assert eng.warmup() == 3 and eng.compile_count == 3
    for uid, img in enumerate(images):
        eng.add_request(SNNRequest(uid=uid, image=img))
    stats = eng.run_until_done()
    assert stats["requests"] == 5 and stats["batches"] == 2
    assert stats["buckets"] == {"1": 1, "4": 1}
    assert eng.compile_count == 3          # no new bucket after warmup
    assert stats["padding_waste"] == 0.0
    with torch.inference_mode():
        for uid, img in enumerate(images):
            direct = model.apply(torch.from_numpy(img[None]))[0].numpy()
            req = eng.done[uid]
            np.testing.assert_allclose(req.logits, direct, rtol=1e-5,
                                       atol=1e-6)
            assert req.pred == int(np.argmax(req.logits))
            assert req.latency_s >= req.compute_s >= 0.0
            assert req.image is None


def test_fusion_auto_requests_match_direct_forward():
    """vgg9 fusion="auto": served logits equal a direct forward of the
    same image (tolerance as above), the chain lowering through the
    fused_group wrapper, and the ungrouped package's logits exactly."""
    import dataclasses

    from repro_torch.kernels.fused_group import ref as group_ref

    cfg = deploy_config("vgg9", 4, fusion="auto")
    fused = deploy(snn_cnn.init(1, cfg, device="cpu"), cfg, device="cpu")
    flat = dataclasses.replace(fused, cfg=dataclasses.replace(cfg,
                                                              fusion=()))
    images = _images(cfg, 3, seed=4)
    eng = SNNServeEngine(fused, SNNEngineConfig(max_batch=2), device="cpu")
    assert "[fuse.0]" in eng.graph_summary()
    assert eng.warmup() == 2
    calls = []
    plain = group_ref.fused_group_rollout_torch
    group_ref.fused_group_rollout_torch = \
        lambda *a, **k: calls.append(1) or plain(*a, **k)
    try:
        for uid, img in enumerate(images):
            eng.add_request(SNNRequest(uid=uid, image=img))
        assert eng.run_until_done()["batches"] == 2
    finally:
        group_ref.fused_group_rollout_torch = plain
    assert len(calls) == 2
    with torch.inference_mode():
        for uid, img in enumerate(images):
            x = torch.from_numpy(img[None])
            direct = fused.apply(x)[0].numpy()
            np.testing.assert_allclose(eng.done[uid].logits, direct,
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(flat.apply(x)[0].numpy(), direct)


def test_stats_keys_match_repro_engine(model):
    cfg = model.cfg
    jcfg = jdeploy_config("vgg9", 4)
    jmodel = jdeploy(jsnn.init(jax.random.PRNGKey(0), jcfg), jcfg)
    jeng = JServeEngine(jmodel, JEngineConfig(max_batch=1))
    img = _images(cfg, 1)[0]
    jeng.add_request(JRequest(uid=0, image=img))
    jstats = jeng.run_until_done()
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=1), device="cpu")
    eng.add_request(SNNRequest(uid=0, image=img))
    stats = eng.run_until_done()
    assert set(stats) == set(jstats)
    assert stats["compiles"] == jstats["compiles"] == 1


def test_engine_validation_and_close(model):
    cfg = model.cfg
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=2), device="cpu")
    with pytest.raises(ValueError, match="image shape"):
        eng.add_request(SNNRequest(uid=0, image=np.zeros((3, 3, 3))))
    images = _images(cfg, 3, seed=2)
    for uid, img in enumerate(images):
        eng.add_request(SNNRequest(uid=uid, image=img))
    stats = eng.close()
    assert stats["requests"] == 3
    with pytest.raises(RuntimeError, match="closed"):
        eng.add_request(SNNRequest(uid=9, image=images[0]))
    with pytest.raises(NotImplementedError, match="data_parallel"):
        SNNServeEngine(model, SNNEngineConfig(data_parallel=True),
                       device="cpu")


def test_run_until_done_raises_on_truncation(model):
    eng = SNNServeEngine(model, SNNEngineConfig(max_batch=1), device="cpu")
    for uid, img in enumerate(_images(model.cfg, 3)):
        eng.add_request(SNNRequest(uid=uid, image=img))
    with pytest.raises(RuntimeError, match="still queued"):
        eng.run_until_done(max_steps=1)


def test_launcher_serves_on_cpu(tmp_path, capsys):
    from repro_torch.launch import serve_snn

    stats = serve_snn.main(["--device", "cpu", "--requests", "5",
                            "--max-batch", "4", "--package",
                            str(tmp_path / "pkg.npz")])
    assert stats["requests"] == 5
    assert "saved + reloaded package" in capsys.readouterr().out
