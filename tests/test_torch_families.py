"""The LM families beyond the dense ones, through the whole model, against
``repro`` on the CPU: MoE (granite-moe, moonshot), Mamba-2, the Hymba
hybrid, PaliGemma with its vision prefix, and Whisper; with them
``models/api.py``, the conv/SSM slot writes of ``serve/engine.py`` and
the layer stacks of ``convert.py``.

Params are JAX's (``get_model(cfg).init``, seed 0), carried across with
``convert.lm_params_from_numpy``; inputs come from numpy seeds at the
smoke configs, float32, B=2, S=64 (two of the smoke SSMs' 32-token
chunks).  JAX runs jitted (no fake-quant here).  Tolerances, each with
its reason:

* hidden states, logits, caches, losses: rtol 1e-4 / atol 1e-5 (XLA and
  PyTorch sum in other orders, ~1e-7 relative a sum);
* gradients: rtol 1e-3 with an atol of 1e-4 times the leaf's largest
  |gradient| (a gradient element near 0 is a cancellation of such sums;
  the backward of a top-k router and an SSD scan adds more of them);
* packed INT4 KV words written by the prefill: at most 1% differ (a code
  flips where a value sits at a rounding tie; 0 at these seeds), and the
  decode logits through ``kv_attention``'s plain version at the
  tolerance above;
* greedy tokens of the serving engine: identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import api as japi
from repro.models import transformer as JT
from repro.models import whisper as JW
from repro.serve import engine as jengine
from repro_torch import configs, convert
from repro_torch.models import api
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.serve import engine
from repro_torch.tree import leaves, unflatten_like

RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL = 1e-3
B, S = 2, 64
FAMILIES = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b", "mamba2-1.3b",
            "hymba-1.5b", "paligemma-3b", "whisper-base")
DECODERS = FAMILIES[:-1]

# the first multi-threaded CPU exp of a process can be 1e-4 off (see
# test_torch_mamba2.py); one parallel exp at import takes it
torch.exp(torch.zeros(1 << 20))


def _close(got, want, rtol=RTOL, atol=ATOL, where=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=where)


@functools.lru_cache(maxsize=None)
def _jax_init(arch):
    """JAX's params of ``arch`` (seed 0), initialised once per process: the
    tests of one family share them, and each gets its own port copy."""
    jp = japi.get_model(jconfigs.get_config(arch, smoke=True)).init(
        jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _models(arch, **changes):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               **changes)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              **changes)
    jp, jnp_tree = _jax_init(arch)
    tp = convert.lm_params_from_numpy(jnp_tree, device="cpu")
    return jcfg, cfg, jp, tp


def _batch(cfg, seed):
    """numpy inputs of ``repro``'s smoke batch layout (tests/test_models.py):
    frames for the audio family, the vision prefix's embeddings and
    ``S - prefix`` text tokens for the VLM; labels -1 at a few places."""
    g = np.random.default_rng(seed)
    s_text = S - cfg.vision_prefix_len
    batch = {"tokens": g.integers(0, cfg.vocab, (B, s_text)).astype(np.int32)}
    labels = g.integers(0, cfg.vocab, (B, s_text)).astype(np.int32)
    labels[0, :3] = -1
    batch["labels"] = labels
    if cfg.family == "audio":
        batch["frames"] = g.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.vision_prefix_len:
        batch["vision_embeds"] = g.standard_normal(
            (B, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch, *drop):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


def _tb(batch, *drop):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()
            if k not in drop}


# --- the model --------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_hidden_matches_repro(arch):
    jcfg, cfg, jp, tp = _models(arch)
    batch = _batch(cfg, 1)
    jb, tb = _jb(batch), _tb(batch)
    if cfg.family == "audio":
        jh = jax.jit(lambda p, b: JW.decode_train(
            p, jcfg, b["tokens"], JW.encode(p, jcfg, b["frames"])))(jp, jb)
        h = W.decode_train(tp, cfg, tb["tokens"],
                           W.encode(tp, cfg, tb["frames"]))
        jaux, aux = 0.0, 0.0
    else:
        jh, jaux = jax.jit(lambda p, b: JT.forward_hidden(
            p, jcfg, b["tokens"], b.get("vision_embeds")))(jp, jb)
        h, aux = T.forward_hidden(tp, cfg, tb["tokens"],
                                  tb.get("vision_embeds"))
    assert h.shape == (B, S, cfg.d_model)
    _close(h.detach().numpy(), jh)
    _close(float(aux), float(jaux))
    if cfg.moe is not None:
        assert float(aux) > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_repro(arch):
    jcfg, cfg, jp, tp = _models(arch)
    batch = _batch(cfg, 2)
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.get_model(jcfg).loss_fn(p, b)))(jp, _jb(batch))
    flat = leaves(tp)
    for p in flat:
        p.requires_grad_(True)
    loss = api.get_model(cfg).loss_fn(tp, _tb(batch))
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    _close(loss.item(), float(jloss))
    got = convert.lm_params_to_numpy(unflatten_like(tp, list(grads)))
    want = jax.tree.map(np.asarray, jg)
    wflat = jax.tree_util.tree_flatten_with_path(want)[0]
    gflat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in gflat] == [p for p, _ in wflat]
    for (path, w), (_, g) in zip(wflat, gflat):
        _close(g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL / 10 * np.abs(w).max(),
               where=jax.tree_util.keystr(path))


def _pad(cache, n, pad):
    """The K/V entries of a prefill cache padded by ``n`` positions (the
    conv/SSM state and whisper's cross cache have no length)."""
    out = dict(cache)
    for k in ("k", "v", "k_scale", "v_scale"):
        if k in cache:
            out[k] = pad(cache[k], n)
    return out


def _jpad(v, n):
    return jnp.pad(v, [(0, 0), (0, 0), (0, n)] + [(0, 0)] * (v.ndim - 3))


def _tpad(v, n):
    return torch.nn.functional.pad(v, (0, 0) * (v.ndim - 3) + (0, n))


def _check_cache(tc, jc, kv_bits=16):
    assert set(tc) == set(jc)
    for key in tc:
        want, got = np.asarray(jc[key]), tc[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, key
        if key in ("k", "v") and kv_bits != 16:
            assert (got != want).mean() <= 0.01       # counted: tie flips
        elif key != "len":
            _close(got, want, where=key)


def _prefill(jcfg, cfg, jp, tp, batch):
    ins = ("tokens", "frames", "vision_embeds")
    jb = {k: v for k, v in _jb(batch).items() if k in ins}
    tb = {k: v for k, v in _tb(batch).items() if k in ins}
    jl, jc = jax.jit(japi.get_model(jcfg).prefill)(jp, jb)
    tl, tc = api.get_model(cfg).prefill(tp, tb)
    _close(tl.numpy(), jl)
    return jc, tc


@pytest.mark.parametrize("arch,ragged", [(a, r) for a in DECODERS
                                         for r in (False, True)]
                         + [("whisper-base", False)])
def test_prefill_and_decode_match_repro(arch, ragged):
    """Prefill, then 3 decode steps from the cache padded by 4; ragged
    steps start the two slots at different lengths (S and S - 2)."""
    jcfg, cfg, jp, tp = _models(arch)
    batch = _batch(cfg, 3)
    jc, tc = _prefill(jcfg, cfg, jp, tp, batch)
    _check_cache(tc, jc)
    jc, tc = _pad(jc, 4, _jpad), _pad(tc, 4, _tpad)
    if ragged:
        lens = np.array([S, S - 2], np.int32)
        jc["len"], tc["len"] = jnp.asarray(lens), torch.from_numpy(lens)
    kw = {"ragged": True} if ragged else {}
    jstep = jax.jit(lambda p, c, t: japi.get_model(jcfg).decode_step(
        p, c, t, **kw))
    g = np.random.default_rng(4)
    for _ in range(3):
        tok = g.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        tl, tc = api.get_model(cfg).decode_step(
            tp, tc, torch.from_numpy(tok).long(), **kw)
        _close(tl.numpy(), jl)
    _check_cache(tc, jc)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@pytest.mark.parametrize("arch", ("hymba-1.5b", "paligemma-3b"))
def test_int4_kv_decode_matches_repro(arch):
    """INT4 KV: the prefill writes packed words and scales; 3 uniform
    decode steps run ``kv_attention``'s plain version (Hymba: a 16-token
    window on layer 1, which the 68-token cache crosses; PaliGemma: one
    KV head for 4 query heads over the prefix)."""
    jcfg, cfg, jp, tp = _models(arch, kv_cache_bits=4)
    batch = _batch(cfg, 5)
    jc, tc = _prefill(jcfg, cfg, jp, tp, batch)
    _check_cache(tc, jc, kv_bits=4)
    assert tc["k"].dtype == torch.int32 and "k_scale" in tc
    jc, tc = _pad(jc, 4, _jpad), _pad(tc, 4, _tpad)
    jstep = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c, t))
    g = np.random.default_rng(6)
    for _ in range(3):
        tok = g.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jstep(jp, jc, jnp.asarray(tok))
        tl, tc = T.decode_step(tp, cfg, tc, torch.from_numpy(tok).long())
        _close(tl.numpy(), jl)
    _check_cache(tc, jc, kv_bits=4)


def test_whisper_decode_raises_when_the_cache_is_full():
    jcfg, cfg, jp, tp = _models("whisper-base")
    _, tc = _prefill(jcfg, cfg, jp, tp, _batch(cfg, 7))
    with pytest.raises(ValueError, match="full"):
        W.decode_step(tp, cfg, tc, torch.zeros((B, 1), dtype=torch.long))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_get_model_builds_and_serves_every_config(arch):
    """Every configuration builds from the port's own init on the CPU, and
    prefill and two decode steps give finite logits."""
    cfg = configs.get_config(arch, smoke=True)
    mb = api.get_model(cfg)
    assert (mb.init_cache is None) == (cfg.family == "audio")
    params = mb.init(0, device="cpu")
    batch = _tb(_batch(cfg, 8), "labels")
    with torch.no_grad():
        logits, cache = mb.prefill(params, batch)
        cache = _pad(cache, 2, _tpad)
        for _ in range(2):
            logits, cache = mb.decode_step(
                params, cache, torch.zeros((B, 1), dtype=torch.long))
    assert logits.shape == (B, cfg.vocab)
    assert torch.isfinite(logits).all()


# --- the serving engine ---------------------------------------------------


@pytest.mark.parametrize("arch", ("mamba2-1.3b", "hymba-1.5b"))
def test_serve_engine_gives_repro_greedy_tokens(arch):
    """2 slots, 4 requests with refills and different prompt lengths: the
    conv/SSM state of each prefill goes into its slot (and Hymba's K/V
    beside it).  Every request's greedy tokens equal JAX's engine's."""
    jcfg, cfg, jp, tp = _models(arch)
    g = np.random.default_rng(0)
    prompts = [g.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 5, 9)]
    news = (6, 3, 7, 4)
    jeng = jengine.ServeEngine(jcfg, jp, jengine.EngineConfig(slots=2,
                                                              max_len=32))
    eng = engine.ServeEngine(cfg, tp, engine.EngineConfig(slots=2,
                                                          max_len=32),
                             device="cpu")
    for uid, (p, n) in enumerate(zip(prompts, news)):
        jeng.add_request(jengine.Request(uid=uid, prompt=p,
                                         max_new_tokens=n))
        eng.add_request(engine.Request(uid=uid, prompt=p, max_new_tokens=n))
    jstats = jeng.run_until_done()
    stats = eng.run_until_done()
    assert stats["generated_tokens"] == jstats["generated_tokens"] == 20
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert set(eng.cache) >= {"conv", "ssm"}
    for uid in range(4):
        assert eng.done[uid].output == jeng.done[uid].output


def test_serve_engine_refuses_the_audio_family_as_repro_does():
    jcfg, cfg, jp, tp = _models("whisper-base")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        jengine.ServeEngine(jcfg, jp, jengine.EngineConfig())
    with pytest.raises(NotImplementedError, match="decoder-only"):
        engine.ServeEngine(cfg, tp, engine.EngineConfig(), device="cpu")
    # the decoder-only module sends the family to models/whisper.py
    with pytest.raises(NotImplementedError, match="whisper"):
        T.init(0, cfg, device="cpu")


# --- conversion -----------------------------------------------------------


@pytest.mark.parametrize("arch", ("whisper-base", "granite-moe-3b-a800m"))
def test_convert_round_trip(arch):
    """JAX's tree -> the port's per-layer lists -> JAX's stacked layout,
    unchanged: whisper's two layer stacks, MoE's stacked experts."""
    jcfg = jconfigs.get_config(arch, smoke=True)
    want = jax.tree.map(np.asarray,
                        japi.get_model(jcfg).init(jax.random.PRNGKey(1)))
    tp = convert.lm_params_from_numpy(want, device="cpu")
    if arch == "whisper-base":
        assert len(tp["enc_layers"]) == jcfg.encdec.n_layers
        assert len(tp["dec_layers"]) == jcfg.n_layers
        assert "xattn" in tp["dec_layers"][0]
    else:
        e, d, f = jcfg.moe.n_experts, jcfg.d_model, jcfg.moe.d_ff_expert
        assert tuple(tp["layers"][0]["mlp"]["wi"].shape) == (e, d, f)
    back = convert.lm_params_to_numpy(tp)
    wflat = jax.tree_util.tree_flatten_with_path(want)[0]
    bflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in wflat] == [p for p, _ in bflat]
    for (path, w), (_, b) in zip(wflat, bflat):
        assert b.dtype == w.dtype and b.shape == w.shape
        np.testing.assert_array_equal(b, w, err_msg=str(path))
