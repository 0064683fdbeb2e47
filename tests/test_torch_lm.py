"""The LM serving path of the port: configs, ``packed_qmatmul``,
``kv_attention``, ``models/layers.py``, ``models/transformer.py`` (dense
families; the others are in test_torch_families.py), ``models/api.py``,
``serve/engine.py``, ``launch/serve.py`` and the LM side of
``convert.py``.

Inputs come from numpy seeds (or from JAX params converted with
``convert``) and go through ``repro`` on its default ``jnp`` backend and
through the port on the CPU, where each kernel wrapper runs its plain
version.  Smoke configs run in float32.  Tolerances, each with its
reason:

* packed words, scales of weights, dequantized weights, quantized KV
  from the same input: bit-exact (the same float32 operations);
* float32 results of a contraction (qmatmul, attention, whole-model
  logits): ``atol`` of 1e-5 on values of magnitude ~1, since XLA and
  PyTorch sum in other orders (~1e-7 relative per sum) and ``pow``,
  ``exp``, ``tanh`` may differ in the last ulp;
* packed KV words written by the models: their inputs already differ in
  the last bits, so a code may flip at a .5 tie; at most 1% of the words
  may differ (0 at these seeds);
* greedy tokens of the serving engine: identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.kernels.kv_attention import ref as jkv
from repro.kernels.packed_qmatmul import ref as jqmm
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant.formats import PrecisionConfig as JPC
from repro.quant.formats import QuantizedTensor as JQT
from repro.quant.ptq import quantize as jquantize
from repro.serve import engine as jengine
from repro_torch import configs, convert
from repro_torch.kernels.kv_attention import ops as kv_ops
from repro_torch.kernels.kv_attention import ref as kv_ref
from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
from repro_torch.kernels.packed_qmatmul import ref as qmm_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.quant.ptq import quantize
from repro_torch.serve import engine

ATOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# --- configs ----------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_repro(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for smoke in (True, False):
        got = dataclasses.asdict(configs.get_config(arch, smoke=smoke))
        want = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
        assert got == want
    assert configs.supported_shapes(arch) == jconfigs.supported_shapes(arch)


def test_geometry_flags_and_unknown_arch():
    import argparse

    ap = argparse.ArgumentParser()
    configs.add_geometry_flags(ap)
    assert ap.parse_args([]).smoke and not ap.parse_args(["--full"]).smoke
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


# --- packed_qmatmul -----------------------------------------------------------


@pytest.mark.parametrize("bits,gs,k", [(2, -1, 64), (4, -1, 72), (8, -1, 40),
                                       (4, 16, 64), (2, 32, 96),
                                       (8, 8, 48)])
def test_qmatmul_plain_matches_repro(bits, gs, k):
    g = np.random.default_rng(bits * 100 + k)
    w = (g.standard_normal((24, k)) * 0.1).astype(np.float32)
    x = g.standard_normal((2, 3, k)).astype(np.float32)
    jqt = jquantize(jnp.asarray(w), JPC(bits=bits, group_size=gs))
    qt = quantize(_t(w), PrecisionConfig(bits=bits, group_size=gs))
    np.testing.assert_array_equal(qt.data.numpy(), np.asarray(jqt.data))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(qmm_ref.dequant_w(qt).numpy(),
                                  np.asarray(jqmm.dequant_w(jqt)))
    want = np.asarray(jqmm.qmatmul_ref(jnp.asarray(x), jqt))
    got = qmm_ops.qmatmul(_t(x), qt)
    assert got.shape == (2, 3, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_qmatmul_keeps_the_input_dtype_and_takes_zero_points_on_cpu():
    w = torch.randn(16, 32)
    qt = quantize(w, PrecisionConfig(bits=4, symmetric=False))
    x = torch.randn(3, 32, dtype=torch.bfloat16)
    y = qmm_ops.qmatmul(x, qt)
    assert y.dtype == torch.bfloat16
    want = (x.float() @ qmm_ref.dequant_w(qt).T).to(torch.bfloat16)
    assert torch.equal(y, want)


# --- kv_attention -------------------------------------------------------------


@pytest.mark.parametrize("bits", (2, 4, 8))
def test_quantize_kv_matches_repro(bits):
    x = np.random.default_rng(bits).standard_normal((2, 5, 3, 32)).astype(
        np.float32)
    jp, js = jkv.quantize_kv(jnp.asarray(x), bits)
    p, s = kv_ref.quantize_kv(_t(x), bits)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        kv_ref.dequantize_kv(p, s, bits, 32).float().numpy(),
        _np(jkv.dequantize_kv(jp, js, bits, 32)))


@pytest.mark.parametrize("bits,window,cap,lens", [
    (4, 0, None, (40, 17)), (2, 8, None, (40, 33)), (8, 0, 20.0, (9, 40)),
    (4, 6, 30.0, (40, 1))])
def test_quant_kv_decode_attention_plain_matches_repro(bits, window, cap,
                                                       lens):
    """Tolerance 2e-3: both round each probability to bfloat16 before the
    weighted sum; a last-ulp difference in the float32 softmax can move a
    probability to the neighbouring bfloat16 value (2^-9 relative)."""
    g = np.random.default_rng(bits + window)
    b, s, kh, grp, hd = 2, 40, 2, 3, 16
    q = g.standard_normal((b, 1, kh * grp, hd)).astype(np.float32)
    k = g.standard_normal((b, s, kh, hd)).astype(np.float32)
    v = g.standard_normal((b, s, kh, hd)).astype(np.float32)
    kp, ks = kv_ref.quantize_kv(_t(k), bits)
    vp, vs = kv_ref.quantize_kv(_t(v), bits)
    kw = dict(bits=bits, scale=hd ** -0.5, window=window, logit_cap=cap)
    want = jkv.quant_kv_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp.numpy()), jnp.asarray(ks.numpy()),
        jnp.asarray(vp.numpy()), jnp.asarray(vs.numpy()),
        cache_len=jnp.asarray(lens, jnp.int32), **kw)
    got = kv_ops.quant_kv_decode_attention(
        _t(q), kp, ks, vp, vs, cache_len=torch.tensor(lens), **kw)
    assert got.shape == (b, 1, kh * grp, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-3, rtol=0)


# --- layers -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ("rmsnorm", "layernorm", "nonparam_ln"))
def test_norms_rope_softcap_and_acts_match_repro(kind):
    g = np.random.default_rng(0)
    x = g.standard_normal((2, 5, 3, 16)).astype(np.float32)
    p = {"g": (1 + 0.1 * g.standard_normal(16)).astype(np.float32),
         "b": (0.1 * g.standard_normal(16)).astype(np.float32)}
    p = {"rmsnorm": {"g": p["g"]}, "layernorm": p, "nonparam_ln": {}}[kind]
    np.testing.assert_allclose(
        L.apply_norm(kind, {k: _t(v) for k, v in p.items()}, _t(x)).numpy(),
        _np(JL.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x))), atol=ATOL, rtol=0)
    pos = np.arange(3, 8, dtype=np.int32)
    np.testing.assert_allclose(
        L.rope(_t(x), _t(pos), 10000.0).numpy(),
        _np(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(L.softcap(_t(x) * 40, 30.0).numpy(),
                               _np(JL.softcap(jnp.asarray(x) * 40, 30.0)),
                               atol=ATOL * 30, rtol=0)
    for act in ("silu", "gelu"):
        np.testing.assert_allclose(L.act_fn(act)(_t(x)).numpy(),
                                   _np(JL.act_fn(act)(jnp.asarray(x))),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunked,window,cap", [
    (False, 0, None), (False, 5, 30.0), (True, 0, None), (True, 7, 20.0)])
def test_attention_matches_repro(chunked, window, cap):
    g = np.random.default_rng(window)
    q = g.standard_normal((2, 21, 4, 16)).astype(np.float32)
    k = g.standard_normal((2, 21, 2, 16)).astype(np.float32)
    v = g.standard_normal((2, 21, 2, 16)).astype(np.float32)
    kw = dict(scale=0.25, window=window, logit_cap=cap, chunked=chunked,
              q_chunk=8, kv_chunk=8)
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = L.attention(_t(q), _t(k), _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)
    lens = np.array([21, 9], np.int32)
    want = JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                               jnp.asarray(v), scale=0.25,
                               cache_len=jnp.asarray(lens), window=window,
                               logit_cap=cap)
    got = L.decode_attention(_t(q[:, :1]), _t(k), _t(v), scale=0.25,
                             cache_len=_t(lens), window=window,
                             logit_cap=cap)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=0)


def test_linear_branches_match_repro():
    g = np.random.default_rng(1)
    w = (g.standard_normal((32, 24)) * 0.2).astype(np.float32)
    b = g.standard_normal(24).astype(np.float32)
    x = g.standard_normal((3, 32)).astype(np.float32)
    pc = JPC(bits=4, group_size=8)
    tpc = PrecisionConfig(bits=4, group_size=8)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    tp = {"w": _t(w), "b": _t(b)}
    for mode_args in ((None, "fake"), ("pc", "fake"), ("pc", "packed")):
        jpc = pc if mode_args[0] else None
        ppc = tpc if mode_args[0] else None
        np.testing.assert_allclose(
            L.linear(tp, _t(x), ppc, mode_args[1]).numpy(),
            _np(JL.linear(jp, jnp.asarray(x), jpc, mode_args[1])),
            atol=ATOL, rtol=0)
    jq = {"w": jquantize(jnp.asarray(w.T), pc), "b": jnp.asarray(b)}
    tq = {"w": convert.quantized_from_numpy(
        jax.tree.map(np.asarray, jq["w"]), device="cpu"), "b": _t(b)}
    np.testing.assert_allclose(L.linear(tq, _t(x)).numpy(),
                               _np(JL.linear(jq, jnp.asarray(x))),
                               atol=ATOL, rtol=0)


# --- the model ----------------------------------------------------------------


def _jax_pack(params, pc):
    """Every linear of a JAX LM param tree as a packed QuantizedTensor,
    per layer, stacked along the layer axis (the pytree keeps the
    per-layer logical shape)."""
    def pack(w):
        qs = [jquantize(w[i].T, pc) for i in range(w.shape[0])]
        return JQT(jnp.stack([q.data for q in qs]),
                   jnp.stack([q.scale for q in qs]), None, qs[0].shape,
                   pc.bits, pc.group_size)

    lay = dict(params["layers"])
    for block in ("attn", "mlp"):
        lay[block] = {k: {**v, "w": pack(v["w"])}
                      for k, v in lay[block].items()}
    return {**params, "layers": lay}


def _torch_pack(params, pc):
    """The same with the port's quantize, on the port's per-layer params."""
    out = dict(params)
    out["layers"] = [
        {**lp, **{blk: {k: {**v, "w": quantize(v["w"].T.float(), pc)}
                        for k, v in lp[blk].items()}
                  for blk in ("attn", "mlp")}}
        for lp in params["layers"]]
    return out


def _models(arch, kv_bits=16, packed=True):
    jcfg = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                               kv_cache_bits=kv_bits)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              kv_cache_bits=kv_bits)
    jp = JT.init(jax.random.PRNGKey(0), jcfg)
    if packed:
        jp = _jax_pack(jp, JPC(bits=4))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jcfg, cfg, jp, tp


def _pad_cache(cache, max_len, pad):
    out = dict(cache)
    for k, v in cache.items():
        if k != "len":
            out[k] = pad(v, max_len - v.shape[2])
    return out


def _jpad(v, n):
    return jnp.pad(v, [(0, 0), (0, 0), (0, n)] + [(0, 0)] * (v.ndim - 3))


def _tpad(v, n):
    return torch.nn.functional.pad(v, (0, 0) * (v.ndim - 3) + (0, n))


@pytest.mark.parametrize("arch,kv_bits,packed,s_len", [
    ("olmo-1b", 4, True, 12),        # the slice's path: W4 + INT4 KV
    ("olmo-1b", 2, True, 7),
    ("gemma2-2b", 16, False, 24),    # sliding window (16) + soft caps
    ("stablelm-1.6b", 16, True, 9),  # layernorm, qkv bias, untied head
])
def test_prefill_and_uniform_decode_match_repro(arch, kv_bits, packed,
                                                s_len):
    jcfg, cfg, jp, tp = _models(arch, kv_bits, packed)
    g = np.random.default_rng(s_len)
    toks = g.integers(0, cfg.vocab, (2, s_len)).astype(np.int32)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tc = T.prefill(tp, cfg, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=0)
    assert set(tc) == set(jc)
    for key in tc:
        want, got = np.asarray(jc[key]), tc[key].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        if key in ("k", "v") and kv_bits != 16:
            assert (got != want).mean() <= 0.01       # counted: tie flips
        elif key != "len":
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    # decode from the prefill cache padded to max_len (JAX would clamp the
    # write of a full cache onto its last position; the port raises)
    max_len = s_len + 6
    jc = _pad_cache(jc, max_len, _jpad)
    tc = _pad_cache(tc, max_len, _tpad)
    for _ in range(4):
        tok = g.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(tok))
        tl, tc = T.decode_step(tp, cfg, tc, torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_port_packs_the_same_words_as_repro():
    """The chip check packs the port's own params with the port's
    quantize; at smoke size that gives JAX's words for JAX's weights."""
    _, cfg, jp, tp = _models("olmo-1b", packed=False)
    jq = jax.tree.map(np.asarray, _jax_pack(jp, JPC(bits=4)))
    tq = _torch_pack(tp, PrecisionConfig(bits=4))
    for i, lp in enumerate(tq["layers"]):
        for blk in ("attn", "mlp"):
            for name, lin in lp[blk].items():
                want = jq["layers"][blk][name]["w"]
                np.testing.assert_array_equal(lin["w"].data.numpy(),
                                              want.data[i])
                np.testing.assert_array_equal(lin["w"].scale.numpy(),
                                              want.scale[i])


def test_decode_raises_when_the_uniform_cache_is_full():
    _, cfg, _, tp = _models("olmo-1b", 4)
    _, cache = T.prefill(tp, cfg, torch.zeros((2, 5), dtype=torch.long))
    with pytest.raises(ValueError, match="full"):
        T.decode_step(tp, cfg, cache, torch.zeros((2, 1), dtype=torch.long))


def test_packed_kv_with_ragged_slots_is_guarded():
    """As in JAX (tests/test_kv_attention.py): continuous batching over a
    packed cache fails loudly instead of corrupting it."""
    _, cfg, _, tp = _models("olmo-1b", 4)
    cache = T.init_cache(cfg, 2, 32, device="cpu")
    cache["len"] = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ragged"):
        T.decode_step(tp, cfg, cache, torch.zeros((2, 1), dtype=torch.long),
                      ragged=True)


def test_init_matches_repro_shapes_and_scales():
    jcfg = jconfigs.get_config("olmo-1b", smoke=True)
    cfg = configs.get_config("olmo-1b", smoke=True)
    jp = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(0), jcfg))
    tp = T.init(0, cfg, device="cpu")
    assert tp["embed"].shape == jp["embed"].shape
    assert abs(float(tp["embed"].std()) - 0.02) < 0.002
    assert len(tp["layers"]) == cfg.n_layers
    for blk in ("attn", "mlp"):
        for name, lin in tp["layers"][0][blk].items():
            want = jp["layers"][blk][name]["w"]
            assert tuple(lin["w"].shape) == want.shape[1:]
            fan_in = lin["w"].shape[0]
            assert abs(float(lin["w"].std()) * fan_in ** 0.5
                       - 2 ** 0.5) < 0.15


def test_left_out_features_raise():
    """Nothing of the LM path is left out now: the context-parallel hint
    (``set_attention_cp``) forces the chunked path for more than
    ``q_chunk`` queries, sees its ``(B, nq, q_chunk, K, G, hd)`` query
    layout and, as JAX's, leaves the result as it was; no arguments
    remove it.  (Multi-rank CP: ``test_torch_distributed.py``.)"""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 4, 8), generator=g)
    k = torch.randn((2, 40, 2, 8), generator=g)
    v = torch.randn((2, 40, 2, 8), generator=g)
    plain = L.attention(q, k, v, scale=8 ** -0.5)
    seen = []
    L.set_attention_cp(hint=lambda x: seen.append(tuple(x.shape)) or x,
                       q_chunk=16, kv_chunk=8)
    try:
        hinted = L.attention(q, k, v, scale=8 ** -0.5)
    finally:
        L.set_attention_cp()
    assert seen == [(2, 3, 16, 2, 2, 8)]
    torch.testing.assert_close(hinted, plain, rtol=1e-5, atol=1e-6)
    assert L._ATTN_CP == {"hint": None, "q_chunk": None, "kv_chunk": None}
    L.attention(q, k, v, scale=8 ** -0.5)
    assert len(seen) == 1


# --- the serving engine -------------------------------------------------------


def test_serve_engine_gives_repro_greedy_tokens():
    """Packed W4 olmo smoke, bf16-layout (float32 here) KV, 2 slots, 4
    requests: continuous batching with ragged slots, refills and
    different prompt lengths.  Every request's greedy tokens equal JAX's
    engine's."""
    jcfg, cfg, jp, tp = _models("olmo-1b", 16, packed=True)
    g = np.random.default_rng(0)
    prompts = [g.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 5, 9)]
    news = (6, 3, 7, 4)
    jeng = jengine.ServeEngine(jcfg, jp, jengine.EngineConfig(slots=2,
                                                              max_len=32))
    eng = engine.ServeEngine(cfg, tp, engine.EngineConfig(
        slots=2, max_len=32, keep_logits=True), device="cpu")
    for uid, (p, n) in enumerate(zip(prompts, news)):
        jeng.add_request(jengine.Request(uid=uid, prompt=p,
                                         max_new_tokens=n))
        eng.add_request(engine.Request(uid=uid, prompt=p, max_new_tokens=n))
    jstats = jeng.run_until_done()
    stats = eng.run_until_done()
    assert stats["requests"] == jstats["requests"] == 4
    assert stats["generated_tokens"] == jstats["generated_tokens"] == 20
    assert stats["decode_steps"] == jstats["decode_steps"]
    assert not stats["incomplete"]
    for uid in range(4):
        assert eng.done[uid].output == jeng.done[uid].output
        lg = eng.done[uid].logits
        assert len(lg) == news[uid] and lg[0].shape == (cfg.vocab,)
        assert [int(np.argmax(x)) for x in lg] == eng.done[uid].output


def test_serve_engine_temperature_sampling_is_seeded():
    _, cfg, _, tp = _models("olmo-1b", 16, packed=True)
    outs = []
    for _ in range(2):
        eng = engine.ServeEngine(cfg, tp, engine.EngineConfig(
            slots=2, max_len=32, temperature=0.8, seed=3), device="cpu")
        for uid in range(3):
            eng.add_request(engine.Request(
                uid=uid, prompt=np.arange(4 + uid, dtype=np.int32),
                max_new_tokens=5))
        eng.run_until_done()
        outs.append([eng.done[u].output for u in range(3)])
    assert outs[0] == outs[1]
    assert all(0 <= t < cfg.vocab for o in outs[0] for t in o)


def test_launcher_serves_on_the_cpu():
    from repro_torch.launch import serve

    stats = serve.main(["--device", "cpu", "--requests", "3", "--slots",
                        "2", "--max-new", "3", "--quant-bits", "4"])
    assert stats["requests"] == 3 and stats["generated_tokens"] == 9
    assert not stats["incomplete"]
