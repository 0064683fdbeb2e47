"""The port's cell roofline, ``perf`` and ``pipeline_dryrun`` against
JAX's.

* ``exact_flops`` at every arch's smoke config and every kind of step
  (train, prefill, decode; B=2, S=64), against JAX's ``exact_flops`` on
  JAX's step, both given the same config and shape.  Matmul FLOPs are
  counted apart (``mm``/``bmm``/``addmm``/``baddbmm`` against
  ``dot_general``) and must match exactly, except where the two graphs
  hold other products, each named below; the rest are "1 flop per
  output element" of different op sets (jaxpr equations against ATen
  ops: JAX charges ``reshape``, ``transpose``, ``broadcast_in_dim``,
  ``convert_element_type``, ``select_n``, ``add_any``; the port charges
  ``_to_copy``, ``clone``, ``_unsafe_view``, ``copy_`` and the plain
  decode attention's casts and copies of the whole cache).  Totals:
  within 5% for train and prefill, 25% for decode (measured: -4.03% to
  -0.07%, and -19.7% to +16.2%).  Products that differ:

  - decode: JAX embeds the new token with a one-hot contraction,
    ``2 * B * vocab * d`` FLOPs (the port gathers); whisper gathers in
    both;
  - the SSD chunk loop's backward (mamba2, hymba train): JAX's
    ``lax.scan`` transpose runs products the port's autograd does not
    (2.1% of mamba2's matmul FLOPs, 0.5% of hymba's), within 3%.

* olmo-1b ``train_4k`` and ``prefill_32k`` at full size against JAX's
  ``exact_flops``: matmul FLOPs equal, totals within 0.5% (measured
  -0.08% and -0.11%).
* ``depth_differential`` and ``roofline_cell`` with both packages'
  ``run_cell_cfg`` and ``exact_flops`` replaced by the same stubs: every
  field equal but the three times, which differ by the ratio of the
  packages' constants (H100 against TPU v5e), and the bottleneck and
  fraction that follow from them.
* ``perf``'s parser and ``cfg_override`` for every flag against JAX's,
  each in a subprocess (JAX's module forces 512 host devices, the port's
  hints start a fake group), ``roofline_cell`` stubbed on both sides.
* ``pipeline_dryrun``'s record at gemma2-2b's smoke config: each stage's
  received bytes exactly the GPipe schedule's activations and
  gradients, JAX's formula fields from JAX's own config.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.configs.base import ShapeConfig as JShape
from repro.perfmodel import flops as JF
from repro.perfmodel import roofline as JR
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.perfmodel import flops as TF
from repro_torch.perfmodel import roofline as TR

ROOT = Path(__file__).resolve().parents[1]


# --- exact_flops -------------------------------------------------------------


def _jax_dot_flops(jaxpr, mult=1.0) -> float:
    """``dot_general`` FLOPs of a jaxpr, with JAX's counter's walk."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            total += JF._dot_flops(eqn) * mult
        elif prim == "scan":
            total += _jax_dot_flops(eqn.params["jaxpr"].jaxpr,
                                    mult * int(eqn.params["length"]))
        elif prim == "while":
            total += _jax_dot_flops(eqn.params["body_jaxpr"].jaxpr, mult)
        elif prim == "cond":
            bs = eqn.params["branches"]
            total += sum(_jax_dot_flops(b.jaxpr, mult / len(bs)) for b in bs)
        else:
            total += sum(_jax_dot_flops(s, mult)
                         for s in JF._sub_jaxprs(eqn.params))
    return total


def _counts(monkeypatch, arch, kind, *, smoke=True, batch=2, seq=64,
            shape_name=None):
    """(JAX's total, JAX's matmul FLOPs, the port's total, its matmul
    FLOPs) of ``exact_flops`` for one cell, both packages given the same
    config and shape."""
    jcfg, tcfg = JC.get_config(arch, smoke=smoke), TC.get_config(arch,
                                                                 smoke=smoke)
    name = shape_name or "cell"
    if shape_name is None:
        monkeypatch.setattr(JC, "SHAPES", {name: JShape(name, seq, batch,
                                                        kind)})
        monkeypatch.setattr(TC, "SHAPES", {name: TShape(name, seq, batch,
                                                        kind)})
    monkeypatch.setattr(JC, "get_config", lambda a, smoke=False: jcfg)
    monkeypatch.setattr(TC, "get_config", lambda a, smoke=False: tcfg)
    seen = {}

    def jcount(fn, *args, **kw):
        jaxpr = jax.make_jaxpr(fn, **kw)(*args)
        seen["jdots"] = _jax_dot_flops(jaxpr.jaxpr)
        return JF.count_jaxpr(jaxpr.jaxpr)

    class Counter(TF._FlopCounter):
        def charge(self, func, args, out):
            f = TF._op_flops(func, args, out)
            self.total += f
            if func.overloadpacket in TF._MATMULS:
                seen["tdots"] = seen.get("tdots", 0) + f

    monkeypatch.setattr(JF, "count_fn_flops", jcount)
    monkeypatch.setattr(TF, "_FlopCounter", Counter)
    jt = JR.exact_flops(arch, name)
    tt = TR.exact_flops(arch, name)
    return jt, seen["jdots"], tt, seen["tdots"]


ARCHS = tuple(JC.ARCH_IDS)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_exact_flops_against_jax_at_smoke_config(monkeypatch, arch, kind):
    jt, jdots, tt, tdots = _counts(monkeypatch, arch, kind)
    cfg = TC.get_config(arch)
    if kind == "decode" and cfg.family != "audio":
        assert tdots == jdots - 2 * 2 * cfg.vocab * cfg.d_model
    elif kind == "train" and cfg.ssm is not None:
        assert abs(tdots - jdots) <= 0.03 * jdots
    else:
        assert tdots == jdots
    limit = 0.25 if kind == "decode" else 0.05
    assert abs(tt - jt) <= limit * jt, (tt, jt, (tt - jt) / jt)


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_exact_flops_against_jax_at_full_size(monkeypatch, shape_name):
    jt, jdots, tt, tdots = _counts(monkeypatch, "olmo-1b", None,
                                   smoke=False, shape_name=shape_name)
    assert tdots == jdots
    assert abs(tt - jt) <= 0.005 * jt, (tt, jt, (tt - jt) / jt)


# --- depth_differential and roofline_cell on stub records --------------------


def _stub_record(depth):
    return {"ok": True, "hbm_bytes_est": 1e9 * (1 + depth),
            "bytes_per_device": 3e9 * depth,
            "collective_bytes": {"all-gather": 2e8 * depth,
                                 "reduce-scatter": 1e8,
                                 "total": 2e8 * depth + 1e8}}


@pytest.fixture
def stubbed(monkeypatch):
    """Both packages' ``run_cell_cfg`` and ``exact_flops`` replaced by the
    same stubs (JAX's dry-run module sets ``XLA_FLAGS`` on import: kept
    to this test)."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as JD
    from repro_torch.launch import dryrun as TD

    def run_cell_cfg(cfg, arch, shape_name, **kw):
        depth = cfg.n_layers if cfg is not None else 0
        return _stub_record(depth)

    for mod in (JD, TD):
        monkeypatch.setattr(mod, "run_cell_cfg", run_cell_cfg)
    for mod in (JR, TR):
        monkeypatch.setattr(mod, "exact_flops", lambda *a, **k: 4.2e18)


def test_depth_differential_against_jax(stubbed):
    j = JR.depth_differential("olmo-1b", "train_4k")
    t = TR.depth_differential("olmo-1b", "train_4k")
    assert j == t
    assert t["bytes_per_device"] == 2e9 + 15 * 1e9


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_roofline_cell_against_jax(stubbed, shape_name, multi_pod):
    j = JR.roofline_cell("olmo-1b", shape_name, multi_pod=multi_pod)
    t = TR.roofline_cell("olmo-1b", shape_name, multi_pod=multi_pod)
    times = ("compute_s", "memory_s", "collective_s")
    derived = ("bottleneck", "step_s_lower_bound", "roofline_fraction")
    assert {k: v for k, v in t.items() if k not in times + derived} == \
        {k: v for k, v in j.items() if k not in times + derived}
    assert t["chips"] == (512 if multi_pod else 256)
    ratios = {"compute_s": JR.PEAK_FLOPS / TR.PEAK_FLOPS,
              "memory_s": JR.HBM_BW / TR.HBM_BW,
              "collective_s": JR.LINK_BW / TR.LINK_BW}
    for k in times:
        assert t[k] == pytest.approx(j[k] * ratios[k], rel=1e-12)
    terms = [t[k] for k in times]
    assert t["bottleneck"] == TR.pick_bottleneck(*terms)
    assert t["step_s_lower_bound"] == max(terms)
    assert t["roofline_fraction"] == pytest.approx(terms[0] / max(terms))


# --- perf.py -----------------------------------------------------------------

PERF_ARGS = [
    ["--arch", "olmo-1b", "--shape", "decode_32k", "--tag", "t"],
    ["--arch", "olmo-1b", "--shape", "decode_32k", "--tag", "t",
     "--quant-bits", "4", "--kv-bits", "4", "--hypothesis", "h", "--force"],
    ["--arch", "olmo-1b", "--shape", "train_4k", "--tag", "s",
     "--serve-sharding", "--spiking-ffn"],
    ["--arch", "mamba2-1.3b", "--shape", "prefill_32k", "--tag", "c",
     "--ssd-chunk", "128"],
    ["--arch", "hymba-1.5b", "--shape", "prefill_32k", "--tag", "cp",
     "--attn-cp"],
    ["--arch", "granite-moe-3b-a800m", "--shape", "train_4k", "--tag", "m",
     "--moe-dense", "--moe-buf-shard", "data,,model,"],
]

_PERF_RUN = """
    import dataclasses, json, sys
    from pathlib import Path
    pkg = sys.argv[1]
    P = __import__(pkg + ".launch.perf", fromlist=["main"])
    R = __import__(pkg + ".perfmodel.roofline", fromlist=["roofline_cell"])
    shd = __import__(pkg + ".distributed.sharding", fromlist=["set_variant"])
    Ly = __import__(pkg + ".models.layers", fromlist=["set_attention_cp"])
    MOE = __import__(pkg + ".models.moe", fromlist=["set_buffer_hint"])
    P.LOG = Path(sys.argv[2]) / (pkg + ".jsonl")
    out = []
    for argv in json.loads(sys.argv[3]):
        shd.set_variant("train")
        Ly.set_attention_cp()
        MOE.set_buffer_hint(None)
        got = {}

        def roofline_cell(arch, shape, **kw):
            cfg = kw.pop("cfg_override")
            got.update(arch=arch, shape=shape, kw=kw,
                       cfg=None if cfg is None else repr(cfg))
            return {"ok": True, "compute_s": 1.0, "memory_s": 2.0,
                    "collective_s": 0.5, "bottleneck": "memory",
                    "step_s_lower_bound": 2.0}

        R.roofline_cell = roofline_cell
        sys.argv = ["perf"] + argv
        P.main()
        got["variant"] = shd.get_variant()
        got["cp"] = [Ly._ATTN_CP["hint"] is not None, Ly._ATTN_CP["q_chunk"]]
        got["moe_hint"] = MOE._BUF_HINT is not None
        got["log"] = json.loads(P.LOG.read_text().splitlines()[-1])
        out.append(got)
    print(json.dumps(out))
"""


def test_perf_flags_and_cfg_override_against_jax(tmp_path):
    def run(pkg, env):
        out = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(_PERF_RUN), pkg,
             str(tmp_path), json.dumps(PERF_ARGS)], capture_output=True,
            text=True, timeout=180, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src"), **env})
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    j = run("repro", {"JAX_PLATFORMS": "cpu"})
    t = run("repro_torch", {})
    assert len(t) == len(PERF_ARGS)
    for argv, a, b in zip(PERF_ARGS, j, t):
        # the configs' reprs name each package's own classes alike
        assert b == a, argv
    assert t[4]["cp"] == [True, 256] and t[5]["moe_hint"]
    assert t[2]["variant"] == "serve"
    assert "kv_cache_bits=4" in t[1]["cfg"]


# --- pipeline_dryrun ---------------------------------------------------------


def test_pipeline_record_at_a_smoke_dense_rmsnorm_config():
    from repro_torch.launch import pipeline_dryrun as PD

    code = """
        import dataclasses, json, sys
        from repro_torch.configs import get_config
        from repro_torch.launch import pipeline_dryrun as PD
        cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                                  remat="dots")
        print(json.dumps(PD.stage_record(cfg, 4, int(sys.argv[1]))))
    """
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for r in PD.STAGE_RANKS]
    stages = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            assert p.returncode == 0, err[-3000:]
            stages.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    cfg = dataclasses.replace(TC.get_config("gemma2-2b", smoke=True),
                              remat="dots")
    rec = PD.pipeline_record("gemma2-2b", cfg, 4, stages)
    assert [s["stage"] for s in stages] == [0, 1]
    assert [s["layers"] for s in stages] == [[0, 1], [1, 2]]
    # each stage receives, for each of 4 microbatches of 256/16/4 rows x
    # 4096 tokens x d, the activations (stage 1) or their gradient
    # (stage 0), in the model's dtype
    act = 4 * (256 // 16 // 4) * 4096 * cfg.d_model * \
        torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    for s in stages:
        assert s["collective_bytes"]["collective-permute"] == act
        assert s["collective_bytes"]["all-reduce"] > 0
    assert rec["inter_pod_bytes"] == 2 * act
    jcfg = JC.get_config("gemma2-2b", smoke=True)
    assert rec["dp_alternative_inter_pod_bytes"] == 2 * jcfg.n_params() * 4
    assert rec["inter_pod_reduction"] == 2 * jcfg.n_params() * 4 / (2 * act)
    assert rec["bubble_fraction"] == 1 / 5
    assert rec["cell"] == "gemma2-2b__train_4k__pipeline_pod2x16x16"
    with pytest.raises(SystemExit):
        PD._config("olmo-1b")          # nonparam_ln
    with pytest.raises(SystemExit):
        PD._config("mamba2-1.3b")      # not dense
