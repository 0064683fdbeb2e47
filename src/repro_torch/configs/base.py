"""Unified architecture config.

One config dataclass drives every assigned architecture plus the paper's
own SNN models.  The L-SPINE feature surface (multi-precision quantized
execution, optional spiking FFN) is part of the config, so any arch can
select it — the "unified datapath" made a framework-level property.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.quant.formats import PrecisionConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # run every expert on every token and gate-combine (no dispatch
    # scatter/gather).  E/top_k x more FLOPs but ZERO dispatch
    # communication — wins whenever the cell is collective-bound
    # (see EXPERIMENTS.md §Perf cell B).
    force_dense: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder config for enc-dec archs (whisper).  Frontend is a stub:
    input_specs provide precomputed frame embeddings."""
    n_layers: int = 6
    frontend_downsample: int = 2  # whisper conv stem stride product (stub)


@dataclasses.dataclass(frozen=True)
class SpikingConfig:
    """L-SPINE spiking execution of FFN blocks (beyond-paper for LMs)."""
    timesteps: int = 4
    leak_shift: int = 3
    threshold: float = 1.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense|moe|hybrid|vlm|ssm|audio|snn-cnn
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None   # default d_model // n_heads
    norm: str = "rmsnorm"            # rmsnorm|layernorm|nonparam_ln
    act: str = "silu"                # silu|gelu
    ffn: str = "glu"                 # glu|mlp
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = True

    # gemma2-style features
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_period: int = 0     # 0 = all global; 2 = alternate local/global
    post_block_norms: bool = False   # gemma2 post-attn/post-ffn norms
    attn_scale: Optional[float] = None  # query_pre_attn_scalar override

    # hybrid (hymba): parallel attention + SSM heads per layer; global attn
    # only at a few layers, sliding-window elsewhere
    hybrid_parallel_ssm: bool = False
    global_attn_layers: Tuple[int, ...] = ()

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None

    # vlm: number of image-patch embedding tokens prefixed (stub frontend),
    # with prefix-LM (bidirectional) masking over the prefix
    vision_prefix_len: int = 0

    # --- the paper's technique ------------------------------------------
    precision: PrecisionConfig = PrecisionConfig(bits=16)  # 16 = bf16 dense
    quant_mode: str = "fake"          # fake (QAT/dry-run) | packed (serve)
    # packed low-bit KV cache (the L-SPINE datapath applied to the dominant
    # HBM buffer of batched decode); 16 = bf16 cache
    kv_cache_bits: int = 16
    spiking: Optional[SpikingConfig] = None

    # numerics / scale
    dtype: str = "bfloat16"
    remat: str = "none"               # none|dots|full

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads and self.n_kv and self.n_heads % self.n_kv:
            raise ValueError(f"{self.name}: n_heads % n_kv != 0")

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path available (SSM / hybrid local+SSM)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, L = self.d_model, self.n_layers
        hd = self.head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            din = s.d_inner(d)
            nh = s.n_heads(d)
            per = (
                d * (2 * din + 2 * s.n_groups * s.d_state + nh)  # in_proj
                + din * d                                        # out_proj
                + (din + 2 * s.n_groups * s.d_state) * s.conv_width
                + 3 * nh + 2 * d + din                           # A, D, dt_b, norms
            )
            return emb + L * per
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        if self.moe is not None:
            n_ff_mats = 3 if self.ffn == "glu" else 2
            ffn = self.moe.n_experts * n_ff_mats * d * self.moe.d_ff_expert
            ffn += self.moe.n_shared_experts * n_ff_mats * d * self.moe.d_ff_expert
            ffn += d * self.moe.n_experts  # router
        else:
            ffn = (3 if self.ffn == "glu" else 2) * d * self.d_ff
        per = attn + ffn + 4 * d
        if self.hybrid_parallel_ssm and self.ssm is not None:
            s = self.ssm
            din = s.d_inner(d)
            nh = s.n_heads(d)
            per += d * (2 * din + 2 * s.n_groups * s.d_state + nh) + din * d
        total = emb + L * per
        if self.encdec is not None:
            total += self.encdec.n_layers * (attn + ffn + 4 * d)
        return total

    def active_params(self) -> int:
        """Active (per-token) params — MoE counts only routed experts."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        n_ff_mats = 3 if self.ffn == "glu" else 2
        dense_ffn = self.moe.top_k * n_ff_mats * d * self.moe.d_ff_expert
        dense_ffn += self.moe.n_shared_experts * n_ff_mats * d * self.moe.d_ff_expert
        hd = self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv * hd) * 2
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return emb + L * (attn + dense_ffn + 4 * d)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                 # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
