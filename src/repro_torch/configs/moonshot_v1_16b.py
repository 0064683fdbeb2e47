"""moonshot-v1-16b-a3b — Moonlight-style MoE 64e top-6, d_ff_expert=1408.
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv=16, d_ff=1408, vocab=163840,
    norm="rmsnorm", act="silu", ffn="glu", tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
)

SMOKE = ArchConfig(
    name="moonshot-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=96, vocab=256,
    norm="rmsnorm", act="silu", ffn="glu", tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96), dtype="float32",
)
