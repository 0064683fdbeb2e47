"""stablelm-1.6b — dense, 24L, MHA-as-GQA(kv=32), LayerNorm + qkv bias.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=5632, vocab=100352,
    norm="layernorm", act="silu", ffn="glu", qkv_bias=True,
    tie_embeddings=False,
)

SMOKE = ArchConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=160, vocab=256,
    norm="layernorm", act="silu", ffn="glu", qkv_bias=True,
    tie_embeddings=False, dtype="float32",
)
