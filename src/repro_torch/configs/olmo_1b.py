"""olmo-1b — dense, non-parametric LayerNorm.  [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=8192, vocab=50304,
    norm="nonparam_ln", act="silu", ffn="glu",
)

SMOKE = ArchConfig(
    name="olmo-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=256, vocab=256,
    norm="nonparam_ln", act="silu", ffn="glu", dtype="float32",
)
