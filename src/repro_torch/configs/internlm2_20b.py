"""internlm2-20b — dense GQA(kv=8), 48L/6144d.  [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=92544,
    norm="rmsnorm", act="silu", ffn="glu", tie_embeddings=False,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="internlm2-smoke", family="dense",
    n_layers=2, d_model=96, n_heads=6, n_kv=2, d_ff=256, vocab=256,
    norm="rmsnorm", act="silu", ffn="glu", tie_embeddings=False,
    dtype="float32",
)
