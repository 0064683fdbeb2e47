"""whisper-base — enc-dec, conv frontend stubbed to frame embeddings.
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    norm="layernorm", act="gelu", ffn="mlp",
    encdec=EncDecConfig(n_layers=6),
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
    norm="layernorm", act="gelu", ffn="mlp",
    encdec=EncDecConfig(n_layers=2), dtype="float32",
)
