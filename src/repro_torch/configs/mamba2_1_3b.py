"""mamba2-1.3b — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0, d_ff=0, vocab=50280,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1),
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv=0, d_ff=0, vocab=256,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1,
                  chunk_size=32),
    dtype="float32",
)
