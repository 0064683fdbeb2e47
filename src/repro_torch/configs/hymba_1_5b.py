"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer; global
attention only at layers {0, mid, last}, 1k sliding window elsewhere.
[arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504, vocab=32001,
    norm="rmsnorm", act="silu", ffn="glu",
    hybrid_parallel_ssm=True, sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, n_groups=1),
)

SMOKE = ArchConfig(
    name="hymba-smoke", family="hybrid",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=256,
    norm="rmsnorm", act="silu", ffn="glu",
    hybrid_parallel_ssm=True, sliding_window=16, global_attn_layers=(0,),
    ssm=SSMConfig(d_state=8, expand=2, head_dim=16, n_groups=1,
                  chunk_size=32),
    dtype="float32",
)
