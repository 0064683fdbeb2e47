"""gemma2-2b — local/global alternating attention + logit softcaps.
[arXiv:2408.00118; hf].  head_dim=256 per the public config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv=4, d_ff=9216, vocab=256000,
    head_dim=256, norm="rmsnorm", act="gelu", ffn="glu",
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sliding_window=4096, local_global_period=2, post_block_norms=True,
    attn_scale=256.0**-0.5,  # query_pre_attn_scalar = head_dim
)

SMOKE = ArchConfig(
    name="gemma2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=160, vocab=256,
    head_dim=16, norm="rmsnorm", act="gelu", ffn="glu",
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sliding_window=16, local_global_period=2, post_block_norms=True,
    attn_scale=16.0**-0.5, dtype="float32",
)
