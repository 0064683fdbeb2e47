"""paligemma-3b — SigLIP(stub) + gemma decoder, MQA kv=1, prefix-LM over
256 image-patch embeddings.  [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384, vocab=257216,
    head_dim=256, norm="rmsnorm", act="gelu", ffn="glu",
    vision_prefix_len=256,
)

SMOKE = ArchConfig(
    name="paligemma-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=160, vocab=256,
    head_dim=16, norm="rmsnorm", act="gelu", ffn="glu",
    vision_prefix_len=8, dtype="float32",
)
