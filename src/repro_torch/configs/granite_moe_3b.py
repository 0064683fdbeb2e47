"""granite-moe-3b-a800m — fine-grained MoE 40e top-8, d_ff_expert=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
NOTE: assignment line says 40 experts; the hf card has 32 — we follow the
assignment (see DESIGN.md §Risks)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512, vocab=49155,
    norm="rmsnorm", act="silu", ffn="glu",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
)

SMOKE = ArchConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=64, vocab=256,
    norm="rmsnorm", act="silu", ffn="glu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64), dtype="float32",
)
