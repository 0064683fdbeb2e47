"""Architecture registry: --arch <id> resolves here."""
from repro_torch.configs import (
    gemma2_2b,
    granite_moe_3b,
    hymba_1_5b,
    internlm2_20b,
    mamba2_1_3b,
    moonshot_v1_16b,
    olmo_1b,
    paligemma_3b,
    stablelm_1_6b,
    whisper_base,
)
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig

_MODULES = {
    "stablelm-1.6b": stablelm_1_6b,
    "olmo-1b": olmo_1b,
    "gemma2-2b": gemma2_2b,
    "internlm2-20b": internlm2_20b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "moonshot-v1-16b-a3b": moonshot_v1_16b,
    "hymba-1.5b": hymba_1_5b,
    "paligemma-3b": paligemma_3b,
    "mamba2-1.3b": mamba2_1_3b,
    "whisper-base": whisper_base,
}

ARCH_IDS = tuple(_MODULES)


def add_geometry_flags(ap) -> None:
    """The --smoke (default) / --full pair every launcher and benchmark
    shares; both write ``args.smoke``."""
    ap.add_argument("--smoke", dest="smoke", action="store_true",
                    default=True,
                    help="reduced model geometry (default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="paper-size model geometry")


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    m = _MODULES[arch_id]
    return m.SMOKE if smoke else m.CONFIG


# (arch, shape) support matrix: long_500k needs a sub-quadratic path —
# documented skips in DESIGN.md / EXPERIMENTS.md
def supported_shapes(arch_id: str) -> tuple:
    cfg = get_config(arch_id)
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return tuple(names)
