"""Architecture registry: --arch <id> resolves here."""
from . import (
    chameleon_34b,
    deepseek_67b,
    falcon_mamba_7b,
    llama3_405b,
    llama4_maverick_400b_a17b,
    moonshot_v1_16b_a3b,
    nemotron_4_340b,
    whisper_medium,
    yi_9b,
    zamba2_1_2b,
)
from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, smoke  # noqa: F401

ARCHS = {
    "llama3-405b": llama3_405b.CONFIG,
    "nemotron-4-340b": nemotron_4_340b.CONFIG,
    "yi-9b": yi_9b.CONFIG,
    "deepseek-67b": deepseek_67b.CONFIG,
    "llama4-maverick-400b-a17b": llama4_maverick_400b_a17b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "chameleon-34b": chameleon_34b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "zamba2-1.2b": zamba2_1_2b.CONFIG,
}

# long_500k requires sub-quadratic sequence mixing (assignment): only SSM /
# hybrid archs run it; pure full-attention archs skip (see DESIGN.md).
LONG_CONTEXT_ARCHS = {"falcon-mamba-7b", "zamba2-1.2b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cells():
    """All (arch, shape) dry-run cells incl. documented skips."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            skip = ""
            if shape.name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                skip = "full-attention arch: long_500k needs sub-quadratic mixing"
            out.append((arch, shape.name, skip))
    return out
