"""Configuration schema of the port and the model zoo's ported configs."""

from repro_torch.configs.base import (ArchConfig, FedConfig, MLAConfig,
                                      MoEConfig, SSMConfig)
from repro_torch.configs.shapes import SHAPES, ShapeConfig

_ARCH_MODULES = {
    "gemma3-12b": "gemma3_12b",
    "mamba2-2.7b": "mamba2_2p7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-4b": "qwen1_5_4b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = ("tiny",) + tuple(_ARCH_MODULES)
# the reference's ids whose configs are not ported yet (ROADMAP.md Queue A
# item 5c)
NOT_PORTED_ARCHS = ("deepseek-v3-671b", "mistral-large-123b")


def get_config(name: str) -> ArchConfig:
    """An architecture by id: ``tiny`` (the training CLI's default LM) or
    one of the ported configs of the reference's registry."""
    import importlib
    if name == "tiny":
        from repro_torch.launch.train import tiny_lm_config
        return tiny_lm_config()
    try:
        mod = _ARCH_MODULES[name]
    except KeyError:
        raise ValueError(
            f"unknown arch {name!r}; choose from {sorted(ARCH_NAMES)}"
        ) from None
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = ["ArchConfig", "FedConfig", "MLAConfig", "MoEConfig", "SSMConfig",
           "SHAPES", "ShapeConfig", "ARCH_NAMES", "NOT_PORTED_ARCHS",
           "get_config"]
