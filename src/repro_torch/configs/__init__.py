"""Configuration schema of the port and the model zoo's ported configs."""

from repro_torch.configs.base import ArchConfig, FedConfig, SSMConfig

_ARCH_MODULES = {
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen1.5-4b": "qwen1_5_4b",
}

ARCH_NAMES = ("tiny",) + tuple(_ARCH_MODULES)


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


__all__ = ["ArchConfig", "FedConfig", "SSMConfig", "ARCH_NAMES",
           "get_config"]
