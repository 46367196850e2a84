"""Configuration schema of the port."""

from repro_torch.configs.base import ArchConfig, FedConfig

__all__ = ["ArchConfig", "FedConfig"]
