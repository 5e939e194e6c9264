"""Model configurations: the reference package's ``ModelConfig`` tree and
registry, copied (``get_config`` imports ``repro_torch.configs.<arch>``)."""

from .base import ModelConfig, get_config, list_archs

__all__ = ["ModelConfig", "get_config", "list_archs"]
