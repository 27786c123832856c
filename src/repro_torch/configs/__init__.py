from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    LayerSpec,
    MLASpec,
    MambaSpec,
    MoESpec,
    get_config,
    list_configs,
    register_config,
    shape_applicable,
)

__all__ = [
    "SHAPES",
    "ArchConfig",
    "LayerSpec",
    "MLASpec",
    "MambaSpec",
    "MoESpec",
    "get_config",
    "list_configs",
    "register_config",
    "shape_applicable",
]
