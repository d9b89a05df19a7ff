from repro_torch.configs.base import (ARCH_IDS, MULTI_POD, PAPER_ARCH, SHAPES,
                                      SINGLE_POD, MeshConfig, ModelConfig,
                                      RunConfig, ShapeConfig, TrainConfig,
                                      get_model_config, resolve,
                                      supported_shapes)

__all__ = [
    "ARCH_IDS", "MULTI_POD", "PAPER_ARCH", "SHAPES", "SINGLE_POD",
    "MeshConfig", "ModelConfig", "RunConfig", "ShapeConfig", "TrainConfig",
    "get_model_config", "resolve", "supported_shapes",
]
