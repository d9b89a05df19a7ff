from repro_torch.configs.base import (ARCH_IDS, SHAPES, ModelConfig,
                                      RunConfig, ShapeConfig, TrainConfig,
                                      get_model_config)

__all__ = [
    "ARCH_IDS", "SHAPES", "ModelConfig", "RunConfig", "ShapeConfig",
    "TrainConfig", "get_model_config",
]
