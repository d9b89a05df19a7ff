from repro_torch.configs.base import (ARCH_IDS, PAPER_ARCH, SHAPES,
                                      ModelConfig, RunConfig, ShapeConfig,
                                      TrainConfig, get_model_config,
                                      supported_shapes)

__all__ = [
    "ARCH_IDS", "PAPER_ARCH", "SHAPES", "ModelConfig", "RunConfig",
    "ShapeConfig", "TrainConfig", "get_model_config", "supported_shapes",
]
