from repro_torch.config.base import (ALGORITHMS, INPUT_SHAPES, FedConfig,
                                     ModelConfig, ShapeConfig)
