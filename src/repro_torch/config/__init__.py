from repro_torch.config.base import ALGORITHMS, FedConfig, ModelConfig
