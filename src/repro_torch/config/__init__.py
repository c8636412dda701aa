from repro_torch.config.base import FedConfig, ModelConfig
