from repro_torch.utils.logging import get_logger
