from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    latest_step,
    load_checkpoint,
    load_extra,
    save_checkpoint,
)
