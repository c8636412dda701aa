from repro_torch.sharding.specs import (
    P,
    cache_specs,
    fed_state_specs,
    param_specs,
    sanitize_specs,
    serve_token_specs,
    shard_shape,
    train_batch_specs,
)
