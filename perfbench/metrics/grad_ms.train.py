"""Device ms of the model's loss and gradients (`Transformer.loss`
under `api.per_client_value_and_grad`) in one eager round."""

from pbench.readers import split_us


def read(ctx):
    us = split_us(ctx, "gradient")
    return None if us is None else us / 1e3
