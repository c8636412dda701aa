from repro_torch.data.synthetic import (
    linreg_noniid,
    logreg_data,
    make_client_batches,
    to_torch,
)
from repro_torch.data.tokens import synthetic_batch_for, synthetic_lm_batches
