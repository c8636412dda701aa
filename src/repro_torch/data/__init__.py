from repro_torch.data.synthetic import (
    linreg_noniid,
    logreg_data,
    make_client_batches,
    to_torch,
)
