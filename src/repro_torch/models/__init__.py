from repro_torch.models.linear_models import (
    LeastSquares,
    LogisticRegression,
    NonConvexLogistic,
)
from repro_torch.models.transformer import Transformer
