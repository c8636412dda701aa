from repro_torch.models.linear_models import (
    LeastSquares,
    LogisticRegression,
    NonConvexLogistic,
)
