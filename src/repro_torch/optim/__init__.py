from repro_torch.optim.optimizers import adam, apply_updates, sgd
from repro_torch.optim.schedules import constant, cosine, paper_lr
