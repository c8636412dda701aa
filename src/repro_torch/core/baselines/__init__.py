"""The paper's comparison baselines (§V.D): FedAvg, FedProx, FedPD and
SCAFFOLD, on the flat dense single-device round (counterparts of
`repro/core/baselines/`)."""
