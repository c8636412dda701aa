"""The paper's experiment runners on the port (counterparts of the
top-level `benchmarks/` package's Table IV and Fig. 1-2 runners)."""
