"""The paper's experiment runners on the port (counterparts of the
top-level `benchmarks/` package's Table IV, Fig. 1-3, participation and
kernel runners)."""
