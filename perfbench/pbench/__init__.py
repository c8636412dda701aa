"""The benchmark's own library: the yardstick (traffic, reference,
formulas, trace reduction, comparison) and the harness that drives the
port. Nothing here imports JAX or the JAX package; the reference modules
import nothing of the port either."""
