"""Runnable examples of the port (counterparts of the top-level
`examples/`)."""
