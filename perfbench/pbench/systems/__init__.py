"""The systems under test, one module a configuration kind (a
configuration file's "system" key names it). Each builds the port's
objects from the benchmark's inputs and knows how the reference recomputes
the same rounds."""
