"""FedGiA on PyTorch and CUDA: the port of the `repro` JAX package.

Same sub-layout and module names as `repro`, so each module's counterpart
is found by path. Plain functions on tensors, dicts of tensors for
parameters and state, an explicit `device`, explicit `torch.Generator`s
for model weights and the reference's threefry keys for every mask and
clock draw (`core/prng.py`). Entry points run on `cuda` unless the
caller passes `device="cpu"`; on the CPU every hand-written kernel is
replaced by its plain PyTorch version.
"""
