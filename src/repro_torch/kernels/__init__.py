"""The port's hand-written CUDA kernels, each with its plain version."""
from __future__ import annotations

import contextlib
import importlib

KERNELS = ("fedgia_update", "flash_attention", "rwkv6_scan")

# None, or hook(name, fn, args, kwargs) returning fn's result: run around
# each kernel's plain version (its wrapper's path for a CPU tensor) and
# the models' plain recurrences, by name; `launch/dryrun.py` sets it
_plain_hook = None


def run_plain(name: str, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, the plain computation `name`
    ("fedgia_update", "flash_attention", "rwkv6_scan", or the models'
    "wkv6_scan" and "ssm_scan"), through the hook where one is set."""
    if _plain_hook is None:
        return fn(*args, **kwargs)
    return _plain_hook(name, fn, args, kwargs)


@contextlib.contextmanager
def plain_hook(hook):
    """Within the block, `run_plain` calls go through `hook`."""
    global _plain_hook
    prev, _plain_hook = _plain_hook, hook
    try:
        yield
    finally:
        _plain_hook = prev


def launch_counters():
    """The `launches` dict of each kernel's wrapper module (imported on
    first use: the wrappers import this package's `_build`), then
    `fedgia_update`'s launches by anchor form."""
    mods = [importlib.import_module(f"repro_torch.kernels.{k}.ops")
            for k in KERNELS]
    return [mod.launches for mod in mods] + [mods[0].anchor_forms]
