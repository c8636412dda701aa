"""The port's hand-written CUDA kernels, each with its plain version."""
from __future__ import annotations

import importlib

KERNELS = ("fedgia_update", "flash_attention", "rwkv6_scan")


def launch_counters():
    """The `launches` dict of each kernel's wrapper module (imported on
    first use: the wrappers import this package's `_build`), then
    `fedgia_update`'s launches by anchor form."""
    mods = [importlib.import_module(f"repro_torch.kernels.{k}.ops")
            for k in KERNELS]
    return [mod.launches for mod in mods] + [mods[0].anchor_forms]
