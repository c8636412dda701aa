"""Architecture registry of the port: the dense GQA, RWKV-6 and MoE/MLA
architectures that its serving and training paths run (counterpart of
`repro/configs/__init__.py`; the hybrid and multimodal configs are
ROADMAP queue 1 item 7b).

Usage:  from repro_torch.configs import get_config
        cfg = get_config("tinyllama-1.1b")
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.deepseek_67b import CONFIG as _ds67
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.qwen15_05b import CONFIG as _qwen
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.tinyllama_11b import CONFIG as _tinyllama

ARCHITECTURES = {c.name: c for c in [_arctic, _rwkv6, _qwen, _stablelm,
                                     _tinyllama, _ds67, _dsv3]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def list_architectures():
    return sorted(ARCHITECTURES)
