"""Architecture registry of the port: all ten of the reference's
architectures, which its serving and training paths run: dense GQA,
RWKV-6, MoE/MLA, the hybrid attention + SSM block, and the embeds
input modes of the audio and VLM configs (counterpart of
`repro/configs/__init__.py`).

Usage:  from repro_torch.configs import get_config
        cfg = get_config("tinyllama-1.1b")
"""
from __future__ import annotations

from repro_torch.config import ModelConfig
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.deepseek_67b import CONFIG as _ds67
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.hymba_15b import CONFIG as _hymba
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava
from repro_torch.configs.musicgen_large import CONFIG as _musicgen
from repro_torch.configs.qwen15_05b import CONFIG as _qwen
from repro_torch.configs.rwkv6_3b import CONFIG as _rwkv6
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.tinyllama_11b import CONFIG as _tinyllama

ARCHITECTURES = {c.name: c for c in [_arctic, _rwkv6, _qwen, _stablelm,
                                     _musicgen, _tinyllama, _llava, _ds67,
                                     _hymba, _dsv3]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


def list_architectures():
    return sorted(ARCHITECTURES)
