"""Architecture registry: ``--arch <id>`` resolves here.

Each module exposes ``full()`` and ``smoke()``. ``smoke()`` is a reduced
same-family config that runs a real forward/train step on CPU.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    # assigned pool (10)
    "yi-9b": "yi_9b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "musicgen-medium": "musicgen_medium",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "zamba2-7b": "zamba2_7b",
    "xlstm-125m": "xlstm_125m",
    # the paper's own evaluation models (approx public configs)
    "nemo8b": "nemo8b",
    "qwen30b-a3b": "qwen30b_a3b",
}


def list_archs(include_paper: bool = False):
    pool = list(_ARCH_MODULES)
    return pool if include_paper else pool[:10]


def _mod(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str):
    return _mod(name).full()


def get_smoke_config(name: str):
    return _mod(name).smoke()
