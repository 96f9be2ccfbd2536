"""Architecture registry of the port: ``get_config(arch_id)`` /
``reduced(arch_id)``. Lists only the architectures the port serves;
the rest of the reference's registry (``repro/configs``) follows as their
families are ported (ROADMAP.md)."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.common import ModelConfig

ARCH_IDS: List[str] = [
    "granite_3_2b",
    "llama2_7b",
    "llama2_13b",
    "minicpm_2b",
]


def canonical(arch: str) -> str:
    a = arch.replace("-", "_")
    if a not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; the port serves: {ARCH_IDS}")
    return a


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.config()


def reduced(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.reduced()
