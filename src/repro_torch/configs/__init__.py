"""Architecture registry of the port.

``get_config(arch_id)`` returns the full-size ModelConfig;
``get_reduced(arch_id)`` returns the same-family smoke-test config.  Only
``granite-3-8b`` is registered: the other architectures of the reference
come with the port's later slices (prefill and the other model families).
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig, reduced

ARCH_IDS = ("granite-3-8b",)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(
            f"arch {arch_id!r} is not ported yet (known: {ARCH_IDS}); the "
            f"other model families come with a later slice of the port")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
