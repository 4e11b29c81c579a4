"""Architecture registry of the port.

``get_config(arch_id)`` returns the full-size config: a ModelConfig for
the dense LMs (``h2o-danube-3-4b``, ``gemma3-12b``, ``granite-3-8b``,
``starcoder2-7b``), and for ``paper-stream`` the paper's own case study
(``paper_stream.StreamCaseStudy``: STREAM over the bridge, not an LM).
``get_reduced(arch_id)`` returns the same-family smoke-test config of an LM
(``paper-stream`` has none); ``lm_archs()`` lists the registered LMs.  The
other architectures of the reference (MoE, recurrent, xLSTM, the
encoder-decoder and the vision-language model) come with the port's later
slices.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig, reduced

# in the reference's order
ARCH_IDS = ("h2o-danube-3-4b", "gemma3-12b", "granite-3-8b", "starcoder2-7b",
            "paper-stream")


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


def lm_archs() -> list[str]:
    return [a for a in ARCH_IDS if a != "paper-stream"]
