"""Architecture registry: the 10 assigned architectures (``--arch <id>``)
plus the paper's own models.  ``get_config(name)`` returns the full-size
:class:`repro.models.config.ModelConfig`; ``get_reduced(name)`` the CPU
smoke-test variant of the same family.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced as _reduced

# arch id -> module (one file per assigned architecture).
_MODULES = {
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl_72b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    try:
        mod = importlib.import_module(_MODULES[name])
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(_MODULES)}")
    return mod.CONFIG


def get_reduced(name: str, **overrides) -> ModelConfig:
    return _reduced(get_config(name), **overrides)


def all_configs() -> dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}
