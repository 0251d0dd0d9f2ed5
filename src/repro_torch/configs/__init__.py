"""Architecture registry: get_config(name) / get_smoke_config(name).

The port registers the architectures whose serving path it carries: the
dense GQA configs, MLA (minicpm3-4b), MLA with sort-dispatch MoE
(deepseek-v2-lite-16b), sliding-window MoE (mixtral-8x7b), Mamba-1
(falcon-mamba-7b) and the Mamba/attention/MoE hybrid
(jamba-1.5-large-398b); the cross-attention architectures of
``repro.configs`` follow with their model code.
"""

from importlib import import_module

from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "starcoder2-3b": "starcoder2_3b",
    "minicpm3-4b": "minicpm3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mixtral-8x7b": "mixtral_8x7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

ARCH_NAMES = list(_MODULES)


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _load(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _load(name).SMOKE
