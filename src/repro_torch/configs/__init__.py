"""Architecture registry: get_config(name) / get_smoke_config(name).

The port registers every model architecture of ``repro.configs``: the
dense GQA configs, MLA (minicpm3-4b), MLA with sort-dispatch MoE
(deepseek-v2-lite-16b), sliding-window MoE (mixtral-8x7b), Mamba-1
(falcon-mamba-7b), the Mamba/attention/MoE hybrid (jamba-1.5-large-398b)
and the cross-attention architectures: the VLM llama-3.2-vision-11b and
the encoder-decoder seamless-m4t-medium, which ``model.prefill`` and
``model.decode_step`` serve with a context (the engine serves none).
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
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "seamless-m4t-medium": "seamless_m4t_medium",
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
