"""Config registry: the assigned architectures and the paper's 12-app suite
(:mod:`.paper_suite`).

The port builds and serves every architecture here (see
:mod:`repro_torch.models.model`)."""
from __future__ import annotations

from importlib import import_module

_ARCH_IDS = (
    "stablelm_3b",
    "qwen2_5_14b",
    "smollm_360m",
    "mistral_nemo_12b",
    "internvl2_76b",
    "zamba2_7b",
    "falcon_mamba_7b",
    "mixtral_8x22b",
    "kimi_k2_1t_a32b",
    "whisper_large_v3",
)

ARCH_ALIASES = {a.replace("_", "-"): a for a in _ARCH_IDS}
# canonical CLI ids (match the assignment list)
ARCH_IDS = tuple(sorted(ARCH_ALIASES))


def get_config(arch: str):
    """Load an architecture config by CLI id (e.g. 'qwen2.5-14b')."""
    key = arch.replace(".", "_").replace("-", "_")
    if key not in _ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_ALIASES)}")
    return import_module(f"{__name__}.{key}").CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_ALIASES}
