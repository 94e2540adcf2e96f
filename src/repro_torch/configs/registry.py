"""Architecture registry: --arch <id> resolution for the reference's ten
archs (repro/configs/registry.py): qwen2-0.5b, falcon-mamba-7b, gemma-7b,
zamba2-2.7b, musicgen-large, qwen3-moe-30b-a3b, moonshot-v1-16b-a3b,
llama4-scout-17b-a16e, qwen3-32b and llava-next-34b. An unknown name
raises KeyError; it never falls back to another arch.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (falcon_mamba_7b, gemma_7b,
                                llama4_scout_17b_a16e, llava_next_34b,
                                moonshot_v1_16b_a3b, musicgen_large,
                                qwen2_0_5b, qwen3_32b, qwen3_moe_30b_a3b,
                                zamba2_2_7b)
from repro_torch.configs.base import ModelConfig

_MODULES = [qwen2_0_5b, falcon_mamba_7b, gemma_7b, zamba2_2_7b,
            musicgen_large, qwen3_moe_30b_a3b, moonshot_v1_16b_a3b,
            llama4_scout_17b_a16e, qwen3_32b, llava_next_34b]

ARCH_IDS = [m.ARCH_ID for m in _MODULES]

# The reference's archs that wait for a later slice: none since the
# mixture-of-experts family was ported (ROADMAP.md queue 1 item 15.4).
NOT_YET_PORTED: tuple = ()

_FULL: Dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.make_config for m in _MODULES}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.make_smoke_config for m in _MODULES}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = _SMOKE if smoke else _FULL
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(table)}")
    return table[arch]()
