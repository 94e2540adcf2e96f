"""Architecture registry: --arch <id> resolution for the archs the port
serves: qwen2-0.5b, falcon-mamba-7b, gemma-7b and zamba2-2.7b.

The reference knows ten archs (repro/configs/registry.py). An arch it
knows that the port does not serve yet raises NotImplementedError naming
it as not yet ported; it never falls back to another arch.
"""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (falcon_mamba_7b, gemma_7b, qwen2_0_5b,
                                zamba2_2_7b)
from repro_torch.configs.base import ModelConfig

_MODULES = [qwen2_0_5b, falcon_mamba_7b, gemma_7b, zamba2_2_7b]

ARCH_IDS = [m.ARCH_ID for m in _MODULES]

# The reference's archs that wait for a later slice (ROADMAP.md, open
# items, queue 1 item 15.3: musicgen-large; 15.4: the archs that do not
# fit one card in float32).
NOT_YET_PORTED = (
    "qwen3-moe-30b-a3b", "qwen3-32b", "llama4-scout-17b-a16e",
    "moonshot-v1-16b-a3b", "llava-next-34b", "musicgen-large",
)

_FULL: Dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.make_config for m in _MODULES}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {
    m.ARCH_ID: m.make_smoke_config for m in _MODULES}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    table = _SMOKE if smoke else _FULL
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch (ROADMAP.md, "
            f"queue 1 items 15.3-15.4); ported: {ARCH_IDS}")
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(table)}")
    return table[arch]()
