"""Architecture registry: ``get_config(arch_id)`` and the shape suites.

The port's copy of ``repro/configs/__init__.py``: all ten architectures
of the reference, each equal field by field to its config there.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

#: the reference's architectures (``repro/configs/__init__.py``), all
#: served by the port (forward, prefill, decode)
ARCHS = [
    'llama3_405b', 'mistral_large_123b', 'yi_9b', 'qwen2_7b', 'qwen2_vl_7b',
    'llama4_maverick_400b_a17b', 'phi35_moe_42b_a66b', 'seamless_m4t_large_v2',
    'jamba_v01_52b', 'rwkv6_1b6',
]

# canonical external ids (hyphenated) → module names
ALIASES = {a.replace('_', '-'): a for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int


SHAPES = [
    ShapeSpec('train_4k', 'train', 4_096, 256),
    ShapeSpec('prefill_32k', 'prefill', 32_768, 32),
    ShapeSpec('decode_32k', 'decode', 32_768, 128),
    ShapeSpec('long_500k', 'decode', 524_288, 1),
]


def get_config(arch: str) -> ModelConfig:
    name = ALIASES.get(arch, arch)
    if name not in ARCHS:
        raise KeyError(f'unknown arch {arch!r}; known: {sorted(ALIASES)}')
    return importlib.import_module(f'repro_torch.configs.{name}').CONFIG
