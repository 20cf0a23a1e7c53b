"""The model zoo: every family of the reference (dense GQA, MoE, M-RoPE
vision-language backbones, encoder-decoder, Mamba/attention hybrids and
RWKV-6).

``build_model(cfg, device=None)`` returns a :class:`Model` whose ``init``
draws random parameters on the model's device (the card unless the caller
asks for ``device='cpu'``) and whose ``forward`` runs where the parameters
lie (``transformer.train_loss`` is the training loss, of every family).
``init_cache`` makes a zeroed decode cache on the model's device and
``decode_step`` feeds it one token per sequence. An encoder-decoder's
``encode`` runs the encoder and ``fill_cross_cache`` writes its output's
K and V into a cache; both are None for the other families, as the
reference's ``encode`` is.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models import transformer

__all__ = ['ModelConfig', 'Model', 'build_model']


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    forward: Callable
    decode_step: Callable
    encode: Callable | None = None
    fill_cross_cache: Callable | None = None

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``cfg.param_dtype`` from a seeded
        ``torch.Generator`` on the model's device."""
        return transformer.init_params(self.cfg, generator, self.device)

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype | None = None) -> dict:
        """A zeroed decode cache for ``batch`` sequences of up to
        ``max_len`` tokens on the model's device."""
        return transformer.init_cache(self.cfg, batch, max_len, dtype,
                                      self.device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    encdec = cfg.is_encdec
    return Model(cfg=cfg, device=resolve_device(device),
                 forward=functools.partial(transformer.forward, cfg),
                 decode_step=functools.partial(transformer.decode_step, cfg),
                 encode=(functools.partial(transformer.encode, cfg)
                         if encdec else None),
                 fill_cross_cache=(functools.partial(
                     transformer.fill_cross_cache, cfg) if encdec else None))
