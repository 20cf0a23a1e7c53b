"""The model zoo, ported family by family: the dense GQA transformer so far.

``build_model(cfg, device=None)`` returns a :class:`Model` whose ``init``
draws random parameters on the model's device (the card unless the caller
asks for ``device='cpu'``) and whose ``forward`` runs where the parameters
lie (``transformer.train_loss`` is the training loss). Decode is not
ported yet.
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

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters in ``cfg.param_dtype`` from a seeded
        ``torch.Generator`` on the model's device."""
        return transformer.init_params(self.cfg, generator, self.device)


def build_model(cfg: ModelConfig, device=None) -> Model:
    transformer.check_ported(cfg)
    return Model(cfg=cfg, device=resolve_device(device),
                 forward=functools.partial(transformer.forward, cfg))
