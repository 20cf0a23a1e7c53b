"""Serving steps: the port of ``repro/launch/steps.py``'s prefill on one
card, without a mesh or sharding specs.

  prefill_step(params, batch) → logits of the last position (B, V_padded)

``serve_params`` casts the floating parameters to bf16, as the reference's
serving load does (``_param_sds(serve=True)``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree_util import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import check_ported, forward


def serve_params(params):
    """Floating leaves → bf16; other leaves unchanged."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.is_floating_point() else x, params)


def build_prefill_step(cfg: ModelConfig, device=None) -> Callable:
    """``prefill_step(params, batch)``: ``forward`` over ``batch['inputs']``
    (B, S) tokens, moved to the step's device (the card unless
    ``device='cpu'``), under ``torch.inference_mode()``; returns the
    next-token logits ``logits[:, -1, :]`` as a tensor of its own."""
    check_ported(cfg)
    device = resolve_device(device)

    def prefill_step(params: dict, batch: dict) -> torch.Tensor:
        with torch.inference_mode():
            logits, _ = forward(cfg, params, batch['inputs'].to(device),
                                positions=batch.get('positions'))
            return logits[:, -1, :].clone()

    return prefill_step
