"""Device resolution for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU with
``device='cpu'``. With no card and no explicit device it raises: the port
never drops to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the first CUDA device (raises when there is none); any
    other value → ``torch.device(value)``.

    On a CUDA device TF32 is switched off for matmuls and convolutions: the
    reference accumulates in IEEE f32, and TF32 keeps about three decimal
    digits, which the parity tolerances (1e-5 on contractions) do not allow.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                'port on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda':
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
