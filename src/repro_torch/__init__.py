"""repro_torch — the PyTorch/CUDA port of ``repro`` (Nyström implicit
differentiation), for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing of
it, and nothing of JAX. Module names and public names follow the
reference's, so each counterpart is easy to find. Entry points run on the
card unless their caller passes ``device='cpu'``; the p-streaming
contractions of the Nyström apply run in hand-written CUDA kernels
(``repro_torch/csrc``) behind ``backend='cuda'``.
"""
