"""Jamba-v0.1 52B: Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer. [arXiv:2403.19887; hf]

Block period = lcm(attn_every=8, moe_every=2) = 8: one attention layer (at
offset 4, matching the released config) + 7 Mamba layers per period, MoE FFN
on odd slots.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='jamba-v0.1-52b', family='hybrid',
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=65536, head_dim=128,
    rope_theta=10_000.0,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8, attn_offset=4, ssm_kind='mamba',
    d_state=16, d_conv=4, expand=2,
)
