"""Qwen2-VL-7B backbone: M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only per the assignment: the vision frontend is a stub —
input_specs() feeds precomputed patch embeddings plus (t,h,w) position ids.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='qwen2-vl-7b', family='vlm',
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    mrope=True, mrope_sections=(16, 24, 24),
    embed_inputs=False,
)
