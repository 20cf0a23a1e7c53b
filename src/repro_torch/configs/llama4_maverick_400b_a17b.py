"""Llama-4 Maverick 400B-A17B: MoE 128e top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

MoE on every other layer with a shared expert reproduces the published
400B-total / 17B-active split (DESIGN.md): 24 MoE layers × 128 experts ×
3·d·d_ff ≈ 386B routed + ~14B dense/attn; active = top-1 + shared + dense.
Early fusion refers to the multimodal frontend, which is outside the assigned
backbone scope.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='llama4-maverick-400b-a17b', family='moe',
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    rope_theta=500_000.0,
    n_experts=128, top_k=1, moe_every=2, shared_expert=True,
    # §Perf: bf16 master params at 100B+ (Adafactor's factored state
    # keeps the update math f32; halves FSDP-gather + grad-reduce bytes)
    param_dtype='bfloat16',
)
