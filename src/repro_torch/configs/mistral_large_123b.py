"""Mistral-Large-2407 123B: dense GQA. [hf:mistralai/Mistral-Large-Instruct-2407; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='mistral-large-123b', family='dense',
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab_size=32768, head_dim=128,
    rope_theta=1_000_000.0,
    # §Perf: bf16 master params at 100B+ (Adafactor's factored state
    # keeps the update math f32; halves FSDP-gather + grad-reduce bytes)
    param_dtype='bfloat16',
)
