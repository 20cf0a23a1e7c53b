"""Llama-3.1 405B: dense GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='llama3-405b', family='dense',
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256, head_dim=128,
    rope_theta=500_000.0,
    # §Perf: bf16 master params at 100B+ (Adafactor's factored state
    # keeps the update math f32; halves FSDP-gather + grad-reduce bytes)
    param_dtype='bfloat16',
)
