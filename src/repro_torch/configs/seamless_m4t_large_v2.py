"""SeamlessM4T-large-v2: enc-dec, multimodal (audio frontend stubbed).
[arXiv:2308.11596; hf]

24 encoder + 24 decoder layers, d=1024, 16 heads (kv=16 ⇒ MHA), hd=64.
Decode shapes: decoder self-cache of seq_len, cross-attention to
cfg.cross_len=4096 precomputed encoder states.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name='seamless-m4t-large-v2', family='audio',
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206, head_dim=64,
    rope_theta=10_000.0,
    n_enc_layers=24, cross_len=4096,
    embed_inputs=False,
)
