"""Model configuration: the port's copy of ``repro/models/config.py``.

One dataclass describes every architecture family of the reference, field
for field, so that a config made here compares equal (``dataclasses.asdict``)
to the reference's: dense GQA transformers, MoE, M-RoPE vision-language
backbones, encoder-decoders, Mamba/attention hybrids and RWKV-6, all of
which the port serves (``repro_torch/models/``).

``fsdp`` and ``seq_shard`` do nothing in the port yet: it runs on one
card. ``remat`` (with ``scan_layers``, as in the reference) checkpoints
each block in a training pass; the port keeps one weight dict per block
whatever ``scan_layers`` says.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Family = Literal['dense', 'vlm', 'moe', 'audio', 'hybrid', 'ssm']


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int                 # query heads; 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    mrope: bool = False                       # Qwen2-VL 3-axis rotary
    mrope_sections: tuple[int, int, int] = (16, 24, 24)   # t/h/w pairs, sums to hd/2

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1            # MoE FFN on layers with (i % moe_every == moe_every-1)
    shared_expert: bool = False   # Llama-4-style always-on expert
    router_aux_coef: float = 0.01

    # hybrid / SSM
    attn_every: int = 1           # attention on layers with (i % attn_every == attn_offset)
    attn_offset: int = 0
    ssm_kind: Literal['mamba', 'rwkv6', None] = None
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    # encoder-decoder
    n_enc_layers: int = 0         # > 0 ⇒ enc-dec (decoder depth = n_layers)
    cross_len: int = 4096         # encoder length assumed during decode shapes

    # frontend: False ⇒ inputs are precomputed embeddings (audio frames /
    # vision patches), the modality frontend is a stub per the assignment.
    embed_inputs: bool = True

    act: str = 'silu'
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # numerics / distribution
    param_dtype: str = 'float32'
    compute_dtype: str = 'bfloat16'
    fsdp: bool = True             # ZeRO-3-style param sharding over the data axis
    seq_shard: bool = True        # Megatron-SP: residual stream S-sharded over 'model'
    remat: str = 'full'           # 'none' | 'full' | 'dots'
    scan_layers: bool = True      # stack layer params, lax.scan over depth
    attn_chunk: int = 1024        # online-softmax q/kv chunking threshold+size
    use_pallas: bool = False      # the hand-written kernels (RMSNorm, flash);
                                  # the name is the reference's

    # ------------------------------------------------------------------ derived
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a lane-aligned multiple of 128 (Megatron-style);
        pad logits are masked to -inf so the math is unchanged."""
        return int(math.ceil(self.vocab_size / 128) * 128)

    @property
    def group_size(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.ssm_kind == 'rwkv6'

    @property
    def block_period(self) -> int:
        """Scan block period: lcm of the per-layer-kind cycles."""
        return math.lcm(max(self.attn_every, 1), max(self.moe_every, 1))

    @property
    def subquadratic(self) -> bool:
        """True iff decode-time state is o(S²): SSM / hybrid families."""
        return self.family in ('ssm', 'hybrid')

    def layer_kinds(self) -> list[tuple[str, str]]:
        """[(mixer, ffn)] per layer within one scan block:
        mixer ∈ {attn, mamba, rwkv}, ffn ∈ {dense, moe}."""
        kinds = []
        for i in range(self.block_period):
            if self.ssm_kind == 'rwkv6':
                mixer = 'rwkv'
            elif self.ssm_kind == 'mamba' and i % self.attn_every != self.attn_offset:
                mixer = 'mamba'
            else:
                mixer = 'attn'
            ffn = 'moe' if (self.n_experts > 0
                            and i % self.moe_every == self.moe_every - 1) else 'dense'
            kinds.append((mixer, ffn))
        return kinds

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.block_period == 0, \
            f'{self.name}: n_layers {self.n_layers} % period {self.block_period} != 0'
        return self.n_layers // self.block_period

    # parameter counts (for MODEL_FLOPS and memory budgeting)
    def param_count(self, active_only: bool = False) -> int:
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        total = 0
        emb = self.padded_vocab * d
        total += emb * (1 if (self.tie_embeddings or not self.embed_inputs) else 2)
        if not self.embed_inputs:
            total += emb  # output head only; input embeddings replaced by stub

        def attn_params():
            return d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d \
                + (self.qkv_bias and (self.n_heads + 2 * self.n_kv_heads) * hd or 0)

        def dense_ffn():
            return 3 * d * f

        def moe_ffn(active):
            routed = self.top_k if active else self.n_experts
            p = routed * 3 * d * f + d * self.n_experts  # experts + router
            if self.shared_expert:
                p += 3 * d * f
            return p

        def mamba_params():
            di, ds = self.d_inner, self.d_state
            return (d * 2 * di            # in_proj (x and z)
                    + di * self.d_conv    # depthwise conv
                    + di * (2 * ds + 1)   # B,C,dt projections (x-dependent)
                    + di * ds + di        # A_log, D
                    + di * d)             # out_proj

        def rwkv_params():
            # time-mix (r,k,v,o,gate ≈ 5d²) incl. decay LoRA + channel-mix (2df + d²)
            return 5 * d * d + 2 * d * f

        for (mixer, ffn) in self.layer_kinds():
            n_such = self.n_layers // self.block_period
            if mixer == 'attn':
                total += attn_params() * n_such
            elif mixer == 'mamba':
                total += mamba_params() * n_such
            else:  # rwkv blocks bundle their channel-mix FFN
                total += rwkv_params() * n_such
                continue
            if ffn == 'dense':
                total += dense_ffn() * n_such
            else:
                total += moe_ffn(active_only) * n_such
        if self.is_encdec:
            # encoder layers: attention + dense FFN + cross-attn in decoder
            total += self.n_enc_layers * (attn_params() + dense_ffn())
            total += self.n_layers * attn_params()  # cross-attention
        return int(total)

    def reduced(self, **overrides) -> 'ModelConfig':
        """Tiny same-family config for CPU smoke tests."""
        hd = 16
        small = dict(
            n_layers=self.block_period * 2,
            d_model=64,
            n_heads=0 if self.n_heads == 0 else 4,
            n_kv_heads=0 if self.n_kv_heads == 0 else 2,
            head_dim=hd,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_enc_layers=2 if self.is_encdec else 0,
            cross_len=16,
            d_state=4,
            d_conv=4,
            attn_chunk=32,
            # t/h/w frequency sections scale with head_dim (sum = hd/2)
            mrope_sections=(hd // 8, 3 * hd // 16, 3 * hd // 16),
            param_dtype='float32',
            compute_dtype='float32',
            name=self.name + '-smoke',
            fsdp=False,
            remat='none',
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
