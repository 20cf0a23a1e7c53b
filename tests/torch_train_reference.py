"""The reference's side of the training tests of the encoder-decoder,
M-RoPE/embedding-input and MoE families (``tests/test_torch_train_*.py``):
their ``reduced()`` configs in f32, the reference's parameters, batches
in ``make_batch_sds``'s layout filled with numpy from a seed, and an
adapter that lets the reference's MoE HVP run under ``jax.vmap``.

The reference's MoE products go through ``_rdot`` (``lax.ragged_dot``
with a custom VJP). Its forward-over-reverse HVP runs for one column, but
``jax.vmap`` of it raises ``NotImplementedError: ragged_dot vmap over any
dim but 0`` (jax 0.9.0), and ``extract_columns`` vmaps its columns.
:func:`serial_columns` wraps an HVP in ``jax.custom_batching.custom_vmap``
with a rule that maps it over the batch with ``jax.lax.map`` (a scan, no
vmap), so ``extract_columns`` and ``NystromIHVP.prepare`` run unchanged
on it. The JAX package is not edited."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import to_torch
from repro_torch.launch.steps import N_DOMAINS, make_batch_sds

ENCDEC, MROPE = 'seamless_m4t_large_v2', 'qwen2_vl_7b'
MOE = ['phi35_moe_42b_a66b', 'llama4_maverick_400b_a17b']
FAMILIES = [ENCDEC, MROPE] + MOE
BATCH, SEQ = 2, 24


def configs(arch: str):
    """(the reference's, the port's) ``reduced()`` config: f32, remat
    off."""
    return jget_config(arch).reduced(), get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def reference_params(arch: str) -> dict:
    """``init(PRNGKey(0))`` of the reduced config, as numpy (stacked
    blocks)."""
    return jax.tree.map(np.asarray, jbuild_model(configs(arch)[0]).init(
        jax.random.PRNGKey(0)))


def vision_ids(B: int, S: int, seed: int) -> np.ndarray:
    """(B, 3, S) int32 (t, h, w) ids: a run of text, a 4 × 4 image grid
    whose h and w ids differ from t, then text again, as Qwen2-VL lays
    them out (``tests/test_torch_mrope.py``)."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((B, 3, S), np.int32)
    for b in range(B):
        start = rng.randint(2, S // 4)
        side = 4
        n = side * side
        ids[b, :, :start] = np.arange(start)
        ids[b, 0, start:start + n] = start
        ids[b, 1, start:start + n] = start + np.repeat(np.arange(side), side)
        ids[b, 2, start:start + n] = start + np.tile(np.arange(side), side)
        ids[b, :, start + n:] = start + side + np.arange(S - start - n)
    return ids


def numpy_batch(arch: str, seed: int, batch: int = BATCH, seq: int = SEQ,
                domain: bool = False) -> dict:
    """A batch in ``make_batch_sds``'s layout drawn with numpy from
    ``seed``: tokens and labels in the vocabulary, a mask with about a
    fifth of the positions off, bf16 embeddings and frames (numpy's
    ``bfloat16``, so both packages read the same values), M-RoPE ids
    with an image grid; with ``domain``, the hypergradient step's domains
    in [0, N_DOMAINS)."""
    cfg = configs(arch)[1]
    rng = np.random.RandomState(seed)
    out = {}
    for name, sds in make_batch_sds(cfg, batch, seq).items():
        shape = tuple(sds.shape)
        if name == 'positions':
            out[name] = vision_ids(batch, seq, seed)
        elif name == 'mask':
            out[name] = (rng.rand(*shape) < 0.8).astype(np.float32)
        elif sds.dtype.is_floating_point:
            out[name] = rng.randn(*shape).astype(ml_dtypes.bfloat16)
        else:
            out[name] = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    if domain:
        out['domain'] = rng.randint(0, N_DOMAINS, batch).astype(np.int32)
    return out


def both(batch: dict):
    """(the reference's, the port's) copy of a numpy batch."""
    return jax.tree.map(jnp.asarray, batch), to_torch(batch)


def serial_columns(hvp):
    """``hvp`` under ``jax.custom_batching.custom_vmap``: a vmap of it maps
    the batch axis with ``jax.lax.map`` instead."""
    @jax.custom_batching.custom_vmap
    def f(v):
        return hvp(v)

    @f.def_vmap
    def rule(axis_size, in_batched, v):
        v = jax.tree.map(
            lambda x, b: x if b else jnp.broadcast_to(x, (axis_size,)
                                                      + x.shape),
            v, in_batched[0])
        out = jax.lax.map(hvp, v)
        return out, jax.tree.map(lambda _: True, out)

    return f
