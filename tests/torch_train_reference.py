"""The reference's side of the training tests of the encoder-decoder,
M-RoPE/embedding-input, MoE and recurrent families
(``tests/test_torch_train_*.py``): their ``reduced()`` configs in f32
(Jamba at one period), the reference's parameters, batches in
``make_batch_sds``'s layout filled with numpy from a seed, an adapter that
lets the reference's MoE HVP run under ``jax.vmap``, and the Eq. 3
hypergradient assembled from the reference's pieces (:func:`eq3`).

The reference's MoE products go through ``_rdot`` (``lax.ragged_dot``
with a custom VJP). Its forward-over-reverse HVP runs for one column, but
``jax.vmap`` of it raises ``NotImplementedError: ragged_dot vmap over any
dim but 0`` (jax 0.9.0), and ``extract_columns`` vmaps its columns.
:func:`serial_columns` wraps an HVP in ``jax.custom_batching.custom_vmap``
with a rule that maps it over the batch with ``jax.lax.map`` (a scan, no
vmap), so ``extract_columns`` and ``NystromIHVP.prepare`` run unchanged
on it. The JAX package is not edited."""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.configs import get_config as jget_config
from repro.core import solvers
from repro.core.hvp import make_hvp
from repro.core.solvers import NystromIHVP
from repro.core.tree_util import PyTreeIndexer
from repro.launch.train import build_losses
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, to_torch
from repro_torch.core.tree_util import tree_flatten_with_path, tree_leaves
from repro_torch.launch.steps import N_DOMAINS, make_batch_sds

ENCDEC, MROPE = 'seamless_m4t_large_v2', 'qwen2_vl_7b'
MOE = ['phi35_moe_42b_a66b', 'llama4_maverick_400b_a17b']
FAMILIES = [ENCDEC, MROPE] + MOE
JAMBA, RWKV = 'jamba_v01_52b', 'rwkv6_1b6'
RECURRENT = [JAMBA, RWKV]
BATCH, SEQ = 2, 24
#: ``reduced()`` overrides: Jamba at one period (7 Mamba, 1 attention, 4
#: MoE FFNs) where ``reduced()`` gives two
CUTS = {JAMBA: dict(n_layers=8)}


def configs(arch: str):
    """(the reference's, the port's) ``reduced()`` config (with
    :data:`CUTS`): f32, remat off."""
    cut = CUTS.get(arch, {})
    return jget_config(arch).reduced(**cut), get_config(arch).reduced(**cut)


@functools.lru_cache(maxsize=None)
def reference_params(arch: str) -> dict:
    """``init(PRNGKey(0))`` of the reduced config under ``jax.jit``, as
    numpy (stacked blocks)."""
    return jax.tree.map(np.asarray, jax.jit(jbuild_model(
        configs(arch)[0]).init)(jax.random.PRNGKey(0)))


def rel(got, want) -> float:
    """Relative L2 of ``got`` against ``want`` (arrays), in f64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def port_tree(arch: str, tree):
    """A reference tree of the model's shape (arrays) in the port's
    layout."""
    return model_params_from_jax(jax.tree.map(np.asarray, tree),
                                 configs(arch)[1])


def port_columns(jcols, cfg):
    """The reference's HVP columns in the port's layout: they lead with
    the column, its stacked blocks then with the block; the port's list
    takes the block, the column stays first."""
    cols = dict(jax.tree.map(np.asarray, jcols))
    cols['blocks'] = [jax.tree.map(lambda x, i=i: x[:, i], cols['blocks'])
                      for i in range(cfg.n_blocks)]
    return to_torch(cols)


def tree_rel(got, want) -> float:
    """Relative L2 of a tree of tensors against another, over all their
    leaves together, in f64."""
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    num = sum(float(((g.detach().double() - w.double()) ** 2).sum())
              for g, w in pairs)
    den = sum(float((w.double() ** 2).sum()) for _, w in pairs)
    return float(np.sqrt(num / den))


def assert_leaves_close(got, want, tol):
    """Every leaf of ``got`` within ``tol`` relative L2 of ``want``'s (a
    leaf that is 0 in the reference must be 0 in the port)."""
    pairs, _ = tree_flatten_with_path(got)
    for (path, g), w in zip(pairs, tree_leaves(want)):
        g, w = g.detach().double().numpy(), w.double().numpy()
        if not np.any(w):
            assert not np.any(g), path
            continue
        assert rel(g, w) <= tol, (path, rel(g, w))


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


def eq3(jcfg, jp, h, jib, job, draw, k: int, rho: float, chunk: int,
        columns=None):
    """The hypergradient of Eq. 3 from the reference's pieces, at its
    parameters ``jp`` and domain logits ``h``: the sketch by
    ``NystromIHVP.prepare`` (``backend='flat'``) at ``draw``, on the
    :func:`serial_columns` HVP or on ``columns``, the HVP columns at that
    draw where the caller has them; u = ``apply``(∇θ outer); and the mixed
    term −(∂²f/∂φ∂θ)ᵀu (the outer loss does not read φ). The reference
    takes that term by reverse mode over ∇θ f, which transposes the MoE
    product's ``_rdot`` VJP and raises in jax 0.9.0
    (``ragged_dot_general``'s transpose in its ragged-contracting mode is
    not implemented): here it is the same mixed partial the other way
    round, the jvp along u of θ ↦ ∇φ f, forward over reverse as its HVP
    (the reverse pass takes θ too, so that the MoE product's custom VJP
    carries the tangent)."""
    inner, outer = build_losses(jcfg)
    phi = jnp.asarray(h)
    solver = NystromIHVP(k=k, rho=rho, column_chunk=chunk, backend='flat')
    indexer = PyTreeIndexer(jp)
    hvp = serial_columns(make_hvp(inner, jp, {'domain_logits': phi}, jib))
    indexer.sample_indices = lambda rng, k, w=None: draw
    with (contextlib.nullcontext() if columns is None else
          mock.patch.object(solvers, 'extract_columns',
                            lambda *args: columns)):
        sketch = solver.prepare(hvp, indexer, jax.random.PRNGKey(0))
    u = solver.apply(sketch, jax.grad(outer)(jp, {'domain_logits': phi},
                                             job))

    def grad_phi(p):
        return jax.grad(inner, argnums=(0, 1))(p, {'domain_logits': phi},
                                               jib)[1]['domain_logits']

    return -np.asarray(jax.jit(lambda p, t: jax.jvp(grad_phi, (p,), (t,))[1])(
        jp, u))
