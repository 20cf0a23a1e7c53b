"""The reference's side of ``tests/test_torch_split_*.py``: reduced
Yi-9B's parameters, the batches and the column draw as numpy, the
``inputs.pt`` the ranks read (``tests/mesh_cases_split.py``), and the
helpers that take a rank's block of a whole port tree.

The reference runs unsplit in the pytest process: its ``constrain`` fails
under jax 0.9.0 inside a mesh (``src/repro/distributed/ctx.py:85``), and a
sharding changes no value in it."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mesh_cases_split as cases
import torch_lm_reference as R
import torch_mesh
from repro.configs import get_config as jget_config
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.core.tree_util import tree_leaves
from repro_torch.distributed.sharding import block_slices, spec_leaves
from repro_torch.launch.steps import N_DOMAINS
from repro_torch.models.split import split_specs


def configs(fsdp: bool = False):
    """(the reference's, the port's) reduced Yi-9B config, f32."""
    return (jget_config(cases.ARCH).reduced(fsdp=fsdp),
            get_config(cases.ARCH).reduced(fsdp=fsdp))


def batch(seed: int) -> dict:
    """A (B, S) token batch with labels, a mask with about a fifth of the
    positions off (the data shards' masks differ) and domains."""
    r = np.random.RandomState(seed)
    V = configs()[1].vocab_size
    return {'inputs': r.randint(0, V, (cases.B, cases.S)).astype(np.int32),
            'labels': r.randint(0, V, (cases.B, cases.S)).astype(np.int32),
            'mask': (r.rand(cases.B, cases.S) < 0.8).astype(np.float32),
            'domain': r.randint(0, N_DOMAINS, cases.B).astype(np.int32)}


def write_inputs(tmp, shape, fsdp: bool, **extra) -> dict:
    """``inputs.pt`` for the ranks; returns what it holds."""
    jp = jax.tree.map(jnp.asarray, R.reference_params())
    draw = jax.tree.map(np.asarray, JIndexer(jp).sample_indices(
        jax.random.PRNGKey(11), cases.K))
    x = dict(params=R.reference_params(), batch=batch(1), outer=batch(2),
             h0=(0.1 * np.random.RandomState(3).randn(N_DOMAINS))
             .astype(np.float32), draw=draw, shape=shape, fsdp=fsdp, **extra)
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(x, tmp / 'inputs.pt')
    return x


def run_ranks(tmp_path_factory, func: str, label: str, shape, fsdp,
              **extra):
    """(what each rank returned, the inputs) for one mesh shape."""
    tmp = tmp_path_factory.mktemp(f'{func}_{label}')
    x = write_inputs(tmp, shape, fsdp, **extra)
    ranks, _ = torch_mesh.run_both('mesh_cases_split', func, None, tmp,
                                   shape[0] * shape[1])
    return ranks, x


def mesh_at(shape, coords: dict):
    """A stand-in ('data', 'model') mesh at one rank's coordinates, for
    the block rules."""
    return types.SimpleNamespace(
        axis_names=('data', 'model'),
        shape={'data': shape[0], 'model': shape[1]},
        devices=np.arange(shape[0] * shape[1]).reshape(shape),
        coords=dict(coords))


def specs_at(cfg, shape, coords) -> list:
    return spec_leaves(split_specs(cfg, mesh_at(shape, coords)))


def block_of(t, spec, shape, coords, lead: int = 0):
    """The block of the whole ``t`` (after ``lead`` leading dims) at
    ``coords``."""
    mesh = mesh_at(shape, coords)
    return t[(slice(None),) * lead + block_slices(tuple(t.shape[lead:]),
                                                  spec, mesh)]


def port_whole(tree, cfg):
    """A reference tree of the model's shape in the port's layout."""
    return model_params_from_jax(jax.tree.map(np.asarray, tree), cfg)


def rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def assert_blocks_close(got_tree, want_tree, cfg, shape, coords, tol,
                        lead: int = 0):
    """Each leaf of a rank's ``got_tree`` (blocks) within ``tol`` relative
    L2 of its block of the whole ``want_tree`` (a leaf that is 0 there
    must be 0 here)."""
    got, want = tree_leaves(got_tree), tree_leaves(want_tree)
    specs = specs_at(cfg, shape, coords)
    assert len(got) == len(want) == len(specs)
    for i, (g, w, sp) in enumerate(zip(got, want, specs)):
        w = block_of(w, sp, shape, coords, lead)
        g = g.detach().double().numpy()
        w = w.detach().double().numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if not np.any(w):
            assert not np.any(g), i
            continue
        assert rel(g, w) <= tol, (i, sp, rel(g, w))
