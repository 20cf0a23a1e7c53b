"""The collectives of ``repro_torch.distributed.ctx`` under every
transform: on a 2 × 2 mesh of 4 gloo ranks, and on one rank (a 1 × 1
mesh, where each is the identity), each case's value, reverse-mode
gradient, ``torch.func.jvp``, HVP columns (``vmap(jvp(grad))`` over three
tangents) and second backward, against the same function of the whole
input on one process (``tests/mesh_cases_split.py``: psum, pmean,
pvary, block, the gather over the whole mesh, FSDP's gather over 'data'
with its cotangent summed over 'data' (a reduce-scatter), and pmax).

Inputs are f64, so the tolerance is 1e-10 relative (a sum's order is the
only difference); ranks' results are compared block by block.
"""
import numpy as np
import pytest
import torch
from torch.func import grad, jvp, vmap

import mesh_cases_split as cases
import torch_mesh
from torch_threads import torch_thread_cap  # noqa: F401

TOL = 1e-10
NAMES = sorted(cases.INVARIANT)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    out = {}
    for world in (4, 1):
        tmp = tmp_path_factory.mktemp(f'collectives{world}')
        ranks, _ = torch_mesh.run_both('mesh_cases_split', 'collectives',
                                       None, tmp, world)
        out[world] = ranks
    return out


@pytest.fixture(scope='module')
def whole():
    c = {k: torch.from_numpy(v) for k, v in cases.collective_inputs().items()}
    out = {}
    for world, shape in ((4, (2, 2)), (1, (1, 1))):
        for name, f in cases.whole_cases(c, shape).items():
            Y, ty, w_y = cases.invariant(c, name, shape)
            X = c['X']
            if Y is None:
                fx = lambda a, f=f: f(a, None)              # noqa: E731
                H = lambda t, fx=fx: jvp(grad(fx), (X,), (t,))[1]  # noqa
                got = {'val': fx(X), 'g': (grad(fx)(X),),
                       'jvp': jvp(fx, (X,), (c['T'][0],))[1],
                       'hvp': (vmap(H)(c['T']),), 'dbl': (H(c['W']),)}
            else:
                g2 = grad(f, argnums=(0, 1))
                H = lambda t, s, g2=g2, Y=Y: jvp(g2, (X, Y), (t, s))[1]  # noqa
                got = {'val': f(X, Y), 'g': g2(X, Y),
                       'jvp': jvp(f, (X, Y), (c['T'][0], ty[0]))[1],
                       'hvp': vmap(H)(c['T'], ty), 'dbl': H(c['W'], w_y)}
            out[world, name] = got
    return out


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1.0))


def _block(t, coords, world):
    shape = (2, 2) if world == 4 else (1, 1)
    return cases.leaf_block(t, ('data', 'model'), shape, coords,
                            lead=t.ndim - 2)


@pytest.mark.parametrize('world', (4, 1))
@pytest.mark.parametrize('part', ('val', 'g', 'jvp', 'hvp', 'dbl'))
@pytest.mark.parametrize('name', NAMES)
def test_collective_matches_the_whole_function(runs, whole, name, part,
                                               world):
    """The value and ``jvp`` equal the whole function's on every rank; the
    gradient, HVP columns and second backward of the split input are each
    rank's block of the whole ones, those of the invariant input whole."""
    want = whole[world, name][part]
    for r in runs[world]:
        got = r[name][part]
        if part in ('val', 'jvp'):
            _close(got, want)
            continue
        _close(got[0], _block(want[0], r['coords'], world))
        if len(want) > 1:
            _close(got[1], want[1])


def test_each_collective_runs_on_several_ranks_and_none_on_one(runs):
    """On 2 × 2 every case issues its collective (named as it runs); on
    one rank none is called."""
    named = {'psum': 'psum', 'pmean': 'psum', 'pvary': 'pvary',
             'block': 'block', 'gather': 'gather',
             'gather_data_vary': 'gather', 'pmax': 'pmax'}
    for r in runs[4]:
        for name, op in named.items():
            assert r[name]['counts'].get(op, 0) > 0, (name, r[name]['counts'])
    for r in runs[1]:
        for name in NAMES:
            assert r[name]['counts'] == {}, (name, r[name]['counts'])
