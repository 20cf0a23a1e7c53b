"""The reference engine's runs, as numpy, for the port's engine parity tests
(``tests/test_torch_engine*.py``): the graphs' data drawn as
``repro/engine/problems.py`` draws them, the initial node values of
``Engine.lower(...).init``, and the column draw of every sketch build of a
run (step i, edge j: ``fold_in(fold_in(PRNGKey(seed), 1 + i), j)``, the
keys ``Engine.lower``'s step folds)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.engine import Engine as JEngine
from repro.engine import EngineConfig as JConfig
from repro.engine import engine_hypergrad as jengine_hypergrad
from repro.engine import engine_hypergrad_reference as jengine_reference
from repro.engine import get_graph as jget_graph

# the reference's test sizes (tests/test_engine.py)
REWEIGHT_KW = dict(d=4, n_tasks=2, n_support=8, n_query=8)
DISTILL_KW = dict(d=4, n_classes=2, n_syn=4, n_train=16, n_val=16)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reweight_data(d=8, n_tasks=3, n_support=16, n_query=16, corrupt=2.0,
                  seed=0, **_):
    key = jax.random.PRNGKey(seed)
    ka, ks, kq, kc, kn1, kn2, kn3 = jax.random.split(key, 7)
    a_true = jax.random.normal(ka, (n_tasks, d))
    xs = jax.random.normal(ks, (n_tasks, n_support, d))
    xq = jax.random.normal(kq, (n_tasks, n_query, d))
    xc = jax.random.normal(kc, (n_tasks, n_query, d))
    ys = (jnp.einsum('tnd,td->tn', xs, a_true)
          + 0.1 * jax.random.normal(kn1, (n_tasks, n_support)))
    yq = (jnp.einsum('tnd,td->tn', xq, a_true)
          + 0.1 * jax.random.normal(kn2, (n_tasks, n_query)))
    yq = yq.at[0].add(corrupt * jax.random.normal(kn3, (n_query,)))
    yclean = jnp.einsum('tnd,td->tn', xc, a_true)
    return numpy_tree(dict(xs=xs, ys=ys, xq=xq, yq=yq, xc=xc,
                           yclean=yclean))


def distill_data(d=6, n_classes=3, n_train=64, n_val=64, seed=0, **_):
    key = jax.random.PRNGKey(seed)
    k_mu, k_tr, k_val, k_n1, k_n2 = jax.random.split(key, 5)
    mu = 2.0 * jax.random.normal(k_mu, (n_classes, d))

    def sample(k, kn, n):
        y = jax.random.randint(k, (n,), 0, n_classes)
        return mu[y] + jax.random.normal(kn, (n, d)), jax.nn.one_hot(
            y, n_classes)

    x_tr, y_tr = sample(k_tr, k_n1, n_train)
    x_val, y_val = sample(k_val, k_n2, n_val)
    return numpy_tree(dict(x_tr=x_tr, y_tr=y_tr, x_val=x_val, y_val=y_val))


DATA = {'reweight_maml': reweight_data, 'distill_hpo': distill_data}


@functools.lru_cache(maxsize=None)
def reference_run(name: str, n_outer: int, outer_lr: float,
                  kw: tuple = ()) -> dict:
    """``Engine().solve`` of the reference on graph ``name``: its initial
    values, its per-step column draws (edge → structured draw), losses,
    final values and bills, and ``engine_hypergrad`` / ``_reference`` (ρ = 0)
    at the final values, all as numpy."""
    kw = dict(kw)
    g = jget_graph(name, **kw)
    cfg = JConfig(n_outer=n_outer, outer_lr=outer_lr)
    key = jax.random.PRNGKey(cfg.seed)
    values0 = JEngine().lower(g, cfg).init(key)[0]
    solved = g.chain_order()[:-1]
    draws = [{n: numpy_tree(JIndexer(values0[n]).sample_indices(
        jax.random.fold_in(jax.random.fold_in(key, 1 + i), j),
        g.edge_for(n).config.build().k))
        for j, n in enumerate(solved)} for i in range(n_outer)]
    res = JEngine().solve(g, cfg)
    hg, _ = jax.jit(lambda v: jengine_hypergrad(g, v))(res.values)
    ref, _ = jax.jit(lambda v: jengine_reference(g, v))(res.values)
    return {'values0': numpy_tree(values0), 'draws': draws,
            'losses': list(res.losses), 'values': numpy_tree(res.values),
            'edge_hvps': dict(res.edge_hvps), 'hypergrad': numpy_tree(hg),
            'oracle': numpy_tree(ref)}


def chip_bound(name: str) -> tuple[float, float]:
    """(the reference's own engine_hypergrad-vs-oracle error at the registry
    defaults after ``Engine().solve`` with ``EngineConfig(n_outer=``
    ``chip_smoke.ENGINE_STEPS[name])``, oracle at ρ = 0; the bound
    ``chip_smoke.py`` phase 17 (b) holds the port to on the card)."""
    import importlib.util
    from pathlib import Path

    from repro.core import hypergrad_error
    path = Path(__file__).resolve().parents[1] / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    g = jget_graph(name)
    res = JEngine().solve(g, JConfig(n_outer=chip_smoke.ENGINE_STEPS[name]))
    hg, _ = jax.jit(lambda v: jengine_hypergrad(g, v))(res.values)
    ref, _ = jax.jit(lambda v: jengine_reference(g, v))(res.values)
    return float(hypergrad_error(hg, ref)), chip_smoke.ENGINE_HG_BOUND[name]
