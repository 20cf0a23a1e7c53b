"""The LM slice's optimizers and data loader against the reference:
``adamw``, ``adafactor`` and the three schedules on a generic tree (1e-5
relative over 5 steps), Adafactor on the transformer tree (the reference's
stacked layout through ``stacked_blocks``; the port's list of blocks
alone gives other numbers, which is why the wrapper exists), and
``ShardedLoader`` / ``Prefetcher``: order, ``state_dict``, a producer's
error raised in the consumer, ``close``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_reference as R
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.optim import chain as jchain
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim import scale_by_schedule as jscale_by_schedule
from repro.optim import warmup_cosine_schedule as jwarmup_cosine
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, to_numpy, to_torch
from repro_torch.core.tree_util import tree_leaves
from repro_torch.data import Prefetcher, ShardedLoader, TokenStream
from repro_torch.optim import (AdafactorState, adafactor, adamw, chain,
                               clip_by_global_norm, cosine_schedule,
                               scale_by_schedule, stacked_blocks,
                               warmup_cosine_schedule)
from torch_threads import torch_thread_cap  # noqa: F401

TOL = 1e-5


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {'w': (scale * rng.randn(6, 5)).astype(np.float32),
            'b': (scale * rng.randn(5)).astype(np.float32),
            'stack': (scale * rng.randn(3, 4, 2)).astype(np.float32),
            's': (scale * rng.randn(1)).astype(np.float32)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _run(jopt, topt, params, grads, steps=5):
    """Both optimizers from ``params`` over ``steps`` steps of the seeded
    gradients ``grads(i)``; returns the two final trees as numpy."""
    jp = jax.tree.map(jnp.asarray, params)
    tp = to_torch(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = grads(i)
        jp, js = jopt.apply(jax.tree.map(jnp.asarray, g), js, jp,
                            jnp.int32(i))
        tp, ts = topt.apply(to_torch(g), ts, tp, i)
    return to_numpy(tp), jax.tree.map(np.asarray, jp), ts


def _assert_close(got, want, tol=TOL):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert _rel(a, b) <= tol


@pytest.mark.parametrize('wd', [0.0, 0.1])
def test_adamw_matches(wd):
    got, want, _ = _run(jchain(jclip(1.0), jadamw(3e-2, weight_decay=wd)),
                        chain(clip_by_global_norm(1.0),
                              adamw(3e-2, weight_decay=wd)),
                        _tree(0), lambda i: _tree(10 + i, 0.5))
    _assert_close(got, want)


@pytest.mark.parametrize('clip_threshold', [1.0, 1e-3])
def test_adafactor_matches(clip_threshold):
    got, want, state = _run(jadafactor(1e-2, clip_threshold=clip_threshold),
                            adafactor(1e-2, clip_threshold=clip_threshold),
                            _tree(1), lambda i: _tree(20 + i))
    _assert_close(got, want)
    assert isinstance(state, AdafactorState)
    assert state.vr['w'].shape == (6,) and state.vc['w'].shape == (5,)
    assert state.vr['stack'].shape == (3, 4) and state.vc['b'].shape == ()


@pytest.mark.parametrize('name', ['cosine', 'warmup_cosine'])
def test_schedules_match(name):
    jsched, tsched = {
        'cosine': (jcosine(0.1, 7, 0.2), cosine_schedule(0.1, 7, 0.2)),
        'warmup_cosine': (jwarmup_cosine(0.1, 3, 9),
                          warmup_cosine_schedule(0.1, 3, 9))}[name]
    for step in range(12):
        want = float(jsched(jnp.int32(step)))
        got = float(tsched(step))
        assert abs(got - want) <= TOL * abs(want)
    got, want, _ = _run(jscale_by_schedule(jadamw(1e-2), jsched),
                        scale_by_schedule(adamw(1e-2), tsched),
                        _tree(2), lambda i: _tree(30 + i))
    _assert_close(got, want)


def test_adafactor_on_the_model_tree_needs_the_stacked_layout():
    """The reference's transformer leaves stack every block
    (``scan_layers``), and Adafactor factors a (n_blocks, d) norm scale and
    clips each update over all blocks: ``stacked_blocks`` gives its numbers
    on the port's list of blocks; plain Adafactor there does not."""
    cfg = get_config(R.ARCH).reduced()
    jparams = R.reference_params()

    def grads(i):
        rng = np.random.RandomState(40 + i)
        return jax.tree.map(
            lambda x: (rng.randn(*x.shape) * (1 + 10 * rng.rand())
                       ).astype(np.float32), jparams)

    jopt = jadafactor(1e-2, clip_threshold=0.05)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jopt.init(jp)
    runs = {}
    for wrap in (True, False):
        topt = adafactor(1e-2, clip_threshold=0.05)
        topt = stacked_blocks(topt) if wrap else topt
        tp = model_params_from_jax(jparams, cfg)
        runs[wrap] = (topt, tp, topt.init(tp))
    for i in range(3):
        g = grads(i)
        jp, js = jopt.apply(jax.tree.map(jnp.asarray, g), js, jp,
                            jnp.int32(i))
        tg = model_params_from_jax(g, cfg)
        for wrap, (topt, tp, ts) in runs.items():
            runs[wrap] = (topt, *topt.apply(tg, ts, tp, i))
    # compare the moves θ − θ0, leaf by leaf in the port's layout
    jmove = jax.tree.map(lambda a, b: np.asarray(a) - b, jp, jparams)
    want = dict(jmove)
    want['blocks'] = [jax.tree.map(lambda x: x[b], jmove['blocks'])
                      for b in range(cfg.n_blocks)]
    p0 = to_numpy(model_params_from_jax(jparams, cfg))
    stacked, plain = (
        [a - b for a, b in zip(tree_leaves(to_numpy(runs[w][1])),
                               tree_leaves(p0))] for w in (True, False))
    want = jax.tree.leaves(want)
    assert max(_rel(a, b) for a, b in zip(stacked, want)) <= TOL
    assert max(_rel(a, b) for a, b in zip(plain, want)) > 0.1


def test_loader_order_and_state_dict():
    stream = TokenStream(vocab_size=64, seq_len=4)
    loader = ShardedLoader(lambda s: stream.batch(s, 2), start_step=3)
    first = [next(loader) for _ in range(2)]
    for got, step in zip(first, (3, 4)):
        assert torch.equal(got['inputs'], stream.batch(step, 2)['inputs'])
    state = loader.state_dict()
    assert state == {'step': 5}
    again = ShardedLoader(lambda s: stream.batch(s, 2))
    again.load_state_dict(state)
    assert torch.equal(next(again)['labels'], next(loader)['labels'])
    with Prefetcher(ShardedLoader(lambda s: stream.batch(s, 2),
                                  start_step=3), depth=2) as pre:
        for step in (3, 4, 5, 6):
            assert torch.equal(next(pre)['inputs'],
                               stream.batch(step, 2)['inputs'])
    assert not pre.thread.is_alive()


def test_prefetcher_raises_the_producers_error_in_the_consumer():
    def items():
        yield 1
        yield 2
        raise KeyError('broken shard')

    pre = Prefetcher(items(), depth=1)
    assert [next(pre), next(pre)] == [1, 2]
    with pytest.raises(KeyError, match='broken shard'):
        next(pre)
    with pytest.raises(KeyError, match='broken shard'):
        next(pre)
    pre.close()


def test_prefetcher_ends_a_finite_iterator():
    pre = Prefetcher(iter(range(3)), depth=2)
    assert list(pre) == [0, 1, 2]
    pre.close()
