"""The port's serving tier against the reference's (``tests/test_serve.py``,
case by case).

  SketchKey        content keying, and ``sketch_key`` equal to the
                   reference's string for the 'flat' and 'tree' backends;
  SketchStore      hit/miss accounting, LRU order under the byte budget,
                   invalidation, policy-wired staleness;
  spill            the disk tier: round trip, template mismatch, a spill
                   the reference wrote that the port's store serves as a
                   disk hit (equal leaves, equal applies) and one the port
                   wrote that the reference loads, bf16 sketches bit for
                   bit; ``state_template`` against a real ``prepare`` on
                   every backend layout and apply form;
  QueryBatcher     stack/split exact, the m = 1 flush bitwise equal to
                   ``apply`` on every backend, batched flushes equal to
                   per-vector applies, flush triggers under an injected
                   clock;
  influence(store=) a warm call (memory or disk) bills zero HVPs, a ρ sweep
                   builds once, iterative solvers bypass the store;
  InfluenceService batched answers held to the reference's one-shot
                   ``influence`` at the same parameters and column draw,
                   warm flushes bill zero HVPs, backpressure, CG
                   degradation (but a kernel fault propagates), deadlines,
                   schema-v2 rows, ``audit_query_path`` refused.

``test_influence_and_engine_bills_share_one_definition`` lives in
``tests/test_torch_engine.py``, beside the engine it reads. Tolerances: the service against the
reference, those of ``tests/test_torch_influence.py`` (scores rtol 1e-5 with
atol 1e-5·max|ref|, indices equal); cross-package applies on one spilled
sketch rtol 1e-5 with atol 1e-5·max|ref|; everything within the port is
exact, except batched against per-vector applies (the reference's 2e-4 /
2e-3 block-apply bound).
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NystromIHVP as JNystrom
from repro.core import PyTreeIndexer as JIndexer
from repro.core import make_hvp as jmake_hvp
from repro.core.hypergrad import HypergradConfig as JConfig
from repro.core.problem import influence as jinfluence
from repro.core.problem import train_influence_params as jtrain
from repro.serve import SketchStore as JStore
from repro.serve import sketch_key as jsketch_key
from repro.tasks.paper import build_influence as jbuild_influence
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import (CGIHVP, ExactIHVP, HypergradConfig,
                              NystromIHVP, PyTreeIndexer, SketchPolicy,
                              influence, make_hvp, solver_fingerprint,
                              state_nbytes, state_template)
from repro_torch.core.backend import CudaBackend, FlatBackend, flatten_vec
from repro_torch.core.tree_util import tree_flatten_with_path, tree_leaves
from repro_torch.kernels._lib import KernelError, KernelRefusal
from repro_torch.serve import (InfluenceService, QueryBatcher,
                               ServiceOverloaded, SketchKey, SketchStore,
                               calibrate_block_size, sketch_key)
from repro_torch.serve.batcher import split_block, stack_block
from repro_torch.tasks import build_influence
from torch_threads import torch_thread_cap  # noqa: F401

SHAPES = {'w': (8,), 'm': (13, 7), 's': ()}
P = 8 + 13 * 7 + 1


def _params():
    return {k: torch.zeros(s) for k, s in SHAPES.items()}


def _hessian(seed=0):
    B = np.random.RandomState(seed).randn(P, 16).astype(np.float32)
    return B @ B.T / P + 0.5 * np.eye(P, dtype=np.float32)


def _quadratic(seed=0):
    Hm = torch.from_numpy(_hessian(seed))

    def loss(prm, hp, batch):
        th = flatten_vec(prm)
        return 0.5 * th @ Hm @ th

    return PyTreeIndexer(_params()), make_hvp(loss, _params(), None, None)


def _prepared(seed=0, k=6, **kw):
    idxr, hvp = _quadratic(seed)
    solver = NystromIHVP(k=k, rho=1e-2, **kw)
    return solver, solver.prepare(hvp, idxr,
                                  torch.Generator().manual_seed(seed))


def _vec(seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(np.asarray(rng.randn(*s), np.float32))
            for k, s in SHAPES.items()}


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope='module')
def toy():
    """One tiny trained influence problem shared by the service tests: the
    reference's problem and its trained parameters (numpy), and the port's
    problem on the CPU."""
    jp = jbuild_influence(d=8, width=8)
    params = jax.tree.map(np.asarray, jtrain(jp, train_steps=5))
    return jp, params, build_influence(d=8, width=8, device='cpu')


# ---------------------------------------------------------------------------
# SketchKey / fingerprints
# ---------------------------------------------------------------------------
class TestSketchKey:
    def test_content_addressed_not_identity(self):
        s = NystromIHVP(k=4)
        assert (sketch_key({'w': torch.ones(3)}, s)
                == sketch_key({'w': torch.ones(3)}, s))

    def test_params_change_changes_key(self):
        s = NystromIHVP(k=4)
        assert (sketch_key({'w': torch.ones(3)}, s)
                != sketch_key({'w': torch.zeros(3)}, s))

    def test_rho_free(self):
        p = {'w': torch.ones(3)}
        assert (sketch_key(p, NystromIHVP(k=4, rho=1e-3))
                == sketch_key(p, NystromIHVP(k=4, rho=10.0)))

    def test_k_and_backend_split_keys(self):
        p = {'w': torch.ones(3)}
        base = sketch_key(p, NystromIHVP(k=4))
        assert sketch_key(p, NystromIHVP(k=8)) != base
        assert sketch_key(p, NystromIHVP(k=4, backend='flat')) != base

    def test_iterative_solver_rejected(self):
        with pytest.raises(TypeError, match='step-local'):
            sketch_key({'w': torch.ones(3)}, CGIHVP(iters=5))

    def test_fingerprint_distinguishes_solver_types(self):
        assert (solver_fingerprint(ExactIHVP(rho=1e-2))
                != solver_fingerprint(NystromIHVP(k=4, rho=1e-2)))

    @pytest.mark.parametrize('backend', ['flat', 'tree', 'flat:bfloat16'])
    def test_key_equals_the_reference(self, toy, backend):
        from repro.core.backend import FlatBackend as JFlat
        _, params, _ = toy
        if backend == 'flat:bfloat16':
            jb, tb = (JFlat(sketch_dtype=jnp.bfloat16),
                      FlatBackend(sketch_dtype=torch.bfloat16))
        else:
            jb = tb = backend
        want = jsketch_key(params, JNystrom(k=4, rho=1e-2, backend=jb))
        got = sketch_key(to_torch(params), NystromIHVP(k=4, backend=tb))
        assert (got.params, got.solver) == (want.params, want.solver)


# ---------------------------------------------------------------------------
# SketchStore
# ---------------------------------------------------------------------------
def _key(tag: str) -> SketchKey:
    return SketchKey(params=tag, solver='nystrom;k=4')


class TestSketchStore:
    def test_miss_builds_hit_reuses(self):
        _, state = _prepared()
        store = SketchStore()
        calls = []
        build = lambda: (calls.append(1), state)[1]        # noqa: E731
        s1, built1 = store.get_or_build(_key('a'), build, build_hvps=6)
        s2, built2 = store.get_or_build(_key('a'), build, build_hvps=6)
        assert built1 and not built2
        assert len(calls) == 1
        assert s1 is s2
        assert (store.hits, store.misses) == (1, 1)
        assert store.hit_rate == 0.5

    def test_lru_eviction_order(self):
        _, state = _prepared()
        store = SketchStore(byte_budget=3 * state_nbytes(state))
        for tag in ('a', 'b', 'c'):
            store.get_or_build(_key(tag), lambda: state)
        store.get_or_build(_key('a'), lambda: state)   # touch a → b is LRU
        store.get_or_build(_key('d'), lambda: state)   # over budget: evict b
        assert store.evictions == 1
        assert _key('b') not in store
        assert store.keys() == [_key('c'), _key('a'), _key('d')]

    def test_single_entry_over_budget_is_kept(self):
        _, state = _prepared()
        store = SketchStore(byte_budget=1)
        store.get_or_build(_key('a'), lambda: state)
        assert _key('a') in store
        _, built = store.get_or_build(_key('a'), lambda: state)
        assert not built

    def test_invalidate_forces_rebuild(self):
        _, state = _prepared()
        store = SketchStore()
        store.get_or_build(_key('a'), lambda: state)
        assert store.invalidate(_key('a'))
        assert not store.invalidate(_key('a'))
        _, built = store.get_or_build(_key('a'), lambda: state)
        assert built
        assert store.invalidations == 1

    def test_invalidate_params_drops_all_solver_variants(self):
        _, state = _prepared()
        store = SketchStore()
        store.get_or_build(SketchKey('old', 'k=4'), lambda: state)
        store.get_or_build(SketchKey('old', 'k=8'), lambda: state)
        store.get_or_build(SketchKey('new', 'k=4'), lambda: state)
        assert store.invalidate_params('old') == 2
        assert store.keys() == [SketchKey('new', 'k=4')]

    def test_policy_refresh_every_is_max_serves(self):
        solver, state = _prepared()
        policy = SketchPolicy(solver=solver, inner_loss=lambda p, h, b: 0.0,
                              refresh_every=2)
        store = SketchStore(policy=policy)
        assert store.max_serves == 2
        _, b1 = store.get_or_build(_key('a'), lambda: state)
        _, b2 = store.get_or_build(_key('a'), lambda: state)
        _, b3 = store.get_or_build(_key('a'), lambda: state)
        assert (b1, b2, b3) == (True, False, True)
        assert store.expirations == 1

    def test_always_fresh_policy_does_not_disable_caching(self):
        solver, _ = _prepared()
        policy = SketchPolicy(solver=solver, inner_loss=lambda p, h, b: 0.0,
                              refresh_every=1)
        assert SketchStore(policy=policy).max_serves is None

    def test_failed_build_caches_nothing(self):
        store = SketchStore()

        def boom():
            raise RuntimeError('numerical fire')

        with pytest.raises(RuntimeError):
            store.get_or_build(_key('a'), boom)
        assert len(store) == 0 and store.misses == 1

    def test_bytes_accounting_matches_state_nbytes(self):
        _, state = _prepared()
        store = SketchStore()
        store.get_or_build(_key('a'), lambda: state)
        assert store.total_bytes == state_nbytes(state) > 2 * 6 * P * 4


# ---------------------------------------------------------------------------
# the disk tier, and the template it reads into
# ---------------------------------------------------------------------------
class TestSketchStoreSpill:
    def test_spill_roundtrip_serves_without_rebuilding(self, tmp_path):
        idxr, hvp = _quadratic()
        solver = NystromIHVP(k=6, rho=1e-2)
        build = lambda: solver.prepare(                    # noqa: E731
            hvp, idxr, torch.Generator().manual_seed(0))
        key = _key('a')
        writer = SketchStore(spill_dir=tmp_path)
        state, built = writer.get_or_build(key, build, build_hvps=6)
        assert built
        path = writer.save_entry(key)
        assert path.exists() and path.name == f'{key.params}__{key.solver}.npz'

        def poisoned():
            raise AssertionError('disk hit must not run the build')

        reader = SketchStore(spill_dir=tmp_path)
        like = state_template(solver, idxr)
        loaded, built2 = reader.get_or_build(key, poisoned, like=like)
        assert not built2
        assert reader.disk_hits == 1 and reader.misses == 0
        assert reader._entries[key].build_hvps == 0
        _assert_bitwise([v for _, v in tree_flatten_with_path(state)[0]
                         if isinstance(v, torch.Tensor)],
                        [v for _, v in tree_flatten_with_path(loaded)[0]
                         if isinstance(v, torch.Tensor)])
        assert loaded.rho == np.float32(state.rho)
        again, built3 = reader.get_or_build(key, poisoned, like=like)
        assert not built3 and reader.hits == 1

    def test_template_mismatch_rejected(self, tmp_path):
        idxr, hvp = _quadratic()
        solver = NystromIHVP(k=6, rho=1e-2)
        store = SketchStore(spill_dir=tmp_path)
        key = _key('a')
        store.get_or_build(key, lambda: solver.prepare(
            hvp, idxr, torch.Generator().manual_seed(0)))
        store.save_entry(key)
        with pytest.raises(ValueError, match='template'):
            store.load_entry(key, state_template(NystromIHVP(k=4), idxr))
        with pytest.raises(ValueError, match='template'):
            store.load_entry(key, state_template(
                NystromIHVP(k=6, stabilized=False), idxr))

    def test_missing_spill_and_no_dir(self, tmp_path):
        solver, _ = _prepared()
        like = state_template(solver, PyTreeIndexer(_params()))
        store = SketchStore(spill_dir=tmp_path)
        with pytest.raises(FileNotFoundError):
            store.load_entry(_key('ghost'), like)
        assert store.load_entry(_key('ghost'), like, missing_ok=True) is None
        with pytest.raises(ValueError, match='spill_dir'):
            SketchStore().save_entry(_key('a'))

    @pytest.mark.parametrize('backend', ['flat', 'tree'])
    def test_port_serves_a_spill_the_reference_wrote(self, tmp_path,
                                                     backend):
        """Same params, same solver config: the same key in both packages,
        so the port's store resolves the reference's file as a disk hit;
        its leaves equal the reference's state and its applies match the
        reference's."""
        Hm = jnp.asarray(_hessian())
        jparams = {k: jnp.zeros(s) for k, s in SHAPES.items()}

        def jloss(prm, hp, batch):
            from repro.core import flatten_vec as jflat
            th = jflat(prm)
            return 0.5 * th @ Hm @ th

        jsolver = JNystrom(k=6, rho=1e-2, backend=backend)
        jidx = JIndexer(jparams)
        jhvp = jmake_hvp(jloss, jparams, None, None)
        jstore = JStore(spill_dir=tmp_path)
        jkey = jsketch_key(jparams, jsolver)
        jstate, _ = jstore.get_or_build(jkey, lambda: jsolver.prepare(
            jhvp, jidx, jax.random.PRNGKey(0)))
        jstore.save_entry(jkey)

        solver = NystromIHVP(k=6, rho=1e-2, backend=backend)
        idxr, _ = _quadratic()
        key = sketch_key(_params(), solver)
        assert (key.params, key.solver) == (jkey.params, jkey.solver)
        store = SketchStore(spill_dir=tmp_path)

        def poisoned():
            raise AssertionError('disk hit must not run the build')

        state, built = store.get_or_build(key, poisoned,
                                          like=state_template(solver, idxr))
        assert not built and store.disk_hits == 1
        got = [v for _, v in tree_flatten_with_path(state)[0]]
        want = jax.tree.leaves(jstate)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.float32(a)
            np.testing.assert_array_equal(a, np.asarray(b))
        v = _vec(3)
        u = to_numpy(solver.apply(state, v))
        ju = jsolver.apply(jstate, jax.tree.map(jnp.asarray, to_numpy(v)))
        for a, b in zip(tree_leaves(u), jax.tree.leaves(ju)):
            ref = np.asarray(b)
            np.testing.assert_allclose(a, ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())

    def test_reference_loads_a_spill_the_port_wrote(self, tmp_path):
        solver, state = _prepared(backend='flat')
        store = SketchStore(spill_dir=tmp_path)
        key = sketch_key(_params(), solver)
        store.get_or_build(key, lambda: state)
        store.save_entry(key)
        jparams = {k: jnp.zeros(s) for k, s in SHAPES.items()}
        jsolver = JNystrom(k=6, rho=1e-2, backend='flat')
        jhvp = jmake_hvp(lambda p, h, b: 0.5 * sum(
            jnp.sum(x ** 2) for x in jax.tree.leaves(p)), jparams, None, None)
        like = jax.eval_shape(lambda: jsolver.prepare(
            jhvp, JIndexer(jparams), jax.random.PRNGKey(0)))
        jkey = jsketch_key(jparams, jsolver)
        loaded = JStore(spill_dir=tmp_path).load_entry(jkey, like)
        for a, b in zip(jax.tree.leaves(loaded),
                        [v for _, v in tree_flatten_with_path(state)[0]]):
            b = b.numpy() if isinstance(b, torch.Tensor) else np.float32(b)
            np.testing.assert_array_equal(np.asarray(a), b)

    @pytest.mark.parametrize('backend', [FlatBackend, CudaBackend])
    def test_bf16_sketch_spills_bit_for_bit(self, tmp_path, backend):
        solver, state = _prepared(backend=backend(
            sketch_dtype=torch.bfloat16))
        assert state.C.dtype == state.B.dtype == torch.bfloat16
        store = SketchStore(spill_dir=tmp_path)
        key = sketch_key(_params(), solver)
        store.get_or_build(key, lambda: state)
        store.save_entry(key)
        loaded = SketchStore(spill_dir=tmp_path).load_entry(
            key, state_template(solver, PyTreeIndexer(_params())))
        pairs = tree_flatten_with_path(loaded)[0]
        assert [p for p, _ in pairs] == [
            p for p, _ in tree_flatten_with_path(state)[0]]
        _assert_bitwise(
            [v for _, v in pairs if isinstance(v, torch.Tensor)],
            [v for _, v in tree_flatten_with_path(state)[0]
             if isinstance(v, torch.Tensor)])


_TEMPLATE_CASES = [
    (be, dt, form)
    for be in ('tree', 'flat', 'cuda')
    for dt in ((None,) if be == 'tree' else (None, torch.bfloat16))
    for form in ('whitened', 'eq6', 'alg1')]


@pytest.mark.parametrize('backend,dtype,form', _TEMPLATE_CASES)
def test_state_template_matches_prepare_leaf_by_leaf(backend, dtype, form):
    """``state_template`` builds, with no HVP, the leaves a real ``prepare``
    builds: the same paths (so the same spill order), shapes, dtypes and
    devices, for every backend layout ('tree' leading-k tree, 'flat' (k, p),
    'cuda' (p, k)), sketch dtype and apply form (B/gram_B, gram_C)."""
    be = backend if dtype is None else {
        'flat': FlatBackend, 'cuda': CudaBackend}[backend](sketch_dtype=dtype)
    kw = {'whitened': {}, 'eq6': {'stabilized': False},
          'alg1': {'kappa': 2}}[form]
    solver, state = _prepared(backend=be, **kw)
    idxr = PyTreeIndexer(_params())
    like = state_template(solver, idxr)
    want = tree_flatten_with_path(state)[0]
    got = tree_flatten_with_path(like)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        if isinstance(b, float):
            assert isinstance(a, float), path
            continue
        assert (a.shape, a.dtype, a.device) == (b.shape, b.dtype,
                                                b.device), path
    assert state_nbytes(like) == state_nbytes(state)


def test_state_template_of_the_exact_solver_and_refusal():
    idxr, hvp = _quadratic()
    H = ExactIHVP().prepare(hvp, idxr).H
    like = state_template(ExactIHVP(), idxr)
    assert (like.H.shape, like.H.dtype) == (H.shape, H.dtype)
    with pytest.raises(TypeError):
        state_template(CGIHVP(), idxr)


# ---------------------------------------------------------------------------
# QueryBatcher
# ---------------------------------------------------------------------------
class TestQueryBatcher:
    def test_stack_split_roundtrip_bitwise(self):
        cols = [_vec(s) for s in range(5)]
        back = split_block(stack_block(cols), 5)
        for orig, rt in zip(cols, back):
            _assert_bitwise(orig, rt)

    @pytest.mark.parametrize('backend', ['tree', 'flat', 'cuda'])
    def test_m1_flush_bitwise_matches_vector_apply(self, backend):
        solver, state = _prepared(seed=7, backend=backend)
        batcher = QueryBatcher(block_size=4, max_delay=0.0)
        v = _vec(8)
        batcher.submit(v)
        block, taken = batcher.take_block()
        assert len(taken) == 1
        [u_col] = split_block(solver.apply_matrix(state, block), 1)
        _assert_bitwise(u_col, solver.apply(state, v))

    def test_interleaved_submissions_match_per_vector_applies(self):
        solver, state = _prepared(seed=9)
        batcher = QueryBatcher(block_size=4, max_delay=10.0)
        vecs = [_vec(10 + s) for s in range(4)]
        for v in vecs:
            batcher.submit(v)
        assert batcher.due()
        block, taken = batcher.take_block()
        assert [q.ticket for q in taken] == [0, 1, 2, 3]
        cols = split_block(solver.apply_matrix(state, block), 4)
        for v, got in zip(vecs, cols):
            np.testing.assert_allclose(
                flatten_vec(got).numpy(),
                flatten_vec(solver.apply(state, v)).numpy(),
                rtol=2e-4, atol=2e-3)

    def test_flush_triggers_under_injected_clock(self):
        now = [0.0]
        batcher = QueryBatcher(block_size=3, max_delay=1.0,
                               clock=lambda: now[0])
        v = _vec(0)
        assert not batcher.due()
        batcher.submit(v)
        assert not batcher.due()
        now[0] = 0.5
        assert not batcher.due()
        now[0] = 1.0
        assert batcher.due()
        assert batcher.next_due_at() == 1.0
        batcher.take_block()
        batcher.deadline_slack = 0.25
        batcher.submit(v, deadline=now[0] + 0.5)
        assert not batcher.due()
        now[0] += 0.25
        assert batcher.due()

    def test_block_full_flushes_regardless_of_clock(self):
        batcher = QueryBatcher(block_size=2, max_delay=1e9)
        v = _vec(0)
        batcher.submit(v)
        assert not batcher.due()
        batcher.submit(v)
        assert batcher.due()
        block, taken = batcher.take_block()
        assert len(taken) == 2 and len(batcher) == 0

    def test_take_block_pops_oldest_first(self):
        batcher = QueryBatcher(block_size=2, max_delay=0.0)
        v = _vec(0)
        tickets = [batcher.submit(v) for _ in range(3)]
        _, taken = batcher.take_block()
        assert [q.ticket for q in taken] == tickets[:2]
        assert len(batcher) == 1

    def test_empty_take_rejected(self):
        with pytest.raises(ValueError, match='empty'):
            QueryBatcher().take_block()

    def test_calibration_times_every_candidate(self):
        solver, state = _prepared()
        widths = []

        def apply_block(V):
            widths.append(tree_leaves(V)[0].shape[-1])
            return solver.apply_matrix(state, V)

        best, rates = calibrate_block_size(apply_block, _vec(0),
                                           candidates=(1, 2, 4), reps=2)
        assert sorted(rates) == [1, 2, 4] and best in rates
        assert widths == [1] * 3 + [2] * 3 + [4] * 3
        assert all(r > 0 for r in rates.values())


# ---------------------------------------------------------------------------
# influence() through the store
# ---------------------------------------------------------------------------
class TestInfluenceThroughStore:
    def test_warm_call_bills_zero_build_hvps(self, toy):
        _, params, problem = toy
        params = to_torch(params)
        solver = NystromIHVP(k=4, rho=1e-2)
        store = SketchStore()
        queries = problem.reference['queries'](2)
        kw = dict(params=params, top_k=5, store=store, device='cpu')
        cold = influence(problem, solver, queries, **kw)
        warm = influence(problem, solver, queries, **kw)
        assert cold.hvp_count == 4
        assert warm.hvp_count == 0
        assert (store.hits, store.misses) == (1, 1)
        assert torch.equal(cold.scores, warm.scores)
        assert torch.equal(cold.indices, warm.indices)

    def test_rho_sweep_reuses_one_sketch(self, toy):
        _, params, problem = toy
        store = SketchStore()
        queries = problem.reference['queries'](1)
        for rho in (1e-3, 1e-2, 1e-1):
            influence(problem, NystromIHVP(k=4, rho=rho), queries,
                      params=to_torch(params), top_k=5, store=store,
                      device='cpu')
        assert store.misses == 1 and store.hits == 2

    def test_iterative_solver_bypasses_store(self, toy):
        _, params, problem = toy
        store = SketchStore()
        res = influence(problem, CGIHVP(iters=3, rho=1e-2),
                        problem.reference['queries'](2),
                        params=to_torch(params), top_k=5, store=store,
                        device='cpu')
        assert len(store) == 0
        assert res.hvp_count == 6

    @pytest.mark.parametrize('backend', ['tree', 'cuda'])
    def test_disk_restart_serves_with_zero_hvps(self, toy, tmp_path,
                                                backend):
        _, params, problem = toy
        params = to_torch(params)
        solver = NystromIHVP(k=4, rho=1e-2, backend=backend)
        queries = problem.reference['queries'](2)
        first = SketchStore(spill_dir=tmp_path)
        kw = dict(params=params, top_k=5, device='cpu')
        cold = influence(problem, solver, queries, store=first, **kw)
        first.save_entry(sketch_key(params, solver))
        restarted = SketchStore(spill_dir=tmp_path)
        warm = influence(problem, solver, queries, store=restarted, **kw)
        assert cold.hvp_count == 4
        assert warm.hvp_count == 0
        assert restarted.disk_hits == 1 and restarted.misses == 0
        assert torch.equal(cold.scores, warm.scores)
        assert torch.equal(cold.indices, warm.indices)

    def test_template_is_built_only_on_a_memory_miss(self, toy, tmp_path,
                                                     monkeypatch):
        """With a disk tier, ``influence(store=)`` hands the store the
        template as a function: a cold call (memory miss) builds it once to
        look on disk, a warm memory hit builds none."""
        from repro_torch.core import solvers
        _, params, problem = toy
        calls = []
        real = solvers.state_template
        monkeypatch.setattr(solvers, 'state_template',
                            lambda *a: calls.append(1) or real(*a))
        store = SketchStore(spill_dir=tmp_path)
        kw = dict(params=to_torch(params), top_k=5, store=store,
                  device='cpu')
        queries = problem.reference['queries'](1)
        solver = NystromIHVP(k=4, rho=1e-2, backend='cuda')
        assert influence(problem, solver, queries, **kw).hvp_count == 4
        assert len(calls) == 1
        assert influence(problem, solver, queries, **kw).hvp_count == 0
        assert len(calls) == 1 and store.hits == 1


# ---------------------------------------------------------------------------
# InfluenceService
# ---------------------------------------------------------------------------
def _one(queries, q):
    return tuple(x[q] for x in queries)


class TestInfluenceService:
    def test_batched_answers_match_reference_oneshot_influence(self, toy):
        """Three queries through one m = 3 flush, and the same three one at
        a time (m = 1), against the reference's one-shot ``influence`` at
        the same parameters and column draw."""
        jp, params, problem = toy
        queries = jax.tree.map(np.asarray, jp.reference['queries'](3))
        want = jinfluence(jp, JConfig(k=4, rho=1e-2, backend='flat'),
                          jax.tree.map(jnp.asarray, queries),
                          params=jax.tree.map(jnp.asarray, params), top_k=5,
                          seed=3)
        draw = jax.tree.map(np.asarray, JIndexer(params).sample_indices(
            jax.random.PRNGKey(3), 4))
        ref_v = np.asarray(want.scores)
        for block_size in (3, 1):
            svc = InfluenceService(problem, HypergradConfig(
                k=4, rho=1e-2, backend='cuda'), params=to_torch(params),
                top_k=5, block_size=block_size, max_delay=60.0,
                indices=draw)
            tickets = [svc.submit(_one(to_torch(queries), q))
                       for q in range(3)]
            assert svc.pump() == 3
            for q, t in enumerate(tickets):
                resp = svc.result(t)
                assert resp.batched_m == block_size
                np.testing.assert_allclose(
                    resp.scores.numpy(), ref_v[q], rtol=1e-5,
                    atol=1e-5 * np.abs(ref_v).max())
                np.testing.assert_array_equal(resp.indices.numpy(),
                                              np.asarray(want.indices[q]))

    def test_warm_requests_run_zero_build_hvps(self, toy):
        _, params, problem = toy
        svc = InfluenceService(problem, NystromIHVP(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=1)
        svc.prepare()
        svc.reset_metrics()
        q = _one(problem.reference['queries'](1), 0)
        for _ in range(3):
            svc.submit(q)
            svc.flush()
        row = svc.bench_rows(phase='warm')[0]
        assert row['hvp_count'] == 0
        assert svc.store.hits == 3

    def test_backpressure(self, toy):
        _, params, problem = toy
        svc = InfluenceService(problem, NystromIHVP(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=8, max_delay=60.0, max_queue=2)
        q = _one(problem.reference['queries'](1), 0)
        svc.submit(q)
        svc.submit(q)
        with pytest.raises(ServiceOverloaded, match='queue full'):
            svc.submit(q)
        svc.flush()
        svc.submit(q)

    def test_degrades_to_cg_on_build_failure(self, toy, caplog):
        _, params, problem = toy

        @dataclasses.dataclass(frozen=True)
        class Broken(NystromIHVP):
            def prepare(self, *a, **k):
                raise RuntimeError('sketch factorization blew up')

        svc = InfluenceService(problem, Broken(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=1)
        q = _one(problem.reference['queries'](1), 0)
        with caplog.at_level(logging.WARNING,
                             logger='repro_torch.serve.service'):
            t = svc.submit(q)
            svc.flush()
        assert any('degrading' in r.message for r in caplog.records)
        resp = svc.result(t)
        assert resp.degraded and not resp.cache_hit
        assert resp.scores.shape == (5,)
        assert svc.degraded_flushes == 1
        assert svc.bench_rows()[0]['hvp_count'] == svc._fallback.iters

    @pytest.mark.parametrize('kernel_fault', [True, False])
    def test_a_kernel_fault_propagates_other_failures_degrade(
            self, toy, kernel_fault):
        """A build, load or launch failure of the kernels (``KernelError``)
        inside the sketch build is not answered by CG: it propagates. Any
        other failure of the build (here a failed factorization) degrades
        the flush to CG."""
        _, params, problem = toy
        err = (KernelError('nvcc failed') if kernel_fault
               else torch.linalg.LinAlgError('H_KK is not finite'))

        @dataclasses.dataclass(frozen=True)
        class Failing(NystromIHVP):
            def prepare(self, *a, **k):
                raise err

        svc = InfluenceService(problem, Failing(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=1)
        t = svc.submit(_one(problem.reference['queries'](1), 0))
        if kernel_fault:
            with pytest.raises(KernelError, match='nvcc'):
                svc.flush()
            assert svc.degraded_flushes == 0
        else:
            svc.flush()
            assert svc.result(t).degraded and svc.degraded_flushes == 1

    def test_a_wrapper_refusal_in_the_build_propagates(self, toy):
        """A real wrapper's refusal inside ``prepare`` on ``backend='cuda'``
        (kernel A's gram takes f32 or bf16, and this sketch is stored in
        f16) is a launch failure: it propagates as ``KernelRefusal``, still
        a ``ValueError``, and no flush is answered by CG."""
        _, params, problem = toy
        solver = NystromIHVP(k=4, rho=1e-2,
                             backend=CudaBackend(sketch_dtype=torch.float16))
        svc = InfluenceService(problem, solver, params=to_torch(params),
                               top_k=5, block_size=1)
        svc.submit(_one(problem.reference['queries'](1), 0))
        with pytest.raises(KernelRefusal, match='float32 or bfloat16') as e:
            svc.flush()
        assert isinstance(e.value, (KernelError, ValueError))
        assert svc.degraded_flushes == 0
        assert svc.stats()['fallback_hvps'] == 0

    def test_deadline_miss_is_recorded(self, toy):
        _, params, problem = toy
        now = [0.0]
        svc = InfluenceService(problem, NystromIHVP(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=1, clock=lambda: now[0])
        t = svc.submit(_one(problem.reference['queries'](1), 0),
                       deadline_s=0.5)
        now[0] = 1.0
        svc.flush()
        assert svc.result(t).deadline_missed and svc.deadline_misses == 1

    def test_bench_rows_are_schema_valid(self, toy):
        from benchmarks.common import BENCH_V2_REQUIRED_KEYS
        _, params, problem = toy
        svc = InfluenceService(problem, NystromIHVP(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=1)
        svc.submit(_one(problem.reference['queries'](1), 0))
        svc.flush()
        [row] = svc.bench_rows()
        for key in BENCH_V2_REQUIRED_KEYS:
            assert key in row, key
        assert row['phase'] == 'serve'
        assert 0.0 <= row['cache_hit_rate'] <= 1.0
        assert row['latency_p95_ms'] >= row['latency_p50_ms'] >= 0.0

    def test_result_before_flush_raises(self, toy):
        _, params, problem = toy
        svc = InfluenceService(problem, NystromIHVP(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5,
                               block_size=4, max_delay=60.0)
        t = svc.submit(_one(problem.reference['queries'](1), 0))
        with pytest.raises(KeyError, match='not answered'):
            svc.result(t)
        svc.flush()
        svc.result(t)

    def test_audit_query_path_is_refused(self, toy):
        _, params, problem = toy
        svc = InfluenceService(problem, NystromIHVP(k=4, rho=1e-2),
                               params=to_torch(params), top_k=5)
        with pytest.raises(NotImplementedError, match='item 13'):
            svc.audit_query_path()
