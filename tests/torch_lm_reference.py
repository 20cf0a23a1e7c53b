"""The reference's bilevel LM trainer, rebuilt from its own pieces outside
the mesh, for the port's LM parity tests (``tests/test_torch_lm*.py``).

``repro/launch/train.py``'s CLI fails under jax 0.9.0 inside
``activation_mesh(make_host_mesh())`` (``constrain`` refuses
``P.UNCONSTRAINED`` without Auto mesh axes); without an active mesh
``constrain`` is the identity, so its loop runs here as it is written:
``build_losses``, ``make_optimizer``, ``config_from_cli(...,
column_chunk=4)``, ``SketchPolicy``, ``implicit_root``, ``TokenStream``,
``adam(1e-2)``. Everything is returned as numpy, with the column draw of
each outer step (``PyTreeIndexer(params).sample_indices(PRNGKey(i), k)``,
the draw the policy's build makes at step i)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.core import SketchPolicy, config_from_cli, implicit_root
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.data.synthetic import TokenStream as JTokenStream
from repro.launch.steps import N_DOMAINS, make_optimizer
from repro.launch.train import build_losses
from repro.models import build_model as jbuild_model
from repro.optim import adam as jadam

ARCH = 'yi_9b'
STEPS, OUTER_EVERY, BATCH, SEQ = 6, 3, 4, 32
K, RHO, CHUNK = 8, 1e-2, 4


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reference_config():
    return jget_config(ARCH).reduced()


@functools.lru_cache(maxsize=None)
def reference_params():
    """``init(PRNGKey(0))`` of the reduced config, as numpy (stacked
    blocks)."""
    return numpy_tree(jbuild_model(reference_config()).init(
        jax.random.PRNGKey(0)))


def reference_draw(params, i: int, k: int = K):
    """The structured draw the policy's build makes at outer step i."""
    return numpy_tree(JIndexer(jax.tree.map(jnp.asarray, params))
                      .sample_indices(jax.random.PRNGKey(i), k))


@functools.lru_cache(maxsize=None)
def reference_run(steps: int = STEPS, outer_every: int = OUTER_EVERY,
                  batch: int = BATCH, seq: int = SEQ) -> dict:
    """The loop of ``repro/launch/train.py`` (lines 174-343) without the
    mesh: per inner step the loss, per outer step (loop index i) the value
    before the update, the hypergradient, the domain logits after the
    update and the column draw; the final parameters."""
    cfg = reference_config()
    inner_loss, outer_loss = build_losses(cfg)
    optimizer = make_optimizer(cfg)
    hg_cfg = config_from_cli(
        'nystrom', flags={'k': None, 'rho': None,
                          'sketch_refresh_every': None},
        defaults={'k': K, 'rho': RHO}, column_chunk=CHUNK)
    params = jax.tree.map(jnp.asarray, reference_params())
    opt_state = optimizer.init(params)
    hparams = {'domain_logits': jnp.zeros((N_DOMAINS,), jnp.float32)}
    outer_opt = jadam(1e-2)
    outer_state = outer_opt.init(hparams)
    step = jnp.int32(0)
    stream = JTokenStream(vocab_size=cfg.vocab_size, seq_len=seq)

    @jax.jit
    def inner_step(params, opt_state, hparams, step, batch):
        loss, grads = jax.value_and_grad(inner_loss)(params, hparams, batch)
        params, opt_state = optimizer.apply(grads, opt_state, params, step)
        return params, opt_state, step + 1, loss

    solver = hg_cfg.build()
    policy = SketchPolicy(solver=solver, inner_loss=inner_loss,
                          refresh_every=hg_cfg.sketch_refresh_every)

    @jax.jit
    def outer_step(params, hparams, outer_state, step, inner_b, outer_b, key,
                   sketch_state):
        solve = implicit_root(lambda phi, b: params, inner_loss, solver)
        sketch_state, _ = policy.refresh(sketch_state, params, hparams,
                                         inner_b, key)

        def outer_obj(phi):
            theta = solve(phi, inner_b, state=sketch_state.sketch)
            return outer_loss(theta, phi, outer_b)

        val, hg = jax.value_and_grad(outer_obj)(hparams)
        hparams, outer_state = outer_opt.apply(hg, outer_state, hparams, step)
        return hparams, outer_state, val, hg, sketch_state

    losses, outer = [], []
    sketch_state = None
    for i in range(steps):
        b = stream.batch(i, batch)
        params, opt_state, step, loss = inner_step(params, opt_state,
                                                   hparams, step, b)
        losses.append(float(loss))
        if (i + 1) % outer_every == 0:
            outer_b = stream.batch(10_000_000 + i, batch, clean_only=True)
            okey = jax.random.PRNGKey(i)
            if sketch_state is None:
                sketch_state = policy.init_state(
                    params, hparams, b, jax.random.fold_in(okey, 1))
            draw = reference_draw(params, i)
            hparams, outer_state, val, hg, sketch_state = outer_step(
                params, hparams, outer_state, jnp.int32(i), b, outer_b,
                okey, sketch_state)
            np.testing.assert_array_equal(
                np.asarray(sketch_state.sketch.indices['leaf']),
                draw['leaf'])
            outer.append(dict(i=i, val=float(val),
                              hypergrad=np.asarray(hg['domain_logits']),
                              logits=np.asarray(hparams['domain_logits']),
                              draw=draw))
    return dict(losses=losses, outer=outer, params=numpy_tree(params))
