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


# ------------------------------------------------ decode and the families
def family_configs(arch: str, over: dict):
    """(the reference's, the port's) ``reduced(**over)`` config, f32."""
    return jget_config(arch).reduced(**over), get_config(arch).reduced(**over)


def family_params(arch: str, over: dict, biases: bool = True) -> dict:
    """``init(PRNGKey(0))`` of the reduced config as numpy (stacked
    blocks); with ``biases``, its q/k/v biases (zeros at init) drawn from
    a seed so that the bias path counts."""
    from repro.models import build_model as jbuild_model
    jcfg = family_configs(arch, over)[0]
    params = jax.tree.map(np.asarray, jax.jit(jbuild_model(jcfg).init)(
        jax.random.PRNGKey(0)))
    r = np.random.RandomState(9)

    def draw(path, x):
        name = getattr(path[-1], 'key', None)
        if biases and name in ('bq', 'bk', 'bv'):
            return (0.3 * r.randn(*x.shape)).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(draw, params)


def decode_inputs(cfg, batch: int, seed: int) -> list:
    """The teacher-forced inputs of ``cases.DECODE_STEPS`` + 1 steps: (B,
    1) tokens, or (B, 1, d) f32 embeddings where the model takes
    embeddings."""
    r = np.random.RandomState(seed)
    n = cases.DECODE_STEPS + 1
    if cfg.embed_inputs or cfg.is_encdec:
        return [r.randint(0, cfg.vocab_size, (batch, 1)).astype(np.int32)
                for _ in range(n)]
    return [r.randn(batch, 1, cfg.d_model).astype(np.float32)
            for _ in range(n)]


def reference_decode(jcfg, params, steps, frames=None) -> dict:
    """The reference's unsplit ``decode_step`` over ``steps`` from an empty
    cache of ``cases.SMAX`` (an encoder-decoder's cross cache filled from
    ``frames`` by its ``encode`` and ``fill_cross_cache``), ``pos`` set to
    ``cases.SMAX`` before the last step: each step's logits and the final
    cache, as numpy."""
    from repro.models import build_model as jbuild_model
    from repro.models.transformer import encode as jencode
    from repro.models.transformer import fill_cross_cache as jfill
    model = jbuild_model(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    cache = model.init_cache(steps[0].shape[0], cases.SMAX)
    if frames is not None:
        enc = jax.jit(lambda p, f: jencode(jcfg, p, f))(jp, frames)
        cache = jfill(jcfg, jp, cache, enc)
    step = jax.jit(model.decode_step)
    logits = []
    for t, inp in enumerate(steps):
        if t == len(steps) - 1:
            cache = dict(cache, pos=jnp.int32(cases.SMAX))
        out, cache = step(jp, jnp.asarray(inp), cache)
        logits.append(np.asarray(out))
    return {'logits': np.stack(logits),
            'cache': jax.tree.map(np.asarray, cache)}


def start_family_ranks(tmp_path_factory, func: str, label: str, **x):
    """Start the ranks of ``x['shape']`` on ``func`` with the inputs ``x``
    (numpy and torch only: the ranks never load JAX); returns (their
    processes, their output directory) for :func:`family_results`."""
    tmp = tmp_path_factory.mktemp(f'{func}_{label}')
    torch.save(x, tmp / 'inputs.pt')
    world = x['shape'][0] * x['shape'][1]
    return (torch_mesh.start_ranks('mesh_cases_split', func, tmp / 'ranks',
                                   world), tmp / 'ranks')


def family_results(started, timeout: float = 300.0) -> list:
    """What each rank of :func:`start_family_ranks` returned."""
    procs, out_dir = started
    torch_mesh.join(procs, timeout)
    return torch_mesh.results(out_dir, len(procs))


def run_family_ranks(tmp_path_factory, func: str, label: str, **x):
    """:func:`start_family_ranks`, then :func:`family_results`."""
    return family_results(start_family_ranks(tmp_path_factory, func, label,
                                             **x))


def cache_block(t, spec, shape, coords):
    """The block at ``coords`` of a whole cache leaf under ``spec``."""
    return t[block_slices(tuple(t.shape), spec, mesh_at(shape, coords))]


def port_columns(jcols, cfg):
    """The reference's HVP columns (leading with the column) in the port's
    layout: each stacked tree of blocks (``blocks``, and an
    encoder-decoder's ``enc_blocks``) becomes a list, one entry a block,
    the column kept first."""
    from repro_torch.convert import to_torch
    cols = dict(jax.tree.map(np.asarray, jcols))
    for key, n in (('blocks', cfg.n_blocks), ('enc_blocks', cfg.n_enc_layers)):
        if key in cols:
            cols[key] = [jax.tree.map(lambda x, i=i: x[:, i], cols[key])
                         for i in range(n)]
    return to_torch(cols)


# ------------------------------------------------------------------- MoE
#: each call's replicas over capacity, by shard, while :func:`capacity_moe`
#: records (``record=True``)
DROPS: list = []


def moe_skew(params: dict, d: int) -> dict:
    """``params`` (the reference's MoE model, numpy) with the embedding
    rows shifted by 0.5 and every router's column 0 by 0.6/√d
    (``tests/mesh_cases_moe.py``'s skew), so that the routing favours
    expert 0 and replicas overflow its capacity."""
    def draw(path, x):
        name = getattr(path[-1], 'key', None)
        if name == 'table' and getattr(path[0], 'key', None) == 'embed':
            return (x + np.float32(0.5)).astype(x.dtype)
        if name == 'router':
            x = x.copy()
            x[..., 0] += np.float32(0.6 / d ** 0.5)
        return x

    return jax.tree_util.tree_map_with_path(draw, params)


def capacity_moe(shards: int, hold=0.0, record: bool = False):
    """A stand-in for the reference's ``moe_ffn`` that computes what its
    ``shard_map`` body does on a mesh whose batch axes hold ``shards``
    ranks (``src/repro/models/moe.py:218-224``): the reference's own
    ``_moe_local(impl='capacity')`` on each shard's rows of the batch (all
    of them where ``shards`` does not divide B, as the port's
    ``batch_split_axes`` replicates such a batch), the outputs joined, and
    the aux loss from the routing statistics averaged over the shards (its
    ``pmean``). Without a mesh it runs under jax 0.9.0, where the
    reference's whole forward under a mesh fails (``constrain``).

    ``hold`` (a 0/1 float, traced or not): at 1 the router reaches the
    output with its gradient stopped, so that its gradient is the aux
    loss's alone (a top-1 gate g/g carries none, only rounding noise);
    the values are the same either way. ``record``: each shard's replicas
    over capacity go to :data:`DROPS`."""
    from repro.models import moe as jmoe

    def moe_ffn(params, x, cfg):
        B, S, d = x.shape
        n = shards if B % shards == 0 else 1
        E, k = cfg.n_experts, cfg.top_k
        r = params['router']
        body = dict(params, router=jax.lax.stop_gradient(r) * hold
                    + r * (1 - hold))
        outs, fracs, means = [], [], []
        for xt in x.reshape(n, B // n * S, d):
            outs.append(jmoe._moe_local(body, xt, cfg, impl='capacity')[0])
            probs = jax.nn.softmax(xt.astype(jnp.float32)
                                   @ r.astype(jnp.float32), -1)
            idx = jax.lax.top_k(probs, k)[1]
            onehot = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
            fracs.append(jnp.mean(onehot.astype(jnp.float32), axis=0))
            means.append(probs.mean(0))
            if record:
                slot = jnp.sum((jnp.cumsum(onehot, 0) - onehot) * onehot, 1)
                nk = onehot.shape[0]
                cap = nk if nk <= 8 * E else min(
                    nk, max(8, int(1.25 * nk / E + 7) // 8 * 8))
                jax.debug.callback(lambda c: DROPS.append(int(c)),
                                   jnp.sum(slot >= cap), ordered=True)
        aux = (E * jnp.sum(jnp.mean(jnp.stack(fracs), 0)
                           * jnp.mean(jnp.stack(means), 0))
               * cfg.router_aux_coef)
        return jnp.concatenate(outs).reshape(B, S, d), aux

    return moe_ffn
