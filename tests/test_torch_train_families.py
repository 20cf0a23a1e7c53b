"""Training the encoder-decoder (SeamlessM4T-large-v2), the M-RoPE and
embedding-input model (Qwen2-VL-7B) and the MoE family (Phi-3.5-MoE,
Llama-4 Maverick) on the port, against the reference, at their
``reduced()`` configs in f32 on the reference's parameters
(``model_params_from_jax``) and on batches in ``make_batch_sds``'s layout
drawn with numpy (``tests/torch_train_reference.py``): Seamless's token
inputs and bf16 frames, Qwen2-VL's bf16 embeddings and (t, h, w) ids with
an image grid.

Tolerances: ``train_loss`` within 1e-5 relative and each leaf of its
gradient within 1e-4 relative L2; one ``build_train_step`` step (the
reference's step function called bare, outside a mesh, as
``tests/torch_lm_reference.py`` explains) within 1e-5 on the loss and the
gradient norm and 1e-4 relative L2 on the parameters; for the
encoder-decoder and Qwen2-VL, ``build_hypergrad_step`` at the reference's
draw within 1e-5 (its step) as ``tests/test_torch_lm.py`` holds Yi-9B's.
The MoE family's HVP columns and hypergradient, whose reference needs an
adapter, are in ``tests/test_torch_train_moe.py``. Also: ``train_lm`` and
the CLI refuse the configs ``TokenStream`` cannot feed."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_reference as R
from repro.core.tree_util import PyTreeIndexer as JIndexer
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_hypergrad_step as jbuild_hypergrad_step
from repro.launch.steps import build_train_step as jbuild_train_step
from repro.launch.steps import make_batch_sds as jmake_batch_sds
from repro.launch.steps import make_optimizer as jmake_optimizer
from repro.models.transformer import train_loss as jtrain_loss
from repro_torch.convert import model_indices_from_jax
from repro_torch.launch.steps import (N_DOMAINS, build_hypergrad_step,
                                      build_train_step, loss_and_grads,
                                      make_batch_sds, make_optimizer)
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train_lm
from repro_torch.models.transformer import train_loss
from torch_threads import torch_thread_cap  # noqa: F401


@pytest.mark.parametrize('arch', R.FAMILIES)
def test_make_batch_sds_is_the_reference_layout(arch):
    jcfg, cfg = R.configs(arch)
    want = jmake_batch_sds(jcfg, 3, 5)
    got = make_batch_sds(cfg, 3, 5)
    assert sorted(got) == sorted(want)
    for name, sds in want.items():
        assert tuple(got[name].shape) == sds.shape
        assert got[name].device.type == 'meta'
        assert str(got[name].dtype)[6:] == str(sds.dtype)


@pytest.mark.parametrize('arch', R.FAMILIES)
def test_train_loss_and_gradients_match_the_reference(arch):
    jcfg, cfg = R.configs(arch)
    jb, b = R.both(R.numpy_batch(arch, 1))
    jp = jax.tree.map(jnp.asarray, R.reference_params(arch))
    want, jgrads = jax.value_and_grad(
        functools.partial(jtrain_loss, jcfg))(jp, jb)
    got, grads = loss_and_grads(lambda p, batch: train_loss(cfg, p, batch),
                                R.port_tree(arch, R.reference_params(arch)),
                                b)
    assert abs(float(got) / float(want) - 1) <= 1e-5
    R.assert_leaves_close(grads, R.port_tree(arch, jgrads), 1e-4)


@pytest.mark.parametrize('arch', R.FAMILIES)
def test_build_train_step_matches_the_reference(arch):
    jcfg, cfg = R.configs(arch)
    jstep = jax.jit(jbuild_train_step(jcfg, make_host_mesh(), R.BATCH,
                                      R.SEQ).fn)
    jp = jax.tree.map(jnp.asarray, R.reference_params(arch))
    jopt = jmake_optimizer(jcfg).init(jp)
    params = R.port_tree(arch, R.reference_params(arch))
    step, opt_state = build_train_step(cfg), make_optimizer(cfg).init(params)
    for i in range(2):
        jb, b = R.both(R.numpy_batch(arch, 2 + i))
        jp, jopt, _, jm = jstep(jp, jopt, jnp.int32(i), jb)
        params, opt_state, nxt, m = step(params, opt_state, i, b)
        assert nxt == i + 1
        assert abs(float(m['loss']) / float(jm['loss']) - 1) <= 1e-5
        assert abs(float(m['grad_norm']) / float(jm['grad_norm']) - 1) \
            <= 1e-5
    assert R.tree_rel(params, R.port_tree(arch, jp)) <= 1e-4


@pytest.mark.parametrize('arch', [R.ENCDEC, R.MROPE])
def test_build_hypergrad_step_matches_the_reference(arch):
    jcfg, cfg = R.configs(arch)
    jstep = jax.jit(jbuild_hypergrad_step(jcfg, make_host_mesh(), R.BATCH,
                                          R.SEQ).fn)
    jp = jax.tree.map(jnp.asarray, R.reference_params(arch))
    jib, ib = R.both(R.numpy_batch(arch, 4, domain=True))
    job, ob = R.both(R.numpy_batch(arch, 5, domain=True))
    h0 = (0.1 * np.random.RandomState(6).randn(N_DOMAINS)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jstep(jp, {'domain_logits': jnp.asarray(h0)}, jib, job, key)
    # the reference's step draws at `key` over its stacked tree
    draw = jax.tree.map(np.asarray, JIndexer(jp).sample_indices(key, 8))
    got = build_hypergrad_step(cfg)(
        R.port_tree(arch, R.reference_params(arch)),
        {'domain_logits': torch.from_numpy(h0)}, ib, ob,
        indices=model_indices_from_jax(draw, cfg))
    step_g = np.asarray(want['domain_logits']) - h0
    assert R.rel(got['domain_logits'].numpy() - h0, step_g) <= 1e-4
    assert R.rel(got['domain_logits'].numpy(), want['domain_logits']) <= 1e-5


@pytest.mark.parametrize('arch,what', [(R.ENCDEC, 'encoder frames'),
                                       (R.MROPE, 'embeddings')])
def test_train_lm_refuses_what_token_stream_cannot_feed(arch, what):
    cfg = R.configs(arch)[1]
    with pytest.raises(ValueError, match=what) as err:
        train_lm(cfg, None, steps=1, batch=1, seq=4, outer_every=1,
                 device='cpu')
    assert 'build_train_step' in str(err.value)
    assert 'build_hypergrad_step' in str(err.value)
    with pytest.raises(ValueError, match='make_batch_sds'):
        train_main(['--arch', arch, '--reduced', '--steps', '1',
                    '--device', 'cpu'])


@pytest.mark.parametrize('mrope', [False, True])
def test_rope_tables_first_built_inside_a_transform_stay_plain(mrope):
    """The RoPE frequencies (and M-RoPE's section map) are cached per
    device. Built first inside ``torch.func.grad``, they came back wrapped
    at its level, and the next transform's forward raised ``escaped?``
    (an HVP column before any plain forward did so); they are plain
    tensors now."""
    from repro_torch.models import layers
    layers._frequencies_on.cache_clear()
    layers._sections_on.cache_clear()
    sections = (2, 3, 3)
    pos = torch.arange(6, dtype=torch.int32).expand(2, 6)
    if mrope:
        pos = pos[:, None, :].expand(2, 3, 6)

    def f(x):
        cos, sin = (layers.mrope_tables(pos, 16, 1e4, sections) if mrope
                    else layers.rope_tables(pos, 16, 1e4))
        return (x * (cos + sin)).sum()

    x = torch.ones(())
    for _ in range(2):
        torch.func.vmap(torch.func.grad(f))(x.expand(2))
    cached = [layers._frequencies_on(16, 1e4, torch.device('cpu'))]
    if mrope:
        cached.append(layers._sections_on(sections, torch.device('cpu')))
    assert not any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                   for t in cached)
