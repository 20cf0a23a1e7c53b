"""The reference's ``multihead_attention`` under its padded head layout,
for ``tests/test_torch_split_families.py``: run in a fresh interpreter
with 4 host devices (``tests/torch_mesh.py``'s ``reference`` mode), inside
``activation_mesh`` of a 1 × 4 ('data', 'model') mesh whose axes are Auto
(``with_sharding_constraint`` refuses the Explicit axes of
``repro.launch.mesh.make_host_mesh`` under jax 0.9.0), under ``jax.jit``:
with 6 heads over 'model' = 4 it pads them to 8 (``_project_qkv``).

Reads ``padded_in.npz`` beside ``out_dir`` (the config's overrides are
fixed here: reduced Qwen2-7B with 6 heads over 2 KV heads), writes
``padded.npy``."""
from pathlib import Path

ARCH, OVER = 'qwen2_7b', {'n_heads': 6, 'n_kv_heads': 2}


def padded(out_dir) -> None:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.distributed.ctx import activation_mesh
    from repro.models.attention import multihead_attention
    cfg = get_config(ARCH).reduced(**OVER)
    z = np.load(Path(out_dir).parent / 'padded_in.npz')
    params = {k[2:]: z[k] for k in z.files if k.startswith('p_')}
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ('data', 'model'))
    with mesh, activation_mesh(mesh):
        out = jax.jit(lambda p, x: multihead_attention(p, x, cfg))(
            params, z['x'])
    np.save(Path(out_dir) / 'padded.npy', np.asarray(out))
