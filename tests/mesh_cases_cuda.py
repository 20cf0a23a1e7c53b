"""One NCCL rank on the card for ``tests/test_torch_cuda.py``: the
``flat_sharded`` backend on a 1×1 mesh (every spec replicates, no
collective runs) through kernels A–C, against the one-card 'cuda'
backend on the same buffer. No JAX here."""


def one_rank(rank: int, world: int, out_dir) -> dict:
    import torch

    from repro_torch.core.backend import CudaBackend, get_backend
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import P
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_host_mesh()
    g = torch.Generator().manual_seed(0)
    shapes = {'w': (64, 33), 'b': (9,), 's': ()}
    specs = {'w': P('data', 'model'), 'b': P('data'), 's': P()}
    C = {n: torch.randn((16,) + s, generator=g).cuda()
         for n, s in shapes.items()}
    v = {n: torch.randn(s, generator=g).cuda() for n, s in shapes.items()}
    V = {n: torch.randn(s + (8,), generator=g).cuda()
         for n, s in shapes.items()}
    W = torch.randn(16, 8, generator=g).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        sb = get_backend('flat_sharded', mesh=mesh, specs=specs,
                         sketch_dtype=dtype)
        cb = CudaBackend(sketch_dtype=dtype)
        op, cop = sb.prepare_operand(C), cb.prepare_operand(C)
        vf, Vm = sb.vec(v), sb.vecm(V)
        _lib.reset_launches()
        ctx.reset_collectives()
        got = {'ctv': sb.ctv(op, vf), 'gram': sb.gram(op),
               'ctm': sb.ctm(op, Vm),
               'combine': sb.combine(op, W[:, 0].contiguous(), vf, 0.1),
               'combinem': sb.combinem(op, W, Vm, 0.1)}
        torch.cuda.synchronize()
        launches = {n: c for n, c in _lib.LAUNCHES.items() if c}
        want = {'ctv': cb.ctv(cop, vf), 'gram': cb.gram(cop),
                'ctm': cb.ctm(cop, Vm),
                'combine': cb.combine(cop, W[:, 0].contiguous(), vf, 0.1),
                'combinem': cb.combinem(cop, W, Vm, 0.1)}
        out[str(dtype)] = dict(
            got={k: t.cpu() for k, t in got.items()},
            want={k: t.cpu() for k, t in want.items()},
            launches=launches, collectives=dict(ctx.COLLECTIVES),
            same_buffer=bool(torch.equal(op.buf, cop)))
    return out


def split_prefill(rank: int, world: int, out_dir) -> dict:
    """Two gloo ranks sharing ``cuda:0``: reduced Yi-9B with one KV head
    (f32, ``use_pallas``, S = 64 past its ``attn_chunk`` of 32) split over
    'model' on 1 × 2, so that the KV weights stay whole and each rank's 2 q
    heads read KV head 0 through a strided slice, prefilled through kernels
    D and E on each rank's heads; rank 0 also runs the unsplit plain path
    on the same weights. No JAX here."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import build_model
    from repro_torch.models.split import shard_params, split_specs
    from repro_torch.core.tree_util import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config('yi_9b').reduced(n_kv_heads=1),
                              use_pallas=True)
    mesh = make_host_mesh(1, 2)
    whole = build_model(cfg, device='cpu').init(
        torch.Generator().manual_seed(0))
    blocks = tree_map(lambda x: x.cuda(),
                      shard_params(whole, split_specs(cfg, mesh), mesh))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    _lib.reset_launches()
    got = build_prefill_step(cfg, mesh=mesh)(blocks, {'inputs': tokens})
    torch.cuda.synchronize()
    out = {'got': got.cpu(), 'launches': {n: c for n, c in
                                         _lib.LAUNCHES.items() if c}}
    if rank == 0:
        plain = dataclasses.replace(cfg, use_pallas=False)
        out['want'] = build_prefill_step(plain)(
            tree_map(lambda x: x.cuda(), whole), {'inputs': tokens}).cpu()
    return out
