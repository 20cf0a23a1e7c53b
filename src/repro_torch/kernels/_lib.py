"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc -c`` per source, all started together) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The library
is named by a hash of the sources and flags, so an edited source rebuilds
and a finished build is reused. The build directory is ``_build/`` beside
this package (listed in ``.gitignore``); beside the library, ``.log`` keeps
what ``nvcc -Xptxas -v`` said of each kernel (registers, spills).

Each wrapper bumps its entry in :data:`LAUNCHES` where it launches its
kernel and nowhere else, so a run can show that it went through the kernel.

A kernel that cannot be built or loaded, a launch that reports a CUDA
error, or a wrapper that refuses its operands (:class:`KernelRefusal`)
raises :class:`KernelError`: a fault of the kernels' path itself, which
callers that degrade on other failures (the serving tier's CG fallback)
must not answer around.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[1] / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']
COMPILE_FLAGS = ['-Xptxas', '-v']   # ptxas reports registers and spills

#: launches per wrapper, keyed by the TPU kernel each one replaces
LAUNCHES = {'nystrom_gram': 0, 'nystrom_cross': 0, 'woodbury_ctv': 0,
            'woodbury_apply': 0, 'woodbury_apply_block': 0, 'rmsnorm': 0,
            'flash_attention': 0,
            # the shares of gram's, cross's and flash_attention's launches
            # on the tensor cores
            'nystrom_gram_tc': 0, 'nystrom_cross_tc': 0,
            'flash_attention_tc': 0}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel B: at most 2 blocks an SM (over its column windows too), each a
# sweep of rows or more; fewer partials for the last block to add than 3
# or 4 an SM, and as fast at streaming C (H100, p = 2^20 and 2^24)
CTV_BLOCKS_PER_SM = 2
# kernel A's stage: 128 rows of p (both of its variants), one block per SM
ATB_ROWS = 128
# kernel A's scratch: one partial (k, m) sum in f32 per block along p,
# capped at this many bytes (fewer blocks where k·m is large; one at least)
ATB_SCRATCH_BYTES = 256 * 2 ** 20

_lib: ctypes.CDLL | None = None


class KernelError(RuntimeError):
    """The hand-written kernels failed: ``nvcc`` missing, a compile or link
    failure, a library that does not load, or a CUDA error from a launch."""


class KernelRefusal(KernelError, ValueError):
    """A wrapper refused its operands (dtype, shape, layout, device, or a
    gradient a forward-only kernel cannot give): the kernel was not
    launched. A ``ValueError`` too, as the refusals always were."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise KernelError('nvcc not found: the CUDA kernels are built on a '
                          'machine with the CUDA toolkit')
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in ('.cu', '.cuh'):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f'libnystrom_kernels_{h.hexdigest()[:16]}.so'


def build_log() -> str:
    """What ``ptxas -v`` printed for the current build (registers, shared
    memory and spills per kernel)."""
    return library_path().with_suffix('.log').read_text()


def build() -> tuple[Path, float]:
    """Compile and link the kernels unless the current build exists.
    Returns (library path, seconds spent building; 0 when reused)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + '.o')
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, '-c', str(src), '-o',
                 str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, logs = [], []
        for src, proc in procs:
            log, _ = proc.communicate()
            logs.append(f'{src.name}:\n{log}')
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise KernelError('nvcc failed:\n' + '\n'.join(failed))
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', '-o', str(so),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise KernelError(f'nvcc link failed:\n{link.stdout}{link.stderr}')
        out.with_suffix('.log').write_text('\n'.join(logs))
        os.replace(so, out)
    return out, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        try:
            cdll = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f'cannot load {path.name}: {e}') from e
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        cdll.rt_atb.argtypes = [p, i, p, i, p, p, ll, i, i, i, i, i, ll, p]
        cdll.rt_ctv.argtypes = [p, i, p, i, p, p, p, ll, i, i, i, p]
        cdll.rt_woodbury_apply.argtypes = [p, i, p, p, i, p, ll, i, i, f, f,
                                           i, i, p]
        cdll.rt_rmsnorm.argtypes = [p, i, p, i, p, ll, i, f, p]
        cdll.rt_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                            *[ll] * 9, f, i, p]
        cdll.rt_flash_attention_tc.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                               *[ll] * 9, f, i, p]
        for fn in (cdll.rt_atb, cdll.rt_ctv, cdll.rt_woodbury_apply,
                   cdll.rt_rmsnorm, cdll.rt_flash_attention,
                   cdll.rt_flash_attention_tc):
            fn.restype = ctypes.c_int
        cdll.rt_error_string.argtypes = [ctypes.c_int]
        cdll.rt_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        msg = lib().rt_error_string(code).decode()
        raise KernelError(f'{what}: CUDA error {code} ({msg})')


def stream() -> int:
    """The current device's current CUDA stream, as the raw handle a launch
    takes (without building a ``torch.cuda.Stream`` object on every
    launch's host path)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def split_rows(p: int, tile: int, max_blocks: int) -> tuple[int, int]:
    """(number of blocks, rows per block) for a p-row pass: at most
    ``max_blocks`` runs of rows, each a whole number of ``tile`` rows."""
    tiles = max(1, -(-p // tile))
    nblocks = min(max_blocks, tiles)
    rows = -(-tiles // nblocks) * tile
    return -(-p // rows) if p else 1, rows


def atb_split(p: int, k: int, m: int, sms: int) -> tuple[int, int]:
    """Kernel A's (blocks along p, rows a block): whole 128-row stages, at
    most one block an SM, and at most as many blocks as keep the scratch
    (blocks · k · m f32 partials) within ``ATB_SCRATCH_BYTES``, but one
    block at least."""
    cap = max(1, ATB_SCRATCH_BYTES // (4 * k * m))
    return split_rows(p, ATB_ROWS, min(sms, cap))


def ctv_path(dtype: torch.dtype, k: int, ptr: int) -> str:
    """Kernel B's load path, by rule: C's base on the 16-byte grid and a row
    whole 16-byte chunks (any number of them) → ``'ctv_rows16'`` (16-byte
    loads, a group of lanes a row); otherwise ``'ctv_scalar'``. The test of
    :func:`rows16` without its 64-chunk limit."""
    whole = ptr % 16 == 0 and (k * dtype.itemsize) % 16 == 0
    return 'ctv_rows16' if whole else 'ctv_scalar'


@functools.lru_cache(maxsize=1024)
def ctv_blocks(p: int, k: int, itemsize: int, rows16: bool, sms: int) -> int:
    """Kernel B's blocks along p (gridDim.x; its column windows go on
    gridDim.y): ``CTV_BLOCKS_PER_SM`` an SM shared among the windows, and no
    more than p's sweeps, a sweep being the rows the block's 256 threads
    take at once (``ctv.cu``: 8 rows a lane in flight)."""
    if rows16:
        chunks = k * itemsize // 16
        lanes = 1
        while lanes < chunks and lanes < 32:
            lanes *= 2
        windows = -(-chunks // lanes)
        sweep = 8 * 32 * max(1, 8 // lanes)   # 8 warps' tasks
    else:
        width = min(k, 256)
        windows = -(-k // width)
        sweep = 256 // width * 8              # groups, 8 rows each
    per = max(1, CTV_BLOCKS_PER_SM * sms // min(windows, 65535))
    return max(1, min(per, -(-p // sweep)))


_CTV_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def ctv_scratch(device: torch.device, stream: int,
                floats: int) -> torch.Tensor:
    """Kernel B's scratch for launches on ``stream``: its first 16 bytes a
    zeroed ticket counter, which the kernel's last block sets back to 0,
    then room for ``floats`` f32 partials. One buffer per (device, stream),
    kept and grown as calls need: launches on one stream run in turn, so
    they can share it."""
    key = (device.index, stream)
    buf = _CTV_SCRATCH.get(key)
    if buf is None or buf.numel() < 4 + floats:
        buf = torch.zeros(4 + floats, dtype=torch.float32, device=device)
        _CTV_SCRATCH[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's count of streaming multiprocessors, which sets the grids
    of kernels A, B and C."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def atb_variant(a_dtype: torch.dtype, b_dtype: torch.dtype, p: int, k: int,
                m: int, ptrs: tuple[int, ...]) -> str:
    """Kernel A's variant, by one rule: bf16 × bf16 with k and m multiples
    of 8, every base address on the 16-byte grid and p < 2³¹ rows (what TMA
    can address: its row coordinate is an int32) runs on the tensor cores
    (``'tensor_cores'``, ``atb_tc``: ``wgmma``, f32 accumulators);
    everything else, f32 and mixed operands included, on the CUDA cores in
    IEEE f32 (``'cuda_cores'``, ``atb_cc``, whose rows are int64)."""
    if (a_dtype == torch.bfloat16 and b_dtype == torch.bfloat16
            and k % 8 == 0 and m % 8 == 0 and p < 2 ** 31
            and all(ptr % 16 == 0 for ptr in ptrs)):
        return 'tensor_cores'
    return 'cuda_cores'


def rows16(dtype: torch.dtype, k: int, ptr: int) -> bool:
    """Kernel C's rule: C's rows are read as whole 16-byte chunks (and, by
    the vector form, one row by a group of lanes) where C's base lies on
    the 16-byte grid and a row is 1 to 64 whole chunks; otherwise by scalar
    (vector form) or plain (block form) loads."""
    row_bytes = k * dtype.itemsize
    return ptr % 16 == 0 and row_bytes % 16 == 0 and row_bytes <= 1024


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise KernelRefusal(msg)


def device_of(*xs: torch.Tensor) -> str:
    """The one device type of a wrapper's operands: 'cpu' (the plain
    version runs) or 'cuda' (the kernel launches); anything else raises.
    (A loop, not sets: this runs on every launch's host path.)"""
    dev = xs[0].device
    for x in xs[1:]:
        require(x.device == dev,
                f'operands on different devices: {[x.device for x in xs]}')
    require(dev.type in ('cpu', 'cuda'), f'unsupported device {dev.type!r}')
    return dev.type


def require_no_grad(name: str, *xs: torch.Tensor) -> None:
    """Raise where a forward-only kernel would be asked for a gradient."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise KernelRefusal(f'{name} is a forward-only kernel: run it under '
                           'torch.no_grad() or torch.inference_mode()')
