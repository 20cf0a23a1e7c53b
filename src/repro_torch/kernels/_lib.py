"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc -c`` per source, all started together) and linked into one
shared library with a plain C interface, loaded with ``ctypes``. The library
is named by a hash of the sources and flags, so an edited source rebuilds
and a finished build is reused. The build directory is ``_build/`` beside
this package (listed in ``.gitignore``).

Each wrapper bumps its entry in :data:`LAUNCHES` where it launches its
kernel and nowhere else, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
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

#: launches per wrapper, keyed by the TPU kernel each one replaces
LAUNCHES = {'nystrom_gram': 0, 'nystrom_cross': 0, 'woodbury_ctv': 0,
            'woodbury_apply': 0, 'woodbury_apply_block': 0}

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# p is cut into at most this many runs of rows (4 blocks per SM on the
# H100's 132 SMs), each a multiple of 16 rows (the atb kernel's tile).
MAX_BLOCKS = 4 * 132
ROW_TILE = 16

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(nvcc):
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def library_path() -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in ('.cu', '.cuh'):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f'libnystrom_kernels_{h.hexdigest()[:16]}.so'


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
                [nvcc, *NVCC_FLAGS, '-c', str(src), '-o', str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f'{src.name}:\n{log}')
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
        so = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', '-o', str(so),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}{link.stderr}')
        os.replace(so, out)
    return out, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        cdll = ctypes.CDLL(str(path))
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        cdll.rt_atb.argtypes = [p, i, p, i, p, p, ll, i, i, i, ll, p]
        cdll.rt_ctv.argtypes = [p, i, p, i, p, p, ll, i, i, ll, p]
        cdll.rt_woodbury_apply.argtypes = [p, i, p, p, i, p, ll, i, i, f, f,
                                           i, p]
        for fn in (cdll.rt_atb, cdll.rt_ctv, cdll.rt_woodbury_apply):
            fn.restype = ctypes.c_int
        cdll.rt_error_string.argtypes = [ctypes.c_int]
        cdll.rt_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if code != 0:
        msg = lib().rt_error_string(code).decode()
        raise RuntimeError(f'{what}: CUDA error {code} ({msg})')


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def split_rows(p: int) -> tuple[int, int]:
    """(number of blocks, rows per block) for a p-row pass."""
    tiles = max(1, -(-p // ROW_TILE))
    nblocks = min(MAX_BLOCKS, tiles)
    rows = -(-tiles // nblocks) * ROW_TILE
    return -(-p // rows) if p else 1, rows


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
