"""Atomic, optionally asynchronous checkpoints, in the reference's format.

The counterpart of ``repro/checkpoint/manager.py``. A checkpoint is a flat
{path: array} map and a JSON manifest (step, shapes, dtypes, a crc32 per
leaf), laid out byte for byte as the reference lays it out, so each package
restores what the other saved:

    <dir>/step_<n:010d>/arrays.npz      one array per leaf, named by path
    <dir>/step_<n:010d>/manifest.json   {'step', 'extra', 'leaves': {path:
                                         {'shape', 'dtype', 'crc32'}}}
    <dir>/LATEST                        the name of the newest step

Paths are ``'/'.join`` of :func:`~repro_torch.core.tree_util.
tree_flatten_with_path`'s entries, JAX's leaf names. Write protocol (crash
safe at every point): serialize into ``step_<n>.tmp/``, fsync, rename to
``step_<n>/``, then rewrite ``LATEST`` through a tmp file and a rename; a
partial step never becomes ``LATEST``, and stale ``.tmp`` directories are
removed when a manager opens the directory.

bf16 leaves: numpy has no bfloat16 of its own. A bf16 leaf is written as
its raw 2-byte values (a ``V2`` array) under the manifest dtype
``'bfloat16'``, as the reference's ``np.savez`` writes them, and read back
by its bits (``|V2``, ``<V2`` or ``uint16``), never by a value cast.

``restore`` puts each leaf on ``device=`` (default: the template leaf's
device); the reference's ``shardings=`` (cross-mesh resharding) belongs to
the distributed work still to be ported and raises.
``CheckpointManager(async_save=True)`` copies the tree to host memory before
``save`` returns (for leaves on the card, that copy is the one sync it
costs) and writes the files on a background thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.tree_util import tree_flatten_with_path, tree_map

#: the dtype name of a bf16 leaf, in the manifest and in the digest
BF16 = 'bfloat16'


def host_array(leaf: Any) -> tuple[np.ndarray, str]:
    """(a host array of ``leaf``'s raw values, numpy's name of
    its dtype). A tensor is copied to the host (from the card, the copy
    waits for it); a bf16 tensor becomes its 2-byte raw values as a ``V2``
    array named ``'bfloat16'``. Other leaves go through ``np.asarray``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to('cpu').contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view('V2'), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def stored_dtype(arr: np.ndarray) -> str:
    """The dtype name of an array read back from an ``.npz``: 2-byte raw
    values (``|V2``, ``<V2``, or numpy's bfloat16 where it is registered)
    are bf16."""
    if arr.dtype.kind == 'V' and arr.dtype.itemsize == 2:
        return BF16
    return str(arr.dtype)


def to_tensor(arr: np.ndarray, dtype: torch.dtype, device,
              bf16_bits: bool = False) -> torch.Tensor:
    """An array read from disk → a tensor of ``dtype`` on ``device``.
    ``bf16_bits``: ``arr`` holds bf16 values as raw 2-byte patterns (``V2``
    or ``uint16``); they are reinterpreted, bit for bit, then cast."""
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if bf16_bits:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype)


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    flat = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        flat['/'.join(path)] = host_array(leaf)
    return flat


def params_digest(tree: Any) -> str:
    """Content digest of a parameter tree: sha256 over each leaf's path,
    ``repr((shape, dtype name))`` and raw bytes, in sorted path order; the
    first 16 hex digits. Equal to the reference's ``params_digest`` for the
    same values (shapes as tuples of ints, numpy's dtype names).

    The checkpoint-identity half of a serving-cache key: two trees digest
    equal iff a save/restore round trip reproduces one from the other. Costs
    one copy of the tree to the host (the copy ``save`` makes) plus a hash
    pass.
    """
    h = hashlib.sha256()
    flat = _flatten(tree)
    for key in sorted(flat):
        arr, dtype = flat[key]
        # the reference hashes the shape of np.ascontiguousarray(leaf),
        # which is (1,) for a 0-d leaf
        arr = np.ascontiguousarray(arr)
        h.update(key.encode())
        h.update(repr((tuple(int(n) for n in arr.shape), dtype)).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def save(directory: str, step: int, tree: Any, extra: dict | None = None):
    """Atomic synchronous save. Returns the final step directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f'step_{step:010d}')
    tmp = final + '.tmp'
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(tree)
    manifest = {'step': step, 'extra': extra or {}, 'leaves': {}}
    with open(os.path.join(tmp, 'arrays.npz'), 'wb') as f:
        np.savez(f, **{k: arr for k, (arr, _) in flat.items()})
    for k, (arr, dtype) in flat.items():
        manifest['leaves'][k] = {
            'shape': list(arr.shape), 'dtype': dtype,
            'crc32': zlib.crc32(arr.tobytes())}
    with open(os.path.join(tmp, 'manifest.json'), 'w') as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)

    latest_tmp = os.path.join(directory, 'LATEST.tmp')
    with open(latest_tmp, 'w') as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(directory, 'LATEST'))
    return final


def latest_step(directory: str) -> int | None:
    latest = os.path.join(directory, 'LATEST')
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    return int(name.split('_')[-1])


def restore(directory: str, template: Any, step: int | None = None,
            shardings: Any = None, verify: bool = True, device=None):
    """Restore into ``template``'s structure (a tree of tensors: each leaf
    gives the shape and the dtype to restore to). Leaves go to ``device``,
    or to the template leaf's device when it is None. Returns
    (tree, manifest). Raises ``IOError`` on a crc mismatch when ``verify``.

    ``shardings`` (the reference's cross-mesh resharding) is ROADMAP item
    12's, the distributed work not ported yet: a non-None value raises."""
    if shardings is not None:
        raise NotImplementedError(
            'restore(shardings=...) reshards onto a device mesh, which '
            'belongs to ROADMAP item 12 (distributed) and is not ported; '
            'pass device= to restore onto one device')
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f'no checkpoint under {directory}')
    d = os.path.join(directory, f'step_{step:010d}')
    with open(os.path.join(d, 'manifest.json')) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, 'arrays.npz')) as npz:
        arrays = {k: npz[k] for k in npz.files}

    if verify:
        for k, meta in manifest['leaves'].items():
            crc = zlib.crc32(np.ascontiguousarray(arrays[k]).tobytes())
            if crc != meta['crc32']:
                raise IOError(f'checkpoint corruption at leaf {k!r} '
                              f'(crc {crc} != {meta["crc32"]})')

    pairs, treedef = tree_flatten_with_path(template)
    out = []
    for path, leaf in pairs:
        key = '/'.join(path)
        if key not in arrays:
            raise KeyError(f'checkpoint missing leaf {key!r}')
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f'shape mismatch at {key!r}: '
                             f'{arr.shape} vs {tuple(leaf.shape)}')
        bits = (manifest['leaves'].get(key, {}).get('dtype') == BF16
                or stored_dtype(arr) == BF16)
        out.append(to_tensor(arr, leaf.dtype,
                             leaf.device if device is None else device,
                             bf16_bits=bits))
    return treedef.unflatten(out), manifest


class CheckpointManager:
    """Rotating, optionally asynchronous manager with preemption-friendly
    semantics: ``keep`` newest steps survive each save; one save is in
    flight at a time, and its error surfaces at the next ``wait``/``save``."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)
        self._gc_tmp()

    def _gc_tmp(self):
        for name in os.listdir(self.directory):
            if name.endswith('.tmp'):
                p = os.path.join(self.directory, name)
                shutil.rmtree(p, ignore_errors=True)

    def wait(self):
        """Block until any in-flight async save lands (call before exit)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()                           # one in-flight save at a time
        if not self.async_save:
            save(self.directory, step, tree, extra)
            self._rotate()
            return
        # synchronous copy to the host, asynchronous disk write; a copy even
        # of host tensors, which the caller may go on updating in place
        host_tree = tree_map(
            lambda x: (x.detach().to('cpu', copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)

        def work():
            try:
                save(self.directory, step, host_tree, extra)
                self._rotate()
            except Exception as e:            # surfaced on next wait()/save()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _rotate(self):
        steps = sorted(int(n.split('_')[-1])
                       for n in os.listdir(self.directory)
                       if n.startswith('step_') and not n.endswith('.tmp'))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f'step_{s:010d}'),
                          ignore_errors=True)

    def restore_latest(self, template: Any, shardings: Any = None,
                       device=None):
        return restore(self.directory, template, shardings=shardings,
                       device=device)

    def latest_step(self):
        return latest_step(self.directory)
