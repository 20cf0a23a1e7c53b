"""SketchStore: a content-addressed cache of prepared solver states.

The counterpart of ``repro/serve/store.py``. The cache key is content, not
identity: the params half is :func:`repro_torch.checkpoint.params_digest`
(the same bytes a checkpoint save would write; the reference's string for
the same values), the solver half
:func:`~repro_torch.core.solvers.solver_fingerprint`, the subset of the
solver's config that changes the prepared state (k, backend, sketch dtype,
...). The fingerprint is ρ-free: the whitened Woodbury apply retargets one
sketch across damping values, so a hit survives a ρ sweep.

Eviction is LRU under a byte budget, the bytes from
:func:`~repro_torch.core.solvers.state_nbytes`. Staleness is serve-count
based: a store wired to a ``SketchPolicy`` takes its ``refresh_every`` as a
max-serves bound, so "rebuild every N uses" means the same in the trainer
loop and the serving tier.

The disk tier spills a state to ``<params>__<solver>.npz``: its leaves in
the reference's order (``NystromSketch``'s fields ``C``, ``H_KK``,
``indices`` (``dims``, then ``leaf``), ``rho``, ``B``, ``gram_B``,
``gram_C``, ``None``s dropped), ``rho`` as a 0-d f32 array, bf16 leaves as
their raw 2-byte values. For the backends the two packages share a layout
('flat', 'tree'), one spill file serves either package.

Everything here is bookkeeping; the only expensive call the store makes is
the ``build`` thunk handed to ``get_or_build``. The hit/miss counters and
per-entry ``build_hvps`` make the amortization auditable: a warm hit bills
zero HVPs.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import params_digest
from repro_torch.checkpoint.manager import (BF16, host_array, stored_dtype,
                                            to_tensor)
from repro_torch.core.solvers import (SketchPolicy, solver_fingerprint,
                                      state_nbytes)
from repro_torch.core.tree_util import tree_flatten_with_path


@dataclasses.dataclass(frozen=True)
class SketchKey:
    """Content address of a prepared solver state.

    ``params``: 16-hex digest of the parameter tree (checkpoint identity).
    ``solver``: fingerprint of the solver's prepared-state config (ρ-free).
    """
    params: str
    solver: str

    def __str__(self) -> str:
        return f'{self.params}/{self.solver}'


def sketch_key(params: Any, solver: Any) -> SketchKey:
    """The cache key for ``solver.prepare(...)`` at ``params``.

    Raises TypeError for solvers that are not amortizable (their state is a
    step-local operator: there is nothing to cache).
    """
    return SketchKey(params=params_digest(params),
                     solver=solver_fingerprint(solver))


@dataclasses.dataclass
class CacheEntry:
    """One cached state plus its accounting."""
    state: Any
    nbytes: int
    build_hvps: int
    serves: int = 0


def _leaf_dtype(leaf) -> str:
    """numpy's name of a template leaf's dtype; a Python float (the
    sketch's ρ record) is the reference's 0-d f32."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix('torch.')
    return 'float32'


class SketchStore:
    """LRU cache of prepared solver states under a byte budget.

    Parameters
    ----------
    byte_budget:
        Soft ceiling on total cached bytes. Inserting past it evicts
        least-recently-used entries until the new total fits; the entry
        being inserted is always kept, even if it alone exceeds the budget
        (a cache that cannot hold one sketch would silently disable
        amortization; better to hold exactly one).
    max_serves:
        Optional staleness bound: an entry that has answered this many
        ``get_or_build`` hits is discarded and rebuilt on the next request.
        ``None`` (default): entries never age out by use.
    policy:
        Optional :class:`~repro_torch.core.SketchPolicy`; wiring one in
        adopts its ``refresh_every`` as ``max_serves`` (unless
        ``refresh_every == 1``, the always-fresh trainer cadence, which
        would defeat caching: the store then has no staleness bound and
        leaves invalidation to the explicit hooks).
    spill_dir:
        Optional directory for the disk tier. When set, :meth:`save_entry`
        spills cached states to ``<params>__<solver>.npz`` files there, and
        ``get_or_build`` (given a ``like`` template) resolves memory misses
        from disk before paying for a build: a disk hit bills zero HVPs and
        returns ``built=False`` exactly like a warm memory hit.

    Counters (``hits``/``misses``/``disk_hits``/``evictions``/
    ``invalidations``/``expirations``) and ``hit_rate`` feed the schema-v2
    bench rows.
    """

    def __init__(self, byte_budget: int = 1 << 30, *,
                 max_serves: int | None = None,
                 policy: SketchPolicy | None = None,
                 spill_dir: str | Path | None = None):
        if byte_budget <= 0:
            raise ValueError(f'byte_budget must be positive, got {byte_budget}')
        if policy is not None and max_serves is None and policy.refresh_every > 1:
            max_serves = policy.refresh_every
        if max_serves is not None and max_serves < 1:
            raise ValueError(f'max_serves must be >= 1, got {max_serves}')
        self.byte_budget = byte_budget
        self.max_serves = max_serves
        self.spill_dir = Path(spill_dir) if spill_dir is not None else None
        self._entries: OrderedDict[SketchKey, CacheEntry] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.evictions = 0
        self.invalidations = 0
        self.expirations = 0

    # ------------------------------------------------------------ lookup
    def get_or_build(self, key: SketchKey, build: Callable[[], Any], *,
                     build_hvps: int = 0, like: Any = None) -> tuple[Any, bool]:
        """Return ``(state, built)`` for ``key``.

        On a hit: moves the entry to most-recently-used, bumps its serve
        count, returns ``(state, False)``: zero HVPs ran. On a memory miss
        with a disk tier (``spill_dir`` set and a ``like`` template, e.g.
        :func:`~repro_torch.core.solvers.state_template`, or a function of
        no arguments that returns one, called only on a memory miss): a
        matching spill file re-enters the memory tier with
        ``build_hvps=0`` and returns ``(state, False)``. Otherwise: calls ``build()`` (the k sketch
        HVPs), inserts under the byte budget, returns ``(state, True)``. A
        failed ``build`` propagates and caches nothing.
        """
        entry = self._entries.get(key)
        if entry is not None:
            if self.max_serves is not None and entry.serves >= self.max_serves:
                del self._entries[key]
                self.expirations += 1
            else:
                self._entries.move_to_end(key)
                entry.serves += 1
                self.hits += 1
                return entry.state, False
        if self.spill_dir is not None and like is not None:
            state = self.load_entry(key, like() if callable(like) else like,
                                    missing_ok=True)
            if state is not None:
                self.disk_hits += 1
                self._insert(key, CacheEntry(
                    state=state, nbytes=state_nbytes(state),
                    build_hvps=0, serves=1))
                return state, False
        self.misses += 1
        state = build()
        self._insert(key, CacheEntry(state=state, nbytes=state_nbytes(state),
                                     build_hvps=int(build_hvps), serves=1))
        return state, True

    # ---------------------------------------------------------- disk tier
    def _spill_path(self, key: SketchKey) -> Path:
        if self.spill_dir is None:
            raise ValueError('store has no spill_dir — pass one to spill '
                             'entries to disk')
        return self.spill_dir / f'{key.params}__{key.solver}.npz'

    def save_entry(self, key: SketchKey) -> Path:
        """Spill one cached entry to ``spill_dir`` and return the file path.

        The file is content-addressed by the same digest × fingerprint pair
        as the memory tier, so a later process (or a later store over the
        same directory) resolves the key without re-running the build HVPs.
        Leaves are stored by position; the ``like`` template gives the
        structure back at load time. Raises ``KeyError`` if the key is not
        cached in memory.
        """
        path = self._spill_path(key)
        entry = self._entries[key]
        path.parent.mkdir(parents=True, exist_ok=True)
        pairs, _ = tree_flatten_with_path(entry.state)
        arrays = {}
        for i, (_, leaf) in enumerate(pairs):
            if isinstance(leaf, float):
                leaf = np.float32(leaf)
            arrays[f'leaf{i}'] = host_array(leaf)[0]
        tmp = path.with_suffix('.npz.tmp')
        with open(tmp, 'wb') as f:
            np.savez(f, **arrays)
        tmp.replace(path)          # atomic publish: readers never see a torn file
        return path

    def load_entry(self, key: SketchKey, like: Any, *,
                   missing_ok: bool = False) -> Any:
        """Load a spilled state for ``key``, shaped by the ``like`` template.

        ``like`` gives the structure, each leaf's shape and dtype, and the
        device the loaded tensors go to (a Python float leaf, the sketch's
        ρ, loads back as a float). A shape or dtype mismatch (a spill from
        another config) raises ``ValueError`` rather than returning a
        corrupt sketch. Returns ``None`` on a missing file when
        ``missing_ok`` is set, else raises ``FileNotFoundError``.
        """
        path = self._spill_path(key)
        if not path.exists():
            if missing_ok:
                return None
            raise FileNotFoundError(f'no spilled entry at {path}')
        pairs, treedef = tree_flatten_with_path(like)
        with np.load(path) as data:
            if len(data.files) != len(pairs):
                raise ValueError(
                    f'spill {path.name} holds {len(data.files)} leaves, '
                    f'template has {len(pairs)}')
            leaves = []
            for i, (_, tmpl) in enumerate(pairs):
                arr = data[f'leaf{i}']
                want = _leaf_dtype(tmpl)
                got = stored_dtype(arr)
                bits = want == BF16 and got in (BF16, 'uint16')
                shape = tuple(getattr(tmpl, 'shape', ()))
                if tuple(arr.shape) != shape or (got != want and not bits):
                    raise ValueError(
                        f'spill {path.name} leaf{i} is {got}{list(arr.shape)}'
                        f', template expects {want}{list(shape)}')
                if isinstance(tmpl, torch.Tensor):
                    leaves.append(to_tensor(arr, tmpl.dtype, tmpl.device,
                                            bf16_bits=bits))
                else:
                    leaves.append(float(arr))
        return treedef.unflatten(leaves)

    def _insert(self, key: SketchKey, entry: CacheEntry) -> None:
        self._entries.pop(key, None)
        self._entries[key] = entry
        while (self.total_bytes > self.byte_budget
               and next(iter(self._entries)) is not key):
            self._entries.popitem(last=False)
            self.evictions += 1

    # ------------------------------------------------------- invalidation
    def invalidate(self, key: SketchKey) -> bool:
        """Drop one entry (e.g. its params were re-trained). Returns whether
        anything was dropped."""
        if self._entries.pop(key, None) is not None:
            self.invalidations += 1
            return True
        return False

    def invalidate_params(self, digest: str) -> int:
        """Drop every entry prepared at the given params digest: the hook a
        checkpoint refresh calls (new params: every sketch at the old ones
        is wrong whatever the solver config). Returns the count dropped."""
        doomed = [k for k in self._entries if k.params == digest]
        for k in doomed:
            del self._entries[k]
        self.invalidations += len(doomed)
        return len(doomed)

    def clear(self) -> int:
        """Drop everything (counts as invalidations). Returns count."""
        n = len(self._entries)
        self._entries.clear()
        self.invalidations += n
        return n

    # ------------------------------------------------------------- stats
    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def keys(self) -> list[SketchKey]:
        """Cached keys, least-recently-used first (eviction order)."""
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: SketchKey) -> bool:
        return key in self._entries

    def stats(self) -> dict[str, Any]:
        """Counter snapshot for bench rows / logs."""
        return {
            'entries': len(self._entries),
            'total_bytes': self.total_bytes,
            'hits': self.hits,
            'misses': self.misses,
            'hit_rate': self.hit_rate,
            'evictions': self.evictions,
            'invalidations': self.invalidations,
            'expirations': self.expirations,
        }
