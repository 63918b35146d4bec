"""Daemon-side symbol resolution with an interned-symbol cache.

Turns raw ``(filename, func)`` pairs into the same ``origin::name`` symbols
the in-process thread backend produces (:func:`repro_torch.core.sampler.frame_symbol`),
then applies the same ``collapse_origins`` folding
(:func:`repro_torch.core.sampler.collapse_stack`).  Parity with the thread backend
is a tested invariant: the two backends must build identical trees from
identical frames.  A copy of ``repro.profilerd.resolver``: it gives the JAX
package's symbols but for the port's origin labels (``torch`` for
``/torch/`` paths and ``repro`` for ``/repro_torch/`` ones, where the JAX
package's read ``py``).

Two cache tiers:

* per-frame — interns on the *(filename, func)* pair; classification runs
  once per unique pair and resolved symbol strings are shared between all
  stacks that reference them, so v1 steady-state resolution is two dict hits
  per frame;
* per-stack (wire v2) — :meth:`SymbolResolver.resolve_stack_interned` memoizes
  the whole collapsed stack on the agent-assigned ``stack_id``, so a stack
  seen again (e.g. under a different thread name) resolves with a single
  dict hit and no per-frame work at all.
"""

from __future__ import annotations

import sys
from collections.abc import Iterable, Sequence

from repro_torch.core.sampler import classify_frame, collapse_stack

from .wire import RawFrame


class SymbolResolver:
    def __init__(self, collapse_origins: Sequence[str] = ()):
        self.collapse_origins = tuple(collapse_origins)
        self._cache: dict[tuple[str, str], str] = {}
        self._stack_cache: dict[int, list[str]] = {}
        self.hits = 0
        self.misses = 0

    def symbol(self, filename: str, func: str) -> str:
        key = (filename, func)
        sym = self._cache.get(key)
        if sym is None:
            self.misses += 1
            sym = sys.intern(f"{classify_frame(filename)}::{func}")
            self._cache[key] = sym
        else:
            self.hits += 1
        return sym

    def resolve_stack(self, frames: Iterable[RawFrame]) -> list[str]:
        """Raw frames (root -> leaf) to collapsed symbol stack (root -> leaf)."""
        syms = [self.symbol(f.filename, f.func) for f in frames]
        return collapse_stack(syms, self.collapse_origins)

    def resolve_stack_interned(self, stack_id: int, frames: Iterable[RawFrame]) -> list[str]:
        """Like :meth:`resolve_stack`, memoized on the wire-v2 ``stack_id``.

        Safe because stack ids are assigned transactionally by the agent and
        never reused, so one id always names one ``(filename, func)`` frame
        sequence — exactly the inputs resolution consumes.
        """
        stack = self._stack_cache.get(stack_id)
        if stack is None:
            stack = self.resolve_stack(frames)
            self._stack_cache[stack_id] = stack
        return stack

    def reset_interned(self) -> None:
        """Forget the per-``stack_id`` memo (NOT the per-frame cache).

        A restarted writer re-assigns stack ids from 0 for what may be
        entirely different stacks, so the id-keyed tier must not survive a
        re-attach; the ``(filename, func)`` tier is content-keyed and stays.
        """
        self._stack_cache.clear()
