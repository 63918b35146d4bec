"""Cached-path call-tree ingestion — the daemon half of wire-v2 stack interning.

The agent interns stacks (one ``STACKDEF`` per unique stack, then fixed-size
``SAMPLE2`` references); :class:`TreeIngestor` completes the contract on the
daemon side: each ``(thread_name, stack_id)`` pair is resolved through the
:class:`~repro_torch.profilerd.resolver.SymbolResolver` exactly once, and the
resulting :class:`~repro_torch.core.calltree.CallNode` chain (root -> leaf, for
inclusive bumps plus the leaf's self bump) is cached by direct reference.
Ingesting a repeated sample is then an O(depth) float-add loop over the
cached chain — zero hashing, zero allocation — via the node fast lane
(:meth:`~repro_torch.core.calltree.CallTree.add_stack_nodes`).

v1 samples (no ``stack_id``) fall back to the per-frame resolve + generic
``add_stack`` path, so old spools ingest unchanged.

:meth:`TreeIngestor.ingest_batch` is the vectorized lane over the same cache:
a columnar :class:`~repro_torch.profilerd.wire.SampleBatch` is grouped by packed
``(thread_name_id, stack_id)`` key with ``np.unique`` + ``np.bincount``, and
each *group* costs one cache lookup plus one batched float-add of the group's
hit count along the cached chain — per-sample Python work disappears
entirely on repeated stacks.  Groups are applied in first-occurrence order,
so epoch dirty lists (and therefore sealed timeline bytes) come out identical
to per-sample ingestion of the same stream.

The cache never needs invalidation: the tree only grows, chains reference
live accumulator nodes, and collapse settings are fixed per daemon run.

Epoch dirty tracking
--------------------

The timeline sealer (:class:`repro_torch.core.snapshot.CountSealer`) needs to know
*which* chains changed during an epoch — and by how much — without walking
the tree.  Each cache entry carries an epoch stamp and a per-epoch hit count:
the first hit per epoch appends the entry to an epoch-local dirty list, every
hit bumps the count (one integer compare + one integer add per sample — the
fast lane stays flat).  :meth:`drain_epoch` hands the dirty entries to the
sealer and opens the next epoch.  v1 samples mutate the tree outside the
chain cache, so they flip an ``untracked`` flag that forces the sealer to
write a keyframe instead of a counts record.
"""

from __future__ import annotations

from collections.abc import Sequence

from repro_torch.core.calltree import CallTree

from .resolver import SymbolResolver
from .wire import RawSample, SampleBatch, _numpy


# Cache-entry ceiling: one chain per (thread, stack_id); the agent's own
# stack table is capped (wire.DEFAULT_MAX_STACKS), this guards the daemon
# against thread-name churn on top of that.  Overflow degrades to the
# uncached path — correctness is unaffected.
DEFAULT_MAX_PATHS = 1 << 18


class TreeIngestor:
    """Streams :class:`RawSample` events into a :class:`CallTree`."""

    def __init__(
        self,
        tree: CallTree | None = None,
        resolver: SymbolResolver | None = None,
        collapse_origins: Sequence[str] = (),
        max_paths: int = DEFAULT_MAX_PATHS,
    ):
        self.tree = tree if tree is not None else CallTree()
        self.resolver = resolver if resolver is not None else SymbolResolver(collapse_origins)
        self.max_paths = max_paths
        # (thread_name, stack_id) -> [node chain incl. root + thread node,
        # resolved stack depth for the timeline, epoch stamp of last hit,
        # samples ingested through this chain in the current epoch].
        self._paths: dict[tuple[str, int], list] = {}
        self._epoch = 0
        self._epoch_entries: list[list] = []
        self._epoch_untracked = False
        self.fast_hits = 0
        self.slow_ingests = 0
        self.batch_samples = 0  # samples ingested through ingest_batch
        self.batch_chunks = 0  # SampleBatch objects ingested

    def ingest(self, sample: RawSample) -> int:
        """Merge one sample; returns the resolved stack depth (timeline)."""
        sid = sample.stack_id
        if sid is not None:
            key = (sample.thread_name, sid)
            entry = self._paths.get(key)
            if entry is not None:
                if entry[2] != self._epoch:
                    entry[2] = self._epoch
                    entry[3] = 0
                    self._epoch_entries.append(entry)
                entry[3] += 1
                CallTree.add_stack_nodes(entry[0])
                self.fast_hits += 1
                return entry[1]
            stack = self.resolver.resolve_stack_interned(sid, sample.frames)
            chain = self.tree.path_nodes([f"thread::{sample.thread_name}"] + stack)
            if len(self._paths) < self.max_paths:
                entry = [chain, len(stack), self._epoch, 1]
                self._paths[key] = entry
                self._epoch_entries.append(entry)
            else:
                # Not cached: hits can't be counted next epoch either, so
                # sealing must keyframe instead of trusting the entry set.
                self._epoch_untracked = True
            CallTree.add_stack_nodes(chain)
            self.slow_ingests += 1
            return len(stack)
        stack = self.resolver.resolve_stack(sample.frames)
        self.tree.add_stack([f"thread::{sample.thread_name}"] + stack)
        self._epoch_untracked = True
        self.slow_ingests += 1
        return len(stack)

    def ingest_batch(self, batch: SampleBatch):
        """Merge one columnar :class:`SampleBatch`; returns the per-sample
        resolved stack depths as an int array (timeline feed), in stream
        order.

        Samples are grouped by packed ``(thread_name_id, stack_id)`` key —
        group sizes via ``np.bincount`` over the ``np.unique`` inverse — and
        each group becomes *one* cache lookup + one batched
        ``add_stack_nodes(chain, count)`` float-add, instead of ``count``
        scalar ingests.  Identical-by-construction to per-sample ingestion:

        * float parity — adding ``n`` ones and adding ``n.0`` once are the
          same IEEE double for any realistic count, so tree metrics match
          bit-for-bit;
        * order parity — groups are applied in first-occurrence order, so
          the epoch dirty list (hence sealed-ring bytes) matches;
        * stats parity — a cached group counts ``n`` fast hits; an uncached
          one counts 1 slow ingest + ``n - 1`` fast hits, exactly what the
          scalar loop would have reported.
        """
        np = _numpy()
        dec = batch.decoder
        sid_col = batch.stack_id
        packed = (batch.name_id.astype(np.uint64) << np.uint64(32)) | sid_col.astype(np.uint64)
        keys, first_at, inverse = np.unique(packed, return_index=True, return_inverse=True)
        # Bulk-convert the tiny per-group arrays once: the loop below then
        # touches only plain Python ints (a numpy scalar index per group
        # would dominate the batch win at realistic group counts).
        counts_l = np.bincount(inverse, minlength=len(keys)).tolist()
        keys_l = keys.tolist()
        group_depths = [0] * len(keys_l)
        epoch = self._epoch
        paths = self._paths
        for gi in np.argsort(first_at).tolist():
            n = counts_l[gi]
            key64 = keys_l[gi]
            sid = key64 & 0xFFFFFFFF
            frames = dec.batch_stack(sid, n)  # degraded-mode accounting per sample
            tname = dec.thread_name(key64 >> 32)
            entry = paths.get((tname, sid))
            if entry is not None:
                if entry[2] != epoch:
                    entry[2] = epoch
                    entry[3] = 0
                    self._epoch_entries.append(entry)
                entry[3] += n
                CallTree.add_stack_nodes(entry[0], float(n))
                self.fast_hits += n
                group_depths[gi] = entry[1]
                continue
            stack = self.resolver.resolve_stack_interned(sid, frames)
            chain = self.tree.path_nodes([f"thread::{tname}"] + stack)
            if len(paths) < self.max_paths:
                entry = [chain, len(stack), epoch, n]
                paths[(tname, sid)] = entry
                self._epoch_entries.append(entry)
                self.slow_ingests += 1
                self.fast_hits += n - 1
            else:
                self._epoch_untracked = True
                self.slow_ingests += n
            CallTree.add_stack_nodes(chain, float(n))
            group_depths[gi] = len(stack)
        self.batch_samples += len(packed)
        self.batch_chunks += 1
        return np.asarray(group_depths, dtype=np.intp)[inverse]

    def reset_chain_cache(self) -> None:
        """Forget every ``(thread, stack_id)`` -> chain association.

        Required on writer re-attach: a restarted target re-assigns stack ids
        from 0, so a cached id could silently route a different stack through
        an old chain.  Counts already drained into the current epoch stay
        valid — entries reference live tree nodes, and the sealer adds
        duplicate-chain counts additively — only the id association dies.
        """
        self._paths.clear()

    def drain_epoch(self) -> tuple[list[list], bool]:
        """Close the current epoch: ``(dirty entries, untracked_mutations)``.

        Each entry is ``[chain, depth, stamp, count]`` — ``count`` samples
        were ingested through ``chain`` this epoch.  ``untracked_mutations``
        is True when the tree changed outside the chain cache (v1 samples,
        cache overflow); the caller must then seal from the full tree instead
        of trusting the entry set.
        """
        entries, self._epoch_entries = self._epoch_entries, []
        untracked, self._epoch_untracked = self._epoch_untracked, False
        self._epoch += 1
        return entries, untracked

    def stats(self) -> dict:
        """The ingestor's slice of the unified ``ingest_stats`` schema (see
        :mod:`repro_torch.profilerd.pipeline` for the full documented dict)."""
        return {
            "fast_hits": self.fast_hits,
            "slow_ingests": self.slow_ingests,
            "batch_samples": self.batch_samples,
            "batch_chunks": self.batch_chunks,
            "cached_paths": len(self._paths),
        }
