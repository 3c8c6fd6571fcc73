"""Append-only update journal — the durable front door of the streaming service.

Host copy of ``repro/stream/journal.py``; :meth:`UpdateJournal.save` writes
the same JSONL file, byte for byte, so either package loads the other's.

Every edge operation (insert or delete) ingested into the streaming
service is recorded as one :class:`JournalEntry` with a monotonically
increasing *sequence number*. A **watermark** ``w`` names the prefix of
the stream with ``seq ≤ w``; the service's *committed* watermark is the
prefix already folded into the match sets.

The journal is where batch semantics come from:

- :meth:`UpdateJournal.window` nets the operations of a ``(lo, hi]``
  window into one canonical :class:`~repro_torch.core.graph.GraphUpdate`. For
  a well-formed stream (deletes target present edges, inserts target
  absent edges — both relative to the state at ``lo``) the operations on
  one edge strictly alternate, so the net effect is parity: an even
  number of touches cancels (insert→delete or delete→insert nets out),
  an odd number reduces to the first (= last) operation kind. Netting
  is what makes multi-ingest windows valid Alg.-4 batches: the netted
  update never deletes a missing edge or inserts a present one.
- :meth:`UpdateJournal.replay` is ``window`` from an arbitrary
  watermark, used for recovery and for from-scratch audits.
- :meth:`UpdateJournal.truncate` drops entries at or below a durable
  watermark so the journal stays bounded while the stream is infinite.
- :meth:`UpdateJournal.save` / :meth:`UpdateJournal.load` persist the
  log as JSONL (one header + one line per op, watermark-aware) so a
  service can restart from a durable journal: load, rebuild state by
  replaying from the committed watermark, keep ingesting. Truncation
  state survives the round-trip.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from ..core.graph import GraphUpdate, decode_edges, edge_codes

__all__ = ["OP_ADD", "OP_DELETE", "JournalEntry", "UpdateJournal"]

OP_ADD = 1
OP_DELETE = -1


@dataclasses.dataclass(frozen=True)
class JournalEntry:
    """One edge operation: ``op`` is :data:`OP_ADD` or :data:`OP_DELETE`."""

    seq: int
    op: int
    code: int  # int64 edge code (min << 32 | max)

    def edge(self) -> Tuple[int, int]:
        e = decode_edges(np.array([self.code], np.int64))[0]
        return int(e[0]), int(e[1])


class UpdateJournal:
    """Append-only, watermarked edge-operation log with replay."""

    def __init__(self) -> None:
        self._seqs: List[int] = []
        self._ops: List[int] = []
        self._codes: List[int] = []
        self._tail = 0        # seq of the last appended op
        self._base = 0        # all ops with seq <= _base have been truncated

    # ------------------------------------------------------------------ write
    def append(self, update: GraphUpdate) -> int:
        """Record one :class:`GraphUpdate` (deletes first, then adds).

        Returns the new tail watermark. Ordering inside one update is
        irrelevant to netting — ``E_d`` and ``E_a`` are disjoint by
        contract — but deletes-first matches the batch semantics of
        :func:`repro_torch.core.graph.Graph.apply_update`.
        """
        return self.append_edges(delete=np.asarray(update.delete),
                                 add=np.asarray(update.add))

    def append_edges(
        self,
        *,
        delete: Iterable[Sequence[int]] | np.ndarray = (),
        add: Iterable[Sequence[int]] | np.ndarray = (),
    ) -> int:
        dele = np.asarray(list(delete) if not isinstance(delete, np.ndarray) else delete,
                          np.int64).reshape(-1, 2)
        adds = np.asarray(list(add) if not isinstance(add, np.ndarray) else add,
                          np.int64).reshape(-1, 2)
        for op, edges in ((OP_DELETE, dele), (OP_ADD, adds)):
            for code in edge_codes(edges):
                self._tail += 1
                self._seqs.append(self._tail)
                self._ops.append(op)
                self._codes.append(int(code))
        return self._tail

    # ------------------------------------------------------------------- read
    @property
    def tail(self) -> int:
        return self._tail

    @property
    def base(self) -> int:
        """Truncation watermark: entries with ``seq ≤ base`` are gone."""
        return self._base

    def __len__(self) -> int:
        return len(self._seqs)

    def pending(self, watermark: int) -> int:
        """Number of operations with ``seq > watermark``."""
        return max(self._tail - max(watermark, self._base), 0)

    def _slice(self, lo: int, hi: int | None):
        """Index range of ops with ``lo < seq ≤ hi`` — sequence numbers
        are consecutive, so a window is a list slice, not a scan."""
        hi = self._tail if hi is None else min(hi, self._tail)
        if lo < self._base:
            raise ValueError(f"window start {lo} precedes truncation base {self._base}")
        return max(lo, self._base) - self._base, max(hi, self._base) - self._base

    def entries(self, lo: int = 0, hi: int | None = None) -> List[JournalEntry]:
        i, j = self._slice(lo, hi)
        return [JournalEntry(s, o, c)
                for s, o, c in zip(self._seqs[i:j], self._ops[i:j], self._codes[i:j])]

    def window(self, lo: int, hi: int | None = None) -> GraphUpdate:
        """Net the ops with ``lo < seq ≤ hi`` into one canonical update.

        Per edge code: an even number of touches cancels, an odd number
        nets to the kind of the first touch in the window.
        """
        i, j = self._slice(lo, hi)
        first_op: dict = {}
        count: dict = {}
        for o, c in zip(self._ops[i:j], self._codes[i:j]):
            if c not in count:
                count[c] = 0
                first_op[c] = o
            count[c] += 1
        dels = sorted(c for c, k in count.items() if k % 2 and first_op[c] == OP_DELETE)
        adds = sorted(c for c, k in count.items() if k % 2 and first_op[c] == OP_ADD)
        return GraphUpdate(
            delete=decode_edges(np.asarray(dels, np.int64)),
            add=decode_edges(np.asarray(adds, np.int64)),
        )

    def replay(self, watermark: int = 0, hi: int | None = None) -> GraphUpdate:
        """Alias of :meth:`window` with recovery naming: everything after
        ``watermark`` (up to ``hi``) as one netted update."""
        return self.window(watermark, hi)

    # ---------------------------------------------------------------- durable
    _MAGIC = "repro.stream.journal"

    def save(self, path: str) -> int:
        """Persist the journal as JSONL; returns the entry count written.

        Line 1 is a header carrying the truncation base and the tail
        watermark; every further line is one edge operation. The write
        is atomic (temp file + ``os.replace``) so a crash mid-save
        leaves the previous durable copy intact — and if a torn file
        does appear some other way, :meth:`load` rejects it loudly
        (sequence gap vs the header), never replaying a silently
        shorter stream.
        """
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"kind": self._MAGIC, "version": 1,
                                "base": self._base, "tail": self._tail}) + "\n")
            for s, o, c in zip(self._seqs, self._ops, self._codes):
                f.write(json.dumps({"seq": s, "op": o, "code": c}) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(self._seqs)

    @classmethod
    def load(cls, path: str) -> "UpdateJournal":
        """Rebuild a journal saved by :meth:`save` (integrity-checked:
        header magic, op kinds, and gapless ``base+1 … tail`` sequence
        numbers — corruption raises instead of replaying wrongly)."""
        j = cls()
        with open(path) as f:
            head = json.loads(f.readline())
            if head.get("kind") != cls._MAGIC:
                raise ValueError(f"{path} is not a journal file")
            if head.get("version") != 1:
                raise ValueError(
                    f"{path}: unsupported journal version {head.get('version')!r} "
                    "(this reader understands version 1)")
            for line in f:
                if not line.strip():
                    continue
                e = json.loads(line)
                if e["op"] not in (OP_ADD, OP_DELETE):
                    raise ValueError(f"corrupt journal entry op={e['op']!r}")
                j._seqs.append(int(e["seq"]))
                j._ops.append(int(e["op"]))
                j._codes.append(int(e["code"]))
        j._base = int(head["base"])
        j._tail = int(head["tail"])
        if j._seqs != list(range(j._base + 1, j._tail + 1)):
            raise ValueError(
                f"corrupt journal {path}: expected seqs ({j._base}, {j._tail}], "
                f"got {len(j._seqs)} entries")
        return j

    # ------------------------------------------------------------------ bound
    def truncate(self, up_to: int) -> int:
        """Drop entries with ``seq ≤ up_to``; returns #entries dropped.

        The caller must only truncate at or below its committed
        watermark — replay below ``up_to`` becomes impossible.
        """
        up_to = min(up_to, self._tail)
        if up_to <= self._base:
            return 0
        cut = up_to - self._base
        dropped = min(cut, len(self._seqs))
        self._seqs = self._seqs[cut:]
        self._ops = self._ops[cut:]
        self._codes = self._codes[cut:]
        self._base = up_to
        return dropped
