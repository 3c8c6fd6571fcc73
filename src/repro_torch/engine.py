"""Static-shape PyTorch executor of the listing/join plan IR.

Port of ``repro/dist/jax_engine.py``: the device half of the plan/executor split, on padded tensors whose shapes
come from :class:`EngineCaps`. Invalid slots hold :data:`PAD` (= -1),
every id is ``int32``, and every compaction returns a dropped-entry
counter, so a zero overflow proves the padded result exact. Results are
byte-identical to the JAX engine on the same inputs (tested).

The two membership predicates of the engine go through the hand-written
CUDA kernels of :mod:`repro_torch.kernels` when ``caps.use_kernels`` is
set: ``member_probe`` in :func:`edge_probe` / :func:`_has_edge`, and
``set_intersect`` in :func:`ccjoin_local`.

Two listing executors run a plan on one partition: :func:`unit_list`
(one R1 unit of a join tree, every step packed to ``match_cap``) and
:func:`wcoj_list` (a whole pattern by generic join, each level packed to
its own cap).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np
import torch

from .core.graph import decode_edges
from .core.pattern import Pattern
from .core.plan import LT, NEQ, JoinPlan, UnitPlan, WcojPlan, build_unit_plan
from .core.storage import Partition
from .core.vcbc import CompressedTable, Ragged
from .kernels import ops

__all__ = [
    "PAD", "EngineCaps", "PaddedPartition", "CompTensors", "pad_partition",
    "build_unit_plan", "UnitPlan", "JoinPlan", "WcojPlan", "unit_list", "wcoj_list",
    "require_edges_mask",
    "compress_plain", "group_rows", "scatter_grouped_values", "ccjoin_local",
    "dedup_rows", "lookup_sorted", "edge_probe", "center_adj_contrib",
    "apply_edge_delta_rows", "patch_partition", "deleted_edge_cols",
    "filter_deleted_dev", "merge_groups", "merge_tables_dev", "count_matches_dev",
    "map_tensors", "comp_to_host",
]

PAD = -1
_BIG = 2**31 - 1
_I32 = torch.int32
# Cells per slice of the row-sliced primitives (set packing, set union,
# probes, the count contraction): rows are independent, so slicing bounds
# the transients at store scale without changing any result.
_SLICE_CELLS = 1 << 26


@dataclasses.dataclass(frozen=True)
class EngineCaps:
    """Static shape model of the device engine (twin of ``jax_engine.EngineCaps``).

    v_cap      max vertices per partition
    deg_cap    max adjacency-row length
    e_cap      max edges per partition
    match_cap  max rows of a plain (uncompressed) match table
    group_cap  max skeleton groups of a compressed table
    set_cap    max values per compressed-vertex set
    pair_cap   max side-2 partners per side-1 group in a CC-join
    use_kernels  route the membership predicates through the CUDA kernels
               (needs CUDA tensors; ``False`` runs their plain versions)
    """

    v_cap: int
    deg_cap: int
    e_cap: int
    match_cap: int
    group_cap: int
    set_cap: int
    pair_cap: int
    use_kernels: bool = True


@dataclasses.dataclass
class PaddedPartition:
    """One NP partition as padded tensors (``int32``/``bool``).

    ``vertices`` ascending with a PAD tail; ``adj`` rows ascending global
    neighbor ids with PAD tails; ``edge_hi``/``edge_lo`` are the (min, max)
    endpoints in lexicographic order with PAD tails. A stacked partition
    set carries a leading ``[m]`` axis on every field.
    """

    vertices: torch.Tensor   # [v_cap]
    center: torch.Tensor     # [v_cap] bool
    deg: torch.Tensor        # [v_cap]
    adj: torch.Tensor        # [v_cap, deg_cap]
    edge_hi: torch.Tensor    # [e_cap] (min endpoint)
    edge_lo: torch.Tensor    # [e_cap] (max endpoint)


@dataclasses.dataclass
class CompTensors:
    """A VCBC compressed table as padded tensors: ``skeleton [G, S]``,
    ``valid [G]`` and per compressed-vertex label ``sets[v] [G, set_cap]``
    (PAD tail, valid prefix ascending)."""

    skeleton: torch.Tensor
    valid: torch.Tensor
    sets: Dict[int, torch.Tensor]


def map_tensors(fn, x):
    """Apply ``fn`` to every tensor of a PaddedPartition / CompTensors-like
    dataclass (``sets`` dicts and nested dataclasses included) and rebuild
    it."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, dict):
            out[f.name] = {k: fn(a) for k, a in v.items()}
        elif dataclasses.is_dataclass(v):
            out[f.name] = map_tensors(fn, v)
        else:
            out[f.name] = fn(v)
    return type(x)(**out)


def _ar(n: int, like: torch.Tensor, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=_I32, device=like.device)


def _full(shape, value, like: torch.Tensor, dtype=_I32) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=like.device)


def _ss(sorted_seq: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``searchsorted`` (side left) with int32 positions where they fit."""
    return torch.searchsorted(sorted_seq.contiguous(), values.contiguous(),
                              out_int32=sorted_seq.shape[-1] < 2**31 - 1)


def _cumsum(ok: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(ok, dim=dim, dtype=_I32)


def _isum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dtype=_I32)


def _isum_rows(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=1, dtype=_I32)


def _zero(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=_I32, device=like.device)


def _row_slices(n_rows: int, width: int):
    """Row slices of at most ``_SLICE_CELLS`` cells for a ``[n_rows, width]`` pass."""
    step = max(1, _SLICE_CELLS // max(width, 1))
    return [slice(s, min(s + step, n_rows)) for s in range(0, n_rows, step)]


# ---------------------------------------------------------------------------
# Padding host partitions
# ---------------------------------------------------------------------------

def pad_partition(part: Partition, caps: EngineCaps, device="cuda") -> PaddedPartition:
    """Pad one host :class:`Partition` to the static shape model; a misfit
    of ``v_cap``/``deg_cap``/``e_cap`` raises instead of truncating."""
    nv = int(part.vertices.shape[0])
    ne = int(part.codes.shape[0])
    deg = np.diff(part.indptr).astype(np.int64)
    if nv > caps.v_cap:
        raise ValueError(f"partition has {nv} vertices > v_cap={caps.v_cap}")
    if ne > caps.e_cap:
        raise ValueError(f"partition has {ne} edges > e_cap={caps.e_cap}")
    if nv and int(deg.max(initial=0)) > caps.deg_cap:
        raise ValueError(f"max degree {int(deg.max())} > deg_cap={caps.deg_cap}")
    vertices = np.full(caps.v_cap, PAD, np.int32)
    center = np.zeros(caps.v_cap, bool)
    degs = np.zeros(caps.v_cap, np.int32)
    adj = np.full((caps.v_cap, caps.deg_cap), PAD, np.int32)
    vertices[:nv] = part.vertices
    center[:nv] = part.center_mask
    degs[:nv] = deg
    for r in range(nv):
        row = part.indices[part.indptr[r]: part.indptr[r + 1]]
        adj[r, : row.shape[0]] = row
    edge_hi = np.full(caps.e_cap, PAD, np.int32)
    edge_lo = np.full(caps.e_cap, PAD, np.int32)
    und = decode_edges(part.codes)  # sorted by code == lexicographic (min, max)
    edge_hi[:ne] = und[:, 0]
    edge_lo[:ne] = und[:, 1]
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return PaddedPartition(vertices=t(vertices), center=t(center), deg=t(degs),
                           adj=t(adj), edge_hi=t(edge_hi), edge_lo=t(edge_lo))


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _row_of(pt: PaddedPartition, q: torch.Tensor) -> torch.Tensor:
    """Local row index of global vertex ids (callers mask misses)."""
    vs = torch.where(pt.vertices < 0, _BIG, pt.vertices)
    return _ss(vs, q.to(_I32)).clamp(0, pt.vertices.shape[0] - 1)


def _lower_bound_pairs(qa, qb, ea, eb) -> torch.Tensor:
    """Count of table entries lexicographically below each ``(qa, qb)``
    query, over a table sorted ascending with ``_BIG`` pads at the tail."""
    n = ea.shape[0]
    lo = torch.zeros(qa.shape, dtype=_I32, device=qa.device)
    hi = torch.full(qa.shape, n, dtype=_I32, device=qa.device)
    for _ in range(max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        ma, mb = ea[midc], eb[midc]
        less = (ma < qa) | ((ma == qa) & (mb < qb))
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less, hi, mid)
    return lo


def _has_edge(pt: PaddedPartition, u, v, use_kernels: bool) -> torch.Tensor:
    """Edge membership of ``(u, v)`` in the partition's edge list."""
    return edge_probe(torch.minimum(u, v), torch.maximum(u, v), pt.edge_hi, pt.edge_lo,
                      use_kernels=use_kernels)


def _compact_index(ok: torch.Tensor, cap: int):
    """Stable first-``cap`` packing: ``(dest, valid, dropped)``, ``dest`` =
    packed slot of each entry (``cap`` = dump slot)."""
    idx = _cumsum(ok) - 1
    total = _isum(ok)
    dest = torch.where(ok & (idx < cap), idx, cap)
    valid = _ar(cap, ok) < total.clamp(max=cap)
    return dest, valid, (total - cap).clamp(min=0)


def _take_index(ok: torch.Tensor, cap: int):
    """Source indices of the first ``cap`` ``ok`` entries (cumsum +
    ``searchsorted`` gather form): ``(src, valid, dropped)``."""
    n = ok.shape[0]
    c = _cumsum(ok)
    total = c[n - 1]
    src = _ss(c, _ar(cap, ok, start=1))
    valid = _ar(cap, ok) < total.clamp(max=cap)
    return src.clamp(0, n - 1), valid, (total - cap).clamp(min=0)


def _compact_rows(rows: torch.Tensor, ok: torch.Tensor, cap: int):
    """Keep the first ``cap`` ``ok`` rows: ``([cap, C] PAD-filled, valid, dropped)``."""
    if rows.shape[0] == 0:
        return (_full((cap, rows.shape[1]), PAD, rows),
                torch.zeros(cap, dtype=torch.bool, device=rows.device), _zero(rows))
    src, valid, dropped = _take_index(ok, cap)
    out = torch.where(valid[:, None], rows[src.long()].to(_I32), PAD)
    return out, valid, dropped


def _compact_vec(vals: torch.Tensor, ok: torch.Tensor, cap: int, fill=0):
    """1-D variant of :func:`_compact_rows`."""
    if vals.shape[0] == 0:
        return (_full((cap,), fill, vals, vals.dtype),
                torch.zeros(cap, dtype=torch.bool, device=vals.device), _zero(vals))
    src, valid, dropped = _take_index(ok, cap)
    return torch.where(valid, vals[src.long()], fill), valid, dropped


def _compact_expand(tbl: torch.Tensor, cand: torch.Tensor, ok: torch.Tensor, cap: int):
    """:func:`_compact_rows` of the frontier expansion ``[tbl[r], cand[r, d]]``
    (row-major over ``(r, d)``) without materializing the expansion."""
    R, D = cand.shape
    src, valid, dropped = _take_index(ok.reshape(-1), cap)
    src = src.long()
    wide = torch.cat([tbl[src // D], cand.reshape(-1)[src][:, None]], dim=1)
    return torch.where(valid[:, None], wide, PAD), valid, dropped


# ---------------------------------------------------------------------------
# Unit listing (plan executor)
# ---------------------------------------------------------------------------

def unit_list(pt: PaddedPartition, plan: UnitPlan, caps: EngineCaps,
              require_edges: torch.Tensor | None = None):
    """Anchored frontier-table listing of one R1 unit (``M_ac``).

    Returns ``(table [match_cap, |V|], valid [match_cap], overflow)`` with
    columns aligned to ``plan.cols``; ``require_edges`` (``[k, 2]``)
    keeps matches mapping ≥1 pattern edge into that edge set.
    """
    seed_ok = pt.center & (pt.vertices >= 0) & (pt.deg >= plan.anchor_min_degree)
    tbl, valid, ovf = _compact_rows(pt.vertices[:, None], seed_ok, caps.match_cap)
    for step in plan.steps:
        rows = _row_of(pt, tbl[:, step.pivot]).long()
        cand = pt.adj[rows]                                   # [R, D]
        ok = valid[:, None] & (cand >= 0)
        ok &= pt.deg[_row_of(pt, cand).long()] >= step.min_degree   # MC₁ prune
        for j in range(tbl.shape[1]):                         # injectivity
            ok &= cand != tbl[:, j][:, None]
        for j in step.edge_checks:                            # extra edges
            ok &= _has_edge(pt, cand, tbl[:, j][:, None].expand_as(cand),
                            caps.use_kernels)
        for j, greater in step.ord_checks:                    # SimB order
            cu = tbl[:, j][:, None]
            ok &= (cand > cu) if greater else (cand < cu)
        tbl, valid, o = _compact_expand(tbl, cand, ok, caps.match_cap)
        ovf = ovf + o
    if require_edges is not None:
        valid = valid & require_edges_mask(tbl, plan.edge_cols, require_edges)
    return tbl, valid, ovf


def wcoj_list(pt: PaddedPartition, plan: WcojPlan, caps: EngineCaps,
              level_caps: Sequence[int], require_edges: torch.Tensor | None = None,
              seed_mask: torch.Tensor | None = None):
    """Anchored generic-join listing of a whole pattern (WCOJ executor).

    Each level gathers the pivot's adjacency, keeps the candidates that are
    adjacent to every other placed neighbour (``intersect_cols``, through
    :func:`_has_edge`) and packs the survivors, row-major over (row,
    candidate), into that level's cap; ``level_caps[0]`` caps the anchor
    seeds. Returns ``(table [level_caps[-1], |V|], valid, overflow)`` with
    columns aligned to ``plan.cols``, the drops of every level summed.
    ``require_edges`` (``[k, 2]``) keeps matches mapping ≥1 pattern edge
    into that edge set; ``seed_mask`` (``[v_cap]`` bool) restricts the
    anchor seeds (the delta candidates of an incremental batch).
    """
    k = len(plan.order)
    level_caps = tuple(int(c) for c in level_caps)
    if len(level_caps) != k:
        raise ValueError(f"need {k} level caps (incl. seed), got {len(level_caps)}")
    seed_ok = pt.center & (pt.vertices >= 0) & (pt.deg >= plan.anchor_min_degree)
    if seed_mask is not None:
        seed_ok = seed_ok & seed_mask
    tbl, valid, ovf = _compact_rows(pt.vertices[:, None], seed_ok, level_caps[0])
    for i, lv in enumerate(plan.levels, start=1):
        rows = _row_of(pt, tbl[:, lv.pivot]).long()
        cand = pt.adj[rows]                                   # [W_{i-1}, D]
        ok = valid[:, None] & (cand >= 0)
        ok &= pt.deg[_row_of(pt, cand).long()] >= lv.min_degree     # MC₁ prune
        for j in range(tbl.shape[1]):                         # injectivity
            ok &= cand != tbl[:, j][:, None]
        for j in lv.intersect_cols:                           # adjacency intersection
            ok &= _has_edge(pt, cand, tbl[:, j][:, None].expand_as(cand),
                            caps.use_kernels)
        for j, greater in lv.ord_checks:                      # SimB order
            cu = tbl[:, j][:, None]
            ok &= (cand > cu) if greater else (cand < cu)
        tbl, valid, o = _compact_expand(tbl, cand, ok, level_caps[i])
        ovf = ovf + o
    if require_edges is not None:
        valid = valid & require_edges_mask(tbl, plan.edge_cols, require_edges)
    return tbl, valid, ovf


def require_edges_mask(tbl: torch.Tensor, edge_cols: Sequence[tuple],
                       require_edges: torch.Tensor) -> torch.Tensor:
    """Rows of a plain match table mapping ≥1 pattern edge into a small
    replicated edge set (the Nav-join seed restriction, §VI-B step 2)."""
    ra = torch.minimum(require_edges[:, 0], require_edges[:, 1]).to(_I32)
    rb = torch.maximum(require_edges[:, 0], require_edges[:, 1]).to(_I32)
    hit = torch.zeros(tbl.shape[0], dtype=torch.bool, device=tbl.device)
    for ia, ib in edge_cols:
        lo = torch.minimum(tbl[:, ia], tbl[:, ib])
        hi = torch.maximum(tbl[:, ia], tbl[:, ib])
        hit |= ((lo[:, None] == ra[None, :]) & (hi[:, None] == rb[None, :])).any(dim=1)
    return hit


# ---------------------------------------------------------------------------
# Compression (plain table → CompTensors)
# ---------------------------------------------------------------------------

def _pack_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 key ordering int32 pairs lexicographically."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _lex_order(keys: torch.Tensor) -> torch.Tensor:
    """Row order sorting ``keys [N, C]`` lexicographically (col 0 primary):
    the stable-sort chain of ``jnp.lexsort``, least significant first, two
    int32 columns packed per int64 sort key."""
    n, c = keys.shape
    order = torch.arange(n, device=keys.device)
    j = c
    while j > 0:
        k = keys[order]
        key = _pack_key(k[:, j - 2], k[:, j - 1]) if j >= 2 else k[:, 0].to(torch.int64)
        order = order[_stable_order(key)]
        j -= 2
    return order


def group_rows(rows: torch.Tensor, ok: torch.Tensor, n_groups: int):
    """Assign group ids to the distinct valid rows of ``rows [N, S]``.

    Returns ``(skeleton [n_groups, S], gvalid, order, g_eff, dropped)``:
    ``order`` sorts the rows, ``g_eff [N]`` maps each sorted row to its
    group (``n_groups`` for invalid or overflowing rows).
    """
    G, S = n_groups, rows.shape[1]
    keys = torch.where(ok[:, None], rows.to(_I32), _BIG)
    order = _lex_order(keys) if S else _stable_order((~ok).to(torch.int8))
    ks = keys[order]
    vs_ = ok[order]
    if S:
        prev = torch.cat([_full((1, S), -2, ks), ks[:-1]], dim=0)
        newg = (ks != prev).any(dim=1) & vs_
    else:
        newg = torch.zeros_like(vs_)
        newg[:1] = True
        newg &= vs_
    gid = _cumsum(newg) - 1
    skeleton, gvalid, dropped = _compact_rows(ks, newg, G)
    g_eff = torch.where(vs_ & (gid < G), gid, G)
    return skeleton, gvalid, order, g_eff, dropped


def scatter_grouped_values(g: torch.Tensor, vals: torch.Tensor, n_groups: int,
                           set_cap: int):
    """Dedup a ``(group, value)`` stream and pack per-group ascending sets.

    ``g`` uses ``n_groups`` as the dump index. Returns
    ``([n_groups, set_cap] PAD-tailed sets, dropped unique values)``.
    """
    n = g.shape[0]
    o2 = _stable_order(_pack_key(g, vals))           # jnp.lexsort((vals, g))
    g2, v2 = g[o2].to(_I32), vals[o2].to(_I32)
    pv = g2 < n_groups
    prevg = torch.cat([_full((1,), -2, g2), g2[:-1]])
    prevv = torch.cat([_full((1,), -2, v2), v2[:-1]])
    isnew = pv & ((g2 != prevg) | (v2 != prevv))
    cum = _cumsum(isnew)                             # uniques up to & incl. i
    start = _ss(g2, _ar(n_groups + 1, g2)).long()
    cum0 = cum - isnew.to(_I32)                      # uniques strictly before i
    base = torch.where(start >= n, cum[-1], cum0[start.clamp(0, n - 1)])
    counts = base[1:] - base[:-1]
    dropped = _isum((counts - set_cap).clamp(min=0))
    out = torch.empty((n_groups, set_cap), dtype=_I32, device=g2.device)
    offs = _ar(set_cap, g2, start=1)
    for s in _row_slices(n_groups, set_cap):
        tgt = base[s][:, None] + offs[None, :]
        idx = _ss(cum, tgt.reshape(-1)).reshape(tgt.shape).clamp(0, n - 1)
        ok = offs[None, :] <= counts[s].clamp(max=set_cap)[:, None]
        out[s] = torch.where(ok, v2[idx], PAD)
    return out, dropped


def compress_plain(tbl: torch.Tensor, valid: torch.Tensor, cols: Sequence[int],
                   cover: Sequence[int], caps: EngineCaps):
    """Group a plain match table by its skeleton columns (§IV-A).

    Returns ``(CompTensors, skel_cols, overflow)``.
    """
    cols = tuple(int(c) for c in cols)
    cover_set = {int(c) for c in cover}
    skel_labels = tuple(c for c in sorted(cols) if c in cover_set)
    comp_labels = tuple(c for c in sorted(cols) if c not in cover_set)
    skel_idx = [cols.index(c) for c in skel_labels]
    G = caps.group_cap
    skel = tbl[:, skel_idx] if skel_labels else tbl[:, :0]
    skeleton, gvalid, order, g_eff, ovf = group_rows(skel, valid, G)
    sets: Dict[int, torch.Tensor] = {}
    for c in comp_labels:
        vals = tbl[:, cols.index(c)][order]
        sets[c], dropped = scatter_grouped_values(g_eff, vals, G, caps.set_cap)
        ovf = ovf + dropped
    return CompTensors(skeleton=skeleton, valid=gvalid, sets=sets), skel_labels, ovf


# ---------------------------------------------------------------------------
# Local CC-join (plan executor)
# ---------------------------------------------------------------------------

def _filter_set_rows(vals: torch.Tensor, ok: torch.Tensor, set_cap: int):
    """Re-pack each row's surviving values into a valid prefix (row-wise
    cumsum + ``searchsorted`` gather). Returns ``(packed, counts)``."""
    n, width = vals.shape
    out = torch.empty((n, set_cap), dtype=_I32, device=vals.device)
    counts = torch.empty(n, dtype=_I32, device=vals.device)
    tgt = _ar(set_cap, vals, start=1)
    for s in _row_slices(n, max(width, set_cap)):
        c = _cumsum(ok[s], dim=1)                       # [rows, C] nondecreasing
        counts[s] = c[:, -1]
        sel = _ss(c, tgt.expand(c.shape[0], set_cap))
        valid = tgt[None, :] <= counts[s].clamp(max=set_cap)[:, None]
        src = sel.clamp(0, width - 1).long()
        out[s] = torch.where(valid, torch.gather(vals[s].to(_I32), 1, src), PAD)
    return out, counts


def ccjoin_local(tA: CompTensors, tB: CompTensors, plan: JoinPlan, caps: EngineCaps):
    """Execute one CC-join plan on co-located compressed tensors.

    Returns ``(CompTensors, overflow)``; overflow counts pair slots beyond
    ``pair_cap`` and output groups beyond ``group_cap``.
    """
    GA, GB = tA.skeleton.shape[0], tB.skeleton.shape[0]
    # Each left group's first pair_cap partners, by row-wise cumsum +
    # searchsorted over the [GA, GB] key-equality mask, built a slice of
    # rows at a time (rows are independent).
    tgt = _ar(caps.pair_cap, tA.valid, start=1)
    row_tot = torch.empty(GA, dtype=_I32, device=tA.valid.device)
    sel = torch.empty((GA, caps.pair_cap), dtype=_I32, device=tA.valid.device)
    for s in _row_slices(GA, GB):
        eq = tA.valid[s][:, None] & tB.valid[None, :]
        for ka, kb in zip(plan.key_left_idx, plan.key_right_idx):
            eq &= tA.skeleton[s, ka][:, None] == tB.skeleton[:, kb][None, :]
        cnt = _cumsum(eq, dim=1)                             # [rows, GB]
        row_tot[s] = cnt[:, -1]
        sel[s] = _ss(cnt, tgt.expand(cnt.shape[0], caps.pair_cap))
    ovf = _isum((row_tot - caps.pair_cap).clamp(min=0))
    pslot = tgt[None, :] <= row_tot.clamp(max=caps.pair_cap)[:, None]
    pair_b = torch.where(pslot, sel.clamp(0, GB - 1), -1).reshape(-1)
    pvalid = pair_b >= 0                                     # [GA * pair_cap]
    ga = _ar(GA, pair_b).repeat_interleave(caps.pair_cap)
    gb = pair_b.clamp(0, GB - 1)
    gal, gbl = ga.long(), gb.long()

    n_out = len(plan.skel_out)
    s3 = torch.zeros((ga.shape[0], n_out), dtype=_I32, device=ga.device)
    for out_j, left_j in plan.out_from_left:
        s3[:, out_j] = tA.skeleton[gal, left_j]
    for out_j, right_j in plan.out_from_right:
        s3[:, out_j] = tB.skeleton[gbl, right_j]
    for ja, jb in plan.pair_neq:
        pvalid &= s3[:, ja] != s3[:, jb]
    for ja, jb in plan.pair_ord:
        pvalid &= s3[:, ja] < s3[:, jb]

    triple = torch.cat([s3, ga[:, None], gb[:, None]], dim=1)
    packed, out_valid, o2 = _compact_rows(triple, pvalid, caps.group_cap)
    ovf = ovf + o2
    out_skel = packed[:, :n_out].contiguous()
    ga_c = packed[:, n_out].clamp(0, GA - 1).long()
    gb_c = packed[:, n_out + 1].clamp(0, GB - 1).long()

    sets: Dict[int, torch.Tensor] = {}
    for cp in plan.comp:
        v = cp.vertex
        if cp.source == "both":
            vals = tA.sets[v][ga_c]
            ok = ops.set_intersect(vals, tB.sets[v][gb_c], pad=PAD,
                                   use_kernels=caps.use_kernels)
        elif cp.source == "left":
            vals = tA.sets[v][ga_c]
            ok = vals >= 0
        else:
            vals = tB.sets[v][gb_c]
            ok = vals >= 0
        for col, mode in cp.checks:
            sv = out_skel[:, col][:, None]
            if mode == NEQ:
                ok &= vals != sv
            elif mode == LT:
                ok &= vals < sv
            else:
                ok &= vals > sv
        packed_vals, counts = _filter_set_rows(vals, ok & out_valid[:, None], caps.set_cap)
        sets[v] = packed_vals
        out_valid = out_valid & (counts > 0)   # host drops empty-set groups
    return CompTensors(skeleton=out_skel, valid=out_valid, sets=sets), ovf


# ---------------------------------------------------------------------------
# Candidate-restricted update primitives (Alg. 4 C1–C3 on device)
# ---------------------------------------------------------------------------

def dedup_rows(rows: torch.Tensor, ok: torch.Tensor, cap: int):
    """Unique valid rows, lexicographically ascending, packed to ``cap``:
    ``([cap, C] PAD-filled, valid, dropped_unique)``."""
    skeleton, valid, _, _, dropped = group_rows(rows, ok, cap)
    return skeleton, valid, dropped


def lookup_sorted(table: torch.Tensor, q: torch.Tensor):
    """Position of ``q`` in an ascending PAD-tailed id table: ``(idx, hit)``
    with ``idx`` clipped so callers can gather unconditionally."""
    t = torch.where(table < 0, _BIG, table)
    idx = _ss(t, q.to(_I32)).clamp(0, table.shape[0] - 1)
    hit = (table[idx.long()] == q) & (q >= 0)
    return idx, hit


def edge_probe(q_hi, q_lo, t_hi, t_lo, use_kernels: bool = False):
    """Membership of ``(hi, lo)`` query pairs in an edge table sorted
    lexicographically with ``(-1, -1)`` pads at the tail: the
    ``member_probe`` kernel, or its plain version."""
    hit = ops.member_probe(q_hi.reshape(-1), q_lo.reshape(-1), t_hi, t_lo,
                           use_kernels=use_kernels)
    return hit.reshape(q_hi.shape)


def center_adj_contrib(pt: PaddedPartition, ids: torch.Tensor, ok: torch.Tensor):
    """This partition's (+1-encoded) adjacency rows for candidate ids: only
    the center copy of a vertex contributes; callers sum over partitions
    and subtract 1."""
    row = _row_of(pt, ids).long()
    hit = ok & (ids >= 0) & (pt.vertices[row] == ids) & pt.center[row]
    return torch.where(hit[:, None], pt.adj[row] + 1, 0).to(_I32)


def apply_edge_delta_rows(ids, rows, add, dele, nv_limit: int,
                          count_overflow: bool = True):
    """Apply one edge batch to the adjacency rows of ``ids``.

    ``rows [K, D]`` PAD-tailed ascending; ``add``/``dele`` ``[T, 2]`` with
    negative rows as padding. Deletes mask matching neighbors, adds insert
    idempotently into the first free slot (rows without one count toward
    the overflow), endpoints ≥ ``nv_limit`` are skipped. Rows come back
    re-sorted with PAD tails. Returns ``(rows, overflow)``.
    """
    r = torch.where(rows < 0, _BIG, rows.to(_I32))
    ovf = _zero(rows)
    for t in range(dele.shape[0]):
        a, b = dele[t, 0], dele[t, 1]
        for u, w in ((a, b), (b, a)):
            sel = (ids == u) & (u >= 0)
            r = torch.where(sel[:, None] & (r == w), _BIG, r)
    for t in range(add.shape[0]):
        a, b = add[t, 0], add[t, 1]
        bad = (a < 0) | (b < 0) | (a >= nv_limit) | (b >= nv_limit)
        for u, w in ((a, b), (b, a)):
            sel = (ids == u) & ~bad
            present = (r == w).any(dim=1)
            free = r == _BIG
            has = free.any(dim=1)
            slot = torch.argmax(free.to(torch.int8), dim=1, keepdim=True)
            ins = sel & has & ~present
            if count_overflow:
                ovf = ovf + _isum(sel & ~has & ~present)
            cur = torch.gather(r, 1, slot)
            r = r.scatter(1, slot, torch.where(ins[:, None], w.to(_I32), cur))
    r = torch.sort(r, dim=1).values
    return torch.where(r == _BIG, PAD, r), ovf


def patch_partition(pt: PaddedPartition, cand, cand_valid, drop_hi, drop_lo,
                    ins_hi, ins_lo, ins_ok, nv_glob: int, m: int, me: int,
                    caps: EngineCaps):
    """Patch a stored partition: drop then insert edge sets.

    ``cand`` is the ascending PAD-tailed candidate vertex table (every
    dropped or inserted edge has both endpoints in it); ``(drop_hi,
    drop_lo)`` a lex-sorted PAD-tailed edge table; ``(ins_hi, ins_lo,
    ins_ok)`` deduped (min, max) insertions disjoint from the surviving
    edges. Produces the canonical layout; returns ``(partition, overflow)``.
    """
    D = caps.deg_cap
    K = cand.shape[0]
    # 1. candidate rows in the old layout, drop-probed
    oci, och = lookup_sorted(pt.vertices, cand)
    crow = torch.where((och & cand_valid)[:, None], pt.adj[oci.long()], PAD)
    cvv = cand[:, None].expand_as(crow)
    hit_drop = edge_probe(torch.minimum(cvv, crow), torch.maximum(cvv, crow),
                          drop_hi, drop_lo, use_kernels=caps.use_kernels)
    ckeep = torch.where((crow >= 0) & ~hit_drop, crow, _BIG)

    # 2. insertion neighbor sets grouped by candidate index
    src = torch.cat([ins_hi, ins_lo]).to(_I32)
    dst = torch.cat([ins_lo, ins_hi]).to(_I32)
    s_ok = torch.cat([ins_ok, ins_ok])
    gidx, ghit = lookup_sorted(cand, src)
    g = torch.where(ghit & s_ok & (dst >= 0), gidx, K)
    ins_adj, o2 = scatter_grouped_values(g, dst, K, D)

    # 3. merged candidate member rows (candidate-sized row sort)
    cmerged = torch.sort(torch.cat(
        [ckeep, torch.where(ins_adj < 0, _BIG, ins_adj)], dim=1), dim=1).values
    ccnt = _isum_rows(cmerged != _BIG)
    o3 = _isum(torch.where(cand_valid, (ccnt - D).clamp(min=0), 0))
    crows = cmerged[:, :D]
    crows = torch.where(crows == _BIG, PAD, crows)

    # 4. new vertex set: bitmap + cumsum compaction
    mark = torch.zeros(nv_glob + 1, dtype=torch.bool, device=cand.device)
    vold = torch.where((pt.vertices >= 0) & (pt.vertices < nv_glob) & (pt.deg > 0),
                       pt.vertices, nv_glob)
    mark[vold.long()] = True
    cdump = torch.where(cand_valid & (cand >= 0) & (cand < nv_glob), cand, nv_glob)
    mark[cdump.long()] = cand_valid & (ccnt > 0)
    vertices, vvalid, o1 = _compact_vec(_ar(nv_glob, cand), mark[:nv_glob], caps.v_cap,
                                        fill=PAD)

    # 5. adjacency in the new layout: gather unchanged rows, overwrite
    #    candidate rows
    oidx, ohit = lookup_sorted(pt.vertices, vertices)
    live = ohit & vvalid
    adj = torch.where(live[:, None], pt.adj[oidx.long()], PAD)
    deg = torch.where(live, pt.deg[oidx.long()], 0).to(_I32)
    nidx, nhit = lookup_sorted(vertices, cand)
    wr = torch.where(cand_valid & nhit, nidx, caps.v_cap).long()
    adj = torch.cat([adj, _full((1, D), PAD, adj)], dim=0)
    adj[wr] = crows
    adj = adj[: caps.v_cap]
    deg = torch.cat([deg, torch.zeros(1, dtype=_I32, device=deg.device)])
    deg[wr] = ccnt.clamp(max=D)
    deg = deg[: caps.v_cap]
    center = vvalid & (vertices >= 0) & (vertices % m == me)

    # 6. canonical edge list: merge of the surviving stored list with the
    #    (sorted, disjoint) insertions by binary-search ranks
    keep_e = (pt.edge_hi >= 0) & ~edge_probe(pt.edge_hi, pt.edge_lo, drop_hi, drop_lo,
                                             use_kernels=caps.use_kernels)
    ak, akv, _ = _compact_rows(torch.stack([pt.edge_hi, pt.edge_lo], dim=1), keep_e,
                               caps.e_cap)
    n_ins = ins_hi.shape[0]
    bk, bkv, _ = _compact_rows(torch.stack([ins_hi, ins_lo], dim=1), ins_ok, n_ins)
    a_hi = torch.where(akv, ak[:, 0], _BIG)
    a_lo = torch.where(akv, ak[:, 1], _BIG)
    b_hi = torch.where(bkv, bk[:, 0], _BIG)
    b_lo = torch.where(bkv, bk[:, 1], _BIG)
    pos_a = _ar(caps.e_cap, ak) + _lower_bound_pairs(a_hi, a_lo, b_hi, b_lo)
    pos_b = _ar(n_ins, bk) + _lower_bound_pairs(b_hi, b_lo, a_hi, a_lo)
    n_total = _isum(akv) + _isum(bkv)
    o4 = (n_total - caps.e_cap).clamp(min=0)
    out = _full((caps.e_cap + 1, 2), PAD, ak)
    out[torch.where(akv & (pos_a < caps.e_cap), pos_a, caps.e_cap).long()] = ak
    out[torch.where(bkv & (pos_b < caps.e_cap), pos_b, caps.e_cap).long()] = bk
    part = PaddedPartition(vertices=vertices, center=center, deg=deg, adj=adj,
                           edge_hi=out[: caps.e_cap, 0].contiguous(),
                           edge_lo=out[: caps.e_cap, 1].contiguous())
    return part, o1 + o2 + o3 + o4


# ---------------------------------------------------------------------------
# Device-resident match maintenance (§VI filter + merge + count)
# ---------------------------------------------------------------------------

def deleted_edge_cols(pattern: Pattern, skel_cols: Sequence[int]):
    """Split pattern edges for the compressed-form delete filter into
    skeleton–skeleton column pairs and (compressed label, skeleton column)
    pairs."""
    sidx = {int(c): j for j, c in enumerate(skel_cols)}
    skel_pairs, comp_pairs = set(), set()
    for a, b in pattern.edges:
        if a in sidx and b in sidx:
            skel_pairs.add((sidx[a], sidx[b]))
        elif a in sidx:
            comp_pairs.add((int(b), sidx[a]))
        elif b in sidx:
            comp_pairs.add((int(a), sidx[b]))
        else:
            raise ValueError(f"pattern edge ({a},{b}) has no cover endpoint")
    return tuple(sorted(skel_pairs)), tuple(sorted(comp_pairs))


def filter_deleted_dev(tc: CompTensors, skel_pairs, comp_pairs, del_hi, del_lo,
                       set_cap: int, use_kernels: bool = False):
    """Drop matches mapping any pattern edge into ``E_d`` (Lemma 6.1).

    ``(del_hi, del_lo)`` is a lex-sorted PAD-tailed edge table. Returns
    ``(CompTensors, removed_groups)``.
    """
    valid = tc.valid
    before = _isum(valid)
    for ia, ib in skel_pairs:
        a, b = tc.skeleton[:, ia], tc.skeleton[:, ib]
        hit = edge_probe(torch.minimum(a, b), torch.maximum(a, b), del_hi, del_lo,
                         use_kernels=use_kernels)
        valid = valid & ~hit
    keep = {v: tc.sets[v] >= 0 for v in tc.sets}
    for v, j in comp_pairs:
        vals = tc.sets[v]
        sv = tc.skeleton[:, j][:, None].expand_as(vals)
        hit = edge_probe(torch.minimum(vals, sv), torch.maximum(vals, sv),
                         del_hi, del_lo, use_kernels=use_kernels)
        keep[v] = keep[v] & ~hit
    sets: Dict[int, torch.Tensor] = {}
    for v in tc.sets:
        packed, counts = _filter_set_rows(tc.sets[v], keep[v] & valid[:, None], set_cap)
        sets[v] = packed
        valid = valid & (counts > 0)
    removed = before - _isum(valid)
    return CompTensors(skeleton=tc.skeleton, valid=valid, sets=sets), removed


def merge_groups(rows: torch.Tensor, ok: torch.Tensor, sets_in: Dict[int, torch.Tensor],
                 group_cap: int, set_cap: int):
    """Regroup rows by identical skeleton, unioning per-vertex sets.
    Returns ``(CompTensors, overflow)``."""
    skeleton, gvalid, order, g_eff, ovf = group_rows(rows, ok, group_cap)
    sets_out: Dict[int, torch.Tensor] = {}
    for v, arr in sets_in.items():
        a = arr[order]                                        # [N, set_cap]
        vals = a.reshape(-1)
        g_rep = g_eff[:, None].expand(a.shape).reshape(-1)
        g_rep = torch.where(vals >= 0, g_rep, group_cap)
        sets_out[v], dropped = scatter_grouped_values(g_rep, vals, group_cap, set_cap)
        ovf = ovf + dropped
    return CompTensors(skeleton=skeleton, valid=gvalid, sets=sets_out), ovf


def _pad_set_width(arr: torch.Tensor, width: int) -> torch.Tensor:
    if arr.shape[1] >= width:
        return arr
    return torch.cat([arr, _full((arr.shape[0], width - arr.shape[1]), PAD, arr)], dim=1)


def merge_tables_dev(tA: CompTensors, tB: CompTensors, group_cap: int, set_cap: int):
    """Union of two compressed tensors of one pattern; each side's valid
    skeletons must be distinct. Returns ``(CompTensors, overflow)`` in
    canonical form (lex-sorted skeletons, ascending sets)."""
    GA, GB = tA.skeleton.shape[0], tB.skeleton.shape[0]
    rows = torch.cat([tA.skeleton, tB.skeleton], dim=0)
    ok = torch.cat([tA.valid, tB.valid])
    skeleton, gvalid, order, g_eff, ovf = group_rows(rows, ok, group_cap)
    n = rows.shape[0]
    gids = _ar(group_cap, rows)
    first = _ss(g_eff, gids).long()
    second = (first + 1).clamp(0, n - 1)
    has2 = (first + 1 < n) & (g_eff[second] == gids)
    src1 = order[first.clamp(0, n - 1)]
    src2 = order[second]
    sets_out: Dict[int, torch.Tensor] = {}
    for v in tA.sets:
        w = max(tA.sets[v].shape[1], tB.sets[v].shape[1])
        a_all = _pad_set_width(tA.sets[v], w)
        b_all = _pad_set_width(tB.sets[v], w)

        def pick(src):
            a = a_all[src.clamp(0, GA - 1)]
            b = b_all[(src - GA).clamp(0, GB - 1)]
            return torch.where((src < GA)[:, None], a, b)

        packed = torch.empty((group_cap, set_cap), dtype=_I32, device=rows.device)
        for s in _row_slices(group_cap, 2 * w):
            s1 = pick(src1[s])
            s2 = torch.where(has2[s][:, None], pick(src2[s]), PAD)
            cat = torch.cat([s1, s2], dim=1)
            key = torch.sort(torch.where(cat < 0, _BIG, cat), dim=1).values
            prev = torch.cat([_full((key.shape[0], 1), -2, key), key[:, :-1]], dim=1)
            uniq = (key != prev) & (key != _BIG) & gvalid[s][:, None]
            packed[s], counts = _filter_set_rows(key, uniq, set_cap)
            ovf = ovf + _isum((counts - set_cap).clamp(min=0))
        sets_out[v] = packed
    return CompTensors(skeleton=skeleton, valid=gvalid, sets=sets_out), ovf


def count_matches_dev(tc: CompTensors, skel_cols: Sequence[int], ord_) -> torch.Tensor:
    """``|M|`` of a compressed tensor without materializing rows (an int64
    scalar; callers sum over partitions).

    Per group, the number of injective compressed-vertex assignments that
    satisfy the symmetry-breaking order. Two compressed vertices count their
    pair mask; three or more contract the pair masks in float64 (exact for
    counts below 2**53, CUDA has no integer matmul). The group axis is
    sliced so that neither a ``[groups, width, width]`` pair mask nor the
    contraction's ``[groups, width**(k-1)]`` intermediate passes
    ``_SLICE_CELLS``.
    """
    ord_set = {(int(a), int(b)) for a, b in ord_}
    comp = sorted(int(v) for v in tc.sets)
    if not comp:
        return tc.valid.sum(dtype=torch.int64)
    kv: Dict[int, torch.Tensor] = {}
    for v in comp:
        vals = tc.sets[v]
        ok = (vals >= 0) & tc.valid[:, None]
        for j, c in enumerate(skel_cols):
            sv = tc.skeleton[:, j][:, None]
            ok = ok & (vals != sv)
            if (v, int(c)) in ord_set:
                ok = ok & (vals < sv)
            if (int(c), v) in ord_set:
                ok = ok & (vals > sv)
        kv[v] = ok
    if len(comp) == 1:
        return kv[comp[0]].sum(dtype=torch.int64)
    letters = {v: "abcdefhijklmnopqrstuvwxyz"[i] for i, v in enumerate(comp)}
    G = tc.valid.shape[0]
    width = max(tc.sets[v].shape[1] for v in comp)
    step = max(1, _SLICE_CELLS // (width ** max(2, len(comp) - 1)))
    total = torch.zeros((), dtype=torch.int64, device=tc.valid.device)
    for s in range(0, G, step):
        operands, subs = [], []
        for i, u in enumerate(comp):
            for w in comp[i + 1:]:
                a, b = tc.sets[u][s:s + step], tc.sets[w][s:s + step]
                ok = (kv[u][s:s + step, :, None] & kv[w][s:s + step, None, :]
                      & (a[:, :, None] != b[:, None, :]))
                if (u, w) in ord_set:
                    ok = ok & (a[:, :, None] < b[:, None, :])
                if (w, u) in ord_set:
                    ok = ok & (a[:, :, None] > b[:, None, :])
                operands.append(ok)
                subs.append(f"g{letters[u]}{letters[w]}")
        if len(comp) == 2:
            total = total + torch.count_nonzero(operands[0])
        else:
            per = torch.einsum(",".join(subs) + "->g",
                               *[op.to(torch.float64) for op in operands])
            total = total + per.round().to(torch.int64).sum()
    return total


def comp_to_host(tc: CompTensors, pattern: Pattern, cover: Sequence[int],
                 skel_cols: Sequence[int]) -> CompressedTable:
    """Padded VCBC tensors back into a host
    :class:`~repro_torch.core.vcbc.CompressedTable` (twin of
    ``jax_engine.comp_to_host``). ``tc`` holds NumPy arrays or CPU tensors;
    a device table is pulled to the host first (``TorchBackend._pull``)."""
    skel = np.asarray(tc.skeleton, np.int64)
    valid = np.asarray(tc.valid, bool)
    keep = np.nonzero(valid)[0]
    rows = skel[keep]
    comp: Dict[int, Ragged] = {}
    for v in sorted(int(k) for k in tc.sets):
        a = np.asarray(tc.sets[v], np.int64)[keep]
        g, s = np.nonzero(a >= 0)
        comp[int(v)] = Ragged.from_group_ids(g.astype(np.int64), a[g, s], rows.shape[0])
    return CompressedTable(pattern=pattern, cover=tuple(sorted(int(c) for c in cover)),
                           skeleton_cols=tuple(int(c) for c in skel_cols), skeleton=rows,
                           comp=comp)
