"""Whole join-tree programs over ``m`` NP partitions.

Port of ``repro/dist/sharded.py`` (its ``*_specs`` helpers have no role
here). Partition ``j`` holds the centers ``h(v) = v mod m``. A process
holds the partitions ``mesh.indices()`` of its mesh as a leading axis of
every input and output (all ``m`` on a
:class:`~repro_torch.mesh.LocalMesh`, ``m / world`` on each rank of a
:class:`~repro_torch.mesh.ProcessMesh`, indexed there by local position);
each step loops over them and meets the other partitions only through the
mesh's collectives, where the JAX step calls ``lax.all_gather`` /
``lax.psum``, and compares ownership against the global ids. Work that
the JAX step repeats on every device on replicated values (the candidate
sets of the storage update, the common-neighbour test of the full
rebuild, the ownership hash of gathered groups) runs once a process.

- :func:`make_list_step` — stage 1: unit listing per partition, then each
  CC-join redistributes groups by join-key ownership and joins locally.
- :func:`make_init_store_step` — the initial listing regrouped into the
  sharded :class:`MatchStore` and counted.
- :func:`make_wcoj_list_step` / :func:`make_wcoj_init_store_step` — the
  same for the generic-join executor: plain match rows per partition, kept
  as a table whose skeleton is every pattern vertex and whose sets are
  empty.
- :func:`make_unit_refresh_step` — the cold fill of a pattern's
  unit-table carry (:class:`UnitCarry`).
- :func:`make_storage_update_step` — Alg. 4: the candidate-restricted
  update (``mode="delta"``) or the full-gather rebuild that it is held
  against (``mode="full"``).
- :func:`make_patch_step` / :func:`make_update_step` — the Nav-join patch
  over the updated partitions, alone or fused behind the storage update.
- :func:`make_maintain_step` — Nav-join patch ∘ Lemma 6.1 delete filter ∘
  merge ∘ count over the updated partitions, with or without the carry.
- :func:`make_maintain_mega_step` — the same for every registered pattern
  in one call (:class:`MaintainSpec`), the streaming service's batch step;
  a slot runs a join tree with its unit-table carry, or the generic join
  seeded from the batch's delta candidates.

Every step reports overflow through explicit counters in its ``diag``
dict (0-d tensors, summed over partitions like the JAX ``psum``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import engine as je
from .core.match_engine import ragged_expand
from .core.navjoin import left_deep_order
from .core.pattern import Pattern, R1Unit
from .core.plan import JoinPlan, UnitPlan, WcojPlan, build_unit_plan
from .core.storage import NPStorage
from .engine import (PAD, CompTensors, EngineCaps, PaddedPartition, _BIG, _I32, _isum,
                     _isum_rows)
from .mesh import LocalMesh, ProcessMesh
from .planner.lowering import TreeProgram
from .planner.sizing import StoreCaps, match_caps, unit_table_caps

Mesh = Union[LocalMesh, ProcessMesh]

__all__ = [
    "stack_partitions", "make_list_step", "UpdateShapes", "make_storage_update_step",
    "make_patch_step", "make_update_step", "MatchStore", "StoreCaps", "match_caps",
    "UnitCarry", "unit_plan_registry", "unit_table_caps", "make_unit_refresh_step",
    "make_init_store_step", "make_wcoj_list_step", "make_wcoj_init_store_step",
    "make_maintain_step", "MaintainSpec", "make_maintain_mega_step", "stack_matches",
]


# ---------------------------------------------------------------------------
# Stacked inputs
# ---------------------------------------------------------------------------

def stack_partitions(storage: NPStorage, caps: EngineCaps, device="cuda",
                     parts: Optional[Sequence[int]] = None) -> PaddedPartition:
    """Pad the partitions ``parts`` (default: all of them, in order) and
    stack them along a leading partition axis."""
    ids = range(len(storage.parts)) if parts is None else parts
    return _stack([je.pad_partition(storage.parts[j], caps, device) for j in ids])


def _stack(xs):
    """Stack per-partition dataclasses along a new leading partition axis."""
    out = {}
    for f in dataclasses.fields(xs[0]):
        v0 = getattr(xs[0], f.name)
        if isinstance(v0, dict):
            out[f.name] = {k: torch.stack([getattr(x, f.name)[k] for x in xs]) for k in v0}
        else:
            out[f.name] = torch.stack([getattr(x, f.name) for x in xs])
    return type(xs[0])(**out)


def _put(out, k: int, j: int, x):
    """Write ``x`` as local partition ``j`` of a stacked dataclass of ``k``
    partitions (allocated on first write, ``out=None``) and return it, so
    a step holds one shard's result at a time instead of ``k``."""
    if out is None:
        out = je.map_tensors(
            lambda a: torch.empty((k,) + tuple(a.shape), dtype=a.dtype, device=a.device), x)
    _copy_into(out, j, x)
    return out


def _copy_into(dst, j: int, x) -> None:
    for f in dataclasses.fields(x):
        v, d = getattr(x, f.name), getattr(dst, f.name)
        if isinstance(v, dict):
            for k, a in v.items():
                d[k][j].copy_(a)
        elif dataclasses.is_dataclass(v):
            _copy_into(d, j, v)
        else:
            d[j].copy_(v)


def _part(x, j: int):
    """Local partition ``j`` of a stacked dataclass."""
    return je.map_tensors(lambda a: a[j], x)


def _parts(x, mesh: Mesh) -> list:
    """Every local partition of a stacked dataclass, in ``mesh.indices()``
    order."""
    return [_part(x, j) for j in range(mesh.local)]


def _psum_flags(flags: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The number of set per-partition flags over the whole mesh."""
    return mesh.psum([_isum(f) for f in flags])


def _comp(x) -> CompTensors:
    return CompTensors(skeleton=x.skeleton, valid=x.valid, sets=dict(x.sets))


# ---------------------------------------------------------------------------
# Distributed CC-join: all-gather + join-key ownership + local join
# ---------------------------------------------------------------------------

def _owner_of(skel: torch.Tensor, key_idx: Sequence[int], m: int) -> torch.Tensor:
    """Join-key → partition hash, wrapping in int32 like the JAX mesh."""
    h = torch.zeros(skel.shape[0], dtype=_I32, device=skel.device)
    for j in key_idx:
        h = h * 1000003 + skel[:, j]
    return ((h % m) + m) % m


def _gather_groups(tcs: Sequence[CompTensors], mesh: Mesh) -> CompTensors:
    return CompTensors(
        skeleton=mesh.all_gather([t.skeleton for t in tcs]),
        valid=mesh.all_gather([t.valid for t in tcs]),
        sets={v: mesh.all_gather([t.sets[v] for t in tcs]) for v in tcs[0].sets})


def _gather_group_list(tcs: Sequence[CompTensors], mesh: Mesh) -> List[CompTensors]:
    """Every partition's table, partition 0 first: the local tables
    themselves on a :class:`LocalMesh`, views of one gather on a
    :class:`ProcessMesh`."""
    if mesh.world == 1:
        return list(tcs)
    g = _gather_groups(tcs, mesh)
    n = tcs[0].valid.shape[0]
    return [je.map_tensors(lambda a: a[d * n:(d + 1) * n], g) for d in range(mesh.size)]


def _compact_groups(tc: CompTensors, ok: torch.Tensor, cap: int):
    """Pack the ``ok`` groups into ``cap`` slots (gather form); count drops."""
    src, valid, dropped = je._take_index(ok, cap)
    src = src.long()

    def pack(arr):
        return torch.where(valid.reshape((-1,) + (1,) * (arr.dim() - 1)), arr[src], PAD)

    return CompTensors(skeleton=pack(tc.skeleton), valid=valid,
                       sets={v: pack(a) for v, a in tc.sets.items()}), dropped


def _dist_join(tcAs: Sequence[CompTensors], tcBs: Sequence[CompTensors], plan: JoinPlan,
               caps: EngineCaps, mesh: Mesh):
    """Redistribute both sides by join-key ownership, then join locally on
    every partition. Returns the per-partition outputs and overflows."""
    m = mesh.size
    gA = _gather_groups(tcAs, mesh)
    gB = _gather_groups(tcBs, mesh)
    ownA = _owner_of(gA.skeleton, plan.key_left_idx, m)
    ownB = _owner_of(gB.skeleton, plan.key_right_idx, m)
    outs, ovfs = [], []
    for me in mesh.indices():
        tA2, o1 = _compact_groups(gA, gA.valid & (ownA == me), caps.group_cap)
        tB2, o2 = _compact_groups(gB, gB.valid & (ownB == me), caps.group_cap)
        out, o3 = je.ccjoin_local(tA2, tB2, plan, caps)
        outs.append(out)
        ovfs.append(o1 + o2 + o3)
    return outs, ovfs


# ---------------------------------------------------------------------------
# Stage 1: distributed initial calculation
# ---------------------------------------------------------------------------

def make_list_step(prog: TreeProgram, mesh: Mesh, caps: EngineCaps):
    """Step: stacked partitions → (stacked root CompTensors, diag) with
    ``diag`` = ``overflow``, ``matches_lower_bound`` (valid root groups)."""

    def step(pt_st: PaddedPartition):
        pts = _parts(pt_st, mesh)
        ovf = [je._zero(pt_st.vertices) for _ in pts]
        res: List[List[CompTensors]] = []
        for node in prog.nodes:
            if node.unit_plan is not None:
                tcs = []
                for j, pt in enumerate(pts):
                    tbl, valid, o1 = je.unit_list(pt, node.unit_plan, caps)
                    tc, _, o2 = je.compress_plain(tbl, valid, node.unit_plan.cols,
                                                  prog.cover, caps)
                    del tbl, valid
                    ovf[j] = ovf[j] + o1 + o2
                    tcs.append(tc)
            else:
                tcs, o = _dist_join(res[node.left], res[node.right], node.join_plan,
                                    caps, mesh)
                ovf = [a + b for a, b in zip(ovf, o)]
            res.append(tcs)
        root = res[prog.root]
        diag = {
            "overflow": mesh.psum(ovf),
            "matches_lower_bound": mesh.psum([_isum(t.valid) for t in root]),
        }
        return _stack(root), diag

    return step


# ---------------------------------------------------------------------------
# Stage 2: storage update
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UpdateShapes:
    """Static batch-update shape model (twin of ``sharded.UpdateShapes``).

    ``cand_cap`` / ``cedge_cap`` bound the candidate vertex and edge sets
    of the delta update; ``None`` derives bounds that can never overflow.
    """

    n_add: int
    n_del: int
    cand_cap: Optional[int] = None
    cedge_cap: Optional[int] = None

    def delta_caps(self, caps: EngineCaps, m: int) -> Tuple[int, int, int]:
        """Resolved ``(c1_cap, cand_cap, cedge_cap)`` for ``m`` partitions."""
        c1_cap = max(2 * (self.n_add + self.n_del), 1)
        nv_glob = m * caps.v_cap
        cand = self.cand_cap if self.cand_cap is not None else min(
            nv_glob, c1_cap * (caps.deg_cap + 1))
        cedge = self.cedge_cap if self.cedge_cap is not None else c1_cap * caps.deg_cap
        return c1_cap, max(cand, 1), max(cedge, 1)

    @staticmethod
    def from_estimator(n_add: int, n_del: int, stats, caps: EngineCaps,
                       m: int, safety: float = 8.0) -> "UpdateShapes":
        """Candidate caps from the size-biased mean degree ``T(2)/T(1)``,
        scaled by ``safety`` and clamped to the never-overflow bound."""
        c1 = max(2 * (n_add + n_del), 1)
        t1 = stats.t_term(1)
        if t1 <= 0.0:
            return UpdateShapes(n_add=n_add, n_del=n_del)
        sb_deg = max(stats.t_term(2) / t1, 1.0)
        exp_nbrs = int(np.ceil(safety * sb_deg))
        nv_glob = m * caps.v_cap
        cand_no = min(nv_glob, c1 * (caps.deg_cap + 1))
        cedge_no = c1 * caps.deg_cap
        return UpdateShapes(
            n_add=n_add, n_del=n_del,
            cand_cap=max(min(cand_no, c1 * (exp_nbrs + 1)), 1),
            cedge_cap=max(min(cedge_no, c1 * exp_nbrs), 1),
        )


def _delta_update_body(pts: List[PaddedPartition], add: torch.Tensor, dele: torch.Tensor,
                       mesh: Mesh, caps: EngineCaps, ushapes: UpdateShapes):
    """Candidate-restricted Alg. 4 (C1–C3): ``Φ(d) → Φ(d')`` from the delta.

    C1 = endpoints of the batch, C2 = C1 ∪ N_{d'}(C1) (rows gathered from
    the partition centers by one psum), C3 = the d'-edges incident to C1,
    whose NP membership is re-evaluated per partition; the stored
    partitions are then patched. Returns the new partitions, the
    per-partition overflows and the replicated counters.
    """
    m = mesh.size
    nv_glob = m * caps.v_cap
    c1_cap, cand_cap, cedge_cap = ushapes.delta_caps(caps, m)
    add = add.to(_I32)
    dele = dele.to(_I32)

    # ---- replicated: candidate sets and rows (once for all partitions) --
    rep = _isum((add >= nv_glob).any(dim=1))
    ends = torch.cat([add.reshape(-1), dele.reshape(-1)])
    e_ok = (ends >= 0) & (ends < nv_glob)
    c1_t, c1_valid, o1 = je.dedup_rows(ends[:, None], e_ok, c1_cap)
    c1 = c1_t[:, 0].contiguous()

    rows1 = mesh.psum([je.center_adj_contrib(pt, c1, c1_valid) for pt in pts]) - 1
    rows1, _ = je.apply_edge_delta_rows(c1, rows1, add, dele, nv_glob,
                                        count_overflow=False)
    cids = torch.cat([c1, rows1.reshape(-1)])
    cand_t, cand_valid, o2 = je.dedup_rows(cids[:, None], cids >= 0, cand_cap)
    cand = cand_t[:, 0].contiguous()

    rows_c = mesh.psum([je.center_adj_contrib(pt, cand, cand_valid) for pt in pts]) - 1
    rows_c, o3 = je.apply_edge_delta_rows(cand, rows_c, add, dele, nv_glob)

    i1, h1 = je.lookup_sorted(cand, c1)
    nb = torch.where(h1[:, None], rows_c[i1.long()], PAD)
    vv = c1[:, None].expand_as(nb)
    pair_ok = c1_valid[:, None] & (nb >= 0)
    pairs = torch.stack([torch.minimum(vv, nb).reshape(-1),
                         torch.maximum(vv, nb).reshape(-1)], dim=1)
    ce, ce_valid, o4 = je.dedup_rows(pairs, pair_ok.reshape(-1), cedge_cap)
    rep = rep + o1 + o2 + o3 + o4

    ia, ha = je.lookup_sorted(cand, ce[:, 0])
    ib, hb = je.lookup_sorted(cand, ce[:, 1])
    ra = torch.where((ce_valid & ha)[:, None], rows_c[ia.long()], PAD)
    rb = torch.where((ce_valid & hb)[:, None], rows_c[ib.long()], PAD)
    # z ∈ N(a) ∩ N(b): membership of each row of ra in the row of rb — the
    # set_intersect predicate ([cedge_cap, deg_cap, deg_cap] if broadcast)
    zcommon = je.ops.set_intersect(ra, rb, pad=PAD, use_kernels=caps.use_kernels)
    ra_home = ra % m

    bad_d = (dele[:, 0] < 0) | (dele[:, 1] < 0)
    d_hi = torch.where(bad_d, PAD, torch.minimum(dele[:, 0], dele[:, 1]))
    d_lo = torch.where(bad_d, PAD, torch.maximum(dele[:, 0], dele[:, 1]))
    probe_rows = torch.cat([ce, torch.stack([d_hi, d_lo], dim=1)], dim=0)
    tbl, _, _ = je.dedup_rows(probe_rows, probe_rows[:, 0] >= 0, probe_rows.shape[0])
    drop_hi, drop_lo = tbl[:, 0].contiguous(), tbl[:, 1].contiguous()
    ins_hi, ins_lo = ce[:, 0].contiguous(), ce[:, 1].contiguous()

    # ---- per partition: NP membership rule and the patch ----------------
    out, ovf = [], []
    for me, pt in zip(mesh.indices(), pts):
        direct = ((ce[:, 0] % m) == me) | ((ce[:, 1] % m) == me)
        zmine = (ra >= 0) & (ra_home == me)               # z ∈ N(a), h(z)=me
        member = ce_valid & (direct | (zmine & zcommon).any(dim=1))
        pt2, o5 = je.patch_partition(pt, cand, cand_valid, drop_hi, drop_lo,
                                     ins_hi, ins_lo, member, nv_glob, m, me, caps)
        out.append(pt2)
        ovf.append(rep + o5)
    counters = {
        "cand_vertices": _isum(cand_valid),
        "cand_edges": _isum(ce_valid),
        "cand_overflow": o1 + o2 + o4,
    }
    return out, ovf, counters


def _storage_update_body(pts: List[PaddedPartition], add: torch.Tensor, dele: torch.Tensor,
                         mesh: Mesh, caps: EngineCaps, ushapes: UpdateShapes):
    """Alg. 4 in full, ``Φ(d) → Φ(d')``: the exact oracle that the delta
    update is held against.

    The global adjacency is gathered from the partition centers (one psum
    over ``[nv_glob, deg_cap]``), the first ``n_del`` deletions and
    ``n_add`` insertions are applied to it, and every partition is rebuilt
    from the NP membership rule ``(v, w) ∈ E_j ⇔ h(v)=j ∨ h(w)=j ∨ ∃z ∈
    CN(v, w): h(z)=j``. The JAX body tests ``z ∈ N(w)`` for every ``(v,
    w, z)`` as a ``[C, D, D, D]`` compare on every device; here the test
    does not depend on the partition, so it runs once, as ``set_intersect``
    over the valid ``(v, w)`` rows (``a = N(v)``, ``b = N(w)``, pad
    ``_BIG``), and each partition reduces it with its own ``h(z)``. The
    valid rows are counted on the host (one sync). Returns the new
    partitions and the per-partition overflows.
    """
    m = mesh.size
    nv_glob = m * caps.v_cap
    D = caps.deg_cap
    add = add.to(_I32)[:ushapes.n_add]
    dele = dele.to(_I32)[:ushapes.n_del]
    ids = torch.arange(nv_glob, dtype=_I32, device=add.device)

    # ---- replicated: the global adjacency after the batch ----------------
    gn = mesh.psum([je.center_adj_contrib(pt, ids, ids >= 0) for pt in pts]) - 1
    rows, o_slot = je.apply_edge_delta_rows(ids, gn, add, dele, nv_glob)
    del gn
    rep = _isum((add >= nv_glob).any(dim=1)) + o_slot
    gm = torch.where(rows < 0, _BIG, rows)             # ascending, _BIG tail
    del rows
    wvalid = gm != _BIG                                # [NV, D]: w = gm[v, j]

    # ---- replicated: z ∈ N(v) ∩ N(w) per valid (v, w), by z's home -------
    pv, pj = wvalid.nonzero(as_tuple=True)
    flat = pv * D + pj
    cond = torch.zeros((mesh.local, nv_glob * D), dtype=torch.bool, device=gm.device)
    for s in je._row_slices(pv.shape[0], 2 * D):
        a = gm[pv[s]]
        w = gm[pv[s], pj[s]].clamp(0, nv_glob - 1).long()
        z = je.ops.set_intersect(a, gm[w], pad=_BIG,
                                 use_kernels=caps.use_kernels)
        home = torch.where(z, a % m, m)
        for i, me in enumerate(mesh.indices()):
            cond[i, flat[s]] = (home == me).any(dim=1)
        del a, w, z, home
    cond = cond.reshape(mesh.local, nv_glob, D)
    gm_home = gm % m

    # ---- per partition: the rule, then the rebuilt partition -------------
    out, ovf = [], []
    for i, (me, pt) in enumerate(zip(mesh.indices(), pts)):
        o_own = _isum(pt.center & (pt.vertices >= 0) & (pt.vertices >= nv_glob))
        m1 = ((ids % m) == me)[:, None] | (wvalid & (gm_home == me))
        memb = (m1 | cond[i]) & wvalid
        vertices, vvalid, o_v = je._compact_vec(ids, memb.any(dim=1), caps.v_cap, fill=PAD)
        vsafe = torch.where(vertices >= 0, vertices, 0).long()
        ladj = torch.where(memb[vsafe] & vvalid[:, None], gm[vsafe], _BIG)
        ladj = torch.sort(ladj, dim=1).values
        ldeg = _isum_rows(ladj != _BIG)
        ladj = torch.where(ladj == _BIG, PAD, ladj)
        center = vvalid & (vertices % m == me)
        vv = vertices[:, None].expand_as(ladj)
        e_ok = (ladj >= 0) & (ladj > vv)
        epairs = torch.stack([vv.reshape(-1), ladj.reshape(-1)], dim=1)
        epacked, _, o_e = je._compact_rows(epairs, e_ok.reshape(-1), caps.e_cap)
        out.append(PaddedPartition(vertices=vertices, center=center, deg=ldeg, adj=ladj,
                                   edge_hi=epacked[:, 0].contiguous(),
                                   edge_lo=epacked[:, 1].contiguous()))
        ovf.append(o_own + rep + o_v + o_e)
    return out, ovf


def _run_storage_update(pts, add, dele, mesh, caps, ushapes, mode: str):
    """Dispatch the storage update body by ``mode``: ``(pts', ovfs, counters)``."""
    if mode == "full":
        pts2, ovf = _storage_update_body(pts, add, dele, mesh, caps, ushapes)
        return pts2, ovf, {}
    if mode == "delta":
        return _delta_update_body(pts, add, dele, mesh, caps, ushapes)
    raise ValueError(f"unknown update mode {mode!r} (expected 'delta' or 'full')")


def make_storage_update_step(mesh: Mesh, caps: EngineCaps, ushapes: UpdateShapes,
                             mode: str = "delta"):
    """Step: (partitions, E_a, E_d) → (partitions', diag).

    ``diag``: ``overflow``, ``stored_edges`` and ``part_dirty`` (a bool for
    each partition of this process: its edge list changed, so every
    per-partition artifact derived from it, such as the unit-table carry,
    is stale; local, never gathered), plus
    ``cand_vertices``, ``cand_edges`` and ``cand_overflow`` for
    ``mode="delta"``. ``mode="full"`` is the full-gather rebuild; the two
    are byte-equal.
    """
    if mode not in ("delta", "full"):
        raise ValueError(f"unknown update mode {mode!r} (expected 'delta' or 'full')")

    def step(pt_st: PaddedPartition, add: torch.Tensor, dele: torch.Tensor):
        pts = _parts(pt_st, mesh)
        pts2, ovf, counters = _run_storage_update(pts, add, dele, mesh, caps, ushapes, mode)
        dirty = torch.stack([(a.edge_hi != b.edge_hi).any() | (a.edge_lo != b.edge_lo).any()
                             for a, b in zip(pts2, pts)])
        diag = {
            "overflow": mesh.psum(ovf),
            "stored_edges": mesh.psum([_isum(p.edge_hi >= 0) for p in pts2]),
            "part_dirty": dirty,
            **counters,
        }
        return _stack(pts2), diag

    return step


# ---------------------------------------------------------------------------
# Stage 2: Nav-join patch chains
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _ChainPlan:
    seed_plan: UnitPlan
    steps: Tuple[Tuple[UnitPlan, JoinPlan], ...]
    skel_pairs: Tuple[Tuple[int, int], ...]       # Thm 6.1 dedup, skeleton edges
    comp_pairs: Tuple[Tuple[int, int], ...]       # (comp label, skeleton col idx)


def _chain_plans(units: Sequence[R1Unit], pattern: Pattern,
                 cover: Tuple[int, ...], ord_) -> Tuple[_ChainPlan, ...]:
    """One left-deep patch chain per unit, with its Thm. 6.1 dedup edges."""
    full_skel = tuple(c for c in cover if c in set(pattern.vertices))
    sidx = {c: j for j, c in enumerate(full_skel)}
    plans = []
    for i, qi in enumerate(units):
        order = left_deep_order(units, qi, cover)
        seed = build_unit_plan(qi.pattern, qi.anchor_in(cover), ord_)
        steps = []
        cur = qi.pattern
        for qk in order[1:]:
            up = build_unit_plan(qk.pattern, qk.anchor_in(cover), ord_)
            jp = JoinPlan.make(cur, qk.pattern, cover, ord_)
            steps.append((up, jp))
            cur = cur.union(qk.pattern)
        skel_pairs, comp_pairs = set(), set()
        for qj in units[:i]:
            for a, b in qj.pattern.edges:
                if a in sidx and b in sidx:
                    skel_pairs.add((sidx[a], sidx[b]))
                elif a in sidx:
                    comp_pairs.add((b, sidx[a]))
                else:  # b in skeleton (every pattern edge has a cover endpoint)
                    comp_pairs.add((a, sidx[b]))
        plans.append(_ChainPlan(seed_plan=seed, steps=tuple(steps),
                                skel_pairs=tuple(sorted(skel_pairs)),
                                comp_pairs=tuple(sorted(comp_pairs))))
    return tuple(plans)


def _edge_in(lo, hi, ea, eb) -> torch.Tensor:
    """Membership of (lo, hi) pairs in a small replicated edge list."""
    if ea.shape[0] == 0:
        return torch.zeros(lo.shape, dtype=torch.bool, device=lo.device)
    return ((lo[..., None] == ea) & (hi[..., None] == eb)).any(dim=-1)


def _pair_compat(cur: CompTensors, u: int, w: int, ord_set) -> torch.Tensor:
    """``[G, S_u, S_w]`` mask: value pairs compatible under injectivity + ord."""
    a, b = cur.sets[u], cur.sets[w]
    ok = (a >= 0)[:, :, None] & (b >= 0)[:, None, :] & (a[:, :, None] != b[:, None, :])
    if (u, w) in ord_set:
        ok &= a[:, :, None] < b[:, None, :]
    if (w, u) in ord_set:
        ok &= a[:, :, None] > b[:, None, :]
    return ok


def _purge_nonparticipating(cur: CompTensors, comp_labels, ord_, set_cap: int):
    """Drop set values participating in no full compressed-vertex assignment
    (exact for ≤ 3 compressed vertices, 3-consistency beyond, as in JAX)."""
    if len(comp_labels) < 2:
        return cur
    ord_set = set(ord_)
    pair: Dict[Tuple[int, int], torch.Tensor] = {}

    def pok(u, w):
        if (u, w) not in pair:
            pair[(u, w)] = _pair_compat(cur, u, w, ord_set)
            pair[(w, u)] = pair[(u, w)].transpose(1, 2)
        return pair[(u, w)]

    keeps = {}
    for u in comp_labels:
        others = [w for w in comp_labels if w != u]
        keep = cur.sets[u] >= 0
        if len(others) == 1:
            keep &= pok(u, others[0]).any(dim=2)
        else:
            for i, w in enumerate(others):
                for x in others[i + 1:]:
                    # r[g,a,b] = ∃c: ok(a,c) ∧ ok(b,c) — float64 batched product
                    r = torch.bmm(pok(u, x).to(torch.float64),
                                  pok(w, x).to(torch.float64).transpose(1, 2)) > 0
                    keep &= (pok(u, w) & r).any(dim=2)
        keeps[u] = keep
    valid = cur.valid
    sets = dict(cur.sets)
    for u in comp_labels:
        packed, counts = je._filter_set_rows(cur.sets[u], keeps[u] & valid[:, None], set_cap)
        sets[u] = packed
        valid = valid & (counts > 0)
    return CompTensors(skeleton=cur.skeleton, valid=valid, sets=sets)


def _patch_body(pts2: List[PaddedPartition], add: torch.Tensor, prog: TreeProgram,
                chains: Tuple[_ChainPlan, ...], mesh: Mesh, caps: EngineCaps,
                unit_tables: Optional[Dict[Tuple, "UnitCarry"]] = None):
    """Nav-join patch chains (Lemma 6.2 + Thm. 6.1) over the updated
    partitions, merged onto their full-skeleton owners. Returns the
    per-partition patches and overflows.

    ``unit_tables`` (keyed by unit-pattern key, stacked ``[m, ...]``) are
    the carried unit tables: a seed is the carried plain table re-filtered
    against this batch's ``E_a``, a chain step joins the carried compressed
    table, and no ``unit_list`` runs. Without them every table is listed
    from ``Φ(d')``; the two are byte-equal while the carry is fresh.
    """
    m = mesh.size
    pattern = prog.nodes[prog.root].pattern
    cover = prog.cover
    full_skel = tuple(c for c in cover if c in set(pattern.vertices))
    comp_labels = tuple(sorted(set(pattern.vertices) - set(cover)))
    add = add.to(_I32)
    add_lo = torch.minimum(add[:, 0], add[:, 1])
    add_hi = torch.maximum(add[:, 0], add[:, 1])
    unit_cache: Dict[Tuple, Tuple[List[CompTensors], List[torch.Tensor]]] = {}

    def unit_tables_of(up: UnitPlan):
        key = up.pattern.key()
        if unit_tables is not None:
            comp = unit_tables[key].comp
            return _parts(comp, mesh), [je._zero(add) for _ in pts2]
        if key not in unit_cache:
            tcs, os_ = [], []
            for pt in pts2:
                tbl, valid, o1 = je.unit_list(pt, up, caps)
                tc, _, o2 = je.compress_plain(tbl, valid, up.cols, cover, caps)
                tcs.append(tc)
                os_.append(o1 + o2)
            unit_cache[key] = (tcs, os_)
        return unit_cache[key]

    def seed(chain: _ChainPlan, j: int, pt: PaddedPartition):
        if unit_tables is not None:
            uc = unit_tables[chain.seed_plan.pattern.key()]
            tbl = uc.tbl[j]
            valid = uc.valid[j] & je.require_edges_mask(tbl, chain.seed_plan.edge_cols, add)
            return tbl, valid, je._zero(add)
        return je.unit_list(pt, chain.seed_plan, caps, require_edges=add)

    povf = [je._zero(add) for _ in pts2]
    chain_out: List[List[CompTensors]] = []
    for chain in chains:
        curs = []
        for j, pt in enumerate(pts2):
            tbl, valid, o1 = seed(chain, j, pt)
            cur, _, o2 = je.compress_plain(tbl, valid, chain.seed_plan.cols, cover, caps)
            povf[j] = povf[j] + o1 + o2
            curs.append(cur)
        for up, jp in chain.steps:
            tcks, o3 = unit_tables_of(up)
            curs, o4 = _dist_join(curs, tcks, jp, caps, mesh)
            # as in JAX, a listed table's overflow counts at each use and
            # once more below
            povf = [a + b + c for a, b, c in zip(povf, o3, o4)]
        outs = []
        for cur in curs:
            # Thm. 6.1 dedup: drop matches mapping an earlier unit's edge
            # into E_a (factorized over skeleton pairs / set values).
            valid = cur.valid
            sets = dict(cur.sets)
            for ia, ib in chain.skel_pairs:
                lo = torch.minimum(cur.skeleton[:, ia], cur.skeleton[:, ib])
                hi = torch.maximum(cur.skeleton[:, ia], cur.skeleton[:, ib])
                valid = valid & ~_edge_in(lo, hi, add_lo, add_hi)
            for v, iskel in chain.comp_pairs:
                vals = sets[v]
                sv = cur.skeleton[:, iskel][:, None]
                ok = (vals >= 0) & ~_edge_in(torch.minimum(vals, sv),
                                             torch.maximum(vals, sv), add_lo, add_hi)
                packed, counts = je._filter_set_rows(vals, ok & valid[:, None],
                                                     caps.set_cap)
                sets[v] = packed
                valid = valid & (counts > 0)
            cur = CompTensors(skeleton=cur.skeleton, valid=valid, sets=sets)
            outs.append(_purge_nonparticipating(cur, comp_labels, prog.ord, caps.set_cap))
        chain_out.append(outs)
    for _, os_ in unit_cache.values():
        povf = [a + b for a, b in zip(povf, os_)]

    # ---- merge chains: co-locate equal skeletons, union sets ------------
    # every partition's chain tables gathered, each partition folding the
    # groups it owns from all of them, chain by chain in partition order
    skel_idx = tuple(range(len(full_skel)))
    tables = [tc for outs in chain_out for tc in _gather_group_list(outs, mesh)]
    del chain_out
    owners = [_owner_of(tc.skeleton, skel_idx, m) for tc in tables]
    patches = []
    for i, me in enumerate(mesh.indices()):
        blocks = [CompTensors(skeleton=tc.skeleton, valid=tc.valid & (own == me),
                              sets=tc.sets)
                  for tc, own in zip(tables, owners)]
        if len(blocks) == 1:
            blk = blocks[0]
            blocks.append(CompTensors(skeleton=blk.skeleton,
                                      valid=torch.zeros_like(blk.valid), sets=blk.sets))
        patch, om = je.merge_tables_dev(blocks[0], blocks[1], caps.group_cap, caps.set_cap)
        for blk in blocks[2:]:
            patch, o = je.merge_tables_dev(patch, blk, caps.group_cap, caps.set_cap)
            om = om + o
        patches.append(patch)
        povf[i] = povf[i] + om
    return patches, povf


# ---------------------------------------------------------------------------
# Unit-table carries
# ---------------------------------------------------------------------------
#
# A unit table is a function of its partition's canonical edge list
# (Lemma 3.1 anchors units to centers), so a pattern's tables are carried
# across batches and listed again only on the partitions whose edge list
# the storage step changed (``diag["part_dirty"]``).

@dataclasses.dataclass
class UnitCarry:
    """One unit plan's carried tables (twin of ``sharded.UnitCarry``): the
    plain listing ``tbl [match_cap, k]`` + ``valid``, which seeds
    re-filter, and its compressed form ``comp``, which chain steps join;
    stacked ``[m, ...]`` in a carry."""

    tbl: torch.Tensor
    valid: torch.Tensor
    comp: CompTensors


def unit_plan_registry(prog: TreeProgram, units: Sequence[R1Unit]):
    """Distinct unit plans of a pattern's patch chains: ``(plans, names)``,
    ``plans`` from a name (``u0``, ``u1``, … in sorted-key order) to its
    :class:`UnitPlan`, ``names`` from a unit-pattern key to its name. A
    seed plan and a chain-step plan of one unit shape share one entry."""
    pattern = prog.nodes[prog.root].pattern
    chains = _chain_plans(units, pattern, prog.cover, prog.ord)
    reg: Dict[Tuple, UnitPlan] = {}
    for chain in chains:
        for up in (chain.seed_plan, *(u for u, _ in chain.steps)):
            reg.setdefault(up.pattern.key(), up)
    names = {k: f"u{i}" for i, k in enumerate(sorted(reg))}
    return {names[k]: up for k, up in reg.items()}, names


def _refresh_units(pt: PaddedPartition, plans: Dict[str, UnitPlan], cover: Tuple[int, ...],
                   caps: EngineCaps, ucaps: StoreCaps):
    """List and compress every registered unit plan on one partition: the
    cold fill of its carry slot, listed with ``caps`` and compressed with
    ``ucaps``' group and set caps. Returns ``({name: UnitCarry}, overflow)``."""
    ccaps = dataclasses.replace(caps, group_cap=ucaps.group_cap, set_cap=ucaps.set_cap)
    out: Dict[str, UnitCarry] = {}
    ovf = je._zero(pt.vertices)
    for name in sorted(plans):
        up = plans[name]
        tbl, valid, o1 = je.unit_list(pt, up, caps)
        tc, _, o2 = je.compress_plain(tbl, valid, up.cols, cover, ccaps)
        out[name] = UnitCarry(tbl=tbl, valid=valid, comp=tc)
        ovf = ovf + o1 + o2
    return out, ovf


def make_unit_refresh_step(prog: TreeProgram, units: Sequence[R1Unit], mesh: Mesh,
                           caps: EngineCaps, ucaps: StoreCaps):
    """Step: partitions → ({name: UnitCarry}, diag), the cold fill of a
    pattern's carry on every partition. ``diag``: ``overflow``."""
    plans, _ = unit_plan_registry(prog, units)

    def step(pt_st: PaddedPartition):
        carry: Dict[str, UnitCarry] = {name: None for name in sorted(plans)}
        ovfs = []
        for j, pt in enumerate(_parts(pt_st, mesh)):
            fresh, ovf = _refresh_units(pt, plans, prog.cover, caps, ucaps)
            for name, uc in fresh.items():
                carry[name] = _put(carry[name], mesh.local, j, uc)
            del fresh
            ovfs.append(ovf)
        return carry, {"overflow": mesh.psum(ovfs)}

    return step


def _dirty_flags(dirty: torch.Tensor) -> List[bool]:
    """The storage step's ``part_dirty`` of this process's partitions on the
    host: the one device-to-host read of a carried step (a CUDA graph of the
    step would branch on the device instead). The refresh it steers is
    local work with no collective in it, so ranks may branch apart here."""
    return [bool(x) for x in dirty.tolist()]


def _refresh_dirty(pts2: List[PaddedPartition], carry: Dict[str, UnitCarry],
                   flags: List[bool], prog: TreeProgram, plans: Dict[str, UnitPlan],
                   caps: EngineCaps, ucaps: StoreCaps) -> List[torch.Tensor]:
    """Refresh, in place, the carry slots of the partitions flagged dirty
    (the JAX step's ``lax.cond``); returns each partition's overflow."""
    rovf = []
    for j, (pt, dirty) in enumerate(zip(pts2, flags)):
        if dirty:
            fresh, o = _refresh_units(pt, plans, prog.cover, caps, ucaps)
            for name, uc in fresh.items():
                _put(carry[name], len(pts2), j, uc)
            del fresh
        else:
            o = je._zero(pt.vertices)
        rovf.append(o)
    return rovf


def _carry_by_key(carry: Dict[str, UnitCarry], names: Dict[Tuple, str]):
    return {k: carry[n] for k, n in names.items()}


def make_patch_step(prog: TreeProgram, units: Sequence[R1Unit], mesh: Mesh,
                    caps: EngineCaps, unit_caps: Optional[StoreCaps] = None):
    """Step: (Φ(d'), E_a) → (patch, diag), the Nav-join patch chains over
    the partitions of :func:`make_storage_update_step`. ``diag``:
    ``overflow``, ``patch_groups``.

    With ``unit_caps`` the step threads the unit-table carry: ``(Φ(d'),
    carry, dirty, E_a) → (patch, carry', diag)``, where ``dirty`` is the
    storage step's ``part_dirty``; only dirty partitions list their units
    again, into the carry in place (the returned carry is the same
    object). ``diag`` gains ``unit_refreshes``, and ``overflow`` includes
    the refresh's.
    """
    pattern = prog.nodes[prog.root].pattern
    chains = _chain_plans(units, pattern, prog.cover, prog.ord)

    if unit_caps is None:
        def step(pt2_st: PaddedPartition, add: torch.Tensor):
            pts2 = _parts(pt2_st, mesh)
            patches, povf = _patch_body(pts2, add, prog, chains, mesh, caps)
            diag = {"overflow": mesh.psum(povf),
                    "patch_groups": mesh.psum([_isum(p.valid) for p in patches])}
            return _stack(patches), diag

        return step

    plans, names = unit_plan_registry(prog, units)

    def step_carry(pt2_st: PaddedPartition, carry: Dict[str, UnitCarry],
                   dirty: torch.Tensor, add: torch.Tensor):
        pts2 = _parts(pt2_st, mesh)
        rovf = _refresh_dirty(pts2, carry, _dirty_flags(dirty), prog, plans, caps, unit_caps)
        patches, povf = _patch_body(pts2, add, prog, chains, mesh, caps,
                                    unit_tables=_carry_by_key(carry, names))
        diag = {"overflow": mesh.psum([a + b for a, b in zip(povf, rovf)]),
                "patch_groups": mesh.psum([_isum(p.valid) for p in patches]),
                "unit_refreshes": _psum_flags(dirty, mesh)}
        return _stack(patches), carry, diag

    return step_carry


def make_update_step(prog: TreeProgram, units: Sequence[R1Unit], mesh: Mesh,
                     caps: EngineCaps, ushapes: UpdateShapes, mode: str = "delta"):
    """Step: (partitions, E_a, E_d) → (partitions', patch, diag): the
    storage update (``mode`` as in :func:`make_storage_update_step`) and
    the patch of :func:`make_patch_step` for one pattern. ``diag``:
    ``overflow``, ``patch_groups``, ``stored_edges`` and, for
    ``mode="delta"``, the candidate counters."""
    pattern = prog.nodes[prog.root].pattern
    chains = _chain_plans(units, pattern, prog.cover, prog.ord)
    if mode not in ("delta", "full"):
        raise ValueError(f"unknown update mode {mode!r} (expected 'delta' or 'full')")

    def step(pt_st: PaddedPartition, add: torch.Tensor, dele: torch.Tensor):
        pts = _parts(pt_st, mesh)
        pts2, ovf, counters = _run_storage_update(pts, add, dele, mesh, caps, ushapes, mode)
        del pts
        patches, povf = _patch_body(pts2, add, prog, chains, mesh, caps)
        diag = {
            "overflow": mesh.psum([a + b for a, b in zip(ovf, povf)]),
            "patch_groups": mesh.psum([_isum(p.valid) for p in patches]),
            "stored_edges": mesh.psum([_isum(p.edge_hi >= 0) for p in pts2]),
            **counters,
        }
        return _stack(pts2), _stack(patches), diag

    return step


# ---------------------------------------------------------------------------
# Device-resident match store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MatchStore:
    """One pattern's running compressed match set, ``[m, Gs, ...]``: groups
    placed by the ownership hash over the full skeleton (twin of
    ``sharded.MatchStore``)."""

    skeleton: torch.Tensor
    valid: torch.Tensor
    sets: Dict[int, torch.Tensor]

    def as_comp(self) -> CompTensors:
        return _comp(self)

    def flatten(self) -> CompTensors:
        """All shards with the partition axis folded away (``[m·Gs, ...]``)."""
        return CompTensors(
            skeleton=self.skeleton.reshape(-1, self.skeleton.shape[-1]),
            valid=self.valid.reshape(-1),
            sets={v: a.reshape(-1, a.shape[-1]) for v, a in self.sets.items()})


def _owner_rows_np(skel: np.ndarray, m: int) -> np.ndarray:
    """Host twin of :func:`_owner_of` (int32 wraparound semantics)."""
    h = np.zeros(skel.shape[0], np.int32)
    with np.errstate(over="ignore"):
        for j in range(skel.shape[1]):
            h = h * np.int32(1000003) + skel[:, j].astype(np.int32)
    return ((h.astype(np.int64) % m) + m) % m


def stack_matches(table, m: int, store: StoreCaps, device="cuda",
                  parts: Optional[Sequence[int]] = None) -> MatchStore:
    """Shard a host :class:`~repro_torch.core.vcbc.CompressedTable` into a
    stacked :class:`MatchStore` on ``device`` by full-skeleton ownership
    (the restore path; registration builds the store on the card through
    :func:`make_init_store_step`). Shard ``j`` holds the groups that hash to
    ``j``, in table order, with PAD tails; only the shards ``parts`` (default:
    all ``m``) are built, stacked in that order. The caps must hold every
    owner's shard: a misfit is a sizing error and raises instead of
    truncating (the first misfit in shard order, as
    ``sharded.stack_matches`` finds it).

    The padded tensors are built on ``device`` and only the table's values
    cross from the host (a WT~ store is tens of GiB once padded)."""
    S = len(table.skeleton_cols)
    G, C = store.group_cap, store.set_cap
    owner = _owner_rows_np(table.skeleton.astype(np.int64), m)
    comp_labels = sorted(int(v) for v in table.comp)
    order = np.argsort(owner, kind="stable")
    shard = owner[order]
    n_of = np.bincount(owner, minlength=m)
    slot = np.arange(order.shape[0]) - np.repeat(np.cumsum(n_of) - n_of, n_of)
    counts = {v: np.diff(table.comp[v].offsets)[order] for v in comp_labels}
    for j in range(m):
        if n_of[j] > G:
            raise ValueError(f"shard {j} holds {n_of[j]} groups > group_cap={G}")
        for v in comp_labels:
            over = counts[v][shard == j]
            over = over[over > C]
            if over.size:
                raise ValueError(f"group set has {int(over[0])} values > set_cap={C}")

    ids = np.arange(m) if parts is None else np.asarray(list(parts), np.int64)
    local = np.full(m, -1, np.int64)
    local[ids] = np.arange(ids.shape[0])
    keep = local[shard] >= 0          # the groups of the shards built here

    def put(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    k = ids.shape[0]
    sh, sl = put(local[shard][keep], torch.long), put(slot[keep], torch.long)
    skel = torch.full((k, G, S), PAD, dtype=torch.int32, device=device)
    skel[sh, sl] = put(table.skeleton[order][keep])
    valid = torch.zeros((k, G), dtype=torch.bool, device=device)
    valid[sh, sl] = True
    sets = {}
    for v in comp_labels:
        r = table.comp[v]
        rep, vals = ragged_expand(r.offsets[order][keep], counts[v][keep], r.values)
        cnt = counts[v][keep]
        col = np.arange(rep.shape[0]) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        rep_t = put(rep, torch.long)
        sets[v] = torch.full((k, G, C), PAD, dtype=torch.int32, device=device)
        sets[v][sh[rep_t], sl[rep_t], put(col, torch.long)] = put(vals)
    return MatchStore(skeleton=skel, valid=valid, sets=sets)


def _init_store(skel_cols: Tuple[int, ...], ord_, mesh: Mesh, store: StoreCaps):
    """Step: a stacked listing → (MatchStore, diag): every group gathered,
    placed by the ownership hash over its whole skeleton, merged into its
    owner's shard and counted there."""
    m = mesh.size
    n_s = len(skel_cols)

    def step(tc_st: CompTensors):
        g = _gather_groups(_parts(tc_st, mesh), mesh)
        own = _owner_of(g.skeleton, tuple(range(n_s)), m)
        out, cnts, ngroups, ovfs = None, [], [], []
        for j, me in enumerate(mesh.indices()):
            st, ovf = je.merge_groups(g.skeleton, g.valid & (own == me), g.sets,
                                      store.group_cap, store.set_cap)
            cnts.append(je.count_matches_dev(st, skel_cols, ord_))
            ngroups.append(_isum(st.valid))
            ovfs.append(ovf)
            out = _put(out, mesh.local, j, MatchStore(skeleton=st.skeleton, valid=st.valid,
                                                      sets=st.sets))
            del st
        diag = {"count": mesh.psum(cnts), "store_groups": mesh.psum(ngroups),
                "overflow": mesh.psum(ovfs)}
        return out, diag

    return step


def make_init_store_step(prog: TreeProgram, mesh: Mesh, caps: EngineCaps,
                         store: StoreCaps):
    """Step: stacked root CompTensors of the list step → (MatchStore, diag)
    with ``diag`` = ``count``, ``store_groups``, ``overflow``."""
    return _init_store(prog.nodes[prog.root].skel_cols, prog.ord, mesh, store)


def _cover_all(pattern: Pattern) -> Tuple[int, ...]:
    """The storage cover of a WCOJ pattern: every vertex (plain rows)."""
    return tuple(sorted(int(v) for v in pattern.vertices))


def make_wcoj_list_step(pattern: Pattern, plan: WcojPlan, mesh: Mesh,
                        caps: EngineCaps, level_caps: Sequence[int]):
    """Step: stacked partitions → (stacked CompTensors, diag), stage 1 of
    the generic-join executor: :func:`~repro_torch.engine.wcoj_list` on
    every partition (complete and disjoint, as the anchor is adjacent to
    every other vertex and seeded at its center), its rows wrapped as a
    table whose skeleton is every column and whose sets are empty, with
    ``level_caps[-1]`` groups. ``diag``: ``overflow``, ``matches_lower_bound``."""
    cover_all = _cover_all(pattern)
    ccaps = dataclasses.replace(caps, group_cap=int(level_caps[-1]))

    def step(pt_st: PaddedPartition):
        out, ovfs, nvalid = None, [], []
        for j, pt in enumerate(_parts(pt_st, mesh)):
            tbl, valid, o1 = je.wcoj_list(pt, plan, caps, level_caps)
            tc, _, o2 = je.compress_plain(tbl, valid, plan.cols, cover_all, ccaps)
            ovfs.append(o1 + o2)
            nvalid.append(_isum(tc.valid))
            out = _put(out, mesh.local, j, tc)
            del tbl, valid, tc
        return out, {"overflow": mesh.psum(ovfs), "matches_lower_bound": mesh.psum(nvalid)}

    return step


def make_wcoj_init_store_step(pattern: Pattern, ord_, mesh: Mesh, store: StoreCaps):
    """Step: the listing of :func:`make_wcoj_list_step` → (MatchStore,
    diag), :func:`make_init_store_step` for plain rows: the ownership hash
    runs over every column. ``diag``: ``count``, ``store_groups``,
    ``overflow``. (JAX's step also takes the engine and level caps and
    reads neither; they are left out here.)"""
    return _init_store(_cover_all(pattern), ord_, mesh, store)


def _wcoj_seed_masks(pts2: List[PaddedPartition], add: torch.Tensor,
                     mesh: Mesh) -> List[torch.Tensor]:
    """Each partition's ``[v_cap]`` anchor-seed mask for the delta-seeded
    WCOJ patch: the candidates ``C1 ∪ N_{d'}(C1)`` over the inserted
    endpoints. A new match holds an inserted edge ``(a, b)``, and its
    anchor is adjacent to every other match vertex, so the anchor is ``a``,
    ``b`` or a common neighbour of both. Both dedup caps hold every input,
    so nothing drops. The candidates are replicated: computed once."""
    ends = add.to(_I32).reshape(-1)
    c1_t, c1_valid, _ = je.dedup_rows(ends[:, None], ends >= 0, max(int(ends.shape[0]), 1))
    c1 = c1_t[:, 0].contiguous()
    rows1 = mesh.psum([je.center_adj_contrib(pt, c1, c1_valid) for pt in pts2]) - 1
    cids = torch.cat([torch.where(c1_valid, c1, PAD), rows1.reshape(-1)])
    cand, _, _ = je.dedup_rows(cids[:, None], cids >= 0, max(int(cids.shape[0]), 1))
    cand = cand[:, 0].contiguous()
    return [je.lookup_sorted(cand, pt.vertices)[1] for pt in pts2]


def _delete_table(dele: torch.Tensor) -> torch.Tensor:
    """One delete batch as the lex-sorted PAD-tailed ``(hi, lo)`` table the
    ``member_probe`` kernel and :func:`~repro_torch.engine.edge_probe` take."""
    dele = dele.to(_I32)
    bad = (dele[:, 0] < 0) | (dele[:, 1] < 0)
    d_pairs = torch.stack(
        [torch.where(bad, PAD, torch.minimum(dele[:, 0], dele[:, 1])),
         torch.where(bad, PAD, torch.maximum(dele[:, 0], dele[:, 1]))], dim=1)
    d_tbl, _, _ = je.dedup_rows(d_pairs, d_pairs[:, 0] >= 0, max(d_pairs.shape[0], 1))
    return d_tbl


def _maintain_local(st: CompTensors, patch: CompTensors, d_tbl: torch.Tensor,
                    prog: TreeProgram, store: StoreCaps, skel_pairs, comp_pairs,
                    skel_cols, caps: EngineCaps):
    """One partition's filter ∘ merge ∘ count over its patch and the
    delete table."""
    kept, removed = je.filter_deleted_dev(
        st, skel_pairs, comp_pairs, d_tbl[:, 0].contiguous(), d_tbl[:, 1].contiguous(),
        store.set_cap, use_kernels=caps.use_kernels)
    merged, movf = je.merge_tables_dev(kept, patch, store.group_cap, store.set_cap)
    cnt = je.count_matches_dev(merged, skel_cols, prog.ord)
    return merged, removed, movf, cnt


def _maintain_shards(st_st: MatchStore, patches: List[CompTensors], d_tbl: torch.Tensor,
                     prog: TreeProgram, store: StoreCaps, skel_pairs, comp_pairs, skel_cols,
                     caps: EngineCaps, mesh: Mesh):
    """Filter ∘ merge ∘ count on every shard, each shard of the store
    overwritten in place by its result. Returns the per-partition counts,
    removed groups, store groups and merge overflows."""
    cnts, removed, ngroups, movfs = [], [], [], []
    for j in range(mesh.local):
        merged, rem, movf, cnt = _maintain_local(
            _comp(_part(st_st, j)), patches[j], d_tbl, prog, store,
            skel_pairs, comp_pairs, skel_cols, caps)
        ngroups.append(_isum(merged.valid))
        _put(st_st, mesh.local, j, MatchStore(skeleton=merged.skeleton,
                                              valid=merged.valid, sets=merged.sets))
        del merged
        cnts.append(cnt)
        removed.append(rem)
        movfs.append(movf)
    return cnts, removed, ngroups, movfs


def _maintain_diag(mesh: Mesh, patches, povf, rovf, shards) -> Dict[str, torch.Tensor]:
    cnts, removed, ngroups, movfs = shards
    return {
        "count": mesh.psum(cnts),
        "patch_groups": mesh.psum([_isum(p.valid) for p in patches]),
        "removed_groups": mesh.psum(removed),
        "store_groups": mesh.psum(ngroups),
        "overflow": mesh.psum([a + b + c for a, b, c in zip(povf, movfs, rovf)]),
        "store_overflow": mesh.psum(movfs),
    }


def make_maintain_step(prog: TreeProgram, units: Sequence[R1Unit], mesh: Mesh,
                       caps: EngineCaps, store: StoreCaps,
                       unit_caps: Optional[StoreCaps] = None):
    """Step: (Φ(d'), store, E_a, E_d) → (store', patch, diag).

    Patch ∘ filter ∘ merge ∘ count, the device twin of
    ``repro.core.incremental.apply_update_to_matches``. ``diag``:
    ``count``, ``patch_groups``, ``removed_groups``, ``store_groups``,
    ``overflow``, ``store_overflow``.

    With ``unit_caps`` the step threads the pattern's unit-table carry:
    ``(Φ(d'), store, carry, dirty, E_a, E_d) → (store', patch, carry',
    diag)``. Seeds and chain steps take the carried tables; only the
    partitions flagged in ``dirty`` (the storage step's ``part_dirty``)
    list their units again. ``diag`` gains ``unit_refreshes``, and
    ``overflow`` includes the refresh's.

    The step consumes its input store and carry: each shard is overwritten
    in place by its result (the store holds ``m·group_cap·set_cap`` values,
    so a second copy would double the step's largest allocation), and the
    returned store and carry are the same objects.
    """
    pattern = prog.nodes[prog.root].pattern
    skel_cols = prog.nodes[prog.root].skel_cols
    chains = _chain_plans(units, pattern, prog.cover, prog.ord)
    skel_pairs, comp_pairs = je.deleted_edge_cols(pattern, skel_cols)

    def maintain(pts2, st_st, unit_tables, rovf, add, dele):
        patches, povf = _patch_body(pts2, add, prog, chains, mesh, caps, unit_tables)
        shards = _maintain_shards(st_st, patches, _delete_table(dele), prog, store,
                                  skel_pairs, comp_pairs, skel_cols, caps, mesh)
        return patches, _maintain_diag(mesh, patches, povf, rovf, shards)

    if unit_caps is None:
        def step(pt2_st: PaddedPartition, st_st: MatchStore, add: torch.Tensor,
                 dele: torch.Tensor):
            pts2 = _parts(pt2_st, mesh)
            zero = [je._zero(add) for _ in pts2]
            patches, diag = maintain(pts2, st_st, None, zero, add, dele)
            return st_st, _stack(patches), diag

        return step

    plans, names = unit_plan_registry(prog, units)

    def step_carry(pt2_st: PaddedPartition, st_st: MatchStore, carry: Dict[str, UnitCarry],
                   dirty: torch.Tensor, add: torch.Tensor, dele: torch.Tensor):
        pts2 = _parts(pt2_st, mesh)
        rovf = _refresh_dirty(pts2, carry, _dirty_flags(dirty), prog, plans, caps, unit_caps)
        patches, diag = maintain(pts2, st_st, _carry_by_key(carry, names), rovf, add, dele)
        diag["unit_refreshes"] = _psum_flags(dirty, mesh)
        return st_st, _stack(patches), carry, diag

    return step_carry


@dataclasses.dataclass(frozen=True)
class MaintainSpec:
    """One pattern's slot in :func:`make_maintain_mega_step` (twin of
    ``sharded.MaintainSpec``): ``name`` keys its entries in the step's
    dicts, ``prog`` / ``units`` are its compiled program, ``store`` its
    :class:`MatchStore` caps and ``unit_caps`` its carry's caps.

    With ``wcoj`` set the slot runs the generic-join executor: its patch is
    a :func:`~repro_torch.engine.wcoj_list` over Φ(d') with the level caps
    ``wcoj_level_caps``, seeded from the batch's delta candidates and kept
    to the matches that hold an inserted edge; its store holds plain rows.
    Such a slot has no carry (``{}`` in and out) and ``unit_refreshes`` 0."""

    name: str
    prog: TreeProgram
    units: Tuple[R1Unit, ...]
    store: StoreCaps
    unit_caps: StoreCaps
    wcoj: Optional[WcojPlan] = None
    wcoj_level_caps: Optional[Tuple[int, ...]] = None


def _wcoj_patch(pts2: List[PaddedPartition], add: torch.Tensor, seed_masks, sp: MaintainSpec,
                skel_cols: Tuple[int, ...], caps: EngineCaps, mesh: Mesh):
    """A WCOJ slot's patch: on every partition, exactly the matches of
    Φ(d') that hold an inserted edge and whose anchor is a delta candidate
    (one pass over the whole pattern, so a match with several inserted
    edges is listed once), placed by the ownership hash over every column.
    Returns the per-partition patches, list overflows and placement
    overflows (the patch fits the store's caps, as it is a subset of the
    merged shard)."""
    ccaps = dataclasses.replace(caps, group_cap=int(sp.wcoj_level_caps[-1]))
    add = add.to(_I32)
    tcs, povf = [], []
    for pt, seed in zip(pts2, seed_masks):
        tbl, valid, o1 = je.wcoj_list(pt, sp.wcoj, caps, sp.wcoj_level_caps,
                                      require_edges=add, seed_mask=seed)
        tc, _, o2 = je.compress_plain(tbl, valid, sp.wcoj.cols, skel_cols, ccaps)
        tcs.append(tc)
        povf.append(o1 + o2)
        del tbl, valid
    g = _gather_groups(tcs, mesh)
    del tcs
    own = _owner_of(g.skeleton, tuple(range(len(skel_cols))), mesh.size)
    patches, govf = [], []
    for me in mesh.indices():
        patch, o = je.merge_groups(g.skeleton, g.valid & (own == me), g.sets,
                                   sp.store.group_cap, sp.store.set_cap)
        patches.append(patch)
        govf.append(o)
    return patches, povf, govf


def make_maintain_mega_step(specs: Sequence[MaintainSpec], mesh: Mesh,
                            caps: EngineCaps):
    """One step maintaining every registered pattern.

    Signature: ``(Φ(d'), {name: store}, {name: carry}, dirty, E_a, E_d) →
    ({name: store'}, {name: patch}, {name: carry'}, {name: diag})``.
    Each pattern's outputs equal those of its carried
    :func:`make_maintain_step` run alone (a tree slot) or of JAX's WCOJ
    slot; one call builds the Lemma 6.1 delete table once, the WCOJ seed
    masks once for all WCOJ slots, and reads ``dirty`` (the storage step's
    ``part_dirty``) from the card once for all tree slots, not at all when
    there is none. A tree slot refreshes its carry on the dirty partitions
    and patches from it; a WCOJ slot patches by a delta-seeded generic
    join; then each filters, merges and counts. ``diag`` has the keys of
    the carried single-pattern step: ``count``, ``patch_groups``,
    ``removed_groups``, ``store_groups``, ``overflow``, ``store_overflow``,
    ``unit_refreshes``; a WCOJ slot's placement overflow is in both
    ``overflow`` and ``store_overflow``.

    The JAX step donates the stores and carries, and its callers treat
    them as consumed. Here they are overwritten in place and the returned
    dicts hold the same objects; a retry after a failed batch rebuilds
    them from the partitions. The host read of ``dirty`` is the step's one
    synchronisation; capturing the step as a CUDA graph would move the
    branch onto the device.
    """
    pre = []
    for sp in specs:
        root = sp.prog.nodes[sp.prog.root]
        if sp.wcoj is not None:
            cover_all = _cover_all(root.pattern)
            skel_pairs, comp_pairs = je.deleted_edge_cols(root.pattern, cover_all)
            pre.append((sp, cover_all, None, skel_pairs, comp_pairs, None, None))
            continue
        chains = _chain_plans(sp.units, root.pattern, sp.prog.cover, sp.prog.ord)
        skel_pairs, comp_pairs = je.deleted_edge_cols(root.pattern, root.skel_cols)
        plans, names = unit_plan_registry(sp.prog, sp.units)
        pre.append((sp, root.skel_cols, chains, skel_pairs, comp_pairs, plans, names))
    any_wcoj = any(sp.wcoj is not None for sp in specs)
    any_tree = any(sp.wcoj is None for sp in specs)

    def step(pt2_st: PaddedPartition, stores: Dict[str, MatchStore],
             carries: Dict[str, Dict[str, UnitCarry]], dirty: torch.Tensor,
             add: torch.Tensor, dele: torch.Tensor):
        pts2 = _parts(pt2_st, mesh)
        flags = _dirty_flags(dirty) if any_tree else None
        d_tbl = _delete_table(dele)
        seed_masks = _wcoj_seed_masks(pts2, add, mesh) if any_wcoj else None
        refreshes = _psum_flags(dirty, mesh)
        zero = [je._zero(add) for _ in pts2]
        patches, diag = {}, {}
        for sp, skel_cols, chains, skel_pairs, comp_pairs, plans, names in pre:
            if sp.wcoj is not None:
                pat, povf, govf = _wcoj_patch(pts2, add, seed_masks, sp, skel_cols, caps, mesh)
                shards = _maintain_shards(stores[sp.name], pat, d_tbl, sp.prog, sp.store,
                                          skel_pairs, comp_pairs, skel_cols, caps, mesh)
                d = _maintain_diag(mesh, pat, [a + b for a, b in zip(povf, govf)], zero,
                                   shards)
                d["store_overflow"] = mesh.psum([a + b for a, b in zip(govf, shards[3])])
                diag[sp.name] = {**d, "unit_refreshes": je._zero(add)}
            else:
                carry = carries[sp.name]
                rovf = _refresh_dirty(pts2, carry, flags, sp.prog, plans, caps, sp.unit_caps)
                pat, povf = _patch_body(pts2, add, sp.prog, chains, mesh, caps,
                                        unit_tables=_carry_by_key(carry, names))
                shards = _maintain_shards(stores[sp.name], pat, d_tbl, sp.prog, sp.store,
                                          skel_pairs, comp_pairs, skel_cols, caps, mesh)
                diag[sp.name] = {**_maintain_diag(mesh, pat, povf, rovf, shards),
                                 "unit_refreshes": refreshes}
            patches[sp.name] = _stack(pat)
            del pat
        return stores, patches, carries, diag

    return step
