"""Whole join-tree programs over ``m`` NP partitions on one card.

Port of the main path of ``repro/dist/sharded.py``. The partitions are a
leading ``[m]`` axis of every input and output (partition ``j`` holds the
centers ``h(v) = v mod m``); each step loops over them and meets the other
partitions only through :class:`~repro_torch.mesh.LocalMesh` collectives,
where the JAX step calls ``lax.all_gather`` / ``lax.psum``. Work that the
JAX step repeats on every device on replicated values (the candidate sets
of the storage update, the ownership hash of gathered groups) runs once.

- :func:`make_list_step` — stage 1: unit listing per partition, then each
  CC-join redistributes groups by join-key ownership and joins locally.
- :func:`make_init_store_step` — the initial listing regrouped into the
  sharded :class:`MatchStore` and counted.
- :func:`make_storage_update_step` (``mode="delta"``) — the
  candidate-restricted Alg. 4 update of the stored partitions.
- :func:`make_maintain_step` — Nav-join patch ∘ Lemma 6.1 delete filter ∘
  merge ∘ count over the updated partitions.

Every step reports overflow through explicit counters in its ``diag``
dict (0-d tensors, summed over partitions like the JAX ``psum``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import engine as je
from .core.navjoin import left_deep_order
from .core.pattern import Pattern, R1Unit
from .core.plan import JoinPlan, UnitPlan, build_unit_plan
from .core.storage import NPStorage
from .engine import PAD, CompTensors, EngineCaps, PaddedPartition, _I32, _isum
from .mesh import LocalMesh
from .planner.lowering import TreeProgram
from .planner.sizing import StoreCaps, match_caps

__all__ = [
    "stack_partitions", "make_list_step", "UpdateShapes", "make_storage_update_step",
    "MatchStore", "StoreCaps", "match_caps", "make_init_store_step", "make_maintain_step",
]


# ---------------------------------------------------------------------------
# Stacked inputs
# ---------------------------------------------------------------------------

def stack_partitions(storage: NPStorage, caps: EngineCaps, device="cuda") -> PaddedPartition:
    """Pad every partition and stack along a leading partition axis [m, ...]."""
    return _stack([je.pad_partition(p, caps, device) for p in storage.parts])


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


def _put(out, m: int, j: int, x):
    """Write ``x`` as partition ``j`` of a stacked dataclass of ``m``
    partitions (allocated on first write, ``out=None``) and return it, so
    a step holds one shard's result at a time instead of ``m``."""
    if out is None:
        out = je.map_tensors(
            lambda a: torch.empty((m,) + tuple(a.shape), dtype=a.dtype, device=a.device), x)
    for f in dataclasses.fields(x):
        v, dst = getattr(x, f.name), getattr(out, f.name)
        if isinstance(v, dict):
            for k, a in v.items():
                dst[k][j].copy_(a)
        else:
            dst[j].copy_(v)
    return out


def _part(x, j: int):
    """Partition ``j`` of a stacked dataclass."""
    return je.map_tensors(lambda a: a[j], x)


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


def _gather_groups(tcs: Sequence[CompTensors], mesh: LocalMesh) -> CompTensors:
    return CompTensors(
        skeleton=mesh.all_gather([t.skeleton for t in tcs]),
        valid=mesh.all_gather([t.valid for t in tcs]),
        sets={v: mesh.all_gather([t.sets[v] for t in tcs]) for v in tcs[0].sets})


def _compact_groups(tc: CompTensors, ok: torch.Tensor, cap: int):
    """Pack the ``ok`` groups into ``cap`` slots (gather form); count drops."""
    src, valid, dropped = je._take_index(ok, cap)
    src = src.long()

    def pack(arr):
        return torch.where(valid.reshape((-1,) + (1,) * (arr.dim() - 1)), arr[src], PAD)

    return CompTensors(skeleton=pack(tc.skeleton), valid=valid,
                       sets={v: pack(a) for v, a in tc.sets.items()}), dropped


def _dist_join(tcAs: Sequence[CompTensors], tcBs: Sequence[CompTensors], plan: JoinPlan,
               caps: EngineCaps, mesh: LocalMesh):
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

def make_list_step(prog: TreeProgram, mesh: LocalMesh, caps: EngineCaps):
    """Step: stacked partitions → (stacked root CompTensors, diag) with
    ``diag`` = ``overflow``, ``matches_lower_bound`` (valid root groups)."""

    def step(pt_st: PaddedPartition):
        pts = [_part(pt_st, j) for j in mesh.indices()]
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
                       mesh: LocalMesh, caps: EngineCaps, ushapes: UpdateShapes):
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


def make_storage_update_step(mesh: LocalMesh, caps: EngineCaps, ushapes: UpdateShapes,
                             mode: str = "delta"):
    """Step: (partitions, E_a, E_d) → (partitions', diag).

    ``diag``: ``overflow``, ``stored_edges``, ``part_dirty`` ([m] bool:
    the partition's edge list changed), ``cand_vertices``, ``cand_edges``,
    ``cand_overflow``. Only ``mode="delta"`` is ported; the full-gather
    oracle stays in the JAX package.
    """
    if mode != "delta":
        raise ValueError(f"update mode {mode!r} is not ported (only 'delta')")

    def step(pt_st: PaddedPartition, add: torch.Tensor, dele: torch.Tensor):
        pts = [_part(pt_st, j) for j in mesh.indices()]
        pts2, ovf, counters = _delta_update_body(pts, add, dele, mesh, caps, ushapes)
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
                chains: Tuple[_ChainPlan, ...], mesh: LocalMesh, caps: EngineCaps):
    """Nav-join patch chains (Lemma 6.2 + Thm. 6.1) over the updated
    partitions, merged onto their full-skeleton owners. Returns the
    per-partition patches and overflows."""
    m = mesh.size
    pattern = prog.nodes[prog.root].pattern
    cover = prog.cover
    full_skel = tuple(c for c in cover if c in set(pattern.vertices))
    comp_labels = tuple(sorted(set(pattern.vertices) - set(cover)))
    add = add.to(_I32)
    add_lo = torch.minimum(add[:, 0], add[:, 1])
    add_hi = torch.maximum(add[:, 0], add[:, 1])
    unit_cache: Dict[Tuple, Tuple[List[CompTensors], List[torch.Tensor]]] = {}

    def unit_tables(up: UnitPlan):
        key = up.pattern.key()
        if key not in unit_cache:
            tcs, os_ = [], []
            for pt in pts2:
                tbl, valid, o1 = je.unit_list(pt, up, caps)
                tc, _, o2 = je.compress_plain(tbl, valid, up.cols, cover, caps)
                tcs.append(tc)
                os_.append(o1 + o2)
            unit_cache[key] = (tcs, os_)
        return unit_cache[key]

    povf = [je._zero(add) for _ in pts2]
    chain_out: List[List[CompTensors]] = []
    for chain in chains:
        curs = []
        for j, pt in enumerate(pts2):
            tbl, valid, o1 = je.unit_list(pt, chain.seed_plan, caps, require_edges=add)
            cur, _, o2 = je.compress_plain(tbl, valid, chain.seed_plan.cols, cover, caps)
            povf[j] = povf[j] + o1 + o2
            curs.append(cur)
        for up, jp in chain.steps:
            tcks, _ = unit_tables(up)
            curs, o4 = _dist_join(curs, tcks, jp, caps, mesh)
            povf = [a + b for a, b in zip(povf, o4)]
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
    skel_idx = tuple(range(len(full_skel)))
    owners = [[_owner_of(tc.skeleton, skel_idx, m) for tc in outs] for outs in chain_out]
    patches = []
    for me in mesh.indices():
        blocks = [CompTensors(skeleton=tc.skeleton, valid=tc.valid & (own == me),
                              sets=tc.sets)
                  for outs, owns in zip(chain_out, owners)
                  for tc, own in zip(outs, owns)]
        if len(blocks) == 1:
            blk = blocks[0]
            blocks.append(CompTensors(skeleton=blk.skeleton,
                                      valid=torch.zeros_like(blk.valid), sets=blk.sets))
        patch, om = je.merge_tables_dev(blocks[0], blocks[1], caps.group_cap, caps.set_cap)
        for blk in blocks[2:]:
            patch, o = je.merge_tables_dev(patch, blk, caps.group_cap, caps.set_cap)
            om = om + o
        patches.append(patch)
        povf[me] = povf[me] + om
    return patches, povf


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


def make_init_store_step(prog: TreeProgram, mesh: LocalMesh, caps: EngineCaps,
                         store: StoreCaps):
    """Step: stacked root CompTensors of the list step → (MatchStore, diag)
    with ``diag`` = ``count``, ``store_groups``, ``overflow``."""
    m = mesh.size
    root = prog.nodes[prog.root]
    n_s = len(root.skel_cols)

    def step(tc_st: CompTensors):
        g = _gather_groups([_part(tc_st, j) for j in mesh.indices()], mesh)
        own = _owner_of(g.skeleton, tuple(range(n_s)), m)
        out, cnts, ngroups, ovfs = None, [], [], []
        for me in mesh.indices():
            st, ovf = je.merge_groups(g.skeleton, g.valid & (own == me), g.sets,
                                      store.group_cap, store.set_cap)
            cnts.append(je.count_matches_dev(st, root.skel_cols, prog.ord))
            ngroups.append(_isum(st.valid))
            ovfs.append(ovf)
            out = _put(out, m, me, MatchStore(skeleton=st.skeleton, valid=st.valid,
                                              sets=st.sets))
            del st
        diag = {"count": mesh.psum(cnts), "store_groups": mesh.psum(ngroups),
                "overflow": mesh.psum(ovfs)}
        return out, diag

    return step


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


def make_maintain_step(prog: TreeProgram, units: Sequence[R1Unit], mesh: LocalMesh,
                       caps: EngineCaps, store: StoreCaps):
    """Step: (Φ(d'), store, E_a, E_d) → (store', patch, diag).

    Patch ∘ filter ∘ merge ∘ count, the device twin of
    ``repro.core.incremental.apply_update_to_matches``. ``diag``:
    ``count``, ``patch_groups``, ``removed_groups``, ``store_groups``,
    ``overflow``, ``store_overflow``.

    The step consumes its input store: each shard is overwritten in place
    by its result (the store holds ``m·group_cap·set_cap`` values, so a
    second copy would double the step's largest allocation). The returned
    store is the same object.
    """
    pattern = prog.nodes[prog.root].pattern
    skel_cols = prog.nodes[prog.root].skel_cols
    chains = _chain_plans(units, pattern, prog.cover, prog.ord)
    skel_pairs, comp_pairs = je.deleted_edge_cols(pattern, skel_cols)

    def step(pt2_st: PaddedPartition, st_st: MatchStore, add: torch.Tensor,
             dele: torch.Tensor):
        pts2 = [_part(pt2_st, j) for j in mesh.indices()]
        patches, povf = _patch_body(pts2, add, prog, chains, mesh, caps)
        d_tbl = _delete_table(dele)
        cnts, removed, ngroups, movfs = [], [], [], []
        for me in mesh.indices():
            merged, rem, movf, cnt = _maintain_local(
                _comp(_part(st_st, me)), patches[me], d_tbl, prog, store,
                skel_pairs, comp_pairs, skel_cols, caps)
            ngroups.append(_isum(merged.valid))
            _put(st_st, mesh.size, me, MatchStore(skeleton=merged.skeleton,
                                                  valid=merged.valid, sets=merged.sets))
            del merged
            cnts.append(cnt)
            removed.append(rem)
            movfs.append(movf)
        diag = {
            "count": mesh.psum(cnts),
            "patch_groups": mesh.psum([_isum(p.valid) for p in patches]),
            "removed_groups": mesh.psum(removed),
            "store_groups": mesh.psum(ngroups),
            "overflow": mesh.psum([a + b for a, b in zip(povf, movfs)]),
            "store_overflow": mesh.psum(movfs),
        }
        return st_st, _stack(patches), diag

    return step
