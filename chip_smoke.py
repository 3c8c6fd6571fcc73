"""Drive the PyTorch/CUDA port of DDSL end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Prints one JSON object per line, in phases:

1. ``build``   — compiles ``src/repro_torch/kernels/csrc/*.cu`` (sm_90a).
2. ``kernel_check`` — each kernel against its plain PyTorch version at the
   main path's shapes and at edge cases (exact equality: the data are
   integers), with median times over CUDA events.
3. ``stage1`` / ``batch`` — the main path with the kernels: q1_square on
   the WT~ graph (rmat_graph(12, 10_000, seed=1)) over m = 8 partitions,
   stage 1 then three 64 + 64 edge batches; time, count, overflow and
   peak device memory of each stage.
4. ``audit`` — stage 1 listed again from scratch on the final partitions;
   its count must equal the maintained count.
5. ``plain``   — the same path with ``use_kernels=False`` on the card; the
   counts and the MatchStore tensors must equal the kernel run's.
6. ``reference`` — the example graph of examples/distributed_listing.py,
   whose host-engine counts are known, checked on the card.
7. ``kernel_check`` (``segment_sum``) — the segment-sum kernel against its
   plain version on its float64 accumulators: one gatedgcn edge slice
   ([2**24, 70] bf16, ids over 2,449,029 nodes with 1 % set to n and
   0.5 % to -1), the meshgraphnet and graphsage widths, a ones column
   (exact), and edge cases; max |kernel - plain| <= 1e-5 * max(1, max
   |plain|), with the kernel's, the plain version's and ``index_add_``'s
   median ms beside the byte bound.
8. ``gnn_plan`` / ``gnn_forward`` — GNN full-graph inference: gatedgcn at
   its full config (16 layers, d_hidden 70, bf16, d_in 100) on the
   ``ogb_products`` shape (2,449,029 nodes, 123,718,280 directed edges,
   ``build_graph_data`` seed 0), once with the kernels (every segment sum
   through the CUDA kernel: 16 layers x 2 sums x 8 edge slices launches)
   and once plain; outputs finite. ``gnn_profile``: one more kernel
   forward under ``torch.profiler``. ``gnn_equal``: max |kernel - plain|
   <= 3e-2 * max |plain|, the share of equal outputs, and the largest
   difference between the two kernel forwards.
9. ``gnn_small`` — graphsage-reddit (float32, limit 1e-4 * max |plain|)
   and meshgraphnet (bf16, 3e-2) at their full configs on
   ``full_graph_sm`` (2,708 nodes, 21,112 directed edges, d_feat 1,433),
   kernel against plain.
10. ``kernel_check`` (``flash_attention``) — the attention kernel against
   its plain version at the serving shapes (prefill q [4, 24, 8192, 128]
   over k/v [4, 8, 8208, 128]; the second 4,096-token chunk at offset
   4,096; decode at offsets 8,192 and 8,206) and at edge cases (float32
   and bf16; Dh 8, 20, 64, 128, 256; MHA; Lq 1; q_offset + Lq = Lk;
   non-causal; Lk not a multiple of the tile; a bf16 Dh 20 must raise).
   Each output element is held to the plain version on the inputs in
   float32 (see ``attention_limits``): within 1e-5 * sum_j p_j |v_j| in
   float32, and within one bf16 rounding of that in bf16. With the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   median ms beside the bound.
11. ``lm_plan`` / ``lm_serve`` — phi4-mini-3.8b serving at full width
   (32 layers, d_model 3,072, 24/8 heads of 128, d_ff 8,192, vocab
   200,064, bf16, random weights from seed 0) through
   ``repro_torch.launch.serve.serve``: 4 prompts of 8,192 tokens, prefill
   then 15 greedy decode steps, once with the kernels (32 launches of
   the 64-row ``flash_attention`` kernel and 480 of the one-row
   ``flash_decode`` kernel) and once plain, teacher-forced on the kernel
   run's tokens (0 launches); outputs finite. ``lm_chunked``:
   ``prefill_chunked`` (chunk 4,096, 64 launches) on the same prompts;
   its last logits and its cache within 1e-2 * max |unchunked| of the
   unchunked prefill's, and the same first token. ``lm_profile``: one
   more kernel prefill and one decode step under ``torch.profiler``.
   ``lm_equal``: the gate, the same model in
   float32 (2 prompts of 2,048 tokens, 8 tokens each), kernel against
   plain within 1e-3 * max |plain| of the logits at every step; and,
   reported, the bf16 run's largest logit difference and its share of
   equal greedy tokens.

Then a ``device`` line with the card's name and power limit (the
``nvidia-smi --query-gpu=name,power.limit`` line), the ``kernels``
summary, and last
``{"ok": true, "device": ...}``. Any mismatch, nonzero overflow or
failed phase exits nonzero without that line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

# Host-engine counts (repro.core.DDSL, the NumPy reference) of the two
# configurations, from the JAX package's engine on the same seeds.
WT_INITIAL_COUNT = 395_050
EXAMPLE_COUNTS = {"q1_square": (1282, 1238, 1128, 1086), "q2_triangle": (188, 182, 172, 168)}

# NVIDIA H100 SXM data sheet: HBM3 rate, the float32 rate outside the
# tensor cores as the peak for 32-bit integer compares and float32 adds and
# float32 attention, and the dense bf16 tensor-core rate for bf16 attention.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
N_BATCHES = 3
DDSL_KERNELS = ("member_probe", "set_intersect")
# The GNN slice: gatedgcn on ogb_products (configs/registry.py GNN_SHAPES;
# a full-graph run doubles the undirected edges, launch/steps.py).
GNN_ARCH, GNN_SHAPE = "gatedgcn", "ogb_products"
GNN_SMALL = (("graphsage-reddit", 1e-4), ("meshgraphnet", 3e-2))
# The LM slice: phi4-mini-3.8b serving (configs/phi4_mini_3_8b.py _FULL).
# The repo's prefill_32k shape (32 x 32,768 tokens) needs a 137 GB cache:
# cut to 4 prompts of 8,192 tokens and 16 generated tokens each.
LM_ARCH = "phi4-mini-3.8b"
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHUNK = 4, 8192, 16, 4096
LM_EQ_BATCH, LM_EQ_PROMPT, LM_EQ_GEN = 2, 2048, 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |kernel - plain| over the outputs, as integers."""
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float = PEAK_OPS_PER_S):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Inputs at the main path's shapes
# ---------------------------------------------------------------------------

def sorted_table(n_rows: int, n_pad: int, hi_max: int, gen) -> torch.Tensor:
    """A lex-sorted unique (hi, lo) table with a (-1, -1) tail, on the card."""
    hi = torch.randint(0, hi_max, (n_rows,), generator=gen, dtype=torch.int64, device="cuda")
    lo = hi + 1 + torch.randint(0, hi_max, (n_rows,), generator=gen, dtype=torch.int64,
                                device="cuda")
    codes = torch.unique(hi * (1 << 32) + lo)
    t = torch.stack([codes >> 32, codes & 0xFFFFFFFF], 1).to(torch.int32)
    return torch.cat([t, torch.full((n_pad, 2), -1, dtype=torch.int32, device="cuda")])


def probe_queries(n: int, table: torch.Tensor, hi_max: int, gen) -> torch.Tensor:
    """Queries: half drawn from the table's rows, the rest random or pad."""
    q = torch.randint(-1, hi_max, (n, 2), generator=gen, dtype=torch.int32, device="cuda")
    take = torch.randint(0, table.shape[0], (n // 2,), generator=gen, device="cuda")
    q[: n // 2] = table[take]
    q[::7] = -1
    return q


def padded_sets(g: int, c: int, v_max: int, gen) -> torch.Tensor:
    """Rows ascending with a PAD tail (the CompTensors set layout)."""
    vals = torch.sort(torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32,
                                    device="cuda"), dim=1).values
    lens = torch.randint(0, c + 1, (g, 1), generator=gen, device="cuda")
    vals[torch.arange(c, device="cuda")[None, :] >= lens] = -1
    return vals


def kernel_phase(pipe_shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.member_probe import member_probe_cuda
    from repro_torch.kernels.set_intersect import set_intersect_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    caps, ush, store = pipe_shapes
    results = {}

    # --- member_probe: every call shape of the main path ----------------
    cedge = ush["cedge_cap"]
    drop = sorted_table(cedge, 64, 4096, gen)
    dele = sorted_table(64, 0, 4096, gen)
    cases = {
        # patch_partition: candidate rows × (candidate ∪ deleted) edges
        "patch_rows": (ush["cand_cap"] * caps["deg_cap"], drop),
        # patch_partition: stored edge list × the same drop table
        "patch_edges": (caps["e_cap"], drop),
        # filter_deleted_dev: store set values × the delete table
        "filter_sets": (store["group_cap"] * store["set_cap"], dele),
        # edge cases: one-row table, all-pad table
        "tiny": (1000, sorted_table(1, 0, 4096, gen)),
        "all_pad": (1000, torch.full((5, 2), -1, dtype=torch.int32, device="cuda")),
    }
    mp = []
    for name, (n, tbl) in cases.items():
        q = probe_queries(n, tbl, 4096, gen)
        args = (q[:, 0].contiguous(), q[:, 1].contiguous(),
                tbl[:, 0].contiguous(), tbl[:, 1].contiguous())
        got = member_probe_cuda(*args)
        want = ref.member_probe_ref(*args)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        check(err == 0, f"member_probe {name}: {err} mismatches")
        rec = {"case": name, "n": n, "m": int(tbl.shape[0]), "equal": True,
               "max_abs_err": max_abs_err(got, want)}
        if n >= 1 << 20:
            m_rows = tbl.shape[0]
            rec["ms"] = cuda_ms(lambda: member_probe_cuda(*args))
            rec["plain_ms"] = cuda_ms(lambda: ref.member_probe_ref(*args), reps=3)
            qk = args[0].to(torch.int64) * (1 << 32) + args[1].to(torch.int64)
            tk = args[2].to(torch.int64) * (1 << 32) + args[3].to(torch.int64)
            rec["library_ms"] = cuda_ms(lambda: torch.isin(qk, tk), reps=3)
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                9.0 * n + 8.0 * m_rows, n * math.ceil(math.log2(m_rows + 1)))
        mp.append(rec)
    # empty query / empty table: answered without a launch
    e = torch.empty(0, dtype=torch.int32, device="cuda")
    one = torch.zeros(3, dtype=torch.int32, device="cuda")
    check(member_probe_cuda(e, e, one, one).numel() == 0, "member_probe N=0")
    check(not member_probe_cuda(one, one, e, e).any(), "member_probe M=0")
    results["member_probe"] = mp

    # --- set_intersect ---------------------------------------------------
    G, S = caps["group_cap"], caps["set_cap"]
    si = []
    for name, (g, ca, cb) in {"ccjoin": (G, S, S), "zcommon": (cedge, caps["deg_cap"],
                                                                caps["deg_cap"]),
                              "wide": (3, 5000, 9000), "narrow": (7, 1, 3)}.items():
        a = padded_sets(g, ca, 4096, gen)
        b = padded_sets(g, cb, 4096, gen)
        if name == "narrow":   # duplicates and unsorted rows
            a = torch.randint(-1, 3, (g, ca), generator=gen, dtype=torch.int32, device="cuda")
            b = torch.randint(-1, 3, (g, cb), generator=gen, dtype=torch.int32, device="cuda")
        got = set_intersect_cuda(a, b, -1)
        want = ref.set_intersect_ref(a, b, -1)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        check(err == 0, f"set_intersect {name}: {err} mismatches")
        rec = {"case": name, "g": g, "ca": ca, "cb": cb, "equal": True,
               "max_abs_err": max_abs_err(got, want)}
        if g * ca >= 1 << 20:
            rec["ms"] = cuda_ms(lambda: set_intersect_cuda(a, b, -1))
            rec["plain_ms"] = cuda_ms(lambda: ref.set_intersect_ref(a, b, -1), reps=3)
            rows = torch.arange(g, device="cuda", dtype=torch.int64)[:, None] * (1 << 32)
            ak, bk = (rows + a.to(torch.int64)).reshape(-1), (rows + b.to(torch.int64)).reshape(-1)
            rec["library_ms"] = cuda_ms(lambda: torch.isin(ak, bk), reps=3)
            rec["bound_ms"], rec["bound_by"] = bound_ms(4.0 * g * (ca + cb) + g * ca,
                                                        g * (ca + cb))
        si.append(rec)
    empty = torch.empty((0, 4), dtype=torch.int32, device="cuda")
    check(set_intersect_cuda(empty, empty, -1).shape == (0, 4), "set_intersect G=0")
    results["set_intersect"] = si
    return results


# ---------------------------------------------------------------------------
# Main path
# ---------------------------------------------------------------------------

def store_snapshot(store):
    """Per shard: the valid prefix of every store tensor on the host, after
    checking that the rest is PAD (so equal snapshots mean equal tensors)."""
    snap = []
    for j in range(store.valid.shape[0]):
        valid = store.valid[j]
        n = int(valid.sum())
        check(bool(valid[:n].all()) and not bool(valid[n:].any()), "store valid is a prefix")
        check(bool((store.skeleton[j, n:] == -1).all()), "store skeleton tail is PAD")
        shard = {"n": n, "skeleton": store.skeleton[j, :n].cpu()}
        for v, a in store.sets.items():
            check(bool((a[j, n:] == -1).all()), "store set tail is PAD")
            shard[v] = a[j, :n].cpu()
        snap.append(shard)
    return snap


def snapshots_equal(a, b) -> bool:
    return all(x.keys() == y.keys() and all(
        (x[k] == y[k]) if k == "n" else torch.equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b)) and len(a) == len(b)


def drive(config, use_kernels: bool, label: str):
    """Stage 1 + N_BATCHES batches through ``repro_torch.run.stages``;
    returns (records, store snapshots, pipeline)."""
    from repro_torch.run import Pipeline, stages

    t0 = time.perf_counter()
    pipe = Pipeline(config, "cuda", use_kernels=use_kernels)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    recs, snaps = [], []
    for d in stages(pipe, N_BATCHES):
        d["run"] = label
        if d["phase"] == "stage1":
            d["setup_seconds"] = setup_s
        emit(d)
        recs.append(d)
        snaps.append(store_snapshot(pipe.store))
    return recs, snaps, pipe


def profiled(fn):
    """``fn()`` under ``torch.profiler``: its result, and wall time, summed
    device time of its kernels, idle share and the kernels that took most
    of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: a CPU-side op also reports its kernels' device time, and
    # "Command Buffer Full" marks a full launch queue, not device work.
    dev = [(e.key, e.self_device_time_total / 1e6, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
           and not e.key.startswith("Command Buffer")]
    busy = sum(s for _, s, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:12]
    return result, {"wall_s": wall, "device_s": busy, "idle_share": max(0.0, 1 - busy / wall),
                    "top": [{"kernel": k[:90], "s": s, "calls": n} for k, s, n in top]}


def profile_batch(pipe):
    """One more batch under ``torch.profiler``."""
    upd = pipe.next_update()
    d, prof = profiled(lambda: {k: int(v) for k, v in pipe.apply(upd).items()})
    emit({"phase": "profile", "count": d["count"], "overflow": d["overflow"], **prof})
    return d


# ---------------------------------------------------------------------------
# GNN slice: segment_sum and full-graph inference
# ---------------------------------------------------------------------------

def segment_ids(e: int, n: int, gen, out_of_range: bool = True) -> torch.Tensor:
    """Ids uniform over [0, n), unsorted; 1 % set to n and 0.5 % to -1."""
    seg = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32, device="cuda")
    if out_of_range:
        r = torch.rand(e, generator=gen, device="cuda")
        seg[r < 0.01] = n
        seg[(r >= 0.01) & (r < 0.015)] = -1
    return seg


def segment_sum_phase():
    """The segment-sum kernel against its plain version on their float64
    accumulators (``ref.ACC_DTYPE``), at the GNN path's shapes and at edge
    cases. The bound and the ``index_add_`` yardstick are those of the
    function itself, whose accumulator is float32: the kernel's float64
    traffic shows as distance from the bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_sum_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    big_n, big_e = 2_449_029, 1 << 24
    bf16, f32 = torch.bfloat16, torch.float32

    def rows(e, d, dtype):
        return torch.randn((e, d), generator=gen, device="cuda").to(dtype)

    cases = {
        # one gatedgcn edge slice (msg / eta) at full width
        "gatedgcn_slice": (rows(big_e, 70, bf16), segment_ids(big_e, big_n, gen), big_n),
        # the _segment_mean ones column over the same ids: integer sums, exact
        "ones_column": (torch.ones((big_e, 1), dtype=bf16, device="cuda"),
                        segment_ids(big_e, big_n, gen), big_n),
        # meshgraphnet (d 128, bf16) and graphsage layer 0 (d 1433, float32)
        # on full_graph_sm
        "meshgraphnet": (rows(21_112, 128, bf16), segment_ids(21_112, 2708, gen), 2708),
        "graphsage_l0": (rows(21_112, 1433, f32), segment_ids(21_112, 2708, gen), 2708),
        # edge cases
        "empty": (rows(0, 70, bf16), segment_ids(0, 10, gen), 10),
        "all_out_of_range": (rows(5000, 70, bf16),
                             torch.where(segment_ids(5000, 2, gen, False) == 0, -1, 64).int(), 64),
        "n_1": (rows(4097, 3, f32), segment_ids(4097, 1, gen), 1),
        "unsorted_duplicates": (rows(3001, 5, f32),
                                torch.randint(-2, 9, (3001,), generator=gen, dtype=torch.int32,
                                              device="cuda"), 7),
    }
    out = []
    for name, (data, seg, n) in cases.items():
        e, d = data.shape
        zeros = lambda: torch.zeros((n, d), dtype=ref.ACC_DTYPE, device="cuda")  # noqa: E731
        got = segment_sum_cuda(data, seg, zeros())
        want = ref.segment_sum_ref(data, seg, n, zeros())
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        top = float(want.abs().max()) if want.numel() else 0.0
        limit = 0.0 if name in ("ones_column", "empty", "all_out_of_range") else \
            1e-5 * max(1.0, top)
        check(err <= limit, f"segment_sum {name}: max |kernel - plain| {err} > {limit}")
        if name == "all_out_of_range":
            check(not got.any(), "segment_sum: out-of-range ids were added")
        rec = {"case": name, "rows": e, "d": d, "n": n, "dtype": str(data.dtype).split(".")[-1],
               "max_abs_err": err, "max_abs_ref": top, "limit": limit}
        if e * d >= 1 << 20:
            keep = (seg >= 0) & (seg < n)
            src = torch.where(keep[:, None], data.float(), 0.0)
            idx = seg.clamp(0, n - 1)
            acc = torch.zeros((n, d), dtype=torch.float32, device="cuda")
            rec["ms"] = cuda_ms(lambda: segment_sum_cuda(data, seg, got))
            rec["plain_ms"] = cuda_ms(lambda: ref.segment_sum_ref(data, seg, n, want), reps=3)
            rec["library_ms"] = cuda_ms(lambda: acc.index_add_(0, idx, src))
            # the function's bytes: data and ids read once, a float32 [n, d]
            # accumulator written once; e * d float32 adds
            n_bytes = e * d * data.element_size() + 4 * e + 4 * n * d
            rec["bytes"] = n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, e * d)
            del keep, src, idx, acc
        out.append(rec)
        del data, seg, got, want
    torch.cuda.empty_cache()
    return out


def gnn_forward(params, g, cfg, use_kernels: bool, label: str):
    """One full-graph forward; its record, output and launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import gnn

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = gnn.forward(params, g, cfg, use_kernels=use_kernels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    rec = {"phase": "gnn_forward", "arch": cfg.name, "run": label, "seconds": seconds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "segment_sum_launches": counts["segment_sum"], "inference_mode": out.is_inference(),
           "shape": list(out.shape), "dtype": str(out.dtype).split(".")[-1],
           "finite": bool(torch.isfinite(out).all()), "max_abs_out": float(out.abs().max())}
    check(rec["finite"], f"{cfg.name} {label}: output is not finite")
    check(rec["inference_mode"], f"{cfg.name} {label}: forward ran outside inference_mode")
    return rec, out, counts


def compare_outputs(name: str, out_k, out_p, tol: float):
    delta = (out_k.float() - out_p.float()).abs()
    diff = float(delta.max())
    top = float(out_p.float().abs().max())
    rec = {"arch": name, "max_abs_diff": diff, "max_abs_plain": top,
           "ratio": diff / top if top else 0.0, "limit_ratio": tol,
           "equal_share": float((delta == 0).float().mean())}
    check(diff <= tol * top, f"{name}: max |kernel - plain| {diff} > {tol} * {top}")
    return rec


def gnn_profile(params, g, cfg):
    """One kernel forward under ``torch.profiler``; returns its output."""
    from repro_torch.models import gnn

    out, prof = profiled(lambda: gnn.forward(params, g, cfg, use_kernels=True))
    emit({"phase": "gnn_profile", "arch": cfg.name, **prof})
    return out


def gnn_phase():
    """gatedgcn full-graph inference at ogb_products size, kernels then
    plain; returns the kernel run's launch counts."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.data import build_graph_data
    from repro_torch.models import gnn
    import dataclasses

    spec = get_arch(GNN_ARCH)
    shape = spec.shape(GNN_SHAPE)
    cfg = dataclasses.replace(spec.config, d_in=shape.d_feat)
    n_nodes, n_edges = shape.n_nodes, 2 * shape.n_edges
    t0 = time.perf_counter()
    raw = build_graph_data(n_nodes, n_edges, shape.d_feat, seed=0)
    data_s = time.perf_counter() - t0
    g = graph_from_numpy(raw, "cuda")
    del raw
    params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    slices = math.ceil(n_edges / gnn.EDGE_SLICE)
    predicted = cfg.n_layers * 2 * slices
    emit({"phase": "gnn_plan", "arch": cfg.name, "shape": GNN_SHAPE, "nodes": n_nodes,
          "edges": n_edges, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden, "d_out": cfg.d_out,
          "layers": cfg.n_layers, "dtype": cfg.dtype, "edge_slice": gnn.EDGE_SLICE,
          "slices": slices, "predicted_segment_sum_launches": predicted,
          "data_seconds": data_s, "setup_seconds": time.perf_counter() - t0,
          "resident_gib": torch.cuda.memory_allocated() / 2**30})

    rec, out_k, counts = gnn_forward(params, g, cfg, True, "kernels")
    emit(rec)
    check(counts["segment_sum"] == predicted,
          f"segment_sum launched {counts['segment_sum']} times, predicted {predicted}")
    for name in DDSL_KERNELS:
        check(counts[name] == 0, f"{name} launched on the GNN path")
    rec, out_p, plain_counts = gnn_forward(params, g, cfg, False, "plain")
    emit(rec)
    check(not any(plain_counts.values()), f"the plain forward launched kernels: {plain_counts}")
    equal = compare_outputs(cfg.name, out_k, out_p, 3e-2)
    del out_p
    # a second kernel forward (profiled): the float64 sums make it repeat
    out_r = gnn_profile(params, g, cfg)
    equal["kernel_repeat_max_abs_diff"] = float((out_r.float() - out_k.float()).abs().max())
    emit({"phase": "gnn_equal", **equal})
    del out_k, out_r, g, params
    torch.cuda.empty_cache()
    return counts


def gnn_small_phase():
    """graphsage-reddit and meshgraphnet at full width on full_graph_sm."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import graph_from_numpy
    from repro_torch.data import build_graph_data
    from repro_torch.models import gnn
    import dataclasses

    for arch, tol in GNN_SMALL:
        spec = get_arch(arch)
        shape = spec.shape("full_graph_sm")
        cfg = dataclasses.replace(spec.config, d_in=shape.d_feat)
        raw = build_graph_data(shape.n_nodes, 2 * shape.n_edges, shape.d_feat,
                               d_edge=cfg.d_edge_in, seed=0)
        g = graph_from_numpy(raw, "cuda")
        params = gnn.init_params(cfg, torch.Generator(device="cuda").manual_seed(2), "cuda")
        rec_k, out_k, counts = gnn_forward(params, g, cfg, True, "kernels")
        rec_p, out_p, _ = gnn_forward(params, g, cfg, False, "plain")
        check(counts["segment_sum"] > 0, f"{arch}: segment_sum never launched")
        emit({"phase": "gnn_small", "shape": "full_graph_sm", "nodes": shape.n_nodes,
              "edges": 2 * shape.n_edges, "dtype": cfg.dtype,
              "segment_sum_launches": counts["segment_sum"],
              "kernel_seconds": rec_k["seconds"], "plain_seconds": rec_p["seconds"],
              **compare_outputs(arch, out_k, out_p, tol)})


# ---------------------------------------------------------------------------
# LM slice: flash_attention and phi4-mini-3.8b serving
# ---------------------------------------------------------------------------

def attention_work(b, hq, hkv, lq, lk, dh, off, causal, elem):
    """The function's keys admitted per query row, operations and bytes:
    4 * b * hq * dh FLOP per admitted (query, key) pair; q and out once, and
    the admitted key/value rows of each KV head once."""
    admitted = off + lq if causal else lk
    pairs = lq * off + lq * (lq + 1) // 2 if causal else lq * lk
    flops = 4 * b * hq * dh * pairs
    n_bytes = elem * (2 * b * hq * lq * dh + 2 * b * hkv * admitted * dh)
    return admitted, flops, n_bytes


def sdpa_call(q, k, v, off, causal):
    """One ``scaled_dot_product_attention`` call computing the same
    function, on K/V cut to the admitted keys (its yardstick; the port
    never calls it)."""
    import torch.nn.functional as F

    lq = q.shape[2]
    admitted = off + lq if causal else k.shape[2]
    kc, vc = k[:, :, :admitted].contiguous(), v[:, :, :admitted].contiguous()
    if causal and lq == admitted:
        return lambda: F.scaled_dot_product_attention(q, kc, vc, is_causal=True, enable_gqa=True)
    mask = None
    if causal:
        i = torch.arange(lq, device=q.device)[:, None]
        mask = torch.arange(admitted, device=q.device)[None, :] <= i + (admitted - lq)
    return lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=mask, enable_gqa=True)


def attention_limits(q, k, v, off, causal):
    """The plain version on the inputs in float32, and the limit each
    output element is held to. A float32 evaluation of the softmax-weighted
    mean sum_j p_j v_j errs by some float32 roundings of sum_j p_j |v_j|
    (the plain version over |v|): the float32 limit is 1e-5 of that. A
    bfloat16 output is one rounding of such a float32 value, off by at
    most 2**-8 of its size."""
    from repro_torch.kernels import ref

    q32, k32, v32 = q.float(), k.float(), v.float()
    want = ref.flash_attention_ref(q32, k32, v32, causal=causal, q_offset=off)
    limit = 1e-5 * ref.flash_attention_ref(q32, k32, v32.abs(), causal=causal, q_offset=off)
    if q.dtype == torch.bfloat16:
        limit = 2.0**-8 * want.abs() + (1 + 2.0**-8) * limit
    return want, limit


def flash_attention_phase():
    """The attention kernel against its plain version at the serving
    shapes and at edge cases, each timed beside its plain version, SDPA
    and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    mx = LM_PROMPT + LM_GEN
    # name: (b, hq, hkv, lq, lk, dh, q_offset, causal, dtypes)
    cases = {
        "prefill": (LM_BATCH, 24, 8, LM_PROMPT, mx, 128, 0, True, (bf16,)),
        "chunk_2": (LM_BATCH, 24, 8, LM_CHUNK, mx, 128, LM_CHUNK, True, (bf16,)),
        "decode_first": (LM_BATCH, 24, 8, 1, mx, 128, LM_PROMPT, True, (bf16,)),
        "decode_last": (LM_BATCH, 24, 8, 1, mx, 128, mx - 2, True, (bf16,)),
        "prefill_f32_gate": (LM_EQ_BATCH, 24, 8, LM_EQ_PROMPT, LM_EQ_PROMPT + LM_EQ_GEN, 128, 0,
                             True, (f32,)),
        "dh8": (2, 6, 2, 300, 333, 8, 0, True, (f32, bf16)),
        "dh64_mha": (2, 8, 8, 257, 257, 64, 0, True, (f32, bf16)),
        "lq1": (3, 6, 2, 1, 1000, 128, 517, True, (f32, bf16)),
        "offset_plus_lq_eq_lk": (1, 6, 2, 100, 357, 128, 257, True, (f32, bf16)),
        "noncausal": (2, 6, 2, 200, 512, 128, 0, False, (f32, bf16)),
        "lk_not_tile_multiple": (1, 3, 1, 1000, 1001, 128, 1, True, (f32, bf16)),
        "dh256_short": (1, 4, 2, 9, 40, 256, 31, True, (f32, bf16)),
        # Dh 20: five 16-byte float32 chunks, a partial column block
        "dh20": (2, 4, 2, 50, 77, 20, 27, True, (f32,)),
        "dh20_lq3": (2, 4, 2, 3, 77, 20, 74, True, (f32,)),
    }
    # Dh 20 in bf16 is not a whole number of 16-byte chunks: refused
    q, k = (torch.zeros(s, device="cuda", dtype=bf16) for s in ((1, 2, 3, 20), (1, 2, 9, 20)))
    try:
        flash_attention_cuda(q, k, k, causal=True, q_offset=0)
        fail("flash_attention took a bf16 Dh of 20")
    except ValueError:
        pass
    out = []
    for name, (b, hq, hkv, lq, lk, dh, off, causal, dtypes) in cases.items():
        for dtype in dtypes:
            q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                       for s in ((b, hq, lq, dh), (b, hkv, lk, dh), (b, hkv, lk, dh)))
            got = flash_attention_cuda(q, k, v, causal=causal, q_offset=off)
            want = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
            want32, limit = attention_limits(q, k, v, off, causal)
            dev = (got.float() - want32).abs()
            worst = float((dev / limit).max())
            err = float((got.float() - want.float()).abs().max())
            tag = str(dtype).split(".")[-1]
            check(worst <= 1.0, f"flash_attention {name} {tag}: |kernel - plain in float32| "
                                f"reaches {worst} of its limit")
            rec = {"case": name, "dtype": tag, "b": b, "hq": hq, "hkv": hkv, "lq": lq, "lk": lk,
                   "dh": dh, "q_offset": off, "causal": causal, "max_abs_err": err,
                   "max_abs_ref": float(want32.abs().max()),
                   "max_abs_err_f32_plain": float(dev.max()), "max_err_over_limit": worst}
            del want32, limit, dev
            admitted, flops, n_bytes = attention_work(b, hq, hkv, lq, lk, dh, off, causal,
                                                      q.element_size())
            rec["ms"] = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                             q_offset=off))
            rec["plain_ms"] = cuda_ms(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal, q_offset=off), reps=3)
            rec["library_ms"] = cuda_ms(sdpa_call(q, k, v, off, causal))
            rec["admitted_keys"], rec["flops"], rec["bytes"] = admitted, flops, n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_bytes, flops, PEAK_BF16_FLOPS if dtype == bf16 else PEAK_OPS_PER_S)
            rec["tflop_per_s"] = flops / rec["ms"] / 1e9
            out.append(rec)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def lm_run(cfg, params, prompt, gen: int, use_kernels: bool, label: str, forced=None):
    """One ``serve`` call (prefill + gen - 1 decode steps); its record,
    result and launch counts, the counts taken over exactly this call."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve(cfg, params, prompt, gen, use_kernels=use_kernels, forced=forced)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    b = prompt.shape[0]
    prefill_s = res.records[0]["seconds"]
    decode = [r["seconds"] for r in res.records[1:]]
    rec = {"phase": "lm_serve", "arch": cfg.name, "run": label, "dtype": cfg.dtype, "batch": b,
           "prompt_len": prompt.shape[1], "gen": gen, "teacher_forced": forced is not None,
           "prefill_seconds": prefill_s, "decode_seconds": sum(decode),
           "decode_ms_per_step": 1e3 * sum(decode) / len(decode),
           "decode_ms_median": 1e3 * statistics.median(decode),
           "decode_tokens_per_s": b * len(decode) / sum(decode),
           "generated_tokens_per_s": b * gen / wall, "wall_seconds": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "flash_attention_launches": counts["flash_attention"],
           "flash_decode_launches": counts["flash_decode"],
           "finite": bool(torch.isfinite(res.logits).all()),
           "ids_first_request": res.ids[0].tolist()}
    check(rec["finite"], f"{cfg.name} {label}: logits are not finite")
    check(tuple(res.ids.shape) == (b, gen), f"{cfg.name} {label}: ids {tuple(res.ids.shape)}")
    return rec, res, counts


def step_ratios(res_k, res_p):
    """max |kernel - plain| / max |plain| of the logits at each step."""
    out = []
    for i in range(res_k.logits.shape[1]):
        lk, lp = res_k.logits[:, i].float(), res_p.logits[:, i].float()
        out.append(float((lk - lp).abs().max()) / float(lp.abs().max()))
    return out


def lm_phase():
    """phi4-mini-3.8b serving at full width: kernels, plain, chunked,
    profiled, and the float32 gate; returns the kernel run's launches.
    A prefill launches the 64-row kernel once a layer, a decode step the
    one-row kernel once a layer."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import prompt_tokens
    from repro_torch.models import transformer as tf
    import dataclasses

    cfg = get_arch(LM_ARCH).config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    resident = torch.cuda.memory_allocated() / 2**30
    prompt = torch.from_numpy(prompt_tokens(cfg.vocab, LM_BATCH, LM_PROMPT, 0)).cuda()
    predicted = {"flash_attention": cfg.n_layers, "flash_decode": cfg.n_layers * (LM_GEN - 1)}
    emit({"phase": "lm_plan", "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads, "d_head": cfg.d_head,
          "d_ff": cfg.d_ff, "vocab": cfg.vocab, "dtype": cfg.dtype,
          "params": cfg.param_count(), "batch": LM_BATCH, "prompt_len": LM_PROMPT,
          "gen": LM_GEN, "max_len": LM_PROMPT + LM_GEN,
          "predicted_launches": predicted, "init_seconds": init_s,
          "resident_gib": resident})

    rec, res_k, counts = lm_run(cfg, params, prompt, LM_GEN, True, "kernels")
    rec["resident_gib"] = resident
    emit(rec)
    for name, n in predicted.items():
        check(counts[name] == n, f"{name} launched {counts[name]} times, predicted {n}")
    others = {k: n for k, n in counts.items() if k not in predicted and n}
    check(not others, f"other kernels launched on the LM path: {others}")
    rec, res_p, plain_counts = lm_run(cfg, params, prompt, LM_GEN, False, "plain",
                                      forced=res_k.ids)
    rec["resident_gib"] = resident
    emit(rec)
    check(not any(plain_counts.values()), f"the plain serve launched kernels: {plain_counts}")
    ratios = step_ratios(res_k, res_p)
    bf16_equal = {"dtype": "bfloat16", "max_ratio": max(ratios), "step_ratios": ratios,
                  "equal_token_share": float((res_k.ids == res_p.ids).float().mean())}
    del res_p
    torch.cuda.empty_cache()

    # chunked prefill against the kernel run's unchunked prefill
    from repro_torch.kernels import ops

    cache = tf.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_c, _ = tf.prefill_chunked(params, prompt, cache, cfg, chunk=LM_CHUNK, use_kernels=True)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    chunk_counts = ops.launch_counts()
    n_chunk = chunk_counts["flash_attention"]
    want = cfg.n_layers * (LM_PROMPT // LM_CHUNK)
    check(n_chunk == want and chunk_counts["flash_decode"] == 0,
          f"chunked prefill launched {chunk_counts}, predicted {want} flash_attention")
    whole = res_k.logits[:, 0].float()
    rec = {"phase": "lm_chunked", "chunk": LM_CHUNK, "seconds": chunked_s,
           "flash_attention_launches": n_chunk,
           "finite": bool(torch.isfinite(logits_c).all()),
           "logits_max_abs_diff": float((logits_c[:, -1].float() - whole).abs().max()),
           "logits_max_abs_unchunked": float(whole.abs().max()),
           "same_first_token": bool(torch.equal(logits_c[:, -1].argmax(-1), res_k.ids[:, 0]))}
    for i, name in enumerate(("k", "v")):
        a = cache["dense"][i][:, :, :, :LM_PROMPT].float()
        b = res_k.cache["dense"][i][:, :, :, :LM_PROMPT].float()
        rec[f"cache_{name}_max_abs_diff"] = float((a - b).abs().max())
        rec[f"cache_{name}_max_abs"] = float(b.abs().max())
        del a, b
    emit(rec)
    check(rec["finite"], "chunked prefill logits are not finite")
    check(rec["same_first_token"], "chunked prefill picks another first token")
    for name in ("logits", "cache_k", "cache_v"):
        top = rec["logits_max_abs_unchunked" if name == "logits" else f"{name}_max_abs"]
        check(rec[f"{name}_max_abs_diff"] <= 1e-2 * top,
              f"chunked prefill {name}: max |chunked - unchunked| "
              f"{rec[f'{name}_max_abs_diff']} > 1e-2 * {top}")
    del cache, logits_c, res_k
    torch.cuda.empty_cache()

    # where a prefill's and a decode step's device time goes
    cache = tf.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN)
    (logits, _), prof = profiled(lambda: tf.prefill(params, prompt, cache, cfg,
                                                    use_kernels=True))
    emit({"phase": "lm_profile", "arch": cfg.name, "stage": "prefill", **prof})
    tok = logits[:, -1].argmax(-1)[:, None]
    _, prof = profiled(lambda: tf.decode_step(params, tok, cache, LM_PROMPT, cfg,
                                              use_kernels=True))
    emit({"phase": "lm_profile", "arch": cfg.name, "stage": "decode", "pos": LM_PROMPT, **prof})
    del cache, params, logits
    torch.cuda.empty_cache()

    # the gate: the same model in float32, kernels against plain
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tf.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt32 = torch.from_numpy(prompt_tokens(cfg.vocab, LM_EQ_BATCH, LM_EQ_PROMPT, 1)).cuda()
    rec_k, res_k, c32 = lm_run(cfg32, params32, prompt32, LM_EQ_GEN, True, "kernels")
    rec_p, res_p, _ = lm_run(cfg32, params32, prompt32, LM_EQ_GEN, False, "plain",
                             forced=res_k.ids)
    check(c32["flash_attention"] == cfg.n_layers
          and c32["flash_decode"] == cfg.n_layers * (LM_EQ_GEN - 1),
          f"float32 run launched {c32}")
    ratios = step_ratios(res_k, res_p)
    f32_equal = {"dtype": "float32", "batch": LM_EQ_BATCH, "prompt_len": LM_EQ_PROMPT,
                 "gen": LM_EQ_GEN, "limit_ratio": 1e-3, "max_ratio": max(ratios),
                 "step_ratios": ratios,
                 "equal_token_share": float((res_k.ids == res_p.ids).float().mean()),
                 "kernel_prefill_seconds": rec_k["prefill_seconds"],
                 "plain_prefill_seconds": rec_p["prefill_seconds"],
                 "kernel_decode_ms_per_step": rec_k["decode_ms_per_step"],
                 "plain_decode_ms_per_step": rec_p["decode_ms_per_step"]}
    emit({"phase": "lm_equal", "gate": f32_equal, "reported": bf16_equal})
    check(max(ratios) <= 1e-3, f"float32 logits: max |kernel - plain| / max |plain| "
                               f"{max(ratios)} > 1e-3")
    del params32, res_k, res_p
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ops
    from repro_torch.run import EXAMPLE_Q1, WT_Q1, Pipeline, stages
    import dataclasses

    # float32 products in full float32 on the card (no TF32), stated here:
    # the GNN comparisons hold float32 outputs to 1e-4.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    check(torch.cuda.device_count() == 1,
          f"expects one visible card, sees {torch.cuda.device_count()} "
          "(set CUDA_VISIBLE_DEVICES)")

    # 1. build
    build.library()
    emit({"phase": "build", "seconds": build.build_seconds(), "sources": [
        os.path.relpath(s, HERE) for s in build.SOURCES]})

    # 2. kernels against their plain versions at the main path's shapes
    shapes_pipe = Pipeline(dataclasses.replace(WT_Q1), "cuda")
    shapes = (dataclasses.asdict(shapes_pipe.caps), dataclasses.asdict(shapes_pipe.ushapes),
              dataclasses.asdict(shapes_pipe.store_caps))
    plan = shapes_pipe.describe()
    del shapes_pipe
    torch.cuda.empty_cache()
    checks = kernel_phase(shapes)
    emit({"phase": "kernel_check", **checks})

    # 3. main path with the kernels; launches counted over exactly this run
    emit({"phase": "plan", **plan})
    ops.reset_launch_counts()
    recs_k, snaps_k, pipe = drive(WT_Q1, True, "kernels")
    launches = ops.launch_counts()
    check(recs_k[0]["count"] == WT_INITIAL_COUNT,
          f"initial count {recs_k[0]['count']} != host {WT_INITIAL_COUNT}")
    for r in recs_k:
        check(r["overflow"] == 0, f"overflow in {r}")
    for name in DDSL_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    # where a batch's device time goes: one more batch under the profiler
    final = profile_batch(pipe)
    check(final["overflow"] == 0, f"overflow in the profiled batch {final}")
    final_snap = store_snapshot(pipe.store)

    # 4. audit: list from scratch on the final partitions (the maintained
    #    store is on the host as its snapshot; free it on the card first)
    pipe.store = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    astore, adiag = pipe.list_pattern()
    audit = {k: int(v) for k, v in adiag.items()}
    torch.cuda.synchronize()
    emit({"phase": "audit", **audit, "maintained": final["count"],
          "seconds": time.perf_counter() - t0,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    check(audit["overflow"] == 0 and audit["count"] == final["count"],
          "audit count differs from the maintained count")
    check(snapshots_equal(store_snapshot(astore), final_snap),
          "audit store differs from the maintained store")
    del pipe, astore
    torch.cuda.empty_cache()

    # 5. the plain path on the card must give the same counts and stores
    recs_p, snaps_p, pipe = drive(WT_Q1, False, "plain")
    for i, (a, b) in enumerate(zip(recs_k, recs_p)):
        check(a["count"] == b["count"] and a["overflow"] == b["overflow"],
              f"step {i}: kernel {a} vs plain {b}")
        check(snapshots_equal(snaps_k[i], snaps_p[i]), f"step {i}: MatchStore tensors differ")
    emit({"phase": "plain_equal", "steps": len(recs_k)})
    del pipe
    torch.cuda.empty_cache()

    # 6. small reference: host-engine counts of the example graph
    for pname, want in EXAMPLE_COUNTS.items():
        pipe = Pipeline(dataclasses.replace(EXAMPLE_Q1, pattern=pname), "cuda")
        got = []
        for d in stages(pipe, N_BATCHES):
            check(d["overflow"] == 0, f"reference {pname}: overflow")
            got.append(d["count"])
        check(tuple(got) == want, f"reference {pname}: {got} != host {list(want)}")
        emit({"phase": "reference", "pattern": pname, "counts": got, "host": list(want)})
    del pipe
    torch.cuda.empty_cache()

    # 7. segment_sum against its plain version at the GNN path's shapes
    checks["segment_sum"] = segment_sum_phase()
    emit({"phase": "kernel_check", "segment_sum": checks["segment_sum"]})

    # 8. GNN full-graph inference; launches counted over the kernel forward
    launches["segment_sum"] = gnn_phase()["segment_sum"]

    # 9. the two other architectures at full width on the small graph
    gnn_small_phase()

    # 10. flash_attention against its plain version at the serving shapes
    checks["flash_attention"] = flash_attention_phase()
    emit({"phase": "kernel_check", "flash_attention": checks["flash_attention"]})

    # 11. phi4-mini-3.8b serving; launches counted over the kernel serve
    lm_counts = lm_phase()
    for name in ("flash_attention", "flash_decode"):
        launches[name] = lm_counts[name]
    checks["flash_decode"] = checks["flash_attention"]

    # summary lines
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    name, _, power = line.rpartition(",")
    emit({"phase": "device", "nvidia_smi": line, "name": name.strip(),
          "power_limit": power.strip()})
    sources = {"member_probe": ("src/repro_torch/kernels/csrc/member_probe.cu",
                                "src/repro/kernels/member_probe.py:52", "filter_sets"),
               "set_intersect": ("src/repro_torch/kernels/csrc/set_intersect.cu",
                                 "src/repro/kernels/set_intersect.py:34", "ccjoin"),
               "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                               "src/repro/kernels/segment_sum.py:53", "gatedgcn_slice"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:84", "prefill"),
               "flash_decode": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:84", "decode_first")}
    kernels = []
    for name, (src, replaces, case) in sources.items():
        rec = next(r for r in checks[name] if r["case"] == case)
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                        "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                        "library_ms": rec["library_ms"], "case": case})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
