"""Drive the PyTorch/CUDA port of DDSL end to end on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times SRC

Prints one JSON object per line, in phases:

1. ``build``   — compiles ``src/repro_torch/kernels/csrc/*.cu`` (sm_90a).
2. ``kernel_check`` — each kernel against its plain PyTorch version at the
   main path's shapes and at edge cases (exact equality: the data are
   integers), with median times over CUDA events. ``member_probe`` also
   at tables on both sides of its shared-memory limit and of a fence
   stride, with n % 4 != 0 and misaligned query views, each twice
   (bitwise repeatable); its main-path shapes one call at a time and 20 in
   a row, beside ``torch.isin`` on packed keys. ``set_intersect`` on each
   of its paths (a warp a row; a block a row with ``b`` in shared memory,
   ``wide``; past the block's limit in global memory, ``past_shared``) and
   on rows in and out of the layout it searches: widths not a multiple of
   4 and misaligned views, a pad amid the values, pad = 7, INT32_MIN /
   INT32_MAX values, all-pad rows, mixed rows in one launch; each launched
   twice (bitwise equal); ``ccjoin`` and ``zcommon`` one call at a time
   and 20 in a row, beside ``torch.isin`` on row-packed keys computing the
   same function.
3. ``stage1`` / ``batch`` — the main path with the kernels, as the
   streaming service's sharded backend runs it: q1_square on the WT~ graph
   (rmat_graph(12, 10_000, seed=1)) over m = 8 partitions, stage 1 (with
   the cold fill of the unit-table carry) then three 64 + 64 edge batches,
   each a storage update and one carried maintain megastep; time, count
   (each equal to ``WT_COUNTS``), ``unit_refreshes``, overflow and peak
   device memory of each stage. ``profile``: one more batch under
   ``torch.profiler``, with the device seconds of ``member_probe`` and
   ``set_intersect`` summed over their kernels (``named_kernels``) and the
   mean fill of ``set_intersect``'s rows (``set_intersect_fill``); then
   ``ccjoin_fill``, the CC-join's shape at that fill, timed.
   ``small_batches``: three batches of 1 + 1 edges on the same pipeline,
   with the partitions each refreshed out of 8 and their seconds.
   ``storage_full``: the next 64 + 64 batch through the full-gather
   storage update and through the delta update from one state; partitions
   and ``part_dirty`` must be equal; each mode's seconds and peak.
4. ``audit`` — stage 1 listed again from scratch on the final partitions;
   its count and store must equal the maintained ones.
5. ``plain``   — the same path with ``use_kernels=False`` on the card,
   replaying the profiled batch and the small batches; the counts and the
   MatchStore tensors must equal the kernel run's.
6. ``multi`` — q1_square and q2_triangle maintained by one megastep on
   WT~ (``run.WT_MULTI``), stage 1 and three batches with the kernels; the
   q1_square store must equal the single-pattern run's at every stage, and
   ``multi_audit`` lists each pattern from scratch on the final partitions
   (count and store equal to the maintained ones).
7. ``reference`` — the example graph of examples/distributed_listing.py,
   whose host-engine counts are known, checked on the card.
8. The generic-join (WCOJ) executor. ``wcoj_plan`` / ``wcoj``:
   q6_clique5 and q4_clique4 on WT~ at m = 8 (``run.WT_CLIQUE``,
   ``executor="auto"``, which picks the generic join for both, with level
   caps calibrated on the host partitions), stage 1 and three 64 + 64
   batches with the kernels, each stage's counts ``WT_K5_COUNTS`` /
   ``WT_K4_COUNTS``, overflow 0, ``unit_refreshes`` 0, seconds and peak;
   ``member_probe`` and ``set_intersect`` launches on this path.
   ``wcoj_profile``: the next batch (seed 103) under ``torch.profiler``.
   ``wcoj_audit``: both patterns listed from scratch on the final
   partitions, count and store equal to the maintained ones.
   ``wcoj_plain``: the same stages and the profiled batch with
   ``use_kernels=False``, stores equal at every stage; its last batch hands
   the widest level probe (16,384 x 512 queries against one partition's
   edge table) to ``kernel_check`` (``member_probe`` case ``wcoj_level``).
   ``multi_auto``: ``run.WT_MULTI_AUTO``, q1_square on its join tree and
   q2_triangle on the generic join in one megastep, stage 1 and three
   batches: the q1_square store equal to the single run's, the q2_triangle
   counts equal to ``WT_Q2_COUNTS`` and to the tree executor's in
   ``multi``. ``wcoj_vs_tree``: K5 and K4 on the planted near-clique graph
   (m = 1) listed from scratch under each executor, both lossless (the
   tree's match_cap grown 4x from 8,192 and its store groups 2x until
   nothing drops), counts ``PLANTED_COUNTS``, steady-state seconds (median
   of 3 after a warm-up) and their ratio, not gated. Each executor's
   first list + init is a counted run (launches set to 0 just before it
   and read just after: ``planted_k5_wcoj`` ... ``planted_k4_tree`` in
   ``launches_by_path``; ``member_probe`` must launch), and its widest
   edge-table probe goes to ``kernel_check`` (``member_probe`` cases
   ``planted_wcoj`` and ``planted_tree``, 32,768 x 72 queries against the
   24,768-row table).
9. ``kernel_check`` (``segment_sum``) — the segment-sum kernel against its
   plain version on their float64 accumulators, each case through its
   segment plan: one gatedgcn edge slice ([2**24, 70] bf16, ids over
   2,449,029 nodes with 1 % set to n and 0.5 % to -1), the same rows with
   ids sorted over one slice's 332,108 nodes as the forward feeds them,
   and with half of them in one id (``heavy_segment``), the meshgraphnet
   and graphsage widths, a ones column (exact), and edge cases; max
   |kernel - plain| <= 1e-5 * max(1, max |plain|), with the kernel's, the
   plan build's, the plain version's and ``index_add_``'s median ms beside
   the byte bound (data and ids once, the touched float32 rows once);
   under 1 ms also over 20 calls in a row, the card's time alone.
10. ``gnn_plan`` / ``gnn_forward`` — GNN full-graph inference: gatedgcn at
   its full config (16 layers, d_hidden 70, bf16, d_in 100) on the
   ``ogb_products`` shape (2,449,029 nodes, 123,718,280 directed edges,
   ``build_graph_data`` seed 0), once with the kernels (every segment sum
   through the CUDA kernel: 16 layers x 2 sums x 8 edge slices launches)
   and once plain; outputs finite. ``gnn_plan`` also times the forward's
   first step alone: the edge list sorted by destination and its 8 plans
   built (``gnn.sort_edges``), seconds and peak. ``gnn_profile``: one more
   kernel forward under ``torch.profiler``. ``gnn_equal``: max |kernel -
   plain| <= 3e-2 * max |plain|, the share of equal outputs, and the
   largest difference between the two kernel forwards (0: no atomics).
11. ``gnn_small`` — graphsage-reddit (float32, limit 1e-4 * max |plain|)
   and meshgraphnet (bf16, 3e-2) at their full configs on
   ``full_graph_sm`` (2,708 nodes, 21,112 directed edges, d_feat 1,433),
   kernel against plain, after one warm-up forward.
12. ``kernel_check`` (``flash_attention``) — the three attention kernels
   against their plain version at the serving shapes (prefill q [4, 24,
   8192, 128] over k/v [4, 8, 8208, 128] and the second 4,096-token chunk
   at offset 4,096 on the tensor-core kernel; decode at offsets 8,192 and
   8,206 and with command-r's 64 / 8 heads on the split-K decode kernel;
   a Dh 64 bf16 prefill) and at edge cases (float32 and bf16; Dh 8, 20, 64,
   128, 256; MHA; Lq 1; q_offset + Lq = Lk; non-causal; Lk not a multiple
   of the tile; a bf16 Dh 20 must raise), each with the route it took.
   Each output element is held to the plain version on the inputs in
   float32 (see ``attention_limits``): within 1e-5 * sum_j p_j |v_j| in
   float32, and within one bf16 rounding of that in bf16. With the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   median ms beside the bound (and, under 1 ms, the kernel's and SDPA's
   time over 20 calls in a row). ``flash_kernels``: each kernel's
   registers, shared and spill bytes, and the decode grid.
13. ``lm_plan`` / ``lm_serve`` — phi4-mini-3.8b serving at full width
   (32 layers, d_model 3,072, 24/8 heads of 128, d_ff 8,192, vocab
   200,064, bf16, random weights from seed 0) through
   ``repro_torch.launch.serve.serve``: 4 prompts of 8,192 tokens, prefill
   then 15 greedy decode steps, once with the kernels (32 prefill
   launches, every one on the tensor-core kernel, and 480 of the split-K
   decode kernel) and once plain, teacher-forced on the kernel
   run's tokens (0 launches); outputs finite. ``lm_chunked``:
   ``prefill_chunked`` (chunk 4,096, 64 tensor-core launches) on the same
   prompts; its last logits and its cache within 1e-2 * max |unchunked|
   of the unchunked prefill's, and the same first token. ``lm_profile``:
   one more kernel prefill and one decode step under ``torch.profiler``.
   ``lm_equal``: the gate, the same model in float32 (2 prompts of 2,048
   tokens, 8 tokens each; prefill on the CUDA-core kernel), kernel against
   plain within 1e-3 * max |plain| of the logits at every step; and,
   reported, the bf16 run's largest logit difference and its share of
   equal greedy tokens.
14. ``kernel_check`` (``embedding_bag``) — the embedding-bag kernel against
   its plain version on a ``[26,000,000, 64]`` float32 table (the 26
   stacked DLRM tables): ``serve_bulk`` (6,815,744 one-row bags) and
   ``serve_p99`` (13,312) must be equal; ``multi_hot`` (batch 4,096 with
   MLPerf DLRM-DCNv2's per-field bag sizes, 214 rows a sample) within
   n_b * 2**-23 * sum |rows| of the float64 sum, kernel and plain alike;
   edge cases (bf16 within one bf16 rounding more, empty bags, bag ids
   num_bags and -1, a row index V (NaN in its bag only), N = 0 and
   num_bags = 0 without a launch, D = 13, ``mixed_windows``: bags of 0 to
   100 rows sharing and crossing 32-row windows), each launched twice
   (bitwise equal). With the kernel's, the plain version's and
   ``torch.nn.functional.embedding_bag``'s median ms (one call at a time
   and 20 in a row) beside the byte bound; ``serve_bulk_1gib`` times
   serve_bulk's lookups folded into the table's first GiB (a TLB limit
   would show as a gap), with the library call beside it too.
15. ``dlrm_plan`` / ``dlrm_serve`` — dlrm-rm2 serving at its full config
   (26 tables of 1,000,000 x 64, float32, 1,664,762,177 parameters,
   random weights from seed 0; TF32 off) through
   ``repro_torch.launch.serve.serve_recsys``: 8 ``serve_p99`` requests
   of 512, 2 ``serve_bulk`` requests of 262,144 and 2 ``retrieval_cand``
   requests (1 query x 1,000,000 candidates), each shape after one
   warm-up request, once with the kernels (one ``embedding_bag`` launch a
   request: 15) and once plain (0). ``dlrm_equal``: logits of every request within 1e-5 *
   max |plain|, and the embedding outputs (one-row bags) bitwise equal.
   ``dlrm_profile``: three more ``serve_bulk`` forwards under
   ``torch.profiler``, after a warm-up forward.

Then a ``device`` line with the card's name and power limit (the
``nvidia-smi --query-gpu=name,power.limit`` line), the ``kernels``
summary, and last
``{"ok": true, "device": ...}``. Any mismatch, nonzero overflow or
failed phase exits nonzero without that line.

``--kernel-times SRC`` runs none of that: it times the ``member_probe``,
``set_intersect`` and ``embedding_bag`` kernels of the package under
``SRC`` at the main paths' shapes and profiles one DDSL batch, so that two
checkouts (``src`` and, say, a ``git archive`` of another commit unpacked
under ``build/``) are compared in turns on one card in one call.
"""

from __future__ import annotations

import contextlib
import functools
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
# The WT~ q1_square counts after stage 1, each of the N_BATCHES batches and
# the profiled batch, as the per-pattern, carry-free maintain step printed
# them on an H100 (python -m repro_torch.run --batches 4 before the
# megastep): the carried megastep must give the same.
WT_COUNTS = (WT_INITIAL_COUNT, 385_521, 373_667, 365_873, 347_791)
# Small batches after the main ones: 1 deletion + 1 insertion each.
N_SMALL, SMALL_SEED = 3, 500
EXAMPLE_COUNTS = {"q1_square": (1282, 1238, 1128, 1086), "q2_triangle": (188, 182, 172, 168)}
# WT~ counts of the generic-join configurations after stage 1, each of the
# N_BATCHES batches and the profiled batch (64 + 64 edges, seeds 100-103):
# the JAX package's host generic join (repro.core.match_engine
# list_matches_wcoj over the whole graph after each batch) and its host
# DDSL (repro.core.DDSL, m = 8, initial() then apply() per batch) both give
# these on the CPU. WT_Q2_COUNTS is q2_triangle's, which the tree executor
# (WT_MULTI) and the generic join (WT_MULTI_AUTO) must both give.
WT_K5_COUNTS = (13_098, 12_437, 11_386, 11_191, 8_918)
WT_K4_COUNTS = (15_320, 14_817, 14_074, 13_790, 12_341)
WT_Q2_COUNTS = (12_691, 12_474, 12_191, 11_983, 11_544)
# K5 / K4 on the planted near-clique graph (benchmarks/bench_wcoj.py), from
# the host generic join; the tree executor's match_cap starts at 8,192 and
# grows 4x until its listing is lossless, as bench_wcoj.py's does.
PLANTED_COUNTS = {"q6_clique5": 14_785, "q4_clique4": 7_358}
TREE_MATCH_CAP0 = 8192

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
# The DLRM slice: dlrm-rm2 serving (configs/dlrm_rm2.py _FULL, nothing
# cut) at the three RECSYS_SHAPES, requests per shape.
DLRM_ARCH = "dlrm-rm2"
DLRM_REQUESTS = {"serve_p99": 8, "serve_bulk": 2, "retrieval_cand": 2}
DLRM_PROFILED = 3  # serve_bulk forwards under the profiler
# Lookups per field of MLPerf Training DLRM-DCNv2 on multi-hot Criteo
# (214 a sample); the serve path keeps the repo's multi_hot = 1.
MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27, 10, 3,
                   1, 1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int = 10, per: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` CUDA-event timings,
    each around ``per`` calls in a row (divided by ``per``). With ``per =
    1`` the host's work for the call shows in the time where the card
    would idle waiting for it; with more, the calls queue up and only the
    card's time shows."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
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


def sized_table(m: int, n_pad: int, gen) -> torch.Tensor:
    """Exactly ``m`` rows: ``m - n_pad`` unique lex-sorted (hi, lo) pairs
    with hi below 2**20, then the (-1, -1) pads."""
    t = sorted_table(2 * (m - n_pad), 0, 1 << 20, gen)
    keep = torch.randperm(t.shape[0], generator=gen, device="cuda")[:m - n_pad].sort().values
    return torch.cat([t[keep], torch.full((n_pad, 2), -1, dtype=torch.int32, device="cuda")])


def probe_queries(n: int, table: torch.Tensor, hi_max: int, gen) -> torch.Tensor:
    """Queries: half drawn from the table's rows, the rest random or pad."""
    q = torch.randint(-1, hi_max, (n, 2), generator=gen, dtype=torch.int32, device="cuda")
    take = torch.randint(0, table.shape[0], (n // 2,), generator=gen, device="cuda")
    q[: n // 2] = table[take]
    q[::7] = -1
    return q


def padded_sets(g: int, c: int, v_max: int, gen, pad: int = -1, fill=None,
                empty: float = 0.0) -> torch.Tensor:
    """Rows ascending with a pad tail (the CompTensors set layout): a row's
    length uniform in [0, c]; or a share ``empty`` of rows all pad and the
    rest uniform over an interval of lengths from 1 around ``fill / (1 -
    empty)``, for a mean length of about ``fill``."""
    vals = torch.sort(torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32,
                                    device="cuda"), dim=1).values
    lo, hi = 0, c
    if fill is not None:
        t = round(2 * fill / (1.0 - empty)) if empty < 1.0 else 0
        lo = max(min(1, t), t - c)
        hi = min(c, t - lo)
    lens = torch.randint(lo, hi + 1, (g, 1), generator=gen, device="cuda")
    lens[torch.rand((g, 1), generator=gen, device="cuda") < empty] = 0
    vals[torch.arange(c, device="cuda")[None, :] >= lens] = pad
    return vals


def set_rows(g: int, c: int, v_max: int, gen, kinds, pad: int = -1) -> torch.Tensor:
    """``padded_sets`` rows, row ``i`` then turned into ``kinds[i %
    len(kinds)]``: ``layout`` (kept), ``unsorted`` (values in any order,
    a fifth of them pad), ``mid_pad`` (full and ascending but for one pad
    amid the values), ``after_tail`` (a value after the pad tail),
    ``extremes`` (INT32_MIN first and INT32_MAX last), ``all_pad``."""
    vals = padded_sets(g, c, v_max, gen, pad)
    kind = torch.arange(g, device="cuda") % len(kinds)
    pos = torch.arange(c, device="cuda")[None, :]
    full = torch.sort(torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32,
                                    device="cuda"), dim=1).values
    for k, name in enumerate(kinds):
        rows = kind == k
        if name == "unsorted":
            r = torch.randint(0, v_max, (g, c), generator=gen, dtype=torch.int32, device="cuda")
            r[torch.rand((g, c), generator=gen, device="cuda") < 0.2] = pad
        elif name == "mid_pad":
            hole = torch.randint(0, max(1, c - 1), (g, 1), generator=gen, device="cuda")
            r = torch.where(pos == hole, pad, full)
        elif name == "after_tail":
            r = torch.where(pos >= c // 2, pad, full)
            r[:, -1] = 0
        elif name == "extremes":
            r = full.clone()
            r[:, 0], r[:, -1] = -2**31, 2**31 - 1
        elif name == "all_pad":
            r = torch.full_like(full, pad)
        else:
            continue
        vals[rows] = r[rows]
    return vals


def drawn_from(a: torch.Tensor, b: torch.Tensor, share: float, gen) -> torch.Tensor:
    """``a`` with about ``share`` of its values replaced by values of its
    own row of ``b`` (so that many are found)."""
    g, ca = a.shape
    idx = torch.randint(0, b.shape[1], (g, ca), generator=gen, device="cuda")
    take = torch.rand((g, ca), generator=gen, device="cuda") < share
    return torch.where(take, b.gather(1, idx), a)


def set_library(a: torch.Tensor, b: torch.Tensor, pad: int):
    """One ``torch.isin`` over row-packed int64 keys (row * 2**32 + value)
    computing the kernel's function: ``b``'s pads become a key that no
    ``a`` value can take, and ``a``'s pads are masked out."""
    g = a.shape[0]
    rows = torch.arange(g, device="cuda", dtype=torch.int64)[:, None] * (1 << 32)
    ak = (rows + a.to(torch.int64)).reshape(-1)
    bk = torch.where(b == pad, -(1 << 62), rows + b.to(torch.int64)).reshape(-1)
    live = a != pad
    return lambda: torch.isin(ak, bk).view(a.shape) & live


def probe_library(q_hi, q_lo, t_hi, t_lo):
    """One ``torch.isin`` over packed int64 keys (hi * 2**32 + lo)
    computing the probe's function: the table's (-1, -1) pads are left out
    of its keys and (-1, -1) queries masked out."""
    qk = q_hi.to(torch.int64) * (1 << 32) + q_lo.to(torch.int64)
    keep = (t_hi != -1) | (t_lo != -1)
    tk = (t_hi.to(torch.int64) * (1 << 32) + t_lo.to(torch.int64))[keep]
    live = (q_hi != -1) | (q_lo != -1)
    return lambda: torch.isin(qk, tk) & live


def kernel_phase(pipe_shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.member_probe import member_probe_cuda, probe_stride
    from repro_torch.kernels.set_intersect import set_intersect_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    caps, ush, store = pipe_shapes
    results = {}

    # --- member_probe: every call shape of the main path ----------------
    cedge = ush["cedge_cap"]
    drop = sorted_table(cedge, 64, 4096, gen)
    dele = sorted_table(64, 0, 4096, gen)
    # (queries, table, offset of the query lanes into their buffers)
    cases = {
        # patch_partition: candidate rows × (candidate ∪ deleted) edges
        "patch_rows": (ush["cand_cap"] * caps["deg_cap"], drop, 0),
        # patch_partition: stored edge list × the same drop table
        "patch_edges": (caps["e_cap"], drop, 0),
        # filter_deleted_dev: store set values × the delete table
        "filter_sets": (store["group_cap"] * store["set_cap"], dele, 0),
        # edge cases: one-row table, all-pad table
        "tiny": (1000, sorted_table(1, 0, 4096, gen), 0),
        "all_pad": (1000, torch.full((5, 2), -1, dtype=torch.int32, device="cuda"), 0),
        # tables on both sides of the kernel's shared-memory table (8,192
        # rows) and at a fence stride's edges (ceil(m / s) = 8,192 fences
        # at s = 4, one row more takes s = 8); n % 4 != 0; query lanes that
        # are offset views (not 16-byte aligned), as engine.edge_probe's
        # reshapes can pass
        "smem_8191": (100_003, sized_table(8191, 0, gen), 0),
        "smem_8192": (100_002, sized_table(8192, 2, gen), 1),
        "smem_8193": (100_001, sized_table(8193, 0, gen), 3),
        "fences_32768": (100_000, sized_table(32_768, 0, gen), 2),
        "fences_32769": (99_999, sized_table(32_769, 1, gen), 0),
        "patch_rows_views": (ush["cand_cap"] * caps["deg_cap"] - 3, drop, 1),
    }
    mp = []
    for name, (n, tbl, offset) in cases.items():
        q = probe_queries(n, tbl, 1 << 20 if name.startswith(("smem", "fences")) else 4096, gen)
        qh, ql = (torch.full((n + offset,), -3, dtype=torch.int32, device="cuda")
                  for _ in range(2))
        qh[offset:], ql[offset:] = q[:, 0], q[:, 1]
        args = (qh[offset:], ql[offset:], tbl[:, 0].contiguous(), tbl[:, 1].contiguous())
        got = member_probe_cuda(*args)
        want = ref.member_probe_ref(*args)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        check(err == 0, f"member_probe {name}: {err} mismatches")
        check(torch.equal(got, member_probe_cuda(*args)), f"member_probe {name}: not repeatable")
        m_rows = tbl.shape[0]
        rec = {"case": name, "n": n, "m": m_rows, "stride": probe_stride(m_rows, n),
               "offset": offset, "equal": True, "max_abs_err": max_abs_err(got, want)}
        if name in ("patch_rows", "patch_edges", "filter_sets", "tiny", "all_pad"):
            # one call at a time, and the card's time alone (20 in a row)
            rec["ms"] = cuda_ms(lambda: member_probe_cuda(*args))
            rec["ms_back_to_back"] = cuda_ms(lambda: member_probe_cuda(*args), per=20)
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                9.0 * n + 8.0 * m_rows, n * math.ceil(math.log2(m_rows + 1)))
        if "ms" in rec:
            rec["plain_ms"] = cuda_ms(lambda: ref.member_probe_ref(*args), reps=3)
            lib = probe_library(*args)
            rec["library_equal"] = torch.equal(lib(), want)
            rec["library_ms"] = cuda_ms(lib, reps=3)
            if name != "filter_sets":
                rec["library_ms_back_to_back"] = cuda_ms(lib, per=20)
            del lib
        mp.append(rec)
        del q, qh, ql, args, got, want
    # empty query / empty table: answered without a launch
    e = torch.empty(0, dtype=torch.int32, device="cuda")
    one = torch.zeros(3, dtype=torch.int32, device="cuda")
    before = member_probe_cuda.launches
    check(member_probe_cuda(e, e, one, one).numel() == 0, "member_probe N=0")
    check(not member_probe_cuda(one, one, e, e).any(), "member_probe M=0")
    check(member_probe_cuda.launches == before, "member_probe launched for an empty input")
    results["member_probe"] = mp
    torch.cuda.empty_cache()

    # --- set_intersect ---------------------------------------------------
    G, S, D = caps["group_cap"], caps["set_cap"], caps["deg_cap"]
    results["set_intersect"] = [set_intersect_case(name, *args, gen=gen) for name, args in {
        # the main path's two calls: the CC-join and the common-neighbour test
        "ccjoin": (G, S, S, ("padded",)),
        "zcommon": (cedge, D, D, ("padded",)),
        # b wider than a warp's shared memory (a block a row), and past the
        # block's shared-memory limit (searched in global memory); rows in and
        # out of layout
        "wide": (3, 5000, 9000, ("unsorted", "layout", "mid_pad")),
        "past_shared": (3, 5000, 60_000, ("layout", "unsorted", "after_tail")),
        # duplicates and unsorted rows, widths 1 and 3
        "narrow": (7, 1, 3, ("narrow",)),
        # widths not a multiple of 4; views 1 and 3 values into a buffer
        "odd_widths": (1000, 511, 509, ("layout",)),
        "misaligned": (1000, 512, 512, ("layout",), -1, (1, 3)),
        # a pad amid the values or a value after the tail; pad = 7 amid the
        # values; INT32_MIN / INT32_MAX values
        "mid_pad": (2000, 300, 300, ("mid_pad", "after_tail", "layout")),
        "pad_7": (2000, 64, 64, ("layout", "mid_pad", "unsorted"), 7),
        "extremes": (2000, 64, 64, ("extremes", "layout")),
        # rows in and out of layout and all-pad rows in one launch
        "mixed": (4000, 512, 512, ("layout", "unsorted", "layout", "all_pad", "mid_pad")),
    }.items()]
    empty = torch.empty((0, 4), dtype=torch.int32, device="cuda")
    check(set_intersect_cuda(empty, empty, -1).shape == (0, 4), "set_intersect G=0")
    return results


def set_intersect_case(name, g, ca, cb, kinds, pad=-1, offsets=(0, 0), fill=None, gen=None):
    """One set_intersect case: the kernel twice (bitwise equal) against its
    plain version, on ``b`` rows of ``kinds`` and ``a`` rows in layout with
    a third of their values drawn from their ``b`` row (``padded``: both
    ``padded_sets`` drawn apart; ``fill``: the mean lengths of ``a`` and
    ``b`` and the share of all-pad ``a`` rows, where given;
    ``narrow``: values in [-1, 3)); at 2**20 values of ``a`` or more, timed
    one call at a time and 20 in a row, beside the plain version, the
    library call and the byte bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.set_intersect import set_intersect_cuda, set_intersect_route

    if kinds == ("narrow",):
        a, b = (torch.randint(-1, 3, (g, c), generator=gen, dtype=torch.int32, device="cuda")
                for c in (ca, cb))
    elif kinds == ("padded",):
        fa, fb, empty = fill or (None, None, 0.0)
        a = padded_sets(g, ca, 4096, gen, pad, fa, empty)
        b = padded_sets(g, cb, 4096, gen, pad, fb)
    else:
        v_max = 4096 if max(ca, cb) <= 512 else 4 * cb
        b = set_rows(g, cb, v_max, gen, kinds, pad)
        a = drawn_from(set_rows(g, ca, v_max, gen, ("layout",), pad), b, 1 / 3, gen)
    if offsets != (0, 0):   # contiguous views that are not 16-byte aligned
        views = []
        for t, off in zip((a, b), offsets):
            buf = torch.full((t.numel() + off,), pad, dtype=torch.int32, device="cuda")
            buf[off:] = t.reshape(-1)
            views.append(buf[off:].view(t.shape))
        a, b = views
    got = set_intersect_cuda(a, b, pad)
    again = set_intersect_cuda(a, b, pad)
    want = ref.set_intersect_ref(a, b, pad)
    torch.cuda.synchronize()
    err = int((got != want).sum())
    check(err == 0, f"set_intersect {name}: {err} mismatches")
    check(torch.equal(got, again), f"set_intersect {name}: two launches differ")
    rec = {"case": name, "g": g, "ca": ca, "cb": cb, "pad": pad, "offsets": list(offsets),
           "route": set_intersect_route(cb, a.device), "equal": True, "repeat_equal": True,
           "max_abs_err": max_abs_err(got, want), "hits": int(want.sum()),
           "mean_nonpad_a": float((a != pad).sum()) / g,
           "mean_nonpad_b": float((b != pad).sum()) / g}
    if g * ca >= 1 << 20:
        rec["ms"] = cuda_ms(lambda: set_intersect_cuda(a, b, pad))
        rec["ms_back_to_back"] = cuda_ms(lambda: set_intersect_cuda(a, b, pad), per=20)
        rec["plain_ms"] = cuda_ms(lambda: ref.set_intersect_ref(a, b, pad), reps=3)
        lib = set_library(a, b, pad)
        rec["library_equal"] = torch.equal(lib(), want)
        check(rec["library_equal"], f"set_intersect {name}: the library call differs")
        rec["library_ms"] = cuda_ms(lib, reps=3)
        rec["bound_ms"], rec["bound_by"] = bound_ms(4.0 * g * (ca + cb) + g * ca, g * (ca + cb))
    del a, b, got, again, want
    torch.cuda.empty_cache()
    return rec


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


def timed_stage(fn):
    """``fn()`` timed on the host clock ending in a synchronize, with the
    peak device memory it reached: ``(result, seconds, peak_gib)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30


def small_batches(pipe, label: str):
    """N_SMALL batches of 1 + 1 edges on the pipeline's current state, each
    with the partitions whose unit tables it listed again out of ``m``;
    returns their records and store snapshots."""
    from repro_torch.data.graphs import sample_update

    recs, snaps = [], []
    for i in range(N_SMALL):
        upd = sample_update(pipe.graph, 1, 1, seed=SMALL_SEED + i)
        d, seconds, peak = timed_stage(lambda: {k: int(v) for k, v in pipe.apply(upd).items()})
        rec = {"phase": "small_batches", "run": label, "batch": i, **d,
               "partitions": pipe.config.m, "seconds": seconds, "peak_gib": peak}
        check(rec["overflow"] == 0, f"overflow in {rec}")
        emit(rec)
        recs.append(rec)
        snaps.append(store_snapshot(pipe.store))
    return recs, snaps


def storage_full_phase(pipe) -> None:
    """The pipeline's next 64 + 64 batch through the delta storage update
    and through the full-gather rebuild, from the same partitions (the
    pipeline itself is left as it is): equal partitions and ``part_dirty``,
    each mode's seconds, peak, resident GiB before it and
    ``set_intersect`` launches."""
    from repro_torch import sharded
    from repro_torch.kernels.set_intersect import set_intersect_cuda

    upd = pipe.next_update()
    add = torch.from_numpy(upd.add.astype("int32").reshape(-1, 2)).cuda()
    dele = torch.from_numpy(upd.delete.astype("int32").reshape(-1, 2)).cuda()
    out, rec = {}, {"phase": "storage_full", "n_add": add.shape[0], "n_del": dele.shape[0]}
    for mode in ("delta", "full"):
        step = sharded.make_storage_update_step(pipe.mesh, pipe.caps, pipe.ushapes, mode=mode)
        resident = torch.cuda.memory_allocated() / 2**30
        before = set_intersect_cuda.launches
        out[mode], seconds, peak = timed_stage(lambda: step(pipe.pt, add, dele))
        rec[mode] = {"seconds": seconds, "peak_gib": peak, "resident_gib": resident,
                     "set_intersect_launches": set_intersect_cuda.launches - before,
                     "overflow": int(out[mode][1]["overflow"]),
                     "stored_edges": int(out[mode][1]["stored_edges"]),
                     "dirty": int(out[mode][1]["part_dirty"].sum())}
    (pd, dd), (pf, df) = out["delta"], out["full"]
    rec["equal"] = all(torch.equal(getattr(pd, f), getattr(pf, f))
                       for f in ("vertices", "center", "deg", "adj", "edge_hi", "edge_lo"))
    rec["part_dirty_equal"] = torch.equal(dd["part_dirty"], df["part_dirty"])
    emit(rec)
    check(rec["equal"] and rec["part_dirty_equal"], "storage_full: full and delta partitions differ")
    check(rec["full"]["overflow"] == rec["delta"]["overflow"] == 0, "storage_full: overflow")
    check(rec["full"]["stored_edges"] == rec["delta"]["stored_edges"], "storage_full: edges")
    del out, pd, pf
    torch.cuda.empty_cache()


def multi_phase(single_snaps):
    """q1_square and q2_triangle in one megastep on WT~ (stage 1 and
    N_BATCHES batches with the kernels): the q1_square counts and store
    snapshots must equal the single-pattern run's at every stage, the
    q2_triangle counts ``WT_Q2_COUNTS``; then each pattern is listed from
    scratch on the final partitions and must equal its maintained count
    and store. Returns the q2_triangle count of each stage."""
    from repro_torch.run import WT_MULTI, Pipeline, stages

    pipe, setup_s, _ = timed_stage(lambda: Pipeline(WT_MULTI, "cuda"))
    emit({"phase": "plan", "run": "multi", "setup_seconds": setup_s, **pipe.describe()})
    q2_counts = []
    for i, d in enumerate(stages(pipe, N_BATCHES)):
        emit({**d, "stage": d["phase"], "phase": "multi"})
        check(d["overflow"] == 0, f"multi: overflow in {d}")
        q1 = d["patterns"]["q1_square"]
        check(q1["count"] == WT_COUNTS[i], f"multi: q1_square count {q1['count']} at stage {i}")
        check(snapshots_equal(store_snapshot(pipe.stores["q1_square"]), single_snaps[i]),
              f"multi: q1_square store differs from the single-pattern run at stage {i}")
        q2_counts.append(d["patterns"]["q2_triangle"]["count"])
        check(q2_counts[-1] == WT_Q2_COUNTS[i],
              f"multi: q2_triangle count {q2_counts[-1]} at stage {i} != {WT_Q2_COUNTS[i]}")
    final = {name: (pd["count"], store_snapshot(pipe.stores[name]))
             for name, pd in d["patterns"].items()}
    pipe.stores = pipe.carries = None
    torch.cuda.empty_cache()
    for name, (count, snap) in final.items():
        (astore, adiag), seconds, peak = timed_stage(lambda: pipe.list_pattern(name))
        audit = {k: int(v) for k, v in adiag.items()}
        emit({"phase": "multi_audit", "pattern": name, **audit, "maintained": count,
              "seconds": seconds, "peak_gib": peak})
        check(audit["overflow"] == 0 and audit["count"] == count,
              f"multi_audit {name}: count differs from the maintained count")
        check(snapshots_equal(store_snapshot(astore), snap),
              f"multi_audit {name}: store differs from the maintained store")
        del astore
        torch.cuda.empty_cache()
    del pipe
    torch.cuda.empty_cache()
    return q2_counts


# ---------------------------------------------------------------------------
# The generic-join (WCOJ) executor
# ---------------------------------------------------------------------------

WCOJ_COUNTS = {"q6_clique5": WT_K5_COUNTS, "q4_clique4": WT_K4_COUNTS}


def snapshots(pipe):
    return {name: store_snapshot(st) for name, st in pipe.stores.items()}


def as_ints(d):
    return {k: as_ints(v) if isinstance(v, dict) else int(v) for k, v in d.items()}


def drive_wcoj(config, use_kernels: bool, label: str):
    """Stage 1 + N_BATCHES batches of ``config`` (WT~, q6_clique5 and
    q4_clique4 by the generic join) through ``repro_torch.run.stages``:
    every stage's counts ``WCOJ_COUNTS``, overflow 0 and ``unit_refreshes``
    0. Returns (records, per-pattern store snapshots, pipeline)."""
    from repro_torch.run import Pipeline, stages

    pipe, setup_s, _ = timed_stage(lambda: Pipeline(config, "cuda", use_kernels=use_kernels))
    emit({"phase": "wcoj_plan", "run": label, "setup_seconds": setup_s, **pipe.describe()})
    for name, pp in pipe.plans.items():
        check(pp.executor == "wcoj", f"wcoj_plan: {name} is not on the generic join")
    recs, snaps = [], []
    for i, d in enumerate(stages(pipe, N_BATCHES)):
        d.update(stage=d["phase"], phase="wcoj", run=label)
        emit(d)
        check(d["overflow"] == 0, f"wcoj {label}: overflow in {d}")
        for name, want in WCOJ_COUNTS.items():
            pd = d["patterns"][name]
            check(pd["count"] == want[i], f"wcoj {label}: {name} count {pd['count']} at "
                  f"stage {i} != {want[i]}")
            check(i == 0 or pd["unit_refreshes"] == 0, f"wcoj {label}: {name} refreshed")
        recs.append(d)
        snaps.append(snapshots(pipe))
    return recs, snaps, pipe


def wcoj_profile(pipe):
    """The next batch (seed 103) under ``torch.profiler``: device time by
    kernel, ``member_probe``'s seconds and launches, the idle share; counts
    the last of ``WCOJ_COUNTS``."""
    upd = pipe.next_update()
    d, prof = profiled(lambda: as_ints(pipe.apply(upd)), DDSL_KERNELS)
    emit({"phase": "wcoj_profile", "update_seed": pipe.config.update_seed + pipe.batches - 1,
          **d, **prof})
    check(d["overflow"] == 0, f"wcoj_profile: overflow in {d}")
    for name, want in WCOJ_COUNTS.items():
        check(d["patterns"][name]["count"] == want[-1],
              f"wcoj_profile: {name} count {d['patterns'][name]['count']} != {want[-1]}")
    return d


@contextlib.contextmanager
def probe_spy(e_cap: int):
    """Wraps ``ops.member_probe`` while the block runs; the dict it yields
    gets a copy of the inputs of the widest call against a partition's edge
    table (``e_cap`` rows): the largest level of the generic join, the
    ``[level_caps[i-1] x deg_cap]`` queries, or a join tree's largest edge
    check. (The storage update's probes go against its drop table, the
    delete filter's against the delete table.) The calls go on to the
    kernel and count as the path's launches."""
    from repro_torch.kernels import ops

    inner, widest = ops.member_probe, {}

    def spy(q_hi, q_lo, t_hi, t_lo, *, use_kernels):
        if t_hi.shape[0] == e_cap and q_hi.numel() > widest.get("n", -1):
            widest.update(n=q_hi.numel(), args=tuple(t.clone() for t in (q_hi, q_lo, t_hi, t_lo)))
        return inner(q_hi, q_lo, t_hi, t_lo, use_kernels=use_kernels)

    ops.member_probe = spy
    try:
        yield widest
    finally:
        ops.member_probe = inner


def widest_probe(pipe):
    """The next batch under :func:`probe_spy`: its diag and the inputs of
    its widest level probe."""
    upd = pipe.next_update()
    with probe_spy(pipe.caps.e_cap) as widest:
        d = pipe.apply(upd)
    return d, widest["args"]


def level_probe_case(case: str, args, **launches):
    """``member_probe`` on the inputs of a call the main path made (a
    level or edge-check probe against one partition's edge table): against
    its plain version, timed one call at a time and 20 in a row, beside
    ``torch.isin`` on packed keys and the byte bound; ``launches`` are the
    kernel's launches on the paths that make such calls."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.member_probe import member_probe_cuda, probe_stride

    q_hi, q_lo, t_hi, t_lo = args
    n, m_rows = q_hi.shape[0], t_hi.shape[0]
    got = member_probe_cuda(*args)
    want = ref.member_probe_ref(*args)
    torch.cuda.synchronize()
    err = int((got != want).sum())
    check(err == 0, f"member_probe {case}: {err} mismatches")
    check(torch.equal(got, member_probe_cuda(*args)), f"member_probe {case}: not repeatable")
    lib = probe_library(*args)
    rec = {"case": case, "n": n, "m": m_rows, "stride": probe_stride(m_rows, n),
           "offset": 0, "equal": True, "max_abs_err": max_abs_err(got, want),
           "live_queries": int(((q_hi != -1) | (q_lo != -1)).sum()),
           "table_rows": int(((t_hi != -1) | (t_lo != -1)).sum()), "hits": int(want.sum()),
           "ms": cuda_ms(lambda: member_probe_cuda(*args)),
           "ms_back_to_back": cuda_ms(lambda: member_probe_cuda(*args), per=20),
           "plain_ms": cuda_ms(lambda: ref.member_probe_ref(*args), reps=3),
           "library_equal": torch.equal(lib(), want), "library_ms": cuda_ms(lib, reps=3),
           "library_ms_back_to_back": cuda_ms(lib, per=20), **launches}
    rec["bound_ms"], rec["bound_by"] = bound_ms(9.0 * n + 8.0 * m_rows,
                                                n * math.ceil(math.log2(m_rows + 1)))
    check(rec["library_equal"], f"member_probe {case}: the library call differs")
    return rec


def wcoj_phase(single_snaps, multi_q2_counts):
    """The generic-join executor on WT~ (``wcoj_plan``, ``wcoj``,
    ``wcoj_profile``, ``wcoj_audit``, ``wcoj_plain``, ``multi_auto``).
    Returns the DDSL kernels' launches on the WCOJ path and on the mixed
    path, and the ``wcoj_level`` kernel case."""
    from repro_torch.kernels import ops
    from repro_torch.run import WT_CLIQUE

    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    recs_k, snaps_k, pipe = drive_wcoj(WT_CLIQUE, True, "kernels")
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the WCOJ path")
    final = wcoj_profile(pipe)
    final_snaps = snapshots(pipe)
    emit({"phase": "wcoj", "run": "kernels", "launches": launches,
          "seconds": time.perf_counter() - t_phase})

    # audit: list both patterns from scratch on the final partitions
    t0 = time.perf_counter()
    pipe.stores = pipe.carries = None
    torch.cuda.empty_cache()
    for name in WCOJ_COUNTS:
        (astore, adiag), seconds, peak = timed_stage(lambda: pipe.list_pattern(name))
        audit = {k: int(v) for k, v in adiag.items()}
        maintained = final["patterns"][name]["count"]
        emit({"phase": "wcoj_audit", "pattern": name, **audit, "maintained": maintained,
              "seconds": seconds, "peak_gib": peak})
        check(audit["overflow"] == 0 and audit["count"] == maintained,
              f"wcoj_audit {name}: count differs from the maintained count")
        check(snapshots_equal(store_snapshot(astore), final_snaps[name]),
              f"wcoj_audit {name}: store differs from the maintained store")
        del astore
    del pipe
    torch.cuda.empty_cache()
    emit({"phase": "wcoj_audit", "seconds": time.perf_counter() - t0})

    # the plain path on the card: the same counts and store tensors at every
    # stage; its profiled batch also hands over the widest level probe
    t0 = time.perf_counter()
    recs_p, snaps_p, pipe = drive_wcoj(WT_CLIQUE, False, "plain")
    for i, (a, b) in enumerate(zip(snaps_k, snaps_p)):
        for name in WCOJ_COUNTS:
            check(snapshots_equal(a[name], b[name]), f"wcoj_plain: {name} store differs at "
                  f"stage {i}")
    d, probe_args = widest_probe(pipe)
    for name in WCOJ_COUNTS:
        check(int(d["patterns"][name]["count"]) == final["patterns"][name]["count"],
              f"wcoj_plain: {name} profiled-batch count differs")
        check(snapshots_equal(store_snapshot(pipe.stores[name]), final_snaps[name]),
              f"wcoj_plain: {name} profiled-batch store differs")
    del pipe
    torch.cuda.empty_cache()
    emit({"phase": "wcoj_plain", "equal": True, "steps": len(recs_p) + 1,
          "seconds": time.perf_counter() - t0})
    case = level_probe_case("wcoj_level", probe_args, launches_wcoj=launches["member_probe"])
    del probe_args
    emit({"phase": "kernel_check", "member_probe": [case]})
    torch.cuda.empty_cache()
    return launches, multi_auto_phase(single_snaps, multi_q2_counts), case


def multi_auto_phase(single_snaps, multi_q2_counts):
    """``WT_MULTI_AUTO``: q1_square on its join tree and q2_triangle on the
    generic join in one megastep, stage 1 and N_BATCHES batches with the
    kernels. At every stage the q1_square store must equal the
    single-pattern run's, and the q2_triangle counts ``WT_Q2_COUNTS`` and
    the tree executor's counts in the ``multi`` phase. Returns the DDSL
    kernels' launches on this path."""
    from repro_torch.kernels import ops
    from repro_torch.run import WT_MULTI_AUTO, Pipeline, stages

    t_phase = time.perf_counter()
    pipe, setup_s, _ = timed_stage(lambda: Pipeline(WT_MULTI_AUTO, "cuda"))
    emit({"phase": "plan", "run": "multi_auto", "setup_seconds": setup_s, **pipe.describe()})
    check(pipe.plans["q1_square"].executor == "tree"
          and pipe.plans["q2_triangle"].executor == "wcoj",
          "multi_auto: expected q1_square on the tree and q2_triangle on the generic join")
    ops.reset_launch_counts()
    for i, d in enumerate(stages(pipe, N_BATCHES)):
        emit({**d, "stage": d["phase"], "phase": "multi_auto"})
        check(d["overflow"] == 0, f"multi_auto: overflow in {d}")
        q1, q2 = d["patterns"]["q1_square"], d["patterns"]["q2_triangle"]
        check(q1["count"] == WT_COUNTS[i], f"multi_auto: q1_square count {q1['count']}")
        check(snapshots_equal(store_snapshot(pipe.stores["q1_square"]), single_snaps[i]),
              f"multi_auto: q1_square store differs from the single-pattern run at stage {i}")
        check(q2["count"] == WT_Q2_COUNTS[i] == multi_q2_counts[i],
              f"multi_auto: q2_triangle count {q2['count']} at stage {i}: tree "
              f"{multi_q2_counts[i]}, host {WT_Q2_COUNTS[i]}")
        check(i == 0 or q2["unit_refreshes"] == 0, "multi_auto: the WCOJ slot refreshed")
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    for k in DDSL_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the mixed path")
    emit({"phase": "multi_auto", "launches": launches, "q2_tree_counts": multi_q2_counts,
          "seconds": time.perf_counter() - t_phase})
    pipe.stores = pipe.carries = None
    del pipe
    torch.cuda.empty_cache()
    return launches


def steady(fn, reps: int = 3):
    """``fn()`` once to warm up, then ``reps`` timed runs (host clock
    ending in a synchronize): (last result, median seconds, all seconds,
    peak GiB)."""
    fn()
    times, peak, result = [], 0.0, None
    for _ in range(reps):
        result, seconds, pk = timed_stage(fn)
        times.append(seconds)
        peak = max(peak, pk)
    return result, statistics.median(times), times, peak


def device_split(fn):
    """One more ``fn()`` under the profiler: its device seconds, kernel
    count and the idle share of its device span."""
    _, prof = profiled(fn)
    return {"device_s": prof["device_s"], "kernels": prof["device_events"],
            "span_idle_share": prof["span_idle_share"]}


def counted_run(fn, e_cap: int, path: str):
    """One run of ``fn()`` with the launch counts set to 0 just before it
    and read just after, under :func:`probe_spy`: (result, the DDSL
    kernels' launches in the run, the inputs of its widest edge-table
    probe). ``member_probe`` must have launched."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    with probe_spy(e_cap) as widest:
        result = fn()
    torch.cuda.synchronize()
    launches = {k: ops.launch_counts()[k] for k in DDSL_KERNELS}
    check(launches["member_probe"] > 0, f"member_probe never launched on {path}")
    return result, launches, widest["args"]


def wcoj_vs_tree_phase():
    """K5 and K4 on the planted near-clique graph at m = 1, listed from
    scratch (list + init store, ``Pipeline.list_pattern``) under each
    executor, both lossless: the generic join with its calibrated caps; the
    join tree with match_cap from TREE_MATCH_CAP0 up 4x until its listing
    drops nothing, and its store groups doubled until its store does (the
    steps are rebuilt at each cap, as bench_wcoj.py's protocol does, and
    the lossless pair is put into the pipeline's plan). Both must give
    ``PLANTED_COUNTS``. Each executor's first run after planning is the
    counted run (launches set to 0 just before it, read just after, its
    widest level or edge-check probe kept); then the steady-state seconds
    (median of 3 after a warm-up) and their ratio are reported, not gated,
    with one more run of each under the profiler (device seconds, kernels,
    idle share). These listings make no ``set_intersect`` call (the
    generic join intersects by edge probes; the planted trees at m = 1
    check edges by probes and join no compressed sets), so only
    ``member_probe`` must launch; both counts are reported. Returns the
    launches by path and the ``member_probe`` cases at the widest probe of
    each executor."""
    import dataclasses

    from repro_torch import sharded
    from repro_torch.planner.sizing import StoreCaps, quantize_store_caps
    from repro_torch.run import PLANTED_K4, PLANTED_K5, Pipeline

    by_path, widest = {}, {}
    for cfg in (PLANTED_K5, PLANTED_K4):
        t_phase = time.perf_counter()
        name, want = cfg.pattern, PLANTED_COUNTS[cfg.pattern]
        path = f"planted_k{name[-1]}"
        pipe = Pipeline(cfg, "cuda")
        p = pipe.plans[name]
        check(p.executor == "wcoj", f"wcoj_vs_tree: {name} is not on the generic join")
        (_, wd0), launches, args = counted_run(lambda: pipe.list_pattern(name),
                                               pipe.caps.e_cap, f"{path}_wcoj")
        by_path[f"{path}_wcoj"] = launches
        if args[0].numel() > widest.get("wcoj", args)[0].numel() or "wcoj" not in widest:
            widest["wcoj"] = args
        (wst, wd), w_s, w_runs, w_peak = steady(lambda: pipe.list_pattern(name))
        wcoj = {"s": w_s, "runs": w_runs, "peak_gib": w_peak, "count": int(wd["count"]),
                "overflow": int(wd["overflow"]), "first_count": int(wd0["count"]),
                "level_caps": list(p.level_caps), "store_caps": dataclasses.asdict(p.store_caps),
                "launches": launches, "widest_probe": int(args[0].numel()),
                **device_split(lambda: pipe.list_pattern(name))}
        del pipe, wst, args
        torch.cuda.empty_cache()

        pipe = Pipeline(dataclasses.replace(cfg, executor="tree"), "cuda")
        p = pipe.plans[name]
        mc, store_g, tries = TREE_MATCH_CAP0, p.store_caps.group_cap, []
        while True:
            check(mc <= 1 << 22, f"wcoj_vs_tree: {name} tree caps past 4M rows")
            caps = dataclasses.replace(pipe.caps, match_cap=mc,
                                       group_cap=max(pipe.caps.group_cap, mc))
            lstep = sharded.make_list_step(p.prog, pipe.mesh, caps)
            out, ld = lstep(pipe.pt)
            if int(ld["overflow"]):
                tries.append({"match_cap": mc, "list_overflow": int(ld["overflow"])})
                mc *= 4
                continue
            scaps = quantize_store_caps(StoreCaps(store_g, p.store_caps.set_cap))
            istep = sharded.make_init_store_step(p.prog, pipe.mesh, caps, scaps)
            _, idiag = istep(out)
            if int(idiag["overflow"]):
                tries.append({"match_cap": mc, "store_group_cap": scaps.group_cap,
                              "store_overflow": int(idiag["overflow"])})
                store_g *= 2
                continue
            break
        del out
        pipe.plans[name] = dataclasses.replace(p, list_step=lstep, init_step=istep,
                                               store_caps=scaps)
        torch.cuda.empty_cache()
        (_, td0), launches, args = counted_run(lambda: pipe.list_pattern(name),
                                               pipe.caps.e_cap, f"{path}_tree")
        by_path[f"{path}_tree"] = launches
        if args[0].numel() > widest.get("tree", args)[0].numel() or "tree" not in widest:
            widest["tree"] = args
        (tst, td), t_s, t_runs, t_peak = steady(lambda: pipe.list_pattern(name))
        tree = {"s": t_s, "runs": t_runs, "peak_gib": t_peak, "count": int(td["count"]),
                "overflow": int(td["overflow"]), "first_count": int(td0["count"]),
                "match_cap": mc, "store_caps": dataclasses.asdict(scaps), "escalations": tries,
                "launches": launches, "widest_probe": int(args[0].numel()),
                **device_split(lambda: pipe.list_pattern(name))}
        del pipe, tst, lstep, istep, args
        torch.cuda.empty_cache()
        emit({"phase": "wcoj_vs_tree", "pattern": name, "graph": "planted", "m": cfg.m,
              "wcoj": wcoj, "tree": tree, "tree_over_wcoj": t_s / w_s,
              "seconds": time.perf_counter() - t_phase})
        for label, r in (("wcoj", wcoj), ("tree", tree)):
            check(r["overflow"] == 0 and r["count"] == r["first_count"] == want,
                  f"wcoj_vs_tree: {name} {label} count {r['count']} (overflow "
                  f"{r['overflow']}) != {want}")
    cases = [level_probe_case(f"planted_{label}", widest[label], **{
        f"launches_{path}": n["member_probe"] for path, n in by_path.items()
        if path.endswith(label)}) for label in ("wcoj", "tree")]
    del widest
    torch.cuda.empty_cache()
    emit({"phase": "kernel_check", "member_probe": cases})
    return by_path, cases


def profiled(fn, kernels=()):
    """``fn()`` under ``torch.profiler``: its result, and wall time, summed
    device time of its kernels, idle share, the kernels that took most of
    it and, for each name in ``kernels``, the device seconds and launches
    of every kernel whose name contains it."""
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
    # device time of the kernels each host op launched itself (a kernel
    # launched outside any op, as the port's are, is in "top" only)
    by_op = sorted(((e.key, e.self_device_time_total / 1e6, e.count) for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                   key=lambda r: -r[1])[:12]
    # the device timeline: the profiler may miss the first kernels after it
    # starts, so the kernel count and the span show what it saw
    kern = [(e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    span = (max(a + d for a, d in kern) - min(a for a, _ in kern)) / 1e9 if kern else 0.0
    named = {k: {"s": sum(t for key, t, _ in dev if k in key),
                 "calls": sum(c for key, _, c in dev if k in key)} for k in kernels}
    return result, {"wall_s": wall, "device_s": busy, "idle_share": max(0.0, 1 - busy / wall),
                    "named_kernels": named,
                    "device_events": len(kern), "device_span_s": span,
                    "span_idle_share": max(0.0, 1 - sum(d for _, d in kern) / 1e9 / span)
                    if span else None,
                    "top": [{"kernel": k[:90], "s": s, "calls": n} for k, s, n in top],
                    "by_op": [{"op": k, "s": s, "calls": n} for k, s, n in by_op]}


def profile_batch(pipe):
    """One more batch under ``torch.profiler``. ``set_intersect_fill``: the
    mean non-pad values a row of ``a`` and ``b`` over the batch's
    ``set_intersect`` calls, counted on the card by a wrapper around
    ``ops.set_intersect`` set for this batch only (its reductions are in
    the profile), and the share of rows whose ``a`` is all pad. Returns the
    batch's record and the fill."""
    from repro_torch.kernels import ops

    inner, calls = ops.set_intersect, []

    def counted(a, b, *, pad, use_kernels):
        live = a != pad
        calls.append((tuple(a.shape), b.shape[1], live.sum(), (b != pad).sum(),
                      (~live.any(1)).sum()))
        return inner(a, b, pad=pad, use_kernels=use_kernels)

    upd = pipe.next_update()
    ops.set_intersect = counted
    try:
        d, prof = profiled(lambda: {k: int(v) for k, v in pipe.apply(upd).items()}, DDSL_KERNELS)
    finally:
        ops.set_intersect = inner
    rows = max(1, sum(shape[0] for shape, *_ in calls))
    fill = {"calls": len(calls), "rows": rows,
            "mean_nonpad_a": sum(int(c[2]) for c in calls) / rows,
            "mean_nonpad_b": sum(int(c[3]) for c in calls) / rows,
            "empty_a_share": sum(int(c[4]) for c in calls) / rows,
            "shapes": sorted({(shape[0], shape[1], cb) for shape, cb, *_ in calls})}
    emit({"phase": "profile", "count": d["count"], "overflow": d["overflow"],
          "set_intersect_fill": fill, **prof})
    return d, fill


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


def heavy_ids(e: int, n: int, gen) -> torch.Tensor:
    """Ids uniform over [0, n), unsorted, with half the rows set to n // 2."""
    seg = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32, device="cuda")
    seg[torch.rand(e, generator=gen, device="cuda") < 0.5] = n // 2
    return seg


def segment_sum_phase():
    """The segment-sum kernel against its plain version on their float64
    accumulators (``ref.ACC_DTYPE``), at the GNN path's shapes and at edge
    cases, each through its segment plan, built first. The bound and the
    ``index_add_`` yardstick are those of the function itself, whose
    accumulator is float32: the kernel's float64 traffic shows as distance
    from the bound."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_plan, segment_sum_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    big_n, big_e = 2_449_029, 1 << 24
    bf16, f32 = torch.bfloat16, torch.float32
    # the nodes of one edge slice of the forward, whose edge list is sorted
    # by destination: 2**24 of the 123,718,280 edges, about 50.5 a node
    slice_nodes = round(big_n * big_e / (2 * get_arch(GNN_ARCH).shape(GNN_SHAPE).n_edges))

    def rows(e, d, dtype):
        return torch.randn((e, d), generator=gen, device="cuda").to(dtype)

    slice_rows = rows(big_e, 70, bf16)
    cases = {
        # one gatedgcn edge slice (msg / eta) at full width, ids unsorted
        "gatedgcn_slice": (slice_rows, segment_ids(big_e, big_n, gen), big_n),
        # the same rows with ids sorted, as the forward feeds them
        "gatedgcn_slice_sorted": (slice_rows, torch.sort(torch.randint(
            0, slice_nodes, (big_e,), generator=gen, dtype=torch.int32, device="cuda")).values,
            big_n),
        # the same rows, half of them in one id
        "heavy_segment": (slice_rows, heavy_ids(big_e, big_n, gen), big_n),
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
    del slice_rows
    out = []
    for name in list(cases):
        data, seg, n = cases.pop(name)
        e, d = data.shape
        zeros = lambda: torch.zeros((n, d), dtype=ref.ACC_DTYPE, device="cuda")  # noqa: E731
        plan = segment_plan(seg, n)
        got = segment_sum_cuda(data, plan, zeros())
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
               "max_abs_err": err, "max_abs_ref": top, "limit": limit,
               "sorted": plan.order is None, "segments": plan.hi - plan.lo,
               "heavy_segments": plan.heavy.shape[0], "heavy_parts": plan.n_parts}
        if e * d >= 1 << 20:
            keep = (seg >= 0) & (seg < n)
            src = torch.where(keep[:, None], data.float(), 0.0)
            idx = seg.clamp(0, n - 1)
            acc = torch.zeros((n, d), dtype=torch.float32, device="cuda")
            touched = int(torch.unique(seg[keep]).numel())
            rec["ms"] = cuda_ms(lambda: segment_sum_cuda(data, plan, got))
            rec["plan_ms"] = cuda_ms(lambda: segment_plan(seg, n), reps=3)
            rec["plain_ms"] = cuda_ms(lambda: ref.segment_sum_ref(data, seg, n, want), reps=3)
            rec["library_ms"] = cuda_ms(lambda: acc.index_add_(0, idx, src))
            if rec["ms"] < 1:  # the card's time alone, the host's hidden
                rec["ms_back_to_back"] = cuda_ms(lambda: segment_sum_cuda(data, plan, got),
                                                 per=20)
                rec["library_ms_back_to_back"] = cuda_ms(lambda: acc.index_add_(0, idx, src),
                                                         per=20)
            # the function's bytes: data and ids read once, the float32 rows
            # of the touched segments written once; e * d float32 adds
            n_bytes = e * d * data.element_size() + 4 * e + 4 * touched * d
            rec["touched_segments"] = touched
            rec["bytes"] = n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, e * d)
            del keep, src, idx, acc
        out.append(rec)
        del data, seg, got, want, plan
    torch.cuda.empty_cache()
    return out


def sort_and_plan(g, slice_rows=None):
    """The forward's first step alone: sort the edge list by destination
    and build its segment plans (``gnn.sort_edges``); seconds on the host
    clock around it, its peak GiB above what was resident, the plans."""
    from repro_torch.models import gnn

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ed = gnn.sort_edges(g, slice_rows)
    torch.cuda.synchronize()
    rec = {"sort_plan_seconds": time.perf_counter() - t0,
           "sort_plan_peak_extra_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "plans": len(ed.plans), "sorted_plans": sum(p.order is None for p in ed.plans),
           "heavy_segments": sum(p.heavy.shape[0] for p in ed.plans)}
    del ed
    torch.cuda.empty_cache()
    return rec


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
    setup_s = time.perf_counter() - t0
    sort = sort_and_plan(g, gnn.EDGE_SLICE)
    check(sort["plans"] == sort["sorted_plans"] == slices,
          f"{sort['plans']} segment plans ({sort['sorted_plans']} sorted) for {slices} slices")
    emit({"phase": "gnn_plan", "arch": cfg.name, "shape": GNN_SHAPE, "nodes": n_nodes,
          "edges": n_edges, "d_in": cfg.d_in, "d_hidden": cfg.d_hidden, "d_out": cfg.d_out,
          "layers": cfg.n_layers, "dtype": cfg.dtype, "edge_slice": gnn.EDGE_SLICE,
          "slices": slices, "predicted_segment_sum_launches": predicted,
          "data_seconds": data_s, "setup_seconds": setup_s,
          "resident_gib": torch.cuda.memory_allocated() / 2**30, **sort})

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
    # a second kernel forward (profiled): without atomics it repeats bit for bit
    out_r = gnn_profile(params, g, cfg)
    equal["kernel_repeat_max_abs_diff"] = float((out_r.float() - out_k.float()).abs().max())
    check(equal["kernel_repeat_max_abs_diff"] == 0,
          f"two kernel forwards differ by {equal['kernel_repeat_max_abs_diff']}")
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
        gnn.forward(params, g, cfg, use_kernels=False)  # warm-up: first-use costs
        sort = sort_and_plan(g)
        rec_k, out_k, counts = gnn_forward(params, g, cfg, True, "kernels")
        rec_p, out_p, _ = gnn_forward(params, g, cfg, False, "plain")
        check(counts["segment_sum"] > 0, f"{arch}: segment_sum never launched")
        emit({"phase": "gnn_small", "shape": "full_graph_sm", "nodes": shape.n_nodes,
              "edges": 2 * shape.n_edges, "dtype": cfg.dtype,
              "segment_sum_launches": counts["segment_sum"],
              "kernel_seconds": rec_k["seconds"], "plain_seconds": rec_p["seconds"],
              "sort_plan_seconds": sort["sort_plan_seconds"],
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
    from repro_torch.kernels.flash_attention import flash_attention_cuda, route

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    mx = LM_PROMPT + LM_GEN
    # name: (b, hq, hkv, lq, lk, dh, q_offset, causal, dtypes)
    cases = {
        "prefill": (LM_BATCH, 24, 8, LM_PROMPT, mx, 128, 0, True, (bf16,)),
        "chunk_2": (LM_BATCH, 24, 8, LM_CHUNK, mx, 128, LM_CHUNK, True, (bf16,)),
        "decode_first": (LM_BATCH, 24, 8, 1, mx, 128, LM_PROMPT, True, (bf16,)),
        "decode_last": (LM_BATCH, 24, 8, 1, mx, 128, mx - 2, True, (bf16,)),
        # command-r-35b's grouping (64 query heads over 8 KV heads): each KV
        # head's cache is read once for its 8 query rows
        "decode_group8": (LM_BATCH, 64, 8, 1, mx, 128, LM_PROMPT, True, (bf16,)),
        "prefill_dh64": (2, 32, 8, 4096, 4100, 64, 0, True, (bf16,)),
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
            rec = {"case": name, "dtype": tag, "route": route(lq, dtype, dh), "b": b, "hq": hq,
                   "hkv": hkv, "lq": lq, "lk": lk, "dh": dh, "q_offset": off, "causal": causal,
                   "max_abs_err": err,
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
            if rec["ms"] < 1.0:
                # device time without the host's share: 20 calls between two events
                rec["ms_back_to_back"] = cuda_ms(lambda: flash_attention_cuda(
                    q, k, v, causal=causal, q_offset=off), per=20)
                rec["library_ms_back_to_back"] = cuda_ms(sdpa_call(q, k, v, off, causal), per=20)
            rec["admitted_keys"], rec["flops"], rec["bytes"] = admitted, flops, n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(
                n_bytes, flops, PEAK_BF16_FLOPS if dtype == bf16 else PEAK_OPS_PER_S)
            rec["tflop_per_s"] = flops / rec["ms"] / 1e9
            out.append(rec)
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def flash_kernels_line():
    """Registers, static shared, local (spill) and dynamic shared bytes of
    each flash kernel at its main-path instantiation (``cudaFuncGetAttributes``),
    and the decode grid the wrapper plans at phi4-mini's decode shape."""
    import importlib

    from repro_torch.kernels import build

    # the module (the package's ``flash_attention`` is the dispatch function)
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    bf16, f32 = torch.bfloat16, torch.float32
    attrs = {"tc_dh128": fa.kernel_attributes("tc", bf16, 128),
             "tc_dh64": fa.kernel_attributes("tc", bf16, 64),
             "decode_rows3": fa.kernel_attributes("decode", bf16, 128, 3),
             "decode_rows8": fa.kernel_attributes("decode", bf16, 128, 8),
             "simt_f32": fa.kernel_attributes("simt", f32, 128)}
    rows, chunks, _ = fa.decode_rows(24, 8, 1)
    slots = fa.decode_slots(torch.device("cuda", torch.cuda.current_device()), 1, 128, rows)
    heads = LM_BATCH * 8 * chunks
    splits, kps = fa.plan_splits(heads, LM_PROMPT + 1, slots,
                                 build.library().flash_decode_max_splits())
    return {"phase": "flash_kernels", "attributes": attrs,
            "decode_grid": {"rows": rows, "resident_blocks": slots, "splits": splits,
                            "keys_per_split": kps, "blocks": heads * splits}}


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
           "flash_attention_tc_launches": counts["flash_attention_tc"],
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
    A prefill launches the tensor-core kernel once a layer (the float32
    gate the CUDA-core kernel), a decode step the split-K decode kernel
    once a layer."""
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
    check(counts["flash_attention_tc"] == cfg.n_layers,
          f"{counts['flash_attention_tc']} of the {cfg.n_layers} bf16 prefill launches took "
          "the tensor-core kernel")
    others = {k: n for k, n in counts.items()
              if k not in predicted and k != "flash_attention_tc" and n}
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
    n_chunk_tc = chunk_counts["flash_attention_tc"]
    want = cfg.n_layers * (LM_PROMPT // LM_CHUNK)
    check(n_chunk == want and n_chunk_tc == want and chunk_counts["flash_decode"] == 0,
          f"chunked prefill launched {chunk_counts} ({n_chunk_tc} on the tensor cores), "
          f"predicted {want} flash_attention, all on the tensor cores")
    whole = res_k.logits[:, 0].float()
    rec = {"phase": "lm_chunked", "chunk": LM_CHUNK, "seconds": chunked_s,
           "flash_attention_launches": n_chunk, "flash_attention_tc_launches": n_chunk_tc,
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
    check(c32["flash_attention"] == cfg.n_layers and c32["flash_attention_tc"] == 0
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
    return counts, c32


# ---------------------------------------------------------------------------
# DLRM slice: embedding_bag and dlrm-rm2 serving
# ---------------------------------------------------------------------------

def dlrm_lookups(batch: int, sizes, v: int, gen):
    """Row indices and bag ids of one DLRM forward over the stacked tables
    (models/dlrm.py ``_embedding_bags``): ``sizes[f]`` uniform ids of field
    f per example, row ``f * v + id``, bag ``b * F + f``, sorted by bag."""
    n_f = len(sizes)
    field = torch.repeat_interleave(torch.arange(n_f, device="cuda"),
                                    torch.tensor(sizes, device="cuda"))          # [per example]
    ids = torch.randint(0, v, (batch, field.shape[0]), generator=gen, device="cuda")
    rows = (field[None, :] * v + ids).to(torch.int32).reshape(-1)
    bags = (torch.arange(batch, device="cuda")[:, None] * n_f + field[None, :])
    return rows, bags.to(torch.int32).reshape(-1), batch * n_f


def bag_limits(table, idx, bag, nb):
    """float64 bag sums of the rows in range, the limit a float32 sum is
    held to (n_b * 2**-23 * sum |rows|), the rows per bag and the bags with
    an out-of-range row (NaN by contract)."""
    v, d = table.shape
    keep = (bag >= 0) & (bag < nb)
    b, i = bag[keep].long(), idx[keep].long()
    ok = (i >= 0) & (i < v)
    rows = table[i.clamp(0, v - 1)].double()
    s = torch.zeros((nb, d), dtype=torch.float64, device="cuda").index_add_(0, b, rows)
    a = torch.zeros_like(s).index_add_(0, b, rows.abs())
    cnt = torch.bincount(b, minlength=nb)[:, None].double()
    nan = torch.zeros(nb, dtype=torch.bool, device="cuda")
    nan[b[~ok]] = True
    return s, cnt * 2.0**-23 * a, cnt, nan


def embedding_bag_phase():
    """The embedding-bag kernel against its plain version at the DLRM
    serving shapes, a multi-hot shape and edge cases, each timed beside
    ``F.embedding_bag`` and its byte bound where it is large."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    cfg = get_arch(DLRM_ARCH).config
    n_f, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    big = torch.randn((n_f * v, d), generator=gen, device="cuda").mul_(d ** -0.5)
    one = (1,) * n_f

    def small(rows, width, dtype=torch.float32):
        return torch.randn((rows, width), generator=gen, device="cuda").to(dtype)

    def unsorted(n, nb, v_rows):
        idx = torch.randint(0, v_rows, (n,), generator=gen, dtype=torch.int32, device="cuda")
        bag = torch.randint(0, nb, (n,), generator=gen, dtype=torch.int32, device="cuda")
        return idx, bag

    cases = {"serve_bulk": (big, *dlrm_lookups(262_144, one, v, gen)),
             "serve_p99": (big, *dlrm_lookups(512, one, v, gen)),
             "multi_hot": (big, *dlrm_lookups(4096, MULTI_HOT_SIZES, v, gen))}
    t = small(5000, 64, torch.bfloat16)
    cases["bf16"] = (t, *unsorted(60_000, 7000, 5000), 7000)
    t = small(5000, 64)
    idx, bag = unsorted(20_000, 3000, 5000)
    cases["empty_bags"] = (t, idx, bag * 3, 9000)                 # two bags in three empty
    idx, bag = unsorted(20_000, 3000, 5000)
    bag[::50], bag[7::50] = 3000, -1
    cases["bag_ids_out_of_range"] = (t, idx, bag, 3000)
    idx, bag = unsorted(20_000, 3000, 5000)
    idx[[11, 4321]] = 5000
    cases["row_index_v"] = (t, idx, bag, 3000)
    cases["d13"] = (small(5000, 13), *unsorted(30_000, 4000, 5000), 4000)
    # bags of 0, 1, 2, 31, 32, 33 and 100 rows: one-row and multi-row bags
    # in one 32-row window, bags crossing windows, empty bags at their edges
    sizes = torch.tensor([0, 0, 1, 1, 1, 1, 2, 31, 32, 33, 100], device="cuda")
    sizes = sizes[torch.randint(0, sizes.shape[0], (3000,), generator=gen, device="cuda")]
    bag = torch.repeat_interleave(torch.arange(3000, device="cuda"), sizes).to(torch.int32)
    cases["mixed_windows"] = (t, torch.randint(0, 5000, bag.shape, generator=gen,
                                               dtype=torch.int32, device="cuda"), bag, 3000)
    # serve_bulk's lookups folded into the table's first GiB (4,194,304
    # rows): against serve_bulk, a TLB limit on the 6.2 GiB of random rows
    # shows as a gap, a latency limit as none
    rows_1g = (1 << 30) // (d * big.element_size())
    cases["serve_bulk_1gib"] = (big, cases["serve_bulk"][1] % rows_1g, *cases["serve_bulk"][2:])
    exact = ("serve_bulk", "serve_p99", "serve_bulk_1gib")
    out = []
    for name, (table, idx, bag, nb) in cases.items():
        idx, bag = ops.sort_by_bag(idx, bag)
        got = embedding_bag_cuda(table, idx, bag, nb)
        bits = torch.int16 if got.element_size() == 2 else torch.int32
        check(torch.equal(got.view(bits), embedding_bag_cuda(table, idx, bag, nb).view(bits)),
              f"embedding_bag {name}: two launches differ")
        want = ref.embedding_bag_ref(table, idx, bag, nb)
        s, limit, cnt, nan = bag_limits(table, idx, bag, nb)
        torch.cuda.synchronize()
        if table.dtype == torch.bfloat16:
            limit = 2.0**-8 * s.abs() + (1 + 2.0**-8) * limit
        check(torch.equal(torch.isnan(got), nan[:, None].expand_as(got))
              and torch.equal(torch.isnan(want), torch.isnan(got)),
              f"embedding_bag {name}: NaN outside the bags of out-of-range rows")
        fin = ~nan
        worst = 0.0
        for label, x in (("kernel", got), ("plain", want)):
            dev = (x[fin].double() - s[fin]).abs()
            share = float((dev / limit[fin].clamp_min(1e-300)).max()) if dev.numel() else 0.0
            check(bool((dev <= limit[fin]).all()),
                  f"embedding_bag {name}: {label} off the float64 sum by {share} of its limit")
            worst = max(worst, share)
        check(not got[(cnt[:, 0] == 0)].any(), f"embedding_bag {name}: an empty bag is not zero")
        equal = torch.equal(got[fin], want[fin])
        if name in exact:
            check(equal, f"embedding_bag {name}: kernel and plain differ on one-row bags")
        rec = {"case": name, "v": table.shape[0], "d": table.shape[1], "n": idx.shape[0],
               "num_bags": nb, "dtype": str(table.dtype).split(".")[-1], "equal": equal,
               "max_abs_err": float((got[fin].float() - want[fin].float()).abs().max()),
               "max_abs_ref": float(want[fin].float().abs().max()),
               "max_err_over_limit": worst, "nan_bags": int(nan.sum()),
               "empty_bags": int((cnt == 0).sum())}
        if name == "serve_bulk_1gib":
            rec["ms"] = cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb))
            offsets = torch.searchsorted(bag, torch.arange(nb, device="cuda", dtype=torch.int32))
            lib = functools.partial(F.embedding_bag, idx.long(), table, offsets, mode="sum")
            rec["library_equal"] = torch.equal(lib(), want)
            rec["library_ms"] = cuda_ms(lib)
            rec["library_ms_back_to_back"] = cuda_ms(lib, per=20)
            del offsets, lib
        if name in ("serve_bulk", "serve_p99", "multi_hot"):
            n = idx.shape[0]
            rec["ms"] = cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb))
            # the card's time alone: 20 calls in a row
            rec["ms_back_to_back"] = cuda_ms(lambda: embedding_bag_cuda(table, idx, bag, nb),
                                             per=20)
            rec["plain_ms"] = cuda_ms(lambda: ref.embedding_bag_ref(table, idx, bag, nb), reps=3)
            i64 = idx.long()
            offsets = torch.searchsorted(bag, torch.arange(nb, device="cuda", dtype=torch.int32))
            lib = lambda: F.embedding_bag(i64, table, offsets, mode="sum")  # noqa: E731
            rec["library_equal"] = torch.equal(lib(), want) if name in exact else None
            rec["library_ms"] = cuda_ms(lib)
            rec["library_ms_back_to_back"] = cuda_ms(lib, per=20)
            rec["sort_ms"] = cuda_ms(lambda: ops.sort_by_bag(idx, bag))  # ops.embedding_bag's
            # rows read once, bags written once, ids read once; n * d adds
            n_bytes = (n + nb) * d * table.element_size() + 8 * n
            rec["bytes"] = n_bytes
            rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n * d)
            del i64, offsets
        out.append(rec)
        del got, want, s, limit, cnt, nan
    # N = 0 and num_bags = 0: answered without a launch
    before = embedding_bag_cuda.launches
    e = torch.empty(0, dtype=torch.int32, device="cuda")
    check(not embedding_bag_cuda(big, e, e, 5).any(), "embedding_bag N=0 is not zero")
    i1 = torch.zeros(3, dtype=torch.int32, device="cuda")
    check(embedding_bag_cuda(big, i1, i1, 0).shape == (0, d), "embedding_bag num_bags=0")
    check(embedding_bag_cuda.launches == before, "embedding_bag launched for an empty input")
    del cases, big
    torch.cuda.empty_cache()
    return out


def dlrm_requests(cfg, shape, r: int):
    """Request r of ``shape`` on the card, as ``serve_recsys`` draws it."""
    from repro_torch.launch import steps

    dense, sparse = (torch.from_numpy(a).cuda() for a in steps.recsys_requests(cfg, shape.batch, r))
    return dense, sparse


def dlrm_serve(cfg, params, shapes, use_kernels: bool, label: str):
    """For each shape, a warm-up request (its first use of each product
    shape), then DLRM_REQUESTS through ``serve_recsys``; a ``dlrm_serve``
    line per shape. Returns the outputs by shape and the launches over the
    whole run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.serve import serve_recsys

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    outputs = {}
    for name, n in DLRM_REQUESTS.items():
        shape = shapes[name]
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()["embedding_bag"]
        warm = serve_recsys(cfg, params, shape, 1, use_kernels=use_kernels, device="cuda",
                            seed=1000)
        res = serve_recsys(cfg, params, shape, n, use_kernels=use_kernels, device="cuda")
        secs = [r["seconds"] for r in res.records]
        examples = shape.n_candidates if shape.kind == "retrieval" else shape.batch
        flops = steps.dlrm_flops(cfg, examples)["model_flops"]
        rec = {"phase": "dlrm_serve", "run": label, "shape": name, "kind": shape.kind,
               "requests": n, "batch": shape.batch, "candidates": shape.n_candidates,
               "seconds": secs, "median_s": statistics.median(secs), "max_s": max(secs),
               "examples_per_s": examples * n / sum(secs),
               "model_flop_per_request": flops,
               "model_tflop_per_s": flops / statistics.median(secs) / 1e12,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "warmup_s": warm.records[0]["seconds"],
               "embedding_bag_launches": ops.launch_counts()["embedding_bag"] - before,
               "finite": all(bool(torch.isfinite(o).all()) for o in res.outputs)}
        del warm
        emit(rec)
        check(rec["finite"], f"dlrm {label} {name}: outputs are not finite")
        check(all(tuple(o.shape) == (examples,) for o in res.outputs),
              f"dlrm {label} {name}: output shapes {[tuple(o.shape) for o in res.outputs]}")
        outputs[name] = res.outputs
    return outputs, ops.launch_counts()


def dlrm_phase():
    """dlrm-rm2 serving at full width: plan, kernels, plain, equality and a
    profiled serve_bulk forward; returns the kernel run's launches."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm

    spec = get_arch(DLRM_ARCH)
    cfg = spec.config
    shapes = {name: spec.shape(name) for name in DLRM_REQUESTS}
    check(not torch.backends.cuda.matmul.allow_tf32, "DLRM runs its float32 products in float32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dlrm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # one launch a request, the warm-ups included
    predicted = len(DLRM_REQUESTS) + sum(DLRM_REQUESTS.values())
    emit({"phase": "dlrm_plan", "arch": cfg.name, "params": cfg.param_count(),
          "tables": cfg.n_sparse, "rows_per_table": cfg.rows_per_table,
          "embed_dim": cfg.embed_dim, "bot_mlp": list(cfg.bot_mlp), "top_mlp": list(cfg.top_mlp),
          "multi_hot": cfg.multi_hot, "dtype": cfg.dtype,
          "tf32": torch.backends.cuda.matmul.allow_tf32,
          "table_gib": params["tables"].numel() * params["tables"].element_size() / 2**30,
          "shapes": [{"name": s.name, "kind": s.kind, "batch": s.batch,
                      "candidates": s.n_candidates, "requests": DLRM_REQUESTS[s.name]}
                     for s in shapes.values()],
          "predicted_embedding_bag_launches": predicted, "init_seconds": init_s,
          "resident_gib": torch.cuda.memory_allocated() / 2**30})

    out_k, counts = dlrm_serve(cfg, params, shapes, True, "kernels")
    check(counts["embedding_bag"] == predicted,
          f"embedding_bag launched {counts['embedding_bag']} times, predicted {predicted}")
    others = {k: n for k, n in counts.items() if k != "embedding_bag" and n}
    check(not others, f"other kernels launched on the DLRM path: {others}")
    out_p, plain_counts = dlrm_serve(cfg, params, shapes, False, "plain")
    check(not any(plain_counts.values()), f"the plain serve launched kernels: {plain_counts}")

    # the gate: logits of every request, and the embedding outputs bitwise
    ratios, equal_share, emb_equal = {}, {}, True
    with torch.inference_mode():
        for name, n in DLRM_REQUESTS.items():
            ratios[name] = [float((k - p).abs().max()) / float(p.abs().max())
                            for k, p in zip(out_k[name], out_p[name])]
            equal_share[name] = float(torch.cat([(k == p).float() for k, p in
                                                 zip(out_k[name], out_p[name])]).mean())
            for r in range(n):
                _, sparse = dlrm_requests(cfg, shapes[name], r)
                ek = dlrm._embedding_bags(params, sparse, cfg, use_kernels=True)
                ep = dlrm._embedding_bags(params, sparse, cfg, use_kernels=False)
                emb_equal &= torch.equal(ek, ep)
                del ek, ep
    worst = max(max(r) for r in ratios.values())
    emit({"phase": "dlrm_equal", "limit_ratio": 1e-5, "max_ratio": worst, "ratios": ratios,
          "equal_share": equal_share, "embedding_bitwise_equal": emb_equal})
    check(worst <= 1e-5, f"dlrm logits: max |kernel - plain| / max |plain| {worst} > 1e-5")
    check(emb_equal, "dlrm embedding outputs of one-row bags differ between kernel and plain")
    del out_k, out_p
    torch.cuda.empty_cache()

    # where a serve_bulk forward's device time goes: DLRM_PROFILED forwards
    # after a warm-up that fills the allocator's cache as serving does (the
    # profiler can miss the first kernels of its window; over several
    # forwards that is a small share), device times per forward
    dense, sparse = dlrm_requests(cfg, shapes["serve_bulk"], 0)
    dlrm.forward(params, dense, sparse, cfg, use_kernels=True)
    _, prof = profiled(lambda: [dlrm.forward(params, dense, sparse, cfg, use_kernels=True)
                                for _ in range(DLRM_PROFILED)])
    ops_s = {o["op"]: o["s"] for o in prof["by_op"]}
    split = {"embedding_bag": sum(k["s"] for k in prof["top"] if "embedding_bag" in k["kernel"]),
             "sort": ops_s.get("aten::sort", 0.0), "mm": ops_s.get("aten::mm", 0.0),
             "bmm": ops_s.get("aten::bmm", 0.0), "cat": ops_s.get("aten::cat", 0.0),
             "add": ops_s.get("aten::add", 0.0), "relu": ops_s.get("aten::clamp_min", 0.0),
             "index": ops_s.get("aten::index", 0.0)}
    emit({"phase": "dlrm_profile", "arch": cfg.name, "shape": "serve_bulk",
          "batch": shapes["serve_bulk"].batch, "forwards": DLRM_PROFILED,
          "device_s_per_forward": prof["device_s"] / DLRM_PROFILED,
          "split_s_per_forward": {k: v / DLRM_PROFILED for k, v in split.items()}, **prof})
    del params, dense, sparse
    torch.cuda.empty_cache()
    return counts


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def device_ms(fn, kernel: str) -> float:
    """Device milliseconds a call of ``fn`` spends in the kernels whose
    names contain ``kernel`` (all of its kernels for ""), from the
    profiler over 20 calls."""
    fn()
    _, prof = profiled(lambda: [fn() for _ in range(20)], (kernel,))
    return prof["named_kernels"][kernel]["s"] * 1e3 / 20


def kernel_times(src: str) -> None:
    """``--kernel-times SRC``: the member_probe, set_intersect and
    embedding_bag kernels of the package under ``SRC`` (this checkout's
    ``src``, or another's, so that two trees are compared on one card in one
    call) timed at the main paths' shapes, one call at a time, 20 in a row
    and on the device (the profiler over 20 calls), beside
    ``F.embedding_bag``; then stage 1, one profiled DDSL batch, with the
    device seconds of each DDSL kernel, and set_intersect at the CC-join's
    shape and the batch's fill. Checks nothing but equality."""
    import dataclasses

    import torch.nn.functional as F

    sys.path.insert(0, os.path.abspath(src))
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.member_probe import member_probe_cuda
    from repro_torch.kernels.set_intersect import set_intersect_cuda
    from repro_torch.run import WT_Q1, Pipeline, stages

    import repro_torch

    tree = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    build.library()
    emit({"phase": "kernel_times", "src": tree, "build_s": build.build_seconds(),
          "device": nvidia_smi()})
    pipe = Pipeline(dataclasses.replace(WT_Q1), "cuda")
    caps, ush, store = pipe.caps, pipe.ushapes, pipe.store_caps
    gen = torch.Generator(device="cuda").manual_seed(0)
    drop = sorted_table(ush.cedge_cap, 64, 4096, gen)
    recs = []   # (record, call, library call)
    for name, (n, tbl) in {"patch_rows": (ush.cand_cap * caps.deg_cap, drop),
                           "patch_edges": (caps.e_cap, drop),
                           "filter_sets": (store.group_cap * store.set_cap,
                                           sorted_table(64, 0, 4096, gen)),
                           "tiny": (1000, sorted_table(1, 0, 4096, gen)),
                           "all_pad": (1000, torch.full((5, 2), -1, dtype=torch.int32,
                                                        device="cuda"))}.items():
        q = probe_queries(n, tbl, 4096, gen)
        args = (q[:, 0].contiguous(), q[:, 1].contiguous(), tbl[:, 0].contiguous(),
                tbl[:, 1].contiguous())
        del q
        check(torch.equal(member_probe_cuda(*args), ref.member_probe_ref(*args)),
              f"member_probe {name}")
        call = functools.partial(member_probe_cuda, *args)
        recs.append(({"phase": "kernel_times", "kernel": "member_probe", "case": name, "n": n,
                      "m": tbl.shape[0], "ms": cuda_ms(call),
                      "ms_back_to_back": cuda_ms(call, per=20)}, call, None))
    for name, (g, c) in {"ccjoin": (caps.group_cap, caps.set_cap),
                         "zcommon": (ush.cedge_cap, caps.deg_cap)}.items():
        a, b = padded_sets(g, c, 4096, gen), padded_sets(g, c, 4096, gen)
        check(torch.equal(set_intersect_cuda(a, b, -1), ref.set_intersect_ref(a, b, -1)),
              f"set_intersect {name}")
        call = functools.partial(set_intersect_cuda, a, b, -1)
        recs.append(({"phase": "kernel_times", "kernel": "set_intersect", "case": name, "g": g,
                      "ca": c, "cb": c, "ms": cuda_ms(call),
                      "ms_back_to_back": cuda_ms(call, per=20)}, call, None))
    del a, b
    cfg = get_arch(DLRM_ARCH).config
    n_f, v, d = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    big = torch.randn((n_f * v, d), generator=gen, device="cuda").mul_(d ** -0.5)
    one = (1,) * n_f
    bulk = dlrm_lookups(262_144, one, v, gen)
    for name, (idx, bag, nb) in {
            "serve_bulk": bulk, "serve_p99": dlrm_lookups(512, one, v, gen),
            "multi_hot": dlrm_lookups(4096, MULTI_HOT_SIZES, v, gen),
            "serve_bulk_1gib": (bulk[0] % ((1 << 30) // (4 * d)), *bulk[1:])}.items():
        idx, bag = ops.sort_by_bag(idx, bag)
        i64 = idx.long()
        offsets = torch.searchsorted(bag, torch.arange(nb, device="cuda", dtype=torch.int32))
        lib = functools.partial(F.embedding_bag, i64, big, offsets, mode="sum")
        call = functools.partial(embedding_bag_cuda, big, idx, bag, nb)
        check(bool(((call() - lib()).abs() <= 1e-5).all()), f"embedding_bag {name}")
        recs.append(({"phase": "kernel_times", "kernel": "embedding_bag", "case": name,
                      "n": idx.shape[0], "num_bags": nb, "ms": cuda_ms(call),
                      "ms_back_to_back": cuda_ms(call, per=20), "library_ms": cuda_ms(lib),
                      "library_ms_back_to_back": cuda_ms(lib, per=20)}, call, lib))
    # device times last: the profiler leaves the host slower for the rest of
    # the process
    for rec, call, lib in recs:
        rec["device_ms"] = device_ms(call, rec["kernel"])
        if lib is not None:
            rec["library_device_ms"] = device_ms(lib, "")
        emit(rec)
    del recs, call, lib
    del big, bulk
    torch.cuda.empty_cache()
    for rec in stages(pipe, 1):
        emit({"phase": "kernel_times", **rec})
    _, fill = profile_batch(pipe)
    # the CC-join's shape at the profiled batch's fill (after the profiler:
    # one call at a time reads slower, 20 in a row does not)
    g, c = caps.group_cap, caps.set_cap
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = padded_sets(g, c, 4096, gen, -1, fill["mean_nonpad_a"], fill["empty_a_share"])
    b = padded_sets(g, c, 4096, gen, -1, fill["mean_nonpad_b"])
    check(torch.equal(set_intersect_cuda(a, b, -1), ref.set_intersect_ref(a, b, -1)),
          "set_intersect ccjoin_fill")
    call = functools.partial(set_intersect_cuda, a, b, -1)
    emit({"phase": "kernel_times", "kernel": "set_intersect", "case": "ccjoin_fill", "g": g,
          "ca": c, "cb": c, "fill": fill,
          "ms": cuda_ms(call), "ms_back_to_back": cuda_ms(call, per=20)})


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ops
    from repro_torch.run import EXAMPLE_Q1, WT_Q1, Pipeline, stages
    import dataclasses

    # float32 products in full float32 on the card (no TF32), stated here:
    # the GNN comparisons hold float32 outputs to 1e-4, and the DLRM model
    # is float32 throughout (logits within 1e-5).
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
    check(tuple(r["count"] for r in recs_k) == WT_COUNTS[:len(recs_k)],
          f"counts {[r['count'] for r in recs_k]} != {list(WT_COUNTS[:len(recs_k)])}")
    for r in recs_k:
        check(r["overflow"] == 0, f"overflow in {r}")
    for name in DDSL_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")

    # where a batch's device time goes: one more batch under the profiler
    final, fill = profile_batch(pipe)
    check(final["overflow"] == 0, f"overflow in the profiled batch {final}")
    check(final["count"] == WT_COUNTS[len(recs_k)],
          f"profiled batch count {final['count']} != {WT_COUNTS[len(recs_k)]}")
    # the CC-join's shape at the batch's mean fill of a and b
    shapes = pipe.caps
    checks["set_intersect"].append(set_intersect_case(
        "ccjoin_fill", shapes.group_cap, shapes.set_cap, shapes.set_cap, ("padded",),
        fill=(fill["mean_nonpad_a"], fill["mean_nonpad_b"], fill["empty_a_share"]),
        gen=torch.Generator(device="cuda").manual_seed(1)))
    emit({"phase": "kernel_check", "set_intersect": checks["set_intersect"][-1:]})
    profiled_snap = store_snapshot(pipe.store)

    # small batches on the same pipeline, where the carry skips listing
    small_k, small_snaps = small_batches(pipe, "kernels")
    final = small_k[-1]
    final_snap = small_snaps[-1]

    # the full-gather storage update against the delta one, from this state
    storage_full_phase(pipe)

    # 4. audit: list from scratch on the final partitions (the maintained
    #    store is on the host as its snapshot; free it on the card first)
    pipe.stores = pipe.carries = None
    torch.cuda.empty_cache()
    (astore, adiag), seconds, peak = timed_stage(pipe.list_pattern)
    audit = {k: int(v) for k, v in adiag.items()}
    emit({"phase": "audit", **audit, "maintained": final["count"], "seconds": seconds,
          "peak_gib": peak})
    check(audit["overflow"] == 0 and audit["count"] == final["count"],
          "audit count differs from the maintained count")
    check(snapshots_equal(store_snapshot(astore), final_snap),
          "audit store differs from the maintained store")
    del pipe, astore
    torch.cuda.empty_cache()

    # 5. the plain path on the card must give the same counts and stores,
    #    over the same batches (the profiled one and the small ones too)
    recs_p, snaps_p, pipe = drive(WT_Q1, False, "plain")
    for i, (a, b) in enumerate(zip(recs_k, recs_p)):
        check(a["count"] == b["count"] and a["overflow"] == b["overflow"],
              f"step {i}: kernel {a} vs plain {b}")
        check(snapshots_equal(snaps_k[i], snaps_p[i]), f"step {i}: MatchStore tensors differ")
    d = pipe.apply(pipe.next_update())
    check(int(d["count"]) == WT_COUNTS[len(recs_p)] and int(d["overflow"]) == 0,
          f"plain profiled batch {d}")
    check(snapshots_equal(store_snapshot(pipe.store), profiled_snap),
          "profiled batch: MatchStore tensors differ")
    small_p, small_snaps_p = small_batches(pipe, "plain")
    for i, (a, b) in enumerate(zip(small_k, small_p)):
        check(a["count"] == b["count"] and a["unit_refreshes"] == b["unit_refreshes"],
              f"small batch {i}: kernel {a} vs plain {b}")
        check(snapshots_equal(small_snaps[i], small_snaps_p[i]),
              f"small batch {i}: MatchStore tensors differ")
    emit({"phase": "plain_equal", "steps": len(recs_k) + 1 + len(small_k)})
    del pipe
    torch.cuda.empty_cache()

    # 6. two patterns in one megastep
    q2_tree_counts = multi_phase(snaps_k)

    # 7. small reference: host-engine counts of the example graph
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

    # 8. the generic-join executor: K5 + K4 on WT~, its audit and plain
    #    replay, the mixed megastep beside the tree, and the planted graph
    wcoj_launches, auto_launches, wcoj_case = wcoj_phase(snaps_k, q2_tree_counts)
    checks["member_probe"].append(wcoj_case)
    del snaps_k
    planted_launches, planted_cases = wcoj_vs_tree_phase()
    checks["member_probe"].extend(planted_cases)

    # 9. segment_sum against its plain version at the GNN path's shapes
    checks["segment_sum"] = segment_sum_phase()
    emit({"phase": "kernel_check", "segment_sum": checks["segment_sum"]})

    # 10. GNN full-graph inference; launches counted over the kernel forward
    launches["segment_sum"] = gnn_phase()["segment_sum"]

    # 11. the two other architectures at full width on the small graph
    gnn_small_phase()

    # 12. flash_attention against its plain version at the serving shapes
    checks["flash_attention"] = flash_attention_phase()
    emit({"phase": "kernel_check", "flash_attention": checks["flash_attention"]})

    emit(flash_kernels_line())

    # 13. phi4-mini-3.8b serving; launches counted over the kernel serve (the
    #     float32 gate's for the CUDA-core kernel, which bf16 serving skips)
    lm_counts, f32_counts = lm_phase()
    launches["flash_attention"] = lm_counts["flash_attention_tc"]
    launches["flash_decode"] = lm_counts["flash_decode"]
    launches["flash_attention_simt"] = (f32_counts["flash_attention"]
                                        - f32_counts["flash_attention_tc"])
    checks["flash_decode"] = checks["flash_attention_simt"] = checks["flash_attention"]

    # 14. embedding_bag against its plain version at the DLRM shapes
    checks["embedding_bag"] = embedding_bag_phase()
    emit({"phase": "kernel_check", "embedding_bag": checks["embedding_bag"]})

    # 15. dlrm-rm2 serving; launches counted over the kernel serve
    launches["embedding_bag"] = dlrm_phase()["embedding_bag"]

    # summary lines
    line = nvidia_smi()
    name, _, power = line.rpartition(",")
    emit({"phase": "device", "nvidia_smi": line, "name": name.strip(),
          "power_limit": power.strip()})
    sources = {"member_probe": ("src/repro_torch/kernels/csrc/member_probe.cu",
                                "src/repro/kernels/member_probe.py:52", "filter_sets"),
               "set_intersect": ("src/repro_torch/kernels/csrc/set_intersect.cu",
                                 "src/repro/kernels/set_intersect.py:34", "ccjoin"),
               "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                               "src/repro/kernels/segment_sum.py:53", "gatedgcn_slice_sorted"),
               "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                                   "src/repro/kernels/flash_attention.py:84", "prefill"),
               "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_attention.py:84", "decode_first"),
               "flash_attention_simt": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                        "src/repro/kernels/flash_attention.py:84",
                                        "prefill_f32_gate"),
               "embedding_bag": ("src/repro_torch/kernels/csrc/embedding_bag.cu",
                                 "src/repro/kernels/embedding_bag.py:41", "serve_bulk")}
    kernels = []
    for name, (src, replaces, case) in sources.items():
        rec = next(r for r in checks[name] if r["case"] == case)
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": rec["max_abs_err"],
                 "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                 "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                 "library_ms": rec["library_ms"], "case": case}
        if name in DDSL_KERNELS:
            # the same kernel's launches on each DDSL path (counts set to 0
            # just before each path and read just after)
            entry["launches_by_path"] = {
                "wt_q1": launches[name], "wt_clique": wcoj_launches[name],
                "wt_multi_auto": auto_launches[name],
                **{path: n[name] for path, n in planted_launches.items()}}
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--kernel-times"] and len(sys.argv) == 3:
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        kernel_times(sys.argv[2])
    elif len(sys.argv) > 1:
        fail(f"usage: {sys.argv[0]} [--kernel-times SRC]")
    else:
        main()
