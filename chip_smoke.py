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

# NVIDIA H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
# tensor cores as the peak for 32-bit integer compares.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
N_BATCHES = 3


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
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


def profile_batch(pipe):
    """One more batch under ``torch.profiler``: wall time, summed device
    time of its kernels, and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    upd = pipe.next_update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d = {k: int(v) for k, v in pipe.apply(upd).items()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: a CPU-side op also reports its kernels' device time, and
    # "Command Buffer Full" marks a full launch queue, not device work.
    dev = [(e.key, e.self_device_time_total / 1e6, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
           and not e.key.startswith("Command Buffer")]
    busy = sum(s for _, s, _ in dev)
    top = sorted(dev, key=lambda r: -r[1])[:12]
    emit({"phase": "profile", "count": d["count"], "overflow": d["overflow"],
          "wall_s": wall, "device_s": busy, "idle_share": max(0.0, 1 - busy / wall),
          "top": [{"kernel": k[:90], "s": s, "calls": n} for k, s, n in top]})
    return d


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    from repro_torch.kernels import build, ops
    from repro_torch.run import EXAMPLE_Q1, WT_Q1, Pipeline, stages
    import dataclasses

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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

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
                                 "src/repro/kernels/set_intersect.py:34", "ccjoin")}
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
