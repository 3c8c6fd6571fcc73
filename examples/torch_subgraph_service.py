"""End-to-end driver of ``repro_torch.stream``: the continuous listing service
of the PyTorch/CUDA port, with no JAX.

The port's twin of ``examples/dynamic_subgraph_service.py``, with the same
flags. Several patterns stay live over one update stream (§VII-C protocol:
batches of half deletions and half insertions). Updates are ingested into
the journal, the scheduler nets them into cost-model-sized micro-batches,
one shared delta drives every pattern (Alg. 4 once per batch), a sink
streams count deltas out, and a from-scratch audit (the host ``DDSL``)
re-lists one pattern every ``--audit-every`` batches.

``--backend sharded`` runs the device backend,
:class:`repro_torch.backend.TorchBackend`: each pattern's running match set
lives on the card as a ``MatchStore`` over 8 partitions, and every batch
runs one storage update and one fused maintain megastep for all patterns
there, through the ``member_probe`` and ``set_intersect`` kernels. It needs
a CUDA card and raises without one; ``--device cpu`` runs it on the CPU
with the kernels' plain versions. ``--backend host`` is the NumPy engine.
With only the count sink subscribed, batches move scalars device→host:
the ``hostB`` field of the per-batch line stays 0.

``--obs-dir DIR`` turns on span tracing and exports the bundle on exit
(metrics JSON and Prometheus text, the span tree as JSONL and Chrome
trace-event JSON, the compiled-plan dumps). ``--reoptimize`` attaches a
:class:`repro_torch.stream.PlanManager`, which recompiles each pattern's
plan from live stats and hot-swaps it at the watermark when the Eq. 11
re-cost says the incumbent has gone stale.

    PYTHONPATH=src python examples/torch_subgraph_service.py --backend host
    PYTHONPATH=src python examples/torch_subgraph_service.py --backend sharded --device cpu \\
        --patterns q2_triangle,q1_square --batch-size 12 --batches 2
    PYTHONPATH=src python examples/torch_subgraph_service.py --backend sharded \\
        --patterns q2_triangle,q1_square --batch-size 12                          # on a card

(q5_house, the default third pattern, overflows the default caps' unit-table
carry at m = 8, and ``register`` raises.)
"""

import argparse

from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.data.graphs import rmat_graph, sample_update
from repro_torch.stream import (BatchScheduler, CountDeltaSink, ListingService, Observability,
                                PlanManager)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=8, help="ingest rounds")
    ap.add_argument("--batch-size", type=int, default=50)
    ap.add_argument("--patterns", default="q2_triangle,q1_square,q5_house")
    ap.add_argument("--audit-every", type=int, default=4)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--backend", choices=("host", "sharded"), default="host")
    ap.add_argument("--device", default="cuda",
                    help="the device backend's device: 'cuda' (the default; "
                         "raises without a card) or 'cpu' (the kernels' plain "
                         "versions)")
    ap.add_argument("--executor", choices=("auto", "tree", "wcoj"), default="tree",
                    help="join executor mode: 'tree' (VCBC join trees), 'wcoj' "
                         "(force the worst-case-optimal generic join; dense "
                         "patterns only), or 'auto' (compiler picks per pattern "
                         "from the cost model)")
    ap.add_argument("--target-cost", type=float, default=250_000.0,
                    help="scheduler per-micro-batch work budget (cost units)")
    ap.add_argument("--obs-dir", default=None,
                    help="enable span tracing and export the observability "
                         "bundle into this directory")
    ap.add_argument("--reoptimize", action="store_true",
                    help="drift-triggered online plan re-optimization: "
                         "recompile plans from live stats and hot-swap at "
                         "committed watermarks")
    ap.add_argument("--drift-threshold", type=float, default=1.5,
                    help="scheduler drift EWMA that triggers a recompile")
    ap.add_argument("--recost-every", type=int, default=16,
                    help="also recompile every K batches (0 disables)")
    args = ap.parse_args()

    pm = PlanManager(drift_threshold=args.drift_threshold,
                     recost_every=args.recost_every) if args.reoptimize else None

    if args.backend == "sharded":
        graph = rmat_graph(6, 400, seed=0)     # device demo, as the JAX example's
        kw = dict(max_add=args.batch_size, max_del=args.batch_size, device=args.device)
    else:
        graph = rmat_graph(10, 5000, seed=0)
        kw = dict(m=args.m)
    svc = ListingService(
        graph, backend=args.backend, audit_every=args.audit_every,
        scheduler=BatchScheduler(target_cost=args.target_cost, max_ops=args.batch_size),
        obs=Observability.full() if args.obs_dir else None,
        plan_manager=pm, executor=args.executor, **kw)
    counts = svc.subscribe(CountDeltaSink())

    for name in args.patterns.split(","):
        n0 = svc.register(name, PATTERN_LIBRARY[name])
        print(f"[init] {name}: |M|={n0} executor={svc.backend.plan(name).executor}")

    seen_audits = 0
    for b in range(args.batches):
        upd = sample_update(svc.projected_graph(), args.batch_size // 2,
                            args.batch_size // 2, seed=100 + b)
        svc.ingest(upd)
        for bm in svc.advance():
            per = " ".join(f"{n}:|M|={r.count_after}(+{r.patch_groups}g)"
                           for n, r in bm.patterns.items())
            cand = (f" cand={bm.cand_vertices}v/{bm.cand_edges}e"
                    if bm.cand_vertices >= 0 else "")
            host_b = f" hostB={bm.host_bytes}" if args.backend == "sharded" else ""
            cache = (f" cache={bm.cache_hits}h/{bm.cache_misses}m/{bm.invalidated_parts}inv"
                     if bm.cache_hits >= 0 else "")
            print(f"[batch {bm.batch_index}] ops={bm.n_ops} "
                  f"(net +{bm.net_add}/-{bm.net_delete}) "
                  f"{bm.latency_s*1e3:.0f}ms {bm.throughput_ops_s:.0f}op/s "
                  f"ovf={bm.overflow}{cand}{host_b}{cache} {per}")
        for bi, name, ok in svc.audits[seen_audits:]:
            print(f"[audit] batch {bi} {name}: {'OK' if ok else 'MISMATCH'}")
        seen_audits = len(svc.audits)

    print(f"service run complete: counts={svc.counts()} "
          f"watermark={svc.committed_watermark} "
          f"journal_compacted={svc.compact()} entries")
    print(f"count deltas seen by sink: {counts.totals}")
    drift = svc.scheduler.drift()
    if drift is not None:
        print(f"scheduler drift (observed/predicted EWMA): {drift:.2f}")
    if pm is not None:
        for ev in pm.events:
            verdict = "SWAPPED" if ev.swapped else "kept"
            print(f"[replan] batch {ev.batch_index} {ev.pattern} "
                  f"({ev.trigger}, drift={ev.drift and f'{ev.drift:.2f}'}): "
                  f"inc={ev.incumbent_cost:.3g} cand={ev.candidate_cost:.3g} -> {verdict}"
                  + (f" |M|={ev.count} in {ev.elapsed_s*1e3:.0f}ms" if ev.swapped else ""))
    if args.obs_dir:
        for kind, path in sorted(svc.obs.export(args.obs_dir).items()):
            print(f"[obs] {kind}: {path}")


if __name__ == "__main__":
    main()
