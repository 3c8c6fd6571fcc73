"""Distributed listing and incremental update on a ``torch.distributed``
mesh: the twin of ``examples/distributed_listing.py`` for the PyTorch port.

    PYTHONPATH=src python examples/torch_distributed_listing.py --world 4 --config wt_q1
    PYTHONPATH=src python examples/torch_distributed_listing.py --device cpu --world 4

The script spawns ``--world`` ranks itself (NCCL, one rank a card, on
``--device cuda``, the default, which raises without CUDA; gloo on
``--device cpu``). Each rank runs the configuration's pipeline
(``repro_torch.run.Pipeline``) on a :class:`~repro_torch.mesh.ProcessMesh`:
stage 1, then ``--batches`` edge batches, each a storage update and one
carried maintain megastep, twice:

1. at the configuration's ``m`` (8), ``m / world`` partitions a rank;
   after the ranks are done, the same stages run in this process on one
   device over a :class:`~repro_torch.mesh.LocalMesh`, and every rank's
   store shards and partitions must equal that run's (a digest of each
   shard's valid prefix, its tail checked to be PAD, and of each
   partition's tensors);
2. at ``m = world`` (JAX's layout, one partition a rank; four ranks),
   counts only.

Every stage's counts must be the host engine's (``EXPECTED``) and the
overflow 0. Then the ranks run the collectives of ``repro_torch.dist``
(one partition a rank) on the inputs of ``tests/spmd/run_collectives.py``,
held to the same functions over a ``LocalMesh(world)`` in this process on
the same device. Prints one JSON line per stage and check; a failed check
or a failed rank exits nonzero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch import run  # noqa: E402

CONFIGS = {"example": run.EXAMPLE_Q1, "wt_q1": run.WT_Q1}
# host-engine counts of q1_square at stage 1 and after each batch
EXPECTED = {"example": (1282, 1238, 1128, 1086),
            "wt_q1": (395_050, 385_521, 373_667, 365_873)}
# The layouts with one partition a rank that the script runs, with the caps
# that change. WT~ at m = 4: a partition holds up to 2,215 vertices and
# 8,168 edges (m = 8: 1,828 and 7,479), and the owner of the hubs' join
# keys gets twice the CC-join groups.
ONE_A_RANK_CAPS = {("example", 4): {},
                   ("wt_q1", 4): dict(v_cap=3072, e_cap=16_384, group_cap=262_144)}
TIMEOUT_S = 600.0
COLLECTIVE_CAPS = (32, 3)   # 32 holds all 32 rows of a device; 3 overflows


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def shard_digests(store, pt):
    """Per local partition: a digest of the store shard (its valid prefix,
    after checking that the valid mask is a prefix and every tail is PAD,
    so equal digests mean equal tensors) and one of the partition's
    tensors."""
    out = []
    for j in range(store.valid.shape[0]):
        valid = store.valid[j]
        n = int(valid.sum())
        tails = [store.skeleton[j, n:]] + [a[j, n:] for a in store.sets.values()]
        if not (bool(valid[:n].all()) and not bool(valid[n:].any())
                and all(bool((t == -1).all()) for t in tails)):
            raise AssertionError(f"store shard {j} is not a PAD-tailed valid prefix")
        h = hashlib.sha256(str(n).encode())
        for t in [store.skeleton[j, :n]] + [store.sets[v][j, :n] for v in sorted(store.sets)]:
            h.update(t.cpu().numpy().tobytes())
        p = hashlib.sha256()
        for f in dataclasses.fields(pt):
            p.update(getattr(pt, f.name)[j].cpu().numpy().tobytes())
        out.append({"store": h.hexdigest(), "partition": p.hexdigest(), "groups": n})
    return out


def _stages(pipe, batches: int, mesh=None):
    """``run.stages`` with each record's shard digests and, on a process
    mesh, the collectives' calls and bytes of the stage."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    if mesh is not None:
        mesh.reset_counts()
    for rec in run.stages(pipe, batches):
        rec["digests"] = shard_digests(pipe.store, pipe.pt)
        rec["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
        ops.reset_launch_counts()
        if mesh is not None:
            rec["collective_calls"] = dict(mesh.calls)
            rec["collective_bytes"] = dict(mesh.bytes)
            mesh.reset_counts()
        yield rec


def collective_inputs(n: int):
    """The inputs of tests/spmd/run_collectives.py for ``n`` devices."""
    rng = np.random.default_rng(0)
    return {"rows": rng.integers(0, 1000, (n, 32, 2)).astype(np.int32),
            "targets": rng.integers(0, n, (n, 32)).astype(np.int32),
            "valid": rng.random((n, 32)) < 0.8,
            "x": rng.normal(size=(n, 16)).astype(np.float32)}


def run_collectives(mesh, device):
    """The collectives of ``repro_torch.dist`` on the mesh's partitions:
    ``{name: per-partition results stacked}`` as numpy arrays."""
    from repro_torch.dist import (bucketed_all_to_all, butterfly_compressed_all_reduce,
                                  ring_all_reduce, routed_exchange)

    inp = collective_inputs(mesh.size)
    ids = list(mesh.indices())

    def part(k):
        return [torch.from_numpy(np.ascontiguousarray(inp[k][i])).to(device) for i in ids]

    out = {}
    for cap in COLLECTIVE_CAPS:
        rec, rv, ovf = bucketed_all_to_all([[r] for r in part("rows")], part("targets"),
                                           part("valid"), mesh, cap)
        out[f"a2a_{cap}"] = [torch.cat([r[0].reshape(-1), v.to(torch.int32),
                                        ovf.reshape(1)]) for r, v in zip(rec, rv)]
        rec, rv, restore, ovf = routed_exchange([[r] for r in part("rows")], part("targets"),
                                                part("valid"), mesh, cap)
        back = restore([r[0] * 2 for r in rec])
        out[f"routed_{cap}"] = [torch.cat([r[0].reshape(-1), v.to(torch.int32),
                                           b.reshape(-1), ovf.reshape(1)])
                                for r, v, b in zip(rec, rv, back)]
    out["ring"] = ring_all_reduce(part("x"), mesh)
    out["butterfly"] = butterfly_compressed_all_reduce(part("x"), mesh)
    return {k: torch.stack(v).cpu().numpy() for k, v in out.items()}


def _rank(rank: int, world: int, port: int, config: str, device: str, batches: int,
          out: str) -> None:
    """One rank: both layouts' stages, then the collectives."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_process_mesh
    from repro_torch.mesh import ProcessMesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    cfg = CONFIGS[config]
    mesh = init_process_mesh(cfg.m, device, timeout_s=TIMEOUT_S)
    cuda = mesh.device.type == "cuda"
    recs = []
    for layout, c in layouts(config, world):
        m_mesh = mesh if c.m == cfg.m else ProcessMesh(c.m, mesh.device)
        pipe = run.Pipeline(c, mesh.device, use_kernels=cuda, mesh=m_mesh)
        for rec in _stages(pipe, batches, m_mesh):
            recs.append({"layout": layout, "rank": rank, **rec})
        del pipe
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    one = ProcessMesh(world, mesh.device)
    np.savez(f"{out}/collectives{rank}.npz", **run_collectives(one, mesh.device))
    with open(f"{out}/rank{rank}.json", "w") as f:
        json.dump(recs, f)
    dist.destroy_process_group()


def layouts(config: str, world: int):
    """``(name, RunConfig)``: the configuration at its m, and at m = world
    where ``ONE_A_RANK_CAPS`` has that layout."""
    cfg = CONFIGS[config]
    if cfg.m % world:
        raise ValueError(f"{world} ranks cannot hold {cfg.m} partitions evenly")
    out = [(f"m{cfg.m}", cfg)]
    if world != cfg.m and (config, world) in ONE_A_RANK_CAPS:
        out.append((f"m{world}", dataclasses.replace(cfg, m=world,
                                                     **ONE_A_RANK_CAPS[config, world])))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--config", choices=sorted(CONFIGS), default="example")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    dev = run._require_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        if torch.cuda.device_count() < args.world:
            raise RuntimeError(f"{args.world} ranks need {args.world} cards, "
                               f"{torch.cuda.device_count()} visible")
        from repro_torch.kernels import build

        build.library()     # once, before the ranks load it
        dev = torch.device("cuda", 0)
    want = EXPECTED[args.config][:args.batches + 1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        torch.multiprocessing.start_processes(
            _rank, args=(args.world, _free_port(), args.config, args.device, args.batches, out),
            nprocs=args.world, join=True, start_method="spawn")
        ranks = []
        for r in range(args.world):
            with open(f"{out}/rank{r}.json") as f:
                ranks.append(json.load(f))
        coll = [dict(np.load(f"{out}/collectives{r}.npz")) for r in range(args.world)]
    spawn_s = time.perf_counter() - t0
    failures = []

    def check(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    by_stage = {}
    for recs in ranks:
        for rec in recs:
            by_stage.setdefault((rec["layout"], rec["phase"], rec.get("batch", -1)),
                                []).append(rec)
    for (layout, phase, b), recs in by_stage.items():
        counts = {r["count"] for r in recs}
        i = b + 1
        line = {"phase": "mesh", "layout": layout, "world": args.world, "stage": phase,
                "batch": b, "count": recs[0]["count"], "overflow": recs[0]["overflow"],
                "seconds": max(r["seconds"] for r in recs),
                "seconds_by_rank": [r["seconds"] for r in recs]}
        if cuda:
            line["peak_gib_by_rank"] = [r["peak_gib"] for r in recs]
        for k in ("collective_calls", "collective_bytes", "launches"):
            line[f"{k}_by_rank"] = [r[k] for r in recs]
        emit(line)
        check(counts == {want[i]}, f"{layout} {phase} {b}: counts {counts} != {want[i]}")
        check(all(r["overflow"] == 0 for r in recs), f"{layout} {phase} {b}: overflow")
        if cuda:
            check(all(r["launches"].get(k, 0) > 0 for r in recs
                      for k in ("member_probe", "set_intersect")) or phase == "stage1",
                  f"{layout} {phase} {b}: a rank launched no DDSL kernel")

    # the one-device reference of the first layout, on card 0 (or the CPU)
    name, cfg = layouts(args.config, args.world)[0]
    t1 = time.perf_counter()
    pipe = run.Pipeline(cfg, dev, use_kernels=cuda)
    ref = list(_stages(pipe, args.batches))
    del pipe
    ref_s = time.perf_counter() - t1
    k = cfg.m // args.world
    equal = True
    for i, r in enumerate(ref):
        check(r["count"] == want[i], f"reference stage {i}: count {r['count']}")
        for rank, recs in enumerate(ranks):
            mine = [x for x in recs if x["layout"] == name][i]
            same = mine["digests"] == r["digests"][rank * k:(rank + 1) * k]
            equal &= same
            check(same, f"{name} stage {i}: rank {rank}'s shards differ from the LocalMesh run")
    emit({"phase": "mesh_reference", "layout": name, "world": args.world,
          "counts": [r["count"] for r in ref], "seconds": [r["seconds"] for r in ref],
          "peak_gib": [r.get("peak_gib") for r in ref], "shards_equal": equal,
          "reference_seconds": ref_s})

    # the collectives against the same functions on a LocalMesh(world)
    from repro_torch.mesh import LocalMesh

    local = run_collectives(LocalMesh(args.world), dev)
    got = {key: np.concatenate([c[key] for c in coll]) for key in local}
    res = {}
    for key, want_v in local.items():
        if key == "ring":
            res[key] = float(np.abs(got[key] - want_v).max() / np.abs(want_v).max())
            check(res[key] <= 1e-6, f"collectives {key}: {res[key]}")
        else:
            res[key] = bool(np.array_equal(got[key], want_v))
            check(res[key], f"collectives {key} differ from the LocalMesh run's")
    overflow = {cap: int(local[f"a2a_{cap}"][0, -1]) for cap in COLLECTIVE_CAPS}
    check(overflow[COLLECTIVE_CAPS[0]] == 0 and overflow[COLLECTIVE_CAPS[1]] > 0,
          f"collectives: overflow {overflow}")
    emit({"phase": "mesh_collectives", "world": args.world, "equal": res,
          "overflow_by_capacity": overflow, "spawned_seconds": spawn_s})
    if failures:
        print("torch_distributed_listing: FAILED: " + "; ".join(failures), file=sys.stderr)
        sys.exit(1)
    emit({"phase": "done", "world": args.world, "config": args.config,
          "backend": "nccl" if cuda else "gloo"})


if __name__ == "__main__":
    main()
