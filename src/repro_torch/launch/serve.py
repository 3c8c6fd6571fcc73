"""Batched serving: an LM's prefill and greedy decode loop, or DLRM's requests.

Twin of ``repro/launch/serve.py``; the arch's family picks the loop. For an
LM (the default arch is minicpm3-4b, an MLA model, as in the JAX CLI), on
the card, with every attention through the CUDA ``flash_attention`` kernels::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \\
        --batch 4 --prompt-len 4096 --gen 16 [--chunk 2048] [--absorbed]

``--absorbed`` decodes MLA models in the absorbed form (scores against the
latent cache, no kernel); any of the five LMs is an ``--arch``
(phi4-mini-3.8b, minicpm3-4b, deepseek-v2-lite-16b, granite-moe-3b-a800m,
command-r-35b). It prints one JSON record per stage and the generated ids
last. For DLRM, with every embedding bag through the CUDA ``embedding_bag``
kernel, it answers ``--requests`` requests of one ``RECSYS_SHAPES`` shape and
prints a JSON record per request::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-rm2 \\
        --shape serve_bulk --requests 2

On the CPU, with the plain versions, at the smoke configurations::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke [--absorbed]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b \\
        --device cpu --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-rm2 --device cpu \\
        --smoke --shape serve_p99 --requests 2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import ShapeSpec, get_arch
from ..models import dlrm
from ..models import transformer as tf
from . import steps

__all__ = ["ServeResult", "RecsysResult", "prompt_tokens", "serve", "serve_recsys", "main"]


@dataclasses.dataclass
class ServeResult:
    ids: torch.Tensor        # [B, gen] greedy tokens (int64)
    logits: torch.Tensor     # [B, gen, V] the logits each token was chosen from
    cache: Dict              # the KV cache after the last step
    records: List[Dict]      # one per stage: prefill, then each decode step


def prompt_tokens(vocab: int, batch: int, prompt_len: int, seed: int = 0) -> np.ndarray:
    """Random prompts ``[batch, prompt_len]`` int32, as the JAX serving loop
    draws them (``numpy.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (batch, prompt_len)).astype(np.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: tf.TransformerConfig, params, prompt: torch.Tensor, gen: int, *,
          use_kernels: bool, chunk: int = 0,
          forced: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompt [B, S]`` (chunked when ``chunk``), then ``gen - 1``
    greedy decode steps at positions ``S … S + gen - 2``, over a cache of
    ``S + gen`` positions on the prompt's device.

    ``forced [B, gen]`` teacher-forces the decode: step ``i`` is fed
    ``forced[:, i]`` instead of the token it chose, so that two runs see
    the same inputs; ``ids`` still holds the tokens this run chose. Each
    record holds the stage's host seconds, ending in a device
    synchronisation.
    """
    device = prompt.device
    b, s = prompt.shape
    cache = tf.init_cache(cfg, b, s + gen, device)
    records, ids, logits = [], [], []

    def step(stage, fn, **extra):
        _sync(device)
        t0 = time.perf_counter()
        out, _ = fn()
        last = out[:, -1]
        tok = torch.argmax(last, dim=-1)
        _sync(device)
        records.append({"stage": stage, "seconds": time.perf_counter() - t0, **extra})
        ids.append(tok)
        logits.append(last)
        return tok if forced is None else forced[:, len(ids) - 1].to(device)

    if chunk:
        tok = step("prefill", lambda: tf.prefill_chunked(params, prompt, cache, cfg, chunk=chunk,
                                                         use_kernels=use_kernels),
                   tokens=b * s, chunk=chunk)
    else:
        tok = step("prefill", lambda: tf.prefill(params, prompt, cache, cfg,
                                                 use_kernels=use_kernels), tokens=b * s)
    for i in range(gen - 1):
        pos = s + i
        tok = step("decode", lambda: tf.decode_step(params, tok[:, None], cache, pos, cfg,
                                                    use_kernels=use_kernels), pos=pos)
    return ServeResult(torch.stack(ids, 1), torch.stack(logits, 1), cache, records)


@dataclasses.dataclass
class RecsysResult:
    outputs: List[torch.Tensor]  # per request: logits [B] or retrieval scores [N]
    records: List[Dict]          # one per request


def serve_recsys(cfg: dlrm.DLRMConfig, params, shape: ShapeSpec, requests: int, *,
                 use_kernels: bool, device="cuda", seed: int = 0, mesh=None) -> RecsysResult:
    """Answer ``requests`` requests of ``shape`` (``recsys_serve``: a batch
    of ``shape.batch`` examples; ``retrieval``: one query against
    ``shape.n_candidates`` candidates). Request ``r`` is drawn from seed
    ``seed + r`` (:func:`steps.recsys_requests`) and copied to ``device``
    before its clock starts; its record holds the host seconds of the step,
    ending in a device synchronisation.

    On a grid ``mesh`` (``_dlrm_cell``'s serving and retrieval placements)
    ``params`` are this rank's shards and every rank draws every request
    whole: it answers its part (a data rank's examples, a rank's slice of
    the candidates; all of them where the axes do not divide them), which
    ``outputs`` hold. Each record adds the collectives' calls and bytes of
    the request by kind and axis."""
    device = torch.device(device)
    outputs, records = [], []
    for r in range(requests):
        dense, sparse = (torch.from_numpy(a).to(device)
                         for a in steps.recsys_requests(cfg, shape.batch, seed + r))
        if shape.kind == "retrieval":
            cand = torch.from_numpy(steps.retrieval_candidates(
                cfg, shape.n_candidates, seed + r)).to(device)
            examples = shape.n_candidates
            step = lambda: steps.dlrm_retrieval_step(params, dense, sparse, cand, cfg,  # noqa: E731
                                                     use_kernels=use_kernels, mesh=mesh)
        else:
            examples = shape.batch
            step = lambda: steps.dlrm_serve_step(params, dense, sparse, cfg,  # noqa: E731
                                                 use_kernels=use_kernels, mesh=mesh)
        calls = bytes_ = None
        if mesh is not None:
            calls, bytes_ = Counter(mesh.calls), Counter(mesh.bytes)
        _sync(device)
        t0 = time.perf_counter()
        out = step()
        _sync(device)
        seconds = time.perf_counter() - t0
        outputs.append(out)
        rec = {"stage": shape.kind, "shape": shape.name, "request": r,
               "batch": shape.batch, "candidates": shape.n_candidates,
               "seconds": seconds, "examples_per_s": examples / seconds}
        if mesh is not None:
            rec.update(rank=mesh.rank, answered=int(out.shape[0]),
                       collective_calls=dict(Counter(mesh.calls) - calls),
                       collective_bytes=dict(Counter(mesh.bytes) - bytes_))
        records.append(rec)
    return RecsysResult(outputs, records)


def _main_recsys(args, spec, device: torch.device) -> RecsysResult:
    cfg: dlrm.DLRMConfig = spec.smoke if args.smoke else spec.config
    shape = spec.shape(args.shape)
    if args.smoke:  # the smoke cell's sizes (repro/launch/steps.py _dlrm_cell)
        shape = dataclasses.replace(shape, batch=min(shape.batch, 64),
                                    n_candidates=min(shape.n_candidates, 1024))
    params = dlrm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    res = serve_recsys(cfg, params, shape, args.requests, use_kernels=device.type == "cuda",
                       device=device)
    for r in res.records:
        print(json.dumps(r), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="minicpm3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--shape", default="serve_p99",
                    help="recsys: serve_p99, serve_bulk or retrieval_cand")
    ap.add_argument("--requests", type=int, default=2, help="recsys: requests to answer")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=0, help="chunked prefill of this many tokens")
    ap.add_argument("--absorbed", action="store_true", help="MLA absorbed decode")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU; pass --device cpu for the "
                           "plain versions")
    spec = get_arch(args.arch)
    if spec.family == "recsys":
        return _main_recsys(args, spec, device)
    cfg: tf.TransformerConfig = spec.smoke if args.smoke else spec.config
    if args.absorbed and cfg.attn == "mla":
        cfg = dataclasses.replace(cfg, decode_absorbed=True)
    params = tf.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    prompt = torch.from_numpy(prompt_tokens(cfg.vocab, args.batch, args.prompt_len)).to(device)
    res = serve(cfg, params, prompt, args.gen, use_kernels=device.type == "cuda",
                chunk=args.chunk)
    for r in res.records:
        print(json.dumps(r), flush=True)
    print("generated ids:\n", res.ids.cpu().numpy(), flush=True)
    return res


if __name__ == "__main__":
    main()
