"""Batched serving: prefill, then a greedy decode loop over a KV cache.

Twin of ``repro/launch/serve.py``. On the card (the default), with every
attention through the CUDA ``flash_attention`` kernel::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
        --batch 4 --prompt-len 8192 --gen 16 [--chunk 4096]

On the CPU, with the plain versions, at the smoke configuration::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke

Prints one JSON record per stage and the generated ids last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..models import transformer as tf

__all__ = ["ServeResult", "prompt_tokens", "serve", "main"]


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


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=0, help="chunked prefill of this many tokens")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU; pass --device cpu for the "
                           "plain versions")
    spec = get_arch(args.arch)
    cfg: tf.TransformerConfig = spec.smoke if args.smoke else spec.config
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
