"""Where the port's bfloat16 MoE serving parts from JAX's, seed by seed.

    PYTHONPATH=src python tests/moe_bf16_sweep.py [--seeds 0-9]

On the CPU, for each seed and each MoE smoke configuration of
``test_torch_mla_moe`` (granite-moe-3b-a800m; deepseek-v2-lite-16b with
its materialized and its absorbed decode), in bfloat16: the port's
``prefill`` and three ``decode_step`` s, recording its routing decisions;
JAX's, taking those decisions; and the port in float32 on the same
parameters (the bfloat16 values), taking them too (the test's
``_bf16_moe_runs``; the absorbed decode's prefill is the materialized
one). Prints one line:

- ``flips``: routing decisions JAX would take otherwise, and the largest
  margin of either view, in bfloat16 spacings of the row's largest |logit|;
  ``f32 flips``: the same for the float32 run;
- ``port / jax vs f32``: each package's largest gap to the float32 logits
  of the same decisions, over the largest |float32 logit| (at least 1), any
  step, and the first over the second; ``port vs jax``: the two packages'
  largest gap, over JAX's;
- ``cache``: the same three for the latent or KV caches.

The tests ``test_moe_bf16_matches_jax_on_the_ports_decisions`` (granite)
and ``test_mla_prefill_and_decode_match_jax`` (deepseek, bfloat16) hold
seeds 7 and 1.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import torch  # noqa: E402

import test_torch_mla_moe as T  # noqa: E402

CASES = (("granite-moe-3b-a800m", False), ("deepseek-v2-lite-16b", False),
         ("deepseek-v2-lite-16b", True))


def sweep(arch: str, absorbed: bool, seed: int, mp: pytest.MonkeyPatch) -> str:
    (logs, cache), (jlogs, jcache), (flogs, fcache), flips, f32_flips = T._bf16_moe_runs(
        arch, seed, mp, decode_absorbed=absorbed)
    logit = [max(T._gap(a, f) for a, f in zip(logs, flogs)),
             max(T._gap(b, f) for b, f in zip(jlogs, flogs)),
             max(T._gap(a, b) for a, b in zip(logs, jlogs))]
    pairs = [(cache[g][i], jcache[g][i], fcache[g][i]) for g in cache for i in range(2)]
    caches = [max(T._gap(a, f) for a, _, f in pairs), max(T._gap(b, f) for _, b, f in pairs),
              max(T._gap(a, b) for a, b, _ in pairs)]
    name = f"{arch.split('-')[0]}{' absorbed' if absorbed else ''}"
    return (f"{name:17s} seed {seed:2d}  flips {len(flips):2d} within "
            f"{T._tie_spacings(flips):4.1f}  f32 flips {len(f32_flips):2d} within "
            f"{T._tie_spacings(f32_flips):4.1f}  port / jax vs f32 {logit[0]:.4f} / "
            f"{logit[1]:.4f} = {logit[0] / logit[1]:.2f}  port vs jax {logit[2]:.4f}  "
            f"cache {caches[0]:.4f} / {caches[1]:.4f} / {caches[2]:.4f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-9", help="a range lo-hi, both included")
    lo, hi = (int(v) for v in ap.parse_args().seeds.split("-"))
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for arch, absorbed in CASES:
            for seed in range(lo, hi + 1):
                print(sweep(arch, absorbed, seed, mp), flush=True)


if __name__ == "__main__":
    main()
