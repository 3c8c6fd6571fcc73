"""Train a small LM of the PyTorch/CUDA port end to end with checkpoint /
restart. Twin of examples/train_lm.py: a thin wrapper over the driver
``python -m repro_torch.launch.train`` at smoke scale.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu   # plain versions
    PYTHONPATH=src python examples/torch_train_lm.py --arch minicpm3-4b   # MLA (or
        # granite-moe-3b-a800m, MoE; deepseek-v2-lite-16b, both)

Without a card the default device raises.
"""

import argparse
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", args.arch, "--steps", str(args.steps),
        "--smoke", "--batch", "8", "--seq", "64", "--device", args.device,
        "--ckpt-dir", os.path.join(tempfile.gettempdir(), f"repro_torch_lm_ckpt_{args.arch}"),
    ]
    path = os.pathsep.join(p for p in (SRC, os.environ.get("PYTHONPATH")) if p)
    raise SystemExit(subprocess.call(cmd, env=dict(os.environ, PYTHONPATH=path)))


if __name__ == "__main__":
    main()
