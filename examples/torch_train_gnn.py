"""Train a GNN of the PyTorch/CUDA port on a synthetic graph (full-batch):
the loss must fall. Twin of examples/train_gnn.py.

    PYTHONPATH=src python examples/torch_train_gnn.py --arch gatedgcn --steps 30
    PYTHONPATH=src python examples/torch_train_gnn.py --device cpu   # plain versions

The smoke configuration of ``--arch`` on 128 nodes and 512 edges, labels
the degree bucket of each node, AdamW at 3e-3. On the card every segment
sum and every gather's backward runs the ``segment_sum`` CUDA kernel;
``--device cpu`` runs their plain PyTorch versions. Without a card the
default device raises.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import graph_from_numpy  # noqa: E402
from repro_torch.data import build_graph_data  # noqa: E402
from repro_torch.launch.steps import gnn_train_step  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gatedgcn")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu' "
                         "(the kernels' plain versions)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")

    cfg = get_arch(args.arch).smoke
    raw = build_graph_data(n_nodes=128, n_edges=512, d_feat=cfg.d_in, d_edge=cfg.d_edge_in,
                           seed=0, geometric=True)
    g = gnn.train_graph(graph_from_numpy(raw, dev), cfg)
    # teach it a simple structural signal: label = degree bucket
    deg = np.bincount(raw["dst"][raw["edge_mask"]], minlength=128)
    labels = torch.from_numpy(
        (np.minimum(deg, cfg.d_out - 1) if cfg.d_out > 1 else deg).astype(np.int32)).to(dev)

    params = gnn.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params)
    first = None
    for i in range(args.steps):
        params, opt, loss, _ = gnn_train_step(params, opt, g, labels, cfg, lr=3e-3,
                                              use_kernels=dev.type == "cuda")
        if first is None:
            first = float(loss)
        if i % 5 == 0:
            print(f"step {i}: loss={float(loss):.4f}")
    print(f"loss {first:.4f} → {float(loss):.4f}")
    assert float(loss) < first, "training did not reduce the loss"


if __name__ == "__main__":
    main()
