"""Quickstart on the PyTorch port's host engine: list subgraphs, apply a
dynamic update, inspect the plan (the twin of ``examples/quickstart.py``,
printing the same lines; NumPy only, no device).

    PYTHONPATH=src python examples/torch_quickstart.py
"""

from repro_torch.core import DDSL
from repro_torch.core.pattern import PATTERN_LIBRARY
from repro_torch.data.graphs import rmat_graph, sample_update


def main() -> None:
    # A power-law data graph (R-MAT) and the paper's "house" pattern.
    graph = rmat_graph(10, 6000, seed=0)
    pattern = PATTERN_LIBRARY["q5_house"]
    print(f"data graph: n={graph.n} m={graph.num_edges}")

    engine = DDSL(graph, pattern, m=4)
    print("chosen cover:", engine.cover)
    print("symmetry-breaking order:", engine.ord_)
    print("optimal join tree:\n" + engine.tree.describe())

    engine.initial()
    print(f"\ninitial |M(p, d)| = {engine.count()}")

    update = sample_update(engine.graph, n_delete=20, n_add=20, seed=1)
    rep = engine.apply(update)
    print(f"after update (+20/-20 edges): |M(p, d')| = {engine.count()}")
    print(f"  patch matches: {rep.nav.patch_matches}, "
          f"navigated ints: {rep.nav.shipped_ints}, "
          f"storage edges moved: ±{rep.storage.edges_removed}/{rep.storage.edges_added}")


if __name__ == "__main__":
    main()
