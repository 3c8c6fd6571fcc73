"""Left-deep Nav-join chain order (paper §VI-B).

Host copy of ``left_deep_order`` from ``repro/core/navjoin.py``; the host
Nav-join executor itself is not ported (the device patch chains in
:mod:`repro_torch.sharded` replace it).
"""

from __future__ import annotations

from typing import List, Sequence

from .pattern import R1Unit

__all__ = ["left_deep_order"]


def left_deep_order(units: Sequence[R1Unit], first: R1Unit, cover: Sequence[int]) -> List[R1Unit]:
    """Copy of ``repro.core.navjoin.left_deep_order``: a left-deep chain from
    ``first`` with a non-empty cover join key at every step."""
    vc = set(cover)
    order = [first]
    placed = set(first.pattern.vertices)
    rest = [u for u in units if u is not first]
    while rest:
        nxt = next((u for u in rest if set(u.pattern.vertices) & placed & vc), None)
        if nxt is None:
            raise ValueError("units cannot form a connected left-deep tree under this cover")
        order.append(nxt)
        placed |= set(nxt.pattern.vertices)
        rest.remove(nxt)
    return order
