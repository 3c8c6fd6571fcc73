"""Fault-tolerant checkpointing (copy of ``repro/checkpoint/checkpoint.py``).

- a tree (dicts of tensors and the optimizer's
  :class:`~repro_torch.optim.AdamWState`) flattens to path-keyed arrays in
  one ``.npz`` per step, with the JAX package's keys: dict keys, and the
  index of an ``AdamWState``'s child (``step``, ``mu``, ``nu`` are 0, 1,
  2, the order of its ``tree_flatten``), joined by ``/``;
  a bfloat16 leaf is stored as its uint16 bits under ``<key>::bf16``. So a
  file written by either package restores in the other;
- writes are **atomic** (tmp file + rename) so a crash mid-save never
  corrupts the latest checkpoint;
- :class:`CheckpointManager` keeps the last ``keep`` steps and restores
  the newest intact one (a torn file falls back to the previous step);
- restore puts the leaves on a ``device`` in place of JAX's shardings.
"""

from __future__ import annotations

import os
import re
import tempfile
import zipfile
from typing import Dict, Optional

import numpy as np
import torch

from ..optim.adamw import AdamWState

__all__ = ["save_pytree", "restore_pytree", "CheckpointManager"]

_BF16 = "::bf16"


def _items(tree, prefix=()):
    """``(path, leaf)`` of every leaf in the order ``jax.tree_util`` takes
    them: dict keys sorted, ``AdamWState`` children by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, AdamWState):
        for i, child in enumerate((tree.step, tree.mu, tree.nu)):
            yield from _items(child, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, leaves: Dict[str, torch.Tensor], prefix=()):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(*(_rebuild(c, leaves, prefix + (str(i),))
                            for i, c in enumerate((tree.step, tree.mu, tree.nu))))
    return leaves["/".join(prefix)]


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:  # npz has no bfloat16: its bits as uint16
            flat[key + _BF16] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat


def save_pytree(tree, path: str) -> None:
    """Write ``tree`` to ``path`` as one ``.npz``, atomically."""
    flat = _flatten(tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def restore_pytree(template, path: str, device=None):
    """Restore into the structure of ``template`` (arrays by path key),
    each leaf in its template leaf's type, on ``device`` (default: the
    template leaf's). Raises ``KeyError`` for a missing leaf and
    ``ValueError`` for a shape that differs from the template's."""
    with np.load(path) as data:
        flat = {}
        for k in data.files:
            if k.endswith(_BF16):
                bits = np.array(data[k]).view(np.int16)
                flat[k[:-len(_BF16)]] = torch.from_numpy(bits).view(torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(np.array(data[k]))
    leaves = {}
    for key, leaf in _items(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = flat[key]
        leaf = torch.as_tensor(leaf)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != template {tuple(leaf.shape)}")
        leaves[key] = t.to(device=device if device is not None else leaf.device,
                           dtype=leaf.dtype)
    return _rebuild(template, leaves)


class CheckpointManager:
    """Keep-last-k manager with crash-safe latest-step discovery."""

    _PAT = re.compile(r"step_(\d+)\.npz$")

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _steps(self):
        out = []
        for f in os.listdir(self.dir):
            m = self._PAT.match(f)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}.npz")

    def save(self, step: int, tree) -> str:
        """Save ``tree`` as ``step`` and delete all but the last ``keep``."""
        p = self.path(step)
        save_pytree(tree, p)
        for s in self._steps()[: -self.keep]:
            try:
                os.unlink(self.path(s))
            except OSError:
                pass
        return p

    def restore_latest(self, template, device=None):
        """``(step, tree)`` of the newest intact checkpoint, or ``(None,
        None)``; a file that does not read back (torn, truncated, or
        missing a leaf) falls back to the step before it."""
        for step in reversed(self._steps()):
            try:
                return step, restore_pytree(template, self.path(step), device)
            except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile):
                continue
        return None, None
