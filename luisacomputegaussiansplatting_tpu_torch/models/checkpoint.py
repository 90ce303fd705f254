"""Training checkpoints as .npz files (port of ``models/checkpoint.py``;
the port has no orbax).

A tree is flattened in ``jax.tree.flatten``'s leaf order: tuples, lists and
NamedTuples by position, dicts by sorted key, ``None`` gives no leaf, and
tensors, numpy arrays and Python scalars are leaves, saved as
``leaf_0``, ``leaf_1``, ... So an npz of ``(GaussianParams, DensifyState,
step)`` written by either package restores in the other.

A ``torch.optim.Optimizer`` (the trainer's Adam, ``ops/adam.py``, keeps
``torch.optim.Adam``'s state) is a node of the port's own: group by group
and parameter by parameter, in order, the three leaves ``step``,
``exp_avg`` and ``exp_avg_sq`` of Adam's state (zeros before the first
step). They are not laid out as optax's state and are not read across
packages. Loading writes them into the ``like`` optimizer's state, and
every tensor leaf into the ``like`` tensor in place.
"""

from __future__ import annotations

import numbers
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

_ADAM_KEYS = ("step", "exp_avg", "exp_avg_sq")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _adam_leaves(opt: torch.optim.Optimizer):
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p, {})
            yield st.get("step", torch.tensor(0.0))
            for key in _ADAM_KEYS[1:]:
                yield st[key] if key in st else torch.zeros_like(p)


def _flatten(tree, out):
    if tree is None:
        return
    if isinstance(tree, torch.optim.Optimizer):
        out.extend(_adam_leaves(tree))
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _flatten(x, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    else:
        out.append(tree)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _restore_leaf(like, arr: np.ndarray):
    if isinstance(like, torch.Tensor):
        if tuple(like.shape) != arr.shape:
            raise ValueError(f"leaf of shape {arr.shape} into a tensor of "
                             f"shape {tuple(like.shape)}")
        with torch.no_grad():
            like.copy_(torch.from_numpy(arr))
        return like
    if isinstance(like, np.ndarray):
        return arr
    if isinstance(like, (numbers.Number, np.generic)):
        return type(like)(arr.item())
    raise TypeError(f"cannot restore a leaf like {type(like).__name__}")


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` (numpy arrays)."""
    if like is None:
        return None
    if isinstance(like, torch.optim.Optimizer):
        with torch.no_grad():
            for group in like.param_groups:
                for p in group["params"]:
                    st = like.state[p]
                    for key, arr in zip(_ADAM_KEYS, leaves):
                        old = st.get(key)
                        if key == "step":
                            st[key] = torch.tensor(
                                arr, dtype=torch.float32,
                                device=old.device if old is not None else "cpu")
                        else:
                            st[key] = torch.from_numpy(arr).to(p.device)
        return like
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        restored = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: restored[k] for k in like}
    return _restore_leaf(like, next(leaves))


def save_npz(path: str, tree: Any) -> None:
    """Save a tree of tensors, arrays and scalars as an .npz (leaf order:
    the module docstring's). The file appears whole or not at all."""
    leaves = []
    _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)  # writes tmp + ".npz"
    os.replace(tmp + ".npz", path)


def load_npz(path: str, like: Any) -> Any:
    """Restore a tree saved by ``save_npz`` (by either package) into
    ``like``, which gives the structure: each tensor of ``like`` is
    overwritten in place (as ``load_state_dict`` does, so parameters stay
    the tensors an optimizer of ``like`` holds) and returned, an array
    leaf comes back as an array, a scalar as a scalar of ``like``'s type.
    """
    n = []
    _flatten(like, n)
    with np.load(path) as data:
        if len(data.files) != len(n):
            raise ValueError(f"{path}: {len(data.files)} leaves, the tree "
                             f"has {len(n)}")
        arrays = [data[f"leaf_{i}"] for i in range(len(n))]
    return _unflatten(like, iter(arrays))


class CheckpointManager:
    """Rolling training checkpoints ``ckpt_<step:08d>.npz`` under a
    directory; the newest ``max_to_keep`` are kept. The stored tree is
    whatever the trainer passes, typically (TrainState, the optimizer,
    DensifyState, step)."""

    _CKPT_RE = re.compile(r"ckpt_(\d{8})\.npz")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    def _kept_steps(self):
        """Steps of the complete checkpoints; a crash between ``np.savez``
        and ``os.replace`` leaves ``ckpt_*.npz.tmp.npz``, which is never
        matched and is removed here."""
        steps = []
        for name in os.listdir(self.directory):
            m = self._CKPT_RE.fullmatch(name)
            if m:
                steps.append(int(m.group(1)))
            elif name.startswith("ckpt_") and name.endswith(".tmp.npz"):
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass  # another process removed it first
        return sorted(steps)

    def save(self, step: int, tree: Any) -> None:
        save_npz(self._path(step), tree)
        for stale in self._kept_steps()[: -self.max_to_keep]:
            os.remove(self._path(stale))

    def latest_step(self) -> Optional[int]:
        kept = self._kept_steps()
        return kept[-1] if kept else None

    def restore(self, step: int, like: Any) -> Any:
        return load_npz(self._path(step), like)

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)
