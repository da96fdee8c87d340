"""Checkpoint manager: atomic, keep-k, background writes, crash-safe restore
(port of ``repro.checkpoint.manager``).

Layout:  <dir>/step_<n>/  arrays.npz + tree.json   (+ .tmp staging)
A checkpoint becomes visible only through the final atomic rename, so a
process killed mid-write never corrupts the restore path.

A tree is nested dicts (lists, tuples) of tensors or numpy arrays; each
leaf is saved as a numpy array under its path name, ``state_dict`` style
(``params.blocks.3.mamba.w_z``, ``opt.m.embed``, ``opt.count``), where the
reference saves ``leaf_<i>`` in pytree order. A bfloat16 leaf is saved as
its 16-bit pattern and comes back bit for bit. :meth:`restore`
fills the structure of ``like``: each leaf comes back in ``like``'s leaf
type, dtype and device.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def _paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf) of every leaf, in a fixed order."""
    if isinstance(tree, dict):
        out = []
        for k in tree:
            out += _paths(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _paths(v, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


def _rebuild(tree: PyTree, leaves: Dict[str, Any], prefix: str = "") -> PyTree:
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _to_numpy(x: Any) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf and the dtype it is saved for: a bfloat16
    tensor is saved as its 16-bit pattern (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy(), "bfloat16"
        return t.numpy().copy(), str(t.dtype).replace("torch.", "")
    a = np.array(x)  # a copy: the caller may overwrite its buffer
    return a, a.dtype.name


def _like(a: np.ndarray, dtype: str, ref: Any) -> Any:
    if isinstance(ref, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=ref.device, dtype=ref.dtype)
    if dtype == "bfloat16":
        a = torch.from_numpy(a).view(torch.bfloat16).float().numpy()
    if hasattr(ref, "dtype"):
        return a.astype(ref.dtype)
    return a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: PyTree, *, block: bool = False) -> None:
        # copy to the host BEFORE handing to the writer thread, so the
        # caller may update its tensors in place right away
        named = [(name, *_to_numpy(x)) for name, x in _paths(tree)]

        def write():
            tmp = self.dir / f".tmp_step_{step}"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **{
                f"leaf_{i}": a for i, (_, a, _) in enumerate(named)
            })
            (tmp / "tree.json").write_text(json.dumps({
                "step": step,
                "n_leaves": len(named),
                "names": [name for name, _, _ in named],
                "dtypes": [dt for _, _, dt in named],
            }))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic visibility
            self._gc()

        if self.async_write and not block:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: PyTree,
                step: Optional[int] = None) -> Tuple[int, PyTree]:
        """Restore into the structure of ``like``; returns (step, tree).
        A leaf ``like`` has and the checkpoint lacks (or the other way)
        raises ``ValueError`` naming it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "tree.json").read_text())
        data = np.load(d / "arrays.npz")
        saved = {name: (data[f"leaf_{i}"], dt) for i, (name, dt)
                 in enumerate(zip(meta["names"], meta["dtypes"]))}
        want = _paths(like)
        missing = sorted({n for n, _ in want} - set(saved))
        extra = sorted(set(saved) - {n for n, _ in want})
        if missing or extra:
            raise ValueError(f"checkpoint step {step} does not match the "
                             f"tree: missing {missing}, extra {extra}")
        leaves = {name: _like(*saved[name], ref) for name, ref in want}
        return step, _rebuild(like, leaves)
