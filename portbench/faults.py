"""Faults planted in the program, for the tests and ``control.py`` only: a
benchmark run plants none. Each patches the port in this process before
the workload builds anything.

* ``unchanged``: the step returns its state unchanged (a scan returns its
  input; a training step leaves the weights and the optimizer as they were;
  a prefill returns zero states);
* ``half``: half of the batch left out (the later half of the ranks adds
  nothing to a scan; a training step's loss is the mean over the first half
  of the rows; a prefill returns zeros for the later half of the prompts);
* ``altered``: one answer altered where it is produced (one element of a
  scan's result, one logit of a prefill).
"""

from __future__ import annotations

from typing import Callable, Optional

FAULTS = ("unchanged", "half", "altered")


class _Patches:
    """Module attributes replaced, to be put back."""

    def __init__(self):
        self.saved = []

    def set(self, module, name, value):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def undo(self):
        for module, name, value in reversed(self.saved):
            setattr(module, name, value)
        self.saved = []


def _alter(tree):
    from repro_torch.core.trees import tree_leaves

    leaf = tree_leaves(tree)[0]
    flat = leaf.view(-1)
    flat[flat.numel() // 2] += 1.0
    return tree


def _scan_patches(name: str, patch: _Patches) -> None:
    from repro_torch.core.trees import tree_map
    from repro_torch.kernels import fused_collective as k1

    one = k1.comm_phase

    if name == "unchanged":
        patch.set(k1, "comm_phase", lambda kind, p, op, tree, **kw: tree)
    elif name == "half":
        def k1_half(kind, p, op, tree, **kw):
            def cut(t):
                t = t.clone()
                t[p // 2:] = 0
                return t
            return one(kind, p, op, tree_map(cut, tree), **kw)

        patch.set(k1, "comm_phase", k1_half)
    elif name == "altered":
        patch.set(k1, "comm_phase", lambda *a, **kw: _alter(one(*a, **kw)))


def _model_patches(name: str, patch: _Patches) -> None:
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import transformer as T

    prefill = T.lm_prefill
    grads = steps.loss_and_grads

    if name == "unchanged":
        patch.set(steps, "adamw_update", lambda g, opt, params, cfg: (
            params, opt, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}))

        def zero_states(model, tokens, cfg, **kw):
            last, caches = prefill(model, tokens, cfg, **kw)
            return last, {k: {n: torch.zeros_like(v) for n, v in c.items()}
                          for k, c in caches.items()}
        patch.set(T, "lm_prefill", zero_states)
    elif name == "half":
        def half_grads(api, model, batch):
            rows = batch["tokens"].shape[0] // 2
            return grads(api, model, {k: v[:rows] for k, v in batch.items()})
        patch.set(steps, "loss_and_grads", half_grads)

        def half_prefill(model, tokens, cfg, **kw):
            last, caches = prefill(model, tokens, cfg, **kw)
            rows = tokens.shape[0] // 2
            last = last.clone()
            last[rows:] = 0
            caches = {k: {n: torch.cat([v[:, :rows], torch.zeros_like(v[:, rows:])], 1)
                          for n, v in c.items()} for k, c in caches.items()}
            return last, caches
        patch.set(T, "lm_prefill", half_prefill)
    elif name == "altered":
        def altered(model, tokens, cfg, **kw):
            last, caches = prefill(model, tokens, cfg, **kw)
            last = last.clone()
            last.view(-1)[0] += 1.0
            return last, caches
        patch.set(T, "lm_prefill", altered)


def apply(name: Optional[str]) -> Callable[[], None]:
    """Plant fault ``name`` (None: none); returns what takes it out."""
    patch = _Patches()
    if not name:
        return patch.undo
    if name not in FAULTS:
        raise ValueError(f"no fault {name!r}; faults: {FAULTS}")
    _scan_patches(name, patch)
    _model_patches(name, patch)
    return patch.undo
