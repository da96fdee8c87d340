"""State that crosses between the JAX reference and the PyTorch port.

What crosses is

* descriptor words, which :class:`repro_torch.core.packet.
  CollectiveDescriptor.decode` reads directly (the wire format is shared);
* payload pytrees: single arrays, the SSD ``(a, b)`` and the flash
  ``(m, l, o)`` tuples, as numpy arrays on one side and tensors on the other;
* model weights: the reference's ``init_lm`` / ``init_encdec`` pytree as
  numpy arrays, loaded into the port's module by
  :func:`model_params_from_numpy` (trainable on request), and the
  reference's AdamW state by :func:`opt_state_from_numpy`. The models run from seeded random
  initialisation; carrying one package's weights into the other is how the
  parity tests hold the two to the same function.

bfloat16 has no numpy dtype of its own; on the numpy side it is the
``ml_dtypes`` bfloat16 the JAX package uses, carried across bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core.trees import tree_map

PyTree = Any


def _tensor_from_numpy(a: np.ndarray, device: "torch.device | str") -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def payload_from_numpy(tree: PyTree, device: "torch.device | str") -> PyTree:
    """numpy payload pytree -> tensors on ``device`` (values bit for bit)."""
    return tree_map(lambda a: _tensor_from_numpy(np.asarray(a), device), tree)


def payload_to_numpy(tree: PyTree) -> PyTree:
    """Tensor payload pytree -> numpy arrays on the host (bit for bit)."""
    return tree_map(_tensor_to_numpy, tree)


#: reference pytree keys whose leaves stack one module per layer (or per
#: hybrid period) along axis 0
_STACKED = ("blocks", "periods", "enc_blocks", "dec_blocks")


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (str(key),))
    else:
        yield path, tree


def _port_names(params_np: Any) -> Iterator[Tuple[str, str, Any]]:
    """(reference path, port ``state_dict`` name, numpy leaf) of every leaf
    of a reference params pytree, each stacked leaf split per layer."""
    for path, leaf in _leaves(params_np):
        name = "/".join(path)
        a = np.asarray(leaf)
        if path[0] in _STACKED:
            if a.ndim == 0:
                raise ValueError(f"{name}: a stacked leaf needs a layer axis, "
                                 f"got shape {a.shape}")
            for i in range(a.shape[0]):
                yield name, ".".join((path[0], str(i)) + path[1:]), a[i]
        else:
            yield name, ".".join(path), a


def model_params_from_numpy(params_np: Any, cfg: Any,
                            device: "torch.device | str", *,
                            trainable: bool = False) -> "torch.nn.Module":
    """The port's module for ``cfg`` holding the reference's weights.

    ``params_np`` is the reference's ``init_lm`` / ``init_encdec`` pytree
    (nested dicts) with numpy leaves: stacked ``(L, ...)`` leaves under
    ``blocks`` / ``enc_blocks`` / ``dec_blocks`` and ``(periods, ...)``
    leaves under the hybrid family's ``periods``. Each stacked leaf is split
    per layer onto ``blocks.<l>.<...>`` (``periods.<i>.sub_<j>.<...>``).
    Values cross bit for bit. A leaf the module lacks, a parameter no leaf
    fills, or a leaf whose shape or dtype differs raises ``ValueError``
    naming its path. With ``trainable`` every parameter requires grad (the
    training path's module); otherwise none does, as serving keeps them."""
    from repro_torch.models import build_model

    module = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="meta")
    want = module.state_dict()
    got: Dict[str, torch.Tensor] = {}
    for name, key, a in _port_names(params_np):
        # a writable copy: the module owns its weights
        got[key] = (name, np.array(a))
    extra = sorted({name for key, (name, _) in got.items() if key not in want})
    if extra:
        raise ValueError(f"leaves the {cfg.name} module has no parameter for: "
                         f"{extra}")
    missing = sorted(key for key in want if key not in got)
    if missing:
        raise ValueError(f"parameters of the {cfg.name} module no leaf fills: "
                         f"{missing}")
    state = {}
    for key, (name, a) in got.items():
        ref = want[key]
        t = _tensor_from_numpy(a, "cpu")
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(
                f"{name} (as {key}): shape {tuple(t.shape)} {t.dtype}, the "
                f"module wants {tuple(ref.shape)} {ref.dtype}")
        state[key] = t.to(device)
    module.load_state_dict(state, strict=True, assign=True)
    module.requires_grad_(trainable)
    return module


def opt_state_from_numpy(opt_np: Any, module: "torch.nn.Module") -> Dict[str, Any]:
    """The reference's AdamW state (``init_opt_state`` / ``adamw_update``'s:
    ``m``, ``v`` and ``master`` params pytrees of numpy arrays and
    ``count``) as the port's (:mod:`repro_torch.optim.adamw`): ``{name:
    float32 tensor}`` dicts under ``module``'s parameter names, on its
    device, and a 0-d int32 ``count``. A leaf no parameter takes, or a
    parameter no leaf fills, raises ``ValueError``."""
    params = dict(module.named_parameters())
    device = next(iter(params.values())).device
    out: Dict[str, Any] = {}
    for part in ("m", "v", "master"):
        got = {key: _tensor_from_numpy(np.array(a), device)
               for _, key, a in _port_names(opt_np[part])}
        if set(got) != set(params):
            raise ValueError(
                f"opt state {part!r}: leaves {sorted(set(got) - set(params))} "
                f"have no parameter, parameters "
                f"{sorted(set(params) - set(got))} no leaf")
        out[part] = {k: got[k] for k in params}
    out["count"] = torch.tensor(int(np.asarray(opt_np["count"])),
                                dtype=torch.int32, device=device)
    return out
