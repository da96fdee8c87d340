"""Shared pieces of the model parity tests (``test_torch_models.py`` and
``test_torch_model_layers.py``): the reference's reduced params with the
port's module holding them, seeded inputs, the tolerance check, one torch
thread a module, and the router's tie guard."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as rget
from repro.models import build_model as rbuild

from repro_torch.configs import get_config as pget
from repro_torch.interop import model_params_from_numpy

REL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny ops: threads only contend with the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got.detach().float().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(reference cfg, port cfg, reference params, port module)."""
    rc, pc = rget(arch).reduced(), pget(arch).reduced()
    params = jax.jit(rbuild(rc).init)(jax.random.key(0))
    module = model_params_from_numpy(jax.tree.map(np.asarray, params), pc, "cpu")
    return rc, pc, params, module


def _batch(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
        b["positions3"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, :, None], (B, S, 3)).copy()
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _first(out):
    return out[0] if isinstance(out, tuple) else out


@pytest.fixture
def untied_router(monkeypatch):
    """torch.topk and lax.top_k may order tied probabilities differently:
    every router call of the test must separate its k-th and (k+1)-th
    expert by more than 1e-6."""
    from repro_torch.models import moe

    router = moe._router

    def untied(logits, k):
        top = torch.topk(torch.softmax(logits, dim=-1), k + 1, dim=-1).values
        assert bool((top[..., k - 1] - top[..., k] > 1e-6).all())
        return router(logits, k)

    monkeypatch.setattr(moe, "_router", untied)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _ssd_inputs(rng, B=2, S=32, H=4, P=8, N=6):
    xs, Bc, Cc = _rand(rng, B, S, H, P), _rand(rng, B, S, N), _rand(rng, B, S, N)
    dt = np.log1p(np.exp(_rand(rng, B, S, H))).astype(np.float32)
    dA = (-dt * np.linspace(1.0, 4.0, H, dtype=np.float32)).astype(np.float32)
    return xs, Bc, Cc, dA, dt
