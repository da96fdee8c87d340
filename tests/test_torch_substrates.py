"""Data pipeline, optimizer, checkpoints and gradient compression of the
port against the reference (``tests/test_substrates.py`` mirrored).

Pairs: ``repro_torch.data.pipeline`` vs ``repro.data.pipeline`` (bitwise:
the same numpy code); ``repro_torch.optim.adamw`` vs ``repro.optim.adamw``
(``adamw_update`` on the same gradients, ``lr_at``: float32, within 1e-6
of each leaf's largest magnitude; the two sum the global norm in different
leaf orders); ``repro_torch.optim.compression`` vs
``repro.optim.compression`` (int8 codes and scales bitwise: both round half
to even); ``repro_torch.checkpoint.manager`` on its own (roundtrip, keep-k
GC, async writes, ``.tmp`` ignored, bf16 bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as RD
from repro.optim import adamw as RA
from repro.optim import compression as RC

from torch_model_helpers import _one_thread  # noqa: F401

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import pipeline as PD
from repro_torch.optim import adamw as PA
from repro_torch.optim import compression as PC

REL = 1e-6


# ------------------------------------------------------------------- data
def test_pack_documents_offsets():
    docs = [np.arange(2, 7, dtype=np.int32), np.arange(10, 13, dtype=np.int32)]
    packed, seg = PD.pack_documents(docs, seq_len=4, pad_id=0)
    flat = packed.reshape(-1)
    assert list(flat[:5]) == [2, 3, 4, 5, 6]
    assert list(flat[5:8]) == [10, 11, 12]
    assert (seg.reshape(-1)[:5] == 1).all()
    assert (seg.reshape(-1)[5:8] == 2).all()
    rp, rs = RD.pack_documents(docs, seq_len=4, pad_id=0)
    assert np.array_equal(packed, rp) and np.array_equal(seg, rs)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=1000, seq_len=64, global_batch=8, seed=7),
    dict(vocab_size=1000, seq_len=64, global_batch=8, seed=7, host_id=1,
         host_count=2),
    dict(vocab_size=50280, seq_len=1024, global_batch=8, seed=0),
    dict(vocab_size=256, seq_len=32, global_batch=4, seed=3, mean_doc_len=16),
])
def test_batches_bitwise_the_references(kw):
    got, want = PD.batches(PD.DataConfig(**kw)), RD.batches(RD.DataConfig(**kw))
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])


def test_batches_deterministic_and_sharded():
    cfg = PD.DataConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=7)
    b1 = next(PD.batches(cfg))
    b2 = next(PD.batches(cfg))
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (8, 64)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    cfg2 = PD.DataConfig(vocab_size=1000, seq_len=64, global_batch=8, seed=7,
                         host_id=1, host_count=2)
    b3 = next(PD.batches(cfg2))
    assert b3["tokens"].shape == (4, 64)
    assert not np.array_equal(b1["tokens"][:4], b3["tokens"])


# -------------------------------------------------------------- optimizer
def _rand_tree(rng, shapes):
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _close(got, want, what):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    assert float(np.abs(got - want).max()) <= REL * scale, what


@pytest.mark.parametrize("cfg", [
    RA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10),
    RA.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=5, clip_norm=0.5),
])
def test_adamw_update_matches_the_reference(cfg):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    params = _rand_tree(rng, shapes)
    r_params = {k: jnp.asarray(v) for k, v in params.items()}
    r_opt = RA.init_opt_state(r_params)
    p_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    p_opt = PA.init_opt_state(p_params)
    pcfg = PA.AdamWConfig(**cfg._asdict())
    for _ in range(4):
        grads = _rand_tree(rng, shapes)
        r_params, r_opt, r_stats = RA.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, r_opt, r_params, cfg)
        _, p_opt, p_stats = PA.adamw_update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, p_opt,
            p_params, pcfg)
        for k in shapes:
            _close(p_params[k], r_params[k], f"param {k}")
            for part in ("m", "v", "master"):
                _close(p_opt[part][k], r_opt[part][k], f"{part} {k}")
        assert int(p_opt["count"]) == int(r_opt["count"])
        _close(p_stats["grad_norm"], r_stats["grad_norm"], "grad_norm")
        _close(p_stats["lr"], r_stats["lr"], "lr")


def test_adamw_updates_a_module_in_place_and_casts():
    lin = torch.nn.Linear(3, 2).to(torch.bfloat16)
    opt = PA.init_opt_state(lin)
    assert opt["master"]["weight"].dtype == torch.float32
    assert opt["master"]["weight"].data_ptr() != lin.weight.data_ptr()
    w = lin.weight
    grads = {n: torch.ones_like(p) for n, p in lin.named_parameters()}
    out, opt, _ = PA.adamw_update(grads, opt, lin, PA.AdamWConfig(warmup_steps=0))
    assert out is lin and lin.weight is w and w.dtype == torch.bfloat16
    assert torch.equal(w, opt["master"]["weight"].to(torch.bfloat16))


def test_adamw_converges_quadratic():
    cfg = PA.AdamWConfig(lr=0.1, warmup_steps=5, total_steps=200,
                         weight_decay=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3, requires_grad=True)}
    opt = PA.init_opt_state(params)
    for _ in range(150):
        loss = torch.sum((params["w"] - target) ** 2)
        (g,) = torch.autograd.grad(loss, params["w"])
        params, opt, stats = PA.adamw_update({"w": g}, opt, params, cfg)
    assert float(torch.sum((params["w"].detach() - target) ** 2)) < 1e-2
    assert np.isfinite(float(stats["grad_norm"]))


def test_lr_schedule_matches_the_reference():
    cfg = RA.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                         min_lr_ratio=0.1)
    pcfg = PA.AdamWConfig(**cfg._asdict())
    lrs = [float(PA.lr_at(torch.tensor(s), pcfg)) for s in range(0, 111)]
    want = [float(RA.lr_at(jnp.asarray(s), cfg)) for s in range(0, 111)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=0)
    assert lrs[0] == 0.0
    assert abs(lrs[10] - 1e-3) < 1e-9          # peak at warmup end
    assert lrs[100] <= lrs[10]
    assert lrs[100] >= 0.1 * 1e-3 - 1e-12      # floor


def test_grad_clipping_applied():
    cfg = PA.AdamWConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    opt = PA.init_opt_state(params)
    huge = {"w": torch.full((4,), 1e6)}
    _, new, stats = PA.adamw_update(huge, opt, params, cfg)
    assert float(stats["grad_norm"]) > 1e5  # raw norm reported pre-clip
    # the moment takes the clipped gradient: (1 - b1) * 1e6 * (1 / 2e6)
    assert torch.allclose(new["m"]["w"], torch.full((4,), 0.1 * 0.5))


# ------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)}}
    for step in (1, 2, 3, 4):
        mgr.save(step, {"a": tree["a"] + step, "b": {"c": tree["b"]["c"] + step}})
    assert mgr.all_steps() == [3, 4]  # keep=2 GC'd older
    step, restored = mgr.restore(tree)
    assert step == 4
    assert torch.equal(restored["a"], tree["a"] + 4)
    assert restored["b"]["c"].dtype == torch.int32


def test_checkpoint_async_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    tree = {"w": torch.ones((16, 16))}
    mgr.save(10, tree)
    tree["w"].zero_()  # the save copied to the host before returning
    mgr.wait()
    step, restored = mgr.restore(tree)
    assert step == 10 and torch.equal(restored["w"], torch.ones(16, 16))


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, {"w": torch.ones(3)})
    # a crashed partial write leaves only .tmp — must be invisible
    (tmp_path / ".tmp_step_9").mkdir()
    assert mgr.latest_step() == 5


def test_checkpoint_bf16_names_and_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.randn(5, generator=torch.Generator().manual_seed(0)).bfloat16()
    mgr.save(1, {"params": {"blocks.0.w": w}, "opt": {"count": torch.tensor(3)}})
    _, back = mgr.restore({"params": {"blocks.0.w": torch.zeros_like(w)},
                           "opt": {"count": torch.tensor(0)}})
    assert torch.equal(back["params"]["blocks.0.w"].view(torch.int16),
                       w.view(torch.int16))
    with pytest.raises(ValueError, match="missing"):
        mgr.restore({"params": {"blocks.1.w": w}, "opt": {"count": 0}})


# ------------------------------------------------------------ compression
@pytest.mark.parametrize("seed,scale", [(0, 1e-3), (1, 1.0), (2, 37.5),
                                        (3, 1e3), (4, 0.5)])
def test_quantize_matches_the_reference(seed, scale):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64,)) * scale).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]  # halves: both round to even
    q, s = PC.quantize_int8(torch.from_numpy(x))
    rq, rs = RC.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)
    err = (PC.dequantize_int8(q, s) - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(np.abs(x).max()) / 127.0 + 1e-6


def test_error_feedback_preserves_signal():
    g = {"w": torch.tensor([0.001, 0.5, -0.3])}
    err, sent = None, torch.zeros(3)
    rg, rerr = {"w": jnp.asarray([0.001, 0.5, -0.3])}, None
    for _ in range(64):
        q, s, err = PC.compress_with_feedback(g, err)
        rq, rs, rerr = RC.compress_with_feedback(rg, rerr)
        assert np.array_equal(q["w"].numpy(), np.asarray(rq["w"]))
        sent += PC.dequantize_int8(q["w"], s["w"])
    np.testing.assert_allclose(sent.numpy() / 64, g["w"].numpy(), atol=2e-3)


def test_compressed_allreduce_mean_in_a_region():
    """Each rank row quantized on its own; the mean of the dequantized
    rows, and each row's residual."""
    from repro_torch import compat
    from repro_torch.compat import P

    mesh = compat.Mesh((4,), ("dp",), device="cpu")
    g = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))

    def body(gl):
        mean, err = PC.compressed_allreduce_mean({"w": gl}, "dp")
        return mean["w"], err["w"]

    mean, err = compat.block_shard_map(body, mesh, in_specs=(P("dp"),),
                                       out_specs=(P(), P("dp")))(g)
    deq = []
    for r in range(4):
        q, s = PC.quantize_int8(g[r])
        deq.append(PC.dequantize_int8(q, s))
        assert torch.equal(err[r], g[r] - deq[-1])
    assert torch.allclose(mean[0], sum(deq) / 4, atol=1e-7)


def test_compressed_dp_check_on_the_cpu():
    from repro_torch.testing import compressed_dp_check

    assert compressed_dp_check.main(["--device", "cpu"]) == 0
