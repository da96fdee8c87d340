"""The plain references agree with the port at tiny sizes on the CPU, and
the controls (the next precision down) do not."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from portbench import bench
from portbench.conftest import TINY_MODEL
from portbench.reference import adamw as ref_adamw
from portbench.reference import mamba2 as R
from portbench.reference.scan import control_scan, reference_scan, scan_error


def tiny_config(dtype="float32"):
    bench.use_port()
    return {**bench.load_cell("mamba2-130m-train-2k").config, **TINY_MODEL, "dtype": dtype}


def test_scan_reference_against_the_engine():
    bench.use_port()
    from repro_torch import OffloadEngine

    eng = OffloadEngine(device="cpu")
    desc = eng.make_descriptor("SCAN", axes=(1, 8), payload_bytes=4096, backend="pallas",
                               chunks=1)
    x = torch.randn(8, 1024, generator=torch.Generator().manual_seed(3))
    got = eng.offload(desc.encode(), x)
    assert torch.allclose(got.double(), reference_scan(x), rtol=0, atol=1e-5)
    assert scan_error(got, x) < 1e-6
    assert scan_error(control_scan(x), x) > 1e-3
    assert scan_error(x, x) > 0.5


def test_weights_follow_the_table_and_the_seed():
    c = tiny_config("bfloat16")
    a, b = R.make_weights(c, 7, "cpu"), R.make_weights(c, 7, "cpu")
    other = R.make_weights(c, 8, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], other["embed"])
    assert a["blocks.0.mamba.A_log"].dtype == torch.float32
    assert a["embed"].dtype == torch.bfloat16
    A = torch.exp(a["blocks.0.mamba.A_log"])
    assert bool(((A >= 1) & (A <= 16)).all())
    dt = torch.nn.functional.softplus(a["blocks.1.mamba.dt_bias"])
    assert bool(((dt > 0.9e-3) & (dt < 0.11)).all())
    assert float(a["embed"].float().std()) == pytest.approx(0.02, rel=0.1)


def program(c, weights):
    family, _ = bench.family_modules("mamba2")
    return family.load_program(c, weights)


def test_reference_prefill_matches_the_port():
    c = tiny_config()
    w = R.make_weights(c, 11, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (2, 64), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    api, model = program(c, {k: v.clone() for k, v in w.items()})
    with torch.inference_mode():
        last, caches = api.prefill(model, {"tokens": tokens})
    want_last, want = R.prefill(w, tokens, c, rows=1)
    assert torch.allclose(last[:, 0], want_last, rtol=1e-4, atol=1e-4)
    for name in ("ssm", "conv_x", "conv_bc"):
        got = caches["mamba"][name]
        assert got.shape == want[name].shape
        assert float((got - want[name]).norm() / want[name].norm()) < 1e-4, name


def test_reference_loss_and_grads_match_the_port():
    bench.use_port()
    from repro_torch.launch.steps import loss_and_grads

    c = tiny_config()
    w = R.make_weights(c, 12, "cpu")
    ids = torch.randint(0, c["vocab_size"], (2, 65), generator=torch.Generator().manual_seed(2))
    tokens, labels = ids[:, :-1].int(), ids[:, 1:].int()
    api, model = program(c, {k: v.clone() for k, v in w.items()})
    loss, _, grads = loss_and_grads(api, model, {"tokens": tokens, "labels": labels})
    ref_loss, ref_grads = R.loss_and_grads(w, tokens, labels, c, rows=1)
    assert float(loss) == pytest.approx(ref_loss, rel=1e-5)
    for k, g in ref_grads.items():
        assert float((grads[k] - g).norm()) <= 1e-4 * float(g.norm()) + 1e-7, k


def test_reference_adamw_matches_the_port():
    bench.use_port()
    from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state

    c = tiny_config()
    gen = torch.Generator().manual_seed(4)
    params = {f"p{i}": torch.randn(5, 3, generator=gen) for i in range(3)}
    cfg = AdamWConfig(**c["optimizer"])
    port = {k: v.clone() for k, v in params.items()}
    state = init_opt_state(port)
    ref = ref_adamw.AdamW({k: v.clone() for k, v in params.items()}, c["optimizer"])
    for _ in range(3):
        grads = {k: torch.randn(5, 3, generator=gen) * 3 for k in params}
        port, state, _ = adamw_update(grads, state, port, cfg)
        ref.step(grads)
    for k in params:
        assert torch.allclose(state["master"][k], ref.params[k], rtol=1e-6, atol=1e-9)
        assert not torch.equal(ref.params[k], params[k])


def test_learning_rate_schedule():
    c = tiny_config()["optimizer"]
    assert ref_adamw.learning_rate(1, c) == pytest.approx(c["lr"] / c["warmup_steps"])
    assert ref_adamw.learning_rate(c["total_steps"], c) == pytest.approx(c["lr"] * c["min_lr_ratio"])


@pytest.mark.parametrize("precision, lo", [("bf16", 1e-4), ("fp8", 1e-2)])
def test_lower_precisions_move_the_reference(precision, lo):
    c = tiny_config()
    w = R.make_weights(c, 13, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (1, 32), generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    exact, _ = R.prefill(w, tokens, c)
    rough, _ = R.prefill(w, tokens, c, precision=precision)
    err = float((rough - exact).norm() / exact.norm())
    assert lo < err < 1.0 and math.isfinite(err)


def test_segsum_and_ssd_against_a_recurrence():
    gen = torch.Generator().manual_seed(6)
    b, l, h, p, n = 1, 8, 2, 3, 4
    X = torch.randn(b, l, h, p, generator=gen)
    A = -torch.rand(b, l, h, generator=gen)
    B = torch.randn(b, l, n, generator=gen)
    C = torch.randn(b, l, n, generator=gen)
    Y, final = R.ssd(X, A, B, C, Q=4, precision="f32")
    state = torch.zeros(b, h, p, n)
    for t in range(l):
        state = torch.exp(A[:, t])[..., None, None] * state + X[:, t, :, :, None] * B[:, t, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", state, C[:, t])
        assert torch.allclose(Y[:, t], y, atol=1e-5)
    assert torch.allclose(final, state, atol=1e-5)


def test_tiny_cell_keeps_the_mechanisms(tiny_cell):
    cell = tiny_cell("mamba2-130m-prefill-4k")
    w = R.widths(cell.config)
    assert w["L"] >= 2 and 64 // w["Q"] >= 2   # several layers and chunks
    assert dataclasses.asdict(bench.Check("x", 1.0, 2.0))["limit"] == 2.0
