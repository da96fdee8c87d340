"""Parity of the port's serving path with the JAX reference.

Pairs: ``repro_torch.serving.engine`` vs ``repro.serving.engine`` (greedy
tokens of ``ServeEngine`` on four families, and the broker tenancy's
totals) and ``repro_torch.launch.serve`` vs ``repro.launch.serve``. Both
packages serve the reduced configurations in float32 with the reference's
weights carried into the port (``model_params_from_numpy``). The tokens
must be identical; so that no near-tie decides that by chance, every
greedy choice the reference makes for an active request must win by a
top-2 logit margin above 1e-3 (recorded through a ``jnp.argmax`` that
reports its margins). Prompts are 4-16 tokens: the reduced SSD chunk is 16,
and a longer prompt that is no whole number of chunks stops both packages
(``test_launcher_mirrors_the_references_chunk_failure``).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import get_config as rget
from repro.models import build_model as rbuild
from repro.offload import OffloadEngine as ROffloadEngine
from repro.serving import engine as rserve
from repro.sharding.specs import Topology as RTopology

from repro_torch.configs import get_config as pget
from repro_torch.core.packet import CollectiveDescriptor
from repro_torch.interop import model_params_from_numpy
from repro_torch.models import build_model as pbuild
from repro_torch.offload import OffloadEngine
from repro_torch.service import DescriptorBroker
from repro_torch.serving import Request, ServeEngine
from repro_torch.sharding import Topology

SRC = Path(__file__).resolve().parents[1] / "src"
MARGIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # tiny ops: threads only contend with the other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=int(rng.integers(4, 17))).astype(np.int32)
            for _ in range(n)]


def _reference_run(arch, prompts, monkeypatch, max_new=10):
    """The reference engine's tokens; asserts every greedy choice for an
    active request beats the runner-up by MARGIN."""
    rc = rget(arch).reduced()
    api = rbuild(rc)
    params = jax.jit(api.init)(jax.random.key(0))
    margins = []
    argmax = jnp.argmax

    def recording_argmax(x, axis=None, **kw):
        top2 = lax.top_k(x, 2)[0]
        jax.debug.callback(lambda m: margins.append(np.asarray(m)),
                           top2[..., 0] - top2[..., 1])
        return argmax(x, axis=axis, **kw)

    monkeypatch.setattr(jnp, "argmax", recording_argmax)
    eng = rserve.ServeEngine(api, params, RTopology(mesh=None), batch_size=4,
                             max_len=64)
    reqs = [rserve.Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots):
        before = len(margins)
        eng._admit()
        for m in margins[before:]:          # the prefills' first tokens
            assert m.shape == (1,) and float(m[0]) > MARGIN, (arch, steps, m)
        active = [s for s in range(eng.B) if eng.slots[s] is not None]
        eng.step()
        decode = margins[-1].reshape(-1)
        assert decode.shape == (4,)
        assert (decode[active] > MARGIN).all(), (arch, steps, decode, active)
        steps += 1
    monkeypatch.setattr(jnp, "argmax", argmax)
    return params, [r.generated for r in reqs], steps


# the prompt seed of each arch: one whose run has no near-tie (the reduced
# Mamba2's tied-embedding logits are small, and prompt seeds 0-7 each meet
# a top-2 margin under 1e-3 somewhere in the run)
@pytest.mark.parametrize("arch,seed", [("smollm-360m", 0), ("mamba2-130m", 8),
                                       ("olmoe-1b-7b", 0), ("jamba-v0.1-52b", 0)])
def test_greedy_tokens_match_the_reference(arch, seed, monkeypatch):
    rc, pc = rget(arch).reduced(), pget(arch).reduced()
    prompts = _prompts(rc.vocab_size, seed=seed)
    params, want, steps = _reference_run(arch, prompts, monkeypatch)
    module = model_params_from_numpy(jax.tree.map(np.asarray, params), pc, "cpu")
    if pc.moe_num_experts:
        # torch.topk and lax.top_k may order tied probabilities differently:
        # hold that no router call of this run comes within 1e-6 of a tie
        # at the k-th place
        from repro_torch.models import moe

        router = moe._router

        def untied(logits, k):
            probs = torch.softmax(logits, dim=-1)
            top = torch.topk(probs, k + 1, dim=-1).values
            assert bool((top[:, k - 1] - top[:, k] > 1e-6).all())
            return router(logits, k)

        monkeypatch.setattr(moe, "_router", untied)
    eng = ServeEngine(pbuild(pc), module, Topology(mesh=None), batch_size=4,
                      max_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=10) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert [r.generated for r in reqs] == want
    assert all(r.done and 1 <= len(r.generated) <= 10 for r in reqs)


def test_tenancy_totals_through_the_broker():
    cfg = pget("mamba2-130m").reduced()
    api = pbuild(cfg)
    module = api.init(torch.Generator().manual_seed(0), device="cpu")
    with DescriptorBroker(OffloadEngine(device="cpu")) as broker:
        client = broker.client("serve")
        eng = ServeEngine(api, module, Topology(mesh=None), batch_size=4,
                          max_len=64, collective_client=client, device="cpu")
        desc = CollectiveDescriptor.decode(eng._stats_desc)
        assert (desc.coll_type.name, desc.axes, desc.backend, desc.chunks) == (
            "ALLREDUCE", (1, 4), "pallas", 1)
        # the same wire words the reference's engine makes for this request
        ref = ROffloadEngine().make_descriptor(
            "ALLREDUCE", axes=(1, 4), payload_bytes=12, op="sum",
            backend="pallas", chunks=1)
        assert np.array_equal(eng._stats_desc, ref.encode())
        for i, p in enumerate(_prompts(cfg.vocab_size, n=6, seed=5)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=3 + i % 4))
        host = {"service_steps": 0, "slot_steps": 0, "tokens_emitted": 0,
                "requests_finished": 0}
        while eng.queue or any(s is not None for s in eng.slots):
            eng._admit()
            active = [s for s in range(eng.B) if eng.slots[s] is not None]
            eng.step()
            host["service_steps"] += 1
            host["slot_steps"] += len(active)
            host["tokens_emitted"] += len(active)
            host["requests_finished"] += sum(eng.slots[s] is None for s in active)
        assert eng.collect_service_stats() == host
        assert host["requests_finished"] == 6
        assert eng.collect_service_stats()["service_steps"] == 0
        algos = {s.algo for s in broker.engine._cache.values()}
        assert any(a.startswith("pallas:") for a in algos), algos


def _launch(args, **env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("REPRO_OPT_", "REPRO_TORCH_OPT_"))}
    env.update(PYTHONPATH=str(SRC), **env_extra)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, timeout=300)


def test_launcher_serves_on_the_cpu():
    proc = _launch(["--arch", "smollm-360m", "--device", "cpu", "--requests", "4",
                    "--max-new", "6"])
    assert proc.returncode == 0, proc.stderr
    assert "served 4 requests / 24 tokens" in proc.stdout
    proc = _launch(["--arch", "mamba2-130m", "--device", "cpu"],
                   REPRO_TORCH_OPT_SSM_CHUNK="32")
    assert proc.returncode == 0, proc.stderr
    assert "served 8 requests / 128 tokens" in proc.stdout


def test_launcher_mirrors_the_references_chunk_failure():
    """The reference's launcher asserts on its first prompt (21 tokens, a
    chunk of 16): the port's raises ValueError there."""
    proc = _launch(["--arch", "mamba2-130m", "--device", "cpu"])
    assert proc.returncode != 0
    assert "ValueError: (21, 16)" in proc.stderr


def test_entry_points_default_to_the_card(monkeypatch):
    """No device named and no card: an error, never the CPU."""
    cfg = pget("smollm-360m").reduced()
    api = pbuild(cfg)
    module = api.init(torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(api, module, Topology(mesh=None))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init_cache(2, 8)
    with pytest.raises(ValueError, match="lives on"):
        ServeEngine(api, module, Topology(mesh=None), device="meta")


def test_prompt_longer_than_the_cache_raises():
    cfg = pget("smollm-360m").reduced()
    api = pbuild(cfg)
    module = api.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(api, module, Topology(mesh=None), batch_size=2, max_len=8,
                      device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(2, 14, dtype=np.int32)))
    with pytest.raises(ValueError, match="longer than the decode cache"):
        eng.step()
