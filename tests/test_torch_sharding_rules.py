"""Partition-spec rules of the port against the reference
(``tests/test_sharding_rules.py`` mirrored).

Pair: ``repro_torch.sharding.rules`` vs ``repro.sharding.rules``. The
reference keys its rules on stacked pytree paths (``blocks/attn/wq`` over
``(L, ...)``); the port on per-layer ``state_dict`` names
(``blocks.3.attn.wq``). Parity: every port spec equals the reference's spec
of the same leaf without its stack axis, for every architecture, on shape
only topologies (16, 16), (8, 4) and (4, 1); ZeRO-1 equals the
reference's rule applied to the per-layer shapes; batch and decode-cache
specs are equal as they are (caches are stacked alike in both). Exact
equality throughout.
"""

import jax
import jax.numpy as jnp
import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as rget
from repro.models import build_model as rbuild
from repro.sharding import rules as RR
from repro.sharding.specs import Topology as RTopology

from repro_torch.compat import P
from repro_torch.configs import get_config as pget
from repro_torch.interop import _STACKED, _leaves
from repro_torch.models import build_model as pbuild
from repro_torch.models import input_specs
from repro_torch.configs.base import ShapeConfig
from repro_torch.sharding import rules as PR
from repro_torch.sharding.specs import Topology


class FakeMesh:
    """Shape-only stand-in so spec rules can be tested without 256 ranks
    (both packages' ``Topology`` read its sizes)."""

    def __init__(self, shape):
        self.shape = tuple(shape.values())
        self.axis_names = tuple(shape)
        self._shape = dict(shape)

    def axis(self, name):
        return self.axis_names.index(name)


class RefFakeMesh(FakeMesh):
    def __init__(self, shape):
        super().__init__(shape)
        self.shape = dict(shape)


def _topos(data=16, model=16):
    sizes = {"data": data, "model": model}
    return (Topology(mesh=FakeMesh(sizes), batch_axes=("data",),
                     model_axis="model"),
            RTopology(mesh=RefFakeMesh(sizes), batch_axes=("data",),
                      model_axis="model"))


TOPOS = [(16, 16), (8, 4), (4, 1)]


def _ref_by_port_name(ref_tree, port_names):
    """The reference's leaf for each port name, with the stacked axis
    dropped from a stacked leaf's spec."""
    by_path = {tuple(path): leaf for path, leaf in _leaves(ref_tree)}
    out = {}
    for name in port_names:
        parts = name.split(".")
        path = tuple(p for p in parts if not p.isdigit())
        spec = tuple(by_path[path])
        out[name] = spec[1:] if parts[0] in _STACKED else spec
    return out


@pytest.fixture(scope="module")
def shapes():
    out = {}
    for arch in ARCH_IDS:
        rc, pc = rget(arch), pget(arch)
        out[arch] = (rc, pc, rbuild(rc).param_shapes(),
                     pbuild(pc).param_shapes())
    return out


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_are_the_references_without_the_stack_axis(
        shapes, arch, topo):
    rc, pc, rshapes, pshapes = shapes[arch]
    ptopo, rtopo = _topos(*topo)
    got = PR.param_specs(pshapes, pc, ptopo)
    assert set(got) == set(pshapes)
    want = _ref_by_port_name(RR.param_specs(rshapes, rc, rtopo), got)
    assert {k: tuple(v) for k, v in got.items()} == want
    assert all(isinstance(v, P) for v in got.values())


@pytest.mark.parametrize("arch", ["smollm_360m", "deepseek_moe_16b",
                                  "jamba_v01_52b"])
def test_zero1_is_the_references_rule_on_per_layer_leaves(shapes, arch):
    rc, pc, _, pshapes = shapes[arch]
    ptopo, rtopo = _topos()
    pspec = PR.param_specs(pshapes, pc, ptopo)
    got = PR.zero1_specs(pspec, pshapes, ptopo)
    want = RR.zero1_specs(
        {k: jax.sharding.PartitionSpec(*v) for k, v in pspec.items()},
        {k: jax.ShapeDtypeStruct(tuple(s), jnp.float32)
         for k, s in pshapes.items()}, rtopo)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", ["granite_20b", "gemma3_27b", "mamba2_130m",
                                  "jamba_v01_52b", "whisper_large_v3"])
def test_batch_and_cache_specs_match_the_reference(arch):
    rc, pc = rget(arch), pget(arch)
    ptopo, rtopo = _topos()
    shape = ShapeConfig("t", 4096, 256, "train")
    from repro.models import input_specs as rinput

    pb = PR.batch_specs(input_specs(pc, shape), ptopo)
    rb = RR.batch_specs(rinput(rc, shape), rtopo)
    assert {k: tuple(v) for k, v in pb.items()} == \
        {k: tuple(v) for k, v in rb.items()}
    pcache = pbuild(pc).init_cache(128, 2048, device="meta")
    rcache = jax.eval_shape(lambda: rbuild(rc).init_cache(128, 2048))
    got = {tuple(p): tuple(v) for p, v in _leaves(
        PR.cache_specs(pcache, pc, ptopo))}
    want = {tuple(p): tuple(v) for p, v in _leaves(
        RR.cache_specs(rcache, rc, rtopo))}
    assert got == want


# the reference file's own assertions, on the port's names


def _one(specs, *frags):
    return [v for k, v in specs.items() if all(f in k for f in frags)]


@pytest.mark.parametrize("arch", ["granite_20b", "gemma3_27b", "qwen25_14b"])
def test_attention_tp_specs(shapes, arch):
    _, cfg, _, pshapes = shapes[arch]
    specs = PR.param_specs(pshapes, cfg, _topos()[0])
    wq = _one(specs, "attn", "wq")[0]
    assert ("model" in wq) == (cfg.num_heads % 16 == 0)
    wk = _one(specs, "attn", "wk")[0]
    assert ("model" in wk) == (cfg.num_kv_heads % 16 == 0)


def test_moe_expert_parallel_specs(shapes):
    _, cfg, _, pshapes = shapes["deepseek_moe_16b"]
    specs = PR.param_specs(pshapes, cfg, _topos()[0])
    routed = [s for s in _one(specs, "moe", "w_in") if len(s) == 3]
    # per-layer (E, d, ff) -> (model, None, None)
    assert routed and all(s[0] == "model" for s in routed)
    assert all(e is None for e in _one(specs, "router")[0])


def test_mamba_sp_vs_tp_specs(shapes):
    _, ssm, _, pshapes = shapes["mamba2_130m"]
    specs = PR.param_specs(pshapes, ssm, _topos()[0])
    for s in _one(specs, "mamba"):
        assert "model" not in tuple(s)  # SP mamba weights replicated
    _, hyb, _, hshapes = shapes["jamba_v01_52b"]
    specs = PR.param_specs(hshapes, hyb, _topos()[0])
    assert "model" in tuple(_one(specs, "mamba", "w_z")[0])


def test_zero1_adds_data_axis(shapes):
    _, cfg, _, pshapes = shapes["smollm_360m"]
    topo = _topos()[0]
    pspec = PR.param_specs(pshapes, cfg, topo)
    ospec = PR.zero1_specs(pspec, pshapes, topo)
    assert tuple(pspec["embed"]) != tuple(ospec["embed"])
    assert "data" in tuple(ospec["embed"])


def test_no_mesh_specs_are_metadata(shapes):
    """On one card the specs name no mesh: the null topology's model size
    is 1 and ZeRO-1 adds nothing."""
    _, cfg, _, pshapes = shapes["smollm_360m"]
    topo = Topology(mesh=None)
    pspec = PR.param_specs(pshapes, cfg, topo)
    assert PR.zero1_specs(pspec, pshapes, topo) == pspec
