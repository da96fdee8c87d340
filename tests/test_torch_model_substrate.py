"""Parity of the port's model substrate with the JAX reference.

Pairs: ``repro_torch.configs`` vs ``repro.configs`` (every field, property
and ``reduced()`` of the ten archs, the shape table, ids, aliases and
cells), ``repro_torch.perf_flags`` vs ``repro.perf_flags`` (``set_flags``,
``parse_opt_string``, and each package reading its own environment), and
``repro_torch.sharding.specs`` vs ``repro.sharding.specs`` (the null
topology, and a meshed one over a ``repro_torch.compat.Mesh``; the model
code's mesh paths are held in ``test_torch_mesh_*.py``).
"""

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.configs as rcfg
import repro.perf_flags as rflags
from repro.sharding import specs as rspecs

import repro_torch.configs as pcfg
import repro_torch.perf_flags as pflags
from repro_torch.compat import Mesh
from repro_torch.sharding import specs as pspecs

SRC = Path(__file__).resolve().parents[1] / "src"

PROPERTIES = ("resolved_head_dim", "padded_vocab", "is_attention_free",
              "ssm_d_inner", "ssm_num_heads", "sub_quadratic")


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", rcfg.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_properties_and_counts(arch, reduced):
    ref = rcfg.get_config(arch)
    port = pcfg.get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert type(port).__module__ == "repro_torch.configs.base"
    assert _as_dict(port) == _as_dict(ref)
    for name in PROPERTIES:
        assert getattr(port, name) == getattr(ref, name), name
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert pcfg.applicable_shapes(port) == rcfg.applicable_shapes(ref)


def test_field_names_and_defaults_match():
    ref = {f.name: f.default for f in dataclasses.fields(rcfg.ModelConfig)}
    port = {f.name: f.default for f in dataclasses.fields(pcfg.ModelConfig)}
    assert port == ref
    ref_s = [f.name for f in dataclasses.fields(rcfg.ShapeConfig)]
    assert [f.name for f in dataclasses.fields(pcfg.ShapeConfig)] == ref_s


def test_registry_shapes_aliases_and_cells():
    from repro.configs import base as rbase
    from repro_torch.configs import base as pbase

    assert pcfg.ARCH_IDS == rcfg.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in pcfg.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in rcfg.SHAPES.items()}
    assert pbase._ALIASES == rbase._ALIASES
    for alias in rbase._ALIASES:
        assert _as_dict(pcfg.get_config(alias)) == _as_dict(rcfg.get_config(alias))
    assert list(pcfg.all_cells()) == list(rcfg.all_cells())


def test_arch_modules_keep_the_reference_docstring_source_line():
    for arch in rcfg.ARCH_IDS:
        rmod = importlib.import_module(f"repro.configs.{arch}")
        pmod = importlib.import_module(f"repro_torch.configs.{arch}")
        assert pmod.__doc__.splitlines()[0] == rmod.__doc__.splitlines()[0]


@pytest.fixture
def restore_flags():
    ref, port = rflags.FLAGS, pflags.FLAGS
    yield
    rflags.FLAGS, pflags.FLAGS = ref, port


def test_flag_fields_and_defaults_match():
    ref = {f.name: f.default for f in dataclasses.fields(rflags.PerfFlags)}
    port = {f.name: f.default for f in dataclasses.fields(pflags.PerfFlags)}
    assert port == ref


@pytest.mark.parametrize("opt", [
    None,
    "",
    "seq_shard_attn=1,remat_policy=save_block_outputs",
    "attn_kv_block=256, ssm_chunk=32",
    "scan_algorithm=sklansky,scan_payload_bf16=true,attn_probs_bf16=True",
    "tp_reduce_bf16=1,explicit_tp=0,attn_seq_over_tp=1",
])
def test_parse_opt_string_matches(opt, restore_flags):
    rflags.FLAGS = rflags.PerfFlags()
    pflags.FLAGS = pflags.PerfFlags()
    rflags.parse_opt_string(opt)
    pflags.parse_opt_string(opt)
    assert dataclasses.asdict(pflags.FLAGS) == dataclasses.asdict(rflags.FLAGS)


def test_set_flags_replaces_and_returns(restore_flags):
    pflags.FLAGS = pflags.PerfFlags()
    got = pflags.set_flags(ssm_chunk=64, attn_probs_bf16=True)
    assert got is pflags.FLAGS
    assert (got.ssm_chunk, got.attn_probs_bf16) == (64, True)
    assert got.attn_kv_block == 1024
    with pytest.raises(TypeError):
        pflags.set_flags(no_such_flag=1)


def test_each_package_reads_its_own_environment():
    code = ("import repro.perf_flags as r, repro_torch.perf_flags as p;"
            "print(r.FLAGS.ssm_chunk, p.FLAGS.ssm_chunk,"
            " r.FLAGS.attn_kv_block, p.FLAGS.attn_kv_block)")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("REPRO_OPT_", "REPRO_TORCH_OPT_"))}
    env.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               REPRO_OPT_SSM_CHUNK="8", REPRO_TORCH_OPT_ATTN_KV_BLOCK="64")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True).stdout
    assert out.split() == ["8", "0", "1024", "64"]


def test_null_topology_matches_the_reference():
    for ref, port in ((rspecs.current_topology(), pspecs.current_topology()),
                      (rspecs.make_topology(None), pspecs.make_topology(None))):
        assert port.mesh is None and ref.mesh is None
        assert (port.batch_axes, port.model_axis) == (ref.batch_axes, ref.model_axis)
        assert (port.dp, port.model_size, port.dp_size) == (
            ref.dp, ref.model_size, ref.dp_size)
    port = pspecs.Topology(mesh=None)
    ref = rspecs.Topology(mesh=None)
    for logical in (("batch", None, "heads"), ("seq", "vocab"), ("expert", "ff", "model")):
        assert port.spec(*logical) == tuple(ref.spec(*logical))
    with pytest.raises(ValueError):
        port.spec("rows")
    x = torch.arange(6.0).reshape(2, 3)
    with pspecs.use_topology(port) as topo:
        assert topo is port and pspecs.current_topology() is port
        assert pspecs.shard(x, "batch", None) is x


def test_meshed_topology_raises_and_names_the_next_slice():
    """A meshed topology maps its axes as the reference's and is entered
    (the mesh paths are ported); what it still refuses is a mesh that is
    not the port's ``compat.Mesh``, naming the type it needs."""
    mesh = Mesh((2, 2), ("data", "model"), device="cpu")
    topo = pspecs.make_topology(mesh)
    # the mapping itself is the reference's
    assert (topo.batch_axes, topo.model_axis) == (("data",), "model")
    assert (topo.model_size, topo.dp_size) == (2, 2)
    assert topo.spec("batch", "heads") == ("data", "model")
    pod = pspecs.make_topology(Mesh((2, 2), ("pod", "data"), device="cpu"))
    assert (pod.batch_axes, pod.model_axis, pod.dp_size) == (("pod", "data"), None, 4)
    before = pspecs.current_topology()
    x = torch.arange(6.0).reshape(2, 3)
    with pspecs.use_topology(topo) as entered:
        assert entered is topo and pspecs.current_topology() is topo
        assert pspecs.shard(x, "batch", "model") is x
    assert pspecs.current_topology() is before
    with pytest.raises(TypeError, match="compat.Mesh"):
        with pspecs.use_topology(pspecs.Topology(mesh=object())):
            pass
    assert pspecs.current_topology() is before
