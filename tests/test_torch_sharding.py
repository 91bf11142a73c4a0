"""The mesh, the sharding rules and the input specs of the port
(`dist.sharding`, `launch.mesh`, `launch.specs`, `launch.steps`'s torus,
`optim.shard_like`, the configs' input shapes, `ModelBundle.abstract` and
`logical_axes`) against the reference on the CPU.

Nothing here needs devices: the reference's specs run on a
``jax.sharding.AbstractMesh`` and the port's on a stand-in whose
``.shape`` maps axis names to sizes, the three meshes (16, 16)
data x model, (2, 16, 16) pod x data x model and (4, 2, 2) data x fsdp
x model.  The mesh functions' refusals run on a one-rank gloo group (an
in-process HashStore, destroyed after the test) beside the reference's on
its one CPU device.  Every comparison is exact: shapes, dtypes, logical
axes, partition specs (the reference's ``PartitionSpec`` entries), the
audit's findings (paths spelled as jax's ``keystr``), error texts.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as jcfgs
from repro.dist import sharding as jsh
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro.launch import steps as jsteps
from repro.models import build_model as jax_build
from repro.optim import adam as jax_adam
from repro.optim import shard_like as jax_shard_like
from repro_torch import configs as cfgs
from repro_torch.core.pdsgd import init_state
from repro_torch.core.privacy import tree_leaves, tree_paths
from repro_torch.dist import sharding as sh
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import specs as pspecs
from repro_torch.launch import steps as psteps
from repro_torch.models import build_model
from repro_torch.optim import adam, shard_like

MESHES = {"data16_model16": {"data": 16, "model": 16},
          "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
          "data4_fsdp2_model2": {"data": 4, "fsdp": 2, "model": 2}}
TABLES = ("TRAIN_RULES", "SERVE_RULES", "DECODE_RULES")


def _duck(shape: dict):
    return types.SimpleNamespace(shape=dict(shape))


def _abstract_mesh(shape: dict):
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _dt(dtype) -> str:
    """A dtype's name in either package."""
    return str(dtype).replace("torch.", "")


def _spec(p) -> tuple:
    return tuple(p)


def test_rule_tables_equal_reference():
    for name in TABLES:
        assert dict(getattr(sh, name)) == dict(getattr(jsh, name)), name


def test_input_shapes_and_config_for_shape_equal_reference():
    assert cfgs.LONG_WINDOW == jcfgs.LONG_WINDOW
    assert list(cfgs.INPUT_SHAPES) == list(jcfgs.INPUT_SHAPES)
    for name, s in cfgs.INPUT_SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jcfgs.INPUT_SHAPES[name])
    for arch in cfgs.ARCH_NAMES:
        for name, s in cfgs.INPUT_SHAPES.items():
            a = cfgs.config_for_shape(cfgs.get_config(arch), s)
            b = jcfgs.config_for_shape(jcfgs.get_config(arch),
                                       jcfgs.INPUT_SHAPES[name])
            for f in ("attn_window", "cross_attn_window", "name"):
                assert getattr(a, f) == getattr(b, f), (arch, name, f)


def _bundles(arch):
    return build_model(cfgs.get_config(arch)), jax_build(
        jcfgs.get_config(arch))


@pytest.mark.parametrize("arch", cfgs.ARCH_NAMES)
def test_abstract_logical_and_specs_equal_reference(arch):
    """Every leaf's shape, dtype, logical axes and partition spec under
    each table on each mesh, and the audit's findings."""
    pb, jb = _bundles(arch)
    abstract, logical = pb.abstract(), pb.logical_axes()
    jabs = jax.tree_util.tree_flatten_with_path(jb.abstract())[0]
    jlog = jax.tree.leaves(jb.logical_axes(),
                           is_leaf=lambda x: isinstance(x, tuple))
    leaves, logs = tree_leaves(abstract), tree_leaves(logical)
    assert len(leaves) == len(jabs) == len(logs) == len(jlog)
    for path, a, log, (jpath, j), jl in zip(tree_paths(abstract), leaves,
                                             logs, jabs, jlog):
        assert sh.keystr(path) == jax.tree_util.keystr(jpath)
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(j.shape), path
        assert _dt(a.dtype) == _dt(j.dtype), path
        assert log == tuple(jl), path
    for mname, shape in MESHES.items():
        duck = _duck(shape)
        for table in TABLES:
            for a, log in zip(leaves, logs):
                assert sh.logical_spec(duck, a.shape, log, getattr(
                    sh, table)) == _spec(jsh.logical_spec(
                        duck, a.shape, log, getattr(jsh, table))), (
                    mname, table, log)
        for table in ("TRAIN_RULES", "SERVE_RULES"):
            assert sh.audit_rules(abstract, logical, duck, getattr(
                sh, table)) == jsh.audit_rules(jb.abstract(),
                                               jb.logical_axes(), duck,
                                               getattr(jsh, table))
        m = pmesh.num_agents(duck)
        pa, pl = pspecs.with_agent_axis(abstract, logical, m)
        ja, jl = jspecs.with_agent_axis(jb.abstract(), jb.logical_axes(), m)
        assert sh.audit_rules(pa, pl, duck) == jsh.audit_rules(ja, jl, duck)


def _check_specs(got_abs, got_sh, want_abs, want_sh, what):
    ga, gs = tree_leaves(got_abs), tree_leaves(got_sh)
    wa = jax.tree.leaves(want_abs)
    ws = jax.tree.leaves(want_sh)
    assert len(ga) == len(gs) == len(wa) == len(ws), what
    for a, s, b, t in zip(ga, gs, wa, ws):
        assert tuple(a.shape) == tuple(b.shape), what
        assert _dt(a.dtype) == _dt(b.dtype), what
        assert a.device.type == "meta", what
        assert s.spec == _spec(t.spec), (what, s.spec, t.spec)


@pytest.mark.parametrize("arch", cfgs.ARCH_NAMES)
def test_input_specs_equal_reference(arch):
    """train_specs, prefill_specs and decode_specs (both decode tables) of
    every config at every input shape on every mesh."""
    for mname, shape in MESHES.items():
        duck, amesh = _duck(shape), _abstract_mesh(shape)
        m = pmesh.num_agents(duck)
        for sname, s in cfgs.INPUT_SHAPES.items():
            pb = build_model(cfgs.config_for_shape(cfgs.get_config(arch), s))
            jb = jax_build(jcfgs.config_for_shape(jcfgs.get_config(arch),
                                                  jcfgs.INPUT_SHAPES[sname]))
            what = (arch, mname, sname)
            if s.global_batch % m:  # no whole batch an agent: both refuse
                with pytest.raises(AssertionError):
                    pspecs.train_specs(pb, s, duck, m)
                with pytest.raises(AssertionError):
                    jspecs.train_specs(jb, jcfgs.INPUT_SHAPES[sname], amesh,
                                       m)
            else:
                got = pspecs.train_specs(pb, s, duck, m)
                want = jspecs.train_specs(jb, jcfgs.INPUT_SHAPES[sname],
                                          amesh, m)
                _check_specs(got[0], got[1], want[0], want[1],
                             what + ("params",))
                _check_specs(got[2], got[3], want[2], want[3],
                             what + ("batch",))
            got = pspecs.prefill_specs(pb, s, duck)
            want = jspecs.prefill_specs(jb, jcfgs.INPUT_SHAPES[sname], amesh)
            for i in (0, 2):
                _check_specs(got[i], got[i + 1], want[i], want[i + 1],
                             what + ("prefill", i))
            for rules, jrules in ((None, None),
                                  (sh.DECODE_RULES, jsh.DECODE_RULES)):
                got = pspecs.decode_specs(pb, s, duck, rules)
                want = jspecs.decode_specs(jb, jcfgs.INPUT_SHAPES[sname],
                                           amesh, jrules)
                for i in (0, 2, 4, 6):
                    _check_specs(got[i], got[i + 1], want[i], want[i + 1],
                                 what + ("decode", i))


def test_spec_placements_on_a_mesh_of_named_axes():
    """A dimension over two axes shards on both, in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert sh.placements(("model", ("pod", "data")), mesh) == [
        Shard(1), Shard(1), Shard(0)]
    assert sh.placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(((("data", "pod")),), mesh)
    with pytest.raises(ValueError, match="not on the mesh"):
        sh.placements(("fsdp",), mesh)


def test_shard_like_matches_reference():
    """tests/test_sharded_pdsgd.py:165-190 on the port's structures."""
    params = {"w": torch.zeros(2, 4, 4), "b": torch.zeros(2, 4)}
    out = shard_like(adam(1e-3).init(params), params,
                     {"w": "W_SHARDING", "b": "B_SHARDING"},
                     scalar_sharding="SCALAR")
    want = jax_shard_like(
        jax_adam(1e-3).init({"w": jnp.zeros((2, 4, 4)),
                             "b": jnp.zeros((2, 4))}),
        {"w": jnp.zeros((2, 4, 4)), "b": jnp.zeros((2, 4))},
        {"w": "W_SHARDING", "b": "B_SHARDING"}, scalar_sharding="SCALAR")
    assert out.mu == out.nu == {"w": "W_SHARDING", "b": "B_SHARDING"}
    got = [*tree_leaves(out.mu), *tree_leaves(out.nu), out.count]
    assert sorted(got) == sorted(jax.tree.leaves(want))
    # same structure, another leaf shape: not the parameters
    state = {"stats": {"w": torch.zeros(3)}, "buf": {"w": torch.zeros(4, 4)}}
    out = shard_like(state, {"w": torch.zeros(4, 4)}, {"w": "PSH"},
                     scalar_sharding="SC")
    assert out == {"stats": {"w": "SC"}, "buf": {"w": "PSH"}}
    # the decentralized state: its buffer and tracker shard like the
    # parameters' buffer, the step counter replicates, the layout stays
    st = init_state({"w": torch.zeros(8)}, 2, algorithm="dsgt")
    out = shard_like(st, st.flat, "PSH", scalar_sharding="SC")
    assert out.flat == "PSH" and out.tracker == ("PSH", "PSH")
    assert out.step == "SC" and out.layout is st.layout


@pytest.mark.parametrize("shape", list(MESHES.values()) + [
    {"data": 4, "model": 1}, {"data": 1, "fsdp": 1, "model": 1}])
def test_torus_and_dsgt_carry_equal_reference(shape):
    duck = _duck(shape)
    a, b = psteps.torus_topology(duck), jsteps.torus_topology(duck)
    assert a.name == b.name
    np.testing.assert_array_equal(a.adjacency, np.asarray(b.adjacency))
    np.testing.assert_array_equal(a.weights, np.asarray(b.weights))
    np.testing.assert_array_equal(psteps.make_torus_W(duck),
                                  np.asarray(jsteps.make_torus_W(duck)))
    assert pmesh.agent_axes(duck) == jmesh.agent_axes(duck)
    assert pmesh.num_agents(duck) == jmesh.num_agents(duck)
    params = {"a": torch.ones(2, 3), "b": torch.ones(2)}
    p, (y, g) = psteps.dsgt_carry(params)
    jp, (jy, jg) = jsteps.dsgt_carry({"a": jnp.ones((2, 3)),
                                      "b": jnp.ones((2,))})
    assert p is params and y is not g
    for t, u in ((y, jy), (g, jg)):
        for k in params:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(u[k]))


def _same_error(fn, jfn, exc=ValueError):
    with pytest.raises(exc) as got:
        fn()
    with pytest.raises(exc) as want:
        jfn()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("shape,agents", [
    ({"data": 4, "model": 2}, 6), ({"pod": 2, "data": 16, "model": 16}, 48),
    ({"data": 4, "fsdp": 2, "model": 2}, 0)])
def test_validate_agent_tiling_errors_equal_reference(shape, agents):
    duck = _duck(shape)
    _same_error(lambda: pmesh.validate_agent_tiling(duck, agents),
                lambda: jmesh.validate_agent_tiling(duck, agents))


@pytest.fixture()
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_functions_on_one_rank(one_rank_group):
    """The mesh functions on one rank against the reference's on its one
    device: the (1, 1, 1) agents x fsdp x tensor mesh, 4 agents on its one
    slot; the refusals' texts."""
    mesh = pmesh.make_sharded_mesh(agents=4, fsdp=1, tensor=1,
                                   device_type="cpu")
    jm = jmesh.make_sharded_mesh(agents=4, fsdp=1, tensor=1)
    assert sh.mesh_shape(mesh) == dict(jm.shape)
    assert pmesh.validate_agent_tiling(mesh, 4) == \
        jmesh.validate_agent_tiling(jm, 4) == 4
    assert pmesh.agent_axes(mesh) == ("data",)
    g = pmesh.make_global_mesh(agents=2, device_type="cpu")
    assert sh.mesh_shape(g) == dict(jmesh.make_global_mesh(agents=2).shape)
    for kw in ({"fsdp": 2}, {"tensor": 0}, {"fsdp": 1, "tensor": 3}):
        _same_error(lambda: pmesh.make_sharded_mesh(device_type="cpu", **kw),
                    lambda: jmesh.make_sharded_mesh(**kw))
    _same_error(lambda: pmesh.make_global_mesh(model_parallel=2,
                                               device_type="cpu"),
                lambda: jmesh.make_global_mesh(model_parallel=2))


def test_mesh_functions_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_sharded_mesh(device_type="cpu")
