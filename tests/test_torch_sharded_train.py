"""The mesh train step and the sharded execution on a gloo group of 4 CPU
ranks (one process a rank, launched once for the whole file), against the
port's single-process forms on the same inputs.

* `launch.steps.make_train_step` on the (4, 1) ("data", "model") mesh of
  `launch.mesh.make_global_mesh`, one agent a rank, parameters DTensors
  and batches placed by `data.make_placer(mesh=)`: dense (the unfused
  formula, and the kernels' plain versions with and without link
  dropout), ring (pipelined and staged, static and dropout), crash
  faults on both schedules, dsgd and the ring's wire-tap, two steps of
  stablelm-3b-tiny each: BITWISE the same step on a stand-in mesh
  ``{"data": 4, "model": 1}`` (all agents in one process; the ring forms
  there with ``ring_fused``, whose plain version accumulates as the
  mesh does), parameters, losses and the tapped V.  The ring with crash
  faults (the stand-in's guarded dense fallback sums the links in
  another order): losses rtol 1e-6, parameters rtol 1e-5 + atol 1e-6.
* The trainer's sharded execution (``--mesh-fsdp 2`` and ``--mesh-tensor
  2``, agents 2, stablelm-3b-tiny, 3 steps, seq 16): the sharding audit
  record, finite losses and every parameter leaf that the rules shard
  still sharded after the update (the assertions of the reference's
  tests/test_sharded_pdsgd.py:394, which fails under jax 0.9.0); against
  the port's ``mesh=None`` leafwise run of the same flags: losses within
  rtol 1e-5 and parameters within atol 1e-5 + rtol 1e-4 (the gradients
  are summed over the fsdp ranks' batch halves, or over the tensor
  ranks' heads, in another f32 order; the update itself is bitwise).

Every rendezvous has its own timeout: the process group 60 s, the ranks
240 s (`run_ranks`).
"""
import json
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.mixing import make_mixing
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.data import make_lm_pipeline
from repro_torch.faults import make_faults
from repro_torch.launch.steps import make_train_step, torus_topology
from repro_torch.launch.train import build_parser, run_training
from repro_torch.models import build_model
from repro_torch.privacy import observe as O

from test_torch_mesh_gossip import RANK_HEAD, run_ranks

ARCH = "stablelm-3b-tiny"
M, STEPS, SEQ = 4, 2, 16
SHARDED_FLAGS = ["--arch", ARCH, "--agents", "2", "--steps", "3",
                 "--log-every", "1", "--seq-len", "16", "--device", "cpu",
                 "--per-agent-batch", "2"]
SHARDED_RUNS = {"fsdp": ["--mesh-fsdp", "2"], "tensor": ["--mesh-tensor", "2"]}


class StandIn:
    shape = {"data": M, "model": 1}


def forms(mesh):
    """name -> make_train_step keywords (on either mesh)."""
    tt = torus_topology(mesh)
    drop = make_mixing(tt, rate=0.3, seed=1)
    crash = make_faults(M, crash_rate=0.5, restart_rate=0.5, seed=1)
    return {
        "dense_eager": {},
        "dense_kernels": {"use_pallas": True},
        "dense_dropout": {"use_pallas": True, "mixing": drop},
        "ring": {"gossip": "ring"},
        "ring_staged": {"gossip": "ring", "ring_schedule": "staged"},
        "ring_dropout": {"gossip": "ring", "mixing": drop},
        "dense_crash": {"use_pallas": True, "faults": crash},
        "ring_crash": {"gossip": "ring", "faults": crash},
        "dsgd": {"algorithm": "dsgd"},
        "ring_tap": {"gossip": "ring",
                     "observer": O.external_eavesdropper()},
    }


def drive(mesh, place, params, name, kw):
    """Two steps of one form: ``(params, losses, V or None)``."""
    bundle = build_model(get_config(ARCH))
    step = make_train_step(bundle, mesh, lam_base=0.1, **kw)
    pipe = make_lm_pipeline(bundle.cfg.vocab_size, M, 1, SEQ, seed=3)
    losses, V = [], None
    for k in range(STEPS):
        params, out = step(params, place(pipe.batch_at(k)), 5, k)
        if isinstance(out, dict):
            V = out["observation"]["v"]
            out = out["loss"]
        losses.append(float(out))
    return params, losses, V


MESH_RANK = RANK_HEAD + textwrap.dedent("""
    sys.path.insert(0, os.path.join(out, "tests"))
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist.sharding import local_block
    from repro_torch.configs import get_config
    from repro_torch.core.privacy import tree_leaves, tree_unflatten
    from repro_torch.data import make_placer
    from repro_torch.launch.mesh import make_global_mesh
    from repro_torch.launch.train import build_parser, run_training
    from repro_torch.models import build_model
    from test_torch_sharded_train import (M, SHARDED_FLAGS, SHARDED_RUNS,
                                          drive, forms)
    mesh = make_global_mesh(device_type="cpu")
    pls = [Shard(0) if n in ("pod", "data") else Replicate()
           for n in mesh.mesh_dim_names]
    bundle = build_model(get_config("stablelm-3b-tiny"))
    p0 = bundle.init(torch.Generator().manual_seed(0), "cpu")
    res = {}
    for name, kw in forms(mesh).items():
        params = tree_unflatten(p0, [local_block(
            mesh, p[None].expand((M,) + tuple(p.shape)).contiguous(), pls)
            for p in tree_leaves(p0)])
        params, losses, V = drive(mesh, make_placer(mesh=mesh), params,
                                  name, kw)
        for i, t in enumerate(tree_leaves(params)):
            res[f"{name}/{i}"] = t.full_tensor().numpy()
        res[f"{name}/losses"] = np.array(losses)
        if V is not None:
            res[f"{name}/V"] = V.numpy()
    for name, extra in SHARDED_RUNS.items():
        got = run_training(build_parser().parse_args(SHARDED_FLAGS + extra))
        for i, t in enumerate(tree_leaves(got["params"])):
            res[f"sharded_{name}/{i}"] = t.full_tensor().numpy()
            res[f"sharded_{name}/placed{i}"] = np.array(
                [not p.is_replicate() for p in t.placements[1:]])
    if rank == 0:
        np.savez(os.path.join(out, "out.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4-rank group's outputs and rank 0's stdout."""
    import os
    import shutil
    out = tmp_path_factory.mktemp("sharded_train")
    (out / "tests").mkdir()
    here = os.path.dirname(__file__)
    for f in ("test_torch_sharded_train.py", "test_torch_mesh_gossip.py"):
        shutil.copy(os.path.join(here, f), out / "tests" / f)
    stdout = run_ranks(MESH_RANK, 4, out)
    return dict(np.load(out / "out.npz")), stdout[0]


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(forms(StandIn())))
def test_mesh_train_step_bitwise_stand_in(ranks, one_thread, name):
    res, _ = ranks
    bundle = build_model(get_config(ARCH))
    p0 = bundle.init(torch.Generator().manual_seed(0), "cpu")
    params = tree_unflatten(p0, [p[None].expand((M,) + tuple(p.shape))
                                 .contiguous() for p in tree_leaves(p0)])
    place = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    kw = dict(forms(StandIn())[name])
    exact = name != "ring_crash"
    if name.startswith("ring") and exact:
        # the ring kernel's plain version: self term, then the directions
        # in order, each message's products rounded apart — the mesh's
        kw["ring_fused"] = True
    params, losses, V = drive(StandIn(), place, params, name, kw)
    if exact:
        assert np.array_equal(np.array(losses), res[f"{name}/losses"])
    else:
        # the guarded dense fallback sums the links in another order
        np.testing.assert_allclose(losses, res[f"{name}/losses"], rtol=1e-6)
    for i, (path, t) in enumerate(zip(tree_paths(params),
                                      tree_leaves(params))):
        if exact:
            assert np.array_equal(t.numpy(), res[f"{name}/{i}"]), path
        else:
            np.testing.assert_allclose(t.numpy(), res[f"{name}/{i}"],
                                       rtol=1e-5, atol=1e-6, err_msg=path)
    if V is not None:
        assert np.array_equal(V.numpy(), res[f"{name}/V"])


@pytest.mark.parametrize("name", list(SHARDED_RUNS))
def test_sharded_trainer_against_mesh_none(ranks, one_thread, name):
    res, stdout = ranks
    recs = [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]
    audits = [r for r in recs if "sharding_audit" in r]
    mesh = {"fsdp": {"data": 2, "fsdp": 2, "model": 1},
            "tensor": {"data": 2, "fsdp": 1, "model": 2}}[name]
    audit = [a for a in audits if a["mesh"] == mesh]
    assert len(audit) == 1 and audit[0]["sharding_audit"] == "ok"
    summary = [r["sharded_summary"] for r in recs if "sharded_summary" in r
               and r["sharded_summary"]["mesh"] == mesh]
    assert summary and summary[0]["sharded_leaves"] > 0
    want = run_training(build_parser().parse_args(
        SHARDED_FLAGS + ["--kernel-layout", "leafwise"]))
    losses = [r["loss"] for r in recs if "step" in r]
    losses = losses[:3] if name == "fsdp" else losses[3:6]
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, [r["loss"] for r in want["history"]
                                        if "step" in r], rtol=1e-5)
    params = want["state"].params
    n_sharded = 0
    for i, (path, t) in enumerate(zip(tree_paths(params),
                                      tree_leaves(params))):
        np.testing.assert_allclose(res[f"sharded_{name}/{i}"], t.numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=path)
        n_sharded += bool(res[f"sharded_{name}/placed{i}"].any())
    assert n_sharded == summary[0]["sharded_leaves"]


def test_sharded_refusals():
    with pytest.raises(SystemExit, match="ROADMAP 7b"):
        run_training(build_parser().parse_args(
            SHARDED_FLAGS + ["--mesh-fsdp", "2", "--algorithm", "dsgd"]))
    with pytest.raises(SystemExit, match="process a rank"):
        run_training(build_parser().parse_args(
            SHARDED_FLAGS + ["--mesh-fsdp", "2"]))
    with pytest.raises(ValueError, match="ROADMAP 7b"):
        build_model(get_config("xlstm-125m-tiny"), mesh=StandIn())
