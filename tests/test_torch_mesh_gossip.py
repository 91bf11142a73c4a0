"""The torus exchange over a device mesh: the mesh branch of
`dist.collectives.torus_gossip_pdsgd` and `dist.transport.ShardMapTransport`
on gloo groups of 4 ranks (one ring, ("data",)) and 8 ranks (the 2 x 4
torus, ("pod", "data")), one CPU process a rank, each group launched once.

* ShardMapTransport is bitwise the port's InProcessTransport, outputs and
  captures (the reference's tests/test_transport.py:499 for its own).
* The mesh branch against the reference's shard_map path, run on XLA host
  devices in a subprocess (as tests/test_mixing.py:265-318 does), on the
  same inputs: within 2 ulp of (|w x| + |b u|) per entry, static, with
  the static table and under a realized dropout mask.  XLA contracts
  w x - b u to a fused multiply-add; the port rounds each product and the
  difference apart (ROADMAP §C).
* The static table path (``W`` = the torus Metropolis matrix) bitwise the
  scalar path, "staged" bitwise "pipelined", the receive guard bitwise
  identity on finite inputs, and the capture (V, every rank) equal to the
  dense fallback's within the same bound.

Every rendezvous has its own timeout: the ranks' process group 60 s, each
subprocess 240 s.
"""
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.mixing import make_mixing
from repro_torch.core.topology import Topology, metropolis_weights, torus2d
from repro_torch.dist import collectives as C
from repro_torch.dist.transport import InProcessTransport

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TORI = [(1, 4), (2, 4)]  # (n_pod, n_data)
RANK_TIMEOUT_S = 240

# a rank of the port's group: reads in.npz, writes out<rank>.npz
RANK_HEAD = textwrap.dedent("""
    import datetime, os, sys
    import numpy as np, torch, torch.distributed as dist
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
""")

GOSSIP_RANK = RANK_HEAD + textwrap.dedent("""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import collectives as C
    from repro_torch.dist.sharding import local_block
    from repro_torch.dist.transport import ShardMapTransport
    from repro_torch.launch.mesh import make_global_mesh
    inp = dict(np.load(os.path.join(out, "in.npz")))
    mesh = make_global_mesh(device_type="cpu")
    pls = [Shard(0) if n in ("pod", "data") else Replicate()
           for n in mesh.mesh_dim_names]
    P = {"w": local_block(mesh, torch.from_numpy(inp["x"]), pls)}
    U = {"w": local_block(mesh, torch.from_numpy(inp["u"]), pls)}
    b, bm = torch.from_numpy(inp["b"]), torch.from_numpy(inp["bm"])
    W, W0 = torch.from_numpy(inp["W"]), torch.from_numpy(inp["W0"])
    res = {}
    for sched in ("staged", "pipelined"):
        def run(name, bb, WW=None, **kw):
            o = C.torus_gossip_pdsgd(mesh, P, U, bb, W=WW, schedule=sched,
                                     **kw)
            if kw.get("capture"):
                o, V = o
                res[f"V_{sched}"] = V.numpy()
            res[f"{name}_{sched}"] = o["w"].full_tensor().numpy()
        run("static", b)
        run("table", b, W0)
        run("masked", bm, W, capture=True)
        run("guard", b, finite_guard=True)
    tr = ShardMapTransport(mesh)
    a = tr.local_lo
    x2, u2 = inp["x"].reshape(len(inp["x"]), -1), inp["u"].reshape(
        len(inp["u"]), -1)
    o, V = tr.exchange(x2[a:a + 1], u2[a:a + 1], inp["W"], inp["B"],
                       capture=True)
    rows = C.gather_agents(mesh, torch.from_numpy(o)).numpy()
    res["transport"], res["transport_V"] = rows, V
    res["span"] = np.array([tr.local_lo, tr.local_hi])
    np.savez(os.path.join(out, f"out{rank}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()
""")

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys; sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.dist import collectives as C
    out = {out!r}
    for n_pod, n_data in {tori!r}:
        inp = dict(np.load(os.path.join(out, f"in_{{n_pod}}x{{n_data}}.npz")))
        if n_pod > 1:
            mesh = jax.make_mesh((n_pod, n_data), ("pod", "data"))
            spec = P(("pod", "data"))
        else:
            mesh = jax.make_mesh((n_data,), ("data",),
                                 devices=jax.devices()[:n_data])
            spec = P("data")
        sh = NamedSharding(mesh, spec)
        p = {{"w": jax.device_put(jnp.asarray(inp["x"]), sh)}}
        u = {{"w": jax.device_put(jnp.asarray(inp["u"]), sh)}}
        axes = ("pod", "data") if n_pod > 1 else ("data",)
        res = {{}}
        f = jax.jit(lambda p, u, b: C.torus_gossip_pdsgd(
            mesh, p, u, b, agent_axes=axes))
        res["static"] = np.asarray(f(p, u, jnp.asarray(inp["b"]))["w"])
        g = jax.jit(lambda p, u, b, W: C.torus_gossip_pdsgd(
            mesh, p, u, b, agent_axes=axes, W=W, capture=True))
        o, V = g(p, u, jnp.asarray(inp["bm"]), jnp.asarray(inp["W"]))
        res["masked"], res["V"] = np.asarray(o["w"]), np.asarray(V)
        np.savez(os.path.join(out, f"ref_{{n_pod}}x{{n_data}}.npz"), **res)
    print("ok")
""")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(script: str, world: int, out, env=None,
              timeout: float = RANK_TIMEOUT_S):
    """Run ``script`` as ``world`` rank processes on a fresh port (argv:
    rank, world, port, out); fails on a non-zero rank or the timeout,
    killing every rank.  Returns each rank's stdout."""
    path = os.path.join(out, "rank.py")
    with open(path, "w") as f:
        f.write(script)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, path, str(r), str(world), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            assert p.returncode == 0, se[-3000:]
            outs.append(so)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _inputs(n_pod: int, n_data: int) -> dict:
    m = n_pod * n_data
    rng = np.random.default_rng(10 * n_pod + n_data)
    adj = torus2d(n_pod, n_data)
    top = Topology(name="torus", adjacency=adj,
                   weights=metropolis_weights(adj))
    W, support, _ = make_mixing(top, rate=0.3, seed=5).realize(7)
    b = C.sample_b_draws(prng.key(3), m, n_data, n_pod)
    bm = C.mask_b_draws(b, C.directional_keep(support, n_data, n_pod))
    _, B = C.dense_coupling(b, n_data, n_pod)
    return {"x": rng.normal(size=(m, 6, 4)).astype(np.float32),
            "u": rng.normal(size=(m, 6, 4)).astype(np.float32),
            "b": b.numpy(), "bm": bm.numpy(), "W": W.numpy(),
            "W0": top.weights.astype(np.float32), "B": B.numpy(),
            "adj": adj}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each torus' inputs, the port's ranks' outputs, and the reference's
    shard_map outputs."""
    root = tmp_path_factory.mktemp("mesh_gossip")
    res = {}
    for n_pod, n_data in TORI:
        d = root / f"{n_pod}x{n_data}"
        d.mkdir()
        inp = _inputs(n_pod, n_data)
        np.savez(d / "in.npz", **inp)
        np.savez(root / f"in_{n_pod}x{n_data}.npz", **inp)
        env = {"LOCAL_WORLD_SIZE": str(n_data)}  # one host a pod row
        run_ranks(GOSSIP_RANK, n_pod * n_data, d, env=env)
        res[(n_pod, n_data)] = (inp, [dict(np.load(d / f"out{r}.npz"))
                                      for r in range(n_pod * n_data)])
    ref = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT.format(src=SRC, out=str(root),
                                                 tori=TORI)],
        capture_output=True, text=True, timeout=RANK_TIMEOUT_S)
    assert ref.returncode == 0, ref.stderr[-3000:]
    for key in TORI:
        res[key] += (dict(np.load(root / f"ref_{key[0]}x{key[1]}.npz")),)
    return res


def _ulp_bound(inp, b, W=None, n_pod=1, n_data=4):
    """2 f32 ulp of sum over links of |w x_j| + |b u_j| per entry."""
    Wd, B = C.dense_coupling(torch.from_numpy(b), n_data, n_pod,
                             W=None if W is None else torch.from_numpy(W))
    x = torch.from_numpy(inp["x"]).reshape(len(inp["x"]), -1)
    u = torch.from_numpy(inp["u"]).reshape(len(inp["u"]), -1)
    scale = Wd.abs() @ x.abs() + B.abs() @ u.abs()
    return (2 * 2.0 ** -23 * scale).numpy().reshape(inp["x"].shape)


@pytest.mark.parametrize("torus", TORI, ids=["ring4", "torus2x4"])
def test_mesh_branch_matches_reference_shard_map(runs, torus):
    inp, outs, ref = runs[torus]
    n_pod, n_data = torus
    for name, b, W in (("static", inp["b"], None),
                       ("masked", inp["bm"], inp["W"])):
        got = outs[0][f"{name}_pipelined"]
        bound = _ulp_bound(inp, b, W, n_pod, n_data)
        diff = np.abs(got - ref[name])
        assert (diff <= bound).all(), (name, float((diff / bound).max()))
    # each V[i, j] is one link's w x_j - b u_j
    Wd, B = C.dense_coupling(torch.from_numpy(inp["bm"]), n_data, n_pod,
                             W=torch.from_numpy(inp["W"]))
    m = n_pod * n_data
    x = np.abs(inp["x"].reshape(m, -1))
    u = np.abs(inp["u"].reshape(m, -1))
    bound = 2 * 2.0 ** -23 * (np.abs(Wd.numpy())[:, :, None] * x[None]
                              + np.abs(B.numpy())[:, :, None] * u[None])
    assert (np.abs(outs[0]["V_pipelined"] - ref["V"]) <= bound).all()


@pytest.mark.parametrize("torus", TORI, ids=["ring4", "torus2x4"])
def test_mesh_branch_bitwise_invariants(runs, torus):
    inp, outs, _ = runs[torus]
    n_pod, n_data = torus
    o = outs[0]
    for name in ("static", "table", "masked", "guard"):
        assert np.array_equal(o[f"{name}_staged"], o[f"{name}_pipelined"])
    assert np.array_equal(o["static_pipelined"], o["table_pipelined"])
    assert np.array_equal(o["guard_pipelined"], o["static_pipelined"])
    assert np.array_equal(o["V_staged"], o["V_pipelined"])
    for r in outs[1:]:  # every rank holds the same full views
        assert np.array_equal(r["masked_pipelined"], o["masked_pipelined"])
        assert np.array_equal(r["V_pipelined"], o["V_pipelined"])
    # against the single-device dense fallback on the same inputs
    x, u = torch.from_numpy(inp["x"]), torch.from_numpy(inp["u"])
    dense, V = C.torus_gossip_pdsgd(
        None, {"w": x}, {"w": u}, torch.from_numpy(inp["bm"]),
        n_data=n_data, n_pod=n_pod, W=torch.from_numpy(inp["W"]),
        capture=True)
    bound = _ulp_bound(inp, inp["bm"], inp["W"], n_pod, n_data)
    assert (np.abs(dense["w"].numpy() - o["masked_pipelined"])
            <= bound).all()
    assert np.array_equal(V.numpy(), o["V_pipelined"])


@pytest.mark.parametrize("torus", TORI, ids=["ring4", "torus2x4"])
def test_shard_map_transport_bitwise_inprocess(runs, torus):
    inp, outs, _ = runs[torus]
    m = torus[0] * torus[1]
    x = inp["x"].reshape(m, -1)
    u = inp["u"].reshape(m, -1)
    want, want_V = InProcessTransport(inp["adj"]).exchange(
        x, u, inp["W"], inp["B"], capture=True)
    for r, o in enumerate(outs):
        assert np.array_equal(o["transport"], want)
        assert np.array_equal(o["transport_V"], want_V)
        lo = int(o["span"][0])
        assert o["span"][1] == lo + 1
    assert sorted(int(o["span"][0]) for o in outs) == list(range(m))


def test_mesh_helpers_refuse():
    m = 4
    p = {"w": torch.zeros(m, 3)}
    b = C.sample_b_draws(prng.key(0), m, m, 1)
    with pytest.raises(TypeError, match="mesh"):
        C.torus_gossip_pdsgd(object(), p, p, b)

    class StandIn:
        shape = {"data": 4, "model": 1}

    # a stand-in mesh gives the torus; the single-device forms run
    a = C.torus_gossip_pdsgd(StandIn(), p, p, b)
    c = C.torus_gossip_pdsgd(None, p, p, b, n_data=4, n_pod=1)
    assert torch.equal(a["w"], c["w"])
