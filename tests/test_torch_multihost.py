"""The port's multi-controller deployment (`repro_torch.launch.multihost`)
on the CPU, stablelm-3b-tiny, 4 agents on a ring, seq 16.

Port-only contracts: a world=2 run (two rank processes over HMAC-framed
loopback sockets) is bit-identical to the world=1 run, final x and
merged wiretap; a shard holds only its rows and no key material; a
SIGKILLed rank, then ``--resume``, completes with the key generation
bumped; the pipelined transport equals the blocking one; the quorum,
generation and refusal helpers.  Against the reference
(`repro.launch.multihost`): the world=1 run from the reference's template
(through `repro_torch.convert`) against its ``run_rank`` over 3 steps,
the coupling W_k and B^k and step 0's u bitwise, and the reference's
checkpoint reader and ``quorum_step`` on the port's shards.  W_k, the
keys and u are bitwise the reference's; B^k within 2 ulps (the Exp(1)
draws' log1p), and the 3-step run within 1e-6 of the state's scale.

Every run compared bitwise uses one torch thread (in this process and,
through ``OMP_NUM_THREADS``, in the rank processes): a CPU reduction's
bits depend on the thread count.  Four multi-process launches in all.
"""
import argparse
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_ckpt_io
from repro.launch import multihost as RMH
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.dist.transport import FRAME_HEADER, WIRE_TAG_SIZE
from repro_torch.launch import multihost as mh

ARCH = "stablelm-3b-tiny"
STEPS = 4


def _args(extra, root=None, parser=mh.build_multihost_parser, device=True):
    argv = ["--arch", ARCH, "--agents", "4", "--steps", str(STEPS),
            "--per-agent-batch", "2", "--seq-len", "16", "--seed", "0",
            "--checkpoint-every", "2", "--timeout", "60"]
    if device:
        argv += ["--device", "cpu"]
    if root:
        argv += ["--checkpoint-dir", root]
    return parser().parse_args(argv + extra)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev_threads = torch.get_num_threads()
    prev_env = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(prev_threads)
    if prev_env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prev_env


def _shard_arrays(host, step):
    d = os.path.join(host, ckpt_io.step_dirname(step))
    with open(os.path.join(d, "tree.json")) as f:
        tree = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        return {p: z[f"a{i}"] for i, p in enumerate(tree["paths"])}


def _load_x(root, world, step):
    return np.concatenate([_shard_arrays(mh.host_dir(root, r), step)["['x']"]
                           for r in range(world)])


@pytest.fixture(scope="module")
def world_runs(tmp_path_factory):
    """A world=1 and a world=2 run of one configuration, with wiretaps."""
    r1 = str(tmp_path_factory.mktemp("mh_w1"))
    r2 = str(tmp_path_factory.mktemp("mh_w2"))
    o1 = mh.launch(_args(["--world", "1", "--wiretap"], r1))
    o2 = mh.launch(_args(["--world", "2", "--wiretap"], r2))
    return r1, o1, r2, o2


def test_world2_bit_identical_to_world1(world_runs):
    r1, o1, r2, o2 = world_runs
    assert o1["ok"] and o2["ok"] and o2["casualties"] == []
    x1, x2 = _load_x(r1, 1, STEPS), _load_x(r2, 2, STEPS)
    assert x1.shape[0] == 4 and x1.dtype == np.float32
    assert x1.tobytes() == x2.tobytes()
    with np.load(os.path.join(r1, "wiretap_merged.npz")) as z1, \
            np.load(os.path.join(r2, "wiretap_merged.npz")) as z2:
        assert list(z1["steps"]) == list(z2["steps"]) == list(range(STEPS))
        assert z1["v"].tobytes() == z2["v"].tobytes()
    for r in range(2):
        s = o2["ranks"][str(r)]
        assert s["finite"] and s["final_step"] == STEPS
        assert s["comm"]["drops"] == 0 and s["comm"]["tag_failures"] == 0
        # a ring of 4 over 2 ranks: 2 frames a step, each a 20-byte
        # header, the D f32 payload and a 32-byte tag
        frame = FRAME_HEADER.size + 4 * x1.shape[1] + WIRE_TAG_SIZE
        assert s["comm"]["bytes_sent"] == STEPS * 2 * frame
        assert s["x_sha256"] == hashlib.sha256(
            x1[2 * r:2 * r + 2].tobytes()).hexdigest()


def test_shard_holds_only_local_rows_and_no_key_material(world_runs):
    _, _, r2, _ = world_runs
    for r in range(2):
        arrs = _shard_arrays(mh.host_dir(r2, r), STEPS)
        assert set(arrs) == {"['x']", "['step']"}
        assert arrs["['x']"].shape[0] == 2 and arrs["['x']"].dtype \
            == np.float32
        with np.load(os.path.join(mh.host_dir(r2, r), "wiretap.npz")) as z:
            assert set(z.files) == {"v", "steps"}
    man = mh.read_manifest(r2)
    assert man["world"] == 2 and man["per_rank"] == 2
    assert man["hosts"] == ["host_0", "host_1"]
    assert man["transport"] == "socket" and man["ok"]


def test_reference_reads_the_port_shards(world_runs):
    """The reference's `quorum_step` and checkpoint reader take the port's
    shard directory as their own."""
    _, _, r2, _ = world_runs
    assert RMH.quorum_step(r2, 2) == mh.quorum_step(r2, 2) == STEPS
    x = _load_x(r2, 2, STEPS)
    for r in range(2):
        like = {"x": jnp.zeros((2, x.shape[1]), jnp.float32),
                "step": jnp.int32(0)}
        got = ref_ckpt_io.load_checkpoint(mh.host_dir(r2, r), STEPS,
                                          like=like)
        assert int(got["step"]) == STEPS
        assert np.asarray(got["x"]).tobytes() == x[2 * r:2 * r + 2].tobytes()


def test_pipelined_transport_bit_matches_blocking(world_runs, tmp_path):
    _, _, r2, o2 = world_runs
    rp = str(tmp_path / "mh_pipe")
    op = mh.launch(_args(["--world", "2", "--frames-ahead", "2",
                          "--outbox-frames", "8"], rp))
    assert op["ok"]
    for r in range(2):
        sb, sp = o2["ranks"][str(r)], op["ranks"][str(r)]
        assert sp["x_sha256"] == sb["x_sha256"]
        assert sb["comm"]["transport"] == "SocketTransport"
        assert sp["comm"]["transport"] == "PipelinedSocketTransport"
        assert sp["comm"]["drops"] == sp["comm"]["tag_failures"] == 0
        with open(os.path.join(mh.host_dir(rp, r), "fault_log.json")) as f:
            log = json.load(f)
        assert log["events"] == []
        assert log["comm"]["transport"] == "PipelinedSocketTransport"
    assert _load_x(r2, 2, STEPS).tobytes() == _load_x(rp, 2, STEPS).tobytes()


def test_kill_rank_then_resume_completes(tmp_path):
    """SIGKILL rank 1 at step 3: the survivor finishes finite on the
    overlay (its fault log shows W doubly stochastic); ``--resume`` rolls
    back to the quorum, bumps the generation and completes."""
    root = str(tmp_path / "mh_chaos")
    o1 = mh.launch(_args(["--world", "2", "--steps", "6",
                          "--chaos-kill-rank", "1", "--chaos-kill-step", "3"],
                         root))
    assert o1["ok"] and o1["casualties"] == [1]
    with open(os.path.join(mh.host_dir(root, 0), "fault_log.json")) as f:
        ev = json.load(f)["events"][0]
    assert ev["dead"] == [2, 3]
    assert ev["row_sum_err"] < 1e-6 and ev["col_sum_err"] < 1e-6
    assert mh.quorum_step(root, 2) == 2
    o2 = mh.launch(_args(["--world", "2", "--steps", "6", "--resume"], root))
    assert o2["ok"] and o2["casualties"] == [] and o2["generation"] == 1
    for r in range(2):
        s = o2["ranks"][str(r)]
        assert s["finite"] and s["final_step"] == 6 and s["generation"] == 1
    assert np.isfinite(_load_x(root, 2, 6)).all()


@pytest.mark.parametrize("case", ["quorum", "generation", "split",
                                  "no_shard", "fingerprint", "no_card"])
def test_helpers_and_refusals(case, tmp_path):
    root = str(tmp_path)
    if case == "no_card":
        # the entry points default to the card and refuse a missing one
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        a = _args(["--world", "1"], None, device=False)
        assert a.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.run_rank(a)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mh.launch(_args(["--world", "2"], root, device=False))
    elif case == "quorum":
        like = {"x": np.zeros((1, 3), np.float32)}
        for r, steps in ((0, [2, 4, 6]), (1, [2, 4])):
            for s in steps:
                ckpt_io.save_checkpoint(mh.host_dir(root, r), s, like)
        assert mh.quorum_step(root, 2) == 4
        assert mh.quorum_step(root, 3) is None
    elif case == "generation":
        assert mh.next_generation(root, resume=False) == 0
        assert mh.next_generation(root, resume=True) == 0
        ckpt_io._atomic_write_json(os.path.join(root, mh.MANIFEST),
                                   {"generation": 0, "casualties": [1]})
        assert mh.next_generation(root, resume=True) == 1
        assert mh.next_generation(root, resume=False) == 0
        ckpt_io._atomic_write_json(os.path.join(root, mh.MANIFEST),
                                   {"generation": 3, "casualties": []})
        assert mh.next_generation(root, resume=True) == 3
    elif case == "split":
        with pytest.raises(ValueError, match="split"):
            mh.launch(_args(["--world", "3"], None))
    elif case == "no_shard":
        with pytest.raises(FileNotFoundError, match="resume"):
            mh.run_rank(_args(["--world", "1", "--resume", "--steps", "1"],
                              os.path.join(root, "empty")))
    else:
        d = os.path.join(root, "fp")
        assert mh.launch(_args(["--world", "1", "--steps", "2"], d))["ok"]
        with pytest.raises(ValueError, match="topology"):
            mh.run_rank(_args(["--world", "1", "--resume", "--steps", "2",
                               "--topology", "complete"], d))
        a = _args(["--world", "1", "--resume", "--steps", "2"], d)
        a.seed = 1  # the same shards, another deployment
        with pytest.raises(ValueError, match="deployment"):
            mh.run_rank(a)


def test_couple_and_first_u_match_reference():
    """The coupling of step k (static and dropout mixing, all alive and
    with rank 1's agents dead, generation 0 and 2) against the reference's
    `couple` (its lines, run here): the key roots, W_k and the support
    bitwise, B^k within 2 ulps; and step 0's u for agents 2 and 3 given
    the same gradients equal to the reference's ``obfuscated_gradient``
    bitwise."""
    from repro.core.mixing import metropolis_from_mask
    from repro.core.privacy import agent_key, obfuscated_gradient, sample_B
    from repro.launch.train import build_mixing as ref_build_mixing
    from repro_torch.core import prng
    from repro_torch.core.pdsgd import obfuscate_flat
    from repro_torch.kernels.ops import FlatLayout
    from repro_torch.launch.train import build_mixing

    for dropout in ("0.0", "0.3"):
        for gen in (0, 2):
            extra = ["--topology-dropout", dropout]
            args = _args(extra)
            ref_args = _args(extra, parser=RMH.build_multihost_parser,
                             device=False)
            shared, lam = mh._key_roots(
                argparse.Namespace(seed=0, private_lambda_keys=False), gen)
            couple = mh._coupler(build_mixing(args), shared, 4)
            ref_mixing = ref_build_mixing(ref_args)
            ref_root = jax.random.key(1)
            if gen:
                ref_root = jax.random.fold_in(
                    jax.random.fold_in(ref_root, 0x5eed), gen)
            assert np.array_equal(shared.numpy(), np.asarray(
                jax.random.key_data(ref_root)))
            for k in (0, 1, 5):
                for alive in (None, np.array([1, 1, 0, 0], np.float32)):
                    W, B, sup = couple(k, alive)
                    kj = jnp.asarray(k, jnp.int32)
                    Wr, supr, mask = ref_mixing.realize(kj)
                    if alive is not None:
                        base = (mask if mask is not None
                                else jnp.asarray(ref_mixing.base_mask,
                                                 jnp.float32))
                        a = jnp.asarray(alive)
                        mask = base * a[:, None] * a[None, :]
                        Wr = metropolis_from_mask(mask)
                        supr = mask + jnp.eye(4, dtype=jnp.float32)
                    sk = jax.random.fold_in(ref_root, k)
                    Br = sample_B(agent_key(jax.random.fold_in(sk, 2), kj,
                                            0), supr)
                    for got, want in ((W, Wr), (sup, supr)):
                        assert got.tobytes() == np.asarray(
                            want, np.float32).tobytes()
                    # B's Exp(1) draws are -log1p(-u): torch's log1p
                    # differs from XLA's by an ulp or two (`prng.
                    # exponential`, ROADMAP C), so B is held within 2 ulps
                    Br = np.asarray(Br, np.float32)
                    assert ((B > 0) == (Br > 0)).all()
                    ulps = np.abs(B.view(np.int32).astype(np.int64)
                                  - Br.view(np.int32).astype(np.int64))
                    assert ulps.max() <= 2, ulps.max()

    # step 0's u for the block [2, 4), the same g
    rng = np.random.default_rng(11)
    g_tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    layout = FlatLayout.of({"a": torch.zeros(3, 5),
                            "b": {"c": torch.zeros(7)}})
    G = torch.zeros((2, layout.width))
    for row, scale in ((0, 1.0), (1, -2.0)):
        G[row, :15] = torch.from_numpy(g_tree["a"].reshape(-1) * scale)
        G[row, 15:22] = torch.from_numpy(g_tree["b"]["c"] * scale)
    X = torch.from_numpy(rng.standard_normal((2, layout.width))
                         .astype(np.float32))
    lam_root = prng.key(1)
    lam_bar = torch.tensor(0.4, dtype=torch.float32)
    u = obfuscate_flat(X, G.clone(), layout, key=prng.fold_in(lam_root, 0),
                       step=0, lam_bar=lam_bar,
                       agents=torch.tensor([2, 3]))
    sk = jax.random.fold_in(jax.random.key(1), 0)
    for row, scale in ((0, 1.0), (1, -2.0)):
        tree = jax.tree.map(lambda a: jnp.asarray(a * scale), g_tree)
        want = obfuscated_gradient(
            agent_key(jax.random.fold_in(sk, 1), jnp.int32(0),
                      jnp.int32(2 + row)), tree, jnp.float32(0.4))
        flat = np.concatenate([np.asarray(want["a"]).reshape(-1),
                               np.asarray(want["b"]["c"])])
        assert u[row, :22].numpy().tobytes() == flat.tobytes()
        assert not u[row, 22:].any()


def test_world1_matches_reference_run_rank(tmp_path):
    """The port's world=1 rank, started from the reference's template
    through `repro_torch.convert`, against the reference's ``run_rank``
    over 3 steps with the clip at 1.0: every element within 1e-6 of the
    largest |x| (XLA and torch order the products and reductions of the
    gradients differently).  Found: 1.19e-7 at a scale of 2.40, one f32
    ulp of an entry near 1."""
    from repro.launch.train import build_parser as ref_parser
    from repro.models import build_model as ref_build_model
    from repro.configs import get_config as ref_get_config
    from repro_torch.convert import params_from_numpy

    rp, rr = str(tmp_path / "port"), str(tmp_path / "ref")
    extra = ["--world", "1", "--steps", "3", "--checkpoint-every", "3",
             "--grad-clip-kappa", "1.0"]
    ref_args = RMH.build_multihost_parser().parse_args(
        ["--arch", ARCH, "--agents", "4", "--steps", "3",
         "--per-agent-batch", "2", "--seq-len", "16", "--seed", "0",
         "--checkpoint-every", "3", "--checkpoint-dir", rr,
         "--grad-clip-kappa", "1.0", "--world", "1"])
    ref_args.rank, ref_args.generation = 0, 0
    RMH.run_rank(ref_args)
    template = ref_build_model(ref_get_config(ARCH)).init(
        jax.random.key(0))
    init = params_from_numpy(jax.tree.map(np.asarray, template))
    args = _args(extra, rp)
    args.rank, args.generation = 0, 0
    mh.run_rank(args, init_params=init)
    x_port, x_ref = _load_x(rp, 1, 3), _load_x(rr, 1, 3)
    assert x_port.shape == x_ref.shape
    dev = float(np.abs(x_port - x_ref).max())
    scale = float(np.abs(x_ref).max())
    assert dev <= 1e-6 * scale, f"max deviation {dev} (scale {scale})"
    # the steps did move the state
    x0 = mh.flatten_one(init)
    assert np.abs(x_ref - x0).max() > 100 * dev
