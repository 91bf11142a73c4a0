"""The port's scanned step (`make_scanned_steps`, `--unroll-k`) on the CPU,
against its own eager loop and against the reference's eager loop, on
the paper's Fig. 2 workload and on the smoke model.

On the CPU the scanned step is a loop over the eager step, so the port's
scanned and eager trajectories are held bitwise.  Against the reference
the tolerance is relative: its own eager and scanned drivers differ on
jax 0.9.0 (ROADMAP §C), so the port is held to the reference's EAGER
run.  The North star's `final_err_scanned` = 0.07891825798133546 (the
reference's scanned run as `BENCH_pdsgd.json` recorded it) was drawn from
jax's earlier threefry stream: the port reproduces it with
``partitionable=False`` on the step and the keys (see the test).  Card-only tests
(marked gpu) hold the CUDA graph's replay against the eager loop bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import init_state as jax_init_state
from repro.core import make_decentralized_step as jax_make_step
from repro.core import make_topology as jax_make_topology
from repro.core.schedules import paper_experiment as jax_paper_experiment
from repro.data import estimation_problem
from repro.launch.steps import per_step_keys as jax_per_step_keys
from repro_torch.core import prng
from repro_torch.core.pdsgd import (init_state, make_decentralized_step,
                                    make_scanned_steps)
from repro_torch.core.schedules import paper_experiment
from repro_torch.core.topology import make_topology
from repro_torch.launch.steps import per_step_keys
from repro_torch.launch.train import build_parser, run_training

FIG2_M, FIG2_D = 5, 2
NORTH_STAR = 0.07891825798133546


def fig2_batches(iters: int):
    """`bench_step_path`'s workload: the problem, the per-step sample
    batches (iters, m, 8, s) and M."""
    prob = estimation_problem(FIG2_M, d=FIG2_D, s=3, n_per_agent=100,
                              seed=0)
    idx = np.random.default_rng(0).integers(0, 100, size=(iters, FIG2_M, 8))
    zb = prob["Z"][np.arange(FIG2_M)[None, :, None], idx]
    return prob, zb


def jax_fig2_loss(p, batch):
    z, Mi = batch
    return jnp.mean(jnp.sum((z - p @ Mi.T) ** 2, -1))


def fig2_loss(p, batch):
    z, Mi = batch
    return torch.mean(torch.sum((z - p @ Mi.T) ** 2, -1))


def fig2_err(prob, params) -> float:
    return float(np.linalg.norm(np.asarray(params).mean(0)
                                - prob["theta_opt"]))


def jax_fig2_run(iters: int, **kw) -> float:
    """The reference's eager loop on the Fig. 2 workload; final error."""
    prob, zb = fig2_batches(iters)
    step = jax_make_step(jax_fig2_loss,
                         jax_make_topology("paper_fig1", FIG2_M),
                         jax_paper_experiment(0.05), **kw)
    state = jax_init_state(jnp.zeros((FIG2_D,)), FIG2_M,
                           algorithm=kw.get("algorithm", "pdsgd"))
    keys = jax.random.split(jax.random.key(0), iters)
    M = jnp.asarray(prob["M"])
    for k in range(iters):
        state, _ = step(state, (jnp.asarray(zb[k]), M), keys[k])
    return fig2_err(prob, state.params)


def port_fig2_step(**kw):
    return make_decentralized_step(fig2_loss,
                                   make_topology("paper_fig1", FIG2_M),
                                   paper_experiment(0.05), **kw)


def port_fig2_eager(iters: int, **kw):
    """The port's eager loop on the Fig. 2 workload: (final error, state,
    per-step aux)."""
    prob, zb = fig2_batches(iters)
    step = port_fig2_step(**kw)
    state = init_state(torch.zeros(FIG2_D), FIG2_M, device="cpu",
                       algorithm=kw.get("algorithm", "pdsgd"))
    keys = prng.split(prng.key(0), iters, kw.get("partitionable", True))
    M = torch.from_numpy(prob["M"])
    auxes = []
    for k in range(iters):
        state, aux = step(state, (torch.from_numpy(zb[k]), M), keys[k])
        auxes.append(aux)
    return fig2_err(prob, state.params.numpy()), state, auxes


def port_fig2_scanned(iters: int, unroll_k: int, **kw):
    prob, zb = fig2_batches(iters)
    scanned = make_scanned_steps(port_fig2_step(**kw), unroll_k)
    state = init_state(torch.zeros(FIG2_D), FIG2_M, device="cpu",
                       algorithm=kw.get("algorithm", "pdsgd"))
    keys = prng.split(prng.key(0), iters, kw.get("partitionable", True))
    M = torch.from_numpy(np.broadcast_to(prob["M"], (unroll_k,)
                                         + prob["M"].shape).copy())
    auxes = []
    for c in range(iters // unroll_k):
        sl = slice(c * unroll_k, (c + 1) * unroll_k)
        state, aux = scanned(state, (torch.from_numpy(zb[sl]), M), keys[sl])
        auxes.append(aux)
    return fig2_err(prob, state.params.numpy()), state, auxes


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


@pytest.mark.parametrize("kw", [
    {}, {"algorithm": "dsgd"}, {"algorithm": "dsgt"},
    {"algorithm": "dp_dsgd", "sigma_dp": 0.05}, {"grad_clip": 0.5},
    {"kernel_rng": False}], ids=["pdsgd", "dsgd", "dsgt", "dp_dsgd",
                                 "clip", "bits"])
def test_scanned_equals_eager_bitwise_on_cpu(kw):
    """30 Fig. 2 steps, unroll_k 10: the same state bits, and the stacked
    aux equal to the eager steps' aux (tolerance: none)."""
    _, se, aux_e = port_fig2_eager(30, **kw)
    _, ss, aux_s = port_fig2_scanned(30, 10, **kw)
    assert ss.step == se.step == 30
    assert _same(ss.flat, se.flat)
    if se.tracker is not None:
        for a, b in zip(ss.tracker, se.tracker):
            assert _same(a, b)
    for name in ("loss", "consensus_error"):
        stacked = torch.cat([a[name] for a in aux_s])
        assert stacked.shape == (30,)
        assert _same(stacked, torch.stack([a[name] for a in aux_e]))


def test_fig2_600_scanned_reaches_north_star():
    """600 iterations at unroll_k 100 (the North star's run).  The recorded
    target was drawn from jax's earlier threefry stream (its default before
    0.5): with ``partitionable=False`` (the port) and under
    ``jax.threefry_partitionable(False)`` (the reference) the port ends
    4.5e-7 relative from 0.07891825798133546 (measured; held at rtol
    1e-5), and the reference's eager run there IS that number.  Under the
    partitionable stream (jax 0.9.0's default) both packages end at
    0.107645, held over 100 steps in `test_torch_baselines.py`."""
    got, _, _ = port_fig2_scanned(600, 100, partitionable=False)
    with jax.threefry_partitionable(False):
        want = jax_fig2_run(600)
    np.testing.assert_allclose(want, NORTH_STAR, rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_per_step_keys_bitwise_with_reference():
    for seed, start, n in ((1, 0, 7), (4, 95, 10), (123456789, 1234, 3)):
        want = np.asarray(jax.random.key_data(
            jax_per_step_keys(jax.random.key(seed), start, n)))
        got = per_step_keys(prng.key(seed), start, n)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        for i in range(n):
            assert torch.equal(got[i], prng.fold_in(prng.key(seed),
                                                    start + i))


def _train_flags(steps, *extra):
    return build_parser().parse_args(
        ["--arch", "stablelm-3b-tiny", "--agents", "4", "--topology",
         "ring", "--steps", str(steps), "--log-every", "1", "--seq-len",
         "32", "--seed", "2", "--device", "cpu", *extra])


@pytest.mark.parametrize("extra", [(), ("--algorithm", "dsgt")],
                         ids=["pdsgd", "dsgt"])
def test_run_training_unroll_2_equals_unroll_1_bitwise(extra):
    """5 steps: two chunks of 2 through the scanned step and an eager
    tail, against 5 eager steps — the same state bits and the same
    history (one record per step)."""
    a = run_training(_train_flags(5, *extra))
    b = run_training(_train_flags(5, "--unroll-k", "2", *extra))
    assert _same(a["state"].flat, b["state"].flat)
    strip = lambda h: [{k: v for k, v in r.items() if k != "elapsed_s"}
                       for r in h]
    assert strip(a["history"]) == strip(b["history"])
    assert [r["step"] for r in b["history"]] == list(range(5))


@pytest.mark.parametrize("extra", [
    ("--topology-dropout", "0.25"),
    ("--topology-resample-every", "2"),
    ("--topology-resample-every", "3")],
    ids=["dropout", "resample", "resample_3"])
def test_unroll_k_runs_time_varying_mixing_bitwise(extra):
    """A time-varying topology under --unroll-k 4: two chunks of 4 through
    the scanned step (on the card a CUDA graph realizing each W_k from the
    device counter) against 8 eager steps — the same state bits and the
    same history.  Resample periods 2 and 3 put a redraw inside a chunk
    (3 at a different offset in each chunk)."""
    a = run_training(_train_flags(8, *extra))
    b = run_training(_train_flags(8, "--unroll-k", "4", *extra))
    assert _same(a["state"].flat, b["state"].flat)
    strip = lambda h: [{k: v for k, v in r.items() if k != "elapsed_s"}
                       for r in h]
    assert strip(a["history"]) == strip(b["history"])
    assert [r["step"] for r in b["history"]] == list(range(8))


@pytest.mark.parametrize("extra", [
    ("--fault-crash-rate", "0.2", "--fault-restart-rate", "0.5"),
    ("--nan-policy", "warn"),
    ("--kernel-layout", "ring"),
    ("--arch", "xlstm-125m-tiny")],
    ids=["faults", "nan_policy", "ring", "xlstm"])
def test_unroll_k_refuses_what_the_graph_does_not_hold(extra):
    """--unroll-k > 1 raises a ValueError naming ROADMAP 0a, on any
    device, before a step runs."""
    with pytest.raises(ValueError, match="ROADMAP 0a"):
        run_training(_train_flags(4, "--unroll-k", "2", *extra))


def test_make_scanned_steps_refuses_unfused_oracle_and_trimmed_mean():
    for kw in ({"eager": True}, {"aggregation": "trimmed_mean"}):
        with pytest.raises(ValueError, match="ROADMAP 0a"):
            make_scanned_steps(port_fig2_step(**kw), 4)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA graph of steps runs only "
                    "there")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {}, {"kernel_rng": False}, {"algorithm": "dsgd"},
    {"algorithm": "dsgt"}, {"algorithm": "dp_dsgd", "sigma_dp": 0.05},
    {"grad_clip": 0.5}, {"partitionable": False}],
    ids=["pdsgd", "bits", "dsgd", "dsgt", "dp_dsgd", "clip",
         "earlier_stream"])
def test_cuda_graph_replay_equals_eager_bitwise(kw):
    """Fig. 2, 40 steps on the card: chunks of 10 through the CUDA graph
    (the first chunk its warm-up, three replays) against the eager loop;
    the same state bits and aux.  The wrappers count the warm-up chunk's
    launches; the replays' come from the capture."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    _need_cuda()
    dev = torch.device("cuda")
    prob, zb = fig2_batches(40)
    M = torch.from_numpy(prob["M"])
    keys = prng.split(prng.key(0), 40, kw.get("partitionable", True))
    step = port_fig2_step(**kw)
    alg = kw.get("algorithm", "pdsgd")
    se = init_state(torch.zeros(FIG2_D), FIG2_M, device=dev, algorithm=alg)
    aux_e = []
    for k in range(40):
        se, aux = step(se, (torch.from_numpy(zb[k]).to(dev), M.to(dev)),
                       keys[k])
        aux_e.append(aux["loss"])
    scanned = make_scanned_steps(port_fig2_step(**kw), 10)
    ss = init_state(torch.zeros(FIG2_D), FIG2_M, device=dev, algorithm=alg)
    Mk = M.expand(10, *M.shape).contiguous()
    aux_s = []
    reset_launch_counts()
    for c in range(4):
        sl = slice(10 * c, 10 * c + 10)
        ss, aux = scanned(ss, (torch.from_numpy(zb[sl]), Mk), keys[sl])
        aux_s.append(aux["loss"])
    assert _same(ss.flat, se.flat)
    assert _same(torch.cat(aux_s), torch.stack(aux_e))
    per = 0 if alg != "pdsgd" else 1
    for name in ("obfuscate_update_krng" if kw.get("kernel_rng", True)
                 else "obfuscate_update", "gossip_update"):
        assert launch_counts.get(name, 0) == 10 * per
        assert scanned.replayed_launches().get(name, 0) == 30 * per


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [(), ("--topology-dropout", "0.3"),
                                   ("--topology-resample-every", "3")],
                         ids=["static", "dropout", "resample"])
def test_cuda_run_training_unroll_equals_eager_smoke_model(extra):
    """stablelm-3b-smoke on the card: --unroll-k 2 over 4 steps (a warm-up
    chunk and a replay) against 4 eager steps, the same state bits; with
    a time-varying topology the replay realizes W_k on the card (resample
    3: the redraw at step 3 falls inside the replayed chunk)."""
    _need_cuda()
    flags = ["--arch", "stablelm-3b-smoke", "--agents", "4", "--steps",
             "4", "--log-every", "1", "--seq-len", "32", "--seed", "2",
             *extra]
    a = run_training(build_parser().parse_args(flags))
    b = run_training(build_parser().parse_args(flags + ["--unroll-k",
                                                        "2"]))
    assert _same(a["state"].flat, b["state"].flat)
