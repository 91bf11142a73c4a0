"""The step configurations the reference's ``lax.scan`` holds, in the form
the port's CUDA graph of steps captures, on the CPU.

`make_scanned_steps` runs ``step.inner`` at a 0-d int64 counter tensor
(on the card inside a CUDA graph, on the CPU in a loop), so every draw of
a step — the coupling, the faults, B^k, Lambda^k, the sentinel flag —
comes from that counter.  These tests hold that form against the int
form of the eager loop, bit for bit (tolerance: none):

* `FaultProcess.realize` from a counter tensor against the int form and
  the reference's jitted realization, over 128 steps, in the modes of
  `tests/test_torch_faults.py`; `realize_coupling` likewise over 24;
* the outage-length thresholds against the float32 formula they stand
  for, over every uniform the draw can give;
* ``step.inner(..., torch.tensor(k))`` against ``step.inner(..., k)`` on
  the Fig. 2 workload (m = 5, paper_fig1), where a step takes
  milliseconds: faults with hold and with neighbor-avg rejoin, the
  sentinels under "warn" and "skip" with unguarded nan senders, and
  trimmed-mean aggregation; the int form is held against the reference
  in `tests/test_torch_faults.py`;
* the ring layout's tables built once per device against the per-call
  build;
* the trainer at ``--unroll-k 2`` against ``--unroll-k 1`` (two chunks,
  4 steps, stablelm-3b-tiny at seq 32 on one torch thread, as
  `tests/test_torch_resume.py` says why): faults, ``--nan-policy warn``
  and ``skip``, ``--kernel-layout ring`` static and with crash faults,
  and xlstm-125m-tiny; each trainer run is made once in a module
  fixture.

Only the port's unfused oracle (``eager=True``) is still refused by the
scanned step (`tests/test_torch_scanned.py`).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.faults import make_faults as jax_make_faults
from repro_torch.core import prng
from repro_torch.core.mixing import make_mixing
from repro_torch.core.pdsgd import (init_state, make_decentralized_step,
                                    make_scanned_steps)
from repro_torch.core.schedules import paper_experiment
from repro_torch.core.topology import make_topology
from repro_torch.dist import collectives as C
from repro_torch.faults import make_faults, realize_coupling
from repro_torch.faults.process import _duration_thresholds
from repro_torch.kernels import gossip
from repro_torch.launch.train import build_faults, build_parser, run_training
from test_torch_faults import MODES
from test_torch_scanned import FIG2_D, FIG2_M, fig2_batches, fig2_loss


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, nan payloads included."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).contiguous().view(torch.uint8),
        b.reshape(-1).contiguous().view(torch.uint8))


def _ctr(k: int) -> torch.Tensor:
    return torch.tensor(k, dtype=torch.int64)


# -- fault realizations from a counter tensor ----------------------------

@pytest.mark.parametrize("m", [5])
@pytest.mark.parametrize("mode", list(MODES))
def test_realize_from_counter_bitwise_over_128_steps(mode, m):
    kw = dict(MODES[mode], seed=3 + m)
    tf = make_faults(m, **kw)
    realize = jax.jit(jax_make_faults(m, **kw).realize)
    for step in range(128):
        ja, jc = (np.asarray(a) for a in realize(jnp.asarray(step,
                                                            jnp.int32)))
        ia, ic = tf.realize(step)
        ta, tc = tf.realize(_ctr(step))
        assert _same(ta, ia) and _same(tc, ic), (mode, m, step)
        assert np.array_equal(ja, ta.numpy()), (mode, m, step)
        assert np.array_equal(jc, tc.numpy()), (mode, m, step)
        # alive_before's where(step > 0, ...) form, through rejoin_mask
        assert _same(tf.rejoin_mask(_ctr(step)), tf.rejoin_mask(step))


@pytest.mark.parametrize("mix", [dict(), dict(rate=0.3, seed=2),
                                 dict(resample_every=3, seed=4)],
                         ids=["static", "dropout", "resample"])
def test_realize_coupling_from_counter_bitwise(mix):
    m = 6
    tp = make_mixing(make_topology("ring", m), **mix)
    tf = make_faults(m, crash_rate=0.25, restart_rate=0.5,
                     corrupt_rate=0.2, seed=9)
    for step in range(24):
        want = realize_coupling(tp, tf, step)
        got = realize_coupling(tp, tf, _ctr(step))
        for a, b in zip(want, got, strict=True):
            assert _same(a, b), step


@pytest.mark.parametrize("restart_rate,max_outage",
                         [(0.5, 64), (0.15, 64), (0.4, 7), (1.0, 64)])
def test_duration_thresholds_are_the_float32_formula(restart_rate,
                                                     max_outage):
    """dur(u) > d  <=>  u >= t_d, for every u = k 2^-23 and every d, with
    dur the reference's float32 formula: with t sorted, the length the
    thresholds give, 1 + #{d >= 1 : u >= t_d}, is dur(u) for every u."""
    t = _duration_thresholds(restart_rate, max_outage)
    assert t[0] == 0.0 and bool((t[1:] >= t[:-1]).all())
    u = prng.bits_to_uniform(torch.arange(1 << 23, dtype=torch.int64) << 9)
    if restart_rate < 1.0:
        dur = 1.0 + torch.floor(torch.log1p(-u) / torch.tensor(
            float(np.log1p(-restart_rate)), dtype=torch.float32))
        dur = torch.clamp(dur, 1.0, float(max_outage))
    else:
        dur = torch.ones_like(u)
    got = 1 + torch.searchsorted(t[1:], u, right=True)
    assert torch.equal(got, dur.long())


# -- the step at a counter tensor, on the Fig. 2 workload ----------------

GARBLE = dict(corrupt_rate=0.3, corrupt_mode="nan", guard_clip=None)
STEP_CASES = {
    "faults_hold": dict(faults=dict(crash_rate=0.2, restart_rate=0.5,
                                    corrupt_rate=0.2, seed=3),
                        nan_policy="skip"),
    "faults_neighbor_avg": dict(faults=dict(
        crash_rate=0.3, restart_rate=0.5, corrupt_rate=0.2,
        corrupt_mode="scale", corrupt_scale=30.0, rejoin="neighbor-avg",
        seed=5)),
    "failstop": dict(faults=dict(crash_rate=0.1, corrupt_rate=0.2,
                                 corrupt_mode="inf", seed=6)),
    "warn": dict(faults=dict(GARBLE, seed=1), nan_policy="warn"),
    "skip": dict(faults=dict(GARBLE, seed=1), nan_policy="skip"),
    "trimmed_mean": dict(faults=dict(crash_rate=0.1, restart_rate=0.5,
                                     corrupt_rate=0.2, corrupt_mode="scale",
                                     corrupt_scale=50.0, seed=4),
                         aggregation="trimmed_mean"),
}


def _fig2_step(case):
    kw = dict(STEP_CASES[case])
    faults = make_faults(FIG2_M, **kw.pop("faults"))
    topo = make_topology("paper_fig1", FIG2_M)
    if kw.get("aggregation") == "trimmed_mean":
        topo = make_topology("complete", FIG2_M)
    return make_decentralized_step(fig2_loss, topo, paper_experiment(0.05),
                                   faults=faults, **kw)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_inner_at_counter_equals_int_step_bitwise(case):
    """40 steps through ``step.inner`` at a counter tensor beside the int
    form: the same state bits after every step and the same aux (the
    fault counters 0-d int32 tensors in both)."""
    iters = 40
    prob, zb = fig2_batches(iters)
    M = torch.from_numpy(prob["M"])
    keys = prng.split(prng.key(0), iters)
    step = _fig2_step(case)
    a = init_state(torch.zeros(FIG2_D), FIG2_M, device="cpu")
    b = init_state(torch.zeros(FIG2_D), FIG2_M, device="cpu")
    seen = {}
    for k in range(iters):
        batch = (torch.from_numpy(zb[k]), M)
        a, aux_a = step.inner(a, batch, keys[k], k)
        b, aux_b = step.inner(b, batch, keys[k], _ctr(k))
        assert _same(a.flat, b.flat), (case, k)
        assert aux_a.keys() == aux_b.keys()
        for n, v in aux_a.items():
            assert _same(v, aux_b[n]), (case, k, n)
            if n.startswith("fault_"):
                assert v.dtype == torch.int32 and v.dim() == 0
                seen[n] = seen.get(n, 0) + int(v)
    if case in ("warn", "skip"):
        assert seen["fault_nonfinite"] > 0
        assert bool(torch.isfinite(a.flat).all()) == (case == "skip")
    else:
        assert seen["fault_corrupt"] > 0 and seen["fault_down"] > 0
    if case == "faults_neighbor_avg":
        assert seen["fault_rejoin"] > 0


@pytest.mark.parametrize("case", ["faults_hold", "skip", "trimmed_mean"])
def test_scanned_steps_equal_eager_steps_bitwise(case):
    """30 steps at unroll_k 10 through `make_scanned_steps` (the counter
    form) against the eager loop (the int form): the same state bits and
    the same stacked aux."""
    iters, unroll = 30, 10
    prob, zb = fig2_batches(iters)
    M = torch.from_numpy(prob["M"])
    keys = prng.split(prng.key(0), iters)
    step = _fig2_step(case)
    e = init_state(torch.zeros(FIG2_D), FIG2_M, device="cpu")
    aux_e = []
    for k in range(iters):
        e, aux = step(e, (torch.from_numpy(zb[k]), M), keys[k])
        aux_e.append(aux)
    scanned = make_scanned_steps(step, unroll)
    s = init_state(torch.zeros(FIG2_D), FIG2_M, device="cpu")
    Mk = M.expand(unroll, *M.shape).contiguous()
    aux_s = []
    for c in range(iters // unroll):
        sl = slice(c * unroll, (c + 1) * unroll)
        s, aux = scanned(s, (torch.from_numpy(zb[sl]), Mk), keys[sl])
        aux_s.append(aux)
    assert s.step == e.step == iters
    assert _same(s.flat, e.flat)
    for n in aux_e[0]:
        stacked = torch.cat([a[n] for a in aux_s])
        assert stacked.shape == (iters,)
        assert _same(stacked, torch.stack([a[n] for a in aux_e])), n


# -- the ring layout's tables, built once --------------------------------

@pytest.mark.parametrize("n_data,n_pod", [(2, 1), (4, 1), (5, 1), (4, 2)])
def test_ring_tables_built_once_equal_per_call_build(n_data, n_pod):
    m = n_data * n_pod
    mats = C._perm_matrices(n_data, n_pod)
    eye = np.eye(m, dtype=np.float32)
    wts = C.torus_weights(n_data, n_pod)
    b = torch.rand((m, 1 + len(mats)), generator=torch.Generator()
                   .manual_seed(m))
    # the per-call build: each matrix made from numpy at the call
    want_W = torch.from_numpy(wts["w_self"] * eye + wts["w_edge"]
                              * sum(mats, np.zeros_like(eye)))
    want_B = torch.from_numpy(eye) * b[None, :, 0]
    for di, Pm in enumerate(mats):
        want_B = want_B + torch.from_numpy(Pm) * b[None, :, 1 + di]
    for _ in range(2):
        W, B = C.dense_coupling(b, n_data, n_pod)
        assert _same(W, want_W) and _same(B, want_B)
    row = C._dense_on(n_data, n_pod, "cpu")["w_row"]
    assert _same(row[0], torch.tensor([wts["w_self"]] + [wts["w_edge"]]
                                      * len(mats), dtype=torch.float32))
    for perms in (C.source_table(n_data, n_pod), C.perm_stack(n_data,
                                                              n_pod)):
        first = gossip._sources_on(perms, "cpu")
        assert _same(first, gossip._sources(perms, m))
        assert gossip._sources_on(perms.clone(), "cpu") is first
    with pytest.raises(ValueError, match="permutation"):
        gossip._sources_on(torch.zeros((1, m), dtype=torch.int32), "cpu")


# -- the trainer at --unroll-k 2 against --unroll-k 1 ---------------------

BASE = ["--arch", "stablelm-3b-tiny", "--agents", "4", "--topology",
        "ring", "--steps", "4", "--per-agent-batch", "1", "--seq-len", "32",
        "--log-every", "1", "--seed", "2", "--device", "cpu"]
FAULT_RATES = ["--fault-crash-rate", "0.3", "--fault-restart-rate", "0.5"]
CORRUPT = ["--fault-corrupt-rate", "0.3", "--fault-corrupt-mode", "nan",
           "--fault-guard-clip", "0"]


def _fault_seed(extra):
    """The first fault seed under which the 4 steps see a down agent (with
    a crash rate) and a corrupt sender (with a corrupt rate)."""
    for seed in range(100):
        faults = build_faults(build_parser().parse_args(
            BASE + extra + ["--fault-seed", str(seed)]))
        rows = [faults.realize(k) for k in range(4)]
        if (faults.crash_rate == 0 or any(bool((a == 0).any())
                                          for a, _ in rows)) and (
                faults.corrupt_rate == 0 or any(bool(c.any())
                                                for _, c in rows)):
            return ["--fault-seed", str(seed)]
    raise AssertionError("no fault seed below 100 fires in 4 steps")


TRAIN_CASES = {
    "faults": FAULT_RATES + ["--fault-corrupt-rate", "0.3",
                             "--nan-policy", "skip"],
    "faults_neighbor_avg": FAULT_RATES + ["--fault-rejoin",
                                          "neighbor-avg"],
    "nan_policy_warn": CORRUPT + ["--nan-policy", "warn"],
    "nan_policy_skip": CORRUPT + ["--nan-policy", "skip"],
    "ring": ["--kernel-layout", "ring"],
    "ring_faults": ["--kernel-layout", "ring"] + FAULT_RATES,
    "xlstm": ["--arch", "xlstm-125m-tiny"],
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def trainer_runs():
    """Each case once eagerly and once at --unroll-k 2, made on first use."""
    runs = {}

    def get(case):
        if case not in runs:
            extra = TRAIN_CASES[case]
            if "--fault-crash-rate" in extra or "--fault-corrupt-rate" \
                    in extra:
                extra = extra + _fault_seed(extra)
            runs[case] = tuple(run_training(build_parser().parse_args(
                BASE + extra + unroll)) for unroll in ([], ["--unroll-k",
                                                            "2"]))
        return runs[case]

    return get


def _strip(history):
    """The records without their times, as JSON lines (nan == nan)."""
    return [json.dumps({k: v for k, v in r.items() if k != "elapsed_s"})
            for r in history]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_unroll_k_2_equals_unroll_k_1_bitwise(case, trainer_runs):
    """Two chunks through the scanned step against 4 eager steps: the same
    state bits, the same history (one record a step, the cumulative fault
    counters included) and the same fault totals."""
    eager, scanned = trainer_runs(case)
    assert scanned["state"].step == eager["state"].step == 4
    assert _same(scanned["state"].flat, eager["state"].flat)
    assert _strip(scanned["history"]) == _strip(eager["history"])
    assert scanned["fault_totals"] == eager["fault_totals"]
    totals = eager["fault_totals"]
    if "--fault-crash-rate" in TRAIN_CASES[case]:
        assert totals["fault_down"] > 0
    if case.startswith("nan_policy"):
        assert totals["fault_nonfinite"] > 0
        finite = bool(torch.isfinite(eager["state"].flat).all())
        assert finite == (case == "nan_policy_skip")
