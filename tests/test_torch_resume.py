"""Checkpoint, resume and rollback in the port's trainer on the CPU
(the semantics of ``tests/test_resume.py``), on stablelm-3b-tiny at seq
16, one sequence an agent, 4 agents, on one torch thread.

The tiny model and the single thread keep the file fast when several
test workers share the cores: a 6-step smoke-model run took 4.9 s alone
and minutes beside five busy torch processes (torch's intra-op threads
wait on each other), the tiny model on one thread 1.1 s (measured).
Every run a test compares (the SIGKILLed subprocess included) uses the
same thread count, because a CPU reduction's bits depend on it.

A resumed run must replay the uninterrupted run exactly: the same
batches (random-access `batch_at`), the same per-step keys (fold_in on
the absolute step) and a step counter that keeps counting.  Held bit for
bit (tolerance: none) against the port's own uninterrupted runs, eager
and scanned: the reference's own eager-against-scanned test fails
(ROADMAP §C).  `tests/test_torch_resume_reference.py` holds the same
machinery against the reference.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch.checkpoint.manager as manager_mod
from repro_torch.checkpoint import (complete_steps, latest_step,
                                    load_checkpoint, save_checkpoint,
                                    step_dirname)
from repro_torch.core import prng
from repro_torch.core.mixing import make_mixing
from repro_torch.core.pdsgd import init_state, make_decentralized_step
from repro_torch.core.schedules import harmonic
from repro_torch.core.topology import make_topology
from repro_torch.faults import make_faults
from repro_torch.launch.train import build_parser, run_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "stablelm-3b-tiny", "--agents", "4", "--steps", "6",
        "--per-agent-batch", "1", "--seq-len", "16", "--log-every", "1",
        "--device", "cpu"]
FAULT = ["--fault-crash-rate", "0.2", "--fault-restart-rate", "0.5",
         "--nan-policy", "skip"]


def _run(extra):
    return run_training(build_parser().parse_args(BASE + extra))


def _buffers(result):
    s = result["state"]
    return (s.flat,) + tuple(s.tracker or ())


def _assert_same_state(a, b):
    assert a["state"].step == b["state"].step
    for x, y in zip(_buffers(a), _buffers(b), strict=True):
        assert torch.equal(x, y)  # the whole buffer, padding included


def _losses(result):
    return {h["step"]: h["loss"] for h in result["history"] if "loss" in h}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def uninterrupted():
    """One 6-step eager run and one scanned run (--unroll-k 3)."""
    return {"eager": _run([]), "scanned": _run(["--unroll-k", "3"])}


def test_scanned_and_eager_runs_walk_identical_trajectory(uninterrupted):
    _assert_same_state(uninterrupted["eager"], uninterrupted["scanned"])
    assert _losses(uninterrupted["eager"]) == _losses(
        uninterrupted["scanned"])


def test_scanned_resume_bit_identical(tmp_path, uninterrupted):
    d = str(tmp_path)
    first = _run(["--unroll-k", "3", "--steps", "3", "--checkpoint-dir", d,
                  "--checkpoint-every", "3"])
    assert latest_step(d) == 3 and first["resumed_from"] is None
    resumed = _run(["--unroll-k", "3", "--checkpoint-dir", d,
                    "--checkpoint-every", "3", "--resume"])
    assert resumed["resumed_from"] == 3 and resumed["state"].step == 6
    _assert_same_state(uninterrupted["scanned"], resumed)
    full = _losses(uninterrupted["scanned"])
    assert _losses(resumed) == {k: full[k] for k in range(3, 6)}


def test_eager_resume_skips_truncated_newest_step(tmp_path, uninterrupted):
    """The newest checkpoint loses its archive (a write torn by a crash):
    resume falls back to the previous complete step and still lands on
    the uninterrupted state."""
    d = str(tmp_path)
    _run(["--steps", "4", "--checkpoint-dir", d, "--checkpoint-every", "2"])
    assert complete_steps(d) == [2, 4]
    os.remove(os.path.join(d, step_dirname(4), "arrays.npz"))
    assert latest_step(d) == 2
    resumed = _run(["--checkpoint-dir", d, "--checkpoint-every", "2",
                    "--resume"])
    assert resumed["resumed_from"] == 2
    _assert_same_state(uninterrupted["eager"], resumed)
    full = _losses(uninterrupted["eager"])
    assert _losses(resumed) == {k: full[k] for k in range(2, 6)}


def test_terminal_checkpoint_saved_off_boundary(tmp_path):
    d = str(tmp_path)
    r = _run(["--steps", "3", "--checkpoint-dir", d,
              "--checkpoint-every", "2"])
    assert complete_steps(d) == [2, 3]
    layout = r["state"].layout
    like = init_state(layout.tree(torch.zeros(layout.width)), 4)
    assert load_checkpoint(d, 3, like).step == 3
    # resuming at the terminal step is a no-op that stays consistent
    resumed = _run(["--steps", "3", "--checkpoint-dir", d,
                    "--checkpoint-every", "2", "--resume"])
    assert resumed["resumed_from"] == 3
    _assert_same_state(r, resumed)
    assert complete_steps(d) == [2, 3]


def test_trainer_keep_last_retention(tmp_path):
    d = str(tmp_path)
    _run(["--steps", "3", "--checkpoint-dir", d, "--checkpoint-every", "1",
          "--keep-last", "2"])
    assert complete_steps(d) == [2, 3]
    resumed = _run(["--steps", "3", "--checkpoint-dir", d,
                    "--checkpoint-every", "1", "--keep-last", "2",
                    "--resume"])
    assert resumed["resumed_from"] == 3


def test_writers_write_identical_checkpoints(tmp_path):
    """The thread writer, the subprocess writer and --checkpoint-sync
    write the same bytes."""
    dirs = {}
    for name, flags in (("thread", []),
                        ("subprocess", ["--checkpoint-writer",
                                        "subprocess"]),
                        ("sync", ["--checkpoint-sync"])):
        dirs[name] = str(tmp_path / name)
        _run(["--steps", "1", "--checkpoint-dir", dirs[name],
              "--checkpoint-every", "1"] + flags)
    for f in ("arrays.npz", "tree.json"):
        blobs = {open(os.path.join(d, step_dirname(1), f), "rb").read()
                 for d in dirs.values()}
        assert len(blobs) == 1, f
    with pytest.raises(ValueError, match="mutually exclusive"):
        _run(["--checkpoint-dir", dirs["sync"], "--checkpoint-sync",
              "--checkpoint-writer", "thread"])


def test_writer_failure_surfaces_in_run_training(tmp_path, monkeypatch):
    monkeypatch.setattr(
        manager_mod.io, "commit_snapshot",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        _run(["--steps", "1", "--checkpoint-dir", str(tmp_path),
              "--checkpoint-every", "1"])


def test_fresh_run_clears_stale_checkpoint_dir(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 100, {"junk": torch.ones(2)})
    _run(["--steps", "1", "--checkpoint-dir", d, "--checkpoint-every", "1"])
    assert complete_steps(d) == [1]


def test_resume_refusals(tmp_path):
    """No checkpoint; --resume without a directory; a bad
    --checkpoint-every; a checkpoint whose state.step is not its
    directory's step."""
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _run(["--checkpoint-dir", str(tmp_path), "--resume"])
    with pytest.raises(ValueError, match="requires --checkpoint-dir"):
        _run(["--resume"])
    with pytest.raises(ValueError, match="--checkpoint-every must be"):
        _run(["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "0"])
    d = str(tmp_path / "mislabeled")
    _run(["--steps", "1", "--checkpoint-dir", d, "--checkpoint-every", "1"])
    os.rename(os.path.join(d, step_dirname(1)),
              os.path.join(d, step_dirname(5)))
    with pytest.raises(ValueError, match="mislabeled"):
        _run(["--checkpoint-dir", d, "--resume"])


def test_dsgt_resume_restores_tracker(tmp_path):
    """The checkpoint holds the whole state: the step and DSGT's tracker
    pair; a resumed DSGT run is the uninterrupted one."""
    d = str(tmp_path)
    full = _run(["--algorithm", "dsgt", "--steps", "2"])
    _run(["--algorithm", "dsgt", "--steps", "1", "--checkpoint-dir", d,
          "--checkpoint-every", "1"])
    resumed = _run(["--algorithm", "dsgt", "--steps", "2",
                    "--checkpoint-dir", d, "--resume"])
    assert resumed["resumed_from"] == 1 and len(_buffers(resumed)) == 3
    assert not torch.equal(resumed["state"].tracker[0],
                           torch.zeros_like(resumed["state"].tracker[0]))
    _assert_same_state(full, resumed)


def test_load_checkpoint_rejects_dtype_mismatch(tmp_path):
    state = init_state({"w": torch.ones((3, 2))}, 4)
    state.step = 17
    save_checkpoint(str(tmp_path), 17, state)
    like = init_state({"w": torch.zeros((3, 2), dtype=torch.bfloat16)}, 4)
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_checkpoint(str(tmp_path), 17, like)
    got = load_checkpoint(str(tmp_path), 17, like, allow_cast=True)
    assert got.step == 17 and got.flat.dtype == torch.bfloat16
    assert torch.equal(got.params["w"].float(), torch.ones((4, 3, 2)))


def test_resume_refuses_mismatched_fault_or_mixing_config(tmp_path):
    d = str(tmp_path)
    _run(FAULT + ["--steps", "1", "--checkpoint-dir", d,
                  "--checkpoint-every", "1"])
    with pytest.raises(ValueError, match="fault config"):
        _run(["--checkpoint-dir", d, "--resume"])  # fault flags dropped
    with pytest.raises(ValueError, match="fault config"):
        _run(FAULT[:1] + ["0.3"] + FAULT[2:] +
             ["--checkpoint-dir", d, "--resume"])  # another crash rate
    d2 = str(tmp_path / "clean")
    _run(["--steps", "1", "--checkpoint-dir", d2, "--checkpoint-every", "1"])
    with pytest.raises(ValueError, match="fault config"):
        _run(FAULT + ["--checkpoint-dir", d2, "--resume"])
    with pytest.raises(ValueError, match="mixing config"):
        _run(["--topology-dropout", "0.3", "--checkpoint-dir", d2,
              "--resume"])


def test_sigkill_mid_run_resumes_bit_identical(tmp_path, uninterrupted):
    """A trainer subprocess is killed (SIGKILL: no finally, no atexit)
    after its first durable checkpoint; --resume from what survived lands
    on the uninterrupted state."""
    d = str(tmp_path)
    env = dict(os.environ, OMP_NUM_THREADS="1")  # as this process
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + BASE +
        ["--checkpoint-dir", d, "--checkpoint-every", "2"],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 180.0
        while time.time() < deadline and proc.poll() is None:
            if (latest_step(d) or 0) >= 2:
                break
            time.sleep(0.05)
        killed = proc.poll() is None
        proc.kill()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.terminate()
    last = latest_step(d)
    assert last is not None and last >= 2
    if not killed:  # raced a fast finish: resume is then a no-op
        assert proc.returncode == 0
    resumed = _run(["--checkpoint-dir", d, "--checkpoint-every", "2",
                    "--resume"])
    assert resumed["resumed_from"] == last
    _assert_same_state(uninterrupted["eager"], resumed)


def _toy_loss(p, b):
    return ((p["w"] - b) ** 2).sum() + (p["v"] ** 2).sum()


@pytest.mark.parametrize("kw", [
    dict(algorithm="pdsgd"), dict(algorithm="dsgd"), dict(algorithm="dsgt"),
    dict(algorithm="dp_dsgd", sigma_dp=0.5), dict(kernel_layout="ring"),
    dict(grad_clip=0.1), dict(aggregation="trimmed_mean"),
    dict(faults=("corrupt", "nan"), nan_policy="warn"),
    dict(faults=("corrupt", "scale"), nan_policy="skip"),
    dict(faults=("crash", "neighbor-avg"), nan_policy="skip")],
    ids=["pdsgd", "dsgd", "dsgt", "dp_dsgd", "ring", "clip", "trimmed_mean",
         "corrupt-nan-warn", "corrupt-scale-skip", "crash-rejoin-skip"])
def test_padding_stays_zero(kw):
    """No step writes the flat buffers' padding, which a checkpoint does
    not hold (the reference has none): a tree of 22 parameters in rows of
    512 columns, 6 steps, every algorithm and fault route."""
    m = 4
    kw = dict(kw)
    if "faults" in kw:
        kind, mode = kw.pop("faults")
        kw["faults"] = (
            make_faults(m, corrupt_rate=0.5, corrupt_mode=mode,
                        guard_clip=None if mode == "nan" else 1e3, seed=1)
            if kind == "corrupt" else
            make_faults(m, crash_rate=0.3, restart_rate=0.5, rejoin=mode,
                        seed=1))
    mixing = make_mixing(make_topology("ring", m),
                         rate=0.3 if "faults" in kw else 0.0, seed=2)
    step = make_decentralized_step(_toy_loss, mixing, harmonic(0.1), **kw)
    gen = torch.Generator().manual_seed(0)
    state = init_state({"w": torch.randn(3, 5, generator=gen),
                        "v": torch.randn(7, generator=gen)}, m,
                       algorithm=kw.get("algorithm", "pdsgd"))
    assert state.layout.width - state.layout.size == 490
    for k in range(6):
        state, _ = step(state, torch.randn(m, 3, 5, generator=gen),
                        prng.fold_in(prng.key(0), k))
    n = state.layout.size
    for buf in (state.flat,) + tuple(state.tracker or ()):
        assert torch.equal(buf[:, n:], torch.zeros_like(buf[:, n:]))
