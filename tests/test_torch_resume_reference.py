"""The port's checkpoints, resume and rollback against the reference's
trainer on the CPU (stablelm-3b-tiny, seq 16, one sequence an agent, 4
agents, float32; the port on one torch thread, as
`tests/test_torch_resume.py` says why).

* The port resumes from a checkpoint the reference's ``run_training``
  wrote at step 4: the run metadata match, so it is accepted; the state
  it loads is the reference's bit for bit, and its own re-save of that
  step is byte-identical to the reference's archive.
* The resumed port's steps 4-6 agree with the reference's uninterrupted
  run: losses at rtol 1e-5 (largest 1.2e-7), the parameters after each
  step at `tests/test_torch_train.py`'s one-step tolerance, atol 1e-5 +
  rtol 1e-4 (largest ratio to it 0.0045, 0.014, 0.041 after one, two and
  three steps; measured).  On the smoke model the drift grows ~30x a
  step from there (1.4e-3 after two steps), as that file describes.
* ``run_meta`` equals the reference's for the same flags: static,
  dropout, resample, faults and ``--privacy-audit``.
* A rollback scenario (nan-corrupt senders, guard off, ``--nan-policy
  warn``) gives the reference's rollback records and exhaustion error,
  in the eager loop and at chunk grain in the scanned loop.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch
import repro.launch.audit as jax_audit
import repro_torch.launch.audit as port_audit
from repro.launch.train import build_parser as jax_parser
from repro.launch.train import run_training as jax_run
from repro_torch.checkpoint import read_run_meta, step_dirname
from repro_torch.launch.train import build_faults, build_mixing
from repro_torch.launch.train import build_parser, run_meta, run_training

FLAGS = ["--arch", "stablelm-3b-tiny", "--agents", "4",
         "--per-agent-batch", "1", "--seq-len", "16", "--log-every", "1"]


def _port(extra):
    return run_training(build_parser().parse_args(
        FLAGS + ["--device", "cpu"] + extra))


def _ref(extra):
    return jax_run(jax_parser().parse_args(FLAGS + extra))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 7-step run, checkpointed at every step."""
    d = str(tmp_path_factory.mktemp("ref"))
    res = _ref(["--steps", "7", "--checkpoint-dir", d,
                "--checkpoint-every", "1"])
    return {"dir": d, "result": res}


def _copy_at(reference, dst, step=4):
    """The reference's checkpoint directory holding ``step`` only."""
    shutil.copytree(reference["dir"], dst)
    for name in os.listdir(dst):
        if name.startswith("step_") and name != step_dirname(step):
            shutil.rmtree(os.path.join(dst, name))
    return str(dst)


def test_port_resumes_reference_checkpoint_bitwise(tmp_path, reference):
    d = _copy_at(reference, tmp_path / "ck")
    src = os.path.join(reference["dir"], step_dirname(4))
    res = _port(["--steps", "4", "--checkpoint-dir", d, "--resume"])
    assert res["resumed_from"] == 4 and res["state"].step == 4
    state = res["state"]
    with np.load(os.path.join(src, "arrays.npz")) as data:
        views = state.layout.leaf_views(state.flat)
        for i, v in enumerate(views):
            np.testing.assert_array_equal(v.numpy(), data[f"a{i}"])
        assert int(data[f"a{len(views)}"]) == 4
    # the terminal save rewrote step 4 in the port: the reference's bytes
    for f in ("arrays.npz", "tree.json"):
        with open(os.path.join(src, f), "rb") as a, \
                open(os.path.join(d, step_dirname(4), f), "rb") as b:
            assert a.read() == b.read(), f


def test_port_continues_reference_run(tmp_path, reference):
    d = _copy_at(reference, tmp_path / "ck")
    res = _port(["--steps", "7", "--checkpoint-dir", d,
                 "--checkpoint-every", "1", "--resume"])
    assert res["resumed_from"] == 4 and res["state"].step == 7
    want = {h["step"]: h["loss"] for h in reference["result"]["history"]
            if "loss" in h}
    got = {h["step"]: h["loss"] for h in res["history"] if "loss" in h}
    assert sorted(got) == [4, 5, 6]
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    for step in (5, 6, 7):
        with np.load(os.path.join(reference["dir"], step_dirname(step),
                                  "arrays.npz")) as ref, \
                np.load(os.path.join(d, step_dirname(step),
                                     "arrays.npz")) as port:
            assert ref.files == port.files
            for name in ref.files:
                np.testing.assert_allclose(port[name], ref[name],
                                           atol=1e-5, rtol=1e-4)


def _stub_audit(cfg, out=None, **kw):
    return {"ok": True, "parity": {"all_pass": True},
            "attacks": {"pdsgd_ls_recovery_mse": 1.0,
                        "theorem5_mse_bound": 0.1}}


@pytest.mark.parametrize("extra", [
    [], ["--topology-dropout", "0.25"],
    ["--topology", "erdos", "--topology-resample-every", "3",
     "--topology-seed", "5"],
    ["--fault-crash-rate", "0.2", "--fault-restart-rate", "0.5",
     "--fault-corrupt-rate", "0.25", "--fault-guard-clip", "0",
     "--fault-seed", "3", "--nan-policy", "skip"],
    ["--privacy-audit", "--grad-clip-kappa", "1.0"]],
    ids=["static", "dropout", "resample", "faults", "privacy_audit"])
def test_run_meta_equals_reference(tmp_path, monkeypatch, extra):
    """Both trainers with --steps 0 write only their terminal checkpoint;
    its ``run`` metadata is the same JSON (the audit itself is stubbed:
    its fingerprint comes from the flags)."""
    monkeypatch.setattr(jax_audit, "run_audit", _stub_audit)
    monkeypatch.setattr(port_audit, "run_audit", _stub_audit)
    monkeypatch.chdir(tmp_path)
    common = ["--steps", "0", "--checkpoint-every", "1"] + extra
    _ref(common + ["--checkpoint-dir", str(tmp_path / "j")])
    _port(common + ["--checkpoint-dir", str(tmp_path / "t")])
    want = read_run_meta(str(tmp_path / "j"), 0)
    got = read_run_meta(str(tmp_path / "t"), 0)
    assert json.dumps(got) == json.dumps(want)
    assert ("faults" in got) == ("--fault-crash-rate" in extra)
    assert ("privacy_audit" in got) == ("--privacy-audit" in extra)
    args = build_parser().parse_args(FLAGS + common)
    assert run_meta(args, build_mixing(args), build_faults(args)) == want


ROLLBACK = ["--fault-corrupt-rate", "0.25", "--fault-corrupt-mode", "nan",
            "--fault-guard-clip", "0", "--nan-policy", "warn",
            "--checkpoint-every", "2", "--rollback-patience", "2",
            "--max-rollbacks", "2", "--rollback-backoff", "0",
            "--steps", "8"]


def _rollback_seed():
    """The first fault seed whose first corrupt sender comes at step 3 or
    later (so step 2 is a durable, finite checkpoint)."""
    for seed in range(100):
        args = build_parser().parse_args(
            FLAGS + ROLLBACK + ["--fault-seed", str(seed)])
        faults = build_faults(args)
        first = next((k for k in range(8)
                      if bool(faults.realize(k)[1].any())), None)
        if first is not None and 3 <= first <= 5:
            return seed
    raise AssertionError("no fault seed below 100 fits")


def _rollback_run(run, extra, capsys):
    with pytest.raises(RuntimeError) as err:
        run(extra)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    return [r for r in lines if "rollback" in r], str(err.value)


@pytest.mark.parametrize("unroll_k", [1, 2])
def test_rollback_matches_reference(tmp_path, capsys, unroll_k):
    """The eager loop counts non-finite steps toward --rollback-patience,
    the scanned loop (--unroll-k 2) non-finite chunks: both trainers roll
    back to the same steps and fail with the same error."""
    seed = str(_rollback_seed())
    extra = ROLLBACK + ["--fault-seed", seed, "--unroll-k", str(unroll_k)]
    want = _rollback_run(
        _ref, extra + ["--checkpoint-dir", str(tmp_path / "j")], capsys)
    got = _rollback_run(
        _port, extra + ["--checkpoint-dir", str(tmp_path / "t")], capsys)
    assert got == want
    assert [r["rollback"] for r in got[0]] == [1, 2]
    assert "stayed non-finite through 2 rollback(s)" in got[1]
