"""The port's checkpoints (`repro_torch.checkpoint`) against the
reference's (`repro.checkpoint`) on the CPU.

* The manager's semantics, ported from ``tests/test_checkpoint_manager.py``
  on torch trees: atomic commits and discovery, the writer's lifecycle,
  back-pressure, retention, the manifest, retries, the debris sweep,
  ``fresh``, adoption, knob validation and the subprocess writer.
* Interop, on a smoke state (stablelm-3b-smoke, m = 3) in float32 with a
  DSGT tracker and in bfloat16, and on a tree mixing both dtypes: the
  port's ``arrays.npz`` and ``tree.json`` are byte-identical to
  ``repro.checkpoint.save_checkpoint``'s for the same values; each
  package restores the other's float32 archive bitwise, and the port the
  reference's bfloat16 archive (the reference cannot restore one:
  ROADMAP §C); manifests are equal for the same saves; the ZIP64 route.
Tolerance everywhere: none (bitwise).
"""
import filecmp
import json
import os
import subprocess
import sys
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.io as jax_io
from repro.checkpoint import CheckpointManager as JaxManager
from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_config
from repro.core import init_state as jax_init_state
from repro.models import build_model as jax_build
import repro_torch.checkpoint.io as io_mod
import repro_torch.checkpoint.manager as manager_mod
from repro_torch.checkpoint import (CheckpointManager, complete_steps,
                                    latest_step, load_checkpoint,
                                    read_run_meta, save_checkpoint,
                                    step_dirname)
from repro_torch.convert import params_from_numpy
from repro_torch.core.pdsgd import init_state

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _tree(v=1.0):
    return {"w": torch.full((2, 3), float(v)), "b": torch.full((4,), float(v))}


def _read_w(directory, step):
    return float(load_checkpoint(directory, step, _tree())["w"][0, 0])


# -- atomicity / discovery ---------------------------------------------------

def test_save_checkpoint_leaves_no_tmp_debris(tmp_path):
    save_checkpoint(str(tmp_path), 7, _tree())
    assert os.listdir(tmp_path) == [step_dirname(7)]
    assert latest_step(str(tmp_path)) == 7


def test_latest_step_skips_incomplete_and_staging_dirs(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 4, _tree())
    save_checkpoint(d, 8, _tree())
    os.remove(tmp_path / step_dirname(8) / "arrays.npz")
    assert latest_step(d) == 4
    (tmp_path / step_dirname(12)).mkdir()
    assert latest_step(d) == 4
    stage = tmp_path / (step_dirname(9) + ".tmp-12345")
    stage.mkdir()
    np.savez(stage / "arrays.npz", a0=np.zeros(3))
    (stage / "tree.json").write_text("{}")
    assert complete_steps(d) == [4]


def test_latest_step_wide_step_numbers(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 99_999_999, _tree(1))
    save_checkpoint(d, 100_000_000, _tree(2))
    assert complete_steps(d) == [99_999_999, 100_000_000]
    assert _read_w(d, 100_000_000) == 2.0


def test_commit_failure_leaves_no_partial_step(tmp_path, monkeypatch):
    real_write = io_mod._write_npz

    def dying_write(path, arrays):
        real_write(path, arrays)
        raise OSError("disk full")

    monkeypatch.setattr(io_mod, "_write_npz", dying_write)
    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 5, _tree())
    assert latest_step(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


# -- manager lifecycle -------------------------------------------------------

def test_async_write_lands_on_close(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(1))
    m.save(2, _tree(2))
    m.close()
    assert complete_steps(str(tmp_path)) == [1, 2]
    assert _read_w(str(tmp_path), 2) == 2.0


@pytest.mark.parametrize("writer", ["thread", "subprocess", "sync"])
def test_writers_equal_save_checkpoint(tmp_path, writer):
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))}
    with CheckpointManager(str(tmp_path / "a"), writer=writer) as m:
        m.save(5, tree)
    save_checkpoint(str(tmp_path / "s"), 5, tree)
    for f in ("arrays.npz", "tree.json"):
        assert filecmp.cmp(tmp_path / "a" / step_dirname(5) / f,
                           tmp_path / "s" / step_dirname(5) / f,
                           shallow=False)


def test_save_snapshots_before_caller_mutates(tmp_path):
    """save() snapshots: a tensor, a numpy leaf and a state updated in
    place after save() land as they were."""
    buf, arr = torch.ones((2, 2)), np.ones((3,), np.float32)
    state = init_state({"w": torch.ones((2, 3))}, 2)
    with CheckpointManager(str(tmp_path / "t")) as m:
        m.save(1, {"w": buf, "a": arr})
        buf.fill_(-1.0)
        arr[:] = -1.0
    with CheckpointManager(str(tmp_path / "s")) as m:
        m.save(1, state)
        state.flat.fill_(-1.0)
    out = load_checkpoint(str(tmp_path / "t"), 1,
                          {"w": torch.zeros((2, 2)),
                           "a": np.zeros(3, np.float32)})
    assert torch.equal(out["w"], torch.ones((2, 2)))
    np.testing.assert_array_equal(out["a"], np.ones(3))
    like = init_state({"w": torch.zeros((2, 3))}, 2)
    back = load_checkpoint(str(tmp_path / "s"), 1, like)
    assert torch.equal(back.params["w"], torch.ones((2, 2, 3)))


def test_worker_exception_surfaces_in_caller(tmp_path, monkeypatch):
    monkeypatch.setattr(
        manager_mod.io, "commit_snapshot",
        lambda *a, **k: (_ for _ in ()).throw(OSError("disk full")))
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree())
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        m.wait()
    with pytest.raises(RuntimeError) as exc:
        m.close()
    assert isinstance(exc.value.__cause__, OSError)


def test_save_idempotent_within_run_but_overwrites_across_runs(tmp_path):
    with CheckpointManager(str(tmp_path)) as m:
        assert m.save(3, _tree(3)) is True
        m.wait()
        assert m.save(3, _tree(99)) is False
    assert _read_w(str(tmp_path), 3) == 3.0
    with CheckpointManager(str(tmp_path)) as m:
        assert m.save(3, _tree(7)) is True
    assert _read_w(str(tmp_path), 3) == 7.0
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", step_dirname(3)]


def test_closed_manager_refuses_saves(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.close()
    with pytest.raises(RuntimeError, match="closed"):
        m.save(1, _tree())


def test_bounded_queue_backpressures_not_unbounded(tmp_path, monkeypatch):
    gate = threading.Event()
    real = manager_mod.io.commit_snapshot

    def slow_commit(*a, **k):
        gate.wait(timeout=10)
        return real(*a, **k)

    monkeypatch.setattr(manager_mod.io, "commit_snapshot", slow_commit)
    monkeypatch.setattr(manager_mod, "QUEUE_DEPTH", 1)
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(1))
    m.save(2, _tree(2))
    done = threading.Event()

    def third():
        m.save(3, _tree(3))
        done.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    assert not done.wait(timeout=0.3)  # back-pressured while writer stalls
    gate.set()
    assert done.wait(timeout=10)
    t.join(timeout=10)
    m.close()
    assert complete_steps(str(tmp_path)) == [1, 2, 3]


# -- retention / manifest ----------------------------------------------------

@pytest.mark.parametrize("keep_last,keep_every,want", [
    (2, 4, [4, 7, 8]), (1, None, [8]), (None, None, list(range(1, 9)))])
def test_retention(tmp_path, keep_last, keep_every, want):
    with CheckpointManager(str(tmp_path), keep_last=keep_last,
                           keep_every=keep_every) as m:
        for s in range(1, 9):
            m.save(s, _tree(s))
            if keep_last == 1:
                m.wait()
                assert m.latest_step() == s  # the newest survives every GC
    assert complete_steps(str(tmp_path)) == want
    assert _read_w(str(tmp_path), 8) == 8.0


def test_manifest_records_completed_steps(tmp_path):
    with CheckpointManager(str(tmp_path), keep_last=3) as m:
        for s in range(1, 6):
            m.save(s, _tree(s))
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["completed"] == [3, 4, 5] == complete_steps(str(tmp_path))
    assert manifest["policy"] == {"keep_last": 3, "keep_every": None}


@pytest.mark.parametrize("writer", ["thread", "sync"])
def test_writer_retries_transient_oserror(tmp_path, monkeypatch, writer):
    real = manager_mod.io.commit_snapshot
    fails = {"n": 2}

    def flaky(*a, **k):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient blip")
        return real(*a, **k)

    monkeypatch.setattr(manager_mod.io, "commit_snapshot", flaky)
    monkeypatch.setattr(manager_mod, "COMMIT_BACKOFF_S", 0.01)
    with CheckpointManager(str(tmp_path), writer=writer) as m:
        m.save(1, _tree(1))
        m.wait()
        assert m.retries == 2
    assert complete_steps(str(tmp_path)) == [1]
    assert json.loads((tmp_path / "manifest.json").read_text())[
        "retries"] == 2


def test_writer_parks_fatal_after_retry_budget(tmp_path, monkeypatch):
    calls = {"n": 0}

    def broken(*a, **k):
        calls["n"] += 1
        raise OSError("disk gone")

    monkeypatch.setattr(manager_mod.io, "commit_snapshot", broken)
    monkeypatch.setattr(manager_mod, "COMMIT_BACKOFF_S", 0.01)
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(1))
    with pytest.raises(RuntimeError, match="checkpoint writer failed"):
        m.wait()
    assert calls["n"] == 1 + manager_mod.COMMIT_RETRIES
    with pytest.raises(RuntimeError):
        m.close()


def test_manager_sweeps_stale_tmp_debris_on_open(tmp_path):
    stage = tmp_path / (step_dirname(9) + ".tmp-99999")
    stage.mkdir()
    (stage / "arrays.npz").write_text("torn")
    (tmp_path / "manifest.json.tmp-99999").write_text("{")
    parked = tmp_path / (step_dirname(2) + ".old-99999")
    parked.mkdir()
    with CheckpointManager(str(tmp_path)) as m:
        m.save(1, _tree())
    assert not stage.exists() and not parked.exists()
    assert not (tmp_path / "manifest.json.tmp-99999").exists()
    assert complete_steps(str(tmp_path)) == [1]


def test_manager_recovers_step_parked_mid_reswap(tmp_path):
    save_checkpoint(str(tmp_path), 4, _tree(4))
    os.rename(tmp_path / step_dirname(4),
              tmp_path / (step_dirname(4) + ".old-31337"))
    assert latest_step(str(tmp_path)) is None
    with CheckpointManager(str(tmp_path)) as m:
        assert m.completed_steps == [4]
    assert _read_w(str(tmp_path), 4) == 4.0


def test_fresh_manager_clears_stale_trajectory(tmp_path):
    save_checkpoint(str(tmp_path), 100, _tree(100))
    save_checkpoint(str(tmp_path), 200, _tree(200))
    with CheckpointManager(str(tmp_path), keep_last=2, fresh=True) as m:
        assert m.completed_steps == []
        m.save(2, _tree(2))
        m.wait()
        assert m.completed_steps == [2]
    assert complete_steps(str(tmp_path)) == [2]


def test_manager_adopts_existing_checkpoints(tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree(2))
    with CheckpointManager(str(tmp_path), keep_last=2) as m:
        assert m.completed_steps == [2]
        m.save(4, _tree(4))
        m.save(6, _tree(6))
    assert complete_steps(str(tmp_path)) == [4, 6]


@pytest.mark.parametrize("kwargs", [
    {"keep_last": 0}, {"keep_every": 0}, {"writer": None},
    {"writer": "fork"}])
def test_invalid_knobs_rejected(tmp_path, kwargs):
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), **kwargs)


# -- subprocess writer -------------------------------------------------------

def test_subprocess_writer_parity_with_thread(tmp_path):
    dirs = {}
    for flavor in ("thread", "subprocess"):
        d = dirs[flavor] = str(tmp_path / flavor)
        m = CheckpointManager(d, keep_last=2, keep_every=4, writer=flavor,
                              run_meta={"mixing": {"mode": "static"}})
        for s in (1, 2, 3, 4, 5, 6):
            m.save(s, _tree(s))
        m.close()
    assert complete_steps(dirs["thread"]) == complete_steps(
        dirs["subprocess"]) == [4, 5, 6]
    for name in ("manifest.json",) + tuple(
            os.path.join(step_dirname(s), f) for s in (4, 5, 6)
            for f in ("arrays.npz", "tree.json")):
        assert filecmp.cmp(os.path.join(dirs["thread"], name),
                           os.path.join(dirs["subprocess"], name),
                           shallow=False)
    assert read_run_meta(dirs["subprocess"], 6) == {
        "mixing": {"mode": "static"}}
    m2 = CheckpointManager(dirs["subprocess"], writer="subprocess")
    m2.save(7, _tree(7))
    m2.close()
    assert complete_steps(dirs["subprocess"]) == [4, 5, 6, 7]


def test_subprocess_writer_bf16_and_strided_leaves(tmp_path):
    """The child reads the arrays from a shared-memory segment: bfloat16
    words and a state's row-strided leaves land as the sync writer writes
    them."""
    gen = torch.Generator().manual_seed(5)
    state = init_state({"w": torch.randn(3, 5, generator=gen),
                        "v": torch.randn(7, generator=gen)}, 3)
    tree = {"state_rows": state.params["w"],  # a row-strided view
            "h": torch.randn(4, 6, generator=gen).to(torch.bfloat16)}
    for writer in ("subprocess", "sync"):
        with CheckpointManager(str(tmp_path / writer), writer=writer) as m:
            m.save(1, tree)
            m.save(2, state)
    for step in (1, 2):
        for f in ("arrays.npz", "tree.json"):
            assert filecmp.cmp(
                tmp_path / "subprocess" / step_dirname(step) / f,
                tmp_path / "sync" / step_dirname(step) / f, shallow=False)


def test_commit_child_imports_no_torch():
    """The subprocess writer's child unpickles its target from
    `checkpoint.manager`; that import pulls in numpy-level code only."""
    code = ("import sys, repro_torch.checkpoint.manager; "
            "assert 'torch' not in sys.modules, 'torch imported'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=SRC))


# -- interop with the reference ---------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    return jax_build(jax_config("stablelm-3b-smoke")).init(jax.random.key(0))


def _states(params, dtype, algorithm, step=5):
    pj = jax.tree.map(lambda a: a.astype(dtype), params)
    js = jax_init_state(pj, 3, algorithm=algorithm)
    js.step = jnp.asarray(step, jnp.int32)
    host = jax.tree.map(np.asarray, pj)
    ps = init_state(params_from_numpy(host), 3, algorithm=algorithm)
    ps.step = step
    if algorithm == "dsgt":  # a tracker that is not all zeros
        rng = np.random.default_rng(1)
        for t in ps.tracker:
            vals = rng.standard_normal(t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(vals))
            t[:, ps.layout.size:] = 0
        js.tracker = tuple(_jax_tree_like(js.params, ps.layout, t)
                           for t in ps.tracker)
    return js, ps


def _jax_tree_like(jtree, layout, buf):
    """The (m, ...) leaves of a port buffer as the reference's tree."""
    views = iter(v.numpy().copy() for v in layout.leaf_views(buf))
    return jax.tree.map(lambda _: jnp.asarray(next(views)), jtree)


def _same_files(a, b, step):
    for f in ("arrays.npz", "tree.json"):
        assert filecmp.cmp(os.path.join(a, step_dirname(step), f),
                           os.path.join(b, step_dirname(step), f),
                           shallow=False), f


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype,algorithm", [
    (jnp.float32, "dsgt"), (jnp.bfloat16, "pdsgd")])
def test_state_archives_byte_identical_to_reference(tmp_path, smoke_params,
                                                    dtype, algorithm):
    js, ps = _states(smoke_params, dtype, algorithm)
    meta = {"mixing": {"mode": "static", "num_agents": 3}}
    jax_save(str(tmp_path / "j"), 5, js, run_meta=meta)
    save_checkpoint(str(tmp_path / "t"), 5, ps, run_meta=meta)
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"), 5)
    tree = json.loads((tmp_path / "t" / step_dirname(5) /
                       "tree.json").read_text())
    assert tree["paths"] == [
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(js)[0]]
    # the port restores the reference's archive bitwise, in place
    like = init_state(params_from_numpy(jax.tree.map(
        lambda a: np.zeros_like(np.asarray(a)),
        jax.tree.map(lambda a: a.astype(dtype), smoke_params))), 3,
        algorithm=algorithm)
    ptr = like.flat.data_ptr()
    got = load_checkpoint(str(tmp_path / "j"), 5, like)
    assert got.step == 5 and got.flat.data_ptr() == ptr
    for a, b in zip((got.flat,) + tuple(got.tracker or ()),
                    (ps.flat,) + tuple(ps.tracker or ())):
        assert torch.equal(_bits(a), _bits(b))
    if dtype == jnp.float32:
        # the reference restores the port's float32 archive bitwise
        back = jax_load(str(tmp_path / "t"), 5, js)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        # the reference's own restore of a bfloat16 leaf fails (ROADMAP §C)
        with pytest.raises(ValueError):
            jax_load(str(tmp_path / "j"), 5, js)


def test_mixed_dtype_tree_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    b = rng.standard_normal((2, 4, 3)).astype(np.float32)
    jt = {"a": jnp.asarray(a), "n": {"b": jnp.asarray(b, jnp.bfloat16),
                                     "c": jnp.asarray(7, jnp.int32)}}
    pt = {"a": torch.from_numpy(a),
          "n": {"b": torch.from_numpy(b).to(torch.bfloat16),
                "c": torch.tensor(7, dtype=torch.int32)}}
    jax_save(str(tmp_path / "j"), 3, jt)
    save_checkpoint(str(tmp_path / "t"), 3, pt)
    _same_files(str(tmp_path / "j"), str(tmp_path / "t"), 3)
    got = load_checkpoint(str(tmp_path / "j"), 3, pt)
    assert torch.equal(got["a"], pt["a"])
    assert torch.equal(_bits(got["n"]["b"]), _bits(pt["n"]["b"]))
    assert got["n"]["c"].dtype == torch.int32 and int(got["n"]["c"]) == 7


def test_load_validates_paths_shapes_dtypes(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="dtype mismatch"):
        load_checkpoint(str(tmp_path), 1,
                        {"w": torch.zeros((2, 2), dtype=torch.float16)})
    out = load_checkpoint(str(tmp_path), 1,
                          {"w": torch.zeros((2, 2), dtype=torch.float16)},
                          allow_cast=True)
    assert out["w"].dtype == torch.float16
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 3))})
    with pytest.raises(ValueError, match="path mismatch"):
        load_checkpoint(str(tmp_path), 1, {"v": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path), 1, {"w": torch.zeros((2, 2)),
                                           "v": torch.zeros(1)})


def test_state_load_zeroes_padding_and_restores_step(tmp_path):
    params = {"w": torch.randn(3, 5), "v": torch.randn(7)}
    state = init_state(params, 4, algorithm="dsgt")
    state.step = 17
    save_checkpoint(str(tmp_path), 17, state)
    like = init_state({k: torch.zeros_like(v) for k, v in params.items()}, 4,
                      algorithm="dsgt")
    like.flat.fill_(float("nan"))  # padding included
    got = load_checkpoint(str(tmp_path), 17, like)
    assert got.step == 17 and got.flat.shape[1] > got.layout.size
    assert torch.equal(got.flat, state.flat)
    for a, b in zip(got.tracker, state.tracker):
        assert torch.equal(a, b)


def test_manifests_equal_reference_under_retention(tmp_path):
    for flavor, cls, tree in (("j", JaxManager, lambda s: {
            "w": jnp.full((2, 3), float(s))}), ("t", CheckpointManager,
                                                lambda s: {"w": torch.full(
                                                    (2, 3), float(s))})):
        with cls(str(tmp_path / flavor), keep_last=2, keep_every=4) as m:
            for s in range(1, 9):
                m.save(s, tree(s))
    assert filecmp.cmp(tmp_path / "j" / "manifest.json",
                       tmp_path / "t" / "manifest.json", shallow=False)
    assert complete_steps(str(tmp_path / "j")) == complete_steps(
        str(tmp_path / "t")) == [4, 7, 8]
    for s in (4, 7, 8):
        _same_files(str(tmp_path / "j"), str(tmp_path / "t"), s)


def test_zip64_route_above_threshold(tmp_path, monkeypatch):
    """Above the threshold both writers take the ZIP64 route (np.savez in
    the reference): the archives agree entry by entry and byte for byte
    apart from zipfile's time stamps."""
    monkeypatch.setattr(jax_io, "_ZIP64_THRESHOLD", 1 << 12)
    monkeypatch.setattr(io_mod, "_ZIP64_THRESHOLD", 1 << 12)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 50)).astype(np.float32)
    b = rng.standard_normal((30, 20)).astype(np.float32)
    jax_save(str(tmp_path / "j"), 2, {"a": jnp.asarray(a),
                                      "b": jnp.asarray(b, jnp.bfloat16)})
    save_checkpoint(str(tmp_path / "t"), 2,
                    {"a": torch.from_numpy(a),
                     "b": torch.from_numpy(b).to(torch.bfloat16)})
    paths = [str(tmp_path / d / step_dirname(2) / "arrays.npz")
             for d in ("j", "t")]
    infos = []
    for p in paths:
        with zipfile.ZipFile(p) as zf:
            infos.append([(i.filename, i.file_size, i.CRC, i.header_offset,
                           i.extra) for i in zf.infolist()])
    assert infos[0] == infos[1]
    raw = [open(p, "rb").read() for p in paths]
    for _, _, _, off, _ in infos[1]:  # each local header has a ZIP64 extra
        n = int.from_bytes(raw[1][off + 26:off + 28], "little")
        assert raw[1][off + 30 + n:off + 32 + n] == b"\x01\x00"
    assert len(raw[0]) == len(raw[1])
    diff = np.flatnonzero(np.frombuffer(raw[0], np.uint8)
                          != np.frombuffer(raw[1], np.uint8))
    stamps = set()
    for _, _, _, off, _ in infos[1]:
        stamps.update(range(off + 10, off + 14))  # local header time, date
    cd = raw[1].rfind(b"PK\x05\x06")
    cd_start = int.from_bytes(raw[1][cd + 16:cd + 20], "little")
    pos = cd_start
    while raw[1][pos:pos + 4] == b"PK\x01\x02":
        stamps.update(range(pos + 12, pos + 16))
        n, e, c = (int.from_bytes(raw[1][pos + o:pos + o + 2], "little")
                   for o in (28, 30, 32))
        pos += 46 + n + e + c
    assert set(diff.tolist()) <= stamps
    got = load_checkpoint(str(tmp_path / "j"), 2,
                          {"a": torch.zeros((40, 50)),
                           "b": torch.zeros((30, 20), dtype=torch.bfloat16)})
    assert torch.equal(got["a"], torch.from_numpy(a))
    assert torch.equal(_bits(got["b"]),
                       _bits(torch.from_numpy(b).to(torch.bfloat16)))


def test_zip64_state_rows_written_in_place(tmp_path, monkeypatch):
    """A state's leaves are row-strided views of its host copy; the ZIP64
    route writes them row by row, and the archive's entries equal the
    reference's (np.savez) for the same state."""
    monkeypatch.setattr(jax_io, "_ZIP64_THRESHOLD", 1 << 10)
    monkeypatch.setattr(io_mod, "_ZIP64_THRESHOLD", 1 << 10)
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "v": rng.standard_normal(7).astype(np.float32)}
    ps = init_state({k: torch.from_numpy(v) for k, v in params.items()}, 3,
                    algorithm="dsgt")
    ps.step = 9
    js = jax_init_state({k: jnp.asarray(v) for k, v in params.items()}, 3,
                        algorithm="dsgt")
    js.step = jnp.asarray(9, jnp.int32)
    save_checkpoint(str(tmp_path / "t"), 9, ps)
    jax_save(str(tmp_path / "j"), 9, js)
    infos = []
    for d in ("j", "t"):
        with zipfile.ZipFile(tmp_path / d / step_dirname(9) /
                             "arrays.npz") as zf:
            infos.append([(i.filename, i.file_size, i.CRC)
                          for i in zf.infolist()])
    assert infos[0] == infos[1]
    like = init_state({k: torch.zeros(v.shape) for k, v in params.items()},
                      3, algorithm="dsgt")
    got = load_checkpoint(str(tmp_path / "t"), 9, like)
    assert got.step == 9 and torch.equal(got.flat, ps.flat)
