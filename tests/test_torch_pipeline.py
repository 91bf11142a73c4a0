"""The port's data pipeline and prefetcher against the reference's
(`repro.data`): `chunk_at`, `chunks` and `agent_slice` are bitwise the
reference's numpy (tolerance: none), and the `Prefetcher` keeps the
reference's lifecycle (order, close, GC, None items, errors, a dead
worker, overlap).  `make_placer` turns leaves into host tensors (pinned
for a CUDA device) and refuses a mesh that is not a `DeviceMesh` (its
mesh placement is held in tests/test_torch_sharded_train.py)."""
import gc
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import make_lm_pipeline as jax_pipeline
from repro_torch.data import (BATCH_LOGICAL, CHUNK_LOGICAL, Prefetcher,
                              make_lm_pipeline, make_placer, prefetch_chunks)
import repro_torch.data.prefetch as prefetch_mod

ARGS = dict(vocab_size=64, num_agents=4, per_agent_batch=2, seq_len=16,
            seed=3)


@pytest.fixture()
def pipeline():
    return make_lm_pipeline(**ARGS)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "repro-torch-data-prefetch" and t.is_alive()]


def _equal_trees(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_logical_axes_are_the_reference_ones():
    from repro.data import BATCH_LOGICAL as JB, CHUNK_LOGICAL as JC
    assert (BATCH_LOGICAL, CHUNK_LOGICAL) == (JB, JC)


@pytest.mark.parametrize("agent_slice", [None, (0, 2), (1, 3), (3, 4)])
def test_batches_and_chunks_bitwise_reference(pipeline, agent_slice):
    ref = jax_pipeline(**ARGS)
    for step in (0, 5, 31):
        _equal_trees(pipeline.batch_at(step, agent_slice),
                     ref.batch_at(step, agent_slice))
    _equal_trees(pipeline.chunk_at(7, 5, agent_slice),
                 ref.chunk_at(7, 5, agent_slice))
    got = list(pipeline.chunks(4, start_step=8, num_chunks=3,
                               agent_slice=agent_slice))
    want = list(ref.chunks(4, start_step=8, num_chunks=3,
                           agent_slice=agent_slice))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _equal_trees(g, w)
    it, rit = iter(pipeline), iter(ref)
    for _ in range(3):
        _equal_trees(next(it), next(rit))


def test_chunk_is_stacked_batches(pipeline):
    chunk = pipeline.chunk_at(7, 5)
    assert chunk["tokens"].shape == (5, 4, 2, 16)
    for i in range(5):
        _equal_trees({k: v[i] for k, v in chunk.items()},
                     pipeline.batch_at(7 + i))


def test_agent_slice_matches_full_stream_and_validates(pipeline):
    full = pipeline.batch_at(3)
    part = pipeline.batch_at(3, agent_slice=(1, 3))
    for name in ("tokens", "labels"):
        np.testing.assert_array_equal(part[name], full[name][1:3])
    for bad in ((0, 5), (-1, 2), (3, 3), (2, 1)):
        with pytest.raises(ValueError, match="agent_slice"):
            pipeline.batch_at(0, agent_slice=bad)


def test_prefetcher_yields_all_chunks_in_order(pipeline):
    with prefetch_chunks(pipeline, 4, num_chunks=5, device="cpu") as pf:
        got = list(pf)
    assert len(got) == 5
    for c, chunk in enumerate(got):
        assert isinstance(chunk["tokens"], torch.Tensor)
        np.testing.assert_array_equal(chunk["tokens"].numpy(),
                                      pipeline.chunk_at(4 * c, 4)["tokens"])
    assert _prefetch_threads() == []


def test_prefetch_chunks_honors_agent_slice(pipeline):
    with prefetch_chunks(pipeline, 2, start_step=4, num_chunks=2,
                         agent_slice=(2, 4)) as chunks:
        got = list(chunks)
    for c, chunk in enumerate(got):
        want = pipeline.chunk_at(4 + 2 * c, 2)
        np.testing.assert_array_equal(chunk["tokens"].numpy(),
                                      want["tokens"][:, 2:4])


def test_prefetcher_close_mid_stream_leaks_no_thread(pipeline):
    pf = prefetch_chunks(pipeline, 4, num_chunks=1000, depth=2)
    next(pf)
    assert _prefetch_threads() != []
    pf.close()
    assert _prefetch_threads() == []
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()  # idempotent


def test_prefetcher_abandoned_iterator_stops_on_gc(pipeline):
    pf = prefetch_chunks(pipeline, 4, num_chunks=1000, depth=2)
    next(pf)
    del pf
    gc.collect()
    deadline = time.time() + 2.0
    while _prefetch_threads() and time.time() < deadline:
        time.sleep(0.02)
    assert _prefetch_threads() == []


def test_prefetcher_passes_none_items_through():
    with Prefetcher(iter([None, 1, None])) as pf:
        assert list(pf) == [None, 1, None]


def test_prefetcher_propagates_worker_exception():
    def boom():
        yield {"x": np.zeros(3)}
        raise RuntimeError("synthesis failed")

    pf = Prefetcher(boom())
    next(pf)
    with pytest.raises(RuntimeError, match="synthesis failed"):
        next(pf)
    pf.close()
    assert _prefetch_threads() == []


def test_prefetcher_dead_worker_raises_instead_of_hanging(monkeypatch):
    def dead_loop(it, place, stop, q):
        q.put((next(it), None))  # one good item, then die sentinel-less

    monkeypatch.setattr(prefetch_mod, "_worker_loop", dead_loop)
    monkeypatch.setattr(prefetch_mod.Prefetcher, "_POLL_S", 0.05)
    pf = prefetch_mod.Prefetcher(iter([7, 8, 9]))
    assert next(pf) == 7
    with pytest.raises(RuntimeError, match="died without posting"):
        next(pf)
    assert pf._exhausted
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetcher_overlaps_source_with_consumer():
    delay = 0.15

    def slow_source():
        for i in range(4):
            time.sleep(delay)
            yield i

    t0 = time.perf_counter()
    with Prefetcher(slow_source(), depth=2) as pf:
        out = []
        for item in pf:
            time.sleep(delay)
            out.append(item)
    wall = time.perf_counter() - t0
    assert out == [0, 1, 2, 3]
    # serial would take 8 delays, overlapped about 5
    assert wall < 7 * delay


def test_prefetcher_rejects_zero_depth():
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter([1]), depth=0)


def test_make_placer_host_tensors_and_mesh_refusal(pipeline):
    chunk = make_placer("cpu")(pipeline.chunk_at(0, 3))
    assert isinstance(chunk["tokens"], torch.Tensor)
    assert chunk["tokens"].shape == (3, 4, 2, 16)
    assert chunk["tokens"].dtype == torch.int32
    assert not chunk["tokens"].is_pinned()
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_placer("cpu", mesh=object())


@pytest.mark.gpu
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_make_placer_pins_for_cuda(pipeline):
    chunk = make_placer("cuda")(pipeline.chunk_at(0, 2))
    assert chunk["tokens"].is_pinned()
    np.testing.assert_array_equal(chunk["tokens"].numpy(),
                                  pipeline.chunk_at(0, 2)["tokens"])
