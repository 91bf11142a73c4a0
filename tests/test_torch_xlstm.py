"""The port's xLSTM family against the reference on the CPU, on shared
weights (the reference's init, carried over with
`repro_torch.convert.params_from_numpy`): xlstm-125m-smoke (f32, one mLSTM
and one sLSTM block) and xlstm-125m-tiny (one mLSTM block, a zero-size
sLSTM cache leaf).  The mLSTM's SSD runs through
`repro_torch.kernels.ssd_intra_chunk` (B11's plain version on the CPU,
with the wrapper's autograd Function in training).

Covered: the parameter tree across `params_from_numpy`; the loss and every
gradient; `forward_prefill`'s logits and every cache leaf; four
`forward_decode` steps, the slab updated in place; the slot-paged cache on
xLSTM's leaves (the sLSTM stack's batch axis is 2); the engine against the
port's own sequential decode and against the reference's engine, greedy
and at T = 0.8; the serve CLI; three PDSGD steps of `run_training`
against the reference's; the train CLI.

Tolerances (f32; measured on this CPU in brackets):
* loss: rtol 1e-6 [4.8e-7 absolute on ~7, 7e-8 relative];
* gradients: atol 2e-6 + rtol 1e-4 [largest |diff| 3.5e-7 on ``embed``,
  entries up to 0.34];
* prefill logits and cache leaves, and each decode step's: atol = rtol =
  2e-5 [logits 2.4e-6, ``slstm`` state 8.3e-6 after prefill], tighter than
  the dense model's 1e-4 (its random attention is sharper);
* token streams: equal;
* training: losses rtol 1e-5; parameters after three steps atol 1e-5 +
  rtol 1e-4.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import make_lm_pipeline
from repro.launch.train import build_parser as jax_train_parser
from repro.launch.train import run_training as jax_run_training
from repro.models import build_model as jax_build
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxEngine
from repro_torch import kernels  # noqa: F401  (before core.privacy)
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.privacy import tree_leaves, tree_paths, tree_unflatten
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.serve import (Request, ServeEngine, make_layout, read_slot,
                               sequential_decode, write_slot)

SMOKE, TINY = "xlstm-125m-smoke", "xlstm-125m-tiny"
TOL = 2e-5
_BUNDLES = {}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread: the tests stay fast beside other xdist workers
    (each comparison is between runs made with one thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundles(arch=SMOKE, seed=0):
    """(reference bundle, reference params, port bundle, port params) on
    the reference's init, built once per module."""
    key = (arch, seed)
    if key not in _BUNDLES:
        jb = jax_build(jax_config(arch))
        jp = jb.init(jax.random.key(seed))
        pb = build_model(get_config(arch))
        pp = params_from_numpy(jax.tree.map(np.asarray, jp))
        _BUNDLES[key] = (jb, jp, pb, pp)
    return _BUNDLES[key]


def _close(got: torch.Tensor, want, tol=TOL):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_configs_and_param_tree_match_reference():
    """Configs resolve to the reference's fields; the nested mlstm / slstm
    trees cross `params_from_numpy` with the reference's leaf paths,
    shapes and values; xlstm-125m has 95,626,008 parameters."""
    for arch in ("xlstm-125m", SMOKE, TINY):
        ours, theirs = get_config(arch), jax_config(arch)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "d_ff", "vocab_size", "head_dim",
                  "slstm_every", "dtype", "source", "tie_embeddings"):
            assert getattr(ours, f) == getattr(theirs, f), (arch, f)
    defs = build_model(get_config("xlstm-125m")).param_defs
    n = sum(int(np.prod(d.shape)) for d in tree_leaves(defs))
    assert n == 95_626_008
    for arch in (SMOKE, TINY):
        _, jp, pb, pp = _bundles(arch)
        jpaths = ["/".join(str(k.key) for k in path) for path, _ in
                  jax.tree_util.tree_flatten_with_path(jp)[0]]
        assert tree_paths(pp) == jpaths
        assert tree_paths(pb.param_defs) == jpaths
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(pp)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("arch", [SMOKE, TINY])
def test_loss_and_gradients_match_reference(arch):
    """S = 70 pads the chunked scan from 70 to 128 (two chunks of 64)."""
    jb, jp, pb, pp = _bundles(arch)
    batch = make_lm_pipeline(pb.cfg.vocab_size, 1, 2, 70, seed=1).batch_at(0)
    b0 = {k: v[0] for k, v in batch.items()}
    want_l, want_g = jax.jit(jax.value_and_grad(jb.loss_fn))(
        jp, jax.tree.map(jnp.asarray, b0))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(pp)]
    params = tree_unflatten(pp, leaves)
    loss = pb.loss_fn(params, {k: torch.from_numpy(v) for k, v in
                               b0.items()})
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=1e-6)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for path, a, g in zip(tree_paths(pp), jax.tree.leaves(want_g), grads):
        a = np.asarray(a)
        g = np.zeros_like(a) if g is None else g.numpy()
        np.testing.assert_allclose(g, a, atol=2e-6, rtol=1e-4, err_msg=path)


@pytest.mark.parametrize("arch", [SMOKE, TINY])
def test_prefill_and_decode_match_reference(arch):
    """Prefill of 9 tokens (one chunk of 9), then 4 decode steps (chunks of
    1) from the prefill's states; each step's logits and states against the
    reference's, and the port's cache written in place."""
    jb, jp, pb, pp = _bundles(arch)
    V = pb.cfg.vocab_size
    tokens = np.random.default_rng(1).integers(0, V, (2, 9), np.int32)
    want = jax.jit(jb.prefill_fn)(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = pb.prefill_fn(pp, {"tokens": torch.from_numpy(tokens)})
    assert got["pos"] == int(want["pos"]) == 9
    _close(got["logits"], want["logits"])
    assert set(got["cache"]) == set(want["cache"])
    for name in want["cache"]:
        _close(got["cache"][name], want["cache"][name])
    cache = {n: c.clone() for n, c in got["cache"].items()}
    ptrs = {n: c.data_ptr() for n, c in cache.items()}
    jcache, pos = want["cache"], 9
    rng = np.random.default_rng(2)
    decode = jax.jit(jb.decode_fn)
    for _ in range(4):
        tok = rng.integers(0, V, (2,), np.int32)
        w = decode(jp, jnp.asarray(tok), jcache, jnp.int32(pos))
        with torch.no_grad():
            g = pb.decode_fn(pp, torch.from_numpy(tok), cache, pos)
        assert g["cache"] is cache and g["pos"] == pos + 1
        assert {n: c.data_ptr() for n, c in cache.items()} == ptrs
        _close(g["logits"], w["logits"])
        for name in jcache:
            # the port's cache holds the new states: written in place
            _close(cache[name], w["cache"][name])
        jcache, pos = w["cache"], pos + 1


def test_cache_spec_matches_reference():
    from repro.models import xlstm as jax_xlstm
    from repro_torch.models import xlstm
    for arch in ("xlstm-125m", SMOKE, TINY):
        want = jax_xlstm.cache_spec(jax_config(arch), 3, 50)
        got = xlstm.cache_spec(get_config(arch), 3, 50)
        assert set(got) == set(want)
        for name, (shape, logical, dtype) in got.items():
            assert (shape, logical) == want[name][:2]
            assert dtype == torch.float32 and want[name][2] == "float32"


@pytest.mark.parametrize("arch", [SMOKE, TINY])
def test_paged_cache_roundtrip_on_xlstm_leaves(arch):
    """The sLSTM stack (n_s, 4, B, H, Ph) pages along axis 2; tiny's
    zero-size sLSTM leaf is static; each page reads back exactly and a
    write leaves the other slots' bytes and the slab's storage alone."""
    _, _, pb, pp = _bundles(arch)
    layout = make_layout(pb, 3, 16)
    axes = {n: l.batch_axis for n, l in layout.leaves.items()}
    if arch == SMOKE:
        assert axes == {"mlstm_C": 1, "mlstm_n": 1, "slstm": 2}
    else:
        assert axes == {"mlstm_C": 1, "mlstm_n": 1, "slstm": None}
        assert layout.leaves["slstm"].shape[0] == 0
    base = {n: torch.randn(l.shape, generator=torch.Generator()
                           .manual_seed(7)) for n, l in layout.leaves.items()}
    ptrs = {n: t.data_ptr() for n, t in base.items()}
    rng = np.random.default_rng(4)
    for slot in range(3):
        tokens = rng.integers(0, pb.cfg.vocab_size, (1, 5 + slot), np.int32)
        with torch.no_grad():
            page = pb.prefill_fn(pp, {"tokens": torch.from_numpy(tokens)})[
                "cache"]
        slab = {n: t.clone() for n, t in base.items()}
        assert write_slot(layout, slab, page, slot) is slab
        back = read_slot(layout, slab, slot)
        for name, l in layout.leaves.items():
            if l.batch_axis is None:
                continue
            assert torch.equal(back[name], page[name])
            for other in set(range(3)) - {slot}:
                assert torch.equal(slab[name].select(l.batch_axis, other),
                                   base[name].select(l.batch_axis, other))
        write_slot(layout, base, page, slot)
    assert {n: t.data_ptr() for n, t in base.items()} == ptrs


def _requests(cls, V, n_req=5, prompt_len=6, gen=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(req_id=i, tokens=rng.integers(0, V, prompt_len + (i % 3),
                                              dtype=np.int32),
                max_new_tokens=gen - (i % 2)) for i in range(n_req)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_matches_sequential_and_reference_engine(temperature):
    """5 requests on 2 slots with ragged prompts and budgets: the engine
    decodes exactly the tokens of the port's sequential decode and of the
    reference's engine.  A decode that returned fresh states without
    writing the slab would serve stale states here."""
    jb, jp, pb, pp = _bundles()
    V = pb.cfg.vocab_size
    max_seq_len = 6 + 2 + 5
    eng = ServeEngine(pb, pp, slots=2, max_seq_len=max_seq_len,
                      decode_chunk=3, temperature=temperature, seed=0)
    with torch.no_grad():
        got = {c.req_id: c.tokens for c in eng.run(_requests(Request, V))}
        assert sorted(got) == list(range(5))
        for r in _requests(Request, V):
            seq = sequential_decode(
                pb, pp, {"tokens": torch.from_numpy(r.tokens)[None]},
                r.req_id, r.max_new_tokens, temperature=temperature,
                base_key=prng.key(0), max_seq_len=max_seq_len)
            assert got[r.req_id] == seq, (r.req_id, got[r.req_id], seq)
    jeng = JaxEngine(jb, jp, slots=2, max_seq_len=max_seq_len,
                     decode_chunk=3, temperature=temperature, seed=0)
    want = {c.req_id: c.tokens for c in jeng.run(_requests(JaxRequest, V))}
    assert got == want


@pytest.mark.parametrize("arch", [SMOKE, TINY])
def test_serve_cli_parity(arch, capsys):
    argv = ["--arch", arch, "--slots", "2", "--requests", "3",
            "--prompt-len", "7", "--gen-tokens", "4", "--decode-chunk", "2",
            "--device", "cpu", "--parity-check"]
    assert serve.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["parity"] == "ok" and out["arch"] == arch
    assert out["completed"] == 3 and out["generated_tokens"] == 12


def test_run_training_walks_reference_trajectory():
    """Three PDSGD steps, 4 agents on a ring, seq 32, same flags and
    initial weights: the gradients go through the autograd Function around
    B11's plain version."""
    flags = ["--arch", SMOKE, "--agents", "4", "--topology", "ring",
             "--steps", "3", "--log-every", "1", "--seq-len", "32",
             "--seed", "3"]
    want = jax_run_training(jax_train_parser().parse_args(flags))
    _, jp, _, _ = _bundles(SMOKE, seed=3)
    got = train.run_training(train.build_parser().parse_args(
        flags + ["--device", "cpu"]), init_params=params_from_numpy(
            jax.tree.map(np.asarray, jp)))
    assert [r["step"] for r in got["history"]] == [0, 1, 2]
    for a, b in zip(want["history"], got["history"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for path, a, b in zip(tree_paths(got["state"].params),
                          jax.tree.leaves(want["state"].params),
                          tree_leaves(got["state"].params)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-4, err_msg=path)


def test_train_cli_runs_on_cpu(capsys):
    assert train.main(["--arch", TINY, "--agents", "3", "--steps", "2",
                       "--seq-len", "16", "--log-every", "1", "--device",
                       "cpu"]) == 0
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in recs)
