"""The port's transport seam (`repro_torch.dist.transport`) against the
reference's (`repro.dist.transport`), on the same numpy inputs made from
a seed.

Every comparison is bitwise (tolerance: none): the messages, the
accumulation, the capture columns, the in-process exchange, the derived
secret, the frames a socket rank puts on the wire (byte for byte), and a
mixed deployment in which a port rank and a reference rank exchange over
loopback TCP between threads.  Then the port's own socket properties:
HMAC rejection, dead-peer drops, the pipelined transport against the
blocking one, its run-ahead window and its backpressure.
"""
import hashlib
import hmac
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import transport as RT
from repro.privacy.observe import wire_messages
from repro_torch.core.mixing import make_mixing
from repro_torch.core.topology import make_topology
from repro_torch.dist import transport as T


def _ring(m):
    A = np.zeros((m, m), np.int64)
    for i in range(m):
        A[i, (i + 1) % m] = A[(i + 1) % m, i] = 1
    return A


def _chord(m):
    """A ring and one chord: unequal degrees exercise the sender order."""
    A = _ring(m)
    A[0, m // 2] = A[m // 2, 0] = 1
    return A


def _coupling(rng, A):
    """A random f32 (W, B) pair on the adjacency's support plus the
    diagonal, B column-stochastic."""
    m = len(A)
    sup = ((np.asarray(A) > 0) | np.eye(m, dtype=bool)).astype(np.float32)
    W = (rng.random((m, m)).astype(np.float32) * sup).astype(np.float32)
    e = rng.exponential(size=(m, m)).astype(np.float32) * sup
    return W, (e / e.sum(0, keepdims=True)).astype(np.float32)


def _problem(seed, A, D, steps=1):
    rng = np.random.default_rng(seed)
    m = len(A)
    WBs = [_coupling(rng, A) for _ in range(steps)]
    x = rng.standard_normal((m, D)).astype(np.float32)
    us = [rng.standard_normal((m, D)).astype(np.float32)
          for _ in range(steps)]
    return WBs, x, us


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# -- the pure pieces, bitwise against the reference ----------------------

@pytest.mark.parametrize("what", ["link_message", "accumulate",
                                  "capture_columns", "merge_captures",
                                  "neighbor_lists"])
def test_pieces_match_reference(what):
    rng = np.random.default_rng(0)
    A = _chord(6)
    W, B = _coupling(rng, A)
    x = rng.standard_normal((6, 37)).astype(np.float32)
    u = rng.standard_normal((6, 37)).astype(np.float32)
    if what == "link_message":
        for i, j in ((0, 1), (0, 3), (2, 2), (4, 0)):
            assert _same(T.link_message(W[i, j], B[i, j], x[j], u[j]),
                         RT.link_message(W[i, j], B[i, j], x[j], u[j]))
        # the torch form: separate ops, the same bits
        t = T.link_message(torch.tensor(W[0, 1]), torch.tensor(B[0, 1]),
                           torch.from_numpy(x[1]), torch.from_numpy(u[1]))
        assert _same(t.numpy(), RT.link_message(W[0, 1], B[0, 1], x[1],
                                                u[1]))
    elif what == "accumulate":
        for i in range(6):
            self_term = RT.link_message(W[i, i], B[i, i], x[i], u[i])
            contribs = {int(j): RT.link_message(W[i, j], B[i, j], x[j],
                                                u[j])
                        for j in np.flatnonzero(A[i])}
            keep = {j: c.copy() for j, c in contribs.items()}
            got = T.accumulate(i, self_term.copy(), contribs)
            want = RT.accumulate(i, self_term, keep)
            assert _same(got, want)
            assert all(_same(contribs[j], keep[j]) for j in keep)
            # written in place: the self term into a row, then the sum
            row = np.empty_like(x[i])
            T.link_message(W[i, i], B[i, i], x[i], u[i], out=row)
            assert _same(row, self_term)
            assert T.accumulate(i, row, contribs, out=row) is row
            assert _same(row, want)
        with pytest.raises(ValueError, match="own"):
            T.accumulate(1, x[1], {1: u[1]})
    elif what == "capture_columns":
        for lo, L in ((0, 6), (2, 2), (3, 3)):
            assert _same(T.capture_columns(W, B, x[lo:lo + L],
                                           u[lo:lo + L], lo=lo),
                         RT.capture_columns(W, B, x[lo:lo + L],
                                            u[lo:lo + L], lo=lo))
    elif what == "merge_captures":
        blocks = [T.capture_columns(W, B, x[lo:lo + 2], u[lo:lo + 2], lo=lo)
                  for lo in (0, 2, 4)]
        full = T.merge_captures(blocks)
        assert _same(full, RT.merge_captures(blocks))
        assert _same(full, T.capture_columns(W, B, x, u, lo=0))
    else:
        for got, want in zip(T.neighbor_lists(A), RT.neighbor_lists(A)):
            assert np.array_equal(got, want)
        bad = _ring(4)
        bad[0, 1] = 0
        with pytest.raises(ValueError, match="symmetric"):
            T.neighbor_lists(bad)


def test_flatten_one_walks_the_reference_leaf_order():
    """A nested tree of torch tensors (bf16 and f32) flattens to the
    reference's vector of the same tree in numpy; `unflatten_one` is its
    exact inverse."""
    rng = np.random.default_rng(3)
    tree = {"b": {"z": rng.standard_normal((2, 3)).astype(np.float32),
                  "a": rng.standard_normal(4).astype(np.float32)},
            "a": rng.standard_normal((3,)).astype(np.float32),
            "c": np.float32(rng.standard_normal())}
    port_tree = {"b": {"z": torch.from_numpy(tree["b"]["z"]).bfloat16(),
                       "a": torch.from_numpy(tree["b"]["a"])},
                 "a": torch.from_numpy(tree["a"]),
                 "c": torch.tensor(tree["c"])}
    ref_tree = {"b": {"z": np.asarray(port_tree["b"]["z"].float()),
                      "a": tree["b"]["a"]},
                "a": tree["a"], "c": tree["c"]}
    flat = T.flatten_one(port_tree)
    assert _same(flat, RT.flatten_one(ref_tree))
    back = T.unflatten_one(flat, port_tree)
    assert _same(T.flatten_one(back), flat)
    assert back["b"]["z"].dtype == torch.float32
    assert tuple(back["b"]["z"].shape) == (2, 3)
    with pytest.raises(ValueError, match="template"):
        T.unflatten_one(flat[:-1], port_tree)


def test_inproc_matches_reference_and_wire_messages():
    """The in-process exchange equals the reference's bit for bit, and
    its capture equals the dense `wire_messages` tensor."""
    A = _chord(6)
    [(W, B)], x, [u] = _problem(1, A, 11)
    out, cap = T.InProcessTransport(A).exchange(x, u, W, B, capture=True)
    ref_out, ref_cap = RT.InProcessTransport(A).exchange(x, u, W, B,
                                                         capture=True)
    assert _same(out, ref_out) and _same(cap, ref_cap)
    dense = np.asarray(wire_messages(jnp.asarray(W), jnp.asarray(B),
                                     jnp.asarray(x), jnp.asarray(u)))
    # as values: the reference's own check (its dense off-support zeros
    # may carry the other sign)
    assert np.array_equal(cap, dense)
    np.testing.assert_allclose(out, W @ x - B @ u, rtol=1e-5, atol=1e-5)


def test_derive_wire_secret_matches_reference(monkeypatch):
    monkeypatch.delenv("REPRO_WIRE_SECRET", raising=False)
    for seed, gen in ((7, 0), (7, 1), (8, 0), (0, 3)):
        assert T.derive_wire_secret(seed, gen) == \
            RT.derive_wire_secret(seed, gen)
    a = T.derive_wire_secret(7, 0)
    assert len(a) == T.WIRE_TAG_SIZE == RT.WIRE_TAG_SIZE
    assert a not in (T.derive_wire_secret(8, 0), T.derive_wire_secret(7, 1))
    assert T.FRAME_HEADER.format == RT.FRAME_HEADER.format
    monkeypatch.setenv("REPRO_WIRE_SECRET", "hunter2")
    assert T.derive_wire_secret(7, 0) == b"hunter2" == \
        RT.derive_wire_secret(7, 0)


# -- sockets between threads ---------------------------------------------

def _socket_world(world, A, fn, *, classes, audit=False, timeout=30.0,
                  secrets=None, tkw=None):
    """Run ``fn(transport, rank)`` on one thread per rank over loopback
    TCP; ``classes[r]`` is rank r's transport class (port or reference),
    ``secrets`` one key or a per-rank dict.  Returns the per-rank
    results, re-raising the first worker error."""
    socks, endpoints = [], {}
    for r in range(world):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(world)
        socks.append(s)
        endpoints[r] = ("127.0.0.1", s.getsockname()[1])
    results, errs = [None] * world, []

    def run(r):
        try:
            sec = secrets.get(r) if isinstance(secrets, dict) else secrets
            tr = classes[r](A, r, world, endpoints, socks[r],
                            timeout=timeout, audit_wire=audit, secret=sec,
                            **(tkw or {}))
            try:
                results[r] = fn(tr, r)
            finally:
                tr.close()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    if errs:
        raise errs[0]
    return results


def _drive_steps(WBs, x, us, L, capture=True):
    """A rank's driver: ``len(WBs)`` exchanges of its block."""
    def drive(tr, r):
        lo = r * L
        xb = x[lo:lo + L].copy()
        caps = []
        for k, (W, B) in enumerate(WBs):
            res = tr.exchange(xb, us[k][lo:lo + L], W, B, step=k,
                              capture=capture)
            xb, cap = res if capture else (res, None)
            caps.append(cap)
        return xb, caps, tr.drops, sorted(tr.dead_ranks)
    return drive


def _inproc_run(A, WBs, x, us):
    tr = T.InProcessTransport(A)
    caps = []
    for k, (W, B) in enumerate(WBs):
        x, cap = tr.exchange(x, us[k], W, B, step=k, capture=True)
        caps.append(cap)
    return x, caps


def _check_against_inproc(results, A, WBs, x, us, L):
    x_ref, caps_ref = _inproc_run(A, WBs, x, us)
    for r, (xb, caps, drops, dead) in enumerate(results):
        assert drops == 0 and dead == []
        assert _same(xb, x_ref[r * L:(r + 1) * L])
    for k in range(len(WBs)):
        merged = T.merge_captures([res[1][k] for res in results])
        assert _same(merged, caps_ref[k])


KEY = T.derive_wire_secret(7, 0)


@pytest.mark.parametrize("secret", [None, KEY], ids=["plain", "hmac"])
def test_socket_frames_byte_identical_to_reference(secret):
    """A port world and a reference world on the same inputs put the
    same frames on the wire, byte for byte: header, the f32 v_ij payload
    and, with a secret, the tag; nothing else."""
    A = _ring(4)
    [(W, B)], x, [u] = _problem(5, A, 6)

    def drive(tr, r):
        tr.exchange(x[r * 2:(r + 1) * 2], u[r * 2:(r + 1) * 2], W, B,
                    step=7)
        return list(tr.sent_frames)

    port = _socket_world(2, A, drive, audit=True, secrets=secret,
                         classes=[T.SocketTransport] * 2)
    ref = _socket_world(2, A, drive, audit=True, secrets=secret,
                        classes=[RT.SocketTransport] * 2)
    piped = _socket_world(2, A, drive, audit=True, secrets=secret,
                          classes=[T.PipelinedSocketTransport] * 2)
    assert port == ref == piped
    expected_v = RT.capture_columns(W, B, x, u, lo=0)
    tag = T.WIRE_TAG_SIZE if secret else 0
    for r, sent in enumerate(port):
        assert len(sent) == 2  # one cross-rank link each way per agent
        for frame in sent:
            hdr = frame[:T.FRAME_HEADER.size]
            step, j, i, nbytes = T.FRAME_HEADER.unpack(hdr)
            body = frame[T.FRAME_HEADER.size:len(frame) - tag]
            assert step == 7 and nbytes == len(body) == 6 * 4
            assert j // 2 == r and i // 2 != r
            assert body == expected_v[i, j].tobytes()
            if secret:
                assert frame[-tag:] == hmac.new(secret, hdr + body,
                                                hashlib.sha256).digest()


@pytest.mark.parametrize("kind", ["blocking", "pipelined"])
@pytest.mark.parametrize("A,world", [(_ring(8), 2), (_chord(8), 4)],
                         ids=["ring-w2", "chord-w4"])
def test_mixed_deployment_matches_inproc(kind, A, world):
    """Port ranks and reference ranks in one deployment (alternating),
    authenticated, 3 steps with W and B re-realized each step: every
    block and every merged capture equals `InProcessTransport`'s."""
    WBs, x, us = _problem(4, A, 9, steps=3)
    cls = {"blocking": (T.SocketTransport, RT.SocketTransport),
           "pipelined": (T.PipelinedSocketTransport,
                         RT.PipelinedSocketTransport)}[kind]
    classes = [cls[r % 2] for r in range(world)]
    L = len(A) // world
    results = _socket_world(world, A, _drive_steps(WBs, x, us, L),
                            classes=classes, secrets=KEY)
    _check_against_inproc(results, A, WBs, x, us, L)


@pytest.mark.parametrize("case", ["wrong_key", "untagged"])
def test_hmac_rejects_tampered_and_untagged_frames(case):
    """A frame under another key, or a stream without tags, fails at the
    receiver: the channel is marked dead, its v never enters the sum, and
    the exchange ends with the local links only."""
    A = _ring(4)
    [(W, B)], x, [u] = _problem(9, A, 6)
    secrets = ({0: T.derive_wire_secret(1, 0), 1: T.derive_wire_secret(2, 0)}
               if case == "wrong_key" else {0: KEY, 1: None})

    def drive(tr, r):
        out = tr.exchange(x[r * 2:(r + 1) * 2], u[r * 2:(r + 1) * 2], W, B,
                          step=0)
        return out, tr.tag_failures, sorted(tr.dead_ranks), tr.drops

    results = _socket_world(2, A, drive, timeout=5.0, secrets=secrets,
                            classes=[T.SocketTransport] * 2)
    checked = range(2) if case == "wrong_key" else (0,)
    if case == "wrong_key":
        # the first rank to reject closes its channel, and the other may
        # then see the reset before it reads a tag
        assert sum(res[1] for res in results) >= 1
    for r in checked:
        out, fails, dead, drops = results[r]
        assert dead == [1 - r] and drops >= 1
        expect = np.empty_like(out)
        for l, i in enumerate(range(r * 2, r * 2 + 2)):
            contribs = {int(j): RT.link_message(W[i, j], B[i, j], x[j], u[j])
                        for j in np.flatnonzero(A[i]) if j // 2 == r}
            expect[l] = RT.accumulate(
                i, RT.link_message(W[i, i], B[i, i], x[i], u[i]), contribs)
        assert _same(out, expect)


@pytest.mark.parametrize("cls,tkw", [
    (T.SocketTransport, {}),
    (T.PipelinedSocketTransport, {"frames_ahead": 2}),
], ids=["blocking", "pipelined"])
def test_dead_peer_drops_counted_exactly(cls, tkw):
    """Rank 1 leaves after step 0: rank 0 does not hang, marks it dead
    and counts every missing contribution each step (2 cross-rank links
    of the 4-ring x 2 steps = 4 drops), and its output stays finite."""
    A = _ring(4)
    [(W, B)], x, [u] = _problem(22, A, 5)
    barrier = threading.Barrier(2, timeout=30)

    def drive(tr, r):
        xb, ub = x[r * 2:(r + 1) * 2].copy(), u[r * 2:(r + 1) * 2]
        xb = tr.exchange(xb, ub, W, B, step=0)
        barrier.wait()
        if r == 1:
            return None  # closed on return: the peer sees EOF
        for k in (1, 2):
            xb = tr.exchange(xb, ub, W, B, step=k)
            assert np.isfinite(xb).all()
        assert 1 in tr.dead_ranks
        return tr.drops

    assert _socket_world(2, A, drive, timeout=5.0, classes=[cls] * 2,
                         tkw=tkw)[0] == 4


def test_pipelined_ctor_validates_knobs():
    with pytest.raises(ValueError, match="outbox_frames"):
        T.PipelinedSocketTransport(_ring(4), 0, 1, {}, None, outbox_frames=0)
    with pytest.raises(ValueError, match="frames_ahead"):
        T.PipelinedSocketTransport(_ring(4), 0, 1, {}, None, frames_ahead=-1)


def _mixing_coupling(dropout, m=4, steps=4):
    """(W_k, B^k) of the port's mixing process on a ring, B from numpy."""
    mixing = make_mixing(make_topology("ring", m), rate=dropout, seed=5)
    rng = np.random.default_rng(3)
    WBs = []
    for k in range(steps):
        W, support, _ = mixing.realize(k)
        e = rng.exponential(size=(m, m)).astype(np.float32) \
            * support.numpy()
        WBs.append((W.numpy().astype(np.float32),
                    (e / e.sum(0, keepdims=True)).astype(np.float32)))
    A = (mixing.base_mask.numpy() > 0).astype(np.int64)
    return A, WBs


@pytest.mark.parametrize("frames_ahead", [0, 2])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_pipelined_matches_blocking_bitwise(dropout, frames_ahead):
    """The pipelined transport walks the blocking one's trajectory and
    captures exactly, static and dropout mixing, in lockstep and with
    run-ahead."""
    A, WBs = _mixing_coupling(dropout)
    _, x, us = _problem(7, A, 8, steps=len(WBs))
    drive = _drive_steps(WBs, x, us, 2)
    blk = _socket_world(2, A, drive, classes=[T.SocketTransport] * 2,
                        secrets=KEY)
    pip = _socket_world(2, A, drive,
                        classes=[T.PipelinedSocketTransport] * 2,
                        secrets=KEY, tkw={"frames_ahead": frames_ahead})
    for b, p in zip(blk, pip):
        assert _same(b[0], p[0]) and b[2] == p[2] == 0
        assert all(_same(cb, cp) for cb, cp in zip(b[1], p[1]))
    _check_against_inproc(pip, A, WBs, x, us, 2)


@pytest.mark.parametrize("case", ["runahead", "outbox_one"])
def test_pipelined_runahead_and_backpressure(case):
    """``frames_ahead=3``: rank 0 runs ahead while rank 1 stalls, its
    frames parked by step id and consumed in order; ``outbox_frames=1``:
    the send thread drains one frame at a time.  Both exact, no drops."""
    A = _ring(4) if case == "runahead" else _chord(4)
    WBs, x, us = _problem(21, A, 8, steps=3)
    done0 = threading.Event()
    tkw = ({"frames_ahead": 3} if case == "runahead"
           else {"outbox_frames": 1})

    def drive(tr, r):
        xb = x[r * 2:(r + 1) * 2].copy()
        for k, (W, B) in enumerate(WBs):
            if case == "runahead" and r == 1 and not done0.is_set():
                time.sleep(0.3)  # stall: rank 0 must run ahead
            xb = tr.exchange(xb, us[k][r * 2:(r + 1) * 2], W, B, step=k)
        if r == 0:
            done0.set()
        return xb, tr.drops

    results = _socket_world(2, A, drive,
                            classes=[T.PipelinedSocketTransport] * 2,
                            tkw=tkw)
    x_ref, _ = _inproc_run(A, WBs, x, us)
    for r, (xb, drops) in enumerate(results):
        assert drops == 0
        assert _same(xb, x_ref[r * 2:(r + 1) * 2])
    if case == "runahead":
        assert done0.is_set()


@pytest.mark.parametrize("cls", [T.SocketTransport,
                                 T.PipelinedSocketTransport],
                         ids=["blocking", "pipelined"])
def test_frames_larger_than_socket_buffers(cls):
    """12 MB frames, far above loopback's socket buffers, both ranks
    sending at once: the blocking transport sends beside its receive pump
    (sending everything first, both ranks would wait in sendall), and the
    in-process exchange, by column ranges on threads, equals the
    reference's bit for bit."""
    A = _ring(4)
    [(W, B)], x, [u] = _problem(31, A, 3_000_000)
    want = RT.InProcessTransport(A).exchange(x, u, W, B)
    assert _same(T.InProcessTransport(A).exchange(x, u, W, B), want)

    def drive(tr, r):
        out = tr.exchange(x[r * 2:(r + 1) * 2], u[r * 2:(r + 1) * 2], W, B,
                          step=0)
        return out, tr.drops, tr.bytes_sent

    for r, (out, drops, sent) in enumerate(_socket_world(
            2, A, drive, classes=[cls] * 2, secrets=KEY, timeout=60.0)):
        assert drops == 0 and _same(out, want[r * 2:(r + 1) * 2])
        assert sent == 2 * (T.FRAME_HEADER.size + 4 * 3_000_000
                            + T.WIRE_TAG_SIZE)
