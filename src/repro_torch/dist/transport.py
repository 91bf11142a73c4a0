"""The transport seam: Eq. (3)'s neighbor exchange written once
(counterpart of ``repro.dist.transport``).

Every execution mode of the paper's update

    x_i' = w_ii x_i - b_ii u_i  +  sum_{j in N_i} (w_ij x_j - b_ij u_j)

moves the same quantity between agents: the sender-mixed message
``v_ij = w_ij x_j - b_ij u_j`` (`link_message`).  Neither x_j nor u_j,
and never any Lambda-key material, crosses an agent boundary:

* `InProcessTransport`  — all agents in one process (host numpy); the
                          world=1 anchor of `launch.multihost`.
* `SocketTransport`     — one process per agent block, TCP framing: the
                          only bytes on the wire are (step, sender,
                          receiver, len, v_ij payload) and, with a
                          secret, an HMAC-SHA256 tag over them.
* `PipelinedSocketTransport` — the same wire protocol with a bounded
                          outbox drained by a send thread, an eager
                          receive thread, per-link lazy staging and a
                          ``frames_ahead`` run-ahead window; bit-identical
                          trajectories to `SocketTransport`.

* `ShardMapTransport`   — one agent per ("pod", "data") rank of a
                          `DeviceMesh`: one point-to-point shift per
                          torus direction on the mesh's process group
                          (`collectives.shift`).

Canonical accumulation order: each receiver accumulates its self term
first, then every neighbor contribution in ascending global sender id.
Every message is computed by separate elementwise operations (numpy, or
separate torch ops), never a fused multiply-add, so the transports, the
reference's and a mixed deployment of both agree bit for bit.  The
frames are the reference's byte for byte.

Capture convention: ``exchange(..., capture=True)`` also returns the
sender-side wire columns, the (m, L, D) block of
``privacy.observe.wire_messages`` (V[i, j] = v_ij, the diagonal zeroed)
that the transport's senders emit; `merge_captures` reassembles the
dense tensor.

Receiving reads each payload into a preallocated buffer (``recv_into``),
in time linear in the frame (the reference grows a ``bytes`` object,
quadratic in it; the bytes are the same).
"""
from __future__ import annotations

import hashlib
import hmac
import os
import queue
import select
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

import numpy as np

__all__ = [
    "link_message",
    "flatten_one",
    "unflatten_one",
    "neighbor_lists",
    "accumulate",
    "capture_columns",
    "merge_captures",
    "Transport",
    "InProcessTransport",
    "ShardMapTransport",
    "SocketTransport",
    "PipelinedSocketTransport",
    "FRAME_HEADER",
    "WIRE_TAG_SIZE",
    "derive_wire_secret",
]

Tree = Any


def link_message(w, b, x, u, out: np.ndarray | None = None):
    """The per-link message v = w * x - b * u, each product and the
    difference rounded separately (numpy or torch operands).  A host
    array is written in place of its first product, or into ``out``:
    the same bits, fewer full-width temporaries."""
    if isinstance(x, np.ndarray) and x.ndim:
        v = np.multiply(w, x, out=out, dtype=np.float32) if out is not None \
            else w * x
        v -= b * u
        return v
    return (w * x) - (b * u)


def _host_f32(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch tensor, any dtype or device
        import torch
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf, dtype=np.float32)


def flatten_one(tree: Tree) -> np.ndarray:
    """One agent's parameter tree -> flat (D,) f32 vector: each leaf
    raveled in the reference's ``jax.tree.leaves`` order, concatenated."""
    from ..core.privacy import tree_leaves
    flat = [_host_f32(l).reshape(-1) for l in tree_leaves(tree)]
    return np.concatenate(flat) if len(flat) > 1 else flat[0]


def unflatten_one(vec: np.ndarray, like: Tree) -> Tree:
    """Inverse of `flatten_one` against a template tree: f32 CPU tensors
    shaped like its leaves (exact: every element copied)."""
    import torch

    from ..core.privacy import tree_leaves, tree_unflatten
    shapes = [tuple(l.shape) for l in tree_leaves(like)]
    need = sum(int(np.prod(s, dtype=np.int64)) for s in shapes)
    if need != len(vec):
        raise ValueError(f"flat vector has {len(vec)} elements; template "
                         f"needs {need}")
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape, dtype=np.int64))
        out.append(torch.from_numpy(
            np.array(vec[off:off + n], dtype=np.float32).reshape(shape)))
        off += n
    return tree_unflatten(like, out)


def neighbor_lists(adjacency: np.ndarray) -> list[np.ndarray]:
    """Ascending neighbor ids per agent from a symmetric 0/1 adjacency
    (diagonal ignored): the canonical accumulation order."""
    A = np.asarray(adjacency)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"adjacency must be square, got {A.shape}")
    if not np.array_equal(A, A.T):
        raise ValueError("adjacency must be symmetric (undirected links)")
    off = A * (1 - np.eye(A.shape[0], dtype=A.dtype))
    return [np.flatnonzero(off[i]) for i in range(A.shape[0])]


def accumulate(i: int, self_term: np.ndarray,
               contribs: dict[int, np.ndarray],
               out: np.ndarray | None = None) -> np.ndarray:
    """Canonical receiver-side reduction: self term + contributions in
    ascending sender id (the first sum a new array, or ``out``, which may
    be ``self_term`` itself; the rest added into it: the same bits as a
    chain of new sums)."""
    acc = self_term
    fresh = False
    if out is not None:
        if out is not self_term:
            out[...] = self_term
        acc, fresh = out, True
    for j in sorted(contribs):
        if j == i:
            raise ValueError(f"agent {i} cannot receive its own v_ii")
        if fresh:
            acc += contribs[j]
        else:
            acc = acc + contribs[j]
            fresh = isinstance(acc, np.ndarray) and acc.ndim > 0
    return acc


def capture_columns(W: np.ndarray, B: np.ndarray, x: np.ndarray,
                    u: np.ndarray, lo: int = 0) -> np.ndarray:
    """Sender-side wire columns: out[i, l] = v_{i, lo+l} with the v_jj
    diagonal zeroed, the (m, L, D) block of ``wire_messages`` a rank
    owning senders [lo, lo+L) emits by itself."""
    L = x.shape[0]
    cols = (W[:, lo:lo + L, None] * x[None, :, :]
            - B[:, lo:lo + L, None] * u[None, :, :])
    for l in range(L):
        cols[lo + l, l, :] = 0.0
    return cols


def merge_captures(blocks: Sequence[np.ndarray]) -> np.ndarray:
    """Per-rank (m, L, D) column blocks (rank order) -> the dense
    (m, m, D) wire tensor."""
    return np.concatenate(list(blocks), axis=1)


def _f32(*arrays) -> list[np.ndarray]:
    return [np.asarray(a, dtype=np.float32) for a in arrays]


# columns a task of `_by_columns` takes: its temporaries stay in cache
_COLUMNS = 1 << 18


def _by_columns(n: int, fn) -> None:
    """``fn(s, e)`` over the column ranges [s, e) of n columns, on a few
    threads (numpy's elementwise operations release the GIL).  Every
    operation here is elementwise, so the bits are those of one pass over
    whole rows."""
    spans = [(s, min(n, s + _COLUMNS)) for s in range(0, n, _COLUMNS)]
    if len(spans) == 1:
        fn(*spans[0])
        return
    with ThreadPoolExecutor(min(len(spans), 8, os.cpu_count() or 1)) as ex:
        for f in [ex.submit(fn, s, e) for s, e in spans]:
            f.result()


def _link_row(w, b, x: np.ndarray, u: np.ndarray) -> np.ndarray:
    """`link_message` of one link into a new row, by column ranges."""
    row = np.empty_like(x)
    _by_columns(x.shape[0], lambda s, e: link_message(
        w, b, x[s:e], u[s:e], out=row[s:e]))
    return row


def _receive_into(out: np.ndarray, i: int, w, b, x: np.ndarray,
                  u: np.ndarray, contribs: dict[int, np.ndarray]) -> None:
    """Receiver i's self term and `accumulate` written into ``out``, its
    row, by column ranges."""
    def cols(s, e):
        o = out[s:e]
        link_message(w, b, x[s:e], u[s:e], out=o)
        accumulate(i, o, {j: c[s:e] for j, c in contribs.items()}, out=o)
    _by_columns(out.shape[0], cols)


class Transport:
    """One neighbor exchange per call over the local agent block:
    ``exchange(x_local, u_local, W, B, step=..., capture=...)`` applies
    Eq. (3) for the owned agents and returns their updated (L, D) block,
    with ``capture=True`` also the (m, L, D) wire columns of the local
    senders.  W and B are the step's realized dense (m, m) coupling."""

    num_agents: int
    local_lo: int
    local_hi: int

    @property
    def local_agents(self) -> range:
        return range(self.local_lo, self.local_hi)

    def exchange(self, x_local, u_local, W, B, *, step: int = 0,
                 capture: bool = False):
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class InProcessTransport(Transport):
    """All m agents local, host numpy: the world=1 transport and the
    anchor the socket transports are held against."""

    def __init__(self, adjacency: np.ndarray):
        self._nbrs = neighbor_lists(adjacency)
        self.num_agents = len(self._nbrs)
        self.local_lo, self.local_hi = 0, self.num_agents

    def exchange(self, x_local, u_local, W, B, *, step: int = 0,
                 capture: bool = False):
        x, u, W, B = _f32(x_local, u_local, W, B)
        m = self.num_agents
        if x.shape[0] != m:
            raise ValueError(f"expected all {m} agents local, got "
                             f"{x.shape[0]}")
        out = np.empty_like(x)

        def cols(s, e):
            for i in range(m):
                o = out[i, s:e]
                contribs = {int(j): link_message(W[i, j], B[i, j],
                                                 x[j, s:e], u[j, s:e])
                            for j in self._nbrs[i]}
                link_message(W[i, i], B[i, i], x[i, s:e], u[i, s:e], out=o)
                accumulate(i, o, contribs, out=o)

        _by_columns(x.shape[1], cols)
        if not capture:
            return out
        return out, capture_columns(W, B, x, u, lo=0)


class ShardMapTransport(Transport):
    """One agent per ("pod", "data") coordinate of a `DeviceMesh`, this
    process its rank's agent: ``local_lo``/``local_hi`` mark that one row.

    The self term and the per-direction messages are computed eagerly on
    the host by `link_message` (numpy bits, as every transport); only the
    shift per direction goes through the mesh (`collectives.shift`, the
    mesh branch of `collectives.torus_gossip_pdsgd`).  The receiver adds
    what it got in ascending global sender id, not direction order: on a
    ring receiver 0 hears direction +1 from sender m - 1 but direction -1
    from sender 1.  ``capture`` gathers the senders' tapped messages to
    the dense (m, m, D) V on every rank (the reference returns it
    whole)."""

    def __init__(self, mesh, n_data: int | None = None,
                 n_pod: int | None = None):
        from . import collectives as C
        shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
        self.mesh = mesh
        self.n_pod = n_pod if n_pod is not None else shape.get("pod", 1)
        self.n_data = n_data if n_data is not None else shape.get("data", 1)
        if (shape.get("pod", 1), shape.get("data", 1)) != (self.n_pod,
                                                          self.n_data):
            raise ValueError(f"the mesh {shape} does not hold the "
                             f"{self.n_pod}x{self.n_data} torus")
        self.num_agents = self.n_pod * self.n_data
        self.local_lo = C.mesh_agent(mesh)
        self.local_hi = self.local_lo + 1
        self._dirs = C._directions(self.n_data, self.n_pod)

    def _source(self, axis: str, shift: int) -> int:
        pod, data = divmod(self.local_lo, self.n_data)
        if axis == "data":
            return pod * self.n_data + (data - shift) % self.n_data
        return ((pod - shift) % self.n_pod) * self.n_data + data

    def exchange(self, x_local, u_local, W, B, *, step: int = 0,
                 capture: bool = False):
        import torch

        from . import collectives as C
        x, u, W, B = _f32(x_local, u_local, W, B)
        if x.shape[0] != 1:
            raise ValueError(f"a rank holds one agent, got {x.shape[0]} "
                             "rows")
        a = self.local_lo
        targets = C._targets(self.n_data, self.n_pod)
        # each entry copied from the dense matrices, never recombined
        w = [W[a, a]] + [W[targets[d, a], a] for d in range(len(self._dirs))]
        b = [B[a, a]] + [B[targets[d, a], a] for d in range(len(self._dirs))]
        out = link_message(w[0], b[0], x, u)
        v_dirs = [link_message(w[1 + d], b[1 + d], x, u)
                  for d in range(len(self._dirs))]
        got = {}
        for d, (axis, _size, shift) in enumerate(self._dirs):
            recv, reqs = C.shift(self.mesh, axis, shift,
                                 [torch.from_numpy(v_dirs[d])])
            for r in reqs:
                r.wait()
            got[self._source(axis, shift)] = recv[0].numpy()
        for j in sorted(got):
            out += got[j]
        if not capture:
            return out
        taps = C.gather_agents(self.mesh, torch.from_numpy(
            np.stack(v_dirs, axis=1) if v_dirs
            else np.zeros((1, 0, x.shape[1]), np.float32))).numpy()
        V = np.zeros((self.num_agents, self.num_agents, x.shape[1]),
                     np.float32)
        for d in range(len(self._dirs)):
            V[targets[d], np.arange(self.num_agents)] = taps[:, d]
        return out, V


# -- the inter-process channel ------------------------------------------

# Wire frame: little-endian (step int64, sender int32, receiver int32,
# payload nbytes uint32) + the raw f32 v_ij payload, then, with a per-run
# secret, an HMAC-SHA256 tag over (header || payload).  Nothing else is
# ever serialized.
FRAME_HEADER = struct.Struct("<qiiI")
_HELLO = struct.Struct("<i")
WIRE_TAG_SIZE = hashlib.sha256().digest_size  # 32


def derive_wire_secret(seed: int, generation: int = 0) -> bytes:
    """The per-run frame-auth key every rank derives by itself from the
    shared run seed and the Lambda-key generation (`launch.multihost`), so
    a frame of another run or of a pre-rollback generation fails its
    tag.  ``REPRO_WIRE_SECRET`` overrides it (a deployment's own
    secret)."""
    env = os.environ.get("REPRO_WIRE_SECRET")
    if env:
        return env.encode()
    return hashlib.sha256(
        f"repro-wire|{int(seed)}|{int(generation)}".encode()).digest()


def _recv_into(sock: socket.socket, mv: memoryview) -> bool:
    """Fill ``mv`` from the socket; False on EOF or reset (peer death)."""
    got, n = 0, len(mv)
    while got < n:
        try:
            k = sock.recv_into(mv[got:], n - got)
        except (ConnectionError, OSError):
            return False
        if k == 0:
            return False
        got += k
    return True


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    """Exactly n bytes, or None on EOF or reset."""
    buf = bytearray(n)
    return bytes(buf) if _recv_into(sock, memoryview(buf)) else None


def _recv_payload(sock: socket.socket, nbytes: int,
                  digest=None) -> np.ndarray | None:
    """A frame's f32 payload read into a new array, or None on EOF or
    reset.  ``digest(view)`` is called on each piece as it lands (the
    HMAC streams beside the socket's receive buffer filling)."""
    vec = np.empty(nbytes // 4, dtype=np.float32)
    mv = memoryview(vec).cast("B")
    got = 0
    while got < nbytes:
        try:
            k = sock.recv_into(mv[got:], nbytes - got)
        except (ConnectionError, OSError):
            return None
        if k == 0:
            return None
        if digest is not None:
            digest(mv[got:got + k])
        got += k
    return vec


class SocketTransport(Transport):
    """TCP neighbor exchange for a process owning agents [lo, lo+L).

    Only the framed ``v_ij`` payloads cross the process boundary; links
    between two local agents never touch a socket.  A peer that dies
    (reset, EOF, or ``timeout`` with frames still owed) is marked in
    ``dead_ranks`` and its contributions drop for the step; the caller
    re-realizes the coupling over the survivors (`launch.multihost`).

    ``audit_wire=True`` keeps every sent frame verbatim in
    ``sent_frames``.  Counters: ``drops`` (counted by `exchange`: every
    remote contribution a local agent needed and did not get),
    ``tag_failures`` (frames that failed HMAC verification),
    ``comm_wait_s`` (wall time waiting on the wire), ``bytes_sent``
    (frame bytes put on the wire) and ``hmac_s`` (time spent computing
    and checking tags, on every thread).

    ``secret`` turns on frame authentication: each frame carries an
    HMAC-SHA256 tag over header and payload, and a frame whose tag is
    missing, truncated or wrong kills its channel (``tag_failures``),
    exactly the peer-death path.  ``None`` keeps the unauthenticated
    framing.
    """

    def __init__(self, adjacency: np.ndarray, rank: int, world: int,
                 endpoints: dict[int, tuple[str, int]],
                 listen_sock: socket.socket, *, timeout: float = 60.0,
                 audit_wire: bool = False, secret: bytes | None = None):
        self._nbrs = neighbor_lists(adjacency)
        m = len(self._nbrs)
        if m % world:
            raise ValueError(f"{m} agents do not split over {world} ranks")
        self.num_agents = m
        self.rank, self.world = rank, world
        self.block = m // world
        self.local_lo = rank * self.block
        self.local_hi = self.local_lo + self.block
        self.timeout = timeout
        self.audit_wire = audit_wire
        self.secret = secret
        self.tag_failures = 0
        self.sent_frames: list[bytes] = []
        self.dead_ranks: set[int] = set()
        self.drops = 0
        self.comm_wait_s = 0.0
        self.bytes_sent = 0
        self.hmac_s = 0.0
        self._counters = threading.Lock()  # the sending and receiving
                                           # threads add to them
        self._listen = listen_sock
        self._socks: dict[int, socket.socket] = {}
        self._rbuf: dict[tuple[int, int, int], np.ndarray] = {}
        # peer ranks that own at least one neighbor of a local agent
        peers: set[int] = set()
        for j in self.local_agents:
            for i in self._nbrs[j]:
                r = int(i) // self.block
                if r != rank:
                    peers.add(r)
        self.peers = peers
        self._connect(endpoints)

    def owner(self, agent: int) -> int:
        return int(agent) // self.block

    def _connect(self, endpoints: dict[int, tuple[str, int]]) -> None:
        # deterministic handshake: the lower rank accepts, the higher
        # connects
        for r in sorted(p for p in self.peers if p > self.rank):
            s = socket.create_connection(tuple(endpoints[r]),
                                         timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(_HELLO.pack(self.rank))
            self._socks[r] = s
        expected = {p for p in self.peers if p < self.rank}
        self._listen.settimeout(self.timeout)
        while expected:
            conn, _ = self._listen.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            hello = _recv_exact(conn, _HELLO.size)
            if hello is None:
                continue
            (r,) = _HELLO.unpack(hello)
            self._socks[r] = conn
            expected.discard(r)

    def mark_dead(self, rank: int) -> None:
        """Control-plane death notice: stop expecting frames from this
        peer and close its channel."""
        if rank in self.dead_ranks:
            return
        self.dead_ranks.add(rank)
        s = self._socks.pop(rank, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _tag(self, *parts) -> bytes:
        h = self._hmac(parts[0])
        for p in parts[1:]:
            self._update(h, p)
        return h.digest()

    def _hmac(self, head: bytes):
        return hmac.new(self.secret, head, hashlib.sha256)

    def _update(self, h, piece) -> None:
        t0 = time.perf_counter()
        h.update(piece)
        dt = time.perf_counter() - t0
        with self._counters:
            self.hmac_s += dt

    def _frame(self, step: int, j: int, i: int, row: np.ndarray) -> list:
        """The frame of v_ij as (header, payload view[, tag]) buffers."""
        payload = memoryview(np.ascontiguousarray(row)).cast("B")
        hdr = FRAME_HEADER.pack(step, j, i, payload.nbytes)
        bufs: list = [hdr, payload]
        if self.secret is not None:
            bufs.append(self._tag(hdr, payload))
        if self.audit_wire:
            self.sent_frames.append(b"".join(bytes(b) for b in bufs))
        return bufs

    def _read_frame(self, s: socket.socket):
        """One frame off a socket: ``(key, payload)``, or None when the
        channel died or failed its tag (``tag_failures``)."""
        hdr = _recv_exact(s, FRAME_HEADER.size)
        if hdr is None:
            return None
        fstep, sender, receiver, nbytes = FRAME_HEADER.unpack(hdr)
        if nbytes % 4:
            return None  # not a frame of f32 words: a desynced stream
        h = self._hmac(hdr) if self.secret is not None else None
        vec = _recv_payload(s, nbytes, None if h is None
                            else lambda piece: self._update(h, piece))
        if vec is None:
            return None
        if h is not None:
            # a truncated tag is a dead peer, a wrong one a tampered or
            # cross-run frame: either way the v is never buffered
            tag = _recv_exact(s, WIRE_TAG_SIZE)
            if tag is None or not hmac.compare_digest(tag, h.digest()):
                with self._counters:
                    self.tag_failures += 1
                return None
        return (fstep, sender, receiver), vec

    def _send(self, r: int, bufs: list) -> None:
        if r in self.dead_ranks:
            return
        try:
            s = self._socks[r]
            for b in bufs:
                s.sendall(b)
            with self._counters:
                self.bytes_sent += sum(len(b) for b in bufs)
        except (KeyError, ConnectionError, OSError):
            self.mark_dead(r)

    def _pump(self, owed: dict[int, int]) -> None:
        """Drain frames until nothing is owed (or the owing peers die or
        time out).  Frames of a later step (a peer running ahead) are
        buffered for it.  Drops are counted by `exchange`."""
        t0 = time.monotonic()
        deadline = t0 + self.timeout
        try:
            while any(n > 0 for n in owed.values()):
                live = {r: self._socks.get(r) for r, n in owed.items()
                        if n > 0 and r not in self.dead_ranks}
                socks = {s: r for r, s in live.items() if s is not None}
                if not socks:
                    return
                wait = max(0.0, deadline - time.monotonic())
                ready, _, _ = select.select(list(socks), [], [],
                                            min(wait, 1.0))
                if not ready:
                    if time.monotonic() >= deadline:
                        for r in socks.values():
                            self.mark_dead(r)
                    continue
                for s in ready:
                    r = socks[s]
                    got = self._read_frame(s)
                    if got is None:
                        self.mark_dead(r)
                        continue
                    self._rbuf[got[0]] = got[1]
                    if owed.get(r, 0) > 0:
                        owed[r] -= 1
        finally:
            self.comm_wait_s += time.monotonic() - t0

    def exchange(self, x_local, u_local, W, B, *, step: int = 0,
                 capture: bool = False):
        x, u, W, B = _f32(x_local, u_local, W, B)
        L, lo = self.block, self.local_lo
        if x.shape[0] != L:
            raise ValueError(f"rank {self.rank} owns {L} agents, got "
                             f"{x.shape[0]} rows")
        # sender side: every outgoing column computed once (also the
        # capture record); the remote rows are framed onto the wire
        cols = capture_columns(W, B, x, u, lo=lo)  # (m, L, D)
        frames = [(self.owner(i), self._frame(step, j, int(i), cols[i, l]))
                  for l, j in enumerate(range(lo, lo + L))
                  for i in self._nbrs[j] if self.owner(i) != self.rank]
        # the sends run beside the receive pump: two ranks each sending a
        # frame larger than the socket buffers would otherwise both block
        # in sendall, neither reading
        sender = threading.Thread(
            target=lambda: [self._send(r, f) for r, f in frames],
            daemon=True)
        sender.start()
        owed: dict[int, int] = {}
        for i in self.local_agents:
            for j in self._nbrs[i]:
                r = self.owner(j)
                if (r != self.rank and r not in self.dead_ranks
                        and (step, int(j), int(i)) not in self._rbuf):
                    owed[r] = owed.get(r, 0) + 1
        self._pump(owed)
        sender.join()
        out = np.empty_like(x)
        for l, i in enumerate(range(lo, lo + L)):
            contribs: dict[int, np.ndarray] = {}
            for j in self._nbrs[i]:
                j = int(j)
                if self.owner(j) == self.rank:
                    contribs[j] = link_message(W[i, j], B[i, j],
                                               x[j - lo], u[j - lo])
                else:
                    v = self._rbuf.pop((step, j, i), None)
                    if v is not None:
                        contribs[j] = v
                    else:
                        # whatever the reason: died mid-pump or before
                        self.drops += 1
            out[l] = accumulate(
                i, link_message(W[i, i], B[i, i], x[l], u[l]), contribs)
        if not capture:
            return out
        return out, cols

    def close(self) -> None:
        for s in list(self._socks.values()):
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()
        try:
            self._listen.close()
        except OSError:
            pass


class PipelinedSocketTransport(SocketTransport):
    """`SocketTransport` with communication overlapped: the same frames,
    the same handshake, bit-identical trajectories.

    * Lazy per-link staging: each realized link's v row is computed once
      (`link_message`) and reused for the wire and the local
      accumulation; the dense `capture_columns` block is built only for
      ``capture=True``.
    * A send thread drains a bounded outbox of (header, payload view,
      tag) buffers with ``sendmsg``; at most ``outbox_frames`` frames
      wait, so a stalled peer applies backpressure to `exchange`.
    * A receive thread reads peer frames into ``_rbuf`` as they arrive.
    * ``frames_ahead``: `exchange(step=k)` first waits until ``k -
      (newest step sent by the slowest live peer + 1) <= frames_ahead``.

    Wait time at both gates adds to ``comm_wait_s``.
    """

    def __init__(self, *args, outbox_frames: int = 64,
                 frames_ahead: int = 1, **kwargs):
        if outbox_frames < 1:
            raise ValueError(f"outbox_frames must be >= 1, got "
                             f"{outbox_frames}")
        if frames_ahead < 0:
            raise ValueError(f"frames_ahead must be >= 0, got "
                             f"{frames_ahead}")
        self.frames_ahead = frames_ahead
        self._outbox: queue.Queue = queue.Queue(outbox_frames)
        self._cv = threading.Condition()
        self._peer_step: dict[int, int] = {}
        self._first_step: int | None = None
        self._stopping = False
        super().__init__(*args, **kwargs)
        for s in self._socks.values():
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4 << 20)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
        self._tx = threading.Thread(target=self._send_loop, daemon=True)
        self._rx = threading.Thread(target=self._recv_loop, daemon=True)
        self._tx.start()
        self._rx.start()

    def _mark_dead_notify(self, rank: int) -> None:
        with self._cv:
            self.mark_dead(rank)
            self._cv.notify_all()

    def _send_loop(self) -> None:
        while True:
            try:
                item = self._outbox.get(timeout=0.2)
            except queue.Empty:
                if self._stopping:
                    return
                continue
            if item is None:
                return
            r, bufs = item
            if r in self.dead_ranks:
                continue
            try:
                s = self._socks[r]
                mvs = [memoryview(b) for b in bufs]
                while mvs:
                    sent = s.sendmsg(mvs)
                    with self._counters:
                        self.bytes_sent += sent
                    while mvs and sent >= len(mvs[0]):
                        sent -= len(mvs[0])
                        mvs.pop(0)
                    if mvs and sent:
                        mvs[0] = mvs[0][sent:]
            except (KeyError, ConnectionError, OSError):
                self._mark_dead_notify(r)

    def _recv_loop(self) -> None:
        while not self._stopping:
            socks = {s: r for r, s in list(self._socks.items())
                     if r not in self.dead_ranks}
            if not socks:
                time.sleep(0.01)
                continue
            try:
                ready, _, _ = select.select(list(socks), [], [], 0.2)
            except (OSError, ValueError):
                continue  # a socket closed under us; re-snapshot
            for s in ready:
                r = socks[s]
                got = self._read_frame(s)
                if got is None:
                    self._mark_dead_notify(r)
                    continue
                with self._cv:
                    self._rbuf[got[0]] = got[1]
                    self._peer_step[r] = max(self._peer_step.get(r, -1),
                                             got[0][0])
                    self._cv.notify_all()

    def exchange(self, x_local, u_local, W, B, *, step: int = 0,
                 capture: bool = False):
        x, u, W, B = _f32(x_local, u_local, W, B)
        L, lo = self.block, self.local_lo
        if x.shape[0] != L:
            raise ValueError(f"rank {self.rank} owns {L} agents, got "
                             f"{x.shape[0]} rows")
        # the frames_ahead gate: do not outrun the slowest live peer's
        # observed sends by more than the window (a peer not heard from
        # yet counts as just before this transport's first step, so a
        # resumed run starting at step q > frames_ahead does not wait)
        if self._first_step is None:
            self._first_step = step
        t0 = time.monotonic()
        deadline = t0 + self.timeout
        with self._cv:
            while True:
                live = [r for r in self.peers if r not in self.dead_ranks]
                if not live:
                    break
                slowest = min(self._peer_step.get(r, self._first_step - 1)
                              for r in live)
                if step - (slowest + 1) <= self.frames_ahead:
                    break
                if time.monotonic() >= deadline:
                    break  # the needed-frames wait below times it out
                self._cv.wait(0.1)
        self.comm_wait_s += time.monotonic() - t0
        # lazy per-link staging: each realized link's row once
        staged: dict[tuple[int, int], np.ndarray] = {}
        for l, j in enumerate(range(lo, lo + L)):
            for i in self._nbrs[j]:
                i = int(i)
                row = _link_row(W[i, j], B[i, j], x[l], u[l])
                r = self.owner(i)
                if r == self.rank:
                    staged[(j, i)] = row
                else:
                    # bounded: blocks (backpressure) when full
                    self._outbox.put((r, self._frame(step, j, i, row)))
                del row
        needed = [(step, int(j), int(i))
                  for i in self.local_agents for j in self._nbrs[i]
                  if self.owner(int(j)) != self.rank]
        t0 = time.monotonic()
        deadline = t0 + self.timeout
        with self._cv:
            while True:
                missing = [k for k in needed if k not in self._rbuf
                           and self.owner(k[1]) not in self.dead_ranks]
                if not missing or time.monotonic() >= deadline:
                    break
                self._cv.wait(0.2)
        self.comm_wait_s += time.monotonic() - t0
        out = np.empty_like(x)
        for l, i in enumerate(range(lo, lo + L)):
            contribs: dict[int, np.ndarray] = {}
            for j in self._nbrs[i]:
                j = int(j)
                if self.owner(j) == self.rank:
                    contribs[j] = staged.pop((j, i))
                else:
                    with self._cv:
                        v = self._rbuf.pop((step, j, i), None)
                    if v is not None:
                        contribs[j] = v
                    else:
                        self.drops += 1
            _receive_into(out[l], i, W[i, i], B[i, i], x[l], u[l], contribs)
            del contribs
        if not capture:
            return out
        return out, capture_columns(W, B, x, u, lo=lo)

    def close(self) -> None:
        self._stopping = True
        try:
            self._outbox.put_nowait(None)
        except queue.Full:
            pass
        for t in (getattr(self, "_tx", None), getattr(self, "_rx", None)):
            if t is not None and t.is_alive():
                t.join(timeout=2.0)
        super().close()
