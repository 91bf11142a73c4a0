"""The torus gossip of Eq. (3) as per-direction tables (counterpart of
``repro.dist.collectives``).

On the ("pod", "data") torus every agent has one neighbour per direction,
so x' = W x - B^k u needs, per direction, only the mixed message
v_ij = w_ij x_j - b_ij u_j that agent j sends that way.  The ring layout
splits the step's realized (W_k, B^k) into (m, 1 + ndirs) tables — column
0 the self term, column 1 + d the weight of the message toward direction
d's neighbour — and a static shift per direction.  Agent id = pod *
n_data + data, as in the reference.

The tables are built on the host from numpy once per (n_data, n_pod) and
copied once per device (the index tensors the gathers use, the
permutation matrices, the torus weights); the per-step tables are
gathers from the realized dense matrices on their device, so every entry
is copied, never recombined, and bitwise the reference's, and no step of
the ring layout, static or time-varying, reads numpy or the host after
its first (which a CUDA graph's eager warm-up chunk runs).

`torus_gossip_pdsgd` has two forms.  With ``mesh=None`` all agents are
on one device: the dense fallback, or the ring kernel with
``fused=True``.  With a `DeviceMesh` each ("pod", "data") rank holds
one agent: the sender computes its message per direction, and only that
message crosses the link, by one point-to-point shift on the
direction's mesh axis (`shift`, shared with
`dist.transport.ShardMapTransport`).
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

# the kernels package first: core.privacy imports kernels.build, whose
# package imports core.privacy back
from ..kernels.build import to_device
from ..core import prng
from ..core.privacy import tree_leaves, tree_unflatten

__all__ = ["sample_b_draws", "torus_weights", "torus_gossip_pdsgd",
           "dense_coupling", "directional_keep", "directional_weights",
           "mask_b_draws", "perm_stack", "source_table", "rows_from_dense",
           "mesh_coords", "mesh_agent", "shift", "gather_agents"]

Pytree = Any


def _directions(n_data: int, n_pod: int) -> list[tuple[str, int, int]]:
    """Distinct neighbour directions (mesh_axis, ring_size, shift) of the
    torus.  A ring of two has one distinct neighbour (+1 == -1 mod 2)."""
    dirs: list[tuple[str, int, int]] = []
    if n_data > 1:
        dirs.append(("data", n_data, 1))
    if n_data > 2:
        dirs.append(("data", n_data, -1))
    if n_pod > 1:
        dirs.append(("pod", n_pod, 1))
    if n_pod > 2:
        dirs.append(("pod", n_pod, -1))
    return dirs


def torus_weights(n_data: int, n_pod: int) -> dict:
    """Metropolis weights of the regular torus: w_edge = 1/(1+deg),
    w_self = 1 - deg*w_edge (python floats, as the reference's)."""
    deg = len(_directions(n_data, n_pod))
    w_edge = 1.0 / (1.0 + deg)
    return {"w_self": 1.0 - deg * w_edge, "w_edge": w_edge}


def _row_sum(e: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in ascending order, (..., 1)."""
    s = e[..., 0:1]
    for c in range(1, e.shape[-1]):
        s = s + e[..., c:c + 1]
    return s


def sample_b_draws(key: torch.Tensor, m: int, n_data: int,
                   n_pod: int) -> torch.Tensor:
    """(m, 1 + ndirs) random rows summing to one: row j holds [b_jj,
    b_{i_1 j}, ...] for agent j's neighbours, normalized Exp(1) draws
    (Dirichlet(1, .., 1)), as ``privacy.sample_B`` on the dense support.
    On the CPU; ``prng.exponential`` is within 2 ulp of the reference's."""
    ndirs = len(_directions(n_data, n_pod))
    e = prng.exponential(key, (m, 1 + ndirs))
    return e / _row_sum(e)


@functools.lru_cache(maxsize=None)
def _targets(n_data: int, n_pod: int) -> np.ndarray:
    """(ndirs, m) int64: dst[d, j] is the agent that receives agent j's
    direction-d message."""
    m = n_data * n_pod
    rows = []
    for axis, _size, shift in _directions(n_data, n_pod):
        dst = np.empty(m, dtype=np.int64)
        for j in range(m):
            pj, dj = divmod(j, n_data)
            if axis == "data":
                dst[j] = pj * n_data + (dj + shift) % n_data
            else:
                dst[j] = ((pj + shift) % n_pod) * n_data + dj
        rows.append(dst)
    return np.stack(rows) if rows else np.zeros((0, m), dtype=np.int64)


def _perm_matrices(n_data: int, n_pod: int) -> list[np.ndarray]:
    """Permutation matrix per direction: P[i, j] = 1 iff i receives from
    j."""
    m = n_data * n_pod
    mats = []
    for dst in _targets(n_data, n_pod):
        Pm = np.zeros((m, m), dtype=np.float32)
        Pm[dst, np.arange(m)] = 1.0
        mats.append(Pm)
    return mats


@functools.lru_cache(maxsize=None)
def perm_stack(n_data: int, n_pod: int) -> torch.Tensor:
    """The `_perm_matrices` stacked to one (ndirs, m, m) float32 CPU tensor
    (cached: do not write to it) — the reference's shift operand of the
    ring kernels."""
    m = n_data * n_pod
    mats = _perm_matrices(n_data, n_pod)
    return torch.from_numpy(np.stack(mats) if mats
                            else np.zeros((0, m, m), dtype=np.float32))


@functools.lru_cache(maxsize=None)
def source_table(n_data: int, n_pod: int) -> torch.Tensor:
    """(ndirs, m) int32 CPU tensor (cached): src[d, i] is the agent whose
    direction-d message agent i receives — the row index of the one 1 in
    row i of ``perm_stack()[d]``.  The ring kernels take this table in
    place of the matrices."""
    dst = _targets(n_data, n_pod)
    src = np.empty_like(dst)
    for d in range(dst.shape[0]):
        src[d, dst[d]] = np.arange(dst.shape[1])
    return torch.from_numpy(src.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _targets_on(n_data: int, n_pod: int, device: str) -> torch.Tensor:
    return to_device(torch.from_numpy(_targets(n_data, n_pod)), device)


@functools.lru_cache(maxsize=None)
def _dense_on(n_data: int, n_pod: int, device: str) -> dict:
    """The torus' dense float32 constants on ``device``, copied once: the
    identity ``eye``, the (ndirs, m, m) permutation matrices ``perms``,
    the Metropolis matrix ``W`` and the ring kernel's (1, 1 + ndirs)
    weight row ``w_row``."""
    m = n_data * n_pod
    mats = _perm_matrices(n_data, n_pod)
    eye = np.eye(m, dtype=np.float32)
    wts = torus_weights(n_data, n_pod)
    W = wts["w_self"] * eye + wts["w_edge"] * sum(mats, np.zeros_like(eye))
    w_row = np.array([[wts["w_self"]] + [wts["w_edge"]] * len(mats)],
                     dtype=np.float32)
    return {name: to_device(torch.from_numpy(np.ascontiguousarray(a)),
                            device)
            for name, a in (("eye", eye), ("perms", perm_stack(
                n_data, n_pod).numpy()), ("W", W), ("w_row", w_row))}


def _per_direction(M: torch.Tensor, n_data: int, n_pod: int) -> torch.Tensor:
    """(m, ndirs): out[j, d] = M[dst_d(j), j], the entry of the dense
    (m, m) ``M`` on agent j's direction-d link."""
    dst = _targets_on(n_data, n_pod, str(M.device))
    return torch.gather(M, 0, dst).T


def dense_coupling(b: torch.Tensor, n_data: int, n_pod: int,
                   W: torch.Tensor | None = None):
    """The (W, B^k) pair the ring tables stand for: W the torus
    Metropolis matrix (or the step's realized W_k, passed through), B^k
    the column-stochastic matrix whose column j is row j of ``b``."""
    c = _dense_on(n_data, n_pod, str(b.device))
    if W is None:
        W = c["W"]
    B = c["eye"] * b[None, :, 0]
    for di in range(c["perms"].shape[0]):
        B = B + c["perms"][di] * b[None, :, 1 + di]
    return W, B


def directional_keep(support: torch.Tensor, n_data: int,
                     n_pod: int) -> torch.Tensor:
    """(m, ndirs): keep[j, d] = support[dst_d(j), j], whether agent j's
    direction-d link survives this step's realization."""
    return _per_direction(support, n_data, n_pod)


def directional_weights(W: torch.Tensor, n_data: int, n_pod: int) -> dict:
    """A realized W_k split into ``w_self`` (m,) = diag(W_k) and ``w_dir``
    (m, ndirs), w_dir[j, d] = W_k[dst_d(j), j]."""
    return {"w_self": torch.diagonal(W),
            "w_dir": _per_direction(W, n_data, n_pod)}


def rows_from_dense(B: torch.Tensor, n_data: int,
                    n_pod: int) -> torch.Tensor:
    """(m, 1 + ndirs) rows [b_jj, b_{i_1 j}, ...] of a dense B on the torus
    support, the inverse of `dense_coupling`'s B (each entry copied)."""
    return torch.cat([torch.diagonal(B)[:, None],
                      _per_direction(B, n_data, n_pod)], dim=1)


def mask_b_draws(b: torch.Tensor, keep_dir: torch.Tensor) -> torch.Tensor:
    """`sample_b_draws` rows renormalized onto the surviving links: a
    dropped direction gets weight exactly zero, the row (self +
    survivors) sums to one."""
    scale = torch.cat([torch.ones((b.shape[0], 1), dtype=b.dtype,
                                  device=b.device),
                       keep_dir.to(b.dtype)], dim=1)
    e = b * scale
    return e / _row_sum(e)


# -- the torus over a DeviceMesh: one agent per ("pod", "data") rank -----

_AGENT_GROUPS: dict = {}


def mesh_coords(mesh) -> dict[str, int]:
    """This rank's coordinate on each named axis of a `DeviceMesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _mesh_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_agent(mesh) -> int:
    """The agent this rank hosts: pod * n_data + data, as the reference's
    device order."""
    c = mesh_coords(mesh)
    return c.get("pod", 0) * _mesh_sizes(mesh).get("data", 1) \
        + c.get("data", 0)


def _rank_at(mesh, coords: dict) -> int:
    return int(mesh.mesh[tuple(coords[n] for n in mesh.mesh_dim_names)])


def _agent_group(mesh):
    """``(group, ranks)``: the process group of the ranks that share this
    rank's non-agent coordinates, and those ranks in agent-id order
    (group None for a single agent).  The groups of a mesh are made once,
    by every rank in the same order, as `new_group` needs."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh
    key = (names, tuple(grid.flatten().tolist()))
    if key not in _AGENT_GROUPS:
        agent = [i for i, n in enumerate(names) if n in ("pod", "data")]
        other = [i for i in range(len(names)) if i not in agent]
        n_agents = 1
        for i in agent:
            n_agents *= grid.shape[i]
        rows = grid.permute(other + agent).reshape(-1, n_agents).tolist()
        groups = {}
        for row in rows:
            grp = dist.new_group(sorted(row)) if len(row) > 1 else None
            for r in row:
                groups[r] = (grp, row)
        _AGENT_GROUPS[key] = groups
    return _AGENT_GROUPS[key][dist.get_rank()]


def gather_agents(mesh, t: torch.Tensor) -> torch.Tensor:
    """All-gather this rank's (L, ...) block over the mesh's agent axes:
    the agents' blocks concatenated in agent-id order, on t's device,
    through the mesh's own process group (no host copy)."""
    import torch.distributed as dist
    grp, row = _agent_group(mesh)
    if grp is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in row]
    dist.all_gather(parts, t, group=grp)
    by_rank = dict(zip(sorted(row), parts))
    return torch.cat([by_rank[r] for r in row], dim=0)


def shift(mesh, axis: str, step: int, tensors):
    """One point-to-point shift on ``axis``: each tensor goes to the rank
    ``step`` further along the axis' ring (the other coordinates kept),
    and the matching tensors come from the rank ``step`` behind.  Returns
    ``(received, requests)``; wait on the requests before reading
    ``received``, and keep ``tensors`` alive until then."""
    import torch.distributed as dist
    c = mesh_coords(mesh)
    size = _mesh_sizes(mesh)[axis]
    dst, src = dict(c), dict(c)
    dst[axis] = (c[axis] + step) % size
    src[axis] = (c[axis] - step) % size
    dst_r, src_r = _rank_at(mesh, dst), _rank_at(mesh, src)
    recv = [torch.empty_like(t) for t in tensors]
    ops = []
    for i, (t, r) in enumerate(zip(tensors, recv)):
        ops.append(dist.P2POp(dist.isend, t, dst_r, tag=i))
        ops.append(dist.P2POp(dist.irecv, r, src_r, tag=i))
    return recv, dist.batch_isend_irecv(ops)


def _mesh_gossip(mesh, params, u, b, W, n_data: int, n_pod: int,
                 capture: bool, finite_guard: bool, schedule: str):
    """`torus_gossip_pdsgd`'s mesh form: this rank's agent a sends, per
    direction, v = w x_a - b u_a computed from its own row of the tables,
    receives its neighbour's, and accumulates self term first, then the
    directions in order (the reference's shard_map body)."""
    from torch.distributed.tensor import DTensor
    from .transport import link_message
    x_leaves, u_leaves = tree_leaves(params), tree_leaves(u)
    xl = [t.to_local() if isinstance(t, DTensor) else t for t in x_leaves]
    ul = [t.to_local() if isinstance(t, DTensor) else t for t in u_leaves]
    dev = xl[0].device
    dirs = _directions(n_data, n_pod)
    a = mesh_agent(mesh)
    if W is None:
        w_row = _dense_on(n_data, n_pod, str(dev))["w_row"][0]
    else:
        W = to_device(W, dev)
        tabs = directional_weights(W, n_data, n_pod)
        w_row = torch.cat([tabs["w_self"][a:a + 1], tabs["w_dir"][a]])
    b_row = to_device(b, dev)[a]

    def coeff(tab, col, leaf):
        return tab[col].reshape((1,) * leaf.dim())

    def mk_v(col):
        return [link_message(coeff(w_row, col, x), coeff(b_row, col, x),
                             x, uu).contiguous() for x, uu in zip(xl, ul)]

    out = mk_v(0)
    taps = []
    if schedule == "pipelined" and dirs:
        v = mk_v(1)
    for di, (axis, _size, step) in enumerate(dirs):
        if schedule == "staged":
            v = mk_v(1 + di)
        if capture:
            # the sender's own buffer, before the shift puts it on the wire
            taps.append(torch.cat([t.reshape(1, -1).float() for t in v], 1))
        sent = v
        recv, reqs = shift(mesh, axis, step, sent)
        if schedule == "pipelined" and di + 1 < len(dirs):
            # the next direction's v while this shift is in flight
            v = mk_v(2 + di)
        for r in reqs:
            r.wait()
        del sent
        if finite_guard:
            recv = [torch.where(torch.isfinite(t), t, torch.zeros_like(t))
                    for t in recv]
        out = [o + c for o, c in zip(out, recv)]
    res = tree_unflatten(params, [
        DTensor.from_local(o, x.device_mesh, x.placements, shape=x.shape,
                           stride=x.stride()) if isinstance(x, DTensor)
        else o for o, x in zip(out, x_leaves)])
    if not capture:
        return res
    from ..privacy import observe as O
    D = taps[0].shape[1] if taps else sum(t[0].numel() for t in xl)
    v_dir = gather_agents(mesh, torch.stack(taps, 1) if taps else
                          torch.zeros((1, 0, D), device=dev))
    return res, O.scatter_directions(v_dir.transpose(0, 1).contiguous(),
                                     perm_stack(n_data, n_pod), D)


def torus_gossip_pdsgd(mesh, params: Pytree, u: Pytree, b: torch.Tensor, *,
                       n_data: int | None = None, n_pod: int | None = None,
                       leaf_specs: Pytree | None = None,
                       W: torch.Tensor | None = None, capture: bool = False,
                       finite_guard: bool = False,
                       schedule: str = "pipelined", fused: bool = False):
    """x' = W x - B^k u on the torus, for params/u trees with leaves
    (m, ...) and ``b`` (m, 1 + ndirs) rows from `sample_b_draws` (masked
    by `mask_b_draws` for a time-varying ``W``, the step's realized W_k).

    ``mesh`` a `DeviceMesh` whose ("pod", "data") axes hold the torus, one
    agent a rank: params/u are DTensors (m, ...) sharded over those axes
    (``leaf_specs``' trailing dims may shard over the others: each leaf's
    local shard is exchanged as it is, nothing gathered), or this rank's
    local (1, ...) blocks.  The sender computes v = w x - b u from its
    own row of the tables (`transport.link_message`, each product and the
    difference rounded apart); per direction one point-to-point `shift`
    on that axis' process group carries it; the receiver accumulates its
    self term, then the directions in `_directions` order (the
    reference's order, which its tests anchor to the bit), each received
    term through ``where(isfinite(v), v, 0)`` with ``finite_guard``.
    ``schedule="pipelined"`` computes direction d+1's v while direction
    d's shift is in flight; ``"staged"`` computes it after; the values
    are the same.  ``capture`` taps each v before its send and gathers
    the taps to the dense V (m, m, D) on every rank.  ``fused`` is
    ignored there (the exchange is the fused schedule).  Returns the same
    kind of leaves it was given (f32 where the coefficients promote).

    Without a mesh (``None``, or a stand-in whose ``.shape`` maps axes to
    sizes, which gives the torus) all agents are on one device: the torus
    is (``n_data``, ``n_pod``) (default (m, 1), one ring).  Without
    ``fused`` the update runs as the
    dense product with `dense_coupling`'s matrices (`core.pdsgd.
    oracle_mix`, summed as B2 sums on the card; ``finite_guard``:
    every link passed through ``where(isfinite(v), v, 0)`` by
    `faults.inject.guarded_gossip_mix`).  With ``fused=True`` it runs
    through the ring kernel `kernels.ring_gossip_update` over the leaves
    flattened into one padded (m, width) buffer: per-direction tables
    and shifts, accumulated self first, then direction by direction.

    ``capture=True`` also returns V (m, m, D) f32, the message on every
    link: with ``fused`` scattered from the kernel's own per-direction v
    (`privacy.observe.scatter_directions`), else `privacy.observe.
    wire_messages` of the dense matrices.
    """
    if schedule not in ("staged", "pipelined"):
        raise ValueError(f"unknown schedule {schedule!r}; "
                         "expected 'staged' or 'pipelined'")
    if fused and finite_guard:
        raise ValueError("fused=True does not compose with finite_guard; "
                         "fault scenarios use the dense guarded path")
    if capture and leaf_specs is not None:
        raise ValueError(
            "capture=True flattens each agent's leaves to (m, D) and so "
            "requires replicated non-agent dims (leaf_specs=None); audit "
            "workloads replicate per agent")
    leaves = tree_leaves(params)
    m = leaves[0].shape[0]
    device_mesh = getattr(mesh, "mesh_dim_names", None) is not None
    if mesh is not None and not (device_mesh or hasattr(mesh, "shape")):
        raise TypeError("mesh must be a DeviceMesh, or a stand-in whose "
                        f".shape maps axes to sizes, not "
                        f"{type(mesh).__name__}")
    sizes = (_mesh_sizes(mesh) if device_mesh
             else dict(mesh.shape) if mesh is not None else {})
    if n_pod is None:
        n_pod = sizes.get("pod", 1)
    if n_data is None:
        n_data = sizes.get("data", m // n_pod)
    if device_mesh and not hasattr(leaves[0], "device_mesh"):
        m = n_pod * n_data  # this rank's local blocks
    if n_pod * n_data != m:
        raise ValueError(
            f"torus {n_pod}x{n_data} does not hold m={m} agents")
    dirs = _directions(n_data, n_pod)
    if b.shape[-1] != 1 + len(dirs):
        raise ValueError(
            f"b has {b.shape[-1]} coefficients but the {n_pod}x{n_data} "
            f"torus has {len(dirs)} neighbor directions")
    if device_mesh:
        if (sizes.get("pod", 1), sizes.get("data", 1)) != (n_pod, n_data):
            raise ValueError(
                f"the mesh's agent axes {sizes} do not hold the "
                f"{n_pod}x{n_data} torus")
        return _mesh_gossip(mesh, params, u, b, W, n_data, n_pod, capture,
                            finite_guard, schedule)

    if fused:
        from ..kernels.gossip import ring_gossip_update
        from ..kernels.ops import FlatLayout
        if leaf_specs is not None:
            raise ValueError("fused=True flattens each agent's leaves to "
                             "(m, D) and needs replicated non-agent dims "
                             "(leaf_specs=None)")
        dev = leaves[0].device
        if W is None:
            w_tab = _dense_on(n_data, n_pod, str(dev))["w_row"].expand(m, -1)
        else:
            tabs = directional_weights(W, n_data, n_pod)
            w_tab = torch.cat([tabs["w_self"][:, None], tabs["w_dir"]], 1)
        layout = FlatLayout.of(tree_unflatten(params,
                                              [l[0] for l in leaves]))
        X = layout.flatten(params, m)
        U = layout.flatten(u, m)
        perms = perm_stack(n_data, n_pod)
        res = ring_gossip_update(w_tab, b, perms, X, U, capture=capture)
        out_flat = res[0] if capture else res
        out = layout.tree(out_flat)
        if not capture:
            return out
        from ..privacy import observe as O
        # res[1]: (ndirs, m, width), sender-major
        return out, O.scatter_directions(res[1], perms, layout.size)

    from ..core.pdsgd import oracle_mix
    from ..faults.inject import guarded_gossip_mix
    Wd, B = dense_coupling(b, n_data, n_pod, W=W)
    u_leaves = tree_leaves(u)
    if finite_guard:
        zeros = torch.zeros(m, device=leaves[0].device)
        outs = [guarded_gossip_mix(Wd, B, p, v, zeros, mode="nan",
                                   scale=1.0, clip=float("inf"))
                for p, v in zip(leaves, u_leaves)]
    else:
        outs = [oracle_mix(Wd, p) - oracle_mix(B, v)
                for p, v in zip(leaves, u_leaves)]
    out = tree_unflatten(params, outs)
    if not capture:
        return out
    from ..privacy import observe as O
    return out, O.wire_messages(Wd, B, O.flatten_agents(params),
                                O.flatten_agents(u))
