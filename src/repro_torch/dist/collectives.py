"""The torus gossip of Eq. (3) as per-direction tables (counterpart of
``repro.dist.collectives``).

On the ("pod", "data") torus every agent has one neighbour per direction,
so x' = W x - B^k u needs, per direction, only the mixed message
v_ij = w_ij x_j - b_ij u_j that agent j sends that way.  The ring layout
splits the step's realized (W_k, B^k) into (m, 1 + ndirs) tables — column
0 the self term, column 1 + d the weight of the message toward direction
d's neighbour — and a static shift per direction.  Agent id = pod *
n_data + data, as in the reference.

The tables are built on the host from numpy, cached per (n_data, n_pod)
(and per device for the index tensors the gathers use); the per-step
tables are gathers from the realized dense matrices, so every entry is
copied, never recombined, and bitwise the reference's.

Only the single-device forms are here: `torus_gossip_pdsgd` with
``mesh=None`` (the dense fallback, or the ring kernel with
``fused=True``).  The mesh form — one agent per card, a point-to-point
shift per direction — is not ported yet.
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
           "mask_b_draws", "perm_stack", "source_table", "rows_from_dense"]

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
    m = n_data * n_pod
    mats = _perm_matrices(n_data, n_pod)
    eye = np.eye(m, dtype=np.float32)
    dev = b.device
    if W is None:
        wts = torus_weights(n_data, n_pod)
        W = torch.from_numpy(wts["w_self"] * eye + wts["w_edge"]
                             * sum(mats, np.zeros_like(eye))).to(dev)
    B = to_device(torch.from_numpy(eye), dev) * b[None, :, 0]
    for di, Pm in enumerate(mats):
        B = B + to_device(torch.from_numpy(Pm), dev) * b[None, :, 1 + di]
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


def torus_gossip_pdsgd(mesh, params: Pytree, u: Pytree, b: torch.Tensor, *,
                       n_data: int | None = None, n_pod: int | None = None,
                       leaf_specs: Pytree | None = None,
                       W: torch.Tensor | None = None, capture: bool = False,
                       finite_guard: bool = False,
                       schedule: str = "pipelined", fused: bool = False):
    """x' = W x - B^k u on the torus, for params/u trees with leaves
    (m, ...) and ``b`` (m, 1 + ndirs) rows from `sample_b_draws` (masked
    by `mask_b_draws` for a time-varying ``W``, the step's realized W_k).

    Only ``mesh=None`` is ported: the torus is (``n_data``, ``n_pod``)
    (default (m, 1), one ring).  Without ``fused`` the update runs as the
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
    wire_messages` of the dense matrices.  ``schedule`` is the mesh
    form's loop order; it is only validated here.
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
    if mesh is not None:
        raise NotImplementedError(
            "torus_gossip_pdsgd over a device mesh (one agent per card, a "
            "point-to-point shift per direction) is not ported yet; pass "
            "mesh=None for the single-device forms")
    leaves = tree_leaves(params)
    m = leaves[0].shape[0]
    n_pod = 1 if n_pod is None else n_pod
    n_data = m // n_pod if n_data is None else n_data
    if n_pod * n_data != m:
        raise ValueError(
            f"torus {n_pod}x{n_data} does not hold m={m} agents")
    dirs = _directions(n_data, n_pod)
    if b.shape[-1] != 1 + len(dirs):
        raise ValueError(
            f"b has {b.shape[-1]} coefficients but the {n_pod}x{n_data} "
            f"torus has {len(dirs)} neighbor directions")

    if fused:
        from ..kernels.gossip import ring_gossip_update
        from ..kernels.ops import FlatLayout
        if leaf_specs is not None:
            raise ValueError("fused=True flattens each agent's leaves to "
                             "(m, D) and needs replicated non-agent dims "
                             "(leaf_specs=None)")
        dev = leaves[0].device
        if W is None:
            wts = torus_weights(n_data, n_pod)
            w_tab = torch.tensor([wts["w_self"]] + [wts["w_edge"]]
                                 * len(dirs), dtype=torch.float32)
            w_tab = to_device(w_tab, dev)[None].expand(m, -1)
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
        zeros = torch.zeros(m)
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
