"""Wire-tap observation capture: the adversary's view as data (counterpart
of ``repro.privacy.observe``).

The paper's privacy claim (Sec. III, Theorem 5) is about what an adversary
can compute from the messages that cross the wire,

    v_ij = w_ij x_j - b_ij (Lambda_j ∘ g_j),        i in N_j, i != j,

so the audit captures exactly those messages from the running step.  This
module defines the observation record every execution path emits (the
unfused oracle, the fused kernels, the scanned step, the ring kernel and
`dist.collectives.torus_gossip_pdsgd`) and the adversary models that
restrict it:

* ``auditor()``               — full ground truth: messages plus the
                                private x, u, g, B, W;
* ``external_eavesdropper()`` — every v_ij and which links were live;
* ``curious_neighbor(i)``     — the messages on agent i's own links, plus
                                its own x_i, u_i, W row and B column.

Records hold (m, D) f32 views flattened as `kernels.ops.FlatLayout` lays
out an agent's row (tree order, each leaf raveled), without the padding:
the reference's field names, shapes and dtype, so a port record and a
reference record compare field by field.  Every function here is torch
ops on the buffers' device (no host copy, no sync), so a record is built
inside the CUDA graph of `core.pdsgd.make_scanned_steps` like any other
aux output.  The wire tensor V is (m, m, D): `wire_messages` fills it a
column piece at a time into one buffer, as `core.pdsgd.gossip_mix` does.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.privacy import tree_leaves
from ..kernels.build import to_device

__all__ = [
    "Adversary",
    "auditor",
    "external_eavesdropper",
    "curious_neighbor",
    "ADVERSARY_KINDS",
    "RECORD_FIELDS",
    "flatten_agents",
    "wire_messages",
    "scatter_directions",
    "broadcast_messages",
    "full_record",
    "state_record",
    "adversary_view",
]

ADVERSARY_KINDS = ("auditor", "external_eavesdropper", "curious_neighbor")
# the fields of a full PDSGD record, and those each adversary keeps
RECORD_FIELDS = ("v", "support", "x", "u", "g", "W", "B")
_VIEW_FIELDS = {"auditor": RECORD_FIELDS,
                "external_eavesdropper": ("v", "support"),
                "curious_neighbor": RECORD_FIELDS}
# columns a piece of `wire_messages` forms at once
_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class Adversary:
    """Who is looking: the restriction applied to the full record.
    ``agent`` is the insider's index, for ``curious_neighbor`` only."""

    kind: str
    agent: int | None = None

    def __post_init__(self):
        if self.kind not in ADVERSARY_KINDS:
            raise ValueError(f"unknown adversary kind {self.kind!r}; "
                             f"have {ADVERSARY_KINDS}")
        if self.kind == "curious_neighbor" and self.agent is None:
            raise ValueError("curious_neighbor needs its agent index")
        if self.kind != "curious_neighbor" and self.agent is not None:
            raise ValueError(f"{self.kind} takes no agent index")

    @property
    def fields(self) -> tuple[str, ...]:
        """The fields of a full record this adversary's view reads: a
        step builds only these."""
        return _VIEW_FIELDS[self.kind]


def auditor() -> Adversary:
    return Adversary("auditor")


def external_eavesdropper() -> Adversary:
    return Adversary("external_eavesdropper")


def curious_neighbor(agent: int) -> Adversary:
    return Adversary("curious_neighbor", agent=int(agent))


def flatten_agents(tree) -> torch.Tensor:
    """A tree with a leading agent axis -> one (m, D) f32 buffer, leaves in
    tree order, each raveled (`kernels.ops.FlatLayout`'s column order).  A
    tensor is taken as an (m, ...) buffer already in that order."""
    leaves = [tree] if isinstance(tree, torch.Tensor) else tree_leaves(tree)
    flat = [l.reshape(l.shape[0], -1).float() for l in leaves]
    return torch.cat(flat, dim=1) if len(flat) > 1 else flat[0]


def wire_messages(W: torch.Tensor, B: torch.Tensor, x_flat: torch.Tensor,
                  u_flat: torch.Tensor, chunk: int = _CHUNK) -> torch.Tensor:
    """The PDSGD wire tensor V[i, j] = w_ij x_j - b_ij u_j, i != j, as
    (m, m, D) f32; the diagonal is zeroed (v_jj is never transmitted).
    Each product and the difference are rounded once in f32, and the
    diagonal is multiplied by 0, as the reference's ``(W x - B u) * off``
    (the same bits, signed zeros included).  ``x_flat``/``u_flat`` may be
    in any float dtype (a bf16 buffer is cast a piece at a time); V is
    written a column piece at a time into one buffer, three passes a
    piece."""
    m, D = x_flat.shape
    dev = x_flat.device
    Wf, Bf = W.float().to(dev)[:, :, None], B.float().to(dev)[:, :, None]
    V = torch.empty((m, m, D), dtype=torch.float32, device=dev)
    for s in range(0, D, chunk):
        e = min(D, s + chunk)
        piece = V[:, :, s:e]
        torch.mul(Wf, x_flat[None, :, s:e].float(), out=piece)
        piece.sub_(Bf * u_flat[None, :, s:e].float())
    # the reference's `* off`: x * 1 is x, so only the diagonal changes
    for i in range(m):
        V[i, i].mul_(0.0)
    return V


def scatter_directions(v_dir: torch.Tensor, perms: torch.Tensor,
                       D: int) -> torch.Tensor:
    """A ring kernel's sender-major per-direction messages v_dir (ndirs, m,
    width) as the dense wire V (m, m, D) f32: V[i, j] = sum_d perms[d][i, j]
    v_dir[d][j], summed in direction order as the reference's scatter
    (``repro/core/pdsgd.py:245-256``), a column piece at a time into one
    buffer.  ``perms`` is the torus's (ndirs, m, m) shift stack
    (`dist.collectives.perm_stack`)."""
    m = v_dir.shape[1]
    P = to_device(perms.float(), v_dir.device)
    V = torch.zeros((m, m, D), dtype=torch.float32, device=v_dir.device)
    for s in range(0, D, _CHUNK):
        e = min(D, s + _CHUNK)
        piece = V[:, :, s:e]
        for d in range(P.shape[0]):
            piece += P[d][:, :, None] * v_dir[d][None, :, s:e].float()
    return V


def broadcast_messages(x_flat: torch.Tensor,
                       support: torch.Tensor) -> torch.Tensor:
    """The conventional-DSGD wire: agent j sends x_j in the clear to every
    live neighbour, V[i, j] = x_j on realized off-diagonal links."""
    m = support.shape[0]
    off = support.float() * (1.0 - torch.eye(m, device=support.device))
    return off[:, :, None] * x_flat.float()[None, :, :]


def full_record(*, v: torch.Tensor, support: torch.Tensor,
                x_flat: torch.Tensor | None = None,
                u_flat: torch.Tensor | None = None,
                g_flat: torch.Tensor | None = None,
                W: torch.Tensor | None = None,
                B: torch.Tensor | None = None) -> dict:
    """The auditor-grade PDSGD record (the reference's field names).  A
    field given as None is left out: a step builds only the fields its
    adversary's view reads."""
    rec = {"v": v, "support": support.float(), "x": x_flat, "u": u_flat,
           "g": g_flat, "W": None if W is None else W.float(),
           "B": None if B is None else B.float()}
    return {k: t for k, t in rec.items() if t is not None}


def state_record(*, support: torch.Tensor, x_flat: torch.Tensor,
                 g_flat: torch.Tensor, W: torch.Tensor, lam) -> dict:
    """The auditor-grade record of the state-sharing baselines (dsgd,
    dp_dsgd): the wire carries x_j itself; lam is public."""
    support = support.float()
    lam = (lam.float() if isinstance(lam, torch.Tensor)
           else torch.full((), float(lam), dtype=torch.float32,
                           device=support.device))
    return {"v": broadcast_messages(x_flat, support), "support": support,
            "x": x_flat.float(), "g": g_flat.float(), "W": W.float(),
            "lam": lam}


def adversary_view(adv: Adversary, record: dict) -> dict:
    """Restrict a full record to what ``adv`` observes."""
    if adv.kind == "auditor":
        return record
    if adv.kind == "external_eavesdropper":
        return {"v": record["v"], "support": record["support"]}
    i = adv.agent
    m = record["support"].shape[0]
    inc = torch.zeros((m, m), dtype=torch.float32,
                      device=record["support"].device)
    inc[i, :] = 1.0
    inc[:, i] = 1.0
    view = {
        "v": record["v"] * inc[:, :, None],
        "support": record["support"],
        "x_self": record["x"][i],
        "w_row": record["W"][i],
    }
    if "u" in record:
        view["u_self"] = record["u"][i]
    if "B" in record:
        view["b_col"] = record["B"][:, i]
    if "lam" in record:
        view["lam"] = record["lam"]
    return view
