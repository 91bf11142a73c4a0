"""Attacks on the captured streams (counterpart of
``repro.privacy.attacks``): the DLG gradient inversion of the paper's
Sec. VII (Zhu, Liu & Han '19), a sweep of it over (agent, step) cells,
and the closed-form least-squares inversion of the distributed-estimation
workload — exact gradient recovery under conventional DSGD (public W and
lam, the state in the clear on the wire), a reconstruction MSE that
Theorem 5 floors under PDSGD.

Attacks read the records of `privacy.observe` (what crossed the wire),
score against the auditor's ``g`` field, and never touch the training
step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..core import prng
from ..core.mixing import MixingProcess
from ..core.privacy import tree_leaves, tree_unflatten
from ..optim import adam, apply_updates, tree_map

__all__ = [
    "DLGResult",
    "dlg_attack",
    "dlg_attack_grid",
    "gradient_match_loss",
    "eavesdropper_observation",
    "eavesdropper_aggregate",
    "states_from_broadcast",
    "dsgd_exact_recovery",
    "pdsgd_ls_recovery",
    "recovery_mse",
]

Tree = Any


@dataclasses.dataclass
class DLGResult:
    recon_x: torch.Tensor
    recon_label_logits: torch.Tensor
    match_history: torch.Tensor  # (steps,) gradient-matching loss
    mse_history: torch.Tensor | None  # (steps,) against true_x if given


def gradient_match_loss(g_dummy: Tree, g_obs: Tree) -> torch.Tensor:
    """Sum of squared differences over all leaves (the DLG objective)."""
    return sum(torch.sum((a.float() - b.float()) ** 2)
               for a, b in zip(tree_leaves(g_dummy), tree_leaves(g_obs)))


def eavesdropper_observation(key: torch.Tensor, step, agent: int, x_j: Tree,
                             grads_j: Tree, W: torch.Tensor | None = None,
                             support: torch.Tensor | None = None,
                             lam_bar=None, *,
                             mixing: MixingProcess | None = None) -> Tree:
    """The strongest eavesdropper aggregate of Sec. III: tapping all of
    agent j's outgoing links and summing the messages gives

        sum_{i != j} v_ij = (1 - w_jj) x_j - (1 - b_jj) Lambda_j ∘ g_j,

    built from the update's own key derivations.  ``mixing`` realizes THIS
    step's (W_k, support_k) from a time-varying process (a dropped link
    sends nothing, and B^k renormalizes over the survivors); explicit
    ``W``/``support`` are for a static topology."""
    from ..core.privacy import agent_key, sample_B, sample_lambda_tree

    if lam_bar is None:
        raise ValueError("eavesdropper_observation requires lam_bar")
    if mixing is not None:
        if W is not None or support is not None:
            raise ValueError("pass either mixing= or explicit W/support, "
                             "not both")
        W, support, _ = mixing.realize(int(step))
    if W is None or support is None:
        raise ValueError("eavesdropper_observation needs W and support "
                         "(or a mixing= process to realize them)")
    k_lam = agent_key(prng.fold_in(key, 1), step, agent)
    lam_tree = sample_lambda_tree(k_lam, grads_j, lam_bar)
    B = sample_B(agent_key(prng.fold_in(key, 2), step, 0), support.float())
    w_jj, b_jj = W[agent, agent].float(), B[agent, agent]
    out = [(1.0 - w_jj) * x.float() - (1.0 - b_jj) * lam * g.float()
           for x, lam, g in zip(tree_leaves(x_j), tree_leaves(lam_tree),
                                tree_leaves(grads_j))]
    return tree_unflatten(x_j, out)


def _param_leaves(params: Tree) -> list[torch.Tensor]:
    return [p.detach().requires_grad_() for p in tree_leaves(params)]


def dlg_attack(loss_fn: Callable[[Tree, torch.Tensor, torch.Tensor],
                                 torch.Tensor],
               params: Tree, observed_grad: Tree, x_shape: tuple,
               num_classes: int, *, key: torch.Tensor, steps: int = 300,
               lr: float = 0.1,
               true_x: torch.Tensor | None = None) -> DLGResult:
    """Run DLG.  ``loss_fn(params, x, soft_label)`` is the training loss
    with a soft label (the attacker also reconstructs the label, as logits
    through a softmax).  The dummy starts from ``normal(split(key)[i]) *
    0.1``, the reference's draws; each of ``steps`` Adam steps
    differentiates the gradient-matching loss through the model's
    gradient (``create_graph=True``)."""
    kx, kl = prng.split(key, 2)
    dev = tree_leaves(params)[0].device
    dummy = {
        "x": (prng.normal(kx, tuple(x_shape)) * 0.1).to(dev),
        "label_logits": (prng.normal(kl, (x_shape[0], num_classes))
                         * 0.1).to(dev),
    }
    leaves = _param_leaves(params)
    p_tree = tree_unflatten(params, leaves)
    opt = adam(lr)
    opt_state = opt.init(dummy)
    hist, mse_hist = [], []
    for _ in range(steps):
        d = {k: v.detach().requires_grad_() for k, v in dummy.items()}
        soft = torch.softmax(d["label_logits"], dim=-1)
        g = torch.autograd.grad(loss_fn(p_tree, d["x"], soft), leaves,
                                create_graph=True)
        value = gradient_match_loss(tree_unflatten(params, list(g)),
                                    observed_grad)
        gx, gl = torch.autograd.grad(value, [d["x"], d["label_logits"]])
        updates, opt_state = opt.update({"x": gx, "label_logits": gl},
                                        opt_state, dummy)
        dummy = apply_updates(dummy, updates)
        hist.append(value.detach())
        if true_x is not None:
            mse_hist.append(torch.mean((dummy["x"] - true_x) ** 2))
    return DLGResult(
        recon_x=dummy["x"], recon_label_logits=dummy["label_logits"],
        match_history=torch.stack(hist) if hist else torch.zeros(0),
        mse_history=(torch.stack(mse_hist) if true_x is not None and
                     mse_hist else None))


def dlg_attack_grid(loss_fn, params: Tree, observed_grads: Tree,
                    x_shape: tuple, num_classes: int, *, key: torch.Tensor,
                    steps: int = 300, lr: float = 0.1,
                    true_x: torch.Tensor | None = None) -> DLGResult:
    """DLG over a leading (n,) axis of observations (e.g. a captured
    stream's (agent, step) cells), cell i's dummy from ``fold_in(key,
    i)``; ``params``/``true_x`` are shared.  A loop over the cells (the
    reference vmaps them); every field of the result carries the (n,)
    axis."""
    n = tree_leaves(observed_grads)[0].shape[0]
    runs = [dlg_attack(loss_fn, params,
                       tree_map(lambda t: t[i], observed_grads), x_shape,
                       num_classes, key=prng.fold_in(key, i), steps=steps,
                       lr=lr, true_x=true_x) for i in range(n)]
    return DLGResult(
        recon_x=torch.stack([r.recon_x for r in runs]),
        recon_label_logits=torch.stack([r.recon_label_logits for r in runs]),
        match_history=torch.stack([r.match_history for r in runs]),
        mse_history=(torch.stack([r.mse_history for r in runs])
                     if true_x is not None else None))


def eavesdropper_aggregate(v_stream: torch.Tensor) -> torch.Tensor:
    """s[..., j, :] = sum_i v[..., i, j, :]: the per-sender aggregate an
    external eavesdropper forms (the diagonal is absent from the
    capture)."""
    return torch.sum(torch.as_tensor(v_stream), dim=-3)


def states_from_broadcast(v_stream, support) -> torch.Tensor:
    """The x_j stream from a state-broadcast (dsgd) capture: any live
    incoming link of j carries x_j verbatim, so read the first realized
    off-diagonal receiver of each column.  ``support`` is (m, m) or a
    (T, m, m) stream (receivers re-chosen per step).  A sender with no
    live receiver at some step sent nothing: refused, never decoded as
    zeros."""
    sup = np.asarray(support, np.float32)
    v = np.asarray(v_stream)
    m = sup.shape[-1]
    off = sup * (1.0 - np.eye(m, dtype=np.float32))
    if np.any(off.sum(axis=-2) == 0):
        raise ValueError(
            "a sender has no live receiver at some step — its broadcast "
            "was never observed; decode only steps where every column has "
            "a realized off-diagonal link")
    recv = np.argmax(off, axis=-2)
    cols = np.arange(m)
    if sup.ndim == 2:
        return torch.from_numpy(np.ascontiguousarray(v[..., recv, cols, :]))
    steps = np.arange(v.shape[0])[:, None]
    return torch.from_numpy(np.ascontiguousarray(
        v[steps, recv, cols[None, :], :]))


def dsgd_exact_recovery(x_stream: torch.Tensor, W: torch.Tensor,
                        lam_stream: torch.Tensor) -> torch.Tensor:
    """Exact gradient recovery against conventional DSGD: x^{k+1} = W x^k
    - lam_k g^k is public in all but g, so g_hat^k = (W x^k - x^{k+1}) /
    lam_k.  ``x_stream`` (T+1, m, D), ``lam_stream`` (T,); returns (T, m,
    D), exact up to f32 rounding."""
    x = torch.as_tensor(x_stream).float()
    mixed = torch.einsum("ij,kjd->kid", torch.as_tensor(W).float(), x[:-1])
    return (mixed - x[1:]) / torch.as_tensor(lam_stream).float()[:, None,
                                                                 None]


def pdsgd_ls_recovery(v_stream, x_stream, W_stream, support_stream,
                      lam_bar_stream) -> torch.Tensor:
    """The least-squares inversion of the PDSGD eavesdropper aggregate,
    granted even the true x_j and W_k's diagonal (Remark 8's strongest
    setting): the residual (1 - w_jj) x_j - s_j = (1 - b_jj) Lambda_j ∘
    g_j divided by the mask's mean, (deg_j / (deg_j + 1)) lam_bar.
    Theorem 5 floors the MSE of this and every estimator.  Streams: v (T,
    m, m, D), x (T, m, D), W and support (T, m, m), lam_bar (T,); returns
    g_hat (T, m, D)."""
    s = eavesdropper_aggregate(v_stream)
    W_stream = torch.as_tensor(W_stream)
    w_jj = torch.diagonal(W_stream, dim1=-2, dim2=-1)
    deg = torch.as_tensor(support_stream).sum(dim=-2) - 1.0
    resid = (1.0 - w_jj)[..., None] * torch.as_tensor(x_stream) - s
    denom = (deg / (deg + 1.0)) * torch.as_tensor(lam_bar_stream)[:, None]
    return resid / torch.clamp_min(denom, 1e-30)[..., None]


def recovery_mse(g_hat, g_true) -> float:
    """Mean squared reconstruction error, the Theorem-5 yardstick."""
    return float(torch.mean((torch.as_tensor(g_hat).float()
                             - torch.as_tensor(g_true).float()) ** 2))
