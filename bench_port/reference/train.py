"""The training step written down plainly, in float32: the denoising loss
(``t ~ U[0, T)``, ``x_t = sqrt(ab) x0 + sqrt(1-ab) eps``, mean squared error
against eps, labels replaced by the null label with probability
``cfg_drop_prob``), the gradient by autograd, optax's
``clip_by_global_norm`` (scale by ``m / norm`` only when ``norm >= m``),
Adam (b1 0.9, b2 0.999, eps 1e-8, bias correction by ``1 - b^(c+1)``,
constant learning rate) and the EMA with warm-up
(``min(decay, (1 + step) / (10 + step))``). Imports nothing of the
program.

The draws of a step come from a ``torch.Generator`` in the order the
program's step makes them: the label-drop mask ``rand(B)``, the timesteps
``randint(0, T, (B,))``, the noise ``randn`` of the batch's shape.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from bench_port.reference.diffusion import Schedule

B1, B2, EPS = 0.9, 0.999, 1e-8


def draws(g: torch.Generator, x: torch.Tensor, T: int, drop_prob: float):
    B = x.shape[0]
    drop = (torch.rand((B,), generator=g, device=x.device) < drop_prob
            if drop_prob > 0 else None)
    t = torch.randint(0, T, (B,), generator=g, device=x.device)
    noise = torch.randn(x.shape, generator=g, dtype=x.dtype, device=x.device)
    return drop, t, noise


def loss_and_grads(forward, P: Dict[str, torch.Tensor], s: Schedule, x, y,
                   drop, t, noise, null_label: int, rows=None,
                   flip_first: bool = False):
    """``(loss, grads)``: the mean squared error of the model's eps on the
    batch (its ``rows`` only, when given), and its gradient per leaf.
    ``flip_first`` negates the first row's target (a planted fault)."""
    if drop is not None:
        y = torch.where(drop, torch.full_like(y, null_label), y)
    if rows is not None:
        x, y, t, noise = x[rows], y[rows], t[rows], noise[rows]
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    x_t = (s.sqrt_ab[t].reshape(-1, 1, 1, 1) * x
           + s.sqrt_1mab[t].reshape(-1, 1, 1, 1) * noise)
    pred = forward(leaves, x_t, t, y)
    target = noise
    if flip_first:
        target = torch.cat([-noise[:1], noise[1:]])
    loss = ((pred - target) ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


class Adam:
    """Adam with optional global-norm clipping, on dicts of tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 clip: float = None):
        self.lr, self.clip, self.count = lr, clip, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params, grads) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the gradients as the moments
        took them (clipped)."""
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        factor = 1.0
        if self.clip is not None:
            factor = torch.where(norm < self.clip, torch.ones_like(norm),
                                 self.clip / norm)
        c = self.count
        taken = {}
        for k, g in grads.items():
            g = g * factor
            taken[k] = g
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            mu_hat = self.mu[k] / (1 - B1 ** (c + 1))
            nu_hat = self.nu[k] / (1 - B2 ** (c + 1))
            params[k] -= self.lr * mu_hat / (torch.sqrt(nu_hat) + EPS)
        self.count += 1
        return taken


@torch.no_grad()
def ema_update(ema, params, decay: float, step: int):
    eff = min(decay, (1.0 + step) / (10.0 + step))
    for k in ema:
        ema[k] = eff * ema[k] + (1.0 - eff) * params[k]


def run_steps(forward, P0: Dict[str, torch.Tensor], s: Schedule,
              batches: List[tuple], g: torch.Generator, tr: dict,
              null_label: int, fault: str = None) -> dict:
    """The first ``len(batches)`` steps from ``P0``: per step the loss, the
    first step's gradient as Adam took it, and the parameters and EMA after
    the last. ``fault`` plants ``half_batch`` (the second half of every
    batch left out, the mean taken over the rest) or ``altered`` (the first
    row's target negated where the loss is formed)."""
    params = {k: v.clone() for k, v in P0.items()}
    ema = {k: v.clone() for k, v in P0.items()}
    opt = Adam(params, tr["learning_rate"], tr.get("grad_clip_norm"))
    losses, first_grad = [], None
    for step, (x, y) in enumerate(batches):
        drop, t, noise = draws(g, x, s.T, tr["cfg_drop_prob"])
        rows = slice(0, x.shape[0] // 2) if fault == "half_batch" else None
        loss, grads = loss_and_grads(forward, params, s, x, y, drop, t,
                                     noise, null_label, rows,
                                     flip_first=fault == "altered")
        taken = opt.update(params, grads)
        ema_update(ema, params, tr["ema_decay"], step)
        losses.append(float(loss))
        if first_grad is None:
            first_grad = taken
    return {"losses": losses, "grad1": first_grad, "params": params,
            "ema": ema}
