"""The training step (impx/train/step.py): the loss, its gradient, Adam with
the reference's learning-rate schedule, and the NaN guard.

`make_train_step(model, hp)` returns step(opt_state, iteration, batch, stats)
-> (metrics, stats); it updates the model's parameters and `opt_state` in
place. The update is optax's `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8
added outside the square root, bias correction from the step count)
[+ `add_decayed_weights` for adamw], `scale(-1)`, then times the learning
rate, as impx/train/step.py:make_optimizer chains them, written by hand over
the parameter list: `torch.optim.Adam.step()` cannot skip on a flag that
lives on the device. On a non-finite loss the whole update is skipped with
`torch.where`: parameters, both moments and the step count keep their
values. Nothing is read back to the host; the trainer reads `stats` once per
log interval.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults


@dataclasses.dataclass(frozen=True)
class TrainHyperParams:
    lr: float = 1e-4
    min_lr: float = 1e-6
    decay_rate: float = 0.999992
    decay_iter: int = 200_000
    optim: str = "adam"  # adam | adamw
    weight_decay: float = 5e-4
    grad_clip: float = 0.0

    def __post_init__(self):
        if self.optim not in ("adam", "adamw"):
            raise ValueError(f"unknown optim {self.optim!r} (expected 'adam' or 'adamw')")


def lr_at(hp: TrainHyperParams, iteration: int) -> float:
    """lr0 * decay_rate^(iteration - decay_iter), clamped to [min_lr, lr0]
    (impx/train/step.py:lr_at)."""
    lr = hp.lr * hp.decay_rate ** (iteration - hp.decay_iter)
    return max(min(lr, hp.lr), hp.min_lr)


def init_opt_state(model) -> dict:
    """Adam's state: the step count (int32) and both moments, by parameter
    name (impx: make_optimizer(hp).init(params))."""
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": {n: torch.zeros_like(p) for n, p in params.items()},
            "nu": {n: torch.zeros_like(p) for n, p in params.items()}}


def init_stats(device) -> dict:
    """Running stats on the device, threaded through the steps
    (impx/train/step.py:init_stats)."""
    z = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return {"loss_sum": z(), "n_good": z(), "consec_bad": z(), "max_consec_bad": z()}


def _clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax.clip_by_global_norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


def make_train_step(model, hp: TrainHyperParams) -> Callable:
    """step(opt_state, iteration, batch, stats) -> (metrics, stats) for
    `model.forward_train(batch)`; see the module docstring."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def step(opt_state: dict, iteration: int, batch: dict, stats: dict):
        model.zero_grad(set_to_none=True)
        out = model.forward_train(batch)
        loss = out["loss"]
        loss.backward()
        bad = ~torch.isfinite(loss.detach())
        lr = lr_at(hp, iteration)
        with torch.no_grad():
            # a parameter the loss does not reach has gradient 0, as in JAX
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if hp.grad_clip > 0:
                grads = _clip_by_global_norm(grads, hp.grad_clip)
            mus = [opt_state["mu"][n] for n in names]
            nus = [opt_state["nu"][n] for n in names]
            count = opt_state["count"]
            count_inc = count + 1
            mu_new = torch._foreach_add(torch._foreach_mul(grads, 1 - ADAM_B1),
                                        torch._foreach_mul(mus, ADAM_B1))
            nu_new = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - ADAM_B2),
                                        torch._foreach_mul(nus, ADAM_B2))
            t = count_inc.float()
            mu_hat = torch._foreach_div(mu_new, 1 - ADAM_B1 ** t)
            nu_hat = torch._foreach_div(nu_new, 1 - ADAM_B2 ** t)
            upd = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS))
            if hp.optim == "adamw":
                upd = torch._foreach_add(upd, torch._foreach_mul(params, hp.weight_decay))
            new_params = torch._foreach_add(params, torch._foreach_mul(torch._foreach_neg(upd), lr))
            # skip the whole update on a bad loss (impx/train/step.py:88-92)
            for old, new in zip(params + mus + nus, new_params + mu_new + nu_new):
                old.copy_(torch.where(bad, old, new))
            count.copy_(torch.where(bad, count, count_inc))

            badf = bad.float()
            consec = torch.where(bad, stats["consec_bad"] + 1.0, 0.0)
            stats = {"loss_sum": stats["loss_sum"] + torch.where(bad, 0.0, loss.detach()),
                     "n_good": stats["n_good"] + (1.0 - badf),
                     "consec_bad": consec,
                     "max_consec_bad": torch.maximum(stats["max_consec_bad"], consec)}
            metrics = {"loss": loss.detach(), "matching_loss": out["matching_loss"].detach(),
                       "acc_corr": out["acc_corr"], "acc_incorr": out["acc_incorr"],
                       "total_acc_corr": out["total_acc_corr"],
                       "total_acc_incorr": out["total_acc_incorr"],
                       "geo_loss": out["geo_loss"].detach(), "max_mscore": out["matching_scores0"].max(),
                       "lr": lr, "bad_loss": bad.to(torch.int32)}
        return metrics, stats

    return step
