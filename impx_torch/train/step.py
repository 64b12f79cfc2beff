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

Data parallelism (the model's `data_group`, set by
impx_torch/train/trainer.py): each rank runs forward_train on its block of
the global batch, whose loss functions then return this rank's share of the
global batch's loss (impx_torch/models/loss.py). The gradients of every
parameter and the loss and metric shares go into one flat bucket and one
all-reduce (sum) over the group: the global loss and gradient, on every
rank, as impx's sharded step computes them in one program. The NaN guard
reads the global loss, so one bad share skips the update on every rank, and
gradient clipping reads the global norm. Under tensor parallelism (the
model's `model_group`, impx_torch/parallel/tp.py) Adam moves this rank's
shards; the clipping norm sums the squares of the sharded parameters'
gradients over the model group and counts a replicated parameter once.
After a step, each parameter's `.grad` holds the gradient its update
applied: the global one, clipped where `grad_clip` is set.

Sequence parallelism (the model's `seq_group`, impx_torch/parallel/mesh.py:
set_seq_group): each rank's gradients are its keypoints' part (the score
head's replicated bin score counted on one rank), so the bucket is summed
over the union of the data and sequence groups (`seq_union`); every rank of
a sequence group computed the same loss, so only its rank 0 puts the loss
and metric shares into the bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from impx_torch.tools.profiling import span

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


def _clip_by_global_norm(grads: list, max_norm: float, sharded: list | None = None, model_group=None) -> list:
    """optax.clip_by_global_norm. sharded (one bool a gradient) and
    model_group: the squares of the tensor-parallel shards are summed over
    the group, those of replicated parameters counted once."""
    if model_group is None:
        sq = sum((g * g).sum() for g in grads)
    else:
        from impx_torch.parallel.collectives import psum

        zero = grads[0].new_zeros(())
        part = sum(((g * g).sum() for g, s in zip(grads, sharded) if s), zero)
        sq = psum(part, model_group) + sum(((g * g).sum() for g, s in zip(grads, sharded) if not s), zero)
    norm = torch.sqrt(sq)
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


# the metrics summed over the data-parallel ranks (each rank's is its share)
SUMMED_METRICS = ("loss", "matching_loss", "acc_corr", "acc_incorr", "total_acc_corr", "total_acc_incorr",
                  "geo_loss")


def reduce_bucket(grads: list, out: dict, group, with_metrics: bool = True) -> tuple[list, dict]:
    """One all-reduce over the data group of a flat bucket holding every
    gradient, the loss and metric shares of SUMMED_METRICS and, for the
    largest match score, this rank's maximum in its own slot (zeros in the
    others), so that the sum carries every rank's. with_metrics=False puts
    zeros for this rank's shares (a rank whose sequence group's rank 0
    holds the same ones). Returns the summed gradients (views of the
    bucket) and the global metrics."""
    import torch.distributed as dist

    n, me = dist.get_world_size(group), dist.get_rank(group)
    scalars = torch.stack([out[k].detach().float().reshape(()) for k in SUMMED_METRICS])
    if not with_metrics:
        scalars = torch.zeros_like(scalars)
    slots = scalars.new_zeros(n)
    slots[me] = out["matching_scores0"].max().float()
    flat = torch.cat([g.reshape(-1).float() for g in grads] + [scalars, slots])
    dist.all_reduce(flat, group=group)
    sizes = [g.numel() for g in grads] + [len(SUMMED_METRICS), n]
    parts = flat.split(sizes)
    summed = [p.view_as(g).to(g.dtype) for p, g in zip(parts, grads)]
    metrics = dict(zip(SUMMED_METRICS, parts[-2].unbind(0)))
    metrics["max_mscore"] = parts[-1].max()
    return summed, metrics


def make_train_step(model, hp: TrainHyperParams) -> Callable:
    """step(opt_state, iteration, batch, stats) -> (metrics, stats) for
    `model.forward_train(batch)`; see the module docstring."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    data_group = getattr(model, "data_group", None)
    model_group = getattr(model, "model_group", None)
    seq_group = getattr(model, "seq_group", None)
    bucket_group = data_group if seq_group is None else model.seq_union
    with_metrics = seq_group is None or model.seq_index == 0
    sharded = [n in getattr(model, "tp_sharded", ()) for n in names]

    def step(opt_state: dict, iteration: int, batch: dict, stats: dict):
        with span("impx.train.step"):
            model.zero_grad(set_to_none=True)
            with span("impx.train.forward"):
                out = model.forward_train(batch)
            with span("impx.train.backward"):
                out["loss"].backward()
            lr = lr_at(hp, iteration)
            with span("impx.train.optimizer"), torch.no_grad():
                # a parameter the loss does not reach has gradient 0, as in JAX
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
                if bucket_group is None:
                    glob = {k: out[k].detach() for k in SUMMED_METRICS}
                    glob["max_mscore"] = out["matching_scores0"].max()
                else:
                    grads, glob = reduce_bucket(grads, out, bucket_group, with_metrics)
                loss = glob["loss"]
                bad = ~torch.isfinite(loss)
                if hp.grad_clip > 0:
                    grads = _clip_by_global_norm(grads, hp.grad_clip, sharded, model_group)
                if bucket_group is not None or hp.grad_clip > 0:
                    for p, g in zip(params, grads):   # .grad: the gradient the update applies
                        p.grad = g
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
                stats = {"loss_sum": stats["loss_sum"] + torch.where(bad, 0.0, loss),
                         "n_good": stats["n_good"] + (1.0 - badf),
                         "consec_bad": consec,
                         "max_consec_bad": torch.maximum(stats["max_consec_bad"], consec)}
                metrics = {**glob, "lr": lr, "bad_loss": bad.to(torch.int32)}
            return metrics, stats

    return step
