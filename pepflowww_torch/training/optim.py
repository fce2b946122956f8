"""Optimizer, plateau scheduler, NaN rescue (counterpart of the JAX
package's ``training/optim.py``).

* gradient-norm clip at ``max_grad_norm`` (100), then Adam, or AdamW when
  weight decay is set, with optax's betas and eps 1e-8;
* accumulation as ``optax.MultiSteps``: the running mean of k steps'
  gradients, one clipped update every k-th step, none in between;
* NaN rescue: non-finite gradient entries are zeroed elementwise;
* ReduceLROnPlateau (min mode) as a small host-side controller, stepped on
  the validation loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterable, Optional

import torch


def zero_nans(params: Iterable[torch.Tensor]) -> None:
    """Zero the non-finite entries of every gradient, in place."""
    for p in params:
        if p.grad is not None:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=0.0, neginf=0.0)


def square_sum(grads) -> torch.Tensor:
    """The float64 sum of squares of a tensor or of a list of tensors."""
    if isinstance(grads, torch.Tensor):
        grads = [grads]
    return sum(torch.linalg.vector_norm(g, dtype=torch.float64).square() for g in grads)


def sum_weighted_losses(losses: dict, weights: Optional[dict]):
    """sum_k weights[k] * losses[k] (an unweighted sum without weights)."""
    if weights is None:
        return sum(losses.values())
    return sum(weights.get(k, 0.0) * v for k, v in losses.items())


def finite_total(losses: dict, weights: Optional[dict]) -> torch.Tensor:
    """The weighted total of `losses`, 0 where it is not finite (its
    gradient then zero: the NaN rescue of the JAX package's ``loss_fn``)."""
    total = sum_weighted_losses(losses, weights)
    return torch.where(torch.isfinite(total), total, torch.zeros_like(total))


def make_torch_optimizer(params, opt_cfg: dict) -> torch.optim.Optimizer:
    """Adam, or AdamW where weight decay is set, with optax's betas and eps 1e-8."""
    kind = opt_cfg.get("type", "adam")
    if kind not in ("adam", "adamw"):
        raise ValueError(f"Unknown optimizer type: {kind}")
    lr = float(opt_cfg.get("lr", 5e-4))
    betas = (float(opt_cfg.get("beta1", 0.9)), float(opt_cfg.get("beta2", 0.999)))
    wd = float(opt_cfg.get("weight_decay", 0.0))
    if kind == "adam" and wd == 0.0:
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    return torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)


class Optimizer:
    """Clip, then Adam/AdamW, with MultiSteps-style accumulation.

    ``step()`` consumes the gradients in ``.grad``. With ``accum_grad`` k > 1
    it folds them into the running mean acc += (g - acc) / (n + 1) and
    applies the clipped update with that mean on every k-th call only, as
    ``optax.MultiSteps`` does; it returns whether the parameters moved.

    Every rank holds all of its state (the parameters, the moments, the
    accumulator); ``parallel/fsdp.py::ShardedOptimizer`` holds a block of
    each. The training step drives either through :meth:`flat_grads`,
    :meth:`reduce_grads`, :meth:`global_norm` and :meth:`step`."""

    sharded = False

    def __init__(self, params, opt_cfg: dict, max_grad_norm: float = 100.0, accum_grad: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.opt = make_torch_optimizer(self.params, opt_cfg)
        self.max_grad_norm = float(max_grad_norm)
        self.accum_grad = int(accum_grad)
        self.mini_step = 0
        self.acc = None
        self._flat, self._views = None, []

    @property
    def lr(self) -> float:
        return self.opt.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = value

    def flat_grads(self, extra: int = 0) -> torch.Tensor:
        """Zero the gradients as one buffer: every parameter's ``.grad`` a
        view of it, in parameter order, and `extra` slots after them. A
        backward then accumulates into the buffer in place, so one
        collective reduces every gradient with no copy in or out (the
        buffer is kept, and the views set again where anything else replaced
        a gradient)."""
        n = sum(p.numel() for p in self.params)
        if self._flat is None or self._flat.numel() != n + extra:
            p0 = self.params[0]
            self._flat = torch.zeros(n + extra, dtype=p0.dtype, device=p0.device)
            offsets = [0]
            for p in self.params:
                offsets.append(offsets[-1] + p.numel())
            self._views = [self._flat[o:o + p.numel()].view_as(p)
                           for o, p in zip(offsets, self.params)]
        else:
            self._flat.zero_()
        for p, v in zip(self.params, self._views):
            if p.grad is not v:
                p.grad = v
        return self._flat

    def reduce_grads(self, flat: torch.Tensor, extra: int) -> torch.Tensor:
        """The gradient buffer of :meth:`flat_grads`, after the backward,
        summed over every rank and divided by the number of data ranks (the
        mean of the data ranks' gradients, where each model group's ranks
        hold parts of its rows' gradient); the `extra` slots travel with it.
        Returns the gradients."""
        from pepflowww_torch.parallel import dist

        if dist.is_initialized():
            torch.distributed.all_reduce(flat)
        flat.div_(dist.grid().n_data)
        return flat[:-extra]

    def global_norm(self, grads) -> torch.Tensor:
        """The 2-norm of every gradient (`grads` from :meth:`reduce_grads`,
        or a list of tensors), accumulated in float64 (float32 over millions
        of entries drifts by ~1e-4)."""
        return square_sum(grads).sqrt().float()

    @contextlib.contextmanager
    def gathered(self, writeback: bool = False):
        """The model's whole parameters for the block (they always are here)."""
        yield

    def _stepped(self) -> list:
        """The tensors Adam steps."""
        return self.params

    def step(self, norm: Optional[torch.Tensor] = None) -> bool:
        """Clip, then Adam, on the gradients in ``.grad`` (or fold them into
        the accumulator). The clip scales them by min(1, max_grad_norm /
        (norm + 1e-6)), as ``clip_grad_norm_`` and optax's
        ``clip_by_global_norm`` do, with `norm` their :meth:`global_norm`
        (the training step's metric) where given and no accumulation
        changed them, else the one computed here."""
        params = self._stepped()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accum_grad > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in params]
            for a, p in zip(self.acc, params):
                a.add_((p.grad - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.accum_grad:
                return False
            for a, p in zip(self.acc, params):
                p.grad.copy_(a)
                a.zero_()
            self.mini_step = 0
            norm = None
        if norm is None:
            norm = self.global_norm([p.grad for p in params])
        coef = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
        for p in params:
            p.grad.mul_(coef)
        self.opt.step()
        return True

    def state_dict(self) -> dict:
        return {"optimizer": self.opt.state_dict(), "mini_step": self.mini_step,
                "acc": None if self.acc is None else [a.detach().cpu() for a in self.acc]}

    def load_state_dict(self, d: dict) -> None:
        self.opt.load_state_dict(d["optimizer"])
        self.mini_step = int(d.get("mini_step", 0))
        acc = d.get("acc")
        self.acc = None if acc is None else [a.to(p.device) for a, p in zip(acc, self.params)]


@dataclasses.dataclass
class PlateauScheduler:
    """torch.optim.lr_scheduler.ReduceLROnPlateau (min mode, relative
    threshold, no cooldown), stepped by hand: ``step(metric, lr)`` returns
    the new learning rate."""

    factor: float = 0.8
    patience: int = 10
    min_lr: float = 5e-6
    threshold: float = 1e-4
    best: float = float("inf")
    num_bad: int = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad = d["num_bad"]
