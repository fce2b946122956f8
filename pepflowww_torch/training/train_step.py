"""One training step (counterpart of the JAX package's
``training/train_step.py::make_train_step``), with its NaN semantics: a
non-finite total loss gives zero gradients (the optimizer still steps), and
residual non-finite gradient entries are zeroed before the clip."""

from __future__ import annotations

import torch

from pepflowww_torch.training.optim import Optimizer, sum_weighted_losses, zero_nans


def loss_and_total(model, batch: dict, loss_weights: dict, generator=None, noise=None):
    """(total, losses): the weighted total, 0 where it is not finite."""
    losses = model.loss(batch, generator, noise)
    total = sum_weighted_losses(losses, loss_weights)
    total = torch.where(torch.isfinite(total), total, torch.zeros_like(total))
    return total, losses


def train_step(model, optimizer: Optimizer, batch: dict, loss_weights: dict, generator=None,
               noise=None) -> dict:
    """Forward, backward and optimizer step. Returns the six losses,
    ``loss`` (the weighted total) and ``grad_norm`` (the global norm of the
    gradients before the clip) as 0-d tensors on the batch's device; nothing
    here waits for the device."""
    optimizer.zero_grad()
    total, losses = loss_and_total(model, batch, loss_weights, generator, noise)
    total.backward()
    zero_nans(optimizer.params)
    grads = [p.grad for p in optimizer.params if p.grad is not None]
    grad_norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    optimizer.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    metrics["grad_norm"] = grad_norm
    return metrics
