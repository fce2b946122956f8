"""One training step (counterpart of the JAX package's
``training/train_step.py::make_train_step`` and, over the ranks of
``parallel/dist.py``, of ``make_dp_train_step`` and the manual
``make_manual_dp_train_step``), with its NaN semantics: a non-finite total
loss gives zero gradients (the optimizer still steps), and residual
non-finite gradient entries are zeroed before the clip."""

from __future__ import annotations

import torch

from pepflowww_torch.training.optim import Optimizer, sum_weighted_losses


def loss_and_total(model, batch: dict, loss_weights: dict, generator=None, noise=None):
    """(total, losses): the weighted total, 0 where it is not finite."""
    losses = model.loss(batch, generator, noise)
    total = sum_weighted_losses(losses, loss_weights)
    total = torch.where(torch.isfinite(total), total, torch.zeros_like(total))
    return total, losses


def train_step(model, optimizer: Optimizer, batch: dict, loss_weights: dict, generator=None,
               noise=None, manual: bool = False) -> dict:
    """Forward, backward and optimizer step on this rank's rows `batch`.
    Returns the six losses, ``loss`` (the weighted total, 0 where it is not
    finite) and ``grad_norm`` (the global norm of the gradients before the
    clip) as 0-d tensors on the batch's device, equal on every rank; nothing
    here waits for the device. Without a process group this is the
    single-process step of a world of one.

    Global step (the JAX package's ``make_dp_train_step``): `noise` is the
    global batch's :func:`draw_noise` dict, or it is drawn here for the
    global batch (this batch's rows times the world size) from `generator`,
    seeded alike on every rank; each rank keeps its own rows, so the
    corruption is the single-process step's row for row. A non-finite total
    on any rank zeroes every rank's gradients, after the reduce, as the
    global step's rescue does.

    ``manual`` (``make_manual_dp_train_step``): `noise` and `generator` are
    this rank's own (``dp.rank_generator``), and each rank rescues its own
    step before the reduce.

    The gradients (accumulated in place into ``optimizer.flat_grads``), the
    six losses, the total and a non-finite flag travel in one flat buffer
    in a fixed order through one all-reduce (sum, then divided by the world
    size: with equal rows on every rank the mean of the rank means is the
    global mean), so every rank steps its optimizer on the same gradients."""
    from pepflowww_torch.models.flow import LOSS_NAMES, draw_noise
    from pepflowww_torch.parallel import dist, dp

    world, rank = dist.world_size(), dist.rank()
    flat = optimizer.flat_grads(len(LOSS_NAMES) + 2)
    grads, tail = flat[:-len(LOSS_NAMES) - 2], flat[-len(LOSS_NAMES) - 2:]
    B, L = batch["aa"].shape
    if noise is None:
        noise = draw_noise(B if manual else B * world, L, generator, batch["aa"].device,
                           model.cfg.interpolant.num_classes)
    if not manual:
        noise = dp.rank_rows(noise, rank, world)
    losses = model.loss(batch, noise=noise)
    raw = sum_weighted_losses(losses, loss_weights)
    finite = torch.isfinite(raw)
    total = torch.where(finite, raw, torch.zeros_like(raw))
    total.backward()
    if manual:
        torch.nan_to_num_(grads, nan=0.0, posinf=0.0, neginf=0.0)
    tail.copy_(torch.stack([losses[k].detach().float() for k in LOSS_NAMES]
                           + [(total if manual else raw).detach().float(),
                              (~finite).float()]))
    if dist.is_initialized():
        torch.distributed.all_reduce(flat)
    flat.div_(world)
    if not manual:
        torch.nan_to_num_(grads, nan=0.0, posinf=0.0, neginf=0.0)
        rescued = tail[-1] > 0
        grads.masked_fill_(rescued, 0.0)
        tail[-2:-1].masked_fill_(rescued, 0.0)
    out = tail.clone()   # the buffer is zeroed by the next step
    metrics = dict(zip(LOSS_NAMES, out))
    metrics["loss"] = out[-2]
    # One reduction over every gradient, accumulated in float64 (float32
    # over millions of entries drifts by ~1e-4).
    metrics["grad_norm"] = torch.linalg.vector_norm(grads, dtype=torch.float64).float()
    optimizer.step()
    return metrics
