"""One training step (counterpart of the JAX package's
``training/train_step.py::make_train_step`` and, over the ranks of
``parallel/dist.py``, of ``make_dp_train_step``, the manual
``make_manual_dp_train_step``, ``make_tp_train_step`` and
``parallel/fsdp.py::make_fsdp_train_step`` and, over pipeline stages,
``make_pp_train_step``), with its NaN semantics: a non-finite total
loss gives zero gradients (the optimizer still steps), and residual
non-finite gradient entries are zeroed before the clip."""

from __future__ import annotations

import torch

from pepflowww_torch.training.optim import Optimizer, finite_total, sum_weighted_losses


def loss_and_total(model, batch: dict, loss_weights: dict, generator=None, noise=None):
    """(total, losses): the weighted total, 0 where it is not finite. On a
    grid with a model axis the model runs on this rank's pair rows
    (``parallel/tp.py``), and the ranks of a model group call it together."""
    from pepflowww_torch.parallel import tp

    L = int(batch["aa"].shape[1])
    with tp.pair_rows(L) as shard:
        if shard is not None:
            batch = tp.pad_length(batch, shard.length)
            noise = None if noise is None else tp.pad_length(noise, shard.length, L)
        losses = model.loss(batch, generator, noise)
    return finite_total(losses, loss_weights), losses


def train_step(model, optimizer: Optimizer, batch: dict, loss_weights: dict, generator=None,
               noise=None, manual: bool = False, n_micro: int = 4) -> dict:
    """Forward, backward and optimizer step on this rank's rows `batch`.
    Returns the six losses, ``loss`` (the weighted total, 0 where it is not
    finite) and ``grad_norm`` (the global norm of the gradients before the
    clip) as 0-d tensors on the batch's device, equal on every rank; nothing
    here waits for the device. Without a process group this is the
    single-process step of a world of one.

    Global step (the JAX package's ``make_dp_train_step``): `noise` is the
    global batch's :func:`draw_noise` dict, or it is drawn here for the
    global batch (this batch's rows times the number of data ranks) from
    `generator`, seeded alike on every rank; each data rank keeps its own
    rows, so the corruption is the single-process step's row for row. A
    non-finite total on any rank zeroes every rank's gradients, after the
    reduce, as the global step's rescue does.

    ``manual`` (``make_manual_dp_train_step``): `noise` and `generator` are
    this rank's own (``dp.rank_generator``), and each rank rescues its own
    step before the reduce.

    The grid (``dist.grid()``): on a model axis (``make_tp_train_step``) the
    ranks of a model group hold the same rows and run the model on their
    pair rows, L padded to a multiple of the model size by masked residues
    (``parallel/tp.py``); the gradients of the parameters no pair work uses,
    which every rank of the group computes whole, and the losses are kept on
    its model rank 0 only before the sum. A ``ShardedOptimizer``
    (``parallel/fsdp.py``, ``make_fsdp_train_step``) gathers the parameters
    first and reduce-scatters the gradients; both compose. On a pipe axis
    (``make_pp_train_step``) the ranks of a pipe group hold the same rows,
    cut into `n_micro` microbatches, and run the GPipe schedule of
    ``parallel/pp.py``: each gradient comes from one stage, and the losses
    from the last; a ``ShardedOptimizer`` composes with it too.

    The gradients (accumulated in place into ``optimizer.flat_grads``), the
    six losses, the total and a non-finite flag travel in one flat buffer
    in a fixed order (``optimizer.reduce_grads``: summed over every rank,
    then divided by the number of data ranks: with equal rows on every
    data rank the mean of the rank means is the global mean), so every rank
    steps its optimizer on the same gradients."""
    from pepflowww_torch.models.flow import LOSS_NAMES, draw_noise
    from pepflowww_torch.parallel import dist, dp

    g = dist.grid()
    if manual and (g.n_minor > 1 or optimizer.sharded):
        raise ValueError("the manual step is the data axis alone: no --fsdp, --tp or --pp")
    extra = len(LOSS_NAMES) + 2
    flat = optimizer.flat_grads(extra)
    tail = flat[-extra:]
    B, L = batch["aa"].shape
    if noise is None:
        noise = draw_noise(B if manual else B * g.n_data, L, generator, batch["aa"].device,
                           model.cfg.interpolant.num_classes)
    if not manual:
        noise = dp.rank_rows(noise, g.data_rank, g.n_data)
    if g.n_pipe > 1:
        from pepflowww_torch.parallel import pp

        losses = pp.loss_and_backward(model, batch, loss_weights, noise, n_micro)
    else:
        total, losses = loss_and_total(model, batch, loss_weights, noise=noise)
        total.backward()
    if manual:
        torch.nan_to_num_(flat[:-extra], nan=0.0, posinf=0.0, neginf=0.0)
    if losses is not None:   # off the last stage of a pipe group the slots stay 0
        raw = sum_weighted_losses(losses, loss_weights)
        tail.copy_(torch.stack([losses[k].detach().float() for k in LOSS_NAMES]
                               + [(total if manual else raw).detach().float(),
                                  (~torch.isfinite(raw)).float()]))
    if g.model_rank:
        pair = {id(p) for p in model.pair_parameters()}
        for p in model.parameters():
            if id(p) not in pair:
                p.grad.zero_()
        tail.zero_()
    grads = optimizer.reduce_grads(flat, extra)
    if not manual:
        torch.nan_to_num_(grads, nan=0.0, posinf=0.0, neginf=0.0)
        rescued = tail[-1] > 0
        grads.masked_fill_(rescued, 0.0)
        tail[-2:-1].masked_fill_(rescued, 0.0)
    out = tail.clone()   # the buffer is zeroed by the next step
    metrics = dict(zip(LOSS_NAMES, out))
    metrics["loss"] = out[-2]
    metrics["grad_norm"] = optimizer.global_norm(grads)
    optimizer.step(metrics["grad_norm"])
    return metrics
