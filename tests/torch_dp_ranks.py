"""Rank functions of the port's data-parallel tests, run by
``pepflowww_torch.parallel.dist.launch`` in spawned processes over gloo.

This module imports neither JAX nor the JAX package (the test modules that
hold the ranks to JAX do, and a spawned rank imports the module of the
function it runs). Every rank returns numpy arrays and plain values."""

import numpy as np
import torch

WEIGHTS = {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
           "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5}


def _model(sd, nb):
    from pepflowww_torch.models.flow import FlowModelConfig, build_model
    from pepflowww_torch.models.trunk import IPAConfig

    cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=nb))
    return build_model(cfg, "cpu", state_dict=sd).train()


def _step(sd, nb, batch_np, noise, manual):
    """One train_step of a fresh model on this rank's rows of
    `batch_np`: (metrics, the reduced gradients before the clip, the
    parameters after the step)."""
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.parallel import dist, dp
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    model = _model(sd, nb)
    opt = Optimizer(model.parameters(), {"type": "adam", "lr": 1e-3}, 100.0)
    batch = device_batch(dp.rank_rows(batch_np, dist.rank(), dist.world_size()), "cpu")
    noise = {k: torch.from_numpy(v) for k, v in noise.items()}
    m = train_step(model, opt, batch, WEIGHTS, noise=noise, manual=manual)
    m = {k: float(v) for k, v in m.items()}
    clip = min(1.0, 100.0 / (m["grad_norm"] + 1e-6))   # .grad holds the clipped gradient
    grads = {n: p.grad.numpy() / clip for n, p in model.named_parameters()}
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    return m, grads, params


def _own_grads(sd, nb, batch_np, noise):
    """This rank's own gradients of its rows (no reduce), NaN-rescued."""
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.parallel import dist, dp
    from pepflowww_torch.training.optim import zero_nans
    from pepflowww_torch.training.train_step import loss_and_total

    model = _model(sd, nb)
    batch = device_batch(dp.rank_rows(batch_np, dist.rank(), dist.world_size()), "cpu")
    total, _ = loss_and_total(model, batch, WEIGHTS,
                              noise={k: torch.from_numpy(v) for k, v in noise.items()})
    total.backward()
    zero_nans(model.parameters())
    return {n: p.grad.numpy().copy() for n, p in model.named_parameters()}


def train_steps(sd, nb, batch_np, noise, poisoned_row, manual, sample=None):
    """The steps of tests/test_torch_dp.py (global) or
    tests/test_torch_dp_manual.py (`manual`; `noise` then holds each rank's
    own draws) on one rank of two: the step, again, and with row
    `poisoned_row` of the batch non-finite, beside this rank's own
    gradients of its rows, clean and poisoned; with `sample` (a batch, a
    seed and a number of steps), :func:`sample_rows` of it."""
    from pepflowww_torch.parallel import dist

    torch.set_num_threads(1)
    dist.init("cpu")
    r = dist.rank()
    noise = noise[r] if manual else noise
    own_noise = noise if manual else {k: v[r:r + 1] for k, v in noise.items()}
    bad = dict(batch_np)
    bad["pos_heavyatom"] = batch_np["pos_heavyatom"].copy()
    bad["pos_heavyatom"][poisoned_row] = np.nan
    out = {"rank": r,
           "step": _step(sd, nb, batch_np, noise, manual),
           "again": _step(sd, nb, batch_np, noise, manual),
           "bad": _step(sd, nb, bad, noise, manual),
           "own": _own_grads(sd, nb, batch_np, own_noise),
           "own_bad": _own_grads(sd, nb, bad, own_noise)}
    if sample is not None:
        out["sample"] = sample_rows(sd, nb, *sample)
    dist.barrier()
    return out


def sample_rows(sd, nb, batch_np, seed, steps):
    """``dp_euler_sample`` of `batch_np` on one rank of an initialized
    group, beside a single-process ``euler_sample`` of this rank's rows of
    the padded batch with a fresh generator of its seed, in this process
    (one thread, as the DP sampler ran): {"gathered": rank 0's gathered
    outputs (None on the other ranks), "own": the reference}."""
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.parallel import dist, dp
    from pepflowww_torch.sampling import dp_euler_sample, euler_sample

    model = _model(sd, nb).eval()
    r, world = dist.rank(), dist.world_size()
    batch = device_batch(batch_np, "cpu")
    out = dp_euler_sample(model, batch, dp.rank_generator(seed, r, "cpu"), num_steps=steps)
    own = euler_sample(model, dp.rank_rows(dp.pad_rows(batch, world), r, world),
                       dp.rank_generator(seed, r, "cpu"), num_steps=steps)
    return {"gathered": None if out is None else {k: v.numpy() for k, v in out.items()},
            "own": {k: v.numpy() for k, v in own.items()}}


def fail_on(rank):
    """Raises on rank `rank` of a group; the other ranks return their rank."""
    from pepflowww_torch.parallel import dist

    dist.init("cpu")
    if dist.rank() == rank:
        raise ValueError(f"raised on rank {rank}")
    return dist.rank()
