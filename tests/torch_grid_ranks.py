"""Rank functions of the port's FSDP and pair-row TP tests, run by
``pepflowww_torch.parallel.dist.launch`` in spawned processes over gloo.

This module imports neither JAX nor the JAX package (a spawned rank
imports the module of the function it runs). Every rank returns numpy
arrays and plain values."""

import numpy as np
import torch

WEIGHTS = {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
           "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5}
OPT = {"type": "adam", "lr": 1e-3}


def model_of(sd, ipa: dict, node: int, edge: int):
    """A FlowModel of the widths `ipa` (IPAConfig's keywords), `node` and
    `edge`, with the state dict `sd` (numpy), in train mode on the CPU."""
    from pepflowww_torch.models.flow import FlowModelConfig, build_model
    from pepflowww_torch.models.trunk import IPAConfig

    cfg = FlowModelConfig(node_embed_size=node, edge_embed_size=edge, ipa=IPAConfig(**ipa))
    return build_model(cfg, "cpu", state_dict=sd).train()


def run(n_model: int, calls: list) -> list:
    """Start this rank on a grid of `n_model` model ranks (one thread), then
    ``fn(*args)`` of this module for each (name, args) of `calls`."""
    from pepflowww_torch.parallel import dist

    torch.set_num_threads(1)
    dist.init("cpu")
    dist.setup_grid(n_model)
    out = [globals()[name](*args) for name, args in calls]
    dist.barrier()
    return out


def _grads(model, opt, m) -> dict:
    """The reduced gradients before the clip, by parameter name (the step
    leaves the clipped ones in ``.grad``, or in a sharded optimizer's block)."""
    clip = min(1.0, 100.0 / (m["grad_norm"] + 1e-6))
    names = [n for n, _ in model.named_parameters()]
    if opt.sharded:
        per = opt._per_param(opt.shard.grad)
        return {n: g.numpy() / clip for n, g in zip(names, per)}
    return {n: p.grad.numpy() / clip for n, p in model.named_parameters()}


def steps(sd, widths, batch_np, noises, sharded, hooks=False):
    """``train_step`` of a fresh model on this rank's rows of `batch_np`, once
    for each global draw of `noises`, on this rank's grid, with a
    ``ShardedOptimizer`` where `sharded`. Returns the metrics and the
    reduced gradients (before the clip) and the parameters after each
    step (``params`` those after the last), the sizes this rank holds after ``prepare`` and
    after each step and, with `hooks`, the shapes of the pair tensor that
    every EdgeTransition and IPA received."""
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.models.ipa import EdgeTransition, InvariantPointAttention
    from pepflowww_torch.parallel import dist, dp
    from pepflowww_torch.parallel.fsdp import ShardedOptimizer
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    g = dist.grid()
    model = model_of(sd, *widths)
    seen = []
    if hooks:
        for name, mod in model.named_modules():
            if isinstance(mod, (EdgeTransition, InvariantPointAttention)):
                mod.register_forward_hook(
                    lambda m, args, out, name=name: seen.append((name, tuple(args[1].shape))))
    opt = (ShardedOptimizer if sharded else Optimizer)(model.parameters(), OPT, 100.0)

    def held():
        """Elements of the parameters' storage, of each moment, of the block."""
        st = opt.opt.state.get(opt.shard if sharded else None, {})
        return {"params": sum(p.untyped_storage().nbytes() // 4 for p in model.parameters()),
                "block": opt.shard.numel() if sharded else None,
                "moments": [int(v.numel()) for k, v in sorted(st.items()) if k != "step"],
                "grad_block": None if not sharded or opt.shard.grad is None
                else int(opt.shard.grad.numel())}

    sizes = [held()]
    batch = device_batch(dp.rank_rows(batch_np, g.data_rank, g.n_data), "cpu")
    metrics, grads, after = [], [], []
    for noise in noises:
        m = train_step(model, opt, batch, WEIGHTS,
                       noise={k: torch.from_numpy(v) for k, v in noise.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(_grads(model, opt, metrics[-1]))
        sizes.append(held())
        with opt.gathered():
            after.append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    return {"data_rank": g.data_rank, "model_rank": g.model_rank, "metrics": metrics,
            "grads": grads, "params": after[-1], "after": after, "sizes": sizes, "numel": opt.numel if sharded
            else None, "span": opt.span if sharded else None, "n_params": len(opt.params),
            "seen": seen}


def sample(sd, widths, batch_np, seed, n_steps, plain_of=None):
    """``dp_euler_sample`` on this rank's grid with this data rank's
    generator of `seed`; with `plain_of` (IPAConfig keywords with a
    kernel profile) the model is built from ``tp.plain_profile`` of that
    profile, and the warnings it gave are returned."""
    import dataclasses
    import warnings

    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.parallel import dist, dp, tp
    from pepflowww_torch.sampling import dp_euler_sample

    g = dist.grid()
    caught = []
    if plain_of is not None:
        from pepflowww_torch.models.flow import FlowModelConfig, build_model
        from pepflowww_torch.models.trunk import IPAConfig

        ipa, node, edge = widths
        cfg = FlowModelConfig(node_embed_size=node, edge_embed_size=edge,
                              ipa=IPAConfig(**{**ipa, **plain_of}))
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            cfg = tp.plain_profile(cfg)
        caught = [str(r.message) for r in rec]
        assert not dataclasses.asdict(cfg.ipa)["use_pallas"]
        model = build_model(cfg, "cpu", state_dict=sd).eval()
    else:
        model = model_of(sd, *widths).eval()
    out = dp_euler_sample(model, device_batch(batch_np, "cpu"),
                          dp.rank_generator(seed, g.data_rank, "cpu"), num_steps=n_steps)
    return {"out": None if out is None else {k: v.numpy() for k, v in out.items()},
            "warnings": caught}
