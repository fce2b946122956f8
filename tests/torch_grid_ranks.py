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
    ``fn(*args)`` of this module for each (name, args) of `calls`; a call
    (name, args, (n_model, n_pipe)) first makes that grid."""
    from pepflowww_torch.parallel import dist

    torch.set_num_threads(1)
    dist.init("cpu")
    dist.setup_grid(n_model)
    out = []
    for name, args, *grid in calls:
        if grid:
            dist.setup_grid(*grid[0])
        out.append(globals()[name](*args))
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


def steps(sd, widths, batch_np, noises, sharded, hooks=False, n_micro=4):
    """``train_step`` of a fresh model on this rank's rows of `batch_np`, once
    for each global draw of `noises`, on this rank's grid, with a
    ``ShardedOptimizer`` where `sharded`. Returns the metrics and the
    reduced gradients (before the clip) and the parameters after each
    step (``params`` those after the last), the sizes this rank holds after ``prepare`` and
    after each step and, with `hooks`, the shapes of the pair tensor that
    every EdgeTransition and IPA received. On a pipe axis the step cuts
    the rows into `n_micro` microbatches."""
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
                       noise={k: torch.from_numpy(v) for k, v in noise.items()}, n_micro=n_micro)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(_grads(model, opt, metrics[-1]))
        sizes.append(held())
        with opt.gathered():
            after.append({n: p.detach().numpy().copy() for n, p in model.named_parameters()})
    return {"data_rank": g.data_rank, "model_rank": g.model_rank, "pipe_rank": g.pipe_rank,
            "metrics": metrics,
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


def trunk(ipa, state_np, n_micro):
    """The pipelined trunk (``parallel/pp.py``) on this data rank's rows of
    `state_np` (GAEncoder's inputs as numpy) against the port's own
    ``GAEncoder.forward`` on them: a GAEncoder of IPAConfig(**`ipa`),
    reference init plus 0.02 noise from seed 0. Returns, on a last stage,
    the largest gap of each output; None elsewhere."""
    from pepflowww_torch.models.flow import init_weights
    from pepflowww_torch.models.trunk import GAEncoder, IPAConfig
    from pepflowww_torch.parallel import dist, dp, pp

    g = dist.grid()
    torch.manual_seed(0)
    enc = GAEncoder(IPAConfig(**ipa))
    gen = torch.Generator().manual_seed(0)
    init_weights(enc, gen)
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    args = [torch.from_numpy(dp.rank_rows(v, g.data_rank, g.n_data)) for v in state_np]
    t, rot, trans, angles, seqs, node, edge, gen_mask, res = args
    with torch.no_grad():
        want = enc(*args)
        pipe = pp.Pipeline(enc, n_micro)
        state0 = (enc.prologue(t, rot, trans, angles, seqs, node, edge, res) if pipe.first
                  else None)
        out = pipe.forward(state0, res)
        if out is None:
            return None
        node, R, tr = out
        got = enc.epilogue((node, None, R, tr, None))
    return {"data_rank": g.data_rank, "stages": g.n_pipe,
            "gaps": [float((a.detach() - b).abs().max()) for a, b in zip(got, want)]}


def ownership(sd, widths, batch_np, noise_np, n_micro):
    """One pipelined forward and backward (``pp.loss_and_backward``) on this
    rank's rows of a model with the weights `sd` plus 0.02 noise from seed 0
    (so that no zero-initialized layer hides a gradient): the names of the
    parameters with a gradient other than zero on this stage, before any
    reduce, and of those ``pp.stage_parameters`` gives this stage."""
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.parallel import dist, dp, pp

    g = dist.grid()
    model = model_of(sd, *widths)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    batch = device_batch(dp.rank_rows(batch_np, g.data_rank, g.n_data), "cpu")
    noise = dp.rank_rows({k: torch.from_numpy(v) for k, v in noise_np.items()}, g.data_rank,
                         g.n_data)
    losses = pp.loss_and_backward(model, batch, WEIGHTS, noise, n_micro)
    own = {id(p) for p in pp.stage_parameters(model, g.pipe_rank, g.n_pipe)}
    return {"pipe_rank": g.pipe_rank, "losses": None if losses is None else
            {k: float(v) for k, v in losses.items()},
            "nonzero": sorted(n for n, p in model.named_parameters()
                              if p.grad is not None and bool(p.grad.ne(0).any())),
            "owned": sorted(n for n, p in model.named_parameters() if id(p) in own),
            "names": [n for n, _ in model.named_parameters()]}
