"""GPipe pipeline parallelism over the trunk's blocks (counterpart of the
JAX package's ``parallel/pp.py`` and of
``training/train_step.py::make_pp_train_step``).

The ranks of a pipe group (``dist.setup_grid(n_pipe=S)``, the pipe axis
minor as in ``make_mesh_pp``) hold the same rows of a batch; stage s of S
runs the trunk's blocks ``[s·k, (s+1)·k)``, k = num_blocks / S, by their
checkpoint names (``GAEncoder.block``). The rows are cut into M
microbatches, and a step (:func:`loss_and_backward`) is

1. stage 0: ``loss_pre`` (encode and corruption) on the whole batch and
   ``GAEncoder.prologue``;
2. forward, microbatch by microbatch: a stage receives the state (node,
   edge, R, trans) from the stage before it (stage 0 takes its rows of the
   prologue's), runs its blocks, each under ``torch.utils.checkpoint`` (JAX's
   per-block ``jax.checkpoint``: one state stashed per block input and
   microbatch), and sends the state on;
3. the last stage concatenates the microbatches' (node, R, trans) in row
   order and runs ``GAEncoder.epilogue`` and ``FlowModel.loss_post`` on the
   whole batch, with ``loss_pre``'s targets from the same global noise, so
   the losses are the single process's (means over rows; no per-row work
   crosses rows);
4. backward, microbatch by microbatch in the same order: each stage
   receives the gradient of what it sent, back-propagates through its
   blocks and sends the gradient of what it received; stage 0 then
   back-propagates through the prologue and the encoder once.

A hop carries only the tensors with a gradient: every rank holds the batch,
so the masks are rebuilt from it. Every send has its receive posted in the
same order on the other side, all forward hops before any backward one,
so no send waits on a receive that is never posted.

Each parameter's gradient comes from one stage of a pipe group: the
encoder and the prologue's modules from stage 0, a block's modules from
its stage, ``seq_net`` and ``angle_net`` from the last
(:func:`stage_parameters`); only the last stage holds the losses. The
training step's one reduce then sums every gradient once.

Kernels. ``make_pp_train_step`` swaps in the XLA graph unconditionally
(``tp.xla_profile_model``); the port's rule is the same: the model is built
from :func:`plain_profile`, and :func:`loss_and_backward` refuses a model
with its kernels on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from pepflowww_torch.parallel import dist, tp

# The JAX package's words (parallel/pp.py:221, train_step.py:183, train.py:265).
STAGES = "pipeline needs >= 2 stages (use the plain/DP step for 1)"
EDGE_WIDTH = ("pp assumes a width-uniform pair track (edge_embed_size == c_z); the stacked "
              "first-block IPA readout weights would otherwise differ in shape from the later "
              "blocks'")
PP_TP = ("--pp composes with --fsdp (state sharded over 'data') and the data axis on its (data, "
         "pipe) mesh; --tp is not supported alongside it — the pair-row axis would need a third "
         "mesh dimension, and the pipelined shard_map body computes pair tensors per stage where "
         "a 'model'-axis constraint has no meaning")
PROFILE_WARNING = ("pipeline parallelism: the Pallas-profile kernels (use_pallas, use_pallas_ipa, "
                   "quant_int8) are off under --pp, as the JAX package's make_pp_train_step "
                   "turns them off (xla_profile_model); building the equivalent plain model "
                   "instead")
REFUSED = ("pipeline parallelism runs the plain model: build it from pp.plain_profile(cfg), as "
           "the --pp train CLI does")


def check(cfg, n_pipe: int, n_micro: int, batch: int, n_data: int = 1) -> Optional[str]:
    """Why a FlowModelConfig `cfg` cannot pipeline a global batch of
    `batch` rows over `n_data` data ranks of `n_pipe` stages in `n_micro`
    microbatches, in the JAX package's words; None where it can."""
    nb = cfg.ipa.num_blocks
    if n_pipe < 2:
        return STAGES
    if nb % n_pipe:
        return f"num_blocks {nb} must divide over {n_pipe} pipeline stages"
    if n_micro < 1 or batch % (n_data * n_micro):
        return f"batch {batch} must divide into {n_data} data shards x {n_micro} microbatches"
    if cfg.edge_embed_size != cfg.ipa.c_z:
        return EDGE_WIDTH
    return None


def plain_profile(cfg):
    """`cfg` with the kernels off, warning where any was on (``make_pp_train_step``)."""
    return tp.plain_profile(cfg, warning=PROFILE_WARNING)


def stage_blocks(num_blocks: int, n_pipe: int, stage: int) -> range:
    k = num_blocks // n_pipe
    return range(stage * k, (stage + 1) * k)


def stage_parameters(model, stage: int, n_pipe: int) -> list:
    """The parameters whose gradient stage `stage` of `n_pipe` computes."""
    enc = model.ga_encoder
    mods = []
    if stage == 0:
        mods += [model.node_embedder, model.edge_embedder, enc.current_seq_embedder,
                 enc.angles_embedder, enc.res_feat_mixer]
    for b in stage_blocks(enc.cfg.num_blocks, n_pipe, stage):
        mods += [m for name, m in enc.trunk.items() if name.endswith(f"_{b}")]
    if stage == n_pipe - 1:
        mods += [enc.seq_net, enc.angle_net]
    return [p for m in mods for p in m.parameters()]


class Pipeline:
    """The GPipe schedule of one stage (module docstring, steps 2 and 4):
    :meth:`forward`, then :meth:`backward`, on every rank of a pipe group."""

    def __init__(self, enc, n_micro: int):
        g = dist.grid()
        self.enc, self.M = enc, int(n_micro)
        self.S, self.s = g.n_pipe, g.pipe_rank
        self.first, self.last = self.s == 0, self.s == self.S - 1
        self.prev, self.next = dist.rank() - 1, dist.rank() + 1
        self.blocks = stage_blocks(enc.cfg.num_blocks, self.S, self.s)

    def _specs(self, Bm: int, L: int) -> list:
        """(shape, dtype) of a hop's node, edge, R and trans: the edge in the
        EdgeTransitions' compute dtype (bf16 in the production profile)."""
        cfg, f32 = self.enc.cfg, torch.float32
        return [((Bm, L, cfg.c_s), f32), ((Bm, L, L, cfg.c_z), cfg.compute_dtype or f32),
                ((Bm, L, 3, 3), f32), ((Bm, L, 3), f32)]

    def _block(self, b, node, edge, R, trans, mask):
        return self.enc.block(b, (node, edge, R, trans, mask))[0][:4]

    def forward(self, state0, res_mask) -> Optional[tuple]:
        """Run this stage's blocks on every microbatch. `state0` is the
        prologue's state on stage 0 (None elsewhere), `res_mask` this data
        rank's (B, L) mask. Returns on the last stage the (node, R, trans)
        of every row, leaves whose gradients :meth:`backward` sends back;
        None elsewhere."""
        B, L = res_mask.shape
        Bm, dev = B // self.M, res_mask.device
        mask = res_mask.float()
        specs = self._specs(Bm, L)
        self.rows = [slice(m * Bm, (m + 1) * Bm) for m in range(self.M)]
        self.xs, self.ys = [], []
        if self.first:
            self.state0 = state0[:4]
            self.leaves = [x.detach().requires_grad_() for x in self.state0]
        for rows in self.rows:
            if self.first:
                x = [t[rows] for t in self.leaves]
            else:
                x = [t.requires_grad_() for t in dist.recv_state(specs, self.prev, dev)]
            y = list(x)
            for b in self.blocks:
                y = checkpoint(self._block, b, *y, mask[rows], use_reentrant=False)
            if not self.last:
                got = [(tuple(t.shape), t.dtype) for t in y]
                if got != specs:
                    raise RuntimeError(f"stage {self.s} hop: {got}, expected {specs}")
                dist.send_state(y, self.next)
            self.xs.append(x)
            self.ys.append(y)
        if not self.last:
            return None
        self.outs = [torch.cat([y[i] for y in self.ys]).detach().requires_grad_()
                     for i in (0, 2, 3)]
        return tuple(self.outs)

    def backward(self) -> None:
        """Back-propagate every microbatch through this stage's blocks (the
        last stage after the loss's backward has filled its outputs'
        gradients), sending the gradients of the received states back;
        stage 0 then back-propagates through the prologue and the encoder."""
        for x, y, rows in zip(self.xs, self.ys, self.rows):
            if self.last:
                ys = [y[0], y[2], y[3]]
                grads = [o.grad[rows] if o.grad is not None else torch.zeros_like(t)
                         for o, t in zip(self.outs, ys)]
            else:
                ys = y
                grads = dist.recv_state([(tuple(t.shape), t.dtype) for t in y], self.next,
                                        y[0].device)
            torch.autograd.backward(ys, grads)
            if not self.first:
                dist.send_state([t.grad if t.grad is not None else torch.zeros_like(t)
                                 for t in x], self.prev)
        if self.first:
            pairs = [(t, leaf.grad) for t, leaf in zip(self.state0, self.leaves)
                     if t.requires_grad and leaf.grad is not None]
            if pairs:
                torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
        self.xs = self.ys = self.outs = self.state0 = self.leaves = None


def loss_and_backward(model, batch: dict, loss_weights: dict, noise: dict,
                      n_micro: int) -> Optional[dict]:
    """One pipelined forward and backward of the training objective on this
    data rank's rows `batch` with its rows of the global draws `noise`
    (module docstring); every rank of the pipe group calls it. The
    gradients accumulate into ``.grad`` of this stage's parameters. Returns
    the six losses on the last stage, None elsewhere."""
    from pepflowww_torch.training.optim import finite_total

    g = dist.grid()
    B = int(batch["aa"].shape[0])
    msg = check(model.cfg, g.n_pipe, n_micro, B * g.n_data, g.n_data)
    if msg is not None:
        raise ValueError(msg)
    ipa = model.cfg.ipa
    if ipa.use_pallas or ipa.use_pallas_ipa or ipa.quant_int8:
        raise ValueError(REFUSED)
    enc = model.ga_encoder
    pipe = Pipeline(enc, n_micro)
    state0 = None
    if pipe.first:
        pre = model.loss_pre(batch, noise=noise)
        state0 = enc.prologue(pre["t"], pre["rotmats_t"], pre["trans_t_c"], pre["angles_t"],
                              pre["seqs_t"], pre["node_embed"], pre["edge_embed"],
                              batch["res_mask"])
    out = pipe.forward(state0, batch["res_mask"])
    losses = None
    if pipe.last:
        with torch.no_grad():
            pre = model.loss_pre(batch, noise=noise)
        node, R, trans = out
        losses = model.loss_post(batch, pre, enc.epilogue((node, None, R, trans, None)))
        finite_total(losses, loss_weights).backward()
    pipe.backward()
    return losses

