"""Fully sharded data parallelism (counterpart of the JAX package's
``parallel/fsdp.py``): the training state lives in equal blocks over the
data ranks of ``dist.grid()``.

The trainable parameters are laid end to end, in parameter order, in one
flat float32 vector, each from a multiple of :data:`ALIGN` elements (the
kernels read parameters, which are views of it, with 16-byte loads), the
whole padded to a multiple of the data size; data rank d
holds its d-th contiguous block of it, of Adam's two moments and, with
``accum_grad`` > 1, of the accumulator (JAX's per-leaf rule shards each
leaf's largest divisible dimension; one flat vector shards every element,
and since Adam is elementwise and the clip takes the global norm, the
numbers are the single-process step's). A step (``train_step`` drives it):

1. :meth:`ShardedOptimizer.flat_grads` all-gathers the blocks into a new
   flat vector, of which the parameters become views, and zeroes a flat
   gradient buffer of which their gradients are views;
2. the forward and the backward;
3. :meth:`ShardedOptimizer.reduce_grads` reduce-scatters the gradient
   buffer (and sums it over the model group under pair-row TP, over the
   pipe group under pipeline parallelism), all-reduces
   the losses beside it, and releases the whole parameters and gradients;
4. :meth:`ShardedOptimizer.step` clips by the global norm of every data
   rank's block and steps Adam on this rank's block.

Between steps the parameters hold no storage: :meth:`gathered` brings them
back for validation, sampling and checkpoints. The state dict is the
single process's (the reference-named parameters, torch Adam's
per-parameter ``exp_avg``/``exp_avg_sq``/``step``), gathered on every
rank, and it loads at any data size.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as tdist

from pepflowww_torch.models.layers import invalidate_operand_caches
from pepflowww_torch.parallel import dist
from pepflowww_torch.training.optim import Optimizer, make_torch_optimizer, square_sum

#: Elements: each parameter starts on a 128-byte boundary of the flat vector.
ALIGN = 32


class ShardedOptimizer(Optimizer):
    """:class:`Optimizer` with its state in blocks over the data ranks
    (module docstring). Every rank of the grid builds it, at once, from the
    same parameters; it takes this rank's block and releases the rest."""

    sharded = True

    def __init__(self, params, opt_cfg: dict, max_grad_norm: float = 100.0, accum_grad: int = 1):
        super().__init__(params, opt_cfg, max_grad_norm, accum_grad)
        g = dist.grid()
        self.n, self.rank, self.group = g.n_data, g.data_rank, g.data_group
        self._shapes = [p.shape for p in self.params]
        self._numels = [p.numel() for p in self.params]
        self.numel = sum(self._numels)
        self.offsets, o = [], 0
        for n in self._numels:
            self.offsets.append(o)
            o += -(-n // ALIGN) * ALIGN
        self.span = o   # the layout's length: the parameters and the gaps between them
        self.block = -(-self.span // self.n)
        self.padded = self.block * self.n
        self._empty = self.params[0].new_empty(0)
        with torch.no_grad():
            self.shard = torch.nn.Parameter(self._block_of([p.detach() for p in self.params]))
        self.opt = make_torch_optimizer([self.shard], opt_cfg)
        self._full = None
        self.release()

    # -- the whole parameters -------------------------------------------
    def _gather_flat(self, block: torch.Tensor) -> torch.Tensor:
        """Every data rank's `block`, end to end (the padded flat vector)."""
        out = block.new_empty(self.padded)
        if self.n == 1:
            out.copy_(block)
        else:
            dist.all_gather_into(out, block.detach().contiguous(), self.group)
        return out

    def gather(self) -> None:
        """Make the parameters whole (a collective of the data group)."""
        if self._full is not None:
            return
        full = self._gather_flat(self.shard.detach())
        for p, o, n, shape in zip(self.params, self.offsets, self._numels, self._shapes):
            p.data = full[o:o + n].view(shape)
        self._full = full
        invalidate_operand_caches()

    def release(self) -> None:
        """Drop the whole parameters' storage (this rank keeps its block),
        and the kernel operands made from them, some of which are views."""
        for p in self.params:
            p.grad = None
            p.data = self._empty
        self._full = None
        invalidate_operand_caches()

    @contextlib.contextmanager
    def gathered(self, writeback: bool = False):
        """The whole parameters for the block, released after it unless they
        were whole before; with `writeback`, this rank's block of them is
        kept (a restored checkpoint)."""
        held = self._full is not None
        self.gather()
        try:
            yield
        finally:
            if writeback:
                with torch.no_grad():
                    self.shard.copy_(self._full[self.rank * self.block:
                                                (self.rank + 1) * self.block])
            if not held:
                self.release()

    # -- the step -------------------------------------------------------
    def flat_grads(self, extra: int = 0) -> torch.Tensor:
        """Gather the parameters and zero a flat gradient buffer (the padded
        vector's layout, then `extra` slots) of which their gradients are views."""
        self.gather()
        flat = self.shard.new_zeros(self.padded + extra)
        for p, o, n, shape in zip(self.params, self.offsets, self._numels, self._shapes):
            p.grad = flat[o:o + n].view(shape)
        return flat

    def reduce_grads(self, flat: torch.Tensor, extra: int) -> torch.Tensor:
        """This rank's block of the data-mean gradient (reduce-scatter over
        the data group, then a sum over the model group under pair-row TP or
        over the pipe group under pipeline parallelism),
        the `extra` slots all-reduced over every rank; then the whole
        parameters and gradients are released. Returns the block."""
        g = dist.grid()
        block = flat.new_empty(self.block)
        if self.n == 1:
            block.copy_(flat[:self.padded])
        else:
            dist.reduce_scatter_into(block, flat[:self.padded], self.group)
        if g.n_minor > 1:
            tdist.all_reduce(block, group=g.minor_group)
        tail = flat[self.padded:]
        if dist.is_initialized():
            tdist.all_reduce(tail)
        block.div_(self.n)
        tail.div_(self.n)
        self.release()
        self.shard.grad = block
        return block

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of every data rank's block (`grads` this rank's)."""
        sq = square_sum(grads)
        if self.n > 1:
            tdist.all_reduce(sq, group=self.group)
        return sq.sqrt().float()

    def _stepped(self) -> list:
        return [self.shard]

    # -- the single process's state dict --------------------------------
    def _per_param(self, block: torch.Tensor) -> list:
        full = self._gather_flat(block).cpu()
        return [full[o:o + n].view(shape).clone()
                for o, n, shape in zip(self.offsets, self._numels, self._shapes)]

    def _block_of(self, tensors) -> torch.Tensor:
        """This rank's block of per-parameter `tensors` laid out as the
        parameters are (zeros in the gaps), on the parameters' device."""
        flat = self._empty.new_zeros(self.padded)
        for t, o, n in zip(tensors, self.offsets, self._numels):
            flat[o:o + n] = t.reshape(-1).to(flat)
        return flat[self.rank * self.block:(self.rank + 1) * self.block].clone()

    def state_dict(self) -> dict:
        """The single process's optimizer state (every rank calls it: the
        moments are gathered)."""
        sd = self.opt.state_dict()
        group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
        ids = list(range(len(self.params)))
        state = {}
        own = sd["state"].get(0)
        if own is not None:
            moments = {k: self._per_param(v) for k, v in own.items() if k != "step"}
            state = {i: {"step": own["step"].clone(), **{k: m[i] for k, m in moments.items()}}
                     for i in ids}
        return {"optimizer": {"state": state, "param_groups": [{**group, "params": ids}]},
                "mini_step": self.mini_step,
                "acc": None if self.acc is None else self._per_param(self.acc[0])}

    def load_state_dict(self, d: dict) -> None:
        """Take this rank's block of a single process's optimizer state."""
        od = d["optimizer"]
        group = {k: v for k, v in od["param_groups"][0].items() if k != "params"}
        state = {}
        if od["state"]:
            per = [od["state"][i] for i in range(len(self.params))]
            state = {0: {"step": per[0]["step"],
                         **{k: self._block_of([s[k] for s in per])
                            for k in per[0] if k != "step"}}}
        self.opt.load_state_dict({"state": state, "param_groups": [{**group, "params": [0]}]})
        self.mini_step = int(d.get("mini_step", 0))
        acc = d.get("acc")
        self.acc = None if acc is None else [self._block_of(acc)]
