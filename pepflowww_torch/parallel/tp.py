"""Pair-row tensor parallelism (counterpart of the JAX package's
``parallel/tp.py``): the ranks of a model group (``dist.setup_grid``) hold
the same rows of a batch and split the query rows of its L² pair tensors.

Under :func:`pair_rows` the model computes, on model rank m of n, the
pair rows ``[i0, i1)`` against all columns, with L padded to a multiple of
n by masked residues (:func:`pad_length`):

* the EdgeEmbedder builds only its rows of every pair feature;
* each IPA takes its queries (and their points) from those rows and its
  keys from all L, and the trunk gathers the node update of every row
  (:func:`gather_rows`); the LayerNorm, the sequence transformer, the
  transitions and the backbone update then run on all rows, alike on
  every rank of the group;
* each EdgeTransition takes the i-side node terms of its rows and the
  j-side of all L.

Gradients. A node tensor that enters pair work passes :func:`copy_in`,
whose backward sums its gradient over the model group, so everything
computed alike on every rank (and its parameters) gets the whole gradient
on every rank, while the parameters of the pair work
(``FlowModel.pair_parameters``) get this rank's part. The training step keeps the first kind on model rank 0 only and
sums over every rank, so each rank ends with the single-process gradient.

Kernels. The port's kernels take whole pair rows, as the JAX package's
Pallas kernels cannot be partitioned: :func:`plain_profile` builds the
model without them (``use_pallas``, ``use_pallas_ipa``, ``quant_int8``
off) and warns, as ``xla_profile_model`` does, and :func:`current` refuses
a module that runs its kernels under :func:`pair_rows`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from contextvars import ContextVar
from typing import Optional

import torch
import torch.distributed as tdist

from pepflowww_torch.constants import PAD_RESIDUE_INDEX
from pepflowww_torch.parallel import dist

PROFILE_WARNING = ("pair-row tensor parallelism: the Pallas-profile kernels (use_pallas, "
                   "use_pallas_ipa, quant_int8) take whole pair rows; building the equivalent "
                   "plain model instead, as the JAX package's xla_profile_model does")
REFUSED = ("pair-row TP runs the plain model: build it from tp.plain_profile(cfg), as the "
           "--tp entry points do")


@dataclasses.dataclass(frozen=True)
class Shard:
    """Pair rows ``[i0, i1)`` of a padded length on model rank `rank` of `n`."""

    i0: int
    i1: int
    length: int
    n: int
    rank: int
    group: object

    @property
    def rows(self) -> slice:
        return slice(self.i0, self.i1)


_SHARD: ContextVar[Optional[Shard]] = ContextVar("pepflowww_torch_pair_rows", default=None)


def current(kernels: bool = False) -> Optional[Shard]:
    """The pair rows of this rank inside :func:`pair_rows`, else None.
    Raises where a module that runs its kernels (`kernels`) asks for them."""
    shard = _SHARD.get()
    if kernels and shard is not None:
        raise ValueError(REFUSED)
    return shard


def padded_length(L: int, n: int) -> int:
    return -(-int(L) // n) * n


@contextlib.contextmanager
def pair_rows(L: int):
    """Run the model on this rank's pair rows of a batch of length `L`
    (padded to a multiple of the model size); yields the :class:`Shard`, or
    None where the grid has no model axis (the model then runs whole)."""
    g = dist.grid()
    if g.n_model == 1:
        yield None
        return
    Lp = padded_length(L, g.n_model)
    per = Lp // g.n_model
    token = _SHARD.set(Shard(g.model_rank * per, (g.model_rank + 1) * per, Lp, g.n_model,
                             g.model_rank, g.model_group))
    try:
        yield _SHARD.get()
    finally:
        _SHARD.reset(token)


def pad_length(x: dict, Lp: int, L: Optional[int] = None) -> dict:
    """`x` (a batch, or the corruption draws) with axis 1 of every tensor of
    length `L` padded to `Lp`: a batch with masked residues (``aa``
    PAD_RESIDUE_INDEX, every other field 0, as ``pad_and_collate`` pads),
    the draws (no ``aa``) with copies of their last residue."""
    L = L if L is not None else next(int(v.shape[1]) for v in x.values()
                                     if isinstance(v, torch.Tensor) and v.dim() > 1)
    if Lp == L:
        return x
    draws = "aa" not in x
    out = {}
    for k, v in x.items():
        if not (isinstance(v, torch.Tensor) and v.dim() > 1 and v.shape[1] == L):
            out[k] = v
            continue
        shape = (v.shape[0], Lp - L) + tuple(v.shape[2:])
        if draws:
            pad = v[:, -1:].expand(shape)
        else:
            pad = v.new_full(shape, PAD_RESIDUE_INDEX if k == "aa" else 0)
        out[k] = torch.cat([v, pad], 1)
    return out


class _CopyIn(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        tdist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """(B, rows, ...) on each model rank -> (B, every row, ...) in rank
    order; the backward keeps this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.rows = shard.rows
        x = x.contiguous()
        out = x.new_empty(shard.n * x.numel())
        dist.all_gather_into(out, x.reshape(-1), shard.group)
        out = out.view(shard.n, *x.shape).movedim(0, 1)
        return out.reshape(x.shape[0], shard.n * x.shape[1], *x.shape[2:])

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.rows].contiguous(), None


def copy_in(x: torch.Tensor) -> torch.Tensor:
    """`x`, computed alike on every rank of the model group, as it enters
    this rank's pair work (the identity outside :func:`pair_rows`)."""
    shard = current()
    return x if shard is None else _CopyIn.apply(x, shard.group)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every row of a node tensor of which this rank computed its pair rows
    (the identity outside :func:`pair_rows`)."""
    shard = current()
    return x if shard is None else _GatherRows.apply(x, shard)


def plain_profile(cfg, warning: str = PROFILE_WARNING):
    """`cfg` (a FlowModelConfig) with the kernels off, warning where any was
    on: the model that pair-row TP runs (the JAX package's
    ``xla_profile_model``, ``tests/test_tp.py:112``), and pipeline
    parallelism with its own `warning`."""
    ipa = cfg.ipa
    if not (ipa.use_pallas or ipa.use_pallas_ipa or ipa.quant_int8):
        return cfg
    warnings.warn(warning, stacklevel=2)
    return dataclasses.replace(cfg, ipa=dataclasses.replace(
        ipa, use_pallas=False, use_pallas_ipa=False, quant_int8=False))
