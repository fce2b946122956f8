"""The row and generator rules of a data-parallel batch (counterpart of the
JAX package's ``parallel/mesh.py::shard_batch`` and of the per-shard keys
of ``parallel/manual.py``).

* Rows: rank r holds the r-th contiguous block of a global batch
  (:func:`rank_rows`), as ``shard_batch`` and the loader's ``shard_index``
  place them; a count the world size does not divide is padded with copies
  of its last row (:func:`pad_rows`), and the copies are discarded after
  :func:`gather_rows`.
* Generators: where each rank draws its own stream (the DP sampler, the
  ``--dp_manual`` step), rank r seeds its generator with
  ``rank_seed(seed, r)``, the port's ``fold_in``: rank 0 keeps the seed, so
  a world of one draws what a single process draws, and rank r > 0 takes
  the first word of ``numpy.random.SeedSequence((seed, r))``. The global
  step draws the global batch's noise from one seed on every rank instead.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pepflowww_torch.parallel import dist


def rank_rows(x, rank: int, world: int):
    """Rank `rank`'s contiguous block of the leading axis of `x` (a tensor,
    an array, a list, or a dict of them; other dict values pass through).
    The leading size must divide by `world`."""
    if isinstance(x, dict):
        return {k: rank_rows(v, rank, world) if _rows(v) is not None else v
                for k, v in x.items()}
    n = _rows(x)
    if n % world:
        raise ValueError(f"{n} rows do not split into {world} equal blocks")
    per = n // world
    return x[rank * per:(rank + 1) * per]


def _rows(v) -> Optional[int]:
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return int(v.shape[0]) if v.ndim else None
    return len(v) if isinstance(v, list) else None


def pad_rows(batch: dict, world: int) -> dict:
    """`batch` (a dict of tensors with one leading size) with copies of its
    last row appended up to the least multiple of `world`."""
    n = next(int(v.shape[0]) for v in batch.values() if isinstance(v, torch.Tensor))
    extra = -n % world
    if not extra:
        return batch
    return {k: torch.cat([v, v[-1:].expand(extra, *v.shape[1:])])
            if isinstance(v, torch.Tensor) else v for k, v in batch.items()}


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s own generator (module docstring)."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence((int(seed), int(rank))).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(rank_seed(seed, rank))


def gather_rows(x: dict, n: Optional[int] = None) -> Optional[dict]:
    """Every data rank's tensors of `x` (equal shapes on every rank) on rank
    0, on the host, concatenated in data-rank order (model rank 0's of each
    model group: its other ranks hold the same rows) and cut to the first
    `n` rows (the padding discarded); None on the other ranks."""
    x = {k: v.detach().cpu().contiguous() for k, v in x.items()}
    if dist.world_size() > 1:
        world, primary = dist.world_size(), dist.is_primary()
        n_model = dist.grid().n_model
        out = {}
        for k, v in x.items():
            parts = [torch.empty_like(v) for _ in range(world)] if primary else None
            torch.distributed.gather(v, parts, dst=0, group=dist.control_group())
            if primary:
                out[k] = torch.cat(parts[::n_model])
        x = out
    if not dist.is_primary():
        return None
    return {k: v[:n] for k, v in x.items()} if n is not None else x
