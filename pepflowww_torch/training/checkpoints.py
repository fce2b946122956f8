"""Checkpoints in the reference's layout: ``<dir>/<iteration>.pt`` holding
{model, optimizer, scheduler, iteration, config}, with ``model`` the
reference-named state dict (it loads into a reference ``FlowModel`` and
through :func:`pepflowww_torch.convert.read_torch_checkpoint` with
``strict=True``)."""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(ckpt_dir: str, it: int, model, optimizer, scheduler,
                    config: dict) -> Optional[str]:
    """Write ``<ckpt_dir>/<it>.pt`` (through a temporary file) on rank 0 and
    return its path (None on the other ranks). Every rank calls it: a
    sharded optimizer (``parallel/fsdp.py``) gathers the parameters and its
    state from every data rank, so the file holds the single process's
    layout at any data size."""
    from pepflowww_torch.parallel import dist

    if not dist.is_primary() and not optimizer.sharded:
        return None
    with optimizer.gathered():
        model_sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        opt_sd = optimizer.state_dict()
    if not dist.is_primary():
        return None
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{it}.pt")
    state = {"model": model_sd, "optimizer": opt_sd, "scheduler": scheduler.state_dict(),
             "iteration": int(it), "config": config}
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The checkpoint of the highest iteration in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    its = [int(f[:-3]) for f in os.listdir(ckpt_dir) if f.endswith(".pt") and f[:-3].isdigit()]
    return os.path.join(ckpt_dir, f"{max(its)}.pt") if its else None


def restore_checkpoint(path: str, model, optimizer, scheduler) -> int:
    """Load model (strict), optimizer and scheduler state from `path` (a
    checkpoint file, or a directory: its latest); returns the iteration.
    Under FSDP every rank calls it and takes its block."""
    from pepflowww_torch.convert import load_state_dict

    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = found
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    with optimizer.gathered(writeback=True):   # a sharded optimizer keeps its block
        load_state_dict(model, ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    return int(ckpt["iteration"])
