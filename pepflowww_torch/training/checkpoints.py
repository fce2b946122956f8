"""Checkpoints in the reference's layout: ``<dir>/<iteration>.pt`` holding
{model, optimizer, scheduler, iteration, config}, with ``model`` the
reference-named state dict (it loads into a reference ``FlowModel`` and
through :func:`pepflowww_torch.convert.read_torch_checkpoint` with
``strict=True``)."""

from __future__ import annotations

import os
from typing import Optional

import torch


def save_checkpoint(ckpt_dir: str, it: int, model, optimizer, scheduler, config: dict) -> str:
    """Write ``<ckpt_dir>/<it>.pt`` (through a temporary file) and return its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{it}.pt")
    state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "optimizer": optimizer.state_dict(), "scheduler": scheduler.state_dict(),
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
    checkpoint file, or a directory: its latest); returns the iteration."""
    from pepflowww_torch.convert import load_state_dict

    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = found
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    load_state_dict(model, ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    return int(ckpt["iteration"])
