"""Batch assembly: padding to a length bucket, and the residue selection
helpers (counterpart of the JAX package's ``data/collate.py``).

Pad values: aa -> PAD_RESIDUE_INDEX (21), everything else -> 0; ``res_mask``
marks real residues. Batches stay numpy until :func:`device_batch` moves
them to a device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from pepflowww_torch.constants import PAD_RESIDUE_INDEX

#: Array fields carried into device batches (string metadata stays host-side).
TENSOR_KEYS = ("aa", "pos_heavyatom", "mask_heavyatom", "chain_nb", "res_nb", "resseq",
               "generate_mask", "torsion_angle", "torsion_angle_mask")

DEFAULT_BUCKETS = (32, 48, 64, 96, 128, 160, 192, 256)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / 8) * 8)


def _pad_first(x: np.ndarray, n: int, value=0) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad_shape = (n - x.shape[0],) + x.shape[1:]
    return np.concatenate([x, np.full(pad_shape, value, dtype=x.dtype)], axis=0)


def pad_and_collate(items: Sequence[dict], pad_to: Optional[int] = None,
                    buckets: Sequence[int] = DEFAULT_BUCKETS) -> dict:
    """Stack per-complex dicts into a padded numpy batch. ``pad_to=None``
    pads to the bucket above the longest item (past the last bucket, to a
    multiple of 8)."""
    max_len = max(item["aa"].shape[0] for item in items)
    if pad_to is None:
        pad_to = bucket_length(max_len, buckets)
    if pad_to < max_len:
        raise ValueError(f"pad_to={pad_to} < max item length {max_len}")
    out = {}
    for key in TENSOR_KEYS:
        if key not in items[0]:
            continue
        value = PAD_RESIDUE_INDEX if key == "aa" else 0
        out[key] = np.stack([_pad_first(np.asarray(item[key]), pad_to, value) for item in items])
    out["res_mask"] = np.stack([_pad_first(np.ones(item["aa"].shape[0], dtype=bool), pad_to, False)
                                for item in items])
    out["id"] = [item.get("id", "") for item in items]
    return out


def replicate_item(item: dict, n: int) -> list:
    """n shallow copies of one complex (one per sample)."""
    return [dict(item) for _ in range(n)]


def device_batch(batch: dict, device) -> dict:
    """The array fields of a numpy batch as tensors on `device` (index
    fields int64, floats float32, masks bool); host-only fields dropped."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        if v.dtype.kind in "iu":
            v = v.astype(np.int64)
        elif v.dtype.kind == "f":
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def mask_select(v, mask: np.ndarray):
    """The residues of `v` (an array or list of residue length) where `mask`
    holds; anything else unchanged."""
    n = len(mask)
    if isinstance(v, np.ndarray) and v.shape[:1] == (n,):
        return v[mask]
    if isinstance(v, list) and len(v) == n:
        return [x for x, m in zip(v, mask) if m]
    return v


def mask_select_data(data: dict, mask: np.ndarray) -> dict:
    return {k: mask_select(v, mask) for k, v in data.items()}
