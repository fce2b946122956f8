"""All-atom structure build: torsion extraction and AF2-Alg.24 reconstruction
(counterpart of the JAX package's ``ops/allatom.py``).

Positions in Å; angles in [0, 2π); ``aa`` tokens 0-19 canonical, 20 UNK,
21 PAD. ``pos15`` uses the 15-slot heavy-atom layout (OXT last); the
rigid-group tables use the atom14 layout (first 14 slots).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pepflowww_torch import constants as C
from pepflowww_torch.ops import frames
from pepflowww_torch.ops.dihedrals import dihedral_from_four_points_raw

TWO_PI = 2.0 * math.pi

_TABLE_CACHE: dict = {}


def _table(name: str, device) -> torch.Tensor:
    """A constants table as a tensor on `device` (made once per device)."""
    key = (name, str(device))
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = torch.from_numpy(np.ascontiguousarray(getattr(C, name))).to(device)
    return _TABLE_CACHE[key]


def get_torsion_angles(pos15: torch.Tensor, aa: torch.Tensor):
    """(psi, chi1..chi4) per residue: (..., L, 5) angles in [0, 2π) with
    zeros where invalid, and the (..., L, 5) bool validity mask. A chi is
    valid iff it is defined for the residue type and its dihedral is
    finite; UNK/PAD residues are all-invalid."""
    dev = pos15.device
    aa_safe = aa.long().clamp(0, C.NUM_AA_TYPES - 1)
    psi_raw = dihedral_from_four_points_raw(
        pos15[..., 0, :], pos15[..., 1, :], pos15[..., 2, :], pos15[..., 3, :])

    chi_idx = _table("CHI_ATOM_INDICES", dev)[aa_safe].long()        # (..., L, 4, 4)
    chi_defined = _table("CHI_ANGLES_MASK", dev)[aa_safe] > 0        # (..., L, 4)
    idx = chi_idx.clamp(min=0)
    # Gather the four atom positions per chi: (..., L, 4, 4, 3).
    src = pos15[..., None, :, :].expand(*idx.shape[:-1], pos15.shape[-2], 3)
    p = torch.gather(src, -2, idx[..., None].expand(*idx.shape, 3))
    chi_raw = dihedral_from_four_points_raw(p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :])

    raw = torch.cat([psi_raw[..., None], chi_raw], -1)
    defined = torch.cat([torch.ones_like(chi_defined[..., :1]), chi_defined], -1)
    mask = defined & torch.isfinite(raw) & (aa < C.AA.UNK)[..., None]
    torsion = torch.where(mask, raw, torch.zeros_like(raw))
    torsion = torch.remainder(torch.nan_to_num(torsion, nan=0.0, posinf=0.0, neginf=0.0), TWO_PI)
    return torsion, mask


def torsions_mask_for(aa: torch.Tensor) -> torch.Tensor:
    """(..., 5) float validity of [psi, chi1..4] per token (UNK/PAD rows 0)."""
    return _table("TORSIONS_MASK", aa.device)[aa.long().clamp(0, 21)]


def heavyatom_mask_for(aa: torch.Tensor) -> torch.Tensor:
    """(..., 15) bool generated-structure atom mask (OXT excluded)."""
    return _table("HEAVYATOM_MASK_GEN", aa.device)[aa.long().clamp(0, 21)]


def _x_axis_rotation(angles: torch.Tensor) -> torch.Tensor:
    """Rotation about +x for each angle: (..., 3, 3)."""
    s, c = torch.sin(angles), torch.cos(angles)
    one, zero = torch.ones_like(s), torch.zeros_like(s)
    return torch.stack([
        torch.stack([one, zero, zero], -1),
        torch.stack([zero, c, -s], -1),
        torch.stack([zero, s, c], -1),
    ], -2)


def full_atom_reconstruction(R_bb, t_bb, angles, aa):
    """Compose backbone→psi→chi1..chi4 frames and place the 14 heavy atoms.

    R_bb (B, L, 3, 3), t_bb (B, L, 3), angles (B, L, 5), aa (B, L).
    Returns pos14 (B, L, 14, 3), R_frames (B, L, 6, 3, 3), t_frames
    (B, L, 6, 3), frames ordered [bb, psi, chi1, chi2, chi3, chi4].
    """
    dev = R_bb.device
    aa_safe = aa.long().clamp(0, C.NUM_AA_TYPES - 1)
    rots = _x_axis_rotation(angles)                                     # (B, L, 5, 3, 3)
    rg_R = _table("RIGID_GROUP_ROTATION", dev)[aa_safe]                 # (B, L, 8, 3, 3)
    rg_t = _table("RIGID_GROUP_TRANSLATION", dev)[aa_safe]              # (B, L, 8, 3)
    atom_group = _table("HEAVYATOM_TO_RIGID_GROUP", dev)[aa_safe]       # (B, L, 14)
    atom_pos = _table("HEAVYATOM_RIGID_GROUP_POSITIONS", dev)[aa_safe]  # (B, L, 14, 3)
    zeros = torch.zeros_like(t_bb)

    def chain(parent, frame_idx, rot):
        return frames.compose_chain(
            [parent, (rg_R[:, :, frame_idx], rg_t[:, :, frame_idx]), (rot, zeros)])

    psi = chain((R_bb, t_bb), C.PSI_FRAME, rots[:, :, 0])
    chi1 = chain((R_bb, t_bb), C.CHI1_FRAME, rots[:, :, 1])
    chi2 = chain(chi1, C.CHI2_FRAME, rots[:, :, 2])
    chi3 = chain(chi2, C.CHI3_FRAME, rots[:, :, 3])
    chi4 = chain(chi3, C.CHI4_FRAME, rots[:, :, 4])
    Rs = [R_bb, psi[0], chi1[0], chi2[0], chi3[0], chi4[0]]
    ts = [t_bb, psi[1], chi1[1], chi2[1], chi3[1], chi4[1]]
    R_frames, t_frames = torch.stack(Rs, 2), torch.stack(ts, 2)

    # Per-atom frame over the 8-group order [bb, omega, phi, psi, chi1..4].
    R_all = torch.stack([R_bb, R_bb] + Rs, 2)                           # (B, L, 8, 3, 3)
    t_all = torch.stack([t_bb, t_bb] + ts, 2)
    idx = atom_group
    R_atom = torch.gather(R_all, 2, idx[..., None, None].expand(*idx.shape, 3, 3))
    t_atom = torch.gather(t_all, 2, idx[..., None].expand(*idx.shape, 3))
    pos14 = (R_atom @ atom_pos[..., None])[..., 0] + t_atom
    return pos14, R_frames, t_frames


def full_atom_to_pos15(pos14: torch.Tensor) -> torch.Tensor:
    """Pad atom14 positions to the 15-slot layout (OXT slot zero)."""
    return torch.cat([pos14, torch.zeros_like(pos14[..., :1, :])], -2)


def bb3_atoms(trans: torch.Tensor, rotmats: torch.Tensor) -> torch.Tensor:
    """N/CA/C global positions of idealized ALA backbones: (B, L, 3, 3),
    R · ideal + t over the backbone group's ideal coordinates (the
    reference's ``to_atom37(trans, rots)[:, :, :3]``)."""
    ideal = torch.from_numpy(C.BB3_IDEAL_COORDS).to(device=rotmats.device, dtype=rotmats.dtype)
    return torch.einsum("blij,aj->blai", rotmats, ideal) + trans[:, :, None, :]
