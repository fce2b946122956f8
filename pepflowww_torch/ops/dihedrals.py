"""Dihedral angles and chain topology flags (counterpart of the JAX package's
``ops/dihedrals.py``)."""

from __future__ import annotations

import torch

from pepflowww_torch.constants import BBHeavyAtom


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def dihedral_from_four_points(p0, p1, p2, p3) -> torch.Tensor:
    """Signed dihedral of four points. The normalizations carry a tiny eps
    so value and gradient stay finite on the degenerate geometry of padded
    rows; NaNs are mapped to 0."""
    v0 = p2 - p1
    v1 = p0 - p1
    v2 = p3 - p2
    u1 = _cross(v0, v1)
    n1 = u1 / torch.sqrt(torch.sum(u1 * u1, -1, keepdim=True) + 1e-20)
    u2 = _cross(v0, v2)
    n2 = u2 / torch.sqrt(torch.sum(u2 * u2, -1, keepdim=True) + 1e-20)
    sgn = torch.sign(torch.sum(_cross(v1, v2) * v0, -1))
    dihed = sgn * torch.arccos(torch.clamp(torch.sum(n1 * n2, -1), -0.999999, 0.999999))
    return torch.nan_to_num(dihed)


def dihedral_from_four_points_raw(p0, p1, p2, p3) -> torch.Tensor:
    """As above without the eps and NaN sanitization: degenerate inputs
    yield NaN, which torsion extraction uses as its validity test."""
    v0 = p2 - p1
    v1 = p0 - p1
    v2 = p3 - p2
    u1 = _cross(v0, v1)
    n1 = u1 / torch.linalg.norm(u1, dim=-1, keepdim=True)
    u2 = _cross(v0, v2)
    n2 = u2 / torch.linalg.norm(u2, dim=-1, keepdim=True)
    sgn = torch.sign(torch.sum(_cross(v1, v2) * v0, -1))
    return sgn * torch.arccos(torch.clamp(torch.sum(n1 * n2, -1), -0.999999, 0.999999))


def get_consecutive_flag(chain_nb, res_nb, mask) -> torch.Tensor:
    """Whether residue i is bonded to residue i+1: (B, L-1)."""
    d_res_nb = torch.abs(res_nb[:, 1:] - res_nb[:, :-1])
    same_chain = chain_nb[:, 1:] == chain_nb[:, :-1]
    return (d_res_nb == 1) & same_chain & mask[:, :-1].bool()


def get_terminus_flag(chain_nb, res_nb, mask):
    """(N_term_flag, C_term_flag), each (B, L)."""
    not_consec = ~get_consecutive_flag(chain_nb, res_nb, mask)
    pad_true = torch.ones_like(not_consec[:, :1])
    return (torch.cat([pad_true, not_consec], 1),
            torch.cat([not_consec, pad_true], 1))


def get_backbone_dihedral_angles(pos_atoms, chain_nb, res_nb, mask):
    """Omega/Phi/Psi angles and their masks, (B, L, 3) each."""
    pos_N = pos_atoms[:, :, BBHeavyAtom.N]
    pos_CA = pos_atoms[:, :, BBHeavyAtom.CA]
    pos_C = pos_atoms[:, :, BBHeavyAtom.C]

    n_term, c_term = get_terminus_flag(chain_nb, res_nb, mask)
    zero_col = torch.zeros_like(pos_N[:, :1, 0])
    omega = torch.cat([zero_col, dihedral_from_four_points(
        pos_CA[:, :-1], pos_C[:, :-1], pos_N[:, 1:], pos_CA[:, 1:])], 1)
    phi = torch.cat([zero_col, dihedral_from_four_points(
        pos_C[:, :-1], pos_N[:, 1:], pos_CA[:, 1:], pos_C[:, 1:])], 1)
    psi = torch.cat([dihedral_from_four_points(
        pos_N[:, :-1], pos_CA[:, :-1], pos_C[:, :-1], pos_N[:, 1:]), zero_col], 1)

    mask_bb_dihed = torch.stack([~n_term, ~n_term, ~c_term], -1)
    bb_dihedral = torch.stack([omega, phi, psi], -1) * mask_bb_dihed
    return bb_dihedral, mask_bb_dihed


def pairwise_dihedrals(pos_atoms, rows: slice = slice(None)) -> torch.Tensor:
    """Inter-residue Phi/Psi angles, (B, L, L, 2):
    phi[i, j] = dihedral(C_i, N_j, CA_j, C_j), psi[i, j] = dihedral(N_i, CA_i, C_i, N_j).
    With `rows`, the rows i of that slice only: (B, rows, L, 2)."""
    pos_N = pos_atoms[:, :, BBHeavyAtom.N]
    pos_CA = pos_atoms[:, :, BBHeavyAtom.CA]
    pos_C = pos_atoms[:, :, BBHeavyAtom.C]
    L = pos_N.shape[1]
    Li = pos_N[:, rows].shape[1]

    def row(x):  # (B, L, 3) -> (B, Li, L, 3), varying over i
        return x[:, rows, None].expand(-1, -1, L, -1)

    def col(x):  # varying over j
        return x[:, None, :].expand(-1, Li, -1, -1)

    ir_phi = dihedral_from_four_points(row(pos_C), col(pos_N), col(pos_CA), col(pos_C))
    ir_psi = dihedral_from_four_points(row(pos_N), row(pos_CA), row(pos_C), col(pos_N))
    return torch.stack([ir_phi, ir_psi], -1)
