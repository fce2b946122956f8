"""Per-residue and pair featurizers (counterpart of the JAX package's
``models/embed.py``), with the reference's leakage masks: the
to-be-generated region's sequence becomes UNK and its structure-derived
features are zeroed."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pepflowww_torch import constants as C
from pepflowww_torch.models import cuda_dist
from pepflowww_torch.models.layers import AngularEncoding, cached_operands, mlp
from pepflowww_torch.ops import frames
from pepflowww_torch.ops.dihedrals import get_backbone_dihedral_angles, pairwise_dihedrals
from pepflowww_torch.parallel import tp


def _unk_where_masked(aa, sequence_mask):
    if sequence_mask is None:
        return aa
    return torch.where(sequence_mask.bool(), aa, torch.full_like(aa, int(C.AA.UNK)))


class NodeEmbedder(nn.Module):
    """Per-residue features -> (B, L, feat_dim)."""

    def __init__(self, feat_dim: int, dtype: Optional[torch.dtype] = None,
                 max_num_atoms: int = C.MAX_NUM_HEAVYATOMS, max_aa_types: int = C.MAX_AA_TYPES):
        super().__init__()
        self.max_num_atoms, self.max_aa_types = max_num_atoms, max_aa_types
        self.aatype_embed = nn.Embedding(max_aa_types, feat_dim)
        self.dihed_embed = AngularEncoding()
        in_dim = feat_dim + max_aa_types * max_num_atoms * 3 + self.dihed_embed.get_out_dim(3)
        self.mlp = mlp((feat_dim * 2, feat_dim, feat_dim, feat_dim), in_dim, dtype=dtype)

    def forward(self, aa, res_nb, chain_nb, pos_atoms, mask_atoms,
                structure_mask=None, sequence_mask=None):
        N, L = aa.shape
        A = self.max_num_atoms
        pos_atoms, mask_atoms = pos_atoms[:, :, :A], mask_atoms[:, :, :A].bool()
        mask_residue = mask_atoms[:, :, C.BBHeavyAtom.CA]
        aa_feat = self.aatype_embed(_unk_where_masked(aa, sequence_mask).long())

        # Local backbone-frame coordinates of all atoms, scattered 22 ways by
        # residue type as a one-hot outer product.
        R = frames.construct_3d_basis(pos_atoms[:, :, C.BBHeavyAtom.CA],
                                      pos_atoms[:, :, C.BBHeavyAtom.C],
                                      pos_atoms[:, :, C.BBHeavyAtom.N])
        crd = frames.global_to_local(R, pos_atoms[:, :, C.BBHeavyAtom.CA], pos_atoms)
        crd = torch.where(mask_atoms[..., None], crd, torch.zeros_like(crd))
        onehot = F.one_hot(_unk_where_masked(aa, sequence_mask).long(), self.max_aa_types).to(crd.dtype)
        crd_feat = (onehot[..., None] * crd.reshape(N, L, 1, A * 3)).reshape(N, L, -1)
        if structure_mask is not None:
            crd_feat = crd_feat * structure_mask[:, :, None].to(crd_feat.dtype)

        bb_dihedral, mask_bb_dihed = get_backbone_dihedral_angles(
            pos_atoms, chain_nb=chain_nb, res_nb=res_nb, mask=mask_residue)
        dihed_feat = self.dihed_embed(bb_dihedral[..., None]) * mask_bb_dihed[..., None]
        dihed_feat = dihed_feat.reshape(N, L, -1)
        if structure_mask is not None:
            # No leakage through the dihedrals of anchor residues.
            sm = structure_mask.bool()
            dihed_mask = sm & torch.roll(sm, 1, 1) & torch.roll(sm, -1, 1)
            dihed_feat = dihed_feat * dihed_mask[:, :, None]

        out = self.mlp(torch.cat([aa_feat, crd_feat, dihed_feat], -1)).float()
        return out * mask_residue[:, :, None]


class EdgeEmbedder(nn.Module):
    """Pair features -> (B, L, L, feat_dim). With ``use_kernels`` the
    distance block runs :class:`cuda_dist.DistanceEmbedFn` (forward and
    backward kernels under autograd)."""

    def __init__(self, feat_dim: int, dtype: Optional[torch.dtype] = None,
                 use_kernels: bool = False, max_num_atoms: int = C.MAX_NUM_HEAVYATOMS,
                 max_aa_types: int = C.MAX_AA_TYPES, max_relpos: int = 32):
        super().__init__()
        self.max_num_atoms, self.max_aa_types, self.max_relpos = max_num_atoms, max_aa_types, max_relpos
        self.dtype, self.use_kernels = dtype, use_kernels
        A2 = max_num_atoms * max_num_atoms
        self.aa_pair_embed = nn.Embedding(max_aa_types ** 2, feat_dim)
        self.relpos_embed = nn.Embedding(2 * max_relpos + 1, feat_dim)
        self.aapair_to_distcoef = nn.Embedding(max_aa_types ** 2, A2)
        self.distance_embed = mlp((feat_dim, feat_dim), A2, final_activation=True)
        self.dihedral_embed = AngularEncoding()
        in_dim = feat_dim * 3 + self.dihedral_embed.get_out_dim(2)
        self.out_mlp = mlp((feat_dim, feat_dim, feat_dim), in_dim, dtype=dtype)

    def distance_params(self) -> dict:
        lin0, lin1 = self.distance_embed[0], self.distance_embed[2]
        return {"table": self.aapair_to_distcoef.weight, "k1": lin0.weight.t(),
                "b1": lin0.bias, "k2": lin1.weight.t(), "b2": lin1.bias}

    def forward(self, aa, res_nb, chain_nb, pos_atoms, mask_atoms,
                structure_mask=None, sequence_mask=None):
        """Under pair-row TP (``parallel/tp.py``) only this rank's query
        rows i of every pair feature, against all j: (B, rows, L, feat)."""
        shard = tp.current(kernels=self.use_kernels)
        rows = slice(None) if shard is None else shard.rows
        N, L = aa.shape
        A = self.max_num_atoms
        pos_atoms, mask_atoms = pos_atoms[:, :, :A], mask_atoms[:, :, :A]
        mask_residue = mask_atoms[:, :, C.BBHeavyAtom.CA].float()
        mask_pair = mask_residue[:, rows, None] * mask_residue[:, None, :]
        smask = (structure_mask.float() if structure_mask is not None
                 else torch.ones_like(mask_residue))
        pair_smask = smask[:, rows, None] * smask[:, None, :]

        aa = _unk_where_masked(aa, sequence_mask).long()
        feat_aapair = self.aa_pair_embed(aa[:, rows, None] * self.max_aa_types + aa[:, None, :])

        same_chain = (chain_nb[:, rows, None] == chain_nb[:, None, :])
        relpos = torch.clamp(res_nb[:, rows, None] - res_nb[:, None, :],
                             -self.max_relpos, self.max_relpos).long()
        table = self.relpos_embed.weight
        if self.dtype is not None:
            # The compute-dtype lookup reads the table rounded to that dtype.
            table = table.to(self.dtype).float()
        feat_relpos = table[relpos + self.max_relpos] * same_chain[..., None]

        p = self.distance_params()
        dt = self.dtype or torch.float32
        pos_nm = pos_atoms * C.ANG_TO_NM_SCALE
        if self.use_kernels:
            ops = None
            if pos_nm.device.type == "cuda":
                ops = cached_operands(self, list(p.values()), lambda: cuda_dist.kernel_operands(p))
            feat_dist = cuda_dist.DistanceEmbedFn.apply(pos_nm, mask_atoms, aa, smask,
                                                        *p.values(), dt, ops)
        else:
            feat_dist = cuda_dist.distance_embed_plain(pos_nm, mask_atoms, aa, smask, p, dtype=dt,
                                                       rows=rows)
        feat_dist = feat_dist.float()

        feat_dihed = self.dihedral_embed(pairwise_dihedrals(pos_atoms, rows))
        if structure_mask is not None:
            feat_dihed = feat_dihed * pair_smask[..., None]

        feat_all = torch.cat([feat_aapair, feat_relpos, feat_dist, feat_dihed], -1)
        feat_all = self.out_mlp(feat_all).float()
        return feat_all * mask_pair[..., None]
