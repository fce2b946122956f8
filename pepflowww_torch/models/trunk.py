"""GAEncoder, the denoising trunk (counterpart of the JAX package's
``models/trunk.py``): mixes node features with the current sequence, time
and torsion-angle embeddings, runs ``num_blocks`` of {IPA → LayerNorm →
sequence transformer → zero-init projection → transition → backbone update
→ EdgeTransition}, and reads out frames, torsion angles in [0, 2π) and
sequence logits."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from pepflowww_torch.models.ipa import (BackboneUpdate, EdgeTransition,
                                        InvariantPointAttention, StructureModuleTransition,
                                        TransformerEncoder)
from pepflowww_torch.models.layers import AngularEncoding, Linear, get_time_embedding, mlp
from pepflowww_torch.ops.frames import compose_q_update
from pepflowww_torch.parallel import tp


@dataclasses.dataclass(frozen=True)
class IPAConfig:
    """configs/learn_angle*.yaml ``model.encoder.ipa``. ``dtype`` "bfloat16"
    selects bf16 matmuls (parameters, geometry, softmax and LayerNorm stay
    float32); ``use_pallas`` selects the hand-written CUDA kernels of the
    EdgeTransition and the distance block; ``use_pallas_ipa`` the fused IPA
    interior (K7, K8); ``quant_int8`` (with ``use_pallas``) the int8 serving
    profile, whose EdgeTransitions run the int8 pair GEMMs (K6), forward
    only: a training step with it raises."""

    c_s: int = 128
    c_z: int = 64
    c_hidden: int = 128
    no_heads: int = 8
    no_qk_points: int = 8
    no_v_points: int = 12
    seq_tfmr_num_heads: int = 4
    seq_tfmr_num_layers: int = 2
    num_blocks: int = 6
    dtype: Optional[str] = None
    use_pallas: bool = False
    use_pallas_ipa: bool = False
    quant_int8: bool = False

    def __post_init__(self):
        if self.quant_int8 and not self.use_pallas:
            raise ValueError("IPAConfig(quant_int8=True) requires use_pallas=True: the int8 "
                             "pair GEMMs exist only in the fused EdgeTransition kernel")

    @property
    def compute_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.dtype in ("bfloat16", "bf16") else None


class GAEncoder(nn.Module):
    def __init__(self, cfg: IPAConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.compute_dtype
        self.current_seq_embedder = nn.Embedding(22, cfg.c_s)
        self.angles_embedder = AngularEncoding(num_funcs=12)
        mix_in = 3 * cfg.c_s + self.angles_embedder.get_out_dim(5)
        self.res_feat_mixer = mlp((cfg.c_s, cfg.c_s), mix_in, dtype=dt)
        trunk = {}
        for b in range(cfg.num_blocks):
            trunk[f"ipa_{b}"] = InvariantPointAttention(
                cfg.c_s, cfg.c_z, cfg.c_hidden, cfg.no_heads, cfg.no_qk_points,
                cfg.no_v_points, dtype=dt, use_kernels=cfg.use_pallas_ipa)
            trunk[f"ipa_ln_{b}"] = nn.LayerNorm(cfg.c_s, eps=1e-5)
            trunk[f"seq_tfmr_{b}"] = TransformerEncoder(
                cfg.c_s, cfg.seq_tfmr_num_heads, cfg.seq_tfmr_num_layers, dtype=dt)
            trunk[f"post_tfmr_{b}"] = Linear(cfg.c_s, cfg.c_s, init="final")
            trunk[f"node_transition_{b}"] = StructureModuleTransition(cfg.c_s, dtype=dt)
            trunk[f"bb_update_{b}"] = BackboneUpdate(cfg.c_s)
            if b < cfg.num_blocks - 1:
                trunk[f"edge_transition_{b}"] = EdgeTransition(
                    cfg.c_s, cfg.c_z, cfg.c_z, dtype=dt, use_kernels=cfg.use_pallas,
                    quant_int8=cfg.quant_int8)
        self.trunk = nn.ModuleDict(trunk)
        self.seq_net = mlp((cfg.c_s, cfg.c_s, 20), cfg.c_s)
        self.angle_net = mlp((cfg.c_s, cfg.c_s, 5), cfg.c_s)

    def forward(self, t, rotmats_t, trans_t, angles_t, seqs_t, node_embed, edge_embed,
                generate_mask, res_mask, fused_pair_readout: bool = False):
        """fused_pair_readout: each EdgeTransition also emits the NEXT IPA
        block's linear_b / down_z readouts from its on-chip output tile
        (sampler path; forward only). The composition of :meth:`prologue`,
        :meth:`block` for every b and :meth:`epilogue`."""
        state = self.prologue(t, rotmats_t, trans_t, angles_t, seqs_t, node_embed, edge_embed,
                              res_mask)
        readouts = None
        for b in range(self.cfg.num_blocks):
            state, readouts = self.block(b, state, readouts, fused_pair_readout)
        return self.epilogue(state)

    def prologue(self, t, rotmats_t, trans_t, angles_t, seqs_t, node_embed, edge_embed,
                 res_mask) -> tuple:
        """The features mixed before the blocks: the state (node_embed,
        edge_embed, R, trans, node_mask) that :meth:`block` steps (the JAX
        package's ``parallel/pp.py::trunk_prologue``)."""
        cfg = self.cfg
        B, L = seqs_t.shape
        node_mask = res_mask.float()
        seq_embed = self.current_seq_embedder(seqs_t.long())
        t_embed = get_time_embedding(t[:, 0], cfg.c_s, max_positions=2056)
        t_embed = t_embed[:, None, :].expand(B, L, cfg.c_s)
        ang_embed = self.angles_embedder(angles_t).reshape(B, L, -1)
        node_embed = self.res_feat_mixer(
            torch.cat([node_embed, seq_embed, t_embed, ang_embed], -1)).float()
        node_embed = node_embed * node_mask[..., None]
        return node_embed, edge_embed, rotmats_t.float(), trans_t.float(), node_mask

    def block(self, b: int, state: tuple, readouts=None, fused_pair_readout: bool = False):
        """Block `b` of the trunk on `state`, by its modules' checkpoint names
        (``ipa_{b}`` ... ``edge_transition_{b}``; the last block has no
        EdgeTransition, its pair output being dead). Returns the next state
        and, with `fused_pair_readout`, the next IPA's readouts (else None)."""
        tr = self.trunk
        node_embed, edge_embed, R, trans, node_mask = state
        # Under pair-row TP each rank computes its rows' update; every row's
        # is gathered (parallel/tp.py), and the node work below runs whole.
        ipa_embed = tp.gather_rows(tr[f"ipa_{b}"](node_embed, edge_embed, R, trans, node_mask,
                                                  readouts=readouts))
        node_embed = tr[f"ipa_ln_{b}"](node_embed + ipa_embed * node_mask[..., None])
        seq_out = tr[f"seq_tfmr_{b}"](node_embed, key_padding_mask=node_mask < 0.5)
        node_embed = node_embed + tr[f"post_tfmr_{b}"](seq_out)
        node_embed = tr[f"node_transition_{b}"](node_embed) * node_mask[..., None]
        update = tr[f"bb_update_{b}"](node_embed * node_mask[..., None])
        R, trans = compose_q_update(R, trans, update, update_mask=node_mask)
        readouts = None
        if b < self.cfg.num_blocks - 1:
            et = tr[f"edge_transition_{b}"]
            if fused_pair_readout:
                edge_embed, readouts = et(node_embed, edge_embed, node_mask,
                                          readout=tr[f"ipa_{b + 1}"].readout_params())
            else:
                edge_embed = et(node_embed, edge_embed, node_mask)
        return (node_embed, edge_embed, R, trans, node_mask), readouts

    def epilogue(self, state: tuple):
        """(R, trans, angles in [0, 2π), sequence logits) read out of the
        last block's state (``trunk_epilogue``)."""
        node_embed, _, R, trans, _ = state
        pred_seqs = self.seq_net(node_embed)
        pred_angles = torch.remainder(self.angle_net(node_embed), 2 * math.pi)
        return R, trans, pred_angles, pred_seqs
