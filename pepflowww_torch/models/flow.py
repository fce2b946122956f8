"""FlowModel: multi-modal flow matching over frames, torsions and sequence
(counterpart of the JAX package's ``models/flow.py``).

``encode`` builds the backbone frames and node/edge features of a batch
once; ``denoise`` is one GAEncoder pass predicting the clean sample;
``loss`` is the training objective (``loss_pre`` → ``denoise`` →
``loss_post``). The Euler sampler lives in :mod:`pepflowww_torch.sampling`.

The objective's randomness comes from :func:`draw_noise`, in the JAX
package's order of draws (t, trans_0, rotmats_0, angles_0, seqs_0, the
seqs_t sample, the prediction sample), from an explicit ``torch.Generator``
or handed in whole, so a test can feed the JAX step's own draws. The two
categorical samples are Gumbel-max draws, argmax(log(p + 1e-8) + gumbel),
which is how ``jax.random.categorical`` samples.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn

from pepflowww_torch import constants as C
from pepflowww_torch.device import resolve_device
from pepflowww_torch.models.embed import EdgeEmbedder, NodeEmbedder
from pepflowww_torch.models.ipa import (EdgeTransition, InvariantPointAttention,
                                        TransformerEncoderLayer)
from pepflowww_torch.models.layers import Linear, init_linear
from pepflowww_torch.models.trunk import GAEncoder, IPAConfig
from pepflowww_torch.ops import allatom, simplex, so3, torus
from pepflowww_torch.ops.frames import construct_3d_basis

LOSS_NAMES = ("trans_loss", "rot_loss", "bb_atom_loss", "seqs_loss", "angle_loss",
              "torsion_loss")


@dataclasses.dataclass(frozen=True)
class InterpolantConfig:
    """configs/learn_angle*.yaml ``model.interpolant``."""

    min_t: float = 1e-2
    t_normalization_clip: float = 0.9
    sample_structure: bool = True
    sample_sequence: bool = True
    rots_exp_rate: float = 10.0
    trans_sigma: float = 1.0
    num_classes: int = 20
    simplex_value: float = 5.0
    num_timesteps: int = 100


@dataclasses.dataclass(frozen=True)
class FlowModelConfig:
    node_embed_size: int = 128
    edge_embed_size: int = 64
    ipa: IPAConfig = dataclasses.field(default_factory=IPAConfig)
    interpolant: InterpolantConfig = dataclasses.field(default_factory=InterpolantConfig)


class FlowModel(nn.Module):
    """Parameters carry the reference's torch names (``node_embedder.*``,
    ``edge_embedder.*``, ``ga_encoder.trunk.ipa_N.*``, ...), so a reference
    state dict loads with ``strict=True``."""

    def __init__(self, cfg: FlowModelConfig):
        super().__init__()
        self.cfg = cfg
        cdt = cfg.ipa.compute_dtype
        self.node_embedder = NodeEmbedder(cfg.node_embed_size, dtype=cdt)
        self.edge_embedder = EdgeEmbedder(cfg.edge_embed_size, dtype=cdt,
                                          use_kernels=cfg.ipa.use_pallas)
        self.ga_encoder = GAEncoder(cfg.ipa)

    def encode(self, batch: dict):
        """Frames, translations, torsions and tokens of the data, plus the
        node (B, L, c_s) and edge (B, L, L, c_z) features."""
        icfg = self.cfg.interpolant
        pos = batch["pos_heavyatom"]
        rotmats_1 = construct_3d_basis(pos[:, :, C.BBHeavyAtom.CA], pos[:, :, C.BBHeavyAtom.C],
                                       pos[:, :, C.BBHeavyAtom.N])
        trans_1 = pos[:, :, C.BBHeavyAtom.CA]
        context_mask = batch["mask_heavyatom"][:, :, C.BBHeavyAtom.CA].bool() & ~batch["generate_mask"].bool()
        structure_mask = context_mask if icfg.sample_structure else None
        sequence_mask = context_mask if icfg.sample_sequence else None
        args = (batch["aa"], batch["res_nb"], batch["chain_nb"], pos, batch["mask_heavyatom"])
        node_embed = self.node_embedder(*args, structure_mask=structure_mask,
                                        sequence_mask=sequence_mask)
        edge_embed = self.edge_embedder(*args, structure_mask=structure_mask,
                                        sequence_mask=sequence_mask)
        return rotmats_1, trans_1, batch["torsion_angle"], batch["aa"], node_embed, edge_embed

    def pair_parameters(self) -> list:
        """The parameters of the pair work: the EdgeEmbedder, the IPAs and
        the EdgeTransitions, which take this rank's pair rows under pair-row
        TP (``parallel/tp.py``) and so get this rank's part of their
        gradient; every other parameter works on node tensors alike on each
        rank of a model group and gets the whole gradient there."""
        return [p for m in self.modules()
                if isinstance(m, (EdgeEmbedder, InvariantPointAttention, EdgeTransition))
                for p in m.parameters()]

    def denoise(self, t, rotmats_t, trans_t, angles_t, seqs_t, node_embed, edge_embed,
                generate_mask, res_mask, fused_pair_readout: bool = False):
        """(pred_rotmats, pred_trans, pred_angles in [0, 2π), seq logits)."""
        return self.ga_encoder(t, rotmats_t, trans_t, angles_t, seqs_t, node_embed, edge_embed,
                               generate_mask, res_mask, fused_pair_readout=fused_pair_readout)

    @staticmethod
    def zero_center_part(pos, gen_mask, res_mask):
        """Center positions on the generated region."""
        g = gen_mask[..., None].to(pos.dtype)
        center = (pos * g).sum(1) / (gen_mask.to(pos.dtype).sum(-1, keepdim=True) + 1e-8)
        pos = pos - center[:, None, :]
        return pos * res_mask[..., None].to(pos.dtype), center[:, None, :]

    # ------------------------------------------------------------ objective
    def loss_pre(self, batch: dict, generator=None, noise=None) -> dict:
        """Encode, sample t and corrupt every modality (no gradient through
        the corruption). ``noise`` is :func:`draw_noise`'s dict; without it
        the draws come from `generator`. Returns the denoiser inputs, the
        loss targets and the prediction sample's noise."""
        icfg = self.cfg.interpolant
        k, K = icfg.simplex_value, icfg.num_classes
        B, L = batch["aa"].shape
        gen_mask = batch["generate_mask"].float()
        res_mask = batch["res_mask"].float()
        gm = batch["generate_mask"].bool()
        rotmats_1, trans_1, angles_1, seqs_1, node_embed, edge_embed = self.encode(batch)
        # Data are centered on the peptide at preprocessing: trans_1 is used as is.
        seqs_1_simplex = simplex.seq_to_simplex(seqs_1, k, K)
        if noise is None:
            noise = draw_noise(B, L, generator, batch["aa"].device, K)
        t = noise["t"] * (1 - 2 * icfg.min_t) + icfg.min_t

        with torch.no_grad():
            if icfg.sample_structure:
                trans_0, _ = self.zero_center_part(noise["trans_0"] * icfg.trans_sigma,
                                                   gen_mask, res_mask)
                trans_t = (1 - t[..., None]) * trans_0 + t[..., None] * trans_1
                trans_t = torch.where(gm[..., None], trans_t, trans_1)
                rotmats_t = so3.geodesic_t(t[..., None], rotmats_1, noise["rotmats_0"])
                rotmats_t = torch.where(gm[..., None, None], rotmats_t, rotmats_1)
                angles_t = torus.geodesic_t(t[..., None], angles_1, noise["angles_0"])
                angles_t = torch.where(gm[..., None], angles_t, angles_1)
            else:
                trans_t, rotmats_t, angles_t = trans_1, rotmats_1, angles_1
            if icfg.sample_sequence:
                seqs_t_simplex = (1 - t[..., None]) * (k * noise["seqs_0"]) \
                    + t[..., None] * seqs_1_simplex
                seqs_t_simplex = torch.where(gm[..., None], seqs_t_simplex, seqs_1_simplex)
                seqs_t = gumbel_sample(torch.softmax(seqs_t_simplex, -1), noise["gumbel_seqs_t"])
                seqs_t = torch.where(gm, seqs_t, seqs_1)
            else:
                seqs_t = seqs_1
        return {"t": t, "rotmats_t": rotmats_t, "trans_t_c": trans_t, "angles_t": angles_t,
                "seqs_t": seqs_t, "node_embed": node_embed, "edge_embed": edge_embed,
                "rotmats_1": rotmats_1, "trans_1_c": trans_1, "angles_1": angles_1,
                "seqs_1": seqs_1, "gumbel_pred": noise["gumbel_pred"]}

    def loss_post(self, batch: dict, pre: dict, denoised) -> dict:
        """The six losses from :meth:`loss_pre`'s dict and the denoiser's
        (rotmats, trans, angles, seq logits). Uses no parameters."""
        icfg = self.cfg.interpolant
        gen_mask = batch["generate_mask"].float()
        gm = batch["generate_mask"].bool()
        t, rotmats_t, angles_t = pre["t"], pre["rotmats_t"], pre["angles_t"]
        rotmats_1, trans_1, angles_1, seqs_1 = (pre["rotmats_1"], pre["trans_1_c"],
                                                pre["angles_1"], pre["seqs_1"])
        pred_rotmats, pred_trans, pred_angles, pred_logits = denoised
        with torch.no_grad():
            pred_seqs = gumbel_sample(torch.softmax(pred_logits, -1), pre["gumbel_pred"])
            pred_seqs = torch.where(gm, pred_seqs, seqs_1.clamp(0, 19))

        norm_scale = 1.0 / (1.0 - torch.clamp(t[..., None], max=icfg.t_normalization_clip))
        gen_sum = gen_mask.sum(-1) + 1e-8

        def masked_mean(x, mask, dims, denom):
            return ((x * mask).sum(dims) / denom).mean()

        trans_loss = masked_mean((pred_trans - trans_1).square(), gen_mask[..., None],
                                 (-1, -2), gen_sum)
        gt_rot_vf = so3.calc_rot_vf(rotmats_t, rotmats_1)
        pred_rot_vf = so3.calc_rot_vf(rotmats_t, pred_rotmats)
        rot_loss = masked_mean(((gt_rot_vf - pred_rot_vf) * norm_scale).square(),
                               gen_mask[..., None], (-1, -2), gen_sum)
        gt_bb = allatom.bb3_atoms(trans_1, rotmats_1)
        pred_bb = allatom.bb3_atoms(pred_trans, pred_rotmats)
        bb_atom_loss = masked_mean((gt_bb - pred_bb).square(), gen_mask[..., None, None],
                                   (-1, -2, -3), gen_sum)
        logp = torch.log_softmax(pred_logits, -1)
        ce = -torch.gather(logp, -1, seqs_1.clamp(0, 19).long()[..., None])[..., 0]
        seqs_loss = masked_mean(ce, gen_mask, -1, gen_sum)

        # Angles are masked by the predicted sequence's valid torsions: the
        # residue type is not known while generating.
        angle_mask = allatom.torsions_mask_for(pred_seqs)
        angle_mask = (gm[..., None] & (torch.cat([angle_mask, angle_mask], -1) > 0.5)).float()
        ang_sum = angle_mask.sum((-1, -2)) + 1e-8
        sincos = lambda a: torch.cat([torch.sin(a), torch.cos(a)], -1)
        gt_av = sincos(torus.logmap(angles_t, angles_1))
        pred_av = sincos(torus.logmap(angles_t, pred_angles))
        angle_loss = masked_mean(((gt_av - pred_av) * norm_scale).square(), angle_mask,
                                 (-1, -2), ang_sum)
        torsion_loss = masked_mean((sincos(pred_angles) - sincos(angles_1)).square(), angle_mask,
                                   (-1, -2), ang_sum)
        return dict(zip(LOSS_NAMES, (trans_loss, rot_loss, bb_atom_loss, seqs_loss, angle_loss,
                                     torsion_loss)))

    def loss(self, batch: dict, generator=None, noise=None) -> dict:
        """The training objective: {name: scalar} for the six losses."""
        pre = self.loss_pre(batch, generator, noise)
        denoised = self.denoise(pre["t"], pre["rotmats_t"], pre["trans_t_c"], pre["angles_t"],
                                pre["seqs_t"], pre["node_embed"], pre["edge_embed"],
                                batch["generate_mask"], batch["res_mask"])
        return self.loss_post(batch, pre, denoised)


def draw_noise(B: int, L: int, generator: torch.Generator, device, num_classes: int = 20) -> dict:
    """The objective's random draws, in the JAX package's order: t (B, 1)
    uniform; trans_0 (B, L, 3) standard normal; rotmats_0 (B, L, 3, 3)
    uniform on SO(3); angles_0 (B, L, 5) uniform on [0, 2π); seqs_0
    (B, L, K) standard normal; Gumbel noise (B, L, K) for the seqs_t sample
    and for the prediction sample."""
    g = generator

    def gumbel():
        u = torch.rand(B, L, num_classes, generator=g, device=device)
        return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))

    return {"t": torch.rand(B, 1, generator=g, device=device),
            "trans_0": torch.randn(B, L, 3, generator=g, device=device),
            "rotmats_0": so3.uniform_so3((B, L), g, device),
            "angles_0": torus.random_uniform((B, L, 5), g, device),
            "seqs_0": torch.randn(B, L, num_classes, generator=g, device=device),
            "gumbel_seqs_t": gumbel(), "gumbel_pred": gumbel()}


def gumbel_sample(probs: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Class indices ∝ probs + 1e-8 by Gumbel-max: argmax(log(probs + 1e-8) + gumbel)."""
    return torch.argmax(torch.log(probs + 1e-8) + gumbel, -1)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random initialization with the reference's schemes, drawn from
    `generator`: Linears by their AF2 scheme, embeddings N(0, 1), LayerNorms
    (1, 0), IPA head weights softplus⁻¹(1), attention in-projections
    Xavier-uniform."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Linear):
                init_linear(m, generator)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
            elif isinstance(m, InvariantPointAttention):
                m.head_weights.fill_(0.541324854612918)
            elif isinstance(m, TransformerEncoderLayer):
                w = m.self_attn.in_proj_weight
                bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                w.uniform_(-bound, bound, generator=generator)
                m.self_attn.in_proj_bias.zero_()


def build_model(cfg: FlowModelConfig, device=None, state_dict=None, seed: int = 0) -> FlowModel:
    """A FlowModel in eval mode on `device` (``cuda`` unless the caller names
    another; raises without CUDA). Weights come from `state_dict`
    (reference names, loaded with ``strict=True``) or, without one, from
    :func:`init_weights` seeded with `seed`."""
    from pepflowww_torch.convert import load_state_dict

    dev = resolve_device(device)
    model = FlowModel(cfg)
    if state_dict is None:
        g = torch.Generator().manual_seed(seed)
        init_weights(model, g)
    else:
        load_state_dict(model, state_dict)
    return model.to(dev).eval()
