"""Euler-ODE sampler (counterpart of the JAX package's ``sampling.py``).

One encode, then ``num_steps - 1`` Euler steps and a final prediction at
t=1, each a denoise pass. The step semantics are the reference's:

* context rows re-imposed through ``generate_mask`` on every modality, every
  step;
* the sequence re-sampled from the simplex each step; its torsion-validity
  table zeroes chemically undefined angles;
* rotations integrate with the exponential schedule ``d_t * exp_rate``,
  translations and the simplex linearly against the *initial* noise, torus
  angles along the shortest arc;
* one extra prediction at t=1 is the output.

Randomness comes from one explicit ``torch.Generator`` on the batch's
device; it draws other numbers than JAX's keys, so the two samplers agree in
distribution, not bitwise. With the model's ``use_pallas`` set, every
EdgeTransition also emits the next IPA block's pair readouts (the fused
kernel's epilogue).

The JAX package's ``make_sampler`` closes over these arguments to microbatch
a large batch with ``lax.map``; the port samples the whole batch in one
pass, so callers call :func:`euler_sample` directly. :func:`dp_euler_sample`
is the data-parallel sampler over the ranks of ``parallel/dist.py``, and
with pair-row TP over their model groups (:func:`grid_euler_sample`).
"""

from __future__ import annotations

from typing import Optional

import torch

from pepflowww_torch.models.flow import FlowModel
from pepflowww_torch.ops import allatom, simplex, so3, torus


def _where_rows(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-residue select: `mask` (B, L) against (B, L, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)


@torch.inference_mode()
def euler_sample(model: FlowModel, batch: dict, generator: torch.Generator,
                 num_steps: int = 100, sample_bb: bool = True, sample_ang: bool = True,
                 sample_seq: bool = True, return_traj: bool = False) -> dict:
    """Run the multi-modal Euler ODE on a device batch (tensors on the
    model's device). Returns the final prediction {rotmats, trans, angles,
    seqs, seqs_simplex} with the data {rotmats_1, trans_1, angles_1, seqs_1}
    and, with `return_traj`, the per-step predictions under "traj"."""
    icfg = model.cfg.interpolant
    K, k = icfg.num_classes, icfg.simplex_value
    B, L = batch["aa"].shape
    dev = batch["aa"].device
    gen_mask = batch["generate_mask"].bool()
    res_mask = batch["res_mask"]

    rotmats_1, trans_1, angles_1, seqs_1, node_embed, edge_embed = model.encode(batch)
    seqs_1_simplex = simplex.seq_to_simplex(seqs_1, k, K)

    def softmax_sample(logits):
        return simplex.sample_from(torch.softmax(logits, -1), generator)

    if sample_bb:
        rot_0 = _where_rows(gen_mask, so3.uniform_so3((B, L), generator, dev), rotmats_1)
        trans_0 = torch.randn(B, L, 3, generator=generator, device=dev)
        trans_0_c, _ = FlowModel.zero_center_part(trans_0, gen_mask.float(), res_mask.float())
        trans_0_c = _where_rows(gen_mask, trans_0_c, trans_1)
    else:
        rot_0, trans_0_c = rotmats_1, trans_1
    if sample_ang:
        angles_0 = _where_rows(gen_mask, torus.random_uniform(angles_1.shape, generator, dev),
                               angles_1)
    else:
        angles_0 = angles_1
    if sample_seq:
        seqs_0_simplex = k * torch.randn(B, L, K, generator=generator, device=dev)
        seqs_0 = torch.where(gen_mask, softmax_sample(seqs_0_simplex), seqs_1)
        seqs_0_simplex = _where_rows(gen_mask, seqs_0_simplex, seqs_1_simplex)
    else:
        seqs_0, seqs_0_simplex = seqs_1, seqs_1_simplex

    ts = torch.linspace(1e-2, 1.0, num_steps, dtype=torch.float32).tolist()
    fused_ro = model.cfg.ipa.use_pallas

    def predict_clean(t, rot, tr, ang, seq):
        """x̂₁ with the context re-imposed."""
        pred_rot, pred_tr, pred_ang, pred_logits = model.denoise(
            torch.full((B, 1), t, device=dev), rot, tr, ang, seq, node_embed, edge_embed,
            batch["generate_mask"], res_mask, fused_pair_readout=fused_ro)
        pred_rot = _where_rows(gen_mask, pred_rot, rotmats_1)
        pred_tr = _where_rows(gen_mask, pred_tr, trans_1)
        pred_ang = _where_rows(gen_mask, pred_ang, angles_1)
        pred_seq = torch.where(gen_mask, softmax_sample(pred_logits), seqs_1)
        pred_seq_simplex = simplex.seq_to_simplex(pred_seq, k, K)
        pred_ang = torch.where(allatom.torsions_mask_for(pred_seq) > 0.5, pred_ang,
                               torch.zeros_like(pred_ang))
        if not sample_bb:
            pred_tr, pred_rot = trans_1, rotmats_1
        if not sample_ang:
            pred_ang = angles_1
        if not sample_seq:
            pred_seq, pred_seq_simplex = seqs_1, seqs_1_simplex
        return pred_rot, pred_tr, pred_ang, pred_seq, pred_seq_simplex

    rot, tr, ang, seq, seq_simplex = rot_0, trans_0_c, angles_0, seqs_0, seqs_0_simplex
    traj = []
    for t_1, t_2 in zip(ts[:-1], ts[1:]):
        pred_rot, pred_tr, pred_ang, pred_seq, pred_seq_simplex = predict_clean(
            t_1, rot, tr, ang, seq)
        if return_traj:
            traj.append({"rotmats": pred_rot, "trans": pred_tr, "angles": pred_ang,
                         "seqs": pred_seq, "seqs_simplex": pred_seq_simplex})
        d_t = t_2 - t_1
        tr_2 = _where_rows(gen_mask, tr + (pred_tr - trans_0_c) * d_t, trans_1)
        rot_2 = _where_rows(gen_mask, so3.geodesic_t(d_t * icfg.rots_exp_rate, pred_rot, rot),
                            rotmats_1)
        ang_2 = _where_rows(gen_mask, torus.geodesic_t(d_t, pred_ang, ang), angles_1)
        seq_simplex = seq_simplex + (pred_seq_simplex - seqs_0_simplex) * d_t
        seq_2 = torch.where(gen_mask, softmax_sample(seq_simplex), seqs_1)
        ang_2 = torch.where(allatom.torsions_mask_for(seq_2) > 0.5, ang_2,
                            torch.zeros_like(ang_2))
        if not sample_bb:
            tr_2, rot_2 = trans_1, rotmats_1
        if not sample_ang:
            ang_2 = angles_1
        if not sample_seq:
            seq_2 = seqs_1
        rot, tr, ang, seq = rot_2, tr_2, ang_2, seq_2

    pred_rot, pred_tr, pred_ang, pred_seq, pred_seq_simplex = predict_clean(
        ts[-1], rot, tr, ang, seq)
    out = {"rotmats": pred_rot, "trans": pred_tr, "angles": pred_ang, "seqs": pred_seq,
           "seqs_simplex": pred_seq_simplex, "rotmats_1": rotmats_1, "trans_1": trans_1,
           "angles_1": angles_1, "seqs_1": seqs_1}
    if return_traj:
        out["traj"] = {name: torch.stack([s[name] for s in traj]) for name in traj[0]}
    return out


class _PaddedModel:
    """`model` as :func:`euler_sample` calls it, run at a length `Lp`
    padded from the batch's `L` by masked residues: the batch and the
    denoiser's per-residue inputs go in padded, the model's outputs come
    out cut back to L, so the sampler draws every number at L. The padded
    residues hold their context (the padded batch's own frames, angles and
    tokens), as the generate mask, 0 there, keeps them in a sampler run at
    Lp. The node and edge features stay at Lp, between the two calls."""

    def __init__(self, model: FlowModel, Lp: int, L: int):
        self.model, self.cfg, self.Lp, self.L = model, model.cfg, Lp, L
        self.context = None

    def encode(self, batch: dict):
        from pepflowww_torch.parallel import tp

        *data, node_embed, edge_embed = self.model.encode(tp.pad_length(batch, self.Lp))
        self.context = [x[:, self.L:] for x in data]
        return (*[x[:, :self.L] for x in data], node_embed, edge_embed)

    def denoise(self, t, rotmats_t, trans_t, angles_t, seqs_t, node_embed, edge_embed,
                generate_mask, res_mask, **kwargs):
        x = [torch.cat([v, c], 1) for v, c in
             zip((rotmats_t, trans_t, angles_t, seqs_t), self.context)]
        masks = [torch.cat([m, m.new_zeros(m.shape[0], self.Lp - self.L)], 1)
                 for m in (generate_mask, res_mask)]
        out = self.model.denoise(t, *x, node_embed, edge_embed, *masks, **kwargs)
        return tuple(v[:, :self.L] for v in out)


def grid_euler_sample(model: FlowModel, batch: dict, generator: torch.Generator,
                      **kwargs) -> dict:
    """:func:`euler_sample` of this rank's rows on the grid's model axis
    (the counterpart of the JAX package's ``make_tp_sampler`` for one data
    rank): the ranks of a model group call it together with the same rows
    and a generator seeded alike, and run the model on their pair rows, L
    padded to a multiple of the model size by masked residues
    (``parallel/tp.py``; the model built by ``tp.plain_profile``). The
    sampler draws at L (:class:`_PaddedModel`), as a single process does.
    Returns every row's outputs on every rank of the group;
    :func:`euler_sample` itself without a model axis."""
    from pepflowww_torch.parallel import tp

    L = int(batch["aa"].shape[1])
    with tp.pair_rows(L) as shard:
        if shard is not None and shard.length != L:
            model = _PaddedModel(model, shard.length, L)
        return euler_sample(model, batch, generator, **kwargs)


def dp_euler_sample(model: FlowModel, batch: dict, generator: torch.Generator,
                    **kwargs) -> Optional[dict]:
    """Data-parallel :func:`euler_sample` over the grid of
    ``parallel/dist.py`` (counterpart of the JAX package's
    ``make_best_dp_sampler`` with its manual sampler, and, on a grid with a
    model axis, of ``make_tp_sampler``): `batch` is the whole device batch
    on every rank; padded to a multiple of the number of data ranks with
    copies of its last row, data rank d samples its contiguous block with
    its own `generator` (``dp.rank_generator(seed, d, device)``, alike on
    the ranks of its model group, which split its pair rows:
    :func:`grid_euler_sample`; a world of one draws what a single process
    draws). Returns the outputs of every row, gathered on the host of rank
    0 in row order with the padding dropped; None on the other ranks."""
    from pepflowww_torch.parallel import dist, dp

    g = dist.grid()
    n = int(batch["aa"].shape[0])
    mine = dp.rank_rows(dp.pad_rows(batch, g.n_data), g.data_rank, g.n_data)
    return dp.gather_rows(grid_euler_sample(model, mine, generator, **kwargs), n)
