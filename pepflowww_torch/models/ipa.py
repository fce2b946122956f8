"""Trunk blocks (counterpart of the JAX package's ``models/ipa.py``):
Invariant Point Attention, the EdgeTransition (with kernel B), the node
transition, the 6-D backbone update and the post-LN sequence transformer.

With a compute dtype (bf16, the production profile) the large matmuls take
bf16 operands. Where the JAX package asks for a float32 result of bf16
operands (``preferred_element_type=float32``), the operands are rounded to
bf16 and multiplied in float32, which is exact per product; frame geometry,
the point terms, softmax and LayerNorm statistics stay float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from pepflowww_torch.models import cuda_edge, cuda_ipa
from pepflowww_torch.models.layers import Linear, cached_operands
from pepflowww_torch.parallel import tp


def _rnd(x: torch.Tensor, dt) -> torch.Tensor:
    """float32 view of `x` rounded to the compute dtype (no-op for fp32)."""
    return x.float() if dt is None else x.to(dt).float()


class InvariantPointAttention(nn.Module):
    """AF2 Algorithm 22 with pair bias, softplus head weights and the c_z/4
    pair readout. R (B, L, 3, 3), t (B, L, 3), mask (B, L).

    With ``use_kernels`` the interior between the input projections and
    ``linear_out`` runs as one fused function (:mod:`cuda_ipa`: the K7
    kernel forward, K8 backward under autograd), which masks key columns
    only: its padded query rows differ from the plain branch's, and the
    trunk masks them."""

    def __init__(self, c_s, c_z, c_hidden, no_heads, no_qk_points, no_v_points,
                 dtype=None, inf: float = 1e5, eps: float = 1e-8, use_kernels: bool = False):
        super().__init__()
        H, C, Pq, Pv = no_heads, c_hidden, no_qk_points, no_v_points
        self.H, self.C, self.Pq, self.Pv = H, C, Pq, Pv
        self.dz4, self.dtype, self.inf, self.eps = c_z // 4, dtype, inf, eps
        self.use_kernels = use_kernels
        self.linear_q = Linear(c_s, H * C, dtype=dtype)
        self.linear_kv = Linear(c_s, 2 * H * C, dtype=dtype)
        self.linear_q_points = Linear(c_s, H * Pq * 3, dtype=dtype)
        self.linear_kv_points = Linear(c_s, H * (Pq + Pv) * 3, dtype=dtype)
        self.linear_b = Linear(c_z, H, dtype=dtype)
        self.down_z = Linear(c_z, self.dz4, dtype=dtype)
        self.linear_out = Linear(H * (C + 4 * Pv + self.dz4), c_s, init="final")
        self.head_weights = nn.Parameter(torch.full((H,), 0.541324854612918))  # softplus⁻¹(1)

    def readout_params(self):
        """(kb, bb, kdz, bdz) in [in, out] layout: this block's pair readouts,
        which the previous block's EdgeTransition kernel computes."""
        return (self.linear_b.weight.t(), self.linear_b.bias,
                self.down_z.weight.t(), self.down_z.bias)

    def forward(self, s, z, R, t, mask, readouts=None):
        """readouts: optional (b (B, H, L, L), pair_z (B, c_z/4, L, L)) from
        the previous EdgeTransition; when given, z is not read.

        Under pair-row TP (``parallel/tp.py``) z holds this rank's query
        rows (B, rows, L, c_z): the queries and their points come from those
        rows of s, R and t, the keys from all L, and the update of those
        rows comes out (B, rows, c_s)."""
        shard = tp.current(kernels=self.use_kernels)
        if self.use_kernels:
            return self._fused(s, z, R, t, mask, readouts)
        rows = slice(None)
        if shard is not None:
            s, R, t, rows = tp.copy_in(s), tp.copy_in(R), tp.copy_in(t), shard.rows
        H, C, Pq, Pv, dt = self.H, self.C, self.Pq, self.Pv, self.dtype
        B, L, _ = s.shape
        s_q, R_q, t_q = s[:, rows], R[:, rows], t[:, rows]
        Lq = s_q.shape[1]
        q = _rnd(self.linear_q(s_q), dt).reshape(B, Lq, H, C)
        kv = _rnd(self.linear_kv(s), dt).reshape(B, L, H, 2 * C)
        k, v = kv[..., :C], kv[..., C:]

        def to_global(flat, n, R, t):
            # [x | y | z] blocks of H*n lanes -> global points (B, l, H, n, 3)
            l = flat.shape[1]
            p = flat.float().reshape(B, l, 3, H * n).transpose(-1, -2)
            g = p @ R.transpose(-1, -2) + t[:, :, None, :]
            return g.reshape(B, l, H, n, 3)

        q_pts = to_global(self.linear_q_points(s_q), Pq, R_q, t_q)
        kv_pts = to_global(self.linear_kv_points(s), Pq + Pv, R, t)
        k_pts, v_pts = kv_pts[..., :Pq, :], kv_pts[..., Pq:, :]

        if readouts is not None:
            b_t, pz_t = readouts
            pair_z = None
        else:
            b_t = self.linear_b(z).permute(0, 3, 1, 2)
            pair_z = self.down_z(z)

        head_w = F.softplus(self.head_weights) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
        a = torch.einsum("bihc,bjhc->bhij", q, k) * math.sqrt(1.0 / (3 * C))
        a = a + math.sqrt(1.0 / 3) * b_t.float()
        # -w/2 * sum_p |q_ip - k_jp|^2 through the square expansion, in fp32.
        q3 = q_pts.reshape(B, Lq, H, Pq * 3)
        k3 = k_pts.reshape(B, L, H, Pq * 3)
        pt = (q3.square().sum(-1).transpose(1, 2)[:, :, :, None]
              + k3.square().sum(-1).transpose(1, 2)[:, :, None, :]
              - 2.0 * torch.einsum("bihx,bjhx->bhij", q3, k3))
        a = a + pt * head_w[None, :, None, None] * (-0.5)
        m = mask.float()
        a = a + (self.inf * (m[:, rows, None] * m[:, None, :] - 1.0))[:, None]
        a = torch.softmax(a, -1)

        a_c = _rnd(a, dt)
        o = torch.einsum("bhij,bjhc->bihc", a_c, v).reshape(B, Lq, H * C)
        o_pt = torch.einsum("bhij,bjhpd->bihpd", a, v_pts)
        local = (o_pt - t_q[:, :, None, None, :]) @ R_q[:, :, None]        # Rᵀ (o - t)
        o_norm = torch.sqrt(local.square().sum(-1) + self.eps)
        if pair_z is None:
            o_pair = torch.einsum("bhij,bdij->bihd", a_c, pz_t.float())
        else:
            o_pair = torch.einsum("bhij,bijd->bihd", a_c, pair_z.float())
        # Reference concat order: o | o_pt x | y | z | norms | pair.
        o_feats = torch.cat([o, local[..., 0].reshape(B, Lq, -1),
                             local[..., 1].reshape(B, Lq, -1), local[..., 2].reshape(B, Lq, -1),
                             o_norm.reshape(B, Lq, -1), o_pair.reshape(B, Lq, -1)], -1)
        if dt is None:
            return F.linear(o_feats, self.linear_out.weight, self.linear_out.bias)
        y = _rnd(o_feats, dt) @ _rnd(self.linear_out.weight, dt).t() + self.linear_out.bias
        return y.to(dt)

    def _fused(self, s, z, R, t, mask, readouts):
        """The interior through :mod:`cuda_ipa` in the JAX package's layouts,
        passed as views of the projections (no transposes): the points as
        (B, H, 3, L, P) coordinate planes, the pair bias head-major, the
        pair readout (B, L, L, c_z/4) (the EdgeTransition epilogue's
        transposed (B, c_z/4, L, L) seen through a permute)."""
        H, Pq, Pv, dt = self.H, self.Pq, self.Pv, self.dtype
        B, L, _ = s.shape
        qp = self.linear_q_points(s).reshape(B, L, 3, H, Pq).permute(0, 3, 2, 1, 4)
        kvp = self.linear_kv_points(s).reshape(B, L, 3, H, Pq + Pv).permute(0, 3, 2, 1, 4)
        if readouts is not None:
            bias, pz_t = readouts
            pz = pz_t.permute(0, 2, 3, 1)
        else:
            bias = self.linear_b(z).permute(0, 3, 1, 2)
            pz = self.down_z(z)
        head_w = F.softplus(self.head_weights) * math.sqrt(1.0 / (3 * (Pq * 9.0 / 2)))
        args = (self.linear_q(s), self.linear_kv(s), qp, kvp, R.float().reshape(B, L, 9),
                t.float(), bias, pz, (self.inf * (mask.float() - 1.0))[:, None, :],
                torch.sqrt(head_w).reshape(1, H))
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            o, optl, norm, opair = cuda_ipa.IPA2Fn.apply(*args, self.eps)
        else:
            o, optl, norm, opair = cuda_ipa.fused_ipa2(*args, eps=self.eps)
        o_feats = torch.cat([o, optl, norm, opair], -1)
        w, b = self.linear_out.weight, self.linear_out.bias
        if dt is None:
            return F.linear(o_feats, w, b)
        return F.linear(o_feats.to(dt), w.to(dt), b.to(dt))


class EdgeTransition(nn.Module):
    """Pair-feature MLP. Its first layer and residual projection are
    factorized over the [edge | node_i | node_j] concat. With
    ``use_kernels`` it runs :class:`cuda_edge.EdgeTransitionFn` (forward and
    backward kernels under autograd), or, with a readout, the forward-only
    :func:`cuda_edge.fused_edge_transition`; with ``quant_int8`` (which
    needs ``use_kernels``, as in the JAX package) every call, readout or
    not, runs the forward-only int8 serving profile
    :func:`cuda_edge.fused_edge_transition_int8`, which raises under grad
    mode; otherwise :func:`cuda_edge.edge_transition_plain`, which autograd
    follows."""

    def __init__(self, node_embed_size: int, edge_embed_in: int, edge_embed_out: int,
                 dtype=None, use_kernels: bool = False, quant_int8: bool = False,
                 node_dilation: int = 2):
        super().__init__()
        if quant_int8 and not use_kernels:
            raise ValueError("EdgeTransition(quant_int8=True) requires use_kernels=True: the "
                             "int8 pair GEMMs exist only in the fused kernel")
        c_bias = node_embed_size // node_dilation
        hidden = 2 * c_bias + edge_embed_in
        self.dtype, self.use_kernels, self.quant_int8 = dtype, use_kernels, quant_int8
        self.initial_embed = Linear(node_embed_size, c_bias, init="relu", dtype=dtype)
        self.trunk = nn.Sequential(Linear(hidden, hidden, init="relu"), nn.ReLU(),
                                   Linear(hidden, hidden, init="relu"), nn.ReLU())
        self.final_layer = Linear(hidden, edge_embed_out, init="final")
        self.layer_norm = nn.LayerNorm(edge_embed_out, eps=1e-5)

    def params(self) -> dict:
        l1, l2 = self.trunk[0], self.trunk[2]
        return {"k1": l1.weight.t(), "b1": l1.bias, "k2": l2.weight.t(), "b2": l2.bias,
                "k3": self.final_layer.weight.t(), "b3": self.final_layer.bias,
                "ln_scale": self.layer_norm.weight, "ln_bias": self.layer_norm.bias}

    def forward(self, node_embed, edge_embed, node_mask, readout=None):
        """readout: the next IPA block's (kb, bb, kdz, bdz); when given the
        result is (edge_out, (b, pair_z)) with b (B, H, L, L) and pair_z
        (B, c_z/4, L, L)."""
        shard = tp.current(kernels=self.use_kernels)
        rows = slice(None)
        if shard is not None:   # edge_embed holds this rank's query rows (parallel/tp.py)
            node_embed, rows = tp.copy_in(node_embed), shard.rows
        dt = self.dtype or torch.float32
        node_bias = self.initial_embed(node_embed)
        p = self.params()
        if self.use_kernels:
            ops = None
            if edge_embed.device.type == "cuda":
                tensors = list(p.values()) + (list(readout) if readout is not None else [])
                ops = cached_operands(self, tensors, lambda: cuda_edge.kernel_operands(
                    p, readout, quant_int8=self.quant_int8))
            if self.quant_int8:
                fn = cuda_edge.fused_edge_transition_int8
            elif readout is None:
                return cuda_edge.EdgeTransitionFn.apply(edge_embed, node_bias, node_mask,
                                                        *p.values(), dt, ops)
            else:  # the readout epilogue is forward-only; the bare wrapper refuses autograd
                fn = cuda_edge.fused_edge_transition
            res = fn(edge_embed.to(dt).contiguous(), node_bias.to(dt).contiguous(), node_mask, p,
                     dt, readout, ops=ops)
        else:
            res = cuda_edge.edge_transition_plain(edge_embed, node_bias, node_mask, p, dt, readout,
                                                  rows=rows)
        if readout is None:
            return res
        out, b_t, pz_t = res
        return out, (b_t, pz_t)


class StructureModuleTransition(nn.Module):
    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.linear_1 = Linear(c, c, init="relu", dtype=dtype)
        self.linear_2 = Linear(c, c, init="relu", dtype=dtype)
        self.linear_3 = Linear(c, c, init="final", dtype=dtype)
        self.ln = nn.LayerNorm(c, eps=1e-5)

    def forward(self, s):
        s0 = s
        s = torch.relu(self.linear_1(s))
        s = torch.relu(self.linear_2(s))
        s = self.linear_3(s)
        return self.ln((s + s0).float())


class BackboneUpdate(nn.Module):
    """6-D [(1,x,y,z) quaternion | translation] update head, float32."""

    def __init__(self, c_s: int):
        super().__init__()
        self.linear = Linear(c_s, 6, init="final")

    def forward(self, s):
        return self.linear(s.float())


class _SelfAttention(nn.Module):
    """Holds the parameters under nn.MultiheadAttention's names
    (in_proj_weight, in_proj_bias, out_proj)."""

    def __init__(self, d_model: int, dtype=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model, init="torch", dtype=dtype)


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer layer (batch first, ReLU feed-forward), written
    out in plain ops. Padded keys get a -1e9 logit; padded query rows are
    computed like any other row (the stock module's fast path would return
    zeros there)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dtype=None):
        super().__init__()
        self.nhead, self.dtype = nhead, dtype
        self.self_attn = _SelfAttention(d_model, dtype)
        self.linear1 = Linear(d_model, dim_feedforward, init="torch", dtype=dtype)
        self.linear2 = Linear(dim_feedforward, d_model, init="torch", dtype=dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, key_padding_mask=None):
        B, L, D = x.shape
        h, dt = self.nhead, self.dtype
        w, b = self.self_attn.in_proj_weight, self.self_attn.in_proj_bias
        qkv = F.linear(x, w, b) if dt is None else F.linear(x.to(dt), w.to(dt), b.to(dt))
        q, k, v = (u.float().reshape(B, L, h, D // h) for u in qkv.chunk(3, -1))
        logits = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(D // h)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], -1e9)
        attn = _rnd(torch.softmax(logits, -1), dt)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(B, L, D)
        x = self.norm1((x + self.self_attn.out_proj(out)).float())
        ff = self.linear2(torch.relu(self.linear1(x)))
        return self.norm2((x + ff).float())


class TransformerEncoder(nn.Module):
    def __init__(self, d_model: int, nhead: int, num_layers: int, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, nhead, d_model, dtype) for _ in range(num_layers))

    def forward(self, x, key_padding_mask=None):
        for layer in self.layers:
            x = layer(x, key_padding_mask)
        return x
