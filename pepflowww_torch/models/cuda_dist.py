"""EdgeEmbedder distance block: the CUDA kernels' wrappers, their plain
PyTorch versions and the autograd Function that joins them (counterpart of
the JAX package's ``models/pallas_dist.py``).

Inputs: heavy-atom positions in nm ``pos_nm`` (B, L, 15, 3), their mask
(B, L, 15), residue tokens ``aa`` (B, L) (after the sequence mask; the
coefficient row of pair (i, j) is aa_i * 22 + aa_j) and the node-level
structure mask ``smask`` (B, L), whose outer product masks the output.
``p`` holds table (484, 225), k1 (225, F), b1, k2 (F, F), b2 ([in, out]).
Returns (B, L, L, F) in `dtype`.

The backward (:func:`distance_embed_bwd`) returns the parameter gradients
only (table, k1, b1, k2, b2): positions, masks and tokens are data.
:class:`DistanceEmbedFn` runs the forward and that backward under autograd;
the bare forward wrapper has no autograd and raises when asked to record one.

A tensor on the CPU takes the plain version; a CUDA tensor takes the kernel
or raises. Both kernels share one tile (csrc/distance_tile.cuh): blocks walk
chunks of the live residues (s_i != 0) in a stable order by token, each run
of equal aa_i with its 22 coefficient rows in shared memory, and every
product on wgmma.
The forward (csrc/distance_embed.cu) is one launch a call. The backward
(csrc/distance_embed_bwd.cu) is two: the main kernel leaves a table partial
per block and run of equal aa_i (:func:`bwd_schedule` sizes them) and a
weight partial per block, and a second kernel sums them in a fixed order.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from pepflowww_torch import native

A, AA2, KP, NF, NAA = 15, 225, 240, 64, 22
PARAM_NAMES = ("table", "k1", "b1", "k2", "b2")
# distance_embed_forward: 10 pointers, B, L, stream.
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
# distance_embed_backward: 18 pointers, B, L, grid, stream.
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
BWD_PART = AA2 * NF + NF * NF + 2 * NF   # a block's weight partial: dK1 | dK2 | db1 | db2


def bwd_schedule(B: int, L: int, sms: int):
    """(grid, table partial slots) of the backward kernel on a card with
    `sms` SMs: one block an SM, at most one a residue; block z's run of
    token k leaves its table partial in slot z + k, so grid + 21 slots."""
    grid = min(sms, B * L)
    return grid, grid + NAA - 1


def distance_embed_plain(pos_nm, mask_atoms, aa, smask, p: dict, dtype=torch.bfloat16,
                         rows: slice = slice(None)):
    """d² over the 15×15 heavy atoms in fp32, gaussian with coefficients
    softplus(table[aa_i·22+aa_j]), atom-pair mask, then the 225→F→F ReLU
    MLP with `dtype` operands and fp32 accumulation, then the pair mask.
    With `rows`, the query rows i of that slice against every j (pair-row
    TP's part, ``parallel/tp.py``): (B, rows, L, F)."""
    B, L = aa.shape
    pos = pos_nm.float()
    pos_i = pos[:, rows]
    Li = pos_i.shape[1]
    d2 = ((pos_i[:, :, None, :, None] - pos[:, None, :, None, :]) ** 2).sum(-1)
    d2 = d2.reshape(B, Li, L, AA2)
    aa = aa.long()
    c = F.softplus(p["table"].float()[aa[:, rows, None] * NAA + aa[:, None, :]])
    m = mask_atoms.float()
    mp = (m[:, rows, None, :, None] * m[:, None, :, None, :]).reshape(B, Li, L, AA2)
    x = (torch.exp(-c * d2) * mp).to(dtype).float()
    h = torch.relu(x @ p["k1"].to(dtype).float() + p["b1"].float())
    o = torch.relu(h.to(dtype).float() @ p["k2"].to(dtype).float() + p["b2"].float())
    s = smask.float()
    return (o * (s[:, rows, None] * s[:, None, :])[..., None]).to(dtype)


def kernel_operands(p: dict) -> dict:
    """The weights as the kernel takes them: fp32 table and biases, bf16
    k1 zero-padded from 225 to 240 rows, bf16 k2."""
    k1 = torch.zeros(KP, NF, dtype=torch.bfloat16, device=p["k1"].device)
    k1[:AA2] = p["k1"].to(torch.bfloat16)
    return {"table": p["table"].float().contiguous(), "k1": k1,
            "b1": p["b1"].float().contiguous(), "k2": p["k2"].to(torch.bfloat16).contiguous(),
            "b2": p["b2"].float().contiguous()}


def fused_distance_embed(pos_nm, mask_atoms, aa, smask, p: dict, dtype=torch.bfloat16,
                         ops: Optional[dict] = None):
    """Distance block forward, without autograd: it raises if grad mode is
    on and a parameter requires grad (use :class:`DistanceEmbedFn` to
    train). CPU tensors run :func:`distance_embed_plain`; CUDA tensors run
    the bf16 kernel (F = 64 only) or raise. ``ops`` may carry
    :func:`kernel_operands` made once."""
    native.refuse_autograd("fused_distance_embed", [pos_nm, *p.values()])
    return _forward(pos_nm, mask_atoms, aa, smask, p, dtype, ops)


def _forward(pos_nm, mask_atoms, aa, smask, p, dtype, ops=None):
    if pos_nm.device.type == "cpu":
        return distance_embed_plain(pos_nm, mask_atoms, aa, smask, p, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the distance kernel computes in bfloat16, not {dtype}")
    if ops is None:
        ops = kernel_operands(p)
    B, L = aa.shape
    f32 = torch.float32
    pos = pos_nm.to(f32).contiguous()
    amask = mask_atoms.to(f32).contiguous()
    aa32 = aa.to(torch.int32).contiguous()
    sm = smask.to(f32).contiguous()
    native.check_tensor(pos, "pos_nm", (B, L, A, 3), f32)
    native.check_tensor(amask, "mask_atoms", (B, L, A), f32)
    native.check_tensor(aa32, "aa", (B, L), torch.int32)
    native.check_tensor(sm, "smask", (B, L), f32)
    native.check_tensor(ops["table"], "table", (NAA * NAA, AA2), f32)
    native.check_tensor(ops["k1"], "k1", (KP, NF), torch.bfloat16)
    native.check_tensor(ops["k2"], "k2", (NF, NF), torch.bfloat16)
    native.check_tensor(ops["b1"], "b1", (NF,), f32)
    native.check_tensor(ops["b2"], "b2", (NF,), f32)
    out = torch.empty(B, L, L, NF, dtype=torch.bfloat16, device=pos.device)
    fn = native.function("distance_embed", "distance_embed_forward", _ARGTYPES)
    ins = [pos, amask, aa32, sm] + [ops[k] for k in ("table", "k1", "b1", "k2", "b2")] + [out]
    rc = fn(*[t.data_ptr() for t in ins], B, L, torch.cuda.current_stream(pos.device).cuda_stream)
    native.check(rc, "distance_embed")
    native.count_launch("distance_embed")
    return out


# ---------------------------------------------------------------- backward
def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.to(dtype).float()


def distance_embed_bwd_plain(pos_nm, mask_atoms, aa, smask, p: dict, g, dtype=torch.bfloat16):
    """The backward kernel's arithmetic in plain PyTorch: the forward of
    :func:`distance_embed_plain` recomputed, then da2, da1 rounded to
    `dtype` before their products, float32 sums, and
    dcoef = dx · mask · e · (−d²) · sigmoid(coef) in float32 summed into the
    coefficient rows. Returns {name: float32 grad} for table, k1, b1, k2, b2."""
    B, L = aa.shape
    pos = pos_nm.float()
    d2 = ((pos[:, :, None, :, None] - pos[:, None, :, None, :]) ** 2).sum(-1).reshape(B, L, L, AA2)
    aa = aa.long()
    idx = aa[:, :, None] * NAA + aa[:, None, :]
    coef = p["table"].float()[idx]
    e = torch.exp(-F.softplus(coef) * d2)
    m = mask_atoms.float()
    mp = (m[:, :, None, :, None] * m[:, None, :, None, :]).reshape(B, L, L, AA2)
    x = _round(e * mp, dtype)
    k1, k2 = _round(p["k1"], dtype), _round(p["k2"], dtype)
    a1 = x @ k1 + p["b1"].float()
    hc = _round(torch.relu(a1), dtype)
    a2 = hc @ k2 + p["b2"].float()
    s = smask.float()
    do = g.float() * (s[:, :, None] * s[:, None, :])[..., None]
    da2 = do * (a2 > 0)
    da2c = _round(da2, dtype)
    da1 = (da2c @ k2.t()) * (a1 > 0)
    da1c = _round(da1, dtype)
    dx = da1c @ k1.t()
    dcoef = dx * mp * e * (-d2) * torch.sigmoid(coef)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    d_table = torch.zeros(NAA * NAA, AA2, dtype=torch.float32, device=pos.device)
    d_table.index_add_(0, idx.reshape(-1), flat(dcoef))
    return {"table": d_table, "k1": flat(x).t() @ flat(da1c), "b1": flat(da1).sum(0),
            "k2": flat(hc).t() @ flat(da2c), "b2": flat(da2).sum(0)}


def distance_embed_bwd(pos_nm, mask_atoms, aa, smask, p: dict, g, dtype=torch.bfloat16,
                       ops: Optional[dict] = None):
    """Parameter gradients of the distance block for the cotangent `g` of
    its output: {table, k1, b1, k2, b2}, float32. CPU tensors run
    :func:`distance_embed_bwd_plain`; CUDA tensors run the bf16 backward
    kernel or raise. Two calls on the same inputs give bit-identical
    results (partials added in a fixed order, no atomics)."""
    if pos_nm.device.type == "cpu":
        return distance_embed_bwd_plain(pos_nm, mask_atoms, aa, smask, p, g, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the distance backward kernel computes in bfloat16, not {dtype}")
    if ops is None:
        ops = kernel_operands(p)
    B, L = aa.shape
    f32, bf = torch.float32, torch.bfloat16
    dev = pos_nm.device
    pos = pos_nm.to(f32).contiguous()
    amask = mask_atoms.to(f32).contiguous()
    aa32 = aa.to(torch.int32).contiguous()
    sm = smask.to(f32).contiguous()
    gg = g.to(bf).contiguous()
    native.check_tensor(pos, "pos_nm", (B, L, A, 3), f32)
    native.check_tensor(amask, "mask_atoms", (B, L, A), f32)
    native.check_tensor(aa32, "aa", (B, L), torch.int32)
    native.check_tensor(sm, "smask", (B, L), f32)
    native.check_tensor(gg, "g", (B, L, L, NF), bf)
    native.check_tensor(ops["table"], "table", (NAA * NAA, AA2), f32)
    native.check_tensor(ops["k1"], "k1", (KP, NF), bf)
    native.check_tensor(ops["k2"], "k2", (NF, NF), bf)
    native.check_tensor(ops["b1"], "b1", (NF,), f32)
    native.check_tensor(ops["b2"], "b2", (NF,), f32)
    grid, slots = bwd_schedule(B, L, native.sm_count(dev))
    empty = lambda *s: torch.empty(*s, dtype=f32, device=dev)
    scratch = [empty(slots, NAA, AA2), empty(grid, BWD_PART),
               torch.empty(NAA + 1, dtype=torch.int32, device=dev)]
    grads = {"table": empty(NAA * NAA, AA2), "k1": empty(AA2, NF), "b1": empty(NF),
             "k2": empty(NF, NF), "b2": empty(NF)}
    fn = native.function("distance_embed_bwd", "distance_embed_backward", _BWD_ARGTYPES)
    ins = [pos, amask, aa32, sm, gg] + [ops[k] for k in PARAM_NAMES]
    outs = scratch + [grads[k] for k in PARAM_NAMES]
    rc = fn(*[t.data_ptr() for t in ins + outs], B, L, grid,
            torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "distance_embed_bwd")
    native.count_launch("distance_embed_bwd")
    return grads


class DistanceEmbedFn(torch.autograd.Function):
    """The distance block under autograd, the counterpart of
    ``fused_distance_embed_vjp``: the forward runs the forward kernel and
    saves only its inputs; the backward runs the backward kernel and returns
    gradients for the parameters only (positions, masks and tokens are
    data). On the CPU both directions take their plain versions.

    apply(pos_nm, mask_atoms, aa, smask, table, k1, b1, k2, b2, dtype, ops)"""

    @staticmethod
    def forward(ctx, pos_nm, mask_atoms, aa, smask, *rest):
        params, (dtype, ops) = rest[:5], rest[5:]
        ctx.save_for_backward(pos_nm, mask_atoms, aa, smask, *params)
        ctx.dtype, ctx.ops = dtype, ops
        return _forward(pos_nm, mask_atoms, aa, smask, dict(zip(PARAM_NAMES, params)), dtype, ops)

    @staticmethod
    def backward(ctx, g):
        pos_nm, mask_atoms, aa, smask, *params = ctx.saved_tensors
        grads = distance_embed_bwd(pos_nm, mask_atoms, aa, smask, dict(zip(PARAM_NAMES, params)),
                                   g, ctx.dtype, ops=ctx.ops)
        return (None, None, None, None,
                *(grads[k].to(prm.dtype) for k, prm in zip(PARAM_NAMES, params)), None, None)
