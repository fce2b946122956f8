"""IPA attention core (v1) on global-frame points: the CUDA kernel's
wrappers, its plain PyTorch version and the autograd Function (counterpart
of the JAX package's ``models/pallas_ipa.py``).

Every per-head tensor is head-major, as in the JAX package (B batch, H
heads, L length, C channels, Pq / Pv query / value points, CZ4 pair
channels):

    q, k, v        (B, H, L, C)       scalar projections, float32 or bfloat16
    q_pts, k_pts   (B, H, L, 3·Pq)    global query / key points, pre-scaled
                                      by sqrt(head weight)
    v_pts          (B, H, L, 3·Pv)    global value points
    bias           (B, H, L, L)       pair bias (before its 1/sqrt(3) scale)
    pair_z         (B, L, L, CZ4)     down-projected pair features
    mask           (B, L)             0/1 key mask: inf·(mask − 1) is added
                                      to the logits

and returns o (B, H, L, C), o_pt (B, H, L, 3·Pv) and o_pair (B, H, L, CZ4),
all float32. :func:`fused_ipa_attention` and :func:`fused_ipa_attention_bh`
are the JAX package's two grid variants of one function; on the card both
make one launch of csrc/ipa1.cu, which takes the model's widths (C 128,
Pq 8, Pv 12, CZ4 16) and the JAX tests' (C 32, Pq 4, Pv 6, CZ4 8), q, k,
v, bias and pair_z in one dtype (float32 or bfloat16), and raises on
anything else: bf16 at the model's widths runs its tensor-core kernel
(K7's attention core on ``wgmma``), everything else its fp32 kernel. :class:`IPAAttentionFn` runs it under autograd; its backward
recomputes through :func:`ipa_attention_plain`, as the JAX ``_bwd``
differentiates the reference, so on the card the backward is plain PyTorch
ops (there is no TPU backward kernel to port). No model path calls these,
here or in the JAX package.

A tensor on the CPU takes the plain version; a CUDA tensor takes the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pepflowww_torch import native

# (C, 3·Pq, 3·Pv, CZ4) the kernel takes: the model's and the JAX tests' widths.
WIDTHS = ((128, 24, 36, 16), (32, 12, 18, 8))
# ipa1_forward: 12 pointers, B, L, H, C, P3Q, P3V, CZ4, bf16, s1, s2, stream.
_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p]
_HINT = "use IPAAttentionFn, whose backward recomputes through the plain version"


def _scales(C):
    return 1.0 / (3 * C) ** 0.5, 1.0 / 3.0 ** 0.5


def ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf: float = 1e5):
    """``ipa_attention_reference`` in plain PyTorch: float32 logits (bf16
    operands are exact in float32) and softmax; the scalar output from the
    weights rounded to v's dtype, the point and pair outputs from the
    float32 weights. Returns (o, o_pt, o_pair), float32."""
    C = q.shape[-1]
    s1, s2 = _scales(C)
    a = torch.einsum("bhic,bhjc->bhij", q.float(), k.float()) * s1
    a = a + bias.float() * s2
    qp, kp = q_pts.float(), k_pts.float()
    qk = torch.einsum("bhip,bhjp->bhij", qp, kp)
    pt = (qp.square().sum(-1)[..., :, None] + kp.square().sum(-1)[..., None, :] - 2 * qk) * -0.5
    a = a + pt + (inf * (mask.float() - 1.0))[:, None, None, :]
    a = torch.softmax(a, -1)
    o = torch.einsum("bhij,bhjc->bhic", a.to(v.dtype).float(), v.float())
    o_pt = torch.einsum("bhij,bhjp->bhip", a, v_pts.float())
    o_pair = torch.einsum("bhij,bijd->bhid", a, pair_z.float())
    return o, o_pt, o_pair


def fused_ipa_attention(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf: float = 1e5):
    """The attention core, without autograd: it raises if grad mode is on
    and an input requires grad (use :class:`IPAAttentionFn`). CPU tensors
    run :func:`ipa_attention_plain`; CUDA tensors run the kernel or raise."""
    native.refuse_autograd("fused_ipa_attention", [q, k, v, q_pts, k_pts, v_pts, bias, pair_z],
                           hint=_HINT)
    return _forward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf)


def fused_ipa_attention_bh(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf: float = 1e5):
    """The JAX package's batch-grid twin of :func:`fused_ipa_attention`
    (same contract, same function): on the card the same kernel."""
    native.refuse_autograd("fused_ipa_attention_bh",
                           [q, k, v, q_pts, k_pts, v_pts, bias, pair_z], hint=_HINT)
    return _forward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf)


def _forward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf=1e5):
    if q.device.type == "cpu":
        return ipa_attention_plain(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf)
    B, H, L, C = q.shape
    P3Q, P3V, CZ4 = q_pts.shape[-1], v_pts.shape[-1], pair_z.shape[-1]
    if (C, P3Q, P3V, CZ4) not in WIDTHS:
        raise ValueError(f"the IPA v1 kernel takes (C, 3Pq, 3Pv, CZ4) in {WIDTHS}; got "
                         f"{(C, P3Q, P3V, CZ4)}")
    dt, f32 = q.dtype, torch.float32
    if dt not in (f32, torch.bfloat16):
        raise ValueError(f"the IPA v1 kernel takes float32 or bfloat16 inputs, not {dt}")
    for name, t, shape in (("q", q, (B, H, L, C)), ("k", k, (B, H, L, C)), ("v", v, (B, H, L, C)),
                           ("bias", bias, (B, H, L, L)), ("pair_z", pair_z, (B, L, L, CZ4))):
        native.check_tensor(t, name, shape, dt)
    # Points and the key mask are float32 in the kernel (an upcast is exact).
    pts = [x.to(f32).contiguous() for x in (q_pts, k_pts, v_pts)]
    for name, t, w in zip(("q_pts", "k_pts", "v_pts"), pts, (P3Q, P3Q, P3V)):
        native.check_tensor(t, name, (B, H, L, w), f32)
    maskb = (inf * (mask.to(f32) - 1.0)).contiguous()
    native.check_tensor(maskb, "mask", (B, L), f32)
    empty = lambda *s: torch.empty(*s, dtype=f32, device=q.device)
    outs = [empty(B, H, L, C), empty(B, H, L, P3V), empty(B, H, L, CZ4)]
    fn = native.function("ipa1", "ipa1_forward", _ARGTYPES)
    ins = [q, k, v, *pts, bias, pair_z, maskb]
    rc = fn(*[x.data_ptr() for x in ins + outs], B, L, H, C, P3Q, P3V, CZ4,
            int(dt == torch.bfloat16), *_scales(C),
            torch.cuda.current_stream(q.device).cuda_stream)
    native.check(rc, "ipa1")
    native.count_launch("ipa1")
    return tuple(outs)


class IPAAttentionFn(torch.autograd.Function):
    """The attention core under autograd, the counterpart of
    ``fused_ipa_attention_vjp``: the forward runs the kernel (the plain
    version on the CPU) and saves only its inputs; the backward recomputes
    :func:`ipa_attention_plain` from them and differentiates it, returning
    each gradient in its input's dtype and none for the 0/1 mask.

    apply(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf)"""

    @staticmethod
    def forward(ctx, q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf=1e5):
        ctx.save_for_backward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask)
        ctx.inf = inf
        return _forward(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf)

    @staticmethod
    def backward(ctx, go, gpt, gpair):
        *ins, mask = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(need) for x, need in zip(ins, ctx.needs_input_grad)]
            outs = ipa_attention_plain(*xs, mask, ctx.inf)
            wrt = [x for x in xs if x.requires_grad]
            grads = iter(torch.autograd.grad(outs, wrt, (go, gpt, gpair), allow_unused=True))
        return (*(next(grads) if x.requires_grad else None for x in xs), None, None)
