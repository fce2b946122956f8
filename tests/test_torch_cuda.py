"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): it
carries the ``cuda`` marker and skips where there is none. This file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances, bf16 outputs of O(1): kernel B 6e-2 (two bf16 steps: the hidden
layers are rounded to bf16 and fp32 sums run in another order), kernel A
3e-2 (one bf16 step). The backward kernels' gradients are sums over every
pair of products of bf16-rounded operands: each is held to its plain
version within 1e-2 of the plain gradient's norm (a rounding that flips
between the two moves one term by one bf16 step; a wrong index or a lost
partial moves the whole sum), and two calls must agree bit for bit.
The fused IPA forward (K7; at 1x and, csrc/ipa2_wide.cu, at the JAX
package's 2x, 4x and 8x widths) has fp32 outputs: each within 2e-2 + 1e-3 of
|plain| (one bf16 rounding of an attention weight that flips between kernel
and plain version moves the scalar output by at most 2^-9 |v|; the point
sums run in fp32 in another order); its backward (K8) is held like the
other backward kernels. The int8 EdgeTransition (K6, at c_z 64 and 128-512) is held to its plain
version at 6e-2 + 2e-2 |plain| (K2's bound: the kernel sums h1 on the
concatenated row, in another order than the plain version's factorized
form, so a row quantization may round the other way, which moves one int8
step of a hidden lane; tests/test_torch_edge_operands.py counts such rows on
the CPU). The wide forwards (K1/K2 and K6 at c_z 128, 256, 512:
csrc/edge_wide.cuh) are held at the same bound, with one counted launch (two
device kernels) a call and two calls bit for bit; the wide backward (K4 at
those widths: the node pre-pass, the chain, weight-gradient and reduction
kernels) like the other backward kernels, with its four device kernels a
call. The v1 IPA attention (K9) has fp32 outputs: with bf16
inputs at the model's widths 2e-2 + 1e-3 |plain| (K7's), with fp32 inputs
at the JAX tests' widths 1e-3 + 1e-4 |plain| (the sums run in another
order).
"""

import numpy as np
import pytest
import torch

from pepflowww_torch import native
from pepflowww_torch.models import cuda_dist, cuda_edge, cuda_ipa, cuda_ipa1

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _edge_inputs(dev, B, L, seed=6):
    rng = np.random.default_rng(seed)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    p = {"k1": t(192, 192, sc=0.1), "b1": t(192, sc=0.1), "k2": t(192, 192, sc=0.1),
         "b2": t(192, sc=0.1), "k3": t(192, 64, sc=0.1), "b3": t(64, sc=0.1),
         "ln_scale": 1 + t(64, sc=0.1), "ln_bias": t(64, sc=0.1)}
    readout = (t(64, 8, sc=0.1), t(8), t(64, 16, sc=0.1), t(16))
    mask = torch.from_numpy((rng.random((B, L)) > 0.1).astype(np.float32)).to(dev)
    return t(B, L, L, 64).bfloat16(), t(B, L, 64).bfloat16(), mask, p, readout


def _dist_inputs(dev, B, L, seed=13):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    args = (f(rng.normal(size=(B, L, 15, 3)) * 0.5), f(rng.random((B, L, 15)) > 0.15),
            torch.from_numpy(rng.integers(0, 22, size=(B, L))).to(dev),
            f(rng.random((B, L)) > 0.2))
    p = {"table": f(rng.normal(size=(484, 225)) * 0.1), "k1": f(rng.normal(size=(225, 64)) * 0.05),
         "b1": f(rng.normal(size=64) * 0.1), "k2": f(rng.normal(size=(64, 64)) * 0.05),
         "b2": f(rng.normal(size=64) * 0.1)}
    return args, p


# (B, L): ragged L with tiles that cross batch rows (24, 37, 100), L=1,
# fewer tiles than SMs, and L > 64 at the sampler's batch.
@pytest.mark.parametrize("B,L", [(2, 24), (2, 64), (3, 37), (1, 1), (2, 100), (64, 128)])
@pytest.mark.parametrize("with_readout", [False, True])
def test_edge_kernel_matches_plain(dev, B, L, with_readout):
    edge, nb, mask, p, readout = _edge_inputs(dev, B, L)
    ro = readout if with_readout else None
    before = native.LAUNCHES["edge_transition"]
    got = cuda_edge.fused_edge_transition(edge, nb, mask, p, readout=ro)
    torch.cuda.synchronize()
    assert native.LAUNCHES["edge_transition"] == before + 1
    want = cuda_edge.edge_transition_plain(edge, nb, mask, p, torch.bfloat16, ro)
    for a, b in zip(got if ro else (got,), want if ro else (want,)):
        torch.testing.assert_close(a.float(), b.float(), atol=6e-2, rtol=0)


# L = 37 and 100: a ragged single j tile, and two j tiles with a ragged edge.
@pytest.mark.parametrize("L", [37, 40, 64, 100])
def test_distance_kernel_matches_plain(dev, L):
    args, p = _dist_inputs(dev, 2, L)
    before = native.LAUNCHES["distance_embed"]
    got = cuda_dist.fused_distance_embed(*args, p)
    torch.cuda.synchronize()
    assert native.LAUNCHES["distance_embed"] == before + 1
    want = cuda_dist.distance_embed_plain(*args, p, torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


def _close_in_norm(got, want, name, rel=1e-2):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), name
    err = float((got - want).norm())
    assert err <= rel * float(want.norm()) + 1e-6, (name, err, float(want.norm()))


# (B, L): the training shape's L, a ragged L, and one whose 8 x 8 tiles
# are cut at both edges with a pair count that is no multiple of 64.
@pytest.mark.parametrize("B,L", [(2, 24), (2, 64), (3, 37)])
def test_edge_backward_kernel_matches_plain(dev, B, L):
    edge, nb, mask, p, _ = _edge_inputs(dev, B, L, seed=L)
    g = torch.randn(edge.shape, generator=torch.Generator().manual_seed(L)).to(dev).bfloat16()
    before = native.LAUNCHES["edge_transition_bwd"]
    got = cuda_edge.edge_transition_bwd(edge, nb, mask, p, g)
    again = cuda_edge.edge_transition_bwd(edge, nb, mask, p, g)
    torch.cuda.synchronize()
    assert native.LAUNCHES["edge_transition_bwd"] == before + 2
    want = cuda_edge.edge_transition_bwd_plain(edge, nb, mask, p, g, torch.bfloat16)
    for name, a, b, c in (("d_edge", got[0], want[0], again[0]),
                          ("d_node", got[1], want[1], again[1]),
                          *((k, got[2][k], want[2][k], again[2][k]) for k in cuda_edge.PARAM_NAMES)):
        _close_in_norm(a, b, name)
        assert torch.equal(a, c), f"{name}: two calls differ"


@pytest.mark.parametrize("L", [37, 40, 64, 100])
def test_distance_backward_kernel_matches_plain(dev, L):
    args, p = _dist_inputs(dev, 2, L)
    g = torch.randn(2, L, L, 64, generator=torch.Generator().manual_seed(L)).to(dev).bfloat16()
    before = native.LAUNCHES["distance_embed_bwd"]
    got = cuda_dist.distance_embed_bwd(*args, p, g)
    again = cuda_dist.distance_embed_bwd(*args, p, g)
    torch.cuda.synchronize()
    assert native.LAUNCHES["distance_embed_bwd"] == before + 2
    want = cuda_dist.distance_embed_bwd_plain(*args, p, g, torch.bfloat16)
    for k in cuda_dist.PARAM_NAMES:
        _close_in_norm(got[k], want[k], k)
        assert torch.equal(got[k], again[k]), f"{k}: two calls differ"


def test_autograd_functions_fill_every_grad(dev):
    """loss.backward() through both Functions on the card launches both
    backward kernels once and fills every parameter's .grad."""
    edge, nb, mask, p, _ = _edge_inputs(dev, 2, 24)
    pe = {k: v.clone().requires_grad_() for k, v in p.items()}
    args, pd = _dist_inputs(dev, 2, 24)
    pd = {k: v.clone().requires_grad_() for k, v in pd.items()}
    before = dict(native.LAUNCHES)
    out = cuda_edge.EdgeTransitionFn.apply(edge, nb, mask, *pe.values(), torch.bfloat16,
                                           cuda_edge.kernel_operands(p))
    dist = cuda_dist.DistanceEmbedFn.apply(*args, *pd.values(), torch.bfloat16,
                                           cuda_dist.kernel_operands(pd))
    (out.float().square().sum() + dist.float().square().sum()).backward()
    torch.cuda.synchronize()
    for name in ("edge_transition", "edge_transition_bwd", "distance_embed", "distance_embed_bwd"):
        assert native.LAUNCHES[name] == before[name] + 1, name
    for k, v in list(pe.items()) + list(pd.items()):
        assert v.grad is not None and bool(torch.isfinite(v.grad).all()), k
    with pytest.raises(RuntimeError, match="no autograd"):
        cuda_edge.fused_edge_transition(edge, nb, mask, pe)


def test_kernels_reject_what_they_do_not_take(dev):
    """A CUDA tensor goes to the kernel or raises: float32 compute, a
    float32 edge tensor and a non-contiguous one are refused, no launch."""
    edge, nb, mask, p, _ = _edge_inputs(dev, 1, 8)
    before = dict(native.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_edge.fused_edge_transition(edge, nb, mask, p, dtype=torch.float32)
    with pytest.raises(ValueError):
        cuda_edge.fused_edge_transition(edge.float(), nb, mask, p)
    with pytest.raises(ValueError):
        cuda_edge.fused_edge_transition(edge.transpose(1, 2), nb, mask, p)
    args, pd = _dist_inputs(dev, 1, 8)
    with pytest.raises(ValueError):
        cuda_dist.fused_distance_embed(*args, pd, dtype=torch.float32)
    # The backward kernel indexes pairs in 32 bits: its wrapper refuses more
    # than 2^31 - 1 pairs before it reads a tensor, and so does its launcher.
    big = torch.empty(1 << 15, 1 << 8, 1 << 8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        cuda_edge.edge_transition_bwd(big, nb, mask, p, big)
    launch = native.function("edge_transition_bwd", "edge_transition_backward",
                             cuda_edge._BWD_ARGTYPES)
    assert launch(*[None] * 30, 1 << 15, 1 << 8, 1, 1, 1, 1, 1, 1e-5, None) != 0
    assert native.LAUNCHES == before


def ipa_inputs(dev, B, L, seed=0, module_layout=False, width=1):
    """Inputs of the fused IPA at `width` times the production widths (H 8,
    C 128 w, Pq 8, Pv 12, CZ4 16 w), bf16 where the model feeds bf16. With
    `module_layout` the points, the pair bias and the pair readout are
    permuted views, as the module passes them (the readout in the
    EdgeTransition epilogue's (B, CZ4, L, L) layout)."""
    H, C, Pq, Pv, CZ4 = 8, 128 * width, 8, 12, 16 * width
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    R = torch.from_numpy(np.linalg.qr(rng.normal(size=(B, L, 3, 3)))[0].astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((B, L)) > 0.15).astype(np.float32)).to(dev)
    bf = torch.bfloat16
    if module_layout:
        qp = f(B, L, 3, H, Pq, sc=2.0).to(bf).permute(0, 3, 2, 1, 4)
        kvp = f(B, L, 3, H, Pq + Pv, sc=2.0).to(bf).permute(0, 3, 2, 1, 4)
        bias = f(B, L, L, H).to(bf).permute(0, 3, 1, 2)
        pz = f(B, CZ4, L, L).to(bf).permute(0, 2, 3, 1)
    else:
        qp, kvp = f(B, H, 3, L, Pq, sc=2.0).to(bf), f(B, H, 3, L, Pq + Pv, sc=2.0).to(bf)
        bias, pz = f(B, H, L, L).to(bf), f(B, L, L, CZ4).to(bf)
    sw = (f(1, H, sc=0.1).abs() + 0.2)
    return [f(B, L, H * C).to(bf), f(B, L, 2 * H * C).to(bf), qp, kvp, R.reshape(B, L, 9),
            f(B, L, 3, sc=5.0), bias, pz, (1e5 * (mask - 1.0))[:, None, :], sw]


# L: one key tile (1, 24, 40, 64), two with a ragged edge (65, 100), four
# (256); layouts: the sampler's (bias (B, H, L, L), the pair readout a view of
# (B, CZ4, L, L)) and the training step's (bias a view of (B, L, L, H), the
# pair readout (B, L, L, CZ4)); L % 8 != 0 takes the strided loads.
@pytest.mark.parametrize("L", [1, 24, 40, 64, 65, 100, 256])
@pytest.mark.parametrize("layout", ["sampler", "train"])
def test_ipa2_kernel_matches_plain(dev, L, layout):
    args = ipa_inputs(dev, 2, L, seed=L, module_layout=True)
    if layout == "sampler":
        args[6] = args[6].contiguous()
    else:
        args[7] = args[7].contiguous()
    before = native.LAUNCHES["ipa2"]
    got = cuda_ipa.fused_ipa2(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ipa2"] == before + 1
    want = cuda_ipa.ipa2_plain(*args)
    for name, a, b in zip(("o", "optl", "norm", "opair"), got, want):
        assert bool(torch.isfinite(a).all()), name
        excess = float(((a - b).abs() - 1e-3 * b.abs()).max())
        assert excess <= 2e-2, (name, excess)


# L <= 64: the tile and pair kernels (a full tile, ragged ones); L = 65,
# 100, 128: the query, key and pair kernels (a last tile of one row, a
# ragged one, two full ones).
@pytest.mark.parametrize("L,module_layout", [(64, False), (24, True), (37, True), (65, True),
                                             (100, False), (128, False)])
def test_ipa2_backward_kernel_matches_plain(dev, L, module_layout):
    args = ipa_inputs(dev, 2, L, seed=L + 1, module_layout=module_layout)
    rng = np.random.default_rng(L)
    outs = cuda_ipa.ipa2_plain(*args)
    cots = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)).to(dev) for o in outs]
    before = native.LAUNCHES["ipa2_bwd"]
    got = cuda_ipa.ipa2_bwd(*args, *cots)
    again = cuda_ipa.ipa2_bwd(*args, *cots)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ipa2_bwd"] == before + 2
    want = cuda_ipa.ipa2_bwd_plain(*args, *cots)
    names = ("gq", "gkv", "gqp", "gkvp", "gr9", "gt", "gbias", "gpz", "gsw")
    for name, a, b, c in zip(names, got, want, again):
        _close_in_norm(a, b, name)
        assert torch.equal(a, c), f"{name}: two calls differ"


def test_ipa2_wrappers_reject_what_they_do_not_take(dev):
    """float32 scalar inputs, a width the kernels do not take (C = 64) and
    the bare forward under grad mode are refused, with no launch; the
    autograd Function launches both kernels once and fills every grad."""
    args = ipa_inputs(dev, 1, 8)
    before = dict(native.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_ipa.fused_ipa2(args[0].float(), *args[1:])
    narrow = list(args)
    narrow[0], narrow[1] = args[0][..., :512].contiguous(), args[1][..., :1024].contiguous()
    with pytest.raises(ValueError):
        cuda_ipa.fused_ipa2(*narrow)
    with pytest.raises(ValueError):
        cuda_ipa.ipa2_bwd(*args, *(torch.zeros(1, 8, w, device=dev) for w in (1024, 288, 96, 64)))
    leaves = [a.detach().clone().requires_grad_() if a.is_floating_point() and i != 8 else a
              for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no autograd"):
        cuda_ipa.fused_ipa2(*leaves)
    assert native.LAUNCHES == before
    out = cuda_ipa.IPA2Fn.apply(*leaves, 1e-8)
    sum(o.square().sum() for o in out).backward()
    torch.cuda.synchronize()
    assert native.LAUNCHES["ipa2"] == before["ipa2"] + 1
    assert native.LAUNCHES["ipa2_bwd"] == before["ipa2_bwd"] + 1
    for i, x in enumerate(leaves):
        if i != 8:
            assert x.grad is not None and bool(torch.isfinite(x.grad).all()), i


def _within(got, want, atol, rtol, name):
    assert bool(torch.isfinite(got).all()), name
    excess = float(((got.float() - want.float()).abs() - rtol * want.float().abs()).max())
    assert excess <= atol, (name, excess)


@pytest.mark.parametrize("L", [24, 37, 64])
@pytest.mark.parametrize("with_readout", [False, True])
def test_int8_edge_kernel_matches_plain(dev, L, with_readout):
    """K6 against its plain version (L=37: tiles that cross batch rows); it
    launches instead of the bf16 kernel."""
    edge, nb, mask, p, readout = _edge_inputs(dev, 2, L, seed=L + 7)
    ro = readout if with_readout else None
    before = dict(native.LAUNCHES)
    got = cuda_edge.fused_edge_transition_int8(edge, nb, mask, p, readout=ro)
    torch.cuda.synchronize()
    assert native.LAUNCHES["edge_transition_int8"] == before["edge_transition_int8"] + 1
    assert native.LAUNCHES["edge_transition"] == before["edge_transition"]
    want = cuda_edge.edge_transition_int8_plain(edge, nb, mask, p, torch.bfloat16, ro)
    for name, a, b in zip(("out", "b", "pz"), got if ro else (got,), want if ro else (want,)):
        _within(a, b, 6e-2, 2e-2, name)


# The JAX package's 2x, 4x and 8x widths (csrc/ipa2_wide.cu; C 256-1024):
# a ragged L, both layouts, L = 1 and the L = 128 bucket; the forward and
# backward held as at 1x, one launch a call each, two backward calls bit
# for bit.
@pytest.mark.parametrize("width,L,module_layout", [(2, 37, True), (4, 64, False), (8, 1, True),
                                                   (2, 128, False), (8, 100, True)])
def test_wide_ipa2_kernels_match_plain(dev, width, L, module_layout):
    args = ipa_inputs(dev, 2, L, seed=L + width, module_layout=module_layout, width=width)
    before = dict(native.LAUNCHES)
    got = cuda_ipa.fused_ipa2(*args)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ipa2"] == before["ipa2"] + 1
    want = cuda_ipa.ipa2_plain(*args)
    for name, a, b in zip(("o", "optl", "norm", "opair"), got, want):
        _within(a, b, 2e-2, 1e-3, name)
    rng = np.random.default_rng(L)
    cots = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)).to(dev) for o in want]
    got = cuda_ipa.ipa2_bwd(*args, *cots)
    again = cuda_ipa.ipa2_bwd(*args, *cots)
    torch.cuda.synchronize()
    assert native.LAUNCHES["ipa2_bwd"] == before["ipa2_bwd"] + 2
    want = cuda_ipa.ipa2_bwd_plain(*args, *cots)
    names = ("gq", "gkv", "gqp", "gkvp", "gr9", "gt", "gbias", "gpz", "gsw")
    for name, a, b, c in zip(names, got, want, again):
        _close_in_norm(a, b, name)
        assert torch.equal(a, c), f"{name}: two calls differ"


def _wide_edge_inputs(dev, cz, L, with_readout):
    """Seeded EdgeTransition inputs at c_z = cz (B = 2): weights
    N(0, 1/fan_in), ~10% of the residues masked, the readout the next
    block's 8 heads and c_z/4 channels (or None)."""
    rng = np.random.default_rng(cz + L)
    t = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    hid = 3 * cz
    p = {"k1": t(hid, hid, sc=hid ** -0.5), "b1": t(hid, sc=0.1), "k2": t(hid, hid, sc=hid ** -0.5),
         "b2": t(hid, sc=0.1), "k3": t(hid, cz, sc=hid ** -0.5), "b3": t(cz, sc=0.1),
         "ln_scale": 1 + t(cz, sc=0.1), "ln_bias": t(cz, sc=0.1)}
    ro = (t(cz, 8, sc=0.1), t(8), t(cz, cz // 4, sc=0.1), t(cz // 4)) if with_readout else None
    edge, nb = t(2, L, L, cz).bfloat16(), t(2, L, cz).bfloat16()
    mask = torch.from_numpy((rng.random((2, L)) > 0.1).astype(np.float32)).to(dev)
    return edge, nb, mask, p, ro


def _wide_edge_check(call, plain, lib, ro):
    """One counted launch a call of the wrapper (the library's two device
    kernels: the node pre-pass and the tile kernel), within EDGE_TOL of the
    plain version, and the same bits from a second call."""
    launched = native.function(lib, f"{lib}_wide_launches", [])
    before, kernels = dict(native.LAUNCHES), launched()
    got = call()
    torch.cuda.synchronize()
    assert native.LAUNCHES[lib] == before[lib] + 1
    assert launched() - kernels == 2
    again = call()
    want = plain()
    got, again, want = (got, again, want) if ro else ((got,), (again,), (want,))
    for name, a, b, c in zip(("out", "b", "pz"), got, want, again):
        _within(a, b, 6e-2, 2e-2, name)
        assert torch.equal(a, c), f"{name}: two calls differ"


# The wide forwards (csrc/edge_wide.cuh) at c_z 128, 256, 512 on ragged L:
# B L^2 = 2738, 1152, 512 pair rows (the last 64-row tile part-filled at 37).
@pytest.mark.parametrize("cz,L", [(128, 37), (256, 24), (512, 16)])
@pytest.mark.parametrize("with_readout", [False, True])
def test_wide_edge_kernel_matches_plain(dev, cz, L, with_readout):
    """K1 (readout off) and K2 (on) at c_z 128, 256, 512
    (csrc/edge_transition.cu's wide entry) against the plain version."""
    edge, nb, mask, p, ro = _wide_edge_inputs(dev, cz, L, with_readout)
    _wide_edge_check(lambda: cuda_edge.fused_edge_transition(edge, nb, mask, p, readout=ro),
                     lambda: cuda_edge.edge_transition_plain(edge, nb, mask, p, torch.bfloat16, ro),
                     "edge_transition", ro)


@pytest.mark.parametrize("cz,L", [(128, 37), (256, 24), (512, 16)])
@pytest.mark.parametrize("with_readout", [False, True])
def test_wide_int8_edge_kernel_matches_plain(dev, cz, L, with_readout):
    """K6 at c_z 128, 256, 512 (csrc/edge_transition_int8.cu's wide entry)
    against its plain version at K6's bound; one launch a call, two calls
    bit for bit."""
    edge, nb, mask, p, ro = _wide_edge_inputs(dev, cz, L, with_readout)
    _wide_edge_check(
        lambda: cuda_edge.fused_edge_transition_int8(edge, nb, mask, p, readout=ro),
        lambda: cuda_edge.edge_transition_int8_plain(edge, nb, mask, p, torch.bfloat16, ro),
        "edge_transition_int8", ro)


@pytest.mark.parametrize("quant_int8", [False, True])
def test_wide_edge_kernels_refuse_stages_of_another_length(dev, monkeypatch, quant_int8):
    """The wide libraries check the lengths of the weight stages they copy
    (ops["wb"], ops["wrb"]) against their schedule themselves: with the
    wrapper's own shape checks switched off, a stage short raises."""
    edge, nb, mask, p, ro = _wide_edge_inputs(dev, 128, 24, True)
    fn = cuda_edge.fused_edge_transition_int8 if quant_int8 else cuda_edge.fused_edge_transition
    monkeypatch.setattr(cuda_edge, "_check_ops", lambda *a, **k: None)
    for key in ("wb", "wrb"):
        ops = cuda_edge.kernel_operands(p, ro, quant_int8=quant_int8)
        ops[key] = ops[key][:-cuda_edge.STAGE]
        with pytest.raises(RuntimeError, match="cudaError 1"):
            fn(edge, nb, mask, p, readout=ro, ops=ops)


# The wide backward (K4 at c_z 128, 256, 512; csrc/edge_transition_bwd.cu's
# wide entry) at the training shape's L and a ragged one whose last 64-pair
# tile is part-filled and whose tiles cross batch rows (B L^2 = 2738 at 37).
@pytest.mark.parametrize("cz", [128, 256, 512])
@pytest.mark.parametrize("L", [64, 37])
def test_wide_edge_backward_kernel_matches_plain(dev, cz, L):
    """Every gradient within 1e-2 of the plain version's norm, two calls bit
    for bit, d_edge in bf16 the float32 one rounded, one counted launch a
    call and the library's designed count of device kernels."""
    edge, nb, mask, p, _ = _wide_edge_inputs(dev, cz, L, False)
    g = torch.randn(edge.shape, generator=torch.Generator().manual_seed(cz + L)).to(dev).bfloat16()
    lib = "edge_transition_bwd"
    launched = native.function(lib, "edge_transition_bwd_wide_launches", [])
    per_call = native.function(lib, "edge_transition_wide_bwd_kernels_per_call", [])()
    assert per_call == 4
    before, kernels = native.LAUNCHES[lib], launched()
    got = cuda_edge.edge_transition_bwd(edge, nb, mask, p, g)
    torch.cuda.synchronize()
    assert native.LAUNCHES[lib] == before + 1
    assert launched() - kernels == per_call
    again = cuda_edge.edge_transition_bwd(edge, nb, mask, p, g)
    half = cuda_edge.edge_transition_bwd(edge, nb, mask, p, g, d_edge_dtype=torch.bfloat16)
    want = cuda_edge.edge_transition_bwd_plain(edge, nb, mask, p, g, torch.bfloat16)
    for name, a, b, c in (("d_edge", got[0], want[0], again[0]),
                          ("d_node", got[1], want[1], again[1]),
                          *((k, got[2][k], want[2][k], again[2][k]) for k in cuda_edge.PARAM_NAMES)):
        _close_in_norm(a, b, name)
        assert torch.equal(a, c), f"{name}: two calls differ"
    assert torch.equal(half[0], got[0].to(torch.bfloat16))


def test_wide_edge_backward_refuses_stages_of_another_length(dev, monkeypatch):
    """The wide backward's library checks the length of the chain kernel's
    weight stages (ops["wbb"]) itself: with the wrapper's shape checks
    switched off, a stage short raises."""
    edge, nb, mask, p, _ = _wide_edge_inputs(dev, 128, 24, False)
    g = torch.ones_like(edge)
    monkeypatch.setattr(cuda_edge, "_check_ops", lambda *a, **k: None)
    ops = cuda_edge.kernel_operands(p)
    ops["wbb"] = ops["wbb"][:-cuda_edge.STAGE]
    with pytest.raises(RuntimeError, match="cudaError 1"):
        cuda_edge.edge_transition_bwd(edge, nb, mask, p, g, ops=ops)


def ipa1_inputs(dev, B, L, widths, dtype, seed=0):
    """Inputs of the v1 attention core, head-major, at the model's widths
    (H 8, C 128, Pq 8, Pv 12, CZ4 16) or the JAX tests' (H 4, C 32, Pq 4,
    Pv 6, CZ4 8): q, k, v, bias and pair_z in `dtype`, points float32,
    about 15% of the keys masked."""
    H, C, Pq, Pv, CZ4 = (8, 128, 8, 12, 16) if widths == "model" else (4, 32, 4, 6, 8)
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((B, L)) > 0.15).astype(np.float32)).to(dev)
    return [f(B, H, L, C).to(dtype), f(B, H, L, C).to(dtype), f(B, H, L, C).to(dtype),
            f(B, H, L, 3 * Pq), f(B, H, L, 3 * Pq), f(B, H, L, 3 * Pv), f(B, H, L, L).to(dtype),
            f(B, L, L, CZ4).to(dtype), mask]


@pytest.mark.parametrize("widths,dtype,L", [("model", torch.bfloat16, 64),
                                            ("test", torch.float32, 40),
                                            ("test", torch.float32, 256),
                                            ("model", torch.bfloat16, 1),
                                            ("model", torch.bfloat16, 24),
                                            ("model", torch.bfloat16, 100),
                                            ("model", torch.bfloat16, 256)])
def test_ipa1_kernel_matches_plain(dev, widths, dtype, L):
    """K9 through both wrappers (the JAX package's two grid variants): bf16
    at the model's widths runs the tensor-core kernel (one key tile at L =
    1, 24, 64; a logits-only first pass at L = 100, 256; the bias read in
    place where L % 8 != 0), fp32 at the JAX tests' widths the fp32 one."""
    args = ipa1_inputs(dev, 2, L, widths, dtype, seed=L)
    atol, rtol = (2e-2, 1e-3) if dtype == torch.bfloat16 else (1e-3, 1e-4)
    want = cuda_ipa1.ipa_attention_plain(*args)
    for fn in (cuda_ipa1.fused_ipa_attention, cuda_ipa1.fused_ipa_attention_bh):
        before = native.LAUNCHES["ipa1"]
        got = fn(*args)
        torch.cuda.synchronize()
        assert native.LAUNCHES["ipa1"] == before + 1
        for name, a, b in zip(("o", "o_pt", "o_pair"), got, want):
            _within(a, b, atol, rtol, name)


def test_int8_and_ipa1_wrappers_reject_what_they_do_not_take(dev):
    """K6: float32 compute, a float32 edge tensor and grad mode are refused;
    K9: a width it does not take (C 64), mixed input dtypes and grad mode;
    all with no launch. IPAAttentionFn launches K9 once and fills every
    gradient but the mask's."""
    edge, nb, mask, p, _ = _edge_inputs(dev, 1, 8)
    before = dict(native.LAUNCHES)
    with pytest.raises(ValueError):
        cuda_edge.fused_edge_transition_int8(edge, nb, mask, p, dtype=torch.float32)
    with pytest.raises(ValueError):
        cuda_edge.fused_edge_transition_int8(edge.float(), nb, mask, p)
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    with pytest.raises(RuntimeError, match="quant_int8"):
        cuda_edge.fused_edge_transition_int8(edge, nb, mask, leaves)
    args = ipa1_inputs(dev, 1, 8, "model", torch.bfloat16)
    wide = list(args)
    wide[:3] = [x[..., :64].contiguous() for x in args[:3]]
    with pytest.raises(ValueError):
        cuda_ipa1.fused_ipa_attention(*wide)
    mixed = list(args)
    mixed[6] = args[6].float()
    with pytest.raises(ValueError):
        cuda_ipa1.fused_ipa_attention(*mixed)
    leaves = [a.detach().clone().requires_grad_() if i < 8 else a for i, a in enumerate(args)]
    with pytest.raises(RuntimeError, match="no autograd"):
        cuda_ipa1.fused_ipa_attention_bh(*leaves)
    assert native.LAUNCHES == before
    out = cuda_ipa1.IPAAttentionFn.apply(*leaves, 1e5)
    sum(o.square().sum() for o in out).backward()
    torch.cuda.synchronize()
    assert native.LAUNCHES["ipa1"] == before["ipa1"] + 1
    for i, x in enumerate(leaves[:8]):
        assert x.grad is not None and bool(torch.isfinite(x.grad).all()), i
