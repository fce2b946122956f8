"""The wide EdgeTransition backward's schedule (K4 at c_z = 128, 256, 512:
csrc/edge_transition_bwd.cu's ``edge_transition_wide_backward``), emulated
in plain PyTorch on the CPU.

The CUDA kernels cannot run here, so :func:`fused_backward` repeats what
their four launches compute, in their order, from the operands
``kernel_operands`` packs:

- the node pre-pass Y = node.[W1i | W1j] in fp32 (the first 2 hid rows of
  ``wn``);
- the chain kernel, every 64-row tile at once (the schedule is the same for
  each; rows past B L^2 read residue 0 and are never stored), taking the
  stages of ``wbb`` one after another as ``wide_bwd_stages`` lists them,
  each stage's two 8 KB pieces unswizzled and multiplied into the two
  consumer warpgroups' 64-column halves: a1 = ((e.W1e + Y1_i) + Y1_j) + b1
  and h1 = bf16(relu(a1)) chunk by chunk; a2 = h1.W2 + b2, r = bf16(relu(a2)
  + [e | n_i | n_j]) and o = b3 + r.W3, r a 128-column chunk at a time;
  the LayerNorm backward with each row's sums taken as warpgroup 0's half
  plus warpgroup 1's; dr = bf16(do).W3^T and da2 = dr [a2 > 0]; the d_edge
  init bf16(do).W3e^T; dh1 = bf16(da2).W2^T, da1 = dh1 [a1 > 0] and d_edge
  += da1_chunk.W1e^T (at c_z 512 o and d_edge a 64-column block at a time,
  after every chunk of r and da1); the column sums of da1, da2, do, g_out y and g_out a
  tile at a time, each block's running sums over its tiles of the
  persistent grid in order, then the blocks' in order;
- the weight kernel: dW1e, dW2, dW3 over K slices of tiles (one partial
  slot a slice, the slots added in order), and the per-residue sums of the
  da1 and do images (S_i = sum over j, S_j = sum over i);
- the reduction: d_node = S_i.W1i^T + T_i.W3i^T + S_j.W1j^T + T_j.W3j^T and
  dW1's node rows node^T.S_i, node^T.S_j, in fp32.

Checks: the emulation against ``edge_transition_bwd_plain`` at c_z 128 (B =
2, L = 13: 338 pairs, a ragged last tile and tiles that cross batch rows;
L = 16: 512 pairs, 64-row tiles that cross i rows) and at c_z 512 (B = 1,
L = 6), every gradient within 3e-4 of the plain gradient's norm
(tests/test_torch_widths_tiles.py's bound for the wide schedules: the first
layer is factorized, so a few h1 entries round to the other bf16 neighbour
than in the plain version's single product; a wrong stage, row map, mask
bit or lost partial moves a gradient by O(1) of its norm); the node-sum
identity (d_node and dW1's node rows from per-residue sums against dx and
x^T.da1 summed pair by pair, fp32 order only); and the packing of ``wbb``:
each stage's pieces unswizzle to the weight blocks ``wide_bwd_stages``
names, in the count the chain kernel's producer copies.
"""

import numpy as np
import pytest
import torch

from pepflowww_torch.models import cuda_edge

from test_torch_widths_edge_fused import Stages

torch.set_num_threads(1)
bf = torch.bfloat16
rnd = lambda t: t.to(bf).float()
TM, SMS = 64, 132


def _inputs(cz, B, L, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    hid = 3 * cz
    p = {"k1": f(hid, hid, sc=hid ** -0.5), "b1": f(hid, sc=0.1),
         "k2": f(hid, hid, sc=hid ** -0.5), "b2": f(hid, sc=0.1),
         "k3": f(hid, cz, sc=hid ** -0.5), "b3": f(cz, sc=0.1),
         "ln_scale": 1 + f(cz, sc=0.1), "ln_bias": f(cz, sc=0.1)}
    mask = torch.from_numpy((rng.random((B, L)) > 0.1).astype(np.float32))
    return f(B, L, L, cz).to(bf), f(B, L, cz).to(bf), mask, p, f(B, L, L, cz).to(bf)


def _column_sums(v, grid):
    """Column sums of v (Mp rows) as the chain kernel takes them: a tile's
    64 rows, each block's running sum over its tiles t = block, block +
    grid, ... in order, then the blocks' sums in order."""
    tiles = v.reshape(-1, TM, v.shape[-1]).sum(1)
    out = torch.zeros(v.shape[-1])
    for b in range(grid):
        run = torch.zeros(v.shape[-1])
        for t in range(b, tiles.shape[0], grid):
            run = run + tiles[t]
        out = out + run
    return out


def fused_backward(edge, nb, mask, ops, g, eps=1e-5, trace=None):
    """The four launches' arithmetic in their order (see the top of this
    file). `trace`, a dict, receives a1 and a2 of the pairs."""
    B, L, _, cz = edge.shape
    hid, M = 3 * cz, B * L * L
    nj, ke, kh, nc = cz // 128, cz // 64, hid // 64, hid // 128
    ntiles = -(-M // TM)
    Mp = ntiles * TM
    grid, nslices = cuda_edge.wide_bwd_schedule(B, L, cz, SMS)
    r = torch.arange(Mp)
    valid = r < M
    ri = torch.where(valid, r // L, 0)
    rj = torch.where(valid, (r // (L * L)) * L + r % L, 0)
    node = rnd(nb).reshape(B * L, cz)
    Y = node @ rnd(ops["wn"][:2 * hid]).t()
    e = torch.zeros(Mp, cz)
    e[:M] = rnd(edge).reshape(M, cz)
    x = torch.cat([e, node[ri], node[rj]], -1)
    ring = Stages(ops["wbb"])
    panel = lambda t, k: t[:, 64 * k:64 * (k + 1)]

    def product(a, nk, acc=None):
        """The two warpgroups' m64n64 products over the next nk stages."""
        blocks = [ring.take(bf) for _ in range(nk)]
        a = torch.cat([panel(a, k) for k in range(nk)], -1)
        out = [a @ torch.cat([blk[w] for blk in blocks], -1).t() for w in (0, 1)]
        return out if acc is None else [acc[w] + out[w] for w in (0, 1)]

    half = lambda c, w: slice(128 * c + 64 * w, 128 * c + 64 * w + 64)
    blk = lambda w, j: slice(w * cz // 2 + 64 * j, w * cz // 2 + 64 * j + 64)
    # 1. a1, h1.
    a1 = torch.empty(Mp, hid)
    for c in range(nc):
        acc = product(e, ke)
        for w in (0, 1):
            cols = half(c, w)
            a1[:, cols] = ((acc[w] + Y[ri, cols]) + Y[rj, hid + cols.start:hid + cols.stop]) \
                + ops["b1"][cols]
    h1 = rnd(torch.relu(a1))
    # 2. a2, r a chunk at a time, o = b3 + r.W3 (the bias first): after each
    # chunk of r, or at c_z 512 after all of them, a block of o at a time.
    a2, rc, o = torch.empty(Mp, hid), torch.empty(Mp, hid), ops["b3"].expand(Mp, cz).clone()
    stream = cz >= cuda_edge.WIDE_BWD_STREAM_CZ
    for c in range(nc):
        acc = product(h1, kh)
        for w in (0, 1):
            cols = half(c, w)
            a2[:, cols] = acc[w] + ops["b2"][cols]
            rc[:, cols] = rnd(torch.relu(a2[:, cols]) + x[:, cols])
        chunk = rc[:, 128 * c:128 * c + 128]
        for j in range(0 if stream else nj):
            acc = product(chunk, 2, acc=[o[:, blk(0, j)], o[:, blk(1, j)]])
            for w in (0, 1):
                o[:, blk(w, j)] = acc[w]
    for j in range(nj if stream else 0):
        acc = product(rc, kh, acc=[o[:, blk(0, j)], o[:, blk(1, j)]])
        for w in (0, 1):
            o[:, blk(w, j)] = acc[w]
    # 3. The LayerNorm backward, each row's sums warpgroup 0's half plus 1's.
    sums = lambda v: v[:, :cz // 2].sum(-1, keepdim=True) + v[:, cz // 2:].sum(-1, keepdim=True)
    oc = o - sums(o) / cz
    rs = torch.rsqrt(sums(oc * oc) / cz + eps)
    y = oc * rs
    m = mask.reshape(-1)
    gf = torch.zeros(Mp, cz)
    gf[:M] = g.float().reshape(M, cz)
    g_out = gf * (m[ri] * m[rj] * valid)[:, None]
    dy = g_out * ops["ln_scale"]
    do = (dy - sums(dy) / cz - y * (sums(dy * y) / cz)) * rs
    doc = rnd(do)
    # 4. dr, da2.
    da2 = torch.empty(Mp, hid)
    for c in range(nc):
        acc = product(doc, ke)
        for w in (0, 1):
            cols = half(c, w)
            da2[:, cols] = acc[w] * (a2[:, cols] > 0)
    da2c = rnd(da2)
    # 5. The d_edge init, then 6. dh1, da1 and d_edge a chunk at a time; at
    # c_z 512 every chunk of dh1 and da1, then d_edge a block at a time.
    d = torch.empty(Mp, cz)
    for j in range(0 if stream else nj):
        acc = product(doc, ke)
        for w in (0, 1):
            d[:, blk(w, j)] = acc[w]
    da1 = torch.empty(Mp, hid)
    for c in range(nc):
        acc = product(da2c, kh)
        for w in (0, 1):
            cols = half(c, w)
            da1[:, cols] = acc[w] * (a1[:, cols] > 0)
        chunk = rnd(da1[:, 128 * c:128 * c + 128])
        for j in range(0 if stream else nj):
            acc = product(chunk, 2, acc=[d[:, blk(0, j)], d[:, blk(1, j)]])
            for w in (0, 1):
                d[:, blk(w, j)] = acc[w]
    for j in range(nj if stream else 0):
        acc = product(doc, ke)
        acc = product(rnd(da1), kh, acc=acc)
        for w in (0, 1):
            d[:, blk(w, j)] = acc[w]
    assert ring.at == ring.blob.shape[0], "the chain kernel takes every stage of wbb"
    if trace is not None:
        trace.update(a1=a1[:M].reshape(B, L, L, hid), a2=a2[:M].reshape(B, L, L, hid))
    da1c = rnd(da1)
    # The weight kernel: K slices of tiles, one slot each, added in order.
    bounds = [ntiles * z // nslices * TM for z in range(nslices + 1)]
    slots = lambda A, Bm: sum((A[lo:hi].t() @ Bm[lo:hi] for lo, hi in zip(bounds, bounds[1:])),
                              torch.zeros(A.shape[1], Bm.shape[1]))
    grads = {"k2": slots(h1, da2c), "k3": slots(rc, doc),
             "b1": _column_sums(da1, grid), "b2": _column_sums(da2, grid),
             "b3": _column_sums(do, grid), "ln_scale": _column_sums(g_out * y, grid),
             "ln_bias": _column_sums(g_out, grid)}
    # Its per-residue sums from the images, then the reduction's products.
    img = torch.cat([da1c, doc], -1)[:M].reshape(B, L, L, hid + cz)
    s_i, s_j = img.sum(2).reshape(B * L, -1), img.sum(1).reshape(B * L, -1)
    w1t, w3t = rnd(ops["w1t"]), rnd(ops["w3t"])
    d_node = (s_i[:, :hid] @ w1t[:, cz:2 * cz] + s_i[:, hid:] @ w3t[:, cz:2 * cz]
              + s_j[:, :hid] @ w1t[:, 2 * cz:] + s_j[:, hid:] @ w3t[:, 2 * cz:])
    grads["k1"] = torch.cat([slots(e, da1c), node.t() @ s_i[:, :hid], node.t() @ s_j[:, :hid]])
    return d[:M].reshape(B, L, L, cz), d_node.reshape(B, L, cz), grads


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def plain_with_masks(edge, nb, mask, p, g, m1=None, m2=None, eps=1e-5):
    """``edge_transition_bwd_plain``'s arithmetic step for step, with its
    ReLU masks a1 > 0 and a2 > 0 replaced by m1 and m2 where given; also
    returns a1 and a2. Without masks it gives the plain version's bits."""
    cz, cb = edge.shape[-1], nb.shape[-1]
    B, L = edge.shape[:2]
    e, n = rnd(edge), rnd(nb)
    k1, k2, k3 = (rnd(p[k]) for k in ("k1", "k2", "k3"))
    x = torch.cat([e, n[:, :, None].expand(B, L, L, cb), n[:, None].expand(B, L, L, cb)], -1)
    a1 = x @ k1 + p["b1"].float()
    m1 = a1 > 0 if m1 is None else m1
    h1c = rnd(a1 * m1)
    a2 = h1c @ k2 + p["b2"].float()
    m2 = a2 > 0 if m2 is None else m2
    rc = rnd(a2 * m2 + x)
    o = rc @ k3 + p["b3"].float()
    mu = o.mean(-1, keepdim=True)
    inv = torch.rsqrt((o - mu).square().mean(-1, keepdim=True) + eps)
    y = (o - mu) * inv
    m = mask.float()
    g_out = g.float() * (m[:, :, None] * m[:, None, :])[..., None]
    dy = g_out * p["ln_scale"].float()
    do = (dy - dy.mean(-1, keepdim=True) - y * (dy * y).mean(-1, keepdim=True)) * inv
    doc = rnd(do)
    dr = doc @ k3.t()
    da2 = dr * m2
    da2c = rnd(da2)
    da1 = (da2c @ k2.t()) * m1
    da1c = rnd(da1)
    dx = da1c @ k1.t() + dr
    flat = lambda t: t.reshape(-1, t.shape[-1])
    grads = {"k1": flat(x).t() @ flat(da1c), "b1": flat(da1).sum(0),
             "k2": flat(h1c).t() @ flat(da2c), "b2": flat(da2).sum(0),
             "k3": flat(rc).t() @ flat(doc), "b3": flat(do).sum(0),
             "ln_scale": flat(g_out * y).sum(0), "ln_bias": flat(g_out).sum(0)}
    d_node = dx[..., cz:cz + cb].sum(2) + dx[..., cz + cb:].sum(1)
    return (dx[..., :cz], d_node, grads), a1, a2


@pytest.mark.parametrize("cz,B,L", [(128, 2, 13), (128, 2, 16), (512, 1, 6)])
def test_bwd_schedule_matches_plain(cz, B, L):
    """The emulation against the plain version: every gradient within 3e-4
    of its norm. The kernels' first layer is factorized, so a hidden
    activation within fp32 order of 0 may take the other sign than in the
    plain version's single product, and with it a ReLU mask bit (at these
    inputs one a2 entry of 196,608 at L = 16, |a2| ~ 1e-4), which moves the
    gradients by O(1e-3): every such flip must be a tie (|a| <= 1e-3 in the
    plain version), and the reference is the plain version's arithmetic
    with the emulation's masks (the plain version's own bits where they
    agree)."""
    edge, nb, mask, p, g = _inputs(cz, B, L, cz + L)
    ops = cuda_edge.kernel_operands(p)
    trace = {}
    d_edge, d_node, grads = fused_backward(edge, nb, mask, ops, g, trace=trace)
    plain = cuda_edge.edge_transition_bwd_plain(edge, nb, mask, p, g, bf)
    own, a1, a2 = plain_with_masks(edge, nb, mask, p, g)
    for x, y in zip(plain[:2] + tuple(plain[2].values()), own[:2] + tuple(own[2].values())):
        assert torch.equal(x, y)
    m1, m2 = trace["a1"] > 0, trace["a2"] > 0
    for a, m in ((a1, m1), (a2, m2)):
        flips = m != (a > 0)
        assert bool((a[flips].abs() <= 1e-3).all()) and int(flips.sum()) <= 2
    (w_edge, w_node, w_grads), _, _ = plain_with_masks(edge, nb, mask, p, g, m1, m2)
    assert _rel(d_edge, w_edge) <= 3e-4 and _rel(d_node, w_node) <= 3e-4
    for k in cuda_edge.PARAM_NAMES:
        assert grads[k].shape == w_grads[k].shape, k
        assert _rel(grads[k], w_grads[k]) <= 3e-4, k


def test_node_sum_identity():
    """d_node from the per-residue sums of da1 and do (the reduction's
    products) against dx = da1.W1^T + do.W3^T summed pair by pair over j
    and over i, and dW1's node rows node^T.S against x^T.da1 over the
    pairs: the same values, summed in another fp32 order."""
    cz, B, L = 128, 2, 13
    hid = 3 * cz
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    da1c, doc = rnd(f(B, L, L, hid)), rnd(f(B, L, L, cz))
    k1, k3 = rnd(f(hid, hid) * hid ** -0.5), rnd(f(hid, cz) * hid ** -0.5)
    node = rnd(f(B, L, cz))
    dx = da1c @ k1.t() + doc @ k3.t()
    want = dx[..., cz:2 * cz].sum(2) + dx[..., 2 * cz:].sum(1)
    s_i, s_j = da1c.sum(2), da1c.sum(1)
    t_i, t_j = doc.sum(2), doc.sum(1)
    got = (s_i @ k1[cz:2 * cz].t() + t_i @ k3[cz:2 * cz].t()
           + s_j @ k1[2 * cz:].t() + t_j @ k3[2 * cz:].t())
    assert _rel(got, want) <= 1e-5
    x = torch.cat([node[:, :, None].expand(B, L, L, cz), node[:, None].expand(B, L, L, cz)], -1)
    flat = lambda t: t.reshape(-1, t.shape[-1])
    want = flat(x).t() @ flat(da1c)
    n = flat(node)
    got = torch.cat([n.t() @ flat(s_i), n.t() @ flat(s_j)])
    assert _rel(got, want) <= 1e-5


def test_bwd_stage_packing():
    """Every stage of wbb unswizzles to the weight blocks wide_bwd_stages
    names; the count is the chain kernel's (ebwd::Cfg::N_MAIN = 2 NC KE + NJ
    KE + 2 NC (KH + 2 NJ)); the int8 profile packs none."""
    for cz in (128, 256, 512):
        hid, nj, ke, kh, nc = 3 * cz, cz // 128, cz // 64, 3 * cz // 64, 3 * cz // 128
        edge, nb, mask, p, _ = _inputs(cz, 1, 2, cz)
        ops = cuda_edge.kernel_operands(p)
        stages = cuda_edge.wide_bwd_stages(cz)
        n_main = 2 * nc * ke + nj * ke + 2 * nc * (kh + 2 * nj)
        assert len(stages) == n_main and ops["wbb"].numel() == n_main * cuda_edge.STAGE
        k1, k2, k3 = (p[f"k{k}"].to(bf) for k in ("1", "2", "3"))
        mats = {"w1e": ops["w1t"][:, :cz], "w2": ops["w2t"], "w3": ops["w3t"], "k3": k3, "k2": k2,
                "k1e": k1[:cz]}
        ring = Stages(ops["wbb"])
        for name, (n0, n1), k in stages:
            for n, got in zip((n0, n1), ring.take(bf)):
                want = mats[name][64 * n:64 * n + 64, 64 * k:64 * k + 64].float()
                assert torch.equal(got, want), (cz, name, n, k)
        assert "wbb" not in cuda_edge.kernel_operands(p, quant_int8=True)
