"""The wide EdgeTransition forwards' tile schedule (K1/K2 and K6 at c_z = 128,
256, 512: csrc/edge_wide.cuh behind edge_transition.cu's and
edge_transition_int8.cu's ``*_wide_forward``), emulated in plain PyTorch on
the CPU.

The CUDA kernel cannot run here, so :func:`fused_forward` repeats what it
computes, in its order, from the operands ``kernel_operands`` packs: the
node pre-pass Y = node.wn^T in fp32; then, for every 64-row tile (all tiles
at once: the schedule is the same for each, and the last tile's rows past
B L^2 are zeros that are never stored), the ring's stages one after another as
``wb`` holds them, each stage's two 8 KB pieces unswizzled
(:func:`unpack_piece`) and multiplied into the two consumer warpgroups'
64-column halves:

- layer 1 chunk by chunk of 128 hidden columns, h1 = relu(((e.W1e + Y1_i) +
  Y1_j) + b1), rounded to bf16 into the h1 panels (K1/K2); for K6 kept fp32
  until each row's amax over all 3 c_z columns is known (the maximum of the
  two warpgroups' maxima): staged at c_z 128, at 256 and 512 the chunk
  products twice, the second pass giving the same bits, then quantized into
  q1;
- o = e.W3e, each warpgroup its half of o's columns (K6: a 64-column block
  of o at a time, just before its q2.W3q);
- K1/K2: for each 128-column chunk of h2, acc = h1.W2 over the hidden width,
  h2 = bf16(relu(acc + b2)), o += h2_chunk.W3 over the chunk's two panels,
  h2 never whole; K6: h2 = relu(float(q1.W2q) s1 w2s + b2) staged in fp32
  (shared memory at 128, a global slot at 256 and 512: the same values), its
  row amax, q2, o = float(q2.W3q) s2 w3s + o a 64-column block at a time;
- ((o + Y3_i) + Y3_j) + b3, the LayerNorm with each row's sums taken as
  warpgroup 0's half plus warpgroup 1's, the pair mask, bf16 out, and the
  readout from bf16(out) in pairs of 64-lane blocks, stored transposed.

Checks: the emulation at c_z 128 and 512 (B = 2, L = 13: 338 pair rows, a
ragged last tile of 18) against ``edge_transition_plain`` (readout on and
off) and ``edge_transition_int8_plain`` (readout on), bf16 outputs within
1e-2 (tests/test_torch_widths_tiles.py's bound: a hidden activation whose
fp32 sum, taken in another order, rounds to the other bf16 neighbour moves
an output by about one bf16 step, 4e-3 at |x| ~ 1) and 2^-7 of their
magnitude (one bf16 step at any magnitude: an output whose own fp32 sum lies
at a rounding boundary, as the readouts' of up to |x| ~ 10 may); K6's int8
values, row scales and int32 sums against the plain version's exactly away
from half-level ties (tests/test_torch_widths_ipa.py's rule); and at c_z 128
against the JAX kernel ``fused_edge_transition`` in interpret mode, bf16 at
the same bound, int8 under the tie rule. The packing itself: each stage's
pieces unswizzle to the weight blocks the schedule names, and the stage
counts are those the kernel's producer copies (edge_wide.cuh
``Cfg::N_MAIN``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.pallas_edge import fused_edge_transition as jax_edge

from pepflowww_torch.models import cuda_edge

from test_torch_widths_ipa import _near_tie_rows

torch.set_num_threads(1)
bf = torch.bfloat16
rnd = lambda t: t.to(bf).float()
TM = 64


def _inputs(cz, B, L, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    hid = 3 * cz
    p = {"k1": f(hid, hid, sc=0.05), "b1": f(hid, sc=0.1), "k2": f(hid, hid, sc=0.05),
         "b2": f(hid, sc=0.1), "k3": f(hid, cz, sc=0.05), "b3": f(cz, sc=0.1),
         "ln_scale": 1 + f(cz, sc=0.1), "ln_bias": f(cz, sc=0.1)}
    readout = (f(cz, 8, sc=0.1), f(8), f(cz, cz // 4, sc=0.1), f(cz // 4))
    mask = (rng.random((B, L)) > 0.1).astype(np.float32)
    return f(B, L, L, cz), f(B, L, cz), mask, p, readout


def _torch(edge, nb, mask, p, readout):
    T = torch.from_numpy
    return (T(edge).to(bf), T(nb).to(bf), T(mask), {k: T(v) for k, v in p.items()},
            tuple(T(x) for x in readout))


def unpack_piece(piece, dtype):
    """The 64 x 128-byte block that ``cuda_edge.wide_pieces`` packed into
    `piece`, as 64 rows of `dtype` (the swizzle undone)."""
    r = torch.arange(64).reshape(64, 1)
    dst = torch.arange(8).reshape(1, 8) ^ (r % 8)
    t = piece.reshape(64, 8, 16)
    return torch.gather(t, 1, dst[:, :, None].expand(64, 8, 16)).reshape(64, 128).view(dtype)


class Stages:
    """The ring as the consumers see it: each take() is the next stage of
    `blob` as the two warpgroups' 64-row blocks of `dtype`."""

    def __init__(self, blob):
        self.blob, self.at = blob.reshape(-1, cuda_edge.STAGE), 0

    def take(self, dtype):
        img = self.blob[self.at]
        self.at += 1
        return [unpack_piece(img[w * cuda_edge.PIECE:(w + 1) * cuda_edge.PIECE], dtype).float()
                for w in (0, 1)]


def _quant(h):
    """Row amax, inv = 127/amax (0 for a zero row), round-half-even, scale."""
    amax = h.abs().amax(-1, keepdim=True)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    return torch.round(h * inv), amax / 127.0


def fused_forward(edge, nb, mask, ops, readout, quant_int8=False, eps=1e-5, trace=None):
    """The wide tile kernel's arithmetic in its order (see the top of this
    file). `trace`, a dict, receives K6's q1, s1, q2, s2 and int32 sums."""
    B, L, _, cz = edge.shape
    hid, M = 3 * cz, B * L * L
    nj, ke, nc = cz // 128, cz // 64, hid // 128
    kh = hid // 128 if quant_int8 else hid // 64
    kw = 128 if quant_int8 else 64          # K of a hidden panel
    Mp = -(-M // TM) * TM
    r = torch.arange(Mp).clamp(max=M - 1)   # rows past M read residue 0's terms
    ri, rj = r // L, (r // (L * L)) * L + r % L
    Y = rnd(nb).reshape(B * L, cz) @ rnd(ops["wn"]).t()
    e = torch.zeros(Mp, cz)
    e[:M] = rnd(edge).reshape(M, cz)
    ring = Stages(ops["wb"])
    panel = lambda x, k, w=64: x[:, k * w:(k + 1) * w]

    def product(a_panel, nk, dtype, acc=None):
        """The two warpgroups' m64n64 products over the next nk stages, side
        by side: each warpgroup's K blocks gathered from the stages and
        multiplied at once (the tensor cores' own order of the fp32 sums is
        not reproducible here; int8 sums are exact)."""
        blocks = [ring.take(dtype) for _ in range(nk)]
        a = torch.cat([a_panel(k) for k in range(nk)], -1)
        out = []
        for w in (0, 1):
            b = torch.cat([blk[w] for blk in blocks], -1)
            if dtype == torch.int8:
                out.append(a.double() @ b.double().t())
            else:
                out.append(a @ b.t() if acc is None else acc[w] + a @ b.t())
        return out

    def layer1():
        h = torch.empty(Mp, hid)
        for c in range(nc):
            acc = product(lambda k: panel(e, k), ke, bf)
            for w in (0, 1):
                cols = slice(128 * c + 64 * w, 128 * c + 64 * w + 64)
                yj = Y[rj, hid + cols.start:hid + cols.stop]
                h[:, cols] = torch.relu(acc[w] + Y[ri, cols] + yj + ops["b1"][cols])
        return h

    if quant_int8:
        h1 = layer1()
        if cz > 128:   # the second pass: the same products, the same bits
            assert torch.equal(h1, layer1())
        q1, s1 = _quant(h1)
    else:
        h1 = rnd(layer1())
    # o = e.W3e: warpgroup w's blocks j hold o's columns w c_z/2 + 64 j (K6:
    # each block just before its q2.W3q).
    o = torch.empty(Mp, cz)
    blk = lambda w, j: slice(w * cz // 2 + 64 * j, w * cz // 2 + 64 * j + 64)

    def e_w3e(j):
        acc = product(lambda k: panel(e, k), ke, bf)
        for w in (0, 1):
            o[:, blk(w, j)] = acc[w]

    if not quant_int8:
        for j in range(nj):
            e_w3e(j)
    if quant_int8:
        h2 = torch.empty(Mp, hid)
        sums2 = torch.empty(Mp, hid, dtype=torch.float64)
        for c in range(nc):
            acc = product(lambda k: panel(q1, k, 128), kh, torch.int8)
            for w in (0, 1):
                cols = slice(128 * c + 64 * w, 128 * c + 64 * w + 64)
                sums2[:, cols] = acc[w]
                h2[:, cols] = torch.relu(acc[w].float() * s1 * ops["w2s"][cols] + ops["b2"][cols])
        q2, s2 = _quant(h2)
        sums3 = torch.empty(Mp, cz, dtype=torch.float64)
        for j in range(nj):
            e_w3e(j)
            acc = product(lambda k: panel(q2, k, 128), kh, torch.int8)
            for w in (0, 1):
                sums3[:, blk(w, j)] = acc[w]
                o[:, blk(w, j)] = acc[w].float() * s2 * ops["w3s"][blk(w, j)] + o[:, blk(w, j)]
        if trace is not None:
            trace.update(q1=q1[:M], s1=s1[:M], q2=q2[:M], s2=s2[:M], sums2=sums2[:M],
                         sums3=sums3[:M])
    else:
        for c in range(nc):
            acc = product(lambda k: panel(h1, k, kw), kh, bf)
            chunk = torch.empty(Mp, 128)
            for w in (0, 1):
                cols = slice(128 * c + 64 * w, 128 * c + 64 * w + 64)
                chunk[:, 64 * w:64 * w + 64] = rnd(torch.relu(acc[w] + ops["b2"][cols]))
            for j in range(nj):
                acc = product(lambda k: panel(chunk, k), 2, bf,
                              acc=[o[:, blk(0, j)], o[:, blk(1, j)]])
                for w in (0, 1):
                    o[:, blk(w, j)] = acc[w]
    assert ring.at == ring.blob.shape[0], "the kernel takes every stage of wb"
    o = o + Y[ri, 2 * hid:2 * hid + cz] + Y[rj, 2 * hid + cz:] + ops["b3"]
    half = lambda x: x[:, :cz // 2].sum(-1, keepdim=True) + x[:, cz // 2:].sum(-1, keepdim=True)
    oc = o - half(o) / cz
    rs = torch.rsqrt(half(oc * oc) / cz + eps)
    m = mask.reshape(-1)
    out = rnd((oc * rs * ops["ln_scale"] + ops["ln_bias"]) * (m[ri] * m[rj])[:, None])
    outs = out[:M].reshape(B, L, L, cz)
    if readout is None:
        return outs
    ring = Stages(ops["wrb"])
    lanes, n_b, n_pz = ops["wrt"].shape[0], ops["n_b"], ops["n_pz"]
    v = torch.empty(Mp, 128 * (-(-lanes // 128)))
    for rp in range(-(-lanes // 128)):
        acc = product(lambda k: panel(out, k), ke, bf)
        for w in (0, 1):
            v[:, 128 * rp + 64 * w:128 * rp + 64 * w + 64] = acc[w]
    assert ring.at == ring.blob.shape[0], "the kernel takes every stage of wrb"
    v = rnd(v[:M, :n_b + n_pz] + ops["bro"][:n_b + n_pz])
    v = v.reshape(B, L, L, -1).permute(0, 3, 1, 2)
    return outs, v[:, :n_b], v[:, n_b:]


def _close(got, want, names=("out", "b", "pz")):
    """bf16 outputs within 1e-2 and one bf16 step at their magnitude (2^-7
    of it): the readouts reach |x| ~ 10 here, where one step is 6e-2."""
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2, rtol=2 ** -7, msg=name)


@pytest.mark.parametrize("cz", [128, 512])
def test_fused_schedule_matches_plain(cz):
    edge, nb, mask, p, ro = _torch(*_inputs(cz, 2, 13, cz + 3))
    for readout in (None, ro):
        ops = cuda_edge.kernel_operands(p, readout)
        got = fused_forward(edge, nb, mask, ops, readout)
        want = cuda_edge.edge_transition_plain(edge, nb, mask, p, bf, readout)
        _close((got,) if readout is None else got, (want,) if readout is None else want)


def _plain_int8_trace(edge, nb, p):
    """The plain version's int8 values, scales and int32 sums (its own
    arithmetic, ``edge_transition_int8_plain``)."""
    cz = edge.shape[-1]
    e, n = rnd(edge), rnd(nb)
    k1 = rnd(p["k1"])
    y_i, y_j = cuda_edge._node_terms(n, k1, cz)
    h = torch.relu(e @ k1[:cz] + y_i + y_j + p["b1"])
    q1, s1 = cuda_edge.quant_rows(h)
    w2q, w2s = cuda_edge.quant_cols(p["k2"])
    sums2 = q1.double() @ w2q.double()
    q2, s2 = cuda_edge.quant_rows(torch.relu(sums2.float() * s1 * w2s + p["b2"]))
    w3q, _ = cuda_edge.quant_cols(p["k3"])
    flat = lambda t: t.reshape(-1, t.shape[-1])
    return {"q1": flat(q1).float(), "s1": flat(s1), "q2": flat(q2).float(), "s2": flat(s2),
            "sums2": flat(sums2), "sums3": flat(q2.double() @ w3q.double())}


def _ties(edge, nb, raw_p):
    """Pair rows (flattened) near a half-level tie of h1 or h2, from the
    bf16 operands the kernels multiply (k1 rounded, k2 quantized from its
    fp32 values): within 1e-3 of a level, since the fp32 sums of the plain
    version, the JAX kernel and the kernel's K panels differ by ~1e-4 of a
    level."""
    tp = dict(raw_p, k1=rnd(torch.from_numpy(raw_p["k1"])).numpy())
    return torch.from_numpy(_near_tie_rows(rnd(edge).numpy(), rnd(nb).numpy(), tp,
                                           tol=1e-3)).reshape(-1)


@pytest.mark.parametrize("cz", [128, 512])
def test_fused_int8_schedule_matches_plain(cz):
    raw = _inputs(cz, 2, 13, cz + 5)
    edge, nb, mask, p, ro = _torch(*raw)
    ops = cuda_edge.kernel_operands(p, ro, quant_int8=True)
    trace = {}
    got = fused_forward(edge, nb, mask, ops, ro, quant_int8=True, trace=trace)
    want = cuda_edge.edge_transition_int8_plain(edge, nb, mask, p, bf, ro)
    # The int8 levels are the plain version's except in rows at a half-level
    # tie, where the two fp32 sums may round an entry to its two
    # neighbouring levels; the int32 sums follow from the levels.
    plain = _plain_int8_trace(edge, nb, p)
    differ = ((trace["q1"] != plain["q1"]).any(-1) | (trace["q2"] != plain["q2"]).any(-1))
    assert not (differ & ~_ties(edge, nb, raw[3])).any(), torch.nonzero(differ)
    assert int(differ.sum()) <= 0.02 * differ.numel()
    same = ~differ
    for k in ("sums2", "sums3"):
        assert torch.equal(trace[k][same], plain[k][same]), k
    for k in ("s1", "s2"):
        torch.testing.assert_close(trace[k], plain[k], rtol=1e-5, atol=0, msg=k)
    _close(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_fused_schedule_matches_jax_kernel(int8):
    """At c_z 128 (B 2, L 13) against the JAX kernel in interpret mode
    with the bf16 compute dtype, readout on."""
    raw = _inputs(128, 2, 13, 11 + int8)
    edge, nb, mask, p, ro = _torch(*raw)
    jx = lambda a: jnp.asarray(np.asarray(a))
    want = jax_edge(jx(rnd(edge)), jx(rnd(nb)), jx(mask), {k: jx(v) for k, v in raw[3].items()},
                    dtype=jnp.bfloat16, quant_int8=int8, interpret=True,
                    readout=tuple(jx(x) for x in raw[4]))
    ops = cuda_edge.kernel_operands(p, ro, quant_int8=int8)
    got = fused_forward(edge, nb, mask, ops, ro, quant_int8=int8)
    want = [torch.from_numpy(np.array(w.astype(jnp.float32))) for w in want]
    want[1:] = [w.reshape(w.shape[0], w.shape[1], 13, 13) for w in want[1:]]
    if not int8:
        _close(got, want)
        return
    # Per pair row, the largest error of out and of the readouts.
    err = (got[0] - want[0]).abs().amax(-1)
    for a, b in zip(got[1:], want[1:]):
        err = torch.maximum(err, (a - b).abs().amax(1))
    beyond = (err > 1e-2).reshape(-1)
    assert not (beyond & ~_ties(edge, nb, raw[3])).any(), torch.nonzero(beyond)
    assert int(beyond.sum()) <= 0.02 * beyond.numel()
    assert float(err.max()) < 5e-2


def test_stage_packing():
    """Every stage's pieces unswizzle to the blocks wide_stages names; the
    counts are the kernel's (edge_wide.cuh Cfg::N_MAIN, the readout's nrp
    KE); the blocks past the readout's lanes are zeros."""
    for cz in (128, 256, 512):
        edge, nb, mask, p, ro = _torch(*_inputs(cz, 1, 2, cz))
        hid, nj, ke, nc = 3 * cz, cz // 128, cz // 64, 3 * cz // 128
        for int8 in (False, True):
            ops = cuda_edge.kernel_operands(p, ro, quant_int8=int8)
            kh = hid // 128 if int8 else hid // 64
            n_main = ((1 if cz == 128 else 2) * nc * ke + nj * ke + nc * kh + nj * kh if int8
                      else nc * ke + nj * ke + nc * (kh + 2 * nj))
            stages = cuda_edge.wide_stages(cz, int8)
            assert len(stages) == n_main and ops["wb"].numel() == n_main * cuda_edge.STAGE
            mats = {"w1e": ops["w1t"][:, :cz], "w3e": ops["w3t"][:, :cz],
                    "w2": ops.get("w2t"), "w3": ops["w3t"], "w2q": ops.get("w2qt"),
                    "w3q": ops.get("w3qt")}
            ring = Stages(ops["wb"])
            for name, (n0, n1), k in stages:
                dt = torch.int8 if name in ("w2q", "w3q") else bf
                kw = 128 if dt == torch.int8 else 64
                got = ring.take(dt)
                for n, g in zip((n0, n1), got):
                    want = mats[name][64 * n:64 * n + 64, kw * k:kw * (k + 1)].float()
                    assert torch.equal(g, want), (cz, int8, name, n, k)
            lanes = ops["wrt"].shape[0]
            ring = Stages(ops["wrb"])
            assert ops["wrb"].numel() == -(-lanes // 128) * ke * cuda_edge.STAGE
            for _, (n0, n1), k in cuda_edge.readout_stages(cz, lanes):
                for n, g in zip((n0, n1), ring.take(bf)):
                    want = (ops["wrt"][64 * n:64 * n + 64, 64 * k:64 * k + 64].float()
                            if 64 * n < lanes else torch.zeros(64, 64))
                    assert torch.equal(g, want)
