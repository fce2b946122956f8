"""The port's v1 IPA attention core (K9's module, ``cuda_ipa1``) against the
JAX package's ``pallas_ipa``.

At the fixture dims of tests/test_pallas.py (B=2, L=16, H 4, C 32, Pq 4,
Pv 6, CZ4 8; float32; about 15% of the keys masked) the plain version and
the wrappers (which take it on the CPU) are held to
``ipa_attention_reference`` and to both Pallas grid variants in interpret
mode at rtol/atol 1e-4, as tests/test_pallas.py holds the kernels; the
autograd Function's gradients to ``jax.grad`` through
``fused_ipa_attention_vjp`` at rtol 1e-3, atol 1e-4. With bf16 scalar
inputs the scalar output is made from the weights rounded to bf16 on both
sides: held at 1e-4 + 1e-3 |ref| (a weight that rounds the other way moves
one term by 2^-9 of it). The CUDA kernel is held against the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.pallas_ipa import (fused_ipa_attention, fused_ipa_attention_bh,
                                             fused_ipa_attention_vjp, ipa_attention_reference)

from pepflowww_torch.models import cuda_ipa1

torch.set_num_threads(1)
NAMES = ("o", "o_pt", "o_pair")


def _inputs(seed=3):
    """tests/test_pallas.py::ipa_inputs, as numpy arrays."""
    B, L, H, C, Pq, Pv, CZ4 = 2, 16, 4, 32, 4, 6, 8
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    args = [mk(B, H, L, C), mk(B, H, L, C), mk(B, H, L, C), mk(B, H, L, Pq * 3),
            mk(B, H, L, Pq * 3), mk(B, H, L, Pv * 3), mk(B, H, L, L), mk(B, L, L, CZ4)]
    mask = (rng.random((B, L)) > 0.15).astype(np.float32)
    assert 0 < mask.sum() < mask.size
    return args + [mask]


def _loss_jax(o, opt, opair):
    return jnp.sum(o ** 2) + jnp.sum(opt * 0.5) + jnp.sum(jnp.sin(opair))


def test_plain_and_wrappers_match_jax_reference_and_kernels():
    args = _inputs()
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    refs = {"reference": ipa_attention_reference(*jargs),
            "kernel": fused_ipa_attention(*jargs, interpret=True),
            "kernel_bh": fused_ipa_attention_bh(*jargs, interpret=True)}
    ours = {"plain": cuda_ipa1.ipa_attention_plain(*targs),
            "fused": cuda_ipa1.fused_ipa_attention(*targs),
            "fused_bh": cuda_ipa1.fused_ipa_attention_bh(*targs)}
    for rname, ref in refs.items():
        for oname, out in ours.items():
            for name, a, b in zip(NAMES, out, ref):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                           err_msg=f"{oname} vs {rname}: {name}")


def test_bf16_inputs_round_the_scalar_weights_as_jax():
    args = _inputs(seed=4)
    bf = [0, 1, 2, 6, 7]   # q, k, v, bias, pair_z in bf16; points and mask float32
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) if i in bf else jnp.asarray(a)
             for i, a in enumerate(args)]
    targs = [torch.from_numpy(a).bfloat16() if i in bf else torch.from_numpy(a)
             for i, a in enumerate(args)]
    want = ipa_attention_reference(*jargs)
    got = cuda_ipa1.ipa_attention_plain(*targs)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=name)


def test_function_gradients_match_jax_vjp():
    """IPAAttentionFn's backward (a recompute through the plain version)
    against jax.grad of fused_ipa_attention_vjp (interpret) for all eight
    differentiable inputs; the mask gets no gradient."""
    args = _inputs()
    jargs = [jnp.asarray(a) for a in args]
    want = jax.grad(lambda *a: _loss_jax(*fused_ipa_attention_vjp(*a, 1e5, True)),
                    argnums=tuple(range(8)))(*jargs)
    leaves = [torch.tensor(a, requires_grad=i < 8) for i, a in enumerate(args)]
    o, opt, opair = cuda_ipa1.IPAAttentionFn.apply(*leaves, 1e5)
    (o.square().sum() + (opt * 0.5).sum() + opair.sin().sum()).backward()
    for i, (x, w) in enumerate(zip(leaves[:8], want)):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4,
                                   err_msg=f"input {i}")
    assert leaves[8].grad is None


def test_wrappers_refuse_autograd():
    """The bare wrappers write results that autograd cannot follow: under
    grad mode with an input that requires grad they raise; under no_grad
    they run."""
    leaves = [torch.tensor(a, requires_grad=i == 0) for i, a in enumerate(_inputs())]
    for fn in (cuda_ipa1.fused_ipa_attention, cuda_ipa1.fused_ipa_attention_bh):
        with pytest.raises(RuntimeError, match="IPAAttentionFn"):
            fn(*leaves)
        with torch.no_grad():
            assert fn(*leaves)[0].shape == (2, 4, 16, 32)
