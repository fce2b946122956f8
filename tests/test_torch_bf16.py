"""The port's bf16 production profile against the JAX package's bf16 model.

Weights: the nb=2 golden state dict (``sd::`` of
tests/golden/model_parity.npz) with seeded N(0, 0.02) noise added in numpy
to every learned parameter (not to the ``freq_bands`` buffers, which are
constants in the JAX model), the same arrays on both sides. The golden's
reference init zeroes the IPA output, transition and backbone-update
layers, which would make the rotations and translations of a denoise pass
equal its inputs on both sides whatever the trunk computed.

The port runs ``FlowModel(dtype=bfloat16, use_pallas=True)`` on the CPU,
where its kernels take their plain versions (K2 with the readout epilogue);
JAX runs ``FlowModel(dtype=bfloat16, use_pallas=True)`` with its Pallas
kernels in interpret mode. Measured gaps (max abs, this batch): encode node
9.8e-4, edge 3.9e-3; denoise at t=0.5 rotations 7.2e-3, translations
4.1e-3 Å, angles 1.8e-3 rad, logits 2.7e-3. With ``use_pallas`` off on both
sides (JAX then rounds the coordinates to bf16 before d², the port keeps
them fp32): edge 2.0e-3, rotations 7.2e-3, translations 4.9e-3, angles
2.2e-3, logits 2.5e-3. The tolerances below are about three times those,
and far inside tests/test_bf16.py's bf16-against-fp32 bounds (translations
0.5, rotations 0.1, logits 0.5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig

from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.trunk import IPAConfig

torch.set_num_threads(2)

ENCODE_TOL = {"node": 4e-3, "edge": 1.6e-2}
DENOISE_TOL = {"rot": 2e-2, "trans": 1.5e-2, "angles": 1e-2, "logits": 1e-2}


@pytest.fixture(scope="module")
def setup(golden):
    g = golden("model_parity")
    nb = int(g["num_blocks"])
    rng = np.random.default_rng(5)
    sd = {}
    for k in sorted(f for f in g.files if f.startswith("sd::")):
        v = np.asarray(g[k], np.float32)
        if not k.endswith("freq_bands"):
            v = (v + 0.02 * rng.standard_normal(v.shape)).astype(np.float32)
        sd[k[4:]] = v
    params = convert_state_dict(sd, num_blocks=nb, seq_tfmr_num_layers=2)
    batch = {k[6:]: np.asarray(g[k]) for k in g.files if k.startswith("batch_")}
    return nb, sd, params, batch


def _port(nb, sd, use_pallas):
    cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=nb, dtype="bfloat16", use_pallas=use_pallas))
    return build_model(cfg, "cpu", state_dict=sd)


def _circle(d):
    return np.arctan2(np.sin(d), np.cos(d))


def test_bf16_params_stay_fp32(setup):
    nb, sd, _, _ = setup
    model = _port(nb, sd, True)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
    assert model.cfg.ipa.compute_dtype == torch.bfloat16


def test_bf16_encode_and_denoise_match_jax_bf16(setup):
    """Encode, then one denoise at t=0.5 from each side's own encode, with
    the kernels (JAX Pallas in interpret mode, the port's plain versions)
    and without them."""
    nb, sd, params, batch = setup
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    B = batch["aa"].shape[0]
    for use_pallas in (True, False):
        jm = JaxFlowModel(JaxFlowModelConfig(ipa=JaxIPAConfig(
            num_blocks=nb, dtype="bfloat16", use_pallas=use_pallas)))
        jenc = jm.apply({"params": params}, jb, method="encode")
        want = jm.apply({"params": params}, jnp.full((B, 1), 0.5), *jenc, jb["generate_mask"],
                        jb["res_mask"], method="denoise", fused_pair_readout=use_pallas)
        model = _port(nb, sd, use_pallas)
        with torch.no_grad():
            enc = model.encode(tb)
            got = model.denoise(torch.full((B, 1), 0.5), *enc, tb["generate_mask"],
                                tb["res_mask"], fused_pair_readout=use_pallas)
        tag = f"use_pallas={use_pallas}"
        for name, a, b in zip(("node", "edge"), enc[4:], jenc[4:]):
            gap = np.abs(a.float().numpy() - np.asarray(b, np.float32)).max()
            assert gap <= ENCODE_TOL[name], (tag, name, gap)
        for name, a, b in zip(("rot", "trans", "angles", "logits"), got, want):
            d = a.float().numpy() - np.asarray(b, np.float32)
            gap = np.abs(_circle(d) if name == "angles" else d).max()
            assert gap <= DENOISE_TOL[name], (tag, name, gap)


def test_bf16_loss_finite(setup):
    nb, sd, _, batch = setup
    model = _port(nb, sd, True).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = model.loss(tb, torch.Generator().manual_seed(1))
    assert set(losses) == {"trans_loss", "rot_loss", "bb_atom_loss", "seqs_loss", "angle_loss",
                           "torsion_loss"}
    total = sum(losses.values())
    total.backward()
    for name, v in losses.items():
        assert np.isfinite(float(v.detach())), name
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters() if p.requires_grad)
