"""The port's int8 serving profile (``quant_int8``: the EdgeTransition's two
hidden-width products in int8, K6's module) against the JAX package.

The plain version of the int8 kernel (``cuda_edge.edge_transition_int8_plain``)
is held to the JAX kernel ``fused_edge_transition(quant_int8=True)`` in
interpret mode at tests/test_pallas.py's setup dims (B=2, L=32, noisy weights
so that k3 is not zero): in float32 at 1e-5 (both compute the same integer
products exactly and the rest in float32 in another order); in bf16 at one
bf16 step of O(1) outputs (rtol 8e-3 + atol 1.6e-2), with a mean abs error
<= 1e-5 (an output rounds the other way only where float32 sums in another
order straddle a bf16 rounding boundary). The quantizers are exact. The
denoise pass of the profile is held to JAX's at the denoise tolerance, 5e-3.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.pallas_edge import _quant_cols, _quant_rows
from pepflowww_tpu.models.pallas_edge import fused_edge_transition as jax_fused
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig

from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.models import cuda_edge
from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.ipa import EdgeTransition
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.sample import main as sample_main
from pepflowww_torch.train import main as train_main

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L, CZ, H, DZ = 2, 32, 64, 8, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    p = {"k1": f(192, 192, sc=0.1), "b1": f(192, sc=0.1), "k2": f(192, 192, sc=0.1),
         "b2": f(192, sc=0.1), "k3": f(192, CZ, sc=0.1), "b3": f(CZ, sc=0.1),
         "ln_scale": 1 + f(CZ, sc=0.1), "ln_bias": f(CZ, sc=0.1)}
    edge, node_bias = f(B, L, L, CZ), f(B, L, CZ)
    mask = (rng.random((B, L)) > 0.1).astype(np.float32)
    readout = (f(CZ, H, sc=0.1), f(H), f(CZ, DZ, sc=0.1), f(DZ))
    return edge, node_bias, mask, p, readout


def _sd(g):
    return {k[4:]: np.asarray(g[k], dtype=np.float32) for k in g.files if k.startswith("sd::")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_int8_kernel(dtype):
    edge, nb, mask, p, ro = _inputs()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for readout in (None, ro):
        want = jax_fused(jnp.asarray(edge), jnp.asarray(nb), jnp.asarray(mask), jp, dtype=jdt,
                         quant_int8=True, interpret=True,
                         readout=None if readout is None else tuple(map(jnp.asarray, readout)))
        got = cuda_edge.edge_transition_int8_plain(
            torch.from_numpy(edge), torch.from_numpy(nb), torch.from_numpy(mask), tp, tdt,
            None if readout is None else tuple(map(torch.from_numpy, readout)))
        if readout is None:
            got, want = (got,), (want,)
        for name, a, b in zip(("out", "b", "pz"), got, want):
            assert a.dtype == tdt, name
            a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, rtol=8e-3, atol=1.6e-2, err_msg=name)
                assert np.abs(a - b).mean() <= 1e-5, name


def test_quantizers_match_jax_exactly():
    """quant_rows / quant_cols against _quant_rows / _quant_cols, bit for
    bit: an all-zero row (and column) gets scale 0 and zeros, and values
    that land on .5 round to even, as jnp.round does."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(6, 192)).astype(np.float32)
    x[2] = 0.0
    x[3, :7] = [127.0, 2.5, 3.5, -0.5, -1.5, 126.5, 0.5]   # amax 127: inv 1, exact halves
    x[3, 7:] = 0.25
    q, s = cuda_edge.quant_rows(torch.from_numpy(x))
    jq, js = _quant_rows(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert list(q[3, :7]) == [127, 2, 4, 0, -2, 126, 0] and float(s[2]) == 0.0
    w = np.ascontiguousarray(x.T)
    q, s = cuda_edge.quant_cols(torch.from_numpy(w))
    jq, js = _quant_cols(jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_operands_from_flax_params_equal_jax(golden):
    """Flax parameters carried across by state_dict_from_flax give the
    kernel the same int8 weights and column scales as the JAX wrapper
    quantizes (from the float32 k2 and k3); the kernel's copies have their K
    axis permuted (cuda_edge.INT8_K_PERM), undone here."""
    g = golden("model_parity")
    nb = int(g["num_blocks"])
    params = convert_state_dict(_sd(g), num_blocks=nb, seq_tfmr_num_layers=2)
    flax_np = jax.tree_util.tree_map(np.asarray, params)
    sd = state_dict_from_flax(flax_np, num_blocks=nb)
    model = build_model(FlowModelConfig(ipa=IPAConfig(num_blocks=nb, dtype="bfloat16",
                                                      use_pallas=True, quant_int8=True)),
                        "cpu", state_dict=sd)
    ets = [m for m in model.modules() if isinstance(m, EdgeTransition)]
    assert len(ets) == nb - 1 and all(m.quant_int8 for m in ets)
    for b, m in enumerate(ets):
        with torch.no_grad():
            ops = cuda_edge.kernel_operands(m.params(), quant_int8=True)
        jp = params["ga_encoder"][f"edge_transition_{b}"]
        for k, layer in (("2", "Linear_2"), ("3", "Linear_3")):
            jq, js = _quant_cols(jp[layer]["Dense_0"]["kernel"])
            wqt = ops[f"w{k}qt"][:, torch.argsort(cuda_edge.INT8_K_PERM)]
            np.testing.assert_array_equal(wqt.t().numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ops[f"w{k}s"].numpy(), np.asarray(js).reshape(-1))


def test_denoise_int8_profile_matches_jax(golden):
    """fp32 denoise of the int8 profile (readout epilogue on, as the sampler
    runs it) through the kernels' plain versions against JAX
    FlowModel(use_pallas=True, quant_int8=True) with the Pallas kernels in
    interpret mode, at nb=2: 5e-3, the denoise tolerance."""
    g = golden("model_parity")
    nb = int(g["num_blocks"])
    sd = _sd(g)
    keys = ("t", "rotmats_t", "trans_t", "angles_t", "seqs_t", "node_embed", "edge_embed")
    jcfg = JaxFlowModelConfig(ipa=JaxIPAConfig(num_blocks=nb, use_pallas=True, quant_int8=True))
    params = convert_state_dict(sd, num_blocks=nb, seq_tfmr_num_layers=2)
    jb = {k[6:]: jnp.asarray(g[k]) for k in g.files if k.startswith("batch_")}
    want = JaxFlowModel(jcfg).apply({"params": params}, *[jnp.asarray(g[k]) for k in keys],
                                    jb["generate_mask"], jb["res_mask"], method="denoise",
                                    fused_pair_readout=True)
    model = build_model(FlowModelConfig(ipa=IPAConfig(num_blocks=nb, use_pallas=True,
                                                      quant_int8=True)), "cpu", state_dict=sd)
    with torch.no_grad():
        got = model.denoise(*[torch.from_numpy(np.asarray(g[k])) for k in keys],
                            torch.from_numpy(g["batch_generate_mask"]),
                            torch.from_numpy(g["batch_res_mask"]), fused_pair_readout=True)
    for name, a, b in zip(("rot", "trans"), got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-3, err_msg=name)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), atol=5e-3)
    d = got[2].numpy() - np.asarray(want[2])
    np.testing.assert_allclose(np.arctan2(np.sin(d), np.cos(d)), 0.0, atol=5e-3)


def _int8_yaml(tmp_path, num_blocks=2):
    with open(os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["encoder"]["ipa"].update(quant_int8=True, num_blocks=num_blocks)
    path = tmp_path / "int8.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_int8_profile_is_forward_only(tmp_path):
    """Under grad mode the int8 EdgeTransition raises (no backward, as in the
    JAX package), and so does a train CLI run with the int8 YAML: it does
    not fall back to a bf16 step. quant_int8 without use_kernels is refused."""
    m = EdgeTransition(128, CZ, CZ, dtype=torch.bfloat16, use_kernels=True, quant_int8=True)
    node = torch.randn(1, 8, 128)
    edge = torch.randn(1, 8, 8, CZ)
    with torch.no_grad():
        assert m(node, edge, torch.ones(1, 8)).shape == (1, 8, 8, CZ)
    with pytest.raises(RuntimeError, match="quant_int8"):
        m(node, edge, torch.ones(1, 8))
    with pytest.raises(ValueError, match="requires use_kernels"):
        EdgeTransition(128, CZ, CZ, quant_int8=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        train_main(["--config", _int8_yaml(tmp_path), "--synthetic", "--debug", "--device", "cpu",
                    "--max_iters", "1", "--batch_size", "1", "--logdir", str(tmp_path / "logs")])


def test_sample_cli_int8_profile_writes_pdbs(tmp_path, capsys):
    """The int8 profile (configs/learn_angle_tpu.yaml with quant_int8: true)
    through the sample CLI on the CPU, where K6 takes its plain version."""
    sample_main(["--config", _int8_yaml(tmp_path, num_blocks=6), "--synthetic", "--out",
                 str(tmp_path / "out"), "--num_samples", "2", "--num_steps", "2",
                 "--max_complexes", "1", "--device", "cpu"])
    pdbs = sorted(glob.glob(str(tmp_path / "out" / "synth0" / "*.pdb")))
    assert len(pdbs) == 2
    atoms = [ln for ln in open(pdbs[0]).read().splitlines() if ln.startswith("ATOM")]
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
    assert len([ln for ln in atoms if ln[12:16] == " CA "]) == 60 and np.isfinite(xyz).all()
    assert "2 pdbs" in capsys.readouterr().out
