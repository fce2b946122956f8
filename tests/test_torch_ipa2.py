"""The fused IPA interior (``use_pallas_ipa``) of the port against the JAX
package, on the CPU, where the wrappers take their plain versions.

* The config keys: ``use_pallas_ipa`` reaches the IPA blocks; ``quant_int8``
  raises instead of running bf16 (its kernel, K6, is not ported).
* ``ipa2_plain`` against ``fused_ipa2`` (Pallas, interpret mode) and
  ``ipa2_reference`` at tests/test_pallas.py's dims, fp32, atol 2e-4 on
  every row (both mask key columns only).
* ``ipa2_bwd_plain`` against ``fused_ipa2_bwd`` (interpret mode) and
  ``jax.grad`` through ``ipa2_reference`` at those dims with two heads (the
  JAX kernel unrolls its head loop, and its interpret run takes 7 s with two
  heads, 14 s with four; two still cover its in-place sums over heads): each
  gradient scaled by its max |·|, atol 1e-3 (tests/test_pallas.py).
* ``IPA2Fn``'s gradients against autograd through ``ipa2_plain``: each
  within 1e-5 of its max |·| (fp32; the same sums in another order).
* The port's ``InvariantPointAttention(use_kernels=True)`` against the JAX
  XLA module on valid rows: forward atol 2e-4, parameter gradients 5e-3 of
  each gradient's max (tests/test_pallas.py); linear_b's bias, whose
  gradient is zero in exact arithmetic, within 1e-6 of the largest one.
* Denoise at golden nb=2, fp32, with ``use_pallas_ipa`` against the JAX XLA
  model on valid rows at the denoise tolerance 5e-3 (tests/test_convert.py);
  in bf16 with the EdgeTransition readouts (the transposed pair layout),
  against the port's bf16 model with the plain IPA: frames and translations
  within 5e-2 (bf16 rounds at other places in the two branches: the pair
  readout from fp32 weights, o_feats rounded whole before linear_out).
* One training step with ``use_pallas_ipa`` against the JAX step (XLA) at
  tests/test_torch_train.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.models import pallas_ipa2 as P
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.ipa import InvariantPointAttention as JaxIPA
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig
from pepflowww_tpu.ops import so3 as jso3

from pepflowww_torch.config import load_config
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.models import cuda_ipa
from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.ipa import EdgeTransition, InvariantPointAttention
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.training.optim import Optimizer
from pepflowww_torch.training.train_step import train_step

from test_torch_train import WEIGHTS, jax_step  # noqa: F401  (the JAX step fixture)

torch.set_num_threads(1)
NAMES = ("q", "kv", "qp", "kvp", "r9", "t", "bias", "pz", "maskb", "sw")


def _inputs(B=2, L=16, H=4, C=32, Pq=4, Pv=6, CZ4=16, seed=0):
    """tests/test_pallas.py::_ipa2_inputs, as numpy arrays."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    R = np.asarray(jso3.rotvec_to_rotmat(jnp.asarray(arr(B, L, 3)))).reshape(B, L, 9)
    mask = (rng.uniform(size=(B, L)) > 0.2).astype(np.float32)
    return [arr(B, L, H * C), arr(B, L, 2 * H * C), arr(B, H, 3, L, Pq), arr(B, H, 3, L, Pq + Pv),
            R, arr(B, L, 3), arr(B, H, L, L), arr(B, L, L, CZ4), (1e5 * (mask - 1.0))[:, None, :],
            np.abs(arr(1, H)) + 0.5]


def _t(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def test_config_keys_reach_the_model(tmp_path):
    """A YAML with use_pallas_ipa builds every IPA block with the kernels
    on; quant_int8 raises ValueError without use_pallas (as the JAX package
    does) and with it reaches every EdgeTransition, where the port had once
    run bf16."""
    def write(ipa):
        path = tmp_path / "cfg.yaml"
        path.write_text(yaml.safe_dump({"model": {"encoder": {"ipa": ipa}}}))
        return str(path)

    cfg = load_config(write({"num_blocks": 2, "use_pallas_ipa": True, "dtype": "bfloat16"}))
    assert cfg.ipa.use_pallas_ipa and not cfg.ipa.quant_int8
    model = build_model(cfg, "cpu", seed=0)
    ipas = [m for m in model.modules() if isinstance(m, InvariantPointAttention)]
    assert len(ipas) == 2 and all(m.use_kernels for m in ipas)
    off = build_model(load_config(write({"num_blocks": 1})), "cpu", seed=0)
    assert not any(m.use_kernels for m in off.modules() if isinstance(m, InvariantPointAttention))
    with pytest.raises(ValueError, match="requires use_pallas"):
        load_config(write({"quant_int8": True}))
    int8 = build_model(load_config(write({"num_blocks": 3, "quant_int8": True,
                                          "use_pallas": True})), "cpu", seed=0)
    ets = [m for m in int8.modules() if isinstance(m, EdgeTransition)]
    assert len(ets) == 2 and all(m.quant_int8 and m.use_kernels for m in ets)


def test_plain_forward_matches_jax_kernel():
    args = _inputs()
    jargs = [jnp.asarray(a) for a in args]
    got = cuda_ipa.ipa2_plain(*[_t(a) for a in args])
    kern = jax.jit(lambda *a: P.fused_ipa2(*a, interpret=True))(*jargs)
    ref = P.ipa2_reference(*jargs)
    for name, a, b, c in zip(("o", "optl", "norm", "opair"), got, kern, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), atol=2e-4, err_msg=name)


def test_plain_backward_matches_jax_kernel_and_grad():
    args = _inputs(H=2, seed=1)
    jargs = [jnp.asarray(a) for a in args]
    rng = np.random.default_rng(2)
    out = jax.eval_shape(P.ipa2_reference, *jargs)
    cots = [rng.normal(size=o.shape).astype(np.float32) for o in out]
    got = cuda_ipa.ipa2_bwd_plain(*[_t(a) for a in args], *[_t(c) for c in cots])
    jcots = tuple(jnp.asarray(c) for c in cots)
    kern = jax.jit(lambda a, c: P.fused_ipa2_bwd(*a, *c, interpret=True))(jargs, jcots)
    ref = list(jax.jit(lambda a, c: jax.vjp(P.ipa2_reference, *a)[1](c))(jargs, jcots))
    ref = ref[:8] + [None, ref[9]]
    for name, a, b, c in zip(NAMES[:8] + ("sw partials",), got, kern, ref[:8] + [None]):
        scale = float(np.abs(np.asarray(b)).max()) + 1e-8
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale, atol=1e-3, err_msg=name)
        if c is not None:
            np.testing.assert_allclose(a.numpy() / scale, np.asarray(c) / scale, atol=1e-3,
                                       err_msg=name)
    gsw = got[8].sum(0, keepdim=True).numpy()
    np.testing.assert_allclose(gsw, np.asarray(ref[9]), atol=1e-3 * float(np.abs(ref[9]).max()))


def test_function_gradients_equal_autograd_through_plain():
    """IPA2Fn (forward and hand-written backward) on permuted views of the
    point inputs, as the module passes them, against autograd through the
    plain forward; no gradient for the key mask."""
    args = _inputs(seed=3)
    rng = np.random.default_rng(4)
    cots = None
    grads = []
    for fn in (cuda_ipa.IPA2Fn.apply, cuda_ipa.ipa2_plain):
        ins = [_t(a, grad=n != "maskb") for n, a in zip(NAMES, args)]
        # qp / kvp as permuted views of (B, L, 3, H, P) storage.
        base = [_t(np.ascontiguousarray(np.transpose(args[k], (0, 3, 2, 1, 4))), grad=True)
                for k in (2, 3)]
        ins[2], ins[3] = (b.permute(0, 3, 2, 1, 4) for b in base)
        out = fn(*ins, 1e-8)
        if cots is None:
            cots = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)) for o in out]
        sum((o * c).sum() for o, c in zip(out, cots)).backward()
        grads.append([x.grad for x in ins[:2]] + [b.grad for b in base]
                     + [x.grad for x in ins[4:]])
    for name, a, b in zip(NAMES, *grads):
        if name == "maskb":
            assert a is None
            continue
        scale = float(b.abs().max()) + 1e-8
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=1e-5, err_msg=name)


def test_ipa_module_matches_jax_xla_on_valid_rows():
    rng = np.random.default_rng(1)
    B, L, cs, cz = 2, 16, 64, 32
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    s, z = arr(B, L, cs), arr(B, L, L, cz)
    R = np.asarray(jso3.rotvec_to_rotmat(jnp.asarray(arr(B, L, 3))))
    t = arr(B, L, 3)
    mask = np.ones((B, L), np.float32)
    mask[:, -3:] = 0.0
    kw = dict(c_s=cs, c_z=cz, c_hidden=32, no_heads=4, no_qk_points=4, no_v_points=6)
    jm = JaxIPA(**kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, (s, z, R, t, mask)))["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(scale=0.05, size=x.shape).astype(np.float32)), params)
    jin = [jnp.asarray(x) for x in (s, z, R, t, mask)]
    want = np.asarray(jax.jit(lambda p, *a: jm.apply({"params": p}, *a))(params, *jin))

    port = InvariantPointAttention(cs, cz, 32, 4, 4, 6, use_kernels=True)
    sd = {"head_weights": np.asarray(params["head_weights"])}
    for name in ("linear_q", "linear_kv", "linear_q_points", "linear_kv_points", "linear_b",
                 "down_z", "linear_out"):
        sd[f"{name}.weight"] = np.asarray(params[name]["Dense_0"]["kernel"]).T
        sd[f"{name}.bias"] = np.asarray(params[name]["Dense_0"]["bias"])
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    got = port(*[_t(x) for x in (s, z, R, t, mask)])
    valid = mask.astype(bool)
    np.testing.assert_allclose(got.detach().numpy()[valid], want[valid], atol=2e-4)

    m = torch.from_numpy(mask)
    (got.square() * m[..., None]).sum().backward()
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.square(
        jm.apply({"params": p}, *jin)) * mask[..., None])))(params)
    top = max(float(p.grad.abs().max()) for p in port.parameters())
    for name, prm in port.named_parameters():
        if name == "linear_b.bias":
            # Zero in exact arithmetic: a per-head constant added to every
            # logit of a row cancels in the softmax. Both sides are rounding
            # noise, held to 1e-6 of the largest gradient.
            assert float(prm.grad.abs().max()) <= 1e-6 * top, float(prm.grad.abs().max())
            continue
        mod, kind = name.rsplit(".", 1) if "." in name else (name, None)
        if kind is None:
            ref = np.asarray(jgrads[mod])
        else:
            j = jgrads[mod]["Dense_0"]
            ref = np.asarray(j["kernel"]).T if kind == "weight" else np.asarray(j["bias"])
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(prm.grad.numpy() / scale, ref / scale, atol=5e-3, err_msg=name)


def test_denoise_with_ipa_kernels(golden):
    g = golden("model_parity")
    nb = int(g["num_blocks"])
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd::")}
    keys = ("t", "rotmats_t", "trans_t", "angles_t", "seqs_t", "node_embed", "edge_embed")
    jb = {k[6:]: jnp.asarray(g[k]) for k in g.files if k.startswith("batch_")}
    params = convert_state_dict(sd, num_blocks=nb, seq_tfmr_num_layers=2)
    jmodel = JaxFlowModel(JaxFlowModelConfig(ipa=JaxIPAConfig(num_blocks=nb)))
    want = jax.jit(lambda p, a, m: jmodel.apply({"params": p}, *a, *m, method="denoise"))(
        params, [jnp.asarray(g[k]) for k in keys], (jb["generate_mask"], jb["res_mask"]))
    args = [torch.from_numpy(np.asarray(g[k])) for k in keys]
    masks = [torch.from_numpy(np.asarray(g["batch_" + k])) for k in ("generate_mask", "res_mask")]
    valid = np.asarray(g["batch_res_mask"]).astype(bool)

    def run(**ipa):
        model = build_model(FlowModelConfig(ipa=IPAConfig(num_blocks=nb, **ipa)), "cpu",
                            state_dict=sd)
        with torch.no_grad():
            return [x.float().numpy() for x in model.denoise(
                *args, *masks, fused_pair_readout=ipa.get("use_pallas", False))]

    got = run(use_pallas_ipa=True)
    for name, a, b in zip(("rot", "trans", "angles", "logits"), got, want):
        d = a[valid] - np.asarray(b)[valid]
        if name == "angles":
            d = np.arctan2(np.sin(d), np.cos(d))
        np.testing.assert_allclose(d, 0.0, atol=5e-3, err_msg=name)
    bf = dict(dtype="bfloat16", use_pallas=True)
    kern, plain = run(use_pallas_ipa=True, **bf), run(**bf)
    for name, a, b in zip(("rot", "trans"), kern[:2], plain[:2]):
        np.testing.assert_allclose(a[valid], b[valid], atol=5e-2, err_msg=name)


def test_one_step_with_ipa_kernels_matches_jax(jax_step):  # noqa: F811
    """The port's step with use_pallas_ipa (IPA2Fn on the CPU: the plain
    forward and the hand-written plain backward) against the JAX XLA step:
    losses, total and grad_norm rtol 1e-4, each gradient within 2e-3 of its
    norm plus 1e-5 of the global norm (tests/test_torch_train.py)."""
    j = jax_step
    cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=j["nb"], use_pallas_ipa=True))
    model = build_model(cfg, "cpu", state_dict=j["sd"]).train()
    optimizer = Optimizer(model.parameters(), {"type": "adam", "lr": 1e-3}, 100.0)
    m = train_step(model, optimizer, device_batch(j["batch"], "cpu"), WEIGHTS, noise=j["noise"])
    for name, v in j["losses"].items():
        np.testing.assert_allclose(float(m[name]), v, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(m["loss"]), j["total"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), j["grad_norm"], rtol=1e-4)
    clip = min(1.0, 100.0 / (float(m["grad_norm"]) + 1e-6))
    G = j["grad_norm"]
    for name, prm in model.named_parameters():
        got, want = prm.grad.numpy() / clip, j["grads"][name]
        err = np.linalg.norm(got - want)
        assert err <= 2e-3 * np.linalg.norm(want) + 1e-5 * G, (name, err, np.linalg.norm(want))
