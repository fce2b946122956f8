"""YAML config loader for ``configs/learn_angle*.yaml``, key-compatible
with the reference's learn_angle.yaml: the ``model`` section as typed
dataclasses, the ``train`` section (loss weights, optimizer, scheduler,
batch size, seed, clip, accumulation) as a dict over the defaults.

``ipa.dtype: bfloat16`` selects bf16 matmuls; ``ipa.use_pallas: true``
selects this package's hand-written CUDA kernels (the fused EdgeTransition
and the distance embedding, forward and backward); ``ipa.use_pallas_ipa:
true`` the fused IPA interior's (forward and backward). ``ipa.quant_int8:
true`` (with ``use_pallas``) the int8 serving profile: the EdgeTransitions'
hidden products in int8, forward only (sampling; a training step raises).
"""

from __future__ import annotations

import copy
import os

import yaml

from pepflowww_torch.models.flow import FlowModelConfig, InterpolantConfig
from pepflowww_torch.models.trunk import IPAConfig


DEFAULT_TRAIN = {
    "loss_weights": {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
                     "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5},
    "max_iters": 400_000_000,
    "val_freq": 20_000,
    "batch_size": 32,
    "accum_grad": 1,
    "seed": 114514,
    "max_grad_norm": 100.0,
    "optimizer": {"type": "adam", "lr": 5e-4, "weight_decay": 0.0, "beta1": 0.9, "beta2": 0.999},
    "scheduler": {"type": "plateau", "factor": 0.8, "patience": 10, "min_lr": 5e-6},
}


def model_config_from_dict(m: dict) -> FlowModelConfig:
    enc = m.get("encoder", {})
    ipa = enc.get("ipa", {})
    itp = m.get("interpolant", {})
    return FlowModelConfig(
        node_embed_size=enc.get("node_embed_size", 128),
        edge_embed_size=enc.get("edge_embed_size", 64),
        ipa=IPAConfig(
            c_s=ipa.get("c_s", 128),
            c_z=ipa.get("c_z", 64),
            c_hidden=ipa.get("c_hidden", 128),
            no_heads=ipa.get("no_heads", 8),
            no_qk_points=ipa.get("no_qk_points", 8),
            no_v_points=ipa.get("no_v_points", 12),
            seq_tfmr_num_heads=ipa.get("seq_tfmr_num_heads", 4),
            seq_tfmr_num_layers=ipa.get("seq_tfmr_num_layers", 2),
            num_blocks=ipa.get("num_blocks", 6),
            dtype=ipa.get("dtype", enc.get("dtype", m.get("dtype"))),
            use_pallas=bool(ipa.get("use_pallas", m.get("use_pallas", False))),
            use_pallas_ipa=bool(ipa.get("use_pallas_ipa", False)),
            quant_int8=bool(ipa.get("quant_int8", False)),
        ),
        interpolant=InterpolantConfig(
            min_t=float(itp.get("min_t", 1e-2)),
            t_normalization_clip=float(itp.get("t_normalization_clip", 0.9)),
            sample_structure=itp.get("sample_structure", True),
            sample_sequence=itp.get("sample_sequence", True),
            rots_exp_rate=float(itp.get("rots", {}).get("exp_rate", 10.0)),
            trans_sigma=float(itp.get("trans", {}).get("sigma", 1.0)),
            num_classes=int(itp.get("seqs", {}).get("num_classes", 20)),
            simplex_value=float(itp.get("seqs", {}).get("simplex_value", 5.0)),
            num_timesteps=int(itp.get("sampling", {}).get("num_timesteps", 100)),
        ),
    )


def load_config(path: str) -> FlowModelConfig:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return model_config_from_dict(raw.get("model", {}))


def _deep_update(base: dict, upd: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in (upd or {}).items():
        out[k] = _deep_update(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def load_train_config(path: str):
    """(model config, the whole YAML as a dict with ``train`` filled from
    :data:`DEFAULT_TRAIN`, the config's name)."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    raw["train"] = _deep_update(DEFAULT_TRAIN, raw.get("train", {}))
    return (model_config_from_dict(raw.get("model", {})), raw,
            os.path.splitext(os.path.basename(path))[0])
