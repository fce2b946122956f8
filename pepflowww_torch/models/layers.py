"""Shared layers: Linear with a compute dtype and an AF2-style init scheme,
the reference's ReLU MLP stacks, angular and time encodings (counterpart of
the JAX package's ``models/layers.py``)."""

from __future__ import annotations

import math
import weakref
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    """nn.Linear with an init scheme name and an optional compute dtype.

    With ``dtype`` set (bf16 on the production path) the input, weight and
    bias are cast to it and the product comes out in that dtype, as a flax
    ``Dense(dtype=...)`` does; parameters stay float32.
    """

    def __init__(self, in_features: int, out_features: int, init: str = "default",
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.init = init
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


def mlp(dims: Sequence[int], in_dim: int, dtype=None, init: str = "torch",
        final_activation: bool = False) -> nn.Sequential:
    """nn.Sequential(Linear, ReLU, Linear, ...): the reference's stacks, whose
    state-dict indices count the ReLUs (Linears sit at 0, 2, 4, ...)."""
    layers = []
    for i, d in enumerate(dims):
        layers.append(Linear(in_dim, d, init=init, dtype=dtype))
        if i < len(dims) - 1 or final_activation:
            layers.append(nn.ReLU())
        in_dim = d
    return nn.Sequential(*layers)


class AngularEncoding(nn.Module):
    """Multi-frequency angle features: per input dim [x, sin(x f), cos(x f)]
    over freq_bands = [1..n, 1/1..1/n], so dim * (1 + 4n) features. The
    bands are a registered buffer, as in the reference state dict."""

    def __init__(self, num_funcs: int = 3):
        super().__init__()
        self.num_funcs = num_funcs
        bands = [float(i + 1) for i in range(num_funcs)] + [1.0 / (i + 1) for i in range(num_funcs)]
        self.register_buffer("freq_bands", torch.tensor(bands, dtype=torch.float32))

    def get_out_dim(self, in_dim: int) -> int:
        return in_dim * (1 + 4 * self.num_funcs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xe = x[..., None]
        code = torch.cat([xe, torch.sin(xe * self.freq_bands), torch.cos(xe * self.freq_bands)], -1)
        return code.reshape(x.shape[:-1] + (-1,))


def get_time_embedding(timesteps: torch.Tensor, embedding_dim: int,
                       max_positions: int = 2000) -> torch.Tensor:
    """DDPM sinusoidal embedding of scalar times in [0, 1]: (N,) -> (N, dim)."""
    timesteps = timesteps.float() * max_positions
    half_dim = embedding_dim // 2
    scale = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=timesteps.device) * -scale)
    emb = timesteps[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], 1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


_GENERATION = [0]
_HOLDERS: "weakref.WeakSet[nn.Module]" = weakref.WeakSet()   # modules with a cache


def invalidate_operand_caches() -> None:
    """Drop every :func:`cached_operands` entry: parameters that were
    refilled without an in-place version bump (an FSDP all-gather into a
    new buffer, which may reuse the old one's address) must rebuild them,
    and operands that are views of released parameters must not keep their
    storage alive."""
    _GENERATION[0] += 1
    for module in list(_HOLDERS):
        module.__dict__.pop("_operand_cache", None)


def cached_operands(module: nn.Module, tensors, make):
    """``make()`` memoized on `module` until one of `tensors` changes (by
    storage or in-place version) or :func:`invalidate_operand_caches` is
    called: kernel operands derived from parameters (bf16 copies, packed
    layouts) are built once, not on every call."""
    key = (_GENERATION[0],) + tuple((t.data_ptr(), t._version, t.device) for t in tensors)
    hit = getattr(module, "_operand_cache", None)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make())
        module._operand_cache = hit
        _HOLDERS.add(module)
    return hit[1]


# --------------------------------------------------------------- init
def _trunc_normal(t: torch.Tensor, scale: float, fan_in: int, g: torch.Generator):
    # variance_scaling(scale, fan_in, truncated_normal): the std of the
    # underlying normal is corrected for the truncation at 2 sigma.
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)


def init_linear(lin: Linear, g: torch.Generator) -> None:
    """Fill a Linear by its scheme (the AF2 schemes of the reference)."""
    fan_in = lin.weight.shape[1]
    with torch.no_grad():
        if lin.init == "default":
            _trunc_normal(lin.weight, 1.0, fan_in, g)
        elif lin.init == "relu":
            _trunc_normal(lin.weight, 2.0, fan_in, g)
        elif lin.init == "final":
            lin.weight.zero_()
        elif lin.init == "torch":
            bound = 1.0 / math.sqrt(fan_in)
            lin.weight.uniform_(-bound, bound, generator=g)
        else:
            raise ValueError(f"unknown init scheme {lin.init!r}")
        if lin.bias is not None:
            lin.bias.zero_()
