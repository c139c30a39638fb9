"""The legacy frequency-encoded NeuS field. Port of the JAX package's
models/neus.py (reference: models/neus.py:88-883): the 8 x 256 SDF MLP with
a skip connection over a frequency encoding, the IDR rendering network and
the learned variance. ``build_neus`` returns the port's ``FieldFns``, so the
importance-sampled render (``render_rays`` / ``render_rays_chunked`` with
``field=``) renders it as it renders the instant-NSR field.

The tree is the JAX package's: {"sdf": [{"w", "b"}, ...], "color": [{"w",
"b"}, ...], "variance": scalar}, weights [out, in]. The MLP products stay
``torch.matmul``: the JAX package computes them in XLA, with no Pallas
kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from avatarcraft_tpu_torch.models.instant_nsr import FieldFns, _softplus100
from avatarcraft_tpu_torch.ops.freq_encoder import freq_encode, freq_encode_dim


@dataclasses.dataclass(frozen=True)
class NeuSConfig:
    """The reference's defaults (models/neus.py:88-118, 243-276)."""

    d_hidden: int = 256
    n_layers: int = 8
    skip_layer: int = 4
    multires: int = 6  # positional encoding bands for x
    multires_view: int = 4  # for the view directions of the rendering network
    d_feature: int = 256
    geometric_init: bool = True
    init_radius: float = 0.5
    variance_init: float = 0.3

    @property
    def d_in(self) -> int:
        return freq_encode_dim(self.multires)

    @property
    def color_d_in(self) -> int:
        # the IDR input: [x, view, normal, feature]
        return 3 + freq_encode_dim(self.multires_view) + 3 + self.d_feature


def init_neus_params(generator: torch.Generator, cfg: NeuSConfig) -> dict:
    """The SAL geometric init (a sphere of radius ``init_radius``,
    reference: models/neus.py:120-170), drawn from ``generator`` on its
    device: the last layer sqrt(pi / in) + 1e-4 N(0, 1) on its SDF row with
    the bias -init_radius; the first layer on xyz only; the skip layer's
    columns of the concatenated encoding beyond xyz zeroed; the other
    layers N(0, 2 / out). The color MLP U(-1/sqrt(in), 1/sqrt(in)), biases
    zero. The tree, shapes and dtypes are the JAX package's; the random
    values are torch's."""
    dev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=dev)

    d_in = cfg.d_in
    dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [1 + cfg.d_feature]
    sdf_layers = []
    for l in range(len(dims) - 1):
        in_dim, out_dim = dims[l], dims[l + 1]
        if l == cfg.skip_layer:
            in_dim += d_in  # the skip concat
        b = torch.zeros(out_dim, device=dev)
        if not cfg.geometric_init:
            w = normal((out_dim, in_dim)) * float(np.sqrt(2.0 / in_dim))
        elif l == len(dims) - 2:  # the last layer
            w = torch.zeros((out_dim, in_dim), device=dev)
            w[0] = float(np.sqrt(np.pi / in_dim)) + 1e-4 * normal((in_dim,))
            b[0] = -cfg.init_radius
        elif l == 0:
            w = torch.zeros((out_dim, in_dim), device=dev)
            w[:, :3] = normal((out_dim, 3)) * float(np.sqrt(2.0 / out_dim))
        else:
            w = normal((out_dim, in_dim)) * float(np.sqrt(2.0 / out_dim))
            if l == cfg.skip_layer:
                # the concatenated encoding beyond raw xyz gets no weight
                # (the cos(0) = 1 channels; reference: models/neus.py:155-158)
                w[:, cfg.d_hidden + 3:] = 0.0
        sdf_layers.append({"w": w, "b": b})

    color_dims = [cfg.color_d_in] + [cfg.d_hidden] * 3 + [3]
    color_layers = []
    for l in range(len(color_dims) - 1):
        bound = float(1.0 / np.sqrt(color_dims[l]))
        w = torch.rand((color_dims[l + 1], color_dims[l]), generator=generator, device=dev) * (2 * bound) - bound
        color_layers.append({"w": w, "b": torch.zeros(color_dims[l + 1], device=dev)})

    return {
        "sdf": sdf_layers,
        "color": color_layers,
        "variance": torch.tensor(cfg.variance_init, dtype=torch.float32, device=dev),
    }


_SQRT2 = float(np.float32(np.sqrt(2.0)))


def neus_sdf(params: dict, x: torch.Tensor, cfg: NeuSConfig) -> torch.Tensor:
    """[N,3] -> [N, 1 + d_feature] (reference: models/neus.py:172-206): the
    skip layer takes [h, enc] / sqrt(2), softplus(beta=100) between the
    layers."""
    enc = freq_encode(x, cfg.multires)
    h = enc
    n = len(params["sdf"])
    for l, layer in enumerate(params["sdf"]):
        if l == cfg.skip_layer:
            h = torch.cat([h, enc], dim=-1) / _SQRT2
        h = h @ layer["w"].T + layer["b"]
        if l != n - 1:
            h = _softplus100(h)
    return h


def neus_color(params: dict, x, d, normal, feat, cfg: NeuSConfig) -> torch.Tensor:
    """The IDR rendering network (reference: models/neus.py:243-322):
    [x, freq(d, multires_view), n, feat] through ReLU layers, then a
    sigmoid."""
    h = torch.cat([x, freq_encode(d, cfg.multires_view), normal, feat], dim=-1)
    n = len(params["color"])
    for l, layer in enumerate(params["color"]):
        h = h @ layer["w"].T + layer["b"]
        if l != n - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def build_neus(params: dict, cfg: NeuSConfig) -> FieldFns:
    """The field functions of ``params`` for ``render_rays(field=...)``
    (reference: models/neus.py:784)."""
    return FieldFns(
        sdf=lambda x: neus_sdf(params, x, cfg),
        color=lambda x, d, n, f: neus_color(params, x, d, n, f, cfg),
        inv_s=lambda: torch.clamp(torch.exp(params["variance"] * 10.0), 1e-6, 1e6),
    )
