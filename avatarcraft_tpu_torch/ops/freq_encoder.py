"""NeRF-style frequency (positional) encoder. Port of the JAX package's
ops/freq_encoder.py (reference: encoder/freq_encoder.py:10-53): the input
itself, then [sin, cos](x * 2^k) for k in 0..multires-1, concatenated on
the feature axis; and the 45-degree rotated Fourier basis of the legacy
NeRF's "rotate" mapping (reference: models/nerf.py:45-59). Plain torch: the
JAX package computes it in XLA, with no Pallas kernel."""

from __future__ import annotations

import numpy as np
import torch


def freq_encode_dim(multires: int, input_dims: int = 3, include_input: bool = True) -> int:
    return input_dims * (include_input + 2 * multires)


def freq_encode(x: torch.Tensor, multires: int, include_input: bool = True) -> torch.Tensor:
    """[..., D] -> [..., D * (include_input + 2 * multires)] in the
    reference's order: [x, sin(x f0), cos(x f0), sin(x f1), cos(x f1), ...]."""
    feats = [x] if include_input else []
    for f in 2.0 ** np.arange(multires, dtype=np.float32):
        feats.append(torch.sin(x * float(f)))
        feats.append(torch.cos(x * float(f)))
    return torch.cat(feats, dim=-1)


def rotated_fourier_bvals(multires: int, min_freq: float = 0.0) -> np.ndarray:
    """The "rotate" mapping's frequency matrix B [3 * multires, 3]: the
    axis-aligned bases 2^k * eye(3) of every band, rotated by Rz(45 deg)
    then Rx(45 deg)."""
    bvals = 2.0 ** np.linspace(min_freq, multires - 1.0, num=multires)
    bvals = np.reshape(np.eye(3) * bvals[:, None, None], [multires * 3, 3])
    s = np.sqrt(2.0) / 2.0
    rot_z = np.array([[s, -s, 0.0], [s, s, 0.0], [0.0, 0.0, 1.0]])
    rot_x = np.array([[1.0, 0.0, 0.0], [0.0, s, -s], [0.0, s, s]])
    return (bvals @ rot_z.T @ rot_x.T).astype(np.float32)


def freq_encode_rotated(x: torch.Tensor, multires: int, include_input: bool = True) -> torch.Tensor:
    """The "rotate" mapping: [x, sin(x B^T), cos(x B^T)], all sines before
    all cosines (3 + 6 * multires features for 3-D inputs)."""
    bvals = torch.from_numpy(rotated_fourier_bvals(multires)).to(x.device)
    proj = x @ bvals.T
    return torch.cat(([x] if include_input else []) + [torch.sin(proj), torch.cos(proj)], dim=-1)
