"""Background synthesis for SDS training: port of the JAX package's
utils/background.py (reference: utils/render_utils.py:953-987).

White, black and the blurred chessboard equal the JAX package's value for
value. The noise background draws from a ``torch.Generator`` where the JAX
package draws from a ``jax.random`` key, so its values differ between the
packages (the same distribution).
"""

from __future__ import annotations

import numpy as np
import torch

from avatarcraft_tpu_torch.constants import (
    BLACK_BKG,
    CHESSBOARD_BKG,
    NOISE_BKG,
    WHITE_BKG,
)


def _chessboard(n_pixels: int) -> np.ndarray:
    """Blurred chessboard background, host-precomputed (render_utils.py:972-986)."""
    from scipy.ndimage import gaussian_filter

    H = W = int(np.sqrt(n_pixels))
    board = np.full((H, W), 0.2, np.float32)
    chess_length = max(H // 10, 1)
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="xy")
    board[((i // chess_length + j // chess_length) % 2) == 0] = 0.8
    board = gaussian_filter(board, sigma=1.0)
    return np.repeat(board.reshape(-1, 1), 3, axis=1)


def select_background(
    n_pixels: int, key_id: int, generator: torch.Generator | None = None, device="cuda"
) -> torch.Tensor:
    """[n_pixels, 3] f32 background on ``device`` by key: white / black /
    gaussian noise (clip(0.5 + 0.1 N(0, 1)), one draw per pixel from
    ``generator``, which lives on ``device``) / blurred chessboard."""
    key_id = key_id % 4
    if key_id == WHITE_BKG:
        return torch.ones((n_pixels, 3), dtype=torch.float32, device=device)
    if key_id == BLACK_BKG:
        return torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)
    if key_id == NOISE_BKG:
        if generator is None:
            raise ValueError("the noise background needs a torch.Generator")
        noise = torch.randn((n_pixels,), generator=generator, device=device)
        return torch.clamp(0.5 + 0.1 * noise, 0.0, 1.0)[:, None].expand(n_pixels, 3).contiguous()
    if key_id == CHESSBOARD_BKG:
        return torch.as_tensor(_chessboard(n_pixels), device=device)
    raise ValueError(key_id)
