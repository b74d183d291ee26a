"""Tiled-latent aggregation math: grid placement + gaussian stitch weights.

Large latents go through the denoiser as overlapping tiles whose predictions
are blended with a gaussian weight map. This module holds the static grid
computation and the weight map; the tile loop lives in
omgsr_tpu_torch.inference.tiled.
"""

from __future__ import annotations

import numpy as np


def gaussian_tile_weights(tile_h: int, tile_w: int, var: float = 0.01) -> np.ndarray:
    """(tile_h, tile_w) gaussian blending weights.

    Keeps the original OMGSR weights' asymmetric midpoints: x uses (w-1)/2
    while y uses h/2, with variance normalized by the tile size. Kept as is
    because stitch weights directly shape the output pixels.
    """
    midpoint_x = (tile_w - 1) / 2
    x = np.arange(tile_w, dtype=np.float64)
    x_probs = np.exp(-((x - midpoint_x) ** 2) / (tile_w * tile_w) / (2 * var)) / np.sqrt(
        2 * np.pi * var
    )
    midpoint_y = tile_h / 2
    y = np.arange(tile_h, dtype=np.float64)
    y_probs = np.exp(-((y - midpoint_y) ** 2) / (tile_h * tile_h) / (2 * var)) / np.sqrt(
        2 * np.pi * var
    )
    return np.outer(y_probs, x_probs)


def tile_grid_1d(size: int, tile: int, overlap: int) -> list[int]:
    """Start offsets of tiles along one dim, stride (tile-overlap), last tile
    snapped to the end so every pixel is covered."""
    if tile >= size:
        return [0]
    if overlap >= tile:
        raise ValueError(f"tile_overlap {overlap} must be < tile {tile}")
    stride = tile - overlap
    # number of tiles: smallest n with (n-1)*stride + tile >= size
    n = 1
    while (n - 1) * stride + tile < size:
        n += 1
    return [min(i * stride, size - tile) for i in range(n)]


def tile_grid_2d(h: int, w: int, tile: int, overlap: int) -> list[tuple[int, int]]:
    """Row-major (y, x) tile offsets covering an h x w latent."""
    ys = tile_grid_1d(h, tile, overlap)
    xs = tile_grid_1d(w, tile, overlap)
    return [(y, x) for y in ys for x in xs]
