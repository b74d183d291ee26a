"""Tiled-latent denoiser aggregation.

The tile grid is computed on the host, tiles are sliced out of the latent,
the denoiser runs on fixed-size tile batches (a Python loop), and the
predictions are added into float32 stitch buffers with gaussian weights,
then normalized by the contributor sum. Tile-parallel multi-GPU denoising
arrives with the distribution slice.
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.diffusion.tiling import gaussian_tile_weights, tile_grid_2d


def auto_tile_batch(n: int, cap: int = 8) -> int:
    """Largest divisor of n in [2, cap]: a padding-free denoiser batch (a
    9-tile grid gets 3, a 49-tile grid gets 7). When n has no divisor in
    range (e.g. prime n), picks the candidate wasting the fewest padded
    tiles, ties to the larger batch (n=13 -> 7, one pad tile)."""
    if n <= 1:
        return max(n, 1)
    for d in range(min(cap, n), 1, -1):
        if n % d == 0:
            return d
    return min(range(2, min(cap, n) + 1), key=lambda d: ((-n) % d, -d))


def tiled_denoise(
    latent: torch.Tensor,
    denoise_tile,
    tile_size: int,
    tile_overlap: int,
    tile_batch: int | None = 1,
):
    """latent (B, H, W, C); denoise_tile: (N, t, t, C) -> (N, t, t, C).

    Returns the stitched prediction, same shape as latent. B > 1 is handled
    by extending the tile list across the image batch (the batch index is a
    third tile coordinate), so the denoiser always sees full
    tile_batch-sized batches. tile_batch=None picks a padding-free divisor
    of the tile count (auto_tile_batch); a function of the tile count picks
    the batch itself."""
    b, h, w, c = latent.shape
    t = min(tile_size, h, w)
    if h * w <= tile_size * tile_size:
        return denoise_tile(latent)

    # when the tile clamps to a short latent dim, scale the overlap with it
    # (overlap >= tile would make the grid stride non-positive)
    tile_overlap = min(tile_overlap, t // 2)
    grid = tile_grid_2d(h, w, t, tile_overlap)
    triples = [(bi, oy, ox) for bi in range(b) for (oy, ox) in grid]
    n = len(triples)
    if tile_batch is None:
        tile_batch = auto_tile_batch(n)
    elif callable(tile_batch):
        tile_batch = tile_batch(n)
    # the last tile is repeated to fill the final batch; the repeats are
    # denoised and then dropped (zero stitch weight)
    pad = (-n) % tile_batch
    padded = triples + [triples[-1]] * pad

    # stitch in float32: bf16 running sums would round in the overlap regions
    weights = torch.as_tensor(
        gaussian_tile_weights(t, t), dtype=torch.float32, device=latent.device
    )[:, :, None]
    acc = torch.zeros(latent.shape, dtype=torch.float32, device=latent.device)
    contrib = torch.zeros(latent.shape, dtype=torch.float32, device=latent.device)
    for start in range(0, len(padded), tile_batch):
        batch = padded[start : start + tile_batch]
        tiles = torch.stack([latent[bi, oy : oy + t, ox : ox + t, :] for bi, oy, ox in batch])
        preds = denoise_tile(tiles)
        for j, (bi, oy, ox) in enumerate(batch):
            if start + j >= n:
                break
            acc[bi, oy : oy + t, ox : ox + t, :] += preds[j].float() * weights
            contrib[bi, oy : oy + t, ox : ox + t, :] += weights
    return (acc / contrib).to(latent.dtype)
