"""Tiled-latent denoiser aggregation.

The tile grid is computed on the host, tiles are sliced out of the latent,
the denoiser runs on fixed-size tile batches (a Python loop), and the
predictions are added into float32 stitch buffers with gaussian weights,
then normalized by the contributor sum. With a process group the tiles are
denoised in parallel: each rank takes a contiguous share, the predictions are
all-gathered, and every rank stitches all of them in the same order.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from omgsr_tpu_torch.diffusion.tiling import gaussian_tile_weights, tile_grid_2d
from omgsr_tpu_torch.parallel.distributed import all_gather_cat
from omgsr_tpu_torch.parallel.sharding import local_tiles


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
    tile_group=None,
):
    """latent (B, H, W, C); denoise_tile: (N, t, t, C) -> (N, t, t, C).

    Returns the stitched prediction, same shape as latent. B > 1 is handled
    by extending the tile list across the image batch (the batch index is a
    third tile coordinate), so the denoiser always sees full
    tile_batch-sized batches. tile_batch=None picks a padding-free divisor
    of the tile count (auto_tile_batch); a function of the tile count picks
    the batch itself.

    tile_group (a process group): tile-parallel denoising. The tile list is
    padded to a multiple of the group's size with copies of the last tile;
    each rank denoises its contiguous share, in batches that ``tile_batch``
    picks for the share; the predictions are all-gathered and stitched in
    tile order on every rank, the copies at weight 0. A latent of one tile
    runs whole on every rank."""
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
    # stitch in float32: bf16 running sums would round in the overlap regions
    weights = torch.as_tensor(
        gaussian_tile_weights(t, t), dtype=torch.float32, device=latent.device
    )[:, :, None]
    acc = torch.zeros(latent.shape, dtype=torch.float32, device=latent.device)
    contrib = torch.zeros(latent.shape, dtype=torch.float32, device=latent.device)

    def denoise(share):
        """The tiles ``share`` in batches of ``tile_batch``; the last tile is
        repeated to fill the final batch, and the repeats are denoised and
        dropped: yields the predictions of each batch."""
        tb = tile_batch
        if tb is None:
            tb = auto_tile_batch(len(share))
        elif callable(tb):
            tb = tb(len(share))
        padded = share + [share[-1]] * ((-len(share)) % tb)
        for start in range(0, len(share), tb):
            batch = padded[start : start + tb]
            preds = denoise_tile(torch.stack([latent[bi, oy : oy + t, ox : ox + t, :] for bi, oy, ox in batch]))
            yield preds[: min(tb, len(share) - start)]

    size, rank = (1, 0) if tile_group is None else (dist.get_world_size(tile_group), dist.get_rank(tile_group))
    total, first, count = local_tiles(n, size, rank)
    padded = triples + [triples[-1]] * (total - n)
    preds = torch.cat(list(denoise(padded[first : first + count])))
    if tile_group is not None:
        preds = all_gather_cat(preds, tile_group)
    for (bi, oy, ox), pred in zip(triples, preds[:n]):
        acc[bi, oy : oy + t, ox : ox + t, :] += pred.float() * weights
        contrib[bi, oy : oy + t, ox : ox + t, :] += weights
    return (acc / contrib).to(latent.dtype)
