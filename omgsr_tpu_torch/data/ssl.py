"""DINOv3 SSL data pipeline: multi-crop augmentation, iBOT block masking,
static-shape collate, and distributed samplers.

Re-owns the vendored SSL data infra that sits off OMGSR's execution path
(dinov3/data/{augmentations,masking,collate,samplers}.py). The port's own
copy of the JAX package's host-only module: the same draws from the same
np.random.Generator give the same crops, masks and indices, bit for bit.
PIL is imported where an image is touched. Design decisions, versus the
torch originals:

- The collate emits STATIC shapes only: a (B_total, N) boolean mask plus a
  scalar count — never the reference's `mask_indices_list` /
  `mask_indices_list.nonzero()` dynamic-length tensors (collate.py:64-66),
  which would force a retrace per batch under jit. Masked-patch losses
  consume the boolean mask directly (losses/ssl.py ibot_patch_loss and the
  weighted sinkhorn); the iBOT head runs on all patch tokens, trading a few
  MLP FLOPs for a single compiled graph.
- Augmentation runs on host (PIL + numpy) like the SR dataset's crop/flip
  path, in the CLI's one prefetch thread; PERF.md has its share of an
  iteration on the card.
- All randomness flows through one np.random.Generator (no global
  `random`/`np.random` state), so a worker is reproducible from its seed.

Deviations from torch, by design (documented where they matter):
- GaussianBlur uses PIL's ImageFilter.GaussianBlur(radius=sigma) rather
  than torchvision's 9-tap kernel (transforms.py:21-30) — visually
  equivalent for sigma in [0.1, 2].
- The infinite samplers shuffle with numpy's Fisher-Yates instead of
  replaying torch's CPU randperm bit-for-bit (samplers.py:64-76); the
  *semantics* (disjoint rank shards, deterministic from seed, resumable
  via `advance`, fresh permutation per pass) are preserved and tested.
  EpochSampler is numpy-based upstream and matches exactly.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# iBOT block masking (masking.py:12-94)
# ---------------------------------------------------------------------------


class BlockMaskingGenerator:
    """Block-wise mask sampler (masking.py MaskingGenerator): repeatedly
    paints random log-aspect rectangles until `num_masking_patches` cells
    are set, then tops up with uniformly random cells so the count is
    EXACT (masking.py:88-94) — exactness is what keeps the collated batch
    statically shaped downstream."""

    def __init__(
        self,
        input_size,
        min_num_patches: int = 4,
        max_num_patches: int | None = None,
        min_aspect: float = 0.3,
        max_aspect: float | None = None,
    ):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.min_num_patches = min_num_patches
        self.max_num_patches = max_num_patches
        max_aspect = max_aspect or 1.0 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _paint(self, rng: np.random.Generator, mask, max_mask_patches):
        # one block attempt loop (masking.py:50-73)
        delta = 0
        for _ in range(10):
            # python random.uniform tolerates reversed bounds (the reference
            # hits this when fewer than min_num_patches cells remain)
            target_area = self.min_num_patches + (
                max_mask_patches - self.min_num_patches
            ) * rng.uniform()
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = int(rng.integers(0, self.height - h + 1))
                left = int(rng.integers(0, self.width - w + 1))
                region = mask[top : top + h, left : left + w]
                num_new = h * w - int(region.sum())
                if 0 < num_new <= max_mask_patches:
                    region[:] = True
                    delta += num_new
            if delta > 0:
                break
        return delta

    def __call__(self, rng: np.random.Generator, num_masking_patches: int = 0):
        mask = np.zeros((self.height, self.width), dtype=bool)
        cap = (
            num_masking_patches
            if self.max_num_patches is None
            else self.max_num_patches
        )
        count = 0
        while count < num_masking_patches:
            delta = self._paint(rng, mask, min(num_masking_patches - count, cap))
            if delta == 0:
                break
            count += delta
        # exact top-up / trim never needed: _paint never overshoots; top up
        # randomly to the exact requested count (masking.py:88-94)
        deficit = num_masking_patches - int(mask.sum())
        if deficit > 0:
            flat = mask.reshape(-1)
            candidates = np.flatnonzero(~flat)
            flat[rng.choice(candidates, size=deficit, replace=False)] = True
        return mask


# ---------------------------------------------------------------------------
# Multi-crop augmentation (augmentations.py DataAugmentationDINO)
# ---------------------------------------------------------------------------


def random_resized_crop(rng, img, size, scale, ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """torchvision RandomResizedCrop semantics: 10 area/log-ratio attempts,
    else aspect-clamped center crop; bicubic resize to (size, size)."""
    from PIL import Image

    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return img.resize(
                (size, size), Image.BICUBIC, box=(left, top, left + cw, top + ch)
            )
    # fallback: center crop at the clamped aspect ratio
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), Image.BICUBIC, box=(left, top, left + cw, top + ch))


def color_jitter(rng, img, brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1):
    """torchvision ColorJitter: the four adjustments in a random order,
    factors uniform around 1 (hue uniform around 0)."""
    from PIL import Image, ImageEnhance

    ops = list(rng.permutation(4))
    for op in ops:
        # torchvision turns zero-strength knobs into no-ops entirely
        if op == 0 and brightness:
            img = ImageEnhance.Brightness(img).enhance(
                rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
            )
        elif op == 1 and contrast:
            img = ImageEnhance.Contrast(img).enhance(
                rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
            )
        elif op == 2 and saturation:
            img = ImageEnhance.Color(img).enhance(
                rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
            )
        elif op == 3 and hue:
            f = rng.uniform(-hue, hue)
            hsv = np.asarray(img.convert("HSV")).copy()
            hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(round(f * 255))) % 256
            img = Image.fromarray(hsv, "HSV").convert("RGB")
    return img


def _normalize(img) -> np.ndarray:
    """uint8 PIL -> ImageNet-normalized float32 HWC."""
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


@dataclasses.dataclass
class MultiCropConfig:
    """Crop geometry + distortion knobs (augmentations.py:18-47 args)."""

    global_crops_scale: tuple = (0.32, 1.0)
    local_crops_scale: tuple = (0.05, 0.32)
    local_crops_number: int = 8
    global_crops_size: int = 224
    local_crops_size: int = 96
    gram_teacher_crops_size: int | None = None
    gram_teacher_no_distortions: bool = False
    teacher_no_color_jitter: bool = False
    horizontal_flips: bool = True


class MultiCropAugmentation:
    """DataAugmentationDINO (augmentations.py:17-225): 2 global crops with
    asymmetric distortions (crop 1: jitter+blur(p=1); crop 2: jitter+
    blur(p=.1)+solarize(p=.2)) + N local crops (jitter+blur(p=.5)), all
    ImageNet-normalized float32 HWC numpy."""

    def __init__(self, cfg: MultiCropConfig):
        self.cfg = cfg
        gram = cfg.gram_teacher_crops_size
        self.global_crop_max_size = max(cfg.global_crops_size, gram or 0)

    def _distort(self, rng, img, which):
        from PIL import ImageFilter, ImageOps

        img = color_jitter(rng, img) if rng.uniform() < 0.8 else img
        if rng.uniform() < 0.2:
            img = img.convert("L").convert("RGB")
        blur_p = {"g1": 1.0, "g2": 0.1, "local": 0.5}[which]
        if rng.uniform() < blur_p:
            img = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.1, 2.0)))
        if which == "g2" and rng.uniform() < 0.2:
            img = ImageOps.solarize(img, threshold=128)
        return img

    def _geo_global(self, rng, img):
        from PIL import Image

        out = random_resized_crop(
            rng, img, self.global_crop_max_size, self.cfg.global_crops_scale
        )
        if self.cfg.horizontal_flips and rng.uniform() < 0.5:
            out = out.transpose(Image.FLIP_LEFT_RIGHT)
        return out

    def _resize(self, img, size):
        from PIL import Image

        return img if img.size == (size, size) else img.resize((size, size), Image.BICUBIC)

    def __call__(self, rng: np.random.Generator, image) -> dict:
        from PIL import Image

        cfg = self.cfg
        out = {}
        global_crops, teacher_crops, gram_crops = [], [], []
        for which in ("g1", "g2"):
            base = self._geo_global(rng, image)
            if cfg.gram_teacher_crops_size is not None and cfg.gram_teacher_no_distortions:
                # distortion-free gram crop from the shared geometric base
                gram_crops.append(
                    _normalize(self._resize(base, cfg.gram_teacher_crops_size))
                )
                distorted = self._distort(
                    rng, self._resize(base, cfg.global_crops_size), which
                )
                global_crops.append(_normalize(distorted))
            else:
                distorted = self._distort(rng, base, which)
                if cfg.gram_teacher_crops_size is not None:
                    gram_crops.append(
                        _normalize(self._resize(distorted, cfg.gram_teacher_crops_size))
                    )
                global_crops.append(
                    _normalize(self._resize(distorted, cfg.global_crops_size))
                )
            if cfg.teacher_no_color_jitter:
                teacher_crops.append(
                    _normalize(self._resize(base, cfg.global_crops_size))
                )
        out["global_crops"] = global_crops
        # same list object when the teacher shares the student's crops, so
        # the collate can skip duplicating the stack
        out["global_crops_teacher"] = teacher_crops if teacher_crops else global_crops
        if gram_crops:
            out["gram_teacher_crops"] = gram_crops
        local_crops = []
        for _ in range(cfg.local_crops_number):
            crop = random_resized_crop(
                rng, image, cfg.local_crops_size, cfg.local_crops_scale
            )
            if cfg.horizontal_flips and rng.uniform() < 0.5:
                crop = crop.transpose(Image.FLIP_LEFT_RIGHT)
            local_crops.append(_normalize(self._distort(rng, crop, "local")))
        out["local_crops"] = local_crops
        return out


# ---------------------------------------------------------------------------
# Collate (collate.py:11-80), static shapes
# ---------------------------------------------------------------------------


def collate_ssl_batch(
    samples: list[dict],
    rng: np.random.Generator,
    mask_generator: BlockMaskingGenerator,
    mask_ratio_tuple=(0.1, 0.5),
    mask_probability: float = 0.5,
    dtype=np.float32,
) -> dict:
    """Stack per-sample crop dicts into device-ready arrays.

    Ordering matches the reference exactly (collate.py:24-27): crop-major,
    i.e. [crop0 of every sample, crop1 of every sample, ...], so row
    `c * B + b` is crop c of sample b and a (C, B, ...) unflatten is valid.

    Masks (collate.py:42-66): `int(B_total * mask_probability)` samples get
    a block mask whose size ramps linearly over `mask_ratio_tuple`; the
    rest get empty masks; the list is shuffled across the batch. Returns
    the static (B_total, N) bool mask — NOT a dynamic index list — plus
    per-sample weights 1/num_masked (zeros where unmasked) so masked
    losses are a static weighted sum.
    """
    n_global = len(samples[0]["global_crops"])
    n_local = len(samples[0]["local_crops"])
    batch = {
        "global_crops": np.stack(
            [s["global_crops"][i] for i in range(n_global) for s in samples]
        ).astype(dtype),
        "local_crops": np.stack(
            [s["local_crops"][i] for i in range(n_local) for s in samples]
        ).astype(dtype),
    }
    if "gram_teacher_crops" in samples[0]:
        batch["gram_teacher_crops"] = np.stack(
            [s["gram_teacher_crops"][i] for i in range(n_global) for s in samples]
        ).astype(dtype)
    if samples[0].get("global_crops_teacher") is not samples[0]["global_crops"]:
        batch["global_crops_teacher"] = np.stack(
            [s["global_crops_teacher"][i] for i in range(n_global) for s in samples]
        ).astype(dtype)

    b_total = batch["global_crops"].shape[0]
    n_tokens = mask_generator.num_patches
    n_masked_samples = int(b_total * mask_probability)
    probs = np.linspace(*mask_ratio_tuple, n_masked_samples + 1)
    masks = [
        mask_generator(rng, int(n_tokens * probs[i + 1])).reshape(-1)
        for i in range(n_masked_samples)
    ]
    masks += [np.zeros((n_tokens,), bool) for _ in range(n_masked_samples, b_total)]
    order = rng.permutation(b_total)
    collated = np.stack([masks[i] for i in order])
    counts = collated.sum(-1)
    weights = np.where(collated, 1.0 / np.maximum(counts, 1.0)[:, None], 0.0)
    batch["masks"] = collated
    batch["masks_weight"] = weights.astype(np.float32)
    batch["n_masked_patches"] = np.asarray(int(counts.sum()), np.int32)
    return batch


# ---------------------------------------------------------------------------
# Samplers (samplers.py:17-229)
# ---------------------------------------------------------------------------


class EpochSampler:
    """samplers.py:17-53, numpy-exact: tile [0, sample_count) to cover
    `size`, optionally rng.choice-shuffle with seed*epoch (or epoch when
    seed == 0), then stride by (start, step) = (rank, world)."""

    def __init__(self, *, size, sample_count, shuffle=False, seed=0, start=0, step=1):
        self._size = size
        self._sample_count = sample_count
        self._shuffle = shuffle
        self._seed = seed
        self._start = start
        self._step = step
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __len__(self):
        return (self._size - self._start + self._step - 1) // self._step

    def __iter__(self):
        count = (self._size + self._sample_count - 1) // self._sample_count
        tiled = np.tile(np.arange(self._sample_count), count)
        if self._shuffle:
            seed = self._seed * self._epoch if self._seed != 0 else self._epoch
            tiled = np.random.default_rng(seed).choice(tiled, self._size, replace=False)
        else:
            tiled = tiled[: self._size]
        yield from tiled[self._start :: self._step].tolist()


class InfiniteSampler:
    """samplers.py:79-123 semantics: endless stream of indices, each pass a
    fresh permutation of [0, sample_count), rank-strided, skippable via
    `advance` for resume."""

    def __init__(self, *, sample_count, shuffle=False, seed=0, start=0, step=1, advance=0):
        self._sample_count = sample_count
        self._shuffle = shuffle
        self._seed = seed
        self._start = start
        self._step = step
        self._advance = advance

    def __iter__(self):
        skip = self._advance
        rng = np.random.default_rng(self._seed)
        while True:
            perm = (
                rng.permutation(self._sample_count)
                if self._shuffle
                else np.arange(self._sample_count)
            )
            for idx in perm[self._start :: self._step].tolist():
                if skip > 0:
                    skip -= 1
                    continue
                yield idx


class ShardedInfiniteSampler:
    """samplers.py:165-229 semantics: one global permutation fixed by
    `seed`, then per-pass reshuffles of this rank's shard re-seeded by
    (seed, start, pass index) so whole passes can be skipped cheaply on
    resume (advance fast-forwards pass count arithmetic, not iteration)."""

    def __init__(self, *, sample_count, shuffle=False, seed=0, start=0, step=1, advance=0):
        self._sample_count = sample_count
        self._shuffle = shuffle
        self._seed = seed
        self._start = start
        self._step = step
        self._advance = advance

    def __iter__(self):
        shard_len = self._sample_count // self._step
        iter_count = self._advance // shard_len if shard_len else 0
        skip = self._advance - iter_count * shard_len
        perm = (
            np.random.default_rng(self._seed).permutation(self._sample_count)
            if self._shuffle
            else np.arange(self._sample_count)
        )
        shard = perm[self._start :: self._step][:shard_len]
        while True:
            if self._shuffle:
                seed = self._seed + self._start + (iter_count << 24)
                out = np.random.default_rng(seed).permutation(shard)
            else:
                out = shard
            for idx in out.tolist():
                if skip > 0:
                    skip -= 1
                    continue
                yield idx
            iter_count += 1
