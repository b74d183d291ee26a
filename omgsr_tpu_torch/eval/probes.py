"""Frozen-feature evaluation probes: the weighted k-NN of the SSL CLI's
in-train eval.

The port of the k-NN part of ``omgsr_tpu/eval/probes.py`` (dinov3/eval/
knn.py KnnModule:96-185): the eval transform, the ImageFolder listing, the
batched feature extraction and the temperature-weighted vote, on one
process. The linear probes and logistic regression are ROADMAP Queue 1
item 3.3. Feature extraction uses the 256-resize / 224-center-crop eval
transform (data/transforms.py make_classification_eval_transform).
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from omgsr_tpu_torch.data.ssl import IMAGENET_MEAN, IMAGENET_STD


def make_eval_transform(resize_size: int = 256, crop_size: int = 224):
    """Resize the shortest side, center crop, ImageNet-normalise
    (data/transforms.py:76-95): PIL image -> float32 HWC numpy."""

    def transform(img) -> np.ndarray:
        from PIL import Image

        w, h = img.size
        scale = resize_size / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
        w, h = img.size
        left, top = (w - crop_size) // 2, (h - crop_size) // 2
        img = img.crop((left, top, left + crop_size, top + crop_size))
        x = np.asarray(img.convert("RGB"), np.float32) / 255.0
        return (x - IMAGENET_MEAN) / IMAGENET_STD

    return transform


def list_imagefolder(d: str):
    """A dir-per-class listing -> (paths, labels, classes). Paths, not
    decoded images: ``extract_features`` decodes per batch."""
    classes = sorted(x for x in os.listdir(d) if os.path.isdir(os.path.join(d, x)))
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {d}")
    paths, labels = [], []
    for ci, c in enumerate(classes):
        cd = os.path.join(d, c)
        for f in sorted(os.listdir(cd)):
            paths.append(os.path.join(cd, f))
            labels.append(ci)
    return paths, np.asarray(labels), classes


def extract_features(apply_fn: Callable, images: Sequence, batch_size: int = 64, transform=None):
    """``apply_fn`` (a float32 NHWC numpy batch -> (B, D) tensor or array)
    over the images in host batches; the tail batch is padded with its last
    image so every call has one shape. Items may be PIL images, arrays or
    paths (opened per batch). Returns (N, D) float32 numpy."""
    from PIL import Image

    transform = transform or make_eval_transform()

    def load(im):
        if isinstance(im, (str, bytes)) or hasattr(im, "__fspath__"):
            with Image.open(im) as f:
                return transform(f.convert("RGB"))
        return transform(im)

    feats = []
    for i in range(0, len(images), batch_size):
        chunk = [load(im) for im in images[i:i + batch_size]]
        n = len(chunk)
        while len(chunk) < batch_size:
            chunk.append(chunk[-1])
        out = apply_fn(np.stack(chunk))
        out = out.detach().float().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out, np.float32)
        feats.append(out[:n])
    return np.concatenate(feats, axis=0)


def knn_classify(train_features, train_labels, test_features, *, ks: Sequence[int] = (10, 20, 100, 200),
                 T: float = 0.07, num_classes: int, skip_first_nn: bool = False):
    """Temperature-weighted k-NN vote (KnnModule.forward:168-185): the
    similarities test @ train^T, the top max(ks) (+1 when skipping self), a
    vote softmax(sims / T), and per k the one-hot neighbour labels weighted
    by the vote over the first k. Features L2-normalised by the caller.
    Returns {k: (B, num_classes) f32}."""
    max_k = max(ks) + int(skip_first_nn)
    sims = test_features.float() @ train_features.float().t()
    topk_sims, idx = torch.topk(sims, min(max_k, sims.shape[1]), dim=1)
    neighbor_labels = train_labels[idx]
    if skip_first_nn:
        topk_sims, neighbor_labels = topk_sims[:, 1:], neighbor_labels[:, 1:]
    vote = torch.softmax(topk_sims / T, dim=1)
    onehot = torch.nn.functional.one_hot(neighbor_labels.long(), num_classes).to(vote.dtype)
    weighted = onehot * vote[:, :, None]
    return {k: torch.sum(weighted[:, :k, :], dim=1) for k in ks}
