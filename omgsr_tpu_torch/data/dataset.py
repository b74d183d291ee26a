"""Paired SR dataset: HQ images -> (lq, hq) training pairs.

Re-implements dataset/my_dataset.py: collects .png/.jpg/.jpeg from dirs or
.txt lists (:28-35), RandomCrop(pad_if_needed, reflect) + Resize +
RandomHorizontalFlip (:18-26), the FFHQ->512 LANCZOS special case (:43-44),
Real-ESRGAN degradation per item, both images normalized to [-1,1]
(:47-53).

Crop and flip run on the host (numpy, PIL, the native decoder), from numpy
Generators seeded as in the JAX package, so one seed gives its arrays and
order. The degradation runs batched on the device (RealESRGANDegrader). A
producer thread decodes batches ahead of the consumer; the counterpart of the
reference's DataLoader(num_workers=8).

On a world of processes each rank's loader takes its contiguous rows of each
global batch from one global order (shuffled alike on every rank), and
crops and degrades them with generators of its own, seeded by ``rank_seed``:
the reference's per-rank DataLoader. The JAX loader has no multi-process
mode; with one rank everything is as it is there.
"""

from __future__ import annotations

import collections
import glob
import os
import queue
import threading

import numpy as np
import torch

from omgsr_tpu_torch.data import imgdec_native
from omgsr_tpu_torch.utils.devices import resolve_device


def collect_paths(dataset_txt_or_dir_paths) -> list[str]:
    out = []
    for p in dataset_txt_or_dir_paths:
        if os.path.isdir(p):
            out.extend(
                glob.glob(f"{p}/*.png") + glob.glob(f"{p}/*.jpg") + glob.glob(f"{p}/*.jpeg")
            )
        elif os.path.splitext(p)[1] == ".txt":
            with open(p) as f:
                out.extend(line.strip() for line in f.readlines())
        else:
            raise ValueError(
                f"Unsupported path type: {p}. Expected either a directory or a file named 'txt'"
            )
    return out


def _random_crop_reflect(arr: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    """RandomCrop(size, pad_if_needed=True, padding_mode='reflect')."""
    h, w = arr.shape[:2]
    if h < size or w < size:
        ph = max(0, size - h)
        pw = max(0, size - w)
        arr = np.pad(
            arr,
            ((ph // 2 + ph % 2, ph // 2), (pw // 2 + pw % 2, pw // 2), (0, 0)),
            mode="reflect",
        )
        h, w = arr.shape[:2]
    y = int(rng.integers(0, h - size + 1))
    x = int(rng.integers(0, w - size + 1))
    return arr[y : y + size, x : x + size]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of a rank's crop and degradation generators: ``seed`` itself
    on rank 0 (so one process draws what it always drew), a seed derived from
    (seed, rank) on the others."""
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1)[0])


class PairedDataset:
    """Index-able HQ-image dataset producing crop-preprocessed float arrays
    in [0,1]; degradation happens batched in the loader. ``decoders`` counts
    the items each decoder ("native", "pil") produced."""

    def __init__(self, dataset_txt_or_dir_paths, resolution: int, seed: int = 0):
        self.resolution = resolution
        self.gt_list = collect_paths(dataset_txt_or_dir_paths)
        self.rng = np.random.default_rng(seed)
        self.decoders = collections.Counter()

    def __len__(self):
        return len(self.gt_list)

    def __getitem__(self, idx: int) -> np.ndarray:
        from PIL import Image

        path = self.gt_list[idx]
        arr8 = None
        if "ffhq" not in path or self.resolution != 512:
            arr8 = imgdec_native.decode_rgb(path)  # native libjpeg/libpng fast path
        if arr8 is not None:
            self.decoders["native"] += 1
            arr = arr8.astype(np.float32) / 255.0
        else:
            self.decoders["pil"] += 1
            img = Image.open(path).convert("RGB")
            if "ffhq" in path and self.resolution == 512:
                img = img.resize((512, 512), Image.LANCZOS)
            arr = np.asarray(img, np.float32) / 255.0
        arr = _random_crop_reflect(arr, min(self.resolution, max(arr.shape[:2])), self.rng)
        if arr.shape[0] != self.resolution:
            img = Image.fromarray((arr * 255).astype(np.uint8)).resize(
                (self.resolution, self.resolution), Image.BILINEAR
            )
            arr = np.asarray(img, np.float32) / 255.0
        if self.rng.uniform() < 0.5:  # RandomHorizontalFlip
            arr = arr[:, ::-1]
        return np.ascontiguousarray(arr)


class PairedLoader:
    """Iterates (lq, hq) batches in [-1,1] NHWC f32 on ``device``.

    A producer thread reads and crops batches (decoding in C where it can)
    into pinned memory, up to ``prefetch`` ahead. The consumer keeps a one-deep
    device pipeline: it copies batch N+1 to the card with ``non_blocking=True``
    and enqueues its degradation on the current stream before it yields batch
    N, and nothing in that dispatch waits for the device. An error in the
    producer is raised in the consumer; a consumer that stops early stops the
    producer. degrader: RealESRGANDegrader, or None for identity pairs.

    ``batch_size`` is the global batch. With ``world`` ranks over "data" this
    loader yields rows [rank * b, (rank + 1) * b) of each global batch, b =
    batch_size / world, of one order that every rank shuffles alike from
    ``seed``; ``len()`` counts global batches. The dataset's crop generator
    and the degrader are the caller's to seed per rank (``rank_seed``).
    """

    def __init__(
        self,
        dataset: PairedDataset,
        batch_size: int,
        degrader=None,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
        drop_last: bool = True,
        device="cuda",
        rank: int = 0,
        world: int = 1,
    ):
        if batch_size % world:
            raise ValueError(f"train_batch_size {batch_size} does not split over {world} ranks of \"data\"")
        self.ds = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.degrader = degrader
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.device = resolve_device(device)

    def __len__(self):
        n = len(self.ds) // self.batch_size
        if not self.drop_last and len(self.ds) % self.batch_size:
            n += 1
        return n

    def _batches(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idxs = order[i : i + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                return
            share = len(idxs) // self.world
            idxs = idxs[self.rank * share : (self.rank + 1) * share]
            yield np.stack([self.ds[int(j)] for j in idxs])

    def _dispatch(self, hq: torch.Tensor) -> dict:
        """Host batch [0,1] (pinned where the device is a GPU) -> (lq, hq) on
        the device in [-1,1], enqueued without waiting for the device."""
        gt = hq.to(self.device, non_blocking=True)
        if self.degrader is not None:
            gt, lq = self.degrader(gt)
        else:
            lq = gt
        return {"lq": lq * 2.0 - 1.0, "hq": gt * 2.0 - 1.0}

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop, done = object(), threading.Event()
        pin = self.device.type == "cuda"

        def put(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for hq in self._batches():
                    t = torch.from_numpy(hq)
                    if not put(t.pin_memory() if pin else t):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
                return
            put(stop)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            # when the producer is ahead, dispatch the next batch's degradation
            # before yielding the previous one; when the producer is the
            # bottleneck (queue empty), yield at once instead of holding the
            # ready batch hostage to the next disk read
            pending = None
            while True:
                if pending is not None:
                    try:
                        hq = q.get_nowait()
                    except queue.Empty:
                        yield pending
                        pending = None
                        hq = q.get()
                else:
                    hq = q.get()
                if isinstance(hq, Exception):
                    raise hq
                if hq is stop:
                    if pending is not None:
                        yield pending
                    return
                batch = self._dispatch(hq)
                if pending is not None:
                    yield pending
                pending = batch
        finally:
            done.set()
            thread.join(timeout=60)
