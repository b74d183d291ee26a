"""Benchmark dataset-format adapters — the reference's preprocessed data
layouts, consumable by pretrain_dinov3 / train_dinotxt / eval_dinov3.

Re-owns dinov3/data/datasets/{image_net,image_net_22k,ade20k,
coco_captions,extended,decoders}.py and the dataset-string grammar of
dinov3/data/loaders.py (_parse_dataset_str:46-74) without the
torchvision VisionDataset base: each adapter is a plain indexable object
yielding (PIL image, target), plus a lazy `.images` Sequence view that
plugs straight into eval.probes.extract_features (which accepts PIL
items) and the SSL/dinotxt loaders.

Formats:
- ImageNet     (image_net.py:55-176): images on disk under
  root/{train,val,test}/..., indexed by extra/entries-SPLIT.npy +
  class-ids/class-names npy sidecars; `dump_extra()` builds the sidecars
  by scanning the disk layout + labels.txt.
- ImageNet22k  (image_net_22k.py:69-240): one <class_id>.tar per class
  mmap'd read-only, entries.npy holding 512-byte-block offsets produced
  from blocks/<class_id>.log listings; gzipped members are sniffed by
  magic (the reference pins a hardcoded index set, :70-96 — sniffing is
  the general form of the same check).
- ADE20K       (ade20k.py:48-88): ADE20K_object150_{split}.txt file
  lists, images/ + annotations/ PNG dense targets (target stays in its
  native palette mode, decoders.py DenseTargetDecoder:34-40).
- CocoCaptions (coco_captions.py:23-88): the trainval2014/2017 caption
  JSONs; a target is one caption drawn from the image's caption list.

Grammar: "ImageNet:split=TRAIN:root=/data/in1k:extra=/data/in1k-extra"
(split names are case-insensitive). `is_dataset_spec` lets CLI path
arguments double as dataset strings.

The port's own copy of the JAX package's host-only module (numpy, PIL, the
standard library): the same specs, the same files, the same items.
"""

from __future__ import annotations

import csv
import json
import os
import threading
import zlib
from io import BytesIO
from mmap import ACCESS_READ, mmap
from typing import Any, Optional, Sequence

import numpy as np

__all__ = [
    "ADE20KDataset",
    "CocoCaptionsDataset",
    "ImageNet22kDataset",
    "ImageNetDataset",
    "ImageView",
    "is_dataset_spec",
    "make_dataset",
]

_TAR_BLOCK = 512


def _pil():
    from PIL import Image

    return Image


def _decode_rgb(data: bytes):
    """ImageDataDecoder (decoders.py:17-23)."""
    return _pil().open(BytesIO(data)).convert("RGB")


class ImageView(Sequence):
    """Lazy Sequence of decoded PIL images over a dataset — O(1) memory,
    directly consumable by eval.probes.extract_features."""

    def __init__(self, dataset):
        self._ds = dataset

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._ds.get_image(j) for j in range(*i.indices(len(self)))]
        return self._ds.get_image(i)


class _Dataset:
    """Common surface: bytes -> PIL -> (image, target) (extended.py:31-43)."""

    def get_image_data(self, index: int) -> bytes:
        raise NotImplementedError

    def get_image(self, index: int):
        return _decode_rgb(self.get_image_data(index))

    def get_target(self, index: int) -> Any:
        raise NotImplementedError

    def get_targets(self) -> Optional[np.ndarray]:
        return None

    @property
    def images(self) -> ImageView:
        return ImageView(self)

    def __getitem__(self, index: int):
        return self.get_image(index), self.get_target(index)

    def __len__(self) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# ImageNet (entries-SPLIT.npy sidecar layout)
# ---------------------------------------------------------------------------


class ImageNetDataset(_Dataset):
    """image_net.py:55-176 — disk images indexed by npy sidecars under
    `extra`: entries-SPLIT.npy (actual_index, class_index, class_id,
    class_name), class-ids-SPLIT.npy, class-names-SPLIT.npy."""

    SPLITS = ("train", "val", "test")

    def __init__(self, *, root: str, extra: str, split: str = "train"):
        split = split.lower()
        if split not in self.SPLITS:
            raise ValueError(f"split {split!r} not in {self.SPLITS}")
        self.root, self.extra, self.split = root, extra, split
        self._entries: Optional[np.ndarray] = None
        self._classes: Optional[list] = None

    # -- sidecar paths (image_net.py:101-111)
    @property
    def _entries_path(self) -> str:
        return os.path.join(self.extra, f"entries-{self.split.upper()}.npy")

    def _sidecar(self, stem: str) -> str:
        return os.path.join(self.extra, f"{stem}-{self.split.upper()}.npy")

    @property
    def entries(self) -> np.ndarray:
        if self._entries is None:
            self._entries = np.load(self._entries_path, mmap_mode="r")
        return self._entries

    @property
    def classes(self) -> list:
        """class ids ordered by class_index (class-ids-SPLIT.npy)."""
        if self._classes is None:
            self._classes = [str(c) for c in np.load(self._sidecar("class-ids"))]
        return self._classes

    def _relpath(self, entry) -> str:
        """get_image_relpath (image_net.py:37-44)."""
        if self.split == "train":
            class_id = str(entry["class_id"])
            base = f"{class_id}_{int(entry['actual_index'])}"
            return os.path.join(self.split, class_id, base + ".JPEG")
        base = f"ILSVRC2012_{self.split}_{int(entry['actual_index']):08d}"
        if self.split == "val":
            return os.path.join(self.split, str(entry["class_id"]), base + ".JPEG")
        return os.path.join(self.split, base + ".JPEG")

    def get_image_path(self, index: int) -> str:
        return os.path.join(self.root, self._relpath(self.entries[index]))

    def get_image_data(self, index: int) -> bytes:
        with open(self.get_image_path(index), "rb") as f:
            return f.read()

    def get_image(self, index: int):
        return _pil().open(self.get_image_path(index)).convert("RGB")

    def get_target(self, index: int) -> Optional[int]:
        if self.split == "test":
            return None
        return int(self.entries[index]["class_index"])

    def get_targets(self) -> Optional[np.ndarray]:
        if self.split == "test":
            return None
        return np.asarray(self.entries["class_index"])

    def get_paths_labels(self):
        """(paths, labels, classes) — the eval.probes.list_imagefolder
        contract, so eval_dinov3 consumes this layout unchanged."""
        if self.split == "test":
            raise ValueError(
                "ImageNet TEST split has no labels (image_net.py:118-120) — "
                "probe against split=TRAIN or split=VAL"
            )
        paths = [self.get_image_path(i) for i in range(len(self))]
        return paths, self.get_targets(), self.classes

    def __len__(self) -> int:
        return len(self.entries)

    # -- sidecar writer (image_net.py _dump_entries/_dump_class_ids)
    def dump_extra(self) -> None:
        """Scan root/{split}/ (+ labels.txt `class_id,class_name` rows) and
        write the three npy sidecars."""
        split_dir = os.path.join(self.root, self.split)
        rows = []  # (actual_index, class_index, class_id, class_name)
        if self.split == "test":
            for f in sorted(os.listdir(split_dir)):
                stem, ext = os.path.splitext(f)
                if ext.lower() != ".jpeg":
                    continue
                rows.append((int(stem.split("_")[-1]), 0, "", ""))
            class_ids, class_names = [], []
        else:
            names = {}
            labels_path = os.path.join(self.root, "labels.txt")
            if os.path.exists(labels_path):
                with open(labels_path) as f:
                    names = {cid: cname for cid, cname in csv.reader(f)}
            class_ids = sorted(
                d
                for d in os.listdir(split_dir)
                if os.path.isdir(os.path.join(split_dir, d))
            )
            class_names = [names.get(c, c) for c in class_ids]
            for ci, cid in enumerate(class_ids):
                for f in sorted(os.listdir(os.path.join(split_dir, cid))):
                    stem, ext = os.path.splitext(f)
                    if ext.lower() != ".jpeg":
                        continue
                    rows.append((int(stem.split("_")[-1]), ci, cid, names.get(cid, cid)))
        max_id = max((len(r[2]) for r in rows), default=1) or 1
        max_name = max((len(r[3]) for r in rows), default=1) or 1
        dtype = np.dtype(
            [
                ("actual_index", "<u4"),
                ("class_index", "<u4"),
                ("class_id", f"U{max_id}"),
                ("class_name", f"U{max_name}"),
            ]
        )
        entries = np.array(rows, dtype=dtype)
        os.makedirs(self.extra, exist_ok=True)
        np.save(self._entries_path, entries)
        np.save(self._sidecar("class-ids"), np.asarray(class_ids))
        np.save(self._sidecar("class-names"), np.asarray(class_names))
        self._entries = self._classes = None


# ---------------------------------------------------------------------------
# ImageNet-22k (per-class tarballs + 512-byte-block entries)
# ---------------------------------------------------------------------------


class ImageNet22kDataset(_Dataset):
    """image_net_22k.py:69-240 — entries.npy rows address byte ranges
    inside mmap'd <class_id>.tar files; the 512-byte tar header of each
    member is skipped and gzipped members are inflated (sniffed by the
    0x1f8b magic instead of the reference's hardcoded index set)."""

    def __init__(self, *, root: str, extra: str, mmap_cache_size: int = 16):
        self.root, self.extra = root, extra
        self._entries: Optional[np.ndarray] = None
        self._class_ids: Optional[np.ndarray] = None
        self._mmaps: dict = {}
        self._mmap_cache_size = mmap_cache_size
        # threaded readers (eval feature-extraction loops) share the LRU:
        # eviction must not close an mmap another thread is mid-slice on
        self._mmap_lock = threading.Lock()

    @property
    def entries(self) -> np.ndarray:
        if self._entries is None:
            self._entries = np.load(
                os.path.join(self.extra, "entries.npy"), mmap_mode="r"
            )
        return self._entries

    @property
    def class_ids(self) -> np.ndarray:
        if self._class_ids is None:
            self._class_ids = np.load(os.path.join(self.extra, "class-ids.npy"))
        return self._class_ids

    def _read_member(self, class_id: str, start: int, end: int) -> bytes:
        """Bounded-LRU mmap cache read (_make_mmap_tarball:57-66). The copy
        out of the mmap happens UNDER the lock so a concurrent reader's
        eviction can never close a map mid-slice."""
        with self._mmap_lock:
            m = self._mmaps.pop(class_id, None)
            if m is None:
                if len(self._mmaps) >= self._mmap_cache_size:
                    # dict preserves insertion order and re-insert-on-access
                    # moves hits to the back, so the FRONT is least-recently-used
                    lru = next(iter(self._mmaps))
                    self._mmaps.pop(lru).close()
                with open(os.path.join(self.root, f"{class_id}.tar")) as f:
                    m = mmap(fileno=f.fileno(), length=0, access=ACCESS_READ)
            self._mmaps[class_id] = m  # re-insert: most-recently-used last
            return bytes(m[start:end])

    def get_image_data(self, index: int) -> bytes:
        entry = self.entries[index]
        data = self._read_member(
            str(entry["class_id"]),
            int(entry["start_offset"]) + _TAR_BLOCK,
            int(entry["end_offset"]),
        )
        if len(data) >= 2 and data[:2] == b"\x1f\x8b":
            # single-member gzip inflate that tolerates the tar block
            # padding after the stream (GzipFile.read would reject it)
            data = zlib.decompressobj(wbits=31).decompress(data)
        return data

    def get_target(self, index: int) -> int:
        return int(self.entries[index]["class_index"])

    def get_targets(self) -> np.ndarray:
        return np.asarray(self.entries["class_index"])

    def find_class_id(self, class_index: int) -> str:
        return str(self.class_ids[class_index])

    def get_paths_labels(self):
        """(images, labels, classes) in the list_imagefolder contract —
        "paths" are lazily decoded PIL items (tar members have no paths)."""
        return self.images, self.get_targets(), [str(c) for c in self.class_ids]

    def __len__(self) -> int:
        return len(self.entries)

    def dump_extra(self) -> None:
        """Build entries.npy / class-ids.npy from blocks/<class_id>.log
        listings ("block NNN: filename" per member, NULs sentinel last —
        _load_entries_class_ids:142-183)."""
        class_ids = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(self.root)
            if f.endswith(".tar")
        )
        rows = []  # (class_index, class_id, start, end, filename)
        for ci, cid in enumerate(class_ids):
            blocks = []  # (block_offset, maybe_filename)
            with open(os.path.join(self.root, "blocks", f"{cid}.log")) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line:
                        continue
                    block, filename = line.split(":", 1)
                    offset, filename = int(block[6:]), filename[1:]
                    blocks.append(
                        (offset, None if filename == "** Block of NULs **" else filename)
                    )
            if not blocks or blocks[-1][1] is not None:
                raise RuntimeError(f"blocks log for {cid} lacks the NULs sentinel")
            for (off1, fname), (off2, _) in zip(blocks, blocks[1:]):
                if fname is None:
                    continue
                rows.append((ci, cid, _TAR_BLOCK * off1, _TAR_BLOCK * off2, fname))
        max_id = max((len(r[1]) for r in rows), default=1) or 1
        max_fn = max((len(r[4]) for r in rows), default=1) or 1
        dtype = np.dtype(
            [
                ("class_index", "<u4"),
                ("class_id", f"U{max_id}"),
                # u8: per-class tarballs can exceed 4 GiB — u4 would silently
                # wrap offsets into corrupt member reads
                ("start_offset", "<u8"),
                ("end_offset", "<u8"),
                ("filename", f"U{max_fn}"),
            ]
        )
        os.makedirs(self.extra, exist_ok=True)
        np.save(os.path.join(self.extra, "entries.npy"), np.array(rows, dtype=dtype))
        np.save(os.path.join(self.extra, "class-ids.npy"), np.asarray(class_ids))
        self._entries = self._class_ids = None

    def close(self) -> None:
        with self._mmap_lock:
            for m in self._mmaps.values():
                m.close()
            self._mmaps.clear()


# ---------------------------------------------------------------------------
# ADE20K (file-list + dense PNG targets)
# ---------------------------------------------------------------------------


class ADE20KDataset(_Dataset):
    """ade20k.py:48-88 — ADE20K_object150_{split}.txt names, image bytes
    under root/images/, dense targets under root/annotations/ with the
    same stem as .png (kept in native palette mode: DenseTargetDecoder)."""

    SPLITS = ("train", "val")

    def __init__(self, *, root: str, split: str = "train"):
        split = split.lower()
        if split not in self.SPLITS:
            raise ValueError(f"split {split!r} not in {self.SPLITS}")
        self.root, self.split = root, split
        with open(os.path.join(root, f"ADE20K_object150_{split}.txt")) as f:
            names = sorted(f.read().strip().split("\n"))
        self.image_paths = [os.path.join("images", n) for n in names]
        self.target_paths = [
            os.path.join("annotations", os.path.splitext(n)[0] + ".png")
            for n in names
        ]

    def get_image_data(self, index: int) -> bytes:
        with open(os.path.join(self.root, self.image_paths[index]), "rb") as f:
            return f.read()

    def get_target(self, index: int):
        with open(os.path.join(self.root, self.target_paths[index]), "rb") as f:
            return _pil().open(BytesIO(f.read()))

    def get_target_array(self, index: int) -> np.ndarray:
        """dense label map as (H, W) int32 — the eval-side consumable."""
        return np.asarray(self.get_target(index), dtype=np.int32)

    def __len__(self) -> int:
        return len(self.image_paths)


# ---------------------------------------------------------------------------
# COCO captions
# ---------------------------------------------------------------------------


class CocoCaptionsDataset(_Dataset):
    """coco_captions.py:23-88 — {train: captions_train2014.json +
    train2014/, val: captions_train2017.json + val2017/} (the reference's
    own split mapping); target = one caption from the image's list."""

    SPLITS = ("train", "val")

    def __init__(self, *, root: str, split: str = "train", seed: int = 0):
        split = split.lower()
        if split not in self.SPLITS:
            raise ValueError(f"split {split!r} not in {self.SPLITS}")
        self.root, self.split = root, split
        if split == "train":
            ann = os.path.join(
                root, "annotations_trainval2014", "annotations", "captions_train2014.json"
            )
            image_dir = os.path.join(root, "train2014", "train2014")
        else:
            ann = os.path.join(
                root, "annotations_trainval2017", "annotations", "captions_train2017.json"
            )
            image_dir = os.path.join(root, "val2017", "val2017")
        with open(ann) as f:
            raw = json.load(f)
        data = {
            item["id"]: {
                "image": os.path.join(image_dir, item["file_name"]),
                "captions": [],
            }
            for item in raw["images"]
        }
        for item in raw["annotations"]:
            data[item["image_id"]]["captions"].append(item["caption"])
        self.items = list(data.values())
        self._rng = np.random.default_rng(seed)

    def get_image_path(self, index: int) -> str:
        return self.items[index]["image"]

    def get_image_data(self, index: int) -> bytes:
        with open(self.get_image_path(index), "rb") as f:
            return f.read()

    def get_image(self, index: int):
        return _pil().open(self.get_image_path(index)).convert("RGB")

    def get_captions(self, index: int) -> list:
        return list(self.items[index]["captions"])

    def get_target(self, index: int, rng: Optional[np.random.Generator] = None) -> str:
        caps = self.items[index]["captions"]
        return str(caps[(rng or self._rng).integers(len(caps))])

    def get_pairs(self):
        """[(image_path, caption_tuple)] — the train_dinotxt loader
        contract (a tuple target means: draw one per access)."""
        return [(it["image"], tuple(it["captions"])) for it in self.items]

    def __len__(self) -> int:
        return len(self.items)


# ---------------------------------------------------------------------------
# dataset-string grammar (loaders.py:46-74)
# ---------------------------------------------------------------------------

_DATASETS = {
    "imagenet": ImageNetDataset,
    "imagenet22k": ImageNet22kDataset,
    "ade20k": ADE20KDataset,
    "cococaptions": CocoCaptionsDataset,
}


def dataset_type(dataset_str: str) -> type:
    """Adapter class named by a spec, without constructing it (capability
    checks before the disk layout is touched)."""
    cls = _DATASETS.get(dataset_str.split(":", 1)[0].lower())
    if cls is None:
        raise ValueError(f"unsupported dataset {dataset_str.split(':', 1)[0]!r}")
    return cls


def is_dataset_spec(s: Any) -> bool:
    return (
        isinstance(s, str)
        and ":" in s
        and s.split(":", 1)[0].lower() in _DATASETS
    )


def make_dataset(dataset_str: str):
    """"ImageNet:split=TRAIN:root=...:extra=..." -> adapter instance."""
    tokens = dataset_str.split(":")
    cls = _DATASETS.get(tokens[0].lower())
    if cls is None:
        raise ValueError(f"unsupported dataset {tokens[0]!r}")
    kwargs = {}
    for token in tokens[1:]:
        key, _, value = token.partition("=")
        if key not in ("root", "extra", "split"):
            raise ValueError(f"unsupported dataset kwarg {key!r}")
        kwargs[key] = value.lower() if key == "split" else value
    return cls(**kwargs)
