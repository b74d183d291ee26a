"""The safetensors format, read and written without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, then N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, offsets relative to the end of the header), then the raw
little-endian bytes of every tensor. ``load_file`` maps the file into memory
(``torch.UntypedStorage.from_file``, private pages: writing to a returned
tensor never reaches the file) and returns views into that map, so reading a
checkpoint touches only the bytes a caller uses; a tensor whose offset is not
a multiple of its element size is copied out. ``save_file`` writes tensors in
the order the ``safetensors`` package does (larger element sizes first, then
by name), with the header padded by spaces to a multiple of 8 bytes.
"""

from __future__ import annotations

import json
import os
import struct
import sys

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}

if sys.byteorder != "little":  # the format's bytes are little-endian; so are torch's on this host
    raise ImportError("omgsr_tpu_torch.convert.safetensors_io needs a little-endian host")


def _read_header(path: str) -> tuple[dict, int]:
    """(the JSON header, the byte offset where the data begins)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} runs past the end of the file ({size} bytes)")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, as views into a private
    memory map of the file."""
    header, base = _read_header(path)
    header.pop("__metadata__", None)
    size = os.path.getsize(path)
    if not header:
        return {}
    data = torch.empty(0, dtype=torch.uint8)
    data.set_(torch.UntypedStorage.from_file(path, False, size))
    out = {}
    for name, info in header.items():
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader does not take")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        item = torch.empty((), dtype=dtype).element_size()
        n = 1
        for s in shape:
            n *= s
        if end - begin != n * item or base + end > size:
            raise ValueError(f"{path}: {name} {info['dtype']}{list(shape)} does not fit offsets {begin}..{end}")
        raw = data[base + begin:base + end]
        if (base + begin) % item:
            raw = raw.clone()
        out[name] = raw.view(dtype).reshape(shape)
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str, metadata: dict[str, str] | None = None):
    """Write ``tensors`` (any device, any layout: each is written as its
    contiguous CPU copy) to ``path``."""
    items = []
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
        if t.dtype not in NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name here")
        items.append((name, t))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header = {}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)  # a reader never sees a half-written file
