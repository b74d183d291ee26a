"""ctypes binding for the native JPEG/PNG decoder (native/imgdec.cpp).

PairedDataset's fast decode path: the decode runs entirely in C (the GIL
released by ctypes), so a loader thread decodes while the main thread
enqueues device work. The library is compiled at first use with ``g++ ...
-ljpeg -lpng`` into ``omgsr_tpu_torch/build/`` (named by a hash of its
source, written under a temporary name and renamed into place); nothing is
written beside the source. Where ``g++``, the libjpeg / libpng headers or
the source are missing, or a file does not decode, the caller falls back to
PIL; ``status()`` says which decoder is in use and why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PACKAGE_DIR), "native", "imgdec.cpp")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "build")
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIBS = ("-ljpeg", "-lpng")

_lock = threading.Lock()
_state = {"lib": None, "path": None, "error": None}


def _library_path(src: bytes) -> str:
    digest = hashlib.sha256(src + " ".join(_FLAGS + _LIBS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libimgdec-{digest}.so")


def _build_and_load():
    with open(SOURCE, "rb") as f:
        so = _library_path(f.read())
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        r = subprocess.run(["g++", *_FLAGS, SOURCE, *_LIBS, "-o", tmp], capture_output=True, text=True)
        if r.returncode != 0:
            raise OSError(f"g++ exit {r.returncode}: {r.stderr.strip()[-400:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name in ("decode_jpeg_rgb", "decode_png_rgb"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
    return lib, so


def load_library():
    """The decoder library, built first if need be; None where it cannot be
    built or loaded (the reason is kept for ``status()``)."""
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            try:
                _state["lib"], _state["path"] = _build_and_load()
            except (OSError, subprocess.SubprocessError) as e:  # no g++, no headers, no source
                _state["error"] = f"{type(e).__name__}: {e}"
        return _state["lib"]


def status() -> str:
    """Which decoder PairedDataset uses here, and why."""
    if load_library() is not None:
        return f"native libjpeg/libpng decoder ({_state['path']})"
    return f"PIL (the native decoder is unavailable: {_state['error']})"


_MAX_BYTES = 8192 * 8192 * 3  # 64MP cap


def decode_rgb(path: str) -> np.ndarray | None:
    """Decode a .jpg/.jpeg/.png file to (H, W, 3) uint8; None on failure
    (caller falls back to PIL)."""
    lib = load_library()
    if lib is None:
        return None
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        fn = lib.decode_jpeg_rgb
    elif ext == ".png":
        fn = lib.decode_png_rgb
    else:
        return None
    buf = np.empty(_MAX_BYTES, np.uint8)
    w = ctypes.c_int32(0)
    h = ctypes.c_int32(0)
    rc = fn(
        path.encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _MAX_BYTES,
        ctypes.byref(w),
        ctypes.byref(h),
    )
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()
