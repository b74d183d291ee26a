"""Host-side image IO + the pre/post resize protocol of the SR CLIs.

Optional min-side guard upscale, x``upscale`` enlargement, snap to a
multiple of 8 with LANCZOS, and the final resize-back when the guard
triggered. Everything that touches PIL imports it inside the function, so
the array-level halves (``array_to_sr_input`` / ``sr_output_to_uint8``) work
on a machine without Pillow; everything on the device is NHWC float.
"""

from __future__ import annotations

import numpy as np
import torch


def load_image_rgb(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


def prepare_input(img, process_size: int, upscale: int):
    """Returns (resized PIL image, resize_flag, original (w, h))."""
    from PIL import Image

    ow, oh = img.size
    resize_flag = False
    if ow < process_size // upscale or oh < process_size // upscale:
        scale = (process_size // upscale) / min(ow, oh)
        img = img.resize((int(scale * ow), int(scale * oh)))
        resize_flag = True
    img = img.resize((img.size[0] * upscale, img.size[1] * upscale))
    new_w = img.width - img.width % 8
    new_h = img.height - img.height % 8
    img = img.resize((new_w, new_h), Image.LANCZOS)
    return img, resize_flag, (ow, oh)


def prepared_hw(h: int, w: int, process_size: int, upscale: int):
    """The (H, W) that prepare_input gives an h x w image (no PIL needed)."""
    if w < process_size // upscale or h < process_size // upscale:
        scale = (process_size // upscale) / min(w, h)
        w, h = int(scale * w), int(scale * h)
    w, h = w * upscale, h * upscale
    return h - h % 8, w - w % 8


def array_to_sr_input(arr_u8: np.ndarray, size_bucket: int):
    """uint8 (H, W, 3), already resized -> (lq (1,H',W',3) in [-1,1]
    reflect-padded up to the size bucket, src01 (1,H,W,3) in [0,1],
    true_hw before padding)."""
    arr_u8 = np.asarray(arr_u8)
    if arr_u8.ndim != 3 or arr_u8.shape[2] != 3 or arr_u8.dtype != np.uint8:
        raise ValueError(f"expected a uint8 (H, W, 3) array, got {arr_u8.dtype} {arr_u8.shape}")
    src01 = (arr_u8.astype(np.float32) / 255.0)[None]
    lq = (src01 * 2.0 - 1.0).astype(np.float32)
    true_hw = lq.shape[1:3]
    if size_bucket:
        ph = (-lq.shape[1]) % size_bucket
        pw = (-lq.shape[2]) % size_bucket
        if ph or pw:
            lq = np.pad(lq, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="reflect")
    return lq, src01, true_hw


def sr_output_to_uint8(out, src01, true_hw, fix_fn=None, already01: bool = False) -> np.ndarray:
    """Device batch (1,H',W',3) -> uint8 (H, W, 3): crop the bucket pad,
    [-1,1] -> [0,1], optional color fix against src01, clip, quantise.
    already01=True means the batch is already color-fixed [0,1] (the
    serving daemon's fused path): only crop + fetch remain."""
    out = out[:, : true_hw[0], : true_hw[1], :].float()
    if not already01:
        out = out * 0.5 + 0.5
        if fix_fn is not None:
            out = fix_fn(out, torch.as_tensor(src01, dtype=torch.float32, device=out.device))
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("SR output holds non-finite values")
    out = torch.clamp(out, 0.0, 1.0)
    return (out[0] * 255.0).round().to(torch.uint8).cpu().numpy()


def pil_to_array_pm1(img, dtype=np.float32) -> np.ndarray:
    """PIL -> (1, H, W, 3) in [-1, 1]."""
    arr = np.asarray(img, np.float32) / 255.0
    return (arr[None] * 2.0 - 1.0).astype(dtype)


def pil_to_array_01(img, dtype=np.float32) -> np.ndarray:
    return (np.asarray(img, np.float32) / 255.0)[None].astype(dtype)


def array01_to_pil(arr: np.ndarray):
    """(1,H,W,3) or (H,W,3) in [0,1] -> PIL (uint8, clipped)."""
    from PIL import Image

    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(np.asarray(arr, np.float32), 0.0, 1.0)
    return Image.fromarray((arr * 255.0).round().astype(np.uint8))


def finalize_output(out_pil, resize_flag: bool, orig_size, upscale: int):
    if resize_flag:
        ow, oh = orig_size
        out_pil = out_pil.resize((int(upscale * ow), int(upscale * oh)))
    return out_pil


def preprocess_sr_input(img, process_size: int, upscale: int, size_bucket: int):
    """The full SR input protocol: pre-resize, [-1,1] and [0,1] arrays, and
    reflect-pad up to the size bucket.

    Returns (lq (1,H,W,3) [-1,1] bucket-padded, src01, resize_flag,
    orig (w,h), true_hw before padding)."""
    inp, resize_flag, orig = prepare_input(img, process_size, upscale)
    lq, src01, true_hw = array_to_sr_input(np.asarray(inp, np.uint8), size_bucket)
    return lq, src01, resize_flag, orig, true_hw


def postprocess_sr_output(
    out_dev, src01, true_hw, fix_fn, resize_flag, orig_size, upscale: int,
    already01: bool = False,
):
    """Inverse protocol: sr_output_to_uint8, then undo the pre-resize."""
    from PIL import Image

    out_u8 = sr_output_to_uint8(out_dev, src01, true_hw, fix_fn, already01)
    return finalize_output(Image.fromarray(out_u8), resize_flag, orig_size, upscale)
