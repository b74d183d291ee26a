"""Pipelined batch inference runner for the CLIs.

The reference's loop is fully serial: load -> infer (cuda.synchronize) ->
colour fix -> save (infer/infer_omgsr_s.py:69-107). Here host work overlaps
device compute: a loader thread reads and preprocesses images ahead, the
main thread only enqueues the device work (CUDA launches return at once),
and a pool of saver threads blocks on each result (its ``.cpu()`` copy waits
for the device), applies the colour fix, and writes PNGs. The per-image wall
time is taken after that copy, so it is fenced on the device.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from omgsr_tpu_torch.ops.color import adain_color_fix, wavelet_color_fix
from omgsr_tpu_torch.utils.image_io import load_image_rgb, postprocess_sr_output, preprocess_sr_input


def run_batch(
    image_names,
    infer_fn,
    output_dir: str,
    process_size: int,
    upscale: int,
    align_method: str,
    prefetch: int = 2,
    savers: int = 2,
    size_bucket: int = 64,
    batch_size: int = 1,
    write: bool = True,
):
    """infer_fn(lq (B,H,W,3) f32 numpy in [-1,1], index) -> SR batch
    (B,H,W,3) in [-1,1] on the device (enqueued, not waited for).

    size_bucket: inputs are reflect-padded up to multiples of this many
    pixels and the SR output cropped back, so the images of a folder fall into
    few shapes (0 disables).

    batch_size: consecutive images that land in the same padded shape are
    stacked up to this size and run as one pipeline call (remainders flush at
    the end of the stream or on a bucket change). With batch_size > 1 the
    infer_fn receives the group's FIRST index, so a sampled latent's noise is
    drawn per batch. Returns the average seconds per image.

    write=False (the ranks other than 0 of a multi-GPU run): every image is
    run, in the same order, and nothing is written or timed.
    """
    if write:
        os.makedirs(output_dir, exist_ok=True)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = object()

    def loader():
        # per-image guard: one unreadable file must not end the thread before
        # the stop sentinel (the main loop would wait forever)
        try:
            for i, name in enumerate(image_names):
                try:
                    item = preprocess_sr_input(load_image_rgb(name), process_size, upscale, size_bucket)
                except Exception as e:  # noqa: BLE001
                    print(f"skipping {name}: {type(e).__name__}: {e}")
                    continue
                q.put((i, name, *item))
        finally:
            q.put(stop)

    t = threading.Thread(target=loader, daemon=True)
    t.start()

    fix = {"adain": adain_color_fix, "wavelet": wavelet_color_fix}.get(align_method)

    def save_one(out_dev, src01, name, resize_flag, orig, true_hw, t_start, times, n_batch):
        out_pil = postprocess_sr_output(out_dev, src01, true_hw, fix, resize_flag, orig, upscale)
        # per-image cost: the batch's wall time is shared by its images
        dt = (time.perf_counter() - t_start) / n_batch
        times.append(dt)
        print(f"Inference time per image: {dt}s")
        bname = os.path.basename(name).split(".")[0] + ".png"
        out_pil.save(os.path.join(output_dir, bname))

    times: list[float] = []
    with ThreadPoolExecutor(max_workers=savers) as pool:
        futures = []
        group: list = []  # same-bucket accumulation

        def flush():
            if not group:
                return
            items = list(group)
            group.clear()
            lq = np.concatenate([it[2] for it in items]).astype(np.float32)
            t0 = time.perf_counter()
            out = infer_fn(lq, items[0][0])
            if not write:
                return
            # backpressure: each pending future holds its batch's device output;
            # without a bound a loader faster than the device grows memory with the backlog
            while len(futures) > 4 * savers:
                futures.pop(0).result()
            for j, (i, name, _, src01, resize_flag, orig, true_hw) in enumerate(items):
                futures.append(
                    pool.submit(save_one, out[j : j + 1], src01, name, resize_flag, orig, true_hw, t0, times,
                                len(items))
                )

        while True:
            item = q.get()
            if item is stop:
                break
            if group and group[0][2].shape != item[2].shape:
                flush()  # bucket change; the flush after an append keeps len < batch_size
            group.append(item)
            if len(group) >= batch_size:
                flush()
        flush()
        for f in futures:
            f.result()

    avg = sum(times) / max(len(times), 1)
    if write:
        print(f"Average inference time: {avg}s")
    return avg
