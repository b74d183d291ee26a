"""Checks and times the flash-attention forward kernels on one NVIDIA GPU.

    python -m omgsr_tpu_torch.tools.check_flash_fwd [--quick] [--unet-enqueue] [--against DIR]

Builds ``csrc/flash_attention_fwd.cu`` (the compiler's register, shared-memory
and spill report is printed, and the build time; a spill in the kernels built
for Hopper fails the run) and holds the bf16 kernels against
``flash_attention_plain`` at ``K1_SHAPES`` (the bf16 D = 64/128 rows of
``chip_smoke.py``'s kernels phase) and ``K1_WIDE_SHAPES`` (its D = 512 rows;
``chip_smoke.py`` takes both, the tolerances and the card's peak rates from
here), plus one head over one kv tile and small ragged shapes: the error over
the largest |plain| value within ``TOL``, the log-sum-exp within ``TOL_LSE``,
and the same bits from two runs. At D = 512 the wrapper's path is checked, with
the kv loop split as ``fwd_kv_splits`` says (the split count is printed), and
the merge kernel alone against ``flash_attention_merge_plain``.
For each shape it prints the kernel's time (CUDA events around back-to-back
calls, the host's launch path included, as ``chip_smoke.py`` times it) and its
device time (calls replayed from a CUDA graph), TFLOP/s and share of the card's
bound from the device time. The library call's time at the same shapes is
``chip_smoke.py``'s (the port's package names no library attention).
``--quick`` runs the shapes of at most 2^20 scores, untimed: the first run
after a change to a kernel, kept short because a wrong barrier phase hangs
(run it under ``timeout``).

``--against DIR`` also builds ``DIR/omgsr_tpu_torch/csrc/flash_attention_fwd.cu``
(a checkout of another commit, same C entry ``flash_attention_fwd``, which it
calls unsplit), holds it to the same checks and times it in turns with this
one (other, this, this, other) at every shape.
``--unet-enqueue`` then times the full-width UNet's host enqueue with each of
the two builds in turns: the per-launch tensor-map encoding must not slow the
host, which a UNet stage at batch 1 waits for. Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.ops.kernel_build import (
    BUILD_DIR,
    NVCC_FLAGS,
    _find_nvcc,
    build_kernels,
    launch_kernel,
)

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# bf16 output against the plain version: max |kernel - plain| over the largest
# |plain| value of the shape, two bf16 steps (chip_smoke.py says why); the f32
# log-sum-exp in absolute terms
TOL = 2.0 ** -6
TOL_LSE = 1e-3

K1_SHAPES = [
    # (B, Sq, H, D), Skv, on the serving path?, q/k/v as views of one packed (B, S, 3, H, D) tensor?
    ((1, 4096, 5, 64), 4096, True, False),
    ((1, 4096, 5, 64), 77, True, False),
    ((1, 1024, 10, 64), 1024, True, False),
    ((1, 64, 20, 64), 64, True, False),
    ((1, 4608, 24, 128), 4608, False, False),  # the -F DiT's joint attention
    # ragged Sq and Skv, read by strides (TMA tensor maps)
    ((2, 300, 3, 64), 300, False, True),
    ((2, 300, 3, 128), 300, False, True),
    # the 768x768 request runs its four latent tiles as one UNet batch of 4
    ((4, 1024, 10, 64), 1024, True, False),
    ((4, 4096, 5, 64), 77, True, False),
]
K1_WIDE_SHAPES = [
    # the VAE mid block's single 512-wide head: the whole latent at 512, 1024 and 2048 px
    # (the full-image and exact routes), the fast tiled decode's 86x86-latent window
    # (7396 tokens end inside a 64-row q and kv tile), ragged packed q/k/v
    ((1, 4096, 1, 512), 4096, True, False),
    ((1, 16384, 1, 512), 16384, True, False),
    ((1, 65536, 1, 512), 65536, True, False),
    ((1, 7396, 1, 512), 7396, True, False),
    ((2, 300, 2, 512), 300, False, True),
]
SMALL_SHAPES = [
    ((1, 128, 1, 64), 128, False, False),  # one head, one q tile, one kv tile
    ((1, 128, 1, 128), 128, False, False),
    ((1, 77, 1, 64), 77, False, False),  # one partial q tile and kv tile
    ((1, 200, 2, 128), 300, False, False),  # partial last tiles, two kv tiles
    ((1, 64, 1, 512), 64, False, False),  # D = 512: one q tile, one kv tile
    ((1, 100, 1, 512), 77, False, False),  # two partial q tiles, two kv tiles (the last partial)
    ((1, 200, 1, 512), 1000, False, False),  # 16 kv tiles, the last partial; split in 8
]
# the kernels built for Hopper: a spill in them fails the run
NEW_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_wide_wgmma_kernel", "flash_fwd_merge_kernel")


def ptxas_report(text):
    """{kernel: (registers, spill stores, spill loads)} from nvcc's -Xptxas -v
    output, one entry per instance (mangled name)."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, None, None]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name in out:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name in out:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def flash_plain_in_chunks(q, k, v):
    """flash_attention_plain over blocks of query rows, each with at most 2^28
    scores (1 GiB in f32): rows are independent, so this is the same function,
    and at 65,536 tokens it needs no 16 GiB score matrix."""
    b, sq, h, _ = q.shape
    rows = max(1, 2 ** 28 // (b * h * k.shape[1]))
    if rows >= sq:
        return FA.flash_attention_plain(q, k, v, return_lse=True)
    parts = [FA.flash_attention_plain(q[:, i : i + rows], k, v, return_lse=True) for i in range(0, sq, rows)]
    return torch.cat([o for o, _ in parts], dim=1), torch.cat([lse for _, lse in parts], dim=1)


def _randn(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", torch.bfloat16)


def _time_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, per_graph, replays=5):
    """Device time of one call: `per_graph` calls captured in a CUDA graph and
    replayed, so the host's launch path is out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * per_graph)


def _bind(lib):
    fn = lib.flash_attention_fwd
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i] + [ll] * 9 + [ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn


def _build_other(source):
    """Start nvcc on another checkout's kernel source (csrc/<name>.cu) -> (path, process)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{Path(source).stem}-against.so"
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _launcher(fn):
    """The forward through the C entry `fn`, with the operands and the call of
    ops.flash_attention._forward (and none of its launch count)."""

    def run(q, k, v):
        b, sq, h, d = q.shape
        q, k, v = FA._kernel_operand(q), FA._kernel_operand(k), FA._kernel_operand(v)
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
        launch_kernel(fn, "flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), 0, b, h, sq, k.shape[1], d,
                      *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], float(d ** -0.5))
        return out, lse

    run.fn = fn
    return run


def _inputs(shape, skv, packed, seed):
    b, sq, h, d = shape
    if packed:
        q, k, v = _randn((b, sq, 3, h, d), seed).unbind(2)
    else:
        q, k, v = _randn(shape, seed), _randn((b, skv, h, d), seed + 1), _randn((b, skv, h, d), seed + 2)
    return q, k, v


def _check(run, q, k, v, ref, ref_lse):
    """(scaled error, lse error, bit-identical twice) of one build."""
    out, lse = run(q, k, v)
    torch.cuda.synchronize()
    again, lse2 = run(q, k, v)
    torch.cuda.synchronize()
    scaled = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    err_lse = (lse - ref_lse).abs().max().item()
    same = torch.equal(out, again) and torch.equal(lse, lse2)
    finite = bool(torch.isfinite(out.float()).all() and torch.isfinite(lse).all())
    return scaled, err_lse, same and finite


def check_merge():
    """The merge kernel alone against flash_attention_merge_plain on chunks
    made by flash_attention_split_plain -> failed checks."""
    failed = []
    for i, (shape, skv, splits) in enumerate((((1, 300, 2, 512), 1000, 3), ((1, 4096, 1, 512), 4096, 2))):
        q, k, v = _inputs(shape, skv, False, 900 + 10 * i)
        b, sq, h, d = shape
        o_part, lse_part = FA.flash_attention_split_plain(q, k, v, d ** -0.5, splits)
        out, lse = FA.flash_attention_merge(o_part, lse_part, b, h)
        torch.cuda.synchronize()
        again, lse2 = FA.flash_attention_merge(o_part, lse_part, b, h)
        ref, ref_lse = FA.flash_attention_merge_plain(o_part, lse_part, b, h)
        scaled = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        err_lse = (lse - ref_lse).abs().max().item()
        same = torch.equal(out, again) and torch.equal(lse, lse2)
        ok = scaled <= TOL and err_lse <= TOL_LSE and same
        print(f"merge q{list(shape)} kv{skv} in {splits} chunks: err {scaled:.3g} of max |plain| (bound {TOL:.3g}), "
              f"lse err {err_lse:.3g} (bound {TOL_LSE}), bit-identical twice {same}: {'ok' if ok else 'FAILED'}",
              flush=True)
        if not ok:
            failed.append(f"merge {shape}")
    return failed


def unet_enqueue(other, samples=7):
    """The SD2.1 UNet at full width (bf16, weights from a seed) on one 64 x 64
    latent with 77 text tokens, its flash-attention launches through the C
    entry `other` and this checkout's in turns (other, this, this, other): the
    host's enqueue time of one call (no synchronize inside; median of
    `samples`) and the call's time by CUDA events. At batch 1 the UNet waits
    for the host, so the enqueue time is what a change to the launch path moves."""
    from omgsr_tpu_torch.convert.params import init_unet
    from omgsr_tpu_torch.models.configs import SD21_UNET
    from omgsr_tpu_torch.models.unet_sd import unet_apply

    params = init_unet(1, SD21_UNET, torch.bfloat16, "cuda")
    z, ctx = _randn((1, 64, 64, 4), 7), _randn((1, 77, 1024), 8)
    libraries = {"against": other, "this": FA._library()}
    enqueue = {tag: [] for tag in libraries}
    events = {tag: [] for tag in libraries}
    with torch.no_grad():
        for tag in ("against", "this", "this", "against"):
            with mock.patch.object(FA, "_library", lambda fn=libraries[tag]: fn):
                unet_apply(params, SD21_UNET, z, 273, ctx)
                before = FA.launches.count
                for _ in range(samples):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    unet_apply(params, SD21_UNET, z, 273, ctx)
                    enqueue[tag].append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.synchronize()
                launches = (FA.launches.count - before) // samples
                events[tag].append(_time_ms(lambda: unet_apply(params, SD21_UNET, z, 273, ctx), 5))
    for tag in libraries:
        print(f"unet enqueue {tag}: median {statistics.median(enqueue[tag]):.3f} ms over {len(enqueue[tag])} calls "
              f"(min {min(enqueue[tag]):.3f}); by CUDA events {' / '.join(f'{t:.3f}' for t in events[tag])} ms; "
              f"{launches} flash launches a call", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true", help="small shapes only, no timing")
    parser.add_argument("--against", type=Path, help="a checkout of another commit to time in turns")
    parser.add_argument("--unet-enqueue", action="store_true",
                        help="with --against: also time the full-width UNet's host enqueue with both builds, in turns")
    args = parser.parse_args(argv)
    if args.unet_enqueue and args.against is None:
        parser.error("--unet-enqueue compares two builds: give --against")
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_fwd needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    other = None if args.against is None else _build_other(args.against / "omgsr_tpu_torch/csrc/flash_attention_fwd.cu")
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        build_kernels(["flash_attention_fwd"], verbose=True)
    print(report.getvalue(), flush=True)
    print(f"build flash_attention_fwd: {time.perf_counter() - t0:.1f} s", flush=True)
    runs = {"this": lambda q, k, v: FA._forward(q, k, v, q.shape[-1] ** -0.5)}
    launchers = {"this": _launcher(FA._library())}
    kernels = {n: r for n, r in ptxas_report(report.getvalue()).items() if any(k in n for k in NEW_KERNELS)}
    if not kernels:
        print("ptxas: no report (the library was built before this run)", flush=True)
    failed = []
    for name, (regs, stores, loads) in sorted(kernels.items()):
        ok = stores == 0 and loads == 0
        print(f"ptxas: {name}: {regs} registers, spill stores {stores} bytes, loads {loads} bytes: "
              f"{'ok' if ok else 'SPILLS'}", flush=True)
        if not ok:
            failed.append(f"spills in {name}")
    if other is not None:
        path, proc = other
        out, _ = proc.communicate()
        print(f"--- build against (nvcc exit {proc.returncode}) ---\n{out}", flush=True)
        if proc.returncode != 0:
            raise SystemExit("build against failed")
        runs["against"] = launchers["against"] = _launcher(_bind(ctypes.CDLL(str(path))))
        print(f"builds done in {time.perf_counter() - t0:.1f} s", flush=True)

    failed += check_merge()
    sms = FA.sm_count(torch.device("cuda", torch.cuda.current_device()))
    shapes = SMALL_SHAPES + K1_SHAPES + K1_WIDE_SHAPES
    if args.quick:
        shapes = [r for r in shapes if r[0][0] * r[0][1] * r[0][2] * r[1] <= 2 ** 20]
    for i, (shape, skv, _, packed) in enumerate(shapes):
        b, sq, h, d = shape
        q, k, v = _inputs(shape, skv, packed, 1000 + 10 * i)
        ref, ref_lse = flash_plain_in_chunks(q, k, v)
        splits = FA.fwd_kv_splits(b, h, sq, skv, d, sms)
        label = f"q{list(shape)} kv{skv}" + (" packed" if packed else "") + (f" (kv loop in {splits})" if d == 512 else "")
        for tag, run in runs.items():
            scaled, err_lse, same = _check(run, q, k, v, ref, ref_lse)
            ok = scaled <= TOL and err_lse <= TOL_LSE and same
            if not ok:
                failed.append(f"{label} {tag}")
            print(f"{label} {tag}: err {scaled:.3g} of max |plain| (bound {TOL:.3g}), lse err {err_lse:.3g} "
                  f"(bound {TOL_LSE}), bit-identical twice and finite {same}: {'ok' if ok else 'FAILED'}",
                  flush=True)
        if args.quick:
            continue
        flops = 4.0 * b * h * sq * skv * d
        nbytes = 2 * (2 * q.numel() + 2 * k.numel()) + 4 * b * h * sq
        bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        iters = 2 if flops > 1e12 else 10 if flops > 1e11 else 50
        calls = {tag: (lambda run=run: run(q, k, v)) for tag, run in launchers.items()}
        if d == 512:
            calls["this"] = lambda: runs["this"](q, k, v)  # the split kv loop and the merge where taken
        order = ("against", "this", "this", "against") if "against" in calls else ("this", "this")
        wall = {tag: [] for tag in calls}
        dev = {tag: [] for tag in calls}
        for tag in order:
            wall[tag].append(_time_ms(calls[tag], iters))
            dev[tag].append(_graph_ms(calls[tag], iters))
        parts = []
        for tag in calls:
            ms, dms = sum(wall[tag]) / len(wall[tag]), sum(dev[tag]) / len(dev[tag])
            parts.append(f"{tag} {ms:.4f} ms ({' / '.join(f'{t:.4f}' for t in wall[tag])}), device {dms:.4f} "
                         f"({' / '.join(f'{t:.4f}' for t in dev[tag])}), {flops / dms / 1e9:.1f} TFLOP/s, "
                         f"{bound_ms / dms:.3f} of bound")
        print(f"{label}: " + "; ".join(parts) + f"; bound {bound_ms:.5f} ms ({'operations' if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else 'bytes'})",
              flush=True)
    if args.unet_enqueue:
        unet_enqueue(launchers["against"].fn)
    if failed:
        print("FAILED: " + ", ".join(failed), flush=True)
        sys.exit(1)
    print("all checks held", flush=True)


if __name__ == "__main__":
    main()
