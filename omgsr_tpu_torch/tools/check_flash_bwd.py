"""A short first run for the flash-attention backward kernels on one NVIDIA GPU.

    python -m omgsr_tpu_torch.tools.check_flash_bwd [--quick] [--against DIR]

Builds ``csrc/flash_attention_bwd.cu`` (and the forward, which makes the saved
output and log-sum-exp), prints the compiler's register, shared-memory and
spill report and fails if the bf16 kernels (``flash_bwd_dq_wgmma_kernel``,
``flash_bwd_dkv_wgmma_kernel``, ``flash_bwd_dkv_reduce_kernel`` at head dims
64 and 128, ``flash_bwd_dq_wide_wgmma_kernel`` and
``flash_bwd_dkv_wide_wgmma_kernel`` at 512) spill. Then, at each shape, it holds the
backward wrapper's dq, dk and dv against ``flash_attention_bwd_plain``: the
error over the largest |plain| value within ``TOL`` (the forward tool's), the
same bits from two runs, finite values, and the delta prologue against
rowsum(dO * O), and the forward that made the saved output and log-sum-exp
against ``flash_attention_plain``. ``--quick`` runs the small shapes only (one head with one tile
each way, ragged ends, packed q/k/v with a permuted dO, a split dK/dV loop, at
head dims 64, 128 and 512),
untimed: the first run after a change to a kernel, kept short because a wrong
barrier phase hangs (run it under ``timeout``). Without it the bf16 rows of
``chip_smoke.py``'s backward shapes (``K2_SHAPES`` at head dims 64 and 128,
``WIDE_SHAPES`` at 512: the VAE mid block at 512 and 1024 px, ragged and
packed, which ``chip_smoke.py`` takes from here) are checked
too and each kernel is timed by
CUDA-graph replay (device time), with TFLOP/s and its share of the card's
bound, and by the host's time to issue one call (the training step waits for
the host).

``--against DIR`` also builds ``DIR/omgsr_tpu_torch/csrc/flash_attention_bwd.cu``
(a checkout of another commit with the C entry ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv_split``, or, before the split, ``flash_attention_bwd_dkv``),
holds it to the same checks and times both builds' kernels in turns (other,
this, this, other) at every shape; an other build with the split entry runs
this build's split choice. At head dims 64 and 128 this build's dK/dV kernel is
also timed at every split of its q loop from 1 up to one wave of blocks (at
least 4), beside the split ``dkv_splits`` takes: the measurement its cost
constants are fitted to. ``EXTRA_SHAPES`` (f32) are checked, untimed. Exits 1
if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.ops.kernel_build import build_kernels, launch_kernel
from omgsr_tpu_torch.tools.check_flash_fwd import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S,
    TOL,
    TOL_LSE,
    _build_other,
    _graph_ms,
    flash_plain_in_chunks,
    ptxas_report,
)

K2_SHAPES = [
    # (B, Sq, H, D), Skv, on the training path?, q/k/v packed in one (B, S, 3, H, D) tensor and dO permuted?
    ((1, 4096, 5, 64), 4096, True, False),
    ((1, 4096, 5, 64), 77, True, False),
    ((1, 1024, 10, 64), 1024, True, False),
    ((1, 1024, 10, 64), 77, True, False),
    ((1, 256, 20, 64), 256, True, False),
    ((1, 256, 20, 64), 77, True, False),
    ((1, 64, 20, 64), 64, True, False),  # the mid block: one q tile, one kv tile, no split
    ((1, 64, 20, 64), 77, True, False),
    ((2, 300, 3, 64), 300, False, True),
    ((1, 4608, 24, 128), 4608, True, False),  # the -F training shape (the DiT's joint attention)
    ((4, 1024, 10, 64), 77, False, False),  # cross-attention at batch 4: 40 kv blocks, split in 3
    # the two sides of dkv_splits' choice: 50 kv blocks, split in 2; 140 (past one wave) not split
    ((1, 1024, 10, 64), 640, False, False),
    ((1, 1024, 10, 64), 1700, False, False),
    ((2, 300, 2, 128), 77, False, False),  # ragged, split in 5
]
WIDE_SHAPES = [
    ((1, 4096, 1, 512), 4096, True, False),  # the VAE mid block at 512 px
    ((1, 1100, 1, 512), 700, False, False),  # ends inside a 64-row q and a 64-row kv tile
    ((1, 16384, 1, 512), 16384, True, False),  # the VAE mid block at 1024 px (-F training at 1024 px)
    ((2, 300, 2, 512), 300, False, True),
]
# checked only, not timed: the f32 kernels, which chip_smoke.py does not hold
# at this shape. (B, Sq, H, D), Skv, dtype, packed?
EXTRA_SHAPES = [
    ((2, 300, 2, 128), 77, torch.float32, False),
]
TOL_F32 = 2e-4  # f32 kernels against the plain version (chip_smoke.py's)
SMALL_SHAPES = [
    ((1, 64, 1, 64), 64, False, False),  # one head, one tile each way, one consumer warpgroup
    ((1, 128, 1, 128), 128, False, False),
    ((1, 77, 1, 64), 77, False, False),  # ragged q and kv
    ((1, 200, 2, 128), 300, False, False),  # partial last tiles both ways
    ((2, 300, 3, 64), 300, False, True),
    ((2, 300, 3, 128), 300, False, True),
    ((1, 300, 2, 64), 77, False, False),  # the dK/dV q loop split in 5, the last chunk ragged
    ((2, 256, 3, 128), 77, False, True),  # split in 4, packed
    ((1, 192, 67, 64), 64, False, False),  # 67 heads: the dQ kernel takes three consumer warpgroups
    ((1, 130, 67, 64), 100, False, False),  # the same, ragged: its third warpgroup owns two rows
    ((1, 64, 1, 512), 64, False, False),  # one pair of CTAs each way, one stream step
    ((1, 200, 1, 512), 130, False, False),  # ragged q and kv, more steps than the ring's two stages
    ((2, 300, 2, 512), 300, False, True),
]
NEW_KERNELS = ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_reduce_kernel",
               "flash_bwd_dq_wide_wgmma_kernel", "flash_bwd_dkv_wide_wgmma_kernel")


def _randn(shape, seed, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to("cuda", dtype)


def _inputs(shape, skv, packed, seed, dtype=torch.bfloat16):
    b, sq, h, d = shape
    if packed:
        q, k, v = _randn((b, sq, 3, h, d), seed, dtype).unbind(2)
        dout = _randn((b, h, sq, d), seed + 3, dtype).permute(0, 2, 1, 3)  # as autograd may hand it over
    else:
        q, k, v = (_randn(shape, seed, dtype), _randn((b, skv, h, d), seed + 1, dtype),
                   _randn((b, skv, h, d), seed + 2, dtype))
        dout = _randn(shape, seed + 3, dtype)
    return q, k, v, dout


def _other_launchers(lib):
    """dq and dk/dv through another build's C entries, with the operands and
    the calls of ops.flash_attention._launch_dq / _launch_dkv (none of their
    launch counts): its dK/dV entry with a split q loop where it has one (this
    build's split choice), else the one without."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    dq_fn = lib.flash_attention_bwd_dq
    dq_fn.argtypes = [vp] * 8 + [i] * 6 + [strides, f, vp]
    dq_fn.restype = ctypes.c_int
    split_entry = hasattr(lib, "flash_attention_bwd_dkv_split")
    dkv_fn = lib.flash_attention_bwd_dkv_split if split_entry else lib.flash_attention_bwd_dkv
    dkv_fn.argtypes = [vp] * 8 + [i] * 6 + [strides, f] + ([i, vp] if split_entry else []) + [vp]
    dkv_fn.restype = ctypes.c_int

    def run_dq(q, k, v, out, lse, dout, scale):
        b, sq, h, d = q.shape
        delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        launch_kernel(dq_fn, "flash_attention_bwd_dq", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      FA._DTYPE_CODE[q.dtype], b, h, sq, k.shape[1], d, FA._strides(q, k, v, out, dout),
                      float(scale))
        return dq, delta

    def run_dkv(q, k, v, lse, delta, dout, scale):
        b, sq, h, d = q.shape
        skv = k.shape[1]
        dk = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        split = ()
        if split_entry:
            splits = (FA.dkv_splits(b, h, sq, skv, d, FA.sm_count(q.device))
                      if q.dtype == torch.bfloat16 and d in FA._SPLIT_HEAD_DIMS else 1)
            partial = (torch.empty((splits, 2, b * h, skv, d), dtype=torch.float32, device=q.device)
                       if splits > 1 else None)
            split = (splits, None if partial is None else partial.data_ptr())
        launch_kernel(dkv_fn, "flash_attention_bwd_dkv", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      FA._DTYPE_CODE[q.dtype], b, h, sq, skv, d, FA._strides(q, k, v, dout), float(scale),
                      *split)
        return dk, dv

    return run_dq, run_dkv


def _enqueue_us(fn, calls=50):
    """The host's time to issue one call (no synchronize inside), mean over
    `calls` back-to-back calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _check(launchers, q, k, v, out, lse, dout, ref, delta_ref, scale):
    """(largest error over max |plain| of dq, dk, dv; delta error; bit-identical
    twice and finite) of one build."""
    run_dq, run_dkv = launchers
    got = []
    for _ in range(2):
        dq, delta = run_dq(q, k, v, out, lse, dout, scale)
        dk, dv = run_dkv(q, k, v, lse, delta, dout, scale)
        torch.cuda.synchronize()
        got.append((dq, dk, dv, delta))
    scaled = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                 for a, r in zip(got[0][:3], ref))
    err_delta = (got[0][3] - delta_ref).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(got[0], got[1]))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got[0])
    return scaled, err_delta, same and finite


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true", help="small shapes only, no timing")
    parser.add_argument("--against", type=Path, help="a checkout of another commit to check and time in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_bwd needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    failed = []
    t0 = time.perf_counter()
    other = None if args.against is None else _build_other(args.against / "omgsr_tpu_torch/csrc/flash_attention_bwd.cu")
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        build_kernels(["flash_attention_bwd", "flash_attention_fwd"], verbose=True)
    print(report.getvalue(), flush=True)
    print(f"build flash_attention_bwd + fwd: {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = {name: r for name, r in ptxas_report(report.getvalue()).items() if any(k in name for k in NEW_KERNELS)}
    if not kernels:
        print("ptxas: no report (the libraries were built before this run)", flush=True)
    for name, (regs, stores, loads) in sorted(kernels.items()):
        ok = stores == 0 and loads == 0
        print(f"ptxas: {name}: {regs} registers, spill stores {stores} bytes, loads {loads} bytes: "
              f"{'ok' if ok else 'SPILLS'}", flush=True)
        if not ok:
            failed.append(f"spills in {name}")

    builds = {"this": (FA._launch_dq, FA._launch_dkv)}
    if other is not None:
        path, proc = other
        out, _ = proc.communicate()
        print(f"--- build against (nvcc exit {proc.returncode}) ---\n{out}", flush=True)
        if proc.returncode != 0:
            raise SystemExit("build against failed")
        builds["against"] = _other_launchers(ctypes.CDLL(str(path)))
        print(f"builds done in {time.perf_counter() - t0:.1f} s", flush=True)

    bf16 = torch.bfloat16
    shapes = [(shape, skv, bf16, packed, not args.quick) for shape, skv, _, packed in SMALL_SHAPES]
    if not args.quick:
        shapes += [(shape, skv, bf16, packed, True) for shape, skv, _, packed in K2_SHAPES + WIDE_SHAPES]
        shapes += [(shape, skv, dtype, packed, False) for shape, skv, dtype, packed in EXTRA_SHAPES]
    sms = FA.sm_count(torch.device("cuda", torch.cuda.current_device()))
    for i, (shape, skv, dtype, packed, timed) in enumerate(shapes):
        b, sq, h, d = shape
        scale = d ** -0.5
        q, k, v, dout = _inputs(shape, skv, packed, 2000 + 10 * i, dtype)
        out, lse = FA.flash_attention(q, k, v, return_lse=True)
        # the forward that made the saved output and lse, against its plain version
        ref_out, ref_lse = flash_plain_in_chunks(q, k, v)
        fwd_err = ((out.float() - ref_out.float()).abs().max() / ref_out.float().abs().max()).item()
        fwd_lse = (lse - ref_lse).abs().max().item()
        fwd_ok = fwd_err <= (TOL if dtype == bf16 else TOL_F32) and fwd_lse <= TOL_LSE
        if not fwd_ok:
            failed.append(f"forward q{list(shape)} kv{skv}")
        ref = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        delta_ref = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, sq)
        ops = [FA._kernel_operand(t) for t in (q, k, v, out, dout)]
        qo, ko, vo, oo, go = ops
        lse = lse.contiguous()
        splits = (FA.dkv_splits(b, h, sq, skv, d, sms)
                  if dtype == bf16 and d in FA._SPLIT_HEAD_DIMS else 1)
        grid = (f"dQ / dK/dV CTAs {' / '.join(map(str, FA.wide_bwd_ctas(b, h, sq, skv)))}"
                if dtype == bf16 and d == 512 else f"dK/dV q loop in {splits}")
        label = (f"q{list(shape)} kv{skv}" + ("" if dtype == bf16 else " f32") + (" packed" if packed else "")
                 + f" ({grid})")
        tol = TOL if dtype == bf16 else TOL_F32
        for tag, launchers in builds.items():
            scaled, err_delta, same = _check(launchers, qo, ko, vo, oo, lse, go, ref, delta_ref, scale)
            ok = scaled <= tol and err_delta <= 1e-4 * max(1.0, delta_ref.abs().max().item()) and same
            if not ok:
                failed.append(f"{label} {tag}")
            print(f"{label} {tag}: err {scaled:.3g} of max |plain| (bound {tol:.3g}), delta err {err_delta:.3g}, "
                  f"bit-identical twice and finite {same}: {'ok' if ok else 'FAILED'}; this build's forward: err "
                  f"{fwd_err:.3g}, lse err {fwd_lse:.3g}: {'ok' if fwd_ok else 'FAILED'}", flush=True)
        if not timed:
            continue
        work = b * h * sq * skv * d
        es = 2
        nbytes = {"dq": (4 * q.numel() + 2 * k.numel()) * es + 8 * b * h * sq,
                  "dkv": (2 * q.numel() + 4 * k.numel()) * es + 8 * b * h * sq}
        flops = {"dq": 6.0 * work, "dkv": 8.0 * work}
        bound = {n: max(flops[n] / PEAK_BF16_FLOPS, nbytes[n] / PEAK_BYTES_PER_S) * 1e3 for n in flops}
        pair_bound = max(10.0 * work / PEAK_BF16_FLOPS, (3 * q.numel() + 4 * k.numel() + q.numel()) * es
                         / PEAK_BYTES_PER_S) * 1e3
        per_graph = 5 if work > 1e10 else 20
        dev = {tag: {"dq": [], "dkv": []} for tag in builds}
        host = {tag: {"dq": [], "dkv": []} for tag in builds}
        order = ("against", "this", "this", "against") if "against" in builds else ("this", "this")
        for tag in order:
            run_dq, run_dkv = builds[tag]
            _, delta = run_dq(qo, ko, vo, oo, lse, go, scale)
            calls = {"dq": lambda: run_dq(qo, ko, vo, oo, lse, go, scale),
                     "dkv": lambda: run_dkv(qo, ko, vo, lse, delta, go, scale)}
            for n, fn in calls.items():
                dev[tag][n].append(_graph_ms(fn, per_graph))
                host[tag][n].append(_enqueue_us(fn))
        parts = []
        for tag in builds:
            ms = {n: sum(t) / len(t) for n, t in dev[tag].items()}
            us = {n: sum(t) / len(t) for n, t in host[tag].items()}
            pair = ms["dq"] + ms["dkv"]
            parts.append(
                f"{tag}: dq {ms['dq']:.4f} ms ({' / '.join(f'{t:.4f}' for t in dev[tag]['dq'])}; "
                f"{flops['dq'] / ms['dq'] / 1e9:.1f} TFLOP/s, {bound['dq'] / ms['dq']:.3f} of bound), "
                f"dkv {ms['dkv']:.4f} ({' / '.join(f'{t:.4f}' for t in dev[tag]['dkv'])}; "
                f"{flops['dkv'] / ms['dkv'] / 1e9:.1f} TFLOP/s, {bound['dkv'] / ms['dkv']:.3f} of bound), "
                f"pair {pair:.4f} ({pair_bound / pair:.3f} of the pair bound); host enqueue a call "
                f"dq {us['dq']:.1f} us, dkv {us['dkv']:.1f} us")
        print(f"{label} device ms: " + "; ".join(parts)
              + f"; bounds dq {bound['dq']:.5f} dkv {bound['dkv']:.5f} pair {pair_bound:.5f} ms", flush=True)
        if d in FA._SPLIT_HEAD_DIMS:
            _, delta = FA._launch_dq(qo, ko, vo, oo, lse, go, scale)
            n_tiles = -(-sq // FA.Q_TILE_ROWS)
            blocks = -(-skv // FA.DKV_BLOCK_ROWS) * b * h
            most = min(n_tiles, max(4, -(-sms // blocks)))
            times = {g: _graph_ms(lambda g=g: FA._launch_dkv(qo, ko, vo, lse, delta, go, scale, splits=g),
                                  per_graph) for g in range(1, most + 1)}
            print(f"{label} dK/dV device ms by split of the q loop ({blocks} blocks unsplit, {n_tiles} q tiles; "
                  f"dkv_splits takes {splits}): " + ", ".join(f"{g}: {t:.4f}" for g, t in times.items()), flush=True)
    if failed:
        print("FAILED: " + ", ".join(failed), flush=True)
        sys.exit(1)
    print("all checks held", flush=True)


if __name__ == "__main__":
    main()
