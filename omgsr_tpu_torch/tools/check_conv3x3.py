"""Checks and times the 3x3-conv kernels on one NVIDIA GPU.

    python -m omgsr_tpu_torch.tools.check_conv3x3 [--quick] [--against DIR]

Builds ``csrc/conv3x3.cu`` (and ``csrc/group_norm_silu.cu``, which the fused
resblock also runs), prints the compiler's register, shared-memory and spill
report and fails if the bf16 conv kernel (``conv3x3_wgmma_kernel``, both the
resblock half and the plain conv) or the fold kernel (``gn_fold_kernel``)
spills. Then it holds ``conv3x3_gn_fused`` (with skip and sums, and without
either), ``conv3x3`` (with and without SiLU) and ``fold_gn_sums`` against
their plain versions: y within ``TOL`` of the largest |plain| value (two bf16
steps; 2e-4 in f32), the channel sums within ``TOL_CONV_SUMS_REL``, the folded
(scale, shift) within ``TOL_FOLD``, the same bits from two runs, finite
values. Both bf16 functions are checked at both tile heights.

``--quick`` runs small and ragged shapes only, untimed: the first run after a
change to a kernel, kept short because a wrong barrier phase hangs (run it
under ``timeout``). Without it the rows of ``CONV_SHAPES`` (which
``chip_smoke.py``'s kernels phase takes from here) are checked too, each
kernel is timed by CUDA-graph replay (device time, TFLOP/s and share of the
card's bound), both bf16 functions at both tile heights beside the one
the wrapper takes (``gn_fused_tile_rows``, ``CONV_TILE_ROWS``), and one ``fused_resblock`` is held against and
timed beside the unfused resnet.

``--against DIR`` also builds ``DIR/omgsr_tpu_torch/csrc/conv3x3.cu`` (a
checkout of another commit: this interface, or one before the bf16 kernels
took a tile height, read from that source's C entries), holds it to the same
checks and times both builds' kernels in turns (other, this, this, other) at
every timed row.
``--prologue-cost`` also builds this source with the resblock kernel's
prologue arithmetic taken out (the staged x is rounded back unchanged: wrong
results, timed only) and times it in turns with the real kernel at the bf16
rows of ``CONV_SHAPES``: what the GroupNorm+SiLU prologue costs the kernel.
Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.ops import conv3x3 as C3
from omgsr_tpu_torch.ops.flash_attention import sm_count
from omgsr_tpu_torch.ops.kernel_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _find_nvcc, build_kernels, launch_kernel
from omgsr_tpu_torch.tools.check_flash_fwd import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S,
    TOL,
    _build_other,
    _graph_ms,
    ptxas_report,
)

CONV_SHAPES = [
    # (H, W, C_in, C_out), dtype, on the fused serving path?
    ((512, 512, 128, 128), torch.bfloat16, True),  # the VAE's widest stage at 512 px
    ((512, 512, 256, 128), torch.bfloat16, True),  # decoder up3, first resnet (conv_shortcut)
    ((256, 256, 512, 256), torch.bfloat16, True),  # decoder up2, first resnet
    ((64, 64, 512, 512), torch.bfloat16, True),  # the mid blocks
    ((1024, 1024, 128, 128), torch.bfloat16, True),  # the widest stage of the 1024x1024 request
    ((30, 50, 128, 256), torch.float32, False),  # the FMA kernels, ragged tiles
    ((61, 45, 256, 128), torch.bfloat16, False),  # H and W no multiples of any tile
]
QUICK_SHAPES = [
    ((16, 16, 128, 128), torch.bfloat16),  # one tile, most of it outside the image
    ((13, 37, 256, 128), torch.bfloat16),
    ((61, 45, 256, 128), torch.bfloat16),
    ((9, 130, 128, 256), torch.bfloat16),  # three column tiles, the last ragged; two channel tiles
    ((20, 64, 512, 128), torch.bfloat16),  # eight chunks: both x slots reused, the weight ring wraps
    ((30, 50, 128, 256), torch.float32),
]
TOL_F32 = 2e-4
# conv3x3_gn_fused's channel sums: f32 accumulators on both sides; a sum of
# signed values can cancel to nothing, so the sum is held against the channel's
# sum of |y| and the sum of squares against itself. What differs is the order of
# the f32 sums and, in bf16, the activations of the prologue that round to
# another bf16 value (the kernel's tanh.approx against torch.sigmoid).
TOL_CONV_SUMS_REL = 1e-3
# fold_gn_sums: |kernel - plain| / max(1, |plain|) of scale and shift; the group
# sums are added in another order (f32), and var = E[x^2] - mean^2 passes on
# their relative error, amplified by E[x^2] / var
TOL_FOLD = 1e-4
KERNELS_NEW = ("conv3x3_wgmma_kernel", "gn_fold_kernel")
# the prologue's arithmetic in csrc/conv3x3.cu, and what --prologue-cost puts in its place
# (the staged x rounded back unchanged)
PROLOGUE_MATH = re.compile(r"r\[i\] = pack_bf16\(silu_half\(fmaf\(f\.x, a8\[2 \* i\], c8\[2 \* i\]\)\),\s*"
                           r"silu_half\(fmaf\(f\.y, a8\[2 \* i \+ 1\], c8\[2 \* i \+ 1\]\)\)\);")
PROLOGUE_NONE = "r[i] = pack_bf16(f.x, f.y);"


def _randn(shape, dtype, seed, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to("cuda", dtype)


def conv_inputs(shape, dtype, seed):
    """x, w (channels_last), b, a, c, skip of one shape; silu(c) is far from 0,
    so a pad ring activated instead of kept at zero shows."""
    h, w_, cin, cout = shape
    x = _randn((1, h, w_, cin), dtype, seed)
    w = _randn((cout, cin, 3, 3), dtype, seed + 1, 0.05).contiguous(memory_format=torch.channels_last)
    b = _randn((cout,), dtype, seed + 2, 0.1)
    a = _randn((cin,), torch.float32, seed + 3, 0.2, 1.0)
    c = _randn((cin,), torch.float32, seed + 4, 0.5, 0.5)
    skip = _randn((1, h, w_, cout), dtype, seed + 5)
    return x, w, b, a, c, skip


def sums_errors(ssum, ssq, ref, rsum, rsq):
    """(relative error of the channel sums, of the sums of squares), as held."""
    abs_sum = ref.float().abs().sum(dim=(0, 1, 2))
    err_sum = ((ssum.sum(0) - rsum[0]).abs() / abs_sum).max().item()
    err_sq = ((ssq.sum(0) - rsq[0]).abs() / rsq[0]).max().item()
    return err_sum, err_sq


def scaled_error(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def takes_tile_rows(source: str, entry: str) -> bool:
    """Whether the C entry ``entry`` of a conv3x3.cu source takes a tile height."""
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", source)
    return m is not None and "tile_rows" in m.group(1)


class Build:
    """The conv entries of one build of csrc/conv3x3.cu, called with the
    operands of ops.conv3x3's wrappers (and none of their launch counts);
    ``source`` is the text it was built from, which says which entries take
    a tile height."""

    def __init__(self, lib, source: str):
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.lib = lib
        self.tile_rows_arg = takes_tile_rows(source, "conv3x3_gn_fused")
        self.conv_rows_arg = takes_tile_rows(source, "conv3x3")
        lib.conv3x3.argtypes = [vp] * 4 + [i] * (7 if self.conv_rows_arg else 6) + [vp]
        lib.conv3x3.restype = i
        lib.conv3x3_gn_fused.argtypes = [vp] * 8 + [i] * (7 if self.tile_rows_arg else 6) + [vp]
        lib.conv3x3_gn_fused.restype = i
        lib.conv3x3_partials.argtypes = [i] * (4 if self.tile_rows_arg else 2)
        lib.conv3x3_partials.restype = i

    def conv(self, x, w, b, act="none", rows=None):
        """y as ``conv3x3`` returns it; ``rows`` the tile height (default: the
        wrapper's choice)."""
        _, h, width, cin = x.shape
        cout = w.shape[0]
        y = torch.empty((1, h, width, cout), dtype=x.dtype, device=x.device)
        extra = ()
        if self.conv_rows_arg:
            if rows is None:
                rows = C3.CONV_TILE_ROWS if x.dtype == torch.bfloat16 else 0
            extra = (rows,)
        launch_kernel(self.lib.conv3x3, "conv3x3", x.device, x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), y.data_ptr(), C3._DTYPE_CODE[x.dtype], C3._ACTS[act], h, width, cin, cout,
                      *extra)
        return y

    def gn_fused(self, x, w, b, a, c, skip=None, emit_stats=True, rows=None):
        """(y, ssum, ssq) as ``conv3x3_gn_fused`` returns them; ``rows`` the
        tile height (default: the wrapper's choice)."""
        _, h, width, cin = x.shape
        cout = w.shape[0]
        code = C3._DTYPE_CODE[x.dtype]
        y = torch.empty((1, h, width, cout), dtype=x.dtype, device=x.device)
        if self.tile_rows_arg:
            if rows is None:
                rows = C3.gn_fused_tile_rows(h, width, cout, sm_count(x.device)) if code == 0 else 0
            n_partials = self.lib.conv3x3_partials(code, h, width, rows)
            extra = (rows,)
        else:
            n_partials, extra = self.lib.conv3x3_partials(h, width), ()
        sums = torch.empty((2, n_partials, cout), dtype=torch.float32, device=x.device) if emit_stats else None
        launch_kernel(self.lib.conv3x3_gn_fused, "conv3x3_gn_fused", x.device, x.data_ptr(), w.data_ptr(),
                      b.data_ptr(), a.data_ptr(), c.data_ptr(), None if skip is None else skip.data_ptr(),
                      y.data_ptr(), None if sums is None else sums.data_ptr(), code, h, width, cin, cout,
                      n_partials, *extra)
        return (y, None, None) if sums is None else (y, sums[0], sums[1])


def check_k5(build, x, w, b, a, c, skip, rows=None):
    """The resblock half of one build against its plain version, with skip and
    sums and without either -> (scaled error of y, sums errors, bit-identical
    twice and finite, partials)."""
    tol = TOL if x.dtype == torch.bfloat16 else TOL_F32
    worst, sums_err, same = 0.0, (0.0, 0.0), True
    for sk, emit in ((skip, True), (None, False), (None, True), (skip, False)):
        y, ssum, ssq = build.gn_fused(x, w, b, a, c, sk, emit, rows)
        torch.cuda.synchronize()
        y2, ssum2, ssq2 = build.gn_fused(x, w, b, a, c, sk, emit, rows)
        torch.cuda.synchronize()
        ref, rsum, rsq = C3.conv3x3_gn_fused_plain(x, w, b, a, c, skip=sk)
        worst = max(worst, scaled_error(y, ref))
        same = same and torch.equal(y, y2) and bool(torch.isfinite(y.float()).all())
        if emit:
            same = same and torch.equal(ssum, ssum2) and torch.equal(ssq, ssq2)
            e = sums_errors(ssum, ssq, ref, rsum, rsq)
            sums_err = (max(sums_err[0], e[0]), max(sums_err[1], e[1]))
            partials = ssum.shape[0]
    ok = worst <= tol and max(sums_err) <= TOL_CONV_SUMS_REL and same
    return ok, f"err {worst:.3g} of max |plain| (bound {tol:.3g}), sums {sums_err[0]:.3g} / {sums_err[1]:.3g} " \
               f"over {partials} partials (bound {TOL_CONV_SUMS_REL}), bit-identical twice and finite {same}"


def check_k4(build, x, w, b, rows=None):
    tol = TOL if x.dtype == torch.bfloat16 else TOL_F32
    worst, same = 0.0, True
    for act in ("none", "silu"):
        y = build.conv(x, w, b, act, rows)
        torch.cuda.synchronize()
        same = same and torch.equal(y, build.conv(x, w, b, act, rows)) and bool(torch.isfinite(y.float()).all())
        worst = max(worst, scaled_error(y, C3.conv3x3_plain(x, w, b, act)))
    return worst <= tol and same, f"err {worst:.3g} of max |plain| (bound {tol:.3g}), bit-identical twice {same}"


def check_fold(x_dtype, c, n_partials, seed):
    """fold_gn_sums against its plain version on sums such as a conv writes."""
    sums = torch.stack([_randn((n_partials, c), torch.float32, seed, 20.0),
                        _randn((n_partials, c), torch.float32, seed + 1, 5.0, 100.0).abs()])
    gamma = _randn((c,), x_dtype, seed + 2, 0.2, 1.0)
    beta = _randn((c,), x_dtype, seed + 3, 0.1)
    hw = 4 * n_partials * 64
    got = C3.fold_gn_sums(sums, hw, 32, gamma, beta)
    again = C3.fold_gn_sums(sums, hw, 32, gamma, beta)
    ref = C3._affine_from_stacked_sums(sums, hw, 32, gamma, beta, 1e-6)
    torch.cuda.synchronize()
    err = max((g - r).abs().div(r.abs().clamp(min=1.0)).max().item() for g, r in zip(got, ref))
    same = all(torch.equal(g, h) for g, h in zip(got, again))
    return err <= TOL_FOLD and same, err, f"err {err:.3g} (bound {TOL_FOLD}), bit-identical twice {same}"


def bounds(shape, dtype, n_part):
    """(K4 bound ms, K5 bound ms with skip and sums, bound by) at one shape."""
    h, w_, cin, cout = shape
    es = 2 if dtype == torch.bfloat16 else 4
    t_flops = 2.0 * 9 * cin * cout * h * w_ / (PEAK_BF16_FLOPS if es == 2 else 67e12)
    small = (9 * cin * cout + cout) * es
    k4 = (h * w_ * (cin + cout)) * es + small
    k5 = (h * w_ * (cin + 2 * cout)) * es + small + 2 * cin * 4 + 2 * n_part * cout * 4
    t4, t5 = k4 / PEAK_BYTES_PER_S, k5 / PEAK_BYTES_PER_S
    return max(t_flops, t4) * 1e3, max(t_flops, t5) * 1e3, "operations" if t_flops >= t5 else "bytes"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true", help="small shapes only, no timing")
    parser.add_argument("--against", type=Path, help="a checkout of another commit to check and time in turns")
    parser.add_argument("--prologue-cost", action="store_true",
                        help="also time the resblock kernel with its prologue arithmetic taken out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_conv3x3 needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain f32 conv must be f32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    failed = []
    t0 = time.perf_counter()
    other = None if args.against is None else _build_other(args.against / "omgsr_tpu_torch/csrc/conv3x3.cu")
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        build_kernels(["conv3x3", "group_norm_silu"], verbose=True)
    print(report.getvalue(), flush=True)
    print(f"build conv3x3 + group_norm_silu: {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = {n: r for n, r in ptxas_report(report.getvalue()).items() if any(k in n for k in KERNELS_NEW)}
    if not kernels:
        print("ptxas: no report (the libraries were built before this run)", flush=True)
    for name, (regs, stores, loads) in sorted(kernels.items()):
        ok = stores == 0 and loads == 0
        print(f"ptxas: {name}: {regs} registers, spill stores {stores} bytes, loads {loads} bytes: "
              f"{'ok' if ok else 'SPILLS'}", flush=True)
        if not ok:
            failed.append(f"spills in {name}")

    builds = {"this": Build(C3._library(), (CSRC_DIR / "conv3x3.cu").read_text())}
    if other is not None:
        path, proc = other
        out, _ = proc.communicate()
        print(f"--- build against (nvcc exit {proc.returncode}) ---\n{out}", flush=True)
        if proc.returncode != 0:
            raise SystemExit("build against failed")
        lib = ctypes.CDLL(str(path))
        builds["against"] = Build(lib, (args.against / "omgsr_tpu_torch/csrc/conv3x3.cu").read_text())
        print(f"builds done in {time.perf_counter() - t0:.1f} s", flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        for c, n_part in ((128, 1024), (512, 128)):
            ok, _, msg = check_fold(dtype, c, n_part, 50 + c)
            print(f"fold_gn_sums C {c}, {n_part} partials, gamma {str(dtype)[6:]}: {msg}: {'ok' if ok else 'FAILED'}",
                  flush=True)
            if not ok:
                failed.append(f"fold {c} {n_part} {dtype}")

    sms = sm_count(torch.device("cuda", torch.cuda.current_device()))
    rows = [(shape, dtype, False) for shape, dtype in QUICK_SHAPES]
    if not args.quick:
        rows += [(shape, dtype, True) for shape, dtype, _ in CONV_SHAPES]
    for i, (shape, dtype, timed) in enumerate(rows):
        h, w_, cin, cout = shape
        x, w, b, a, c, skip = conv_inputs(shape, dtype, 3000 + 10 * i)
        label = f"x[1, {h}, {w_}, {cin}]->{cout} {str(dtype)[6:]}"
        bf16 = dtype == torch.bfloat16
        chosen = C3.gn_fused_tile_rows(h, w_, cout, sms) if bf16 else None
        for tag, build in builds.items():
            variants = [None]
            if tag == "this" and bf16:
                variants = [4, 2]  # both tile heights of the resblock kernel
            for rows_ in variants:
                suffix = f" tile rows {rows_}" if rows_ else ""
                for name, check in ((f"{label} conv3x3_gn_fused {tag}{suffix}",
                                     lambda: check_k5(build, x, w, b, a, c, skip, rows_)),
                                    (f"{label} conv3x3 {tag}{suffix}", lambda: check_k4(build, x, w, b, rows_))):
                    ok, msg = check()
                    print(f"{name}: {msg}: {'ok' if ok else 'FAILED'}", flush=True)
                    if not ok:
                        failed.append(name)
        if not timed:
            continue
        flops = 2.0 * 9 * cin * cout * h * w_
        n_part = builds["this"].gn_fused(x, w, b, a, c, skip)[1].shape[0]
        b4, b5, by = bounds(shape, dtype, n_part)
        per_graph = 5 if flops > 5e10 else 20
        calls = {}
        for tag, build in builds.items():
            calls[f"K5 {tag}"] = lambda build=build: build.gn_fused(x, w, b, a, c, skip)
            calls[f"K4 {tag}"] = lambda build=build: build.conv(x, w, b)
        dev = {k: [] for k in calls}
        order = ("against", "this", "this", "against") if "against" in builds else ("this", "this")
        for tag in order:
            for k in (f"K5 {tag}", f"K4 {tag}"):
                dev[k].append(_graph_ms(calls[k], per_graph))
        parts = []
        for k, t in dev.items():
            ms = sum(t) / len(t)
            bound = b5 if k.startswith("K5") else b4
            parts.append(f"{k} {ms:.4f} ms ({' / '.join(f'{v:.4f}' for v in t)}; {flops / ms / 1e9:.1f} TFLOP/s, "
                         f"{bound / ms:.3f} of bound)")
        if bf16:
            this = builds["this"]
            for k, run, takes in (("K5", lambda r: this.gn_fused(x, w, b, a, c, skip, True, r), chosen),
                                  ("K4", lambda r: this.conv(x, w, b, "none", r), C3.CONV_TILE_ROWS)):
                sweep = {r: _graph_ms(lambda r=r: run(r), per_graph) for r in (4, 2)}
                parts.append(f"{k} this by tile rows " + ", ".join(f"{r}: {t:.4f}" for r, t in sweep.items())
                             + f" (the wrapper takes {takes})")
        xa = x.float() * a + c
        xa = (xa * torch.sigmoid(xa)).to(dtype).permute(0, 3, 1, 2)
        parts.append(f"F.conv2d on the activated input {_graph_ms(lambda: F.conv2d(xa, w, b, padding=1), per_graph):.4f}")
        print(f"{label} device ms: " + "; ".join(parts) + f"; bounds K4 {b4:.5f} K5 {b5:.5f} ({by})", flush=True)

    if args.prologue_cost:
        prologue_cost(builds["this"])
    if not args.quick:
        resblock(failed)
    if failed:
        print("FAILED: " + ", ".join(failed), flush=True)
        sys.exit(1)
    print("all checks held", flush=True)


def prologue_cost(this):
    """The resblock kernel against the same source built without its prologue
    arithmetic, in turns (without, with, with, without), at the bf16 rows of
    CONV_SHAPES, with skip and sums, by CUDA-graph replay."""
    src, n = PROLOGUE_MATH.subn(PROLOGUE_NONE, (CSRC_DIR / "conv3x3.cu").read_text())
    if n != 1:
        raise SystemExit("--prologue-cost: the prologue's arithmetic is not where this tool expects it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = BUILD_DIR / "conv3x3_no_prologue_math.cu"
    variant.write_text(src)
    lib = BUILD_DIR / "libconv3x3_no_prologue_math.so"
    out = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib), str(variant)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"--prologue-cost: build failed\n{out.stdout}{out.stderr}")
    without = Build(ctypes.CDLL(str(lib)), src)
    for i, (shape, dtype, _) in enumerate(CONV_SHAPES):
        if dtype != torch.bfloat16:
            continue
        x, w, b, a, c, skip = conv_inputs(shape, dtype, 4000 + 10 * i)
        per_graph = 5 if 2.0 * 9 * shape[0] * shape[1] * shape[2] * shape[3] > 5e10 else 20
        t = {"without": [], "with": []}
        for tag in ("without", "with", "with", "without"):
            build = without if tag == "without" else this
            t[tag].append(_graph_ms(lambda: build.gn_fused(x, w, b, a, c, skip), per_graph))
        h, w_, cin, cout = shape
        print(f"prologue cost x[1, {h}, {w_}, {cin}]->{cout}: with its arithmetic "
              f"{sum(t['with']) / 2:.4f} ms ({' / '.join(f'{v:.4f}' for v in t['with'])}), without "
              f"{sum(t['without']) / 2:.4f} ms ({' / '.join(f'{v:.4f}' for v in t['without'])}) [timing only: "
              f"the build without computes another function]", flush=True)


def resblock(failed):
    """One fused_resblock against the unfused resnet (bf16), both timed."""
    from omgsr_tpu_torch.models import vae

    for (h, w_, cin, cout) in ((64, 64, 512, 512), (128, 128, 512, 256)):
        rng = np.random.default_rng(99)

        def t(shape, scale=1.0, shift=0.0):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale + shift).to(
                "cuda", torch.bfloat16)

        p = {"norm1": {"weight": t((cin,), 0.2, 1.0), "bias": t((cin,), 0.1)},
             "conv1": {"weight": t((cout, cin, 3, 3), 0.02).contiguous(memory_format=torch.channels_last),
                       "bias": t((cout,), 0.1)},
             "norm2": {"weight": t((cout,), 0.2, 1.0), "bias": t((cout,), 0.1)},
             "conv2": {"weight": t((cout, cout, 3, 3), 0.02).contiguous(memory_format=torch.channels_last),
                       "bias": t((cout,), 0.1)}}
        if cin != cout:
            p["conv_shortcut"] = {"weight": t((cout, cin, 1, 1), 0.05).contiguous(memory_format=torch.channels_last),
                                  "bias": t((cout,), 0.1)}
        x = t((1, h, w_, cin))
        fused = C3.fused_resblock(p, x, 32)
        torch.cuda.synchronize()
        ref = vae._resnet(p, x, 32)
        rel = ((fused.float() - ref.float()).norm() / ref.float().norm()).item()
        ok = rel <= 0.05 and bool(torch.isfinite(fused.float()).all())
        if not ok:
            failed.append(f"fused_resblock {h}x{w_}")
        print(f"fused_resblock x(1,{h},{w_},{cin})->{cout} bf16: rel L2 against the unfused resnet {rel:.3g} "
              f"(bound 0.05): {'ok' if ok else 'FAILED'}; device ms fused "
              f"{_graph_ms(lambda: C3.fused_resblock(p, x, 32), 5):.4f}, unfused "
              f"{_graph_ms(lambda: vae._resnet(p, x, 32), 5):.4f}", flush=True)


if __name__ == "__main__":
    main()
