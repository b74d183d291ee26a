"""Checks and times the GroupNorm+SiLU kernels (K3a stats, K3b apply) on one NVIDIA GPU.

    python -m omgsr_tpu_torch.tools.check_group_norm [--quick] [--against DIR] [--sweep] [--stages]

Builds ``csrc/group_norm_silu.cu``, prints the compiler's register, shared-memory and
spill report and fails if ``gn_stats_kernel`` or ``gn_apply_kernel`` spills. Then it holds
``group_norm_stats`` and ``group_norm_apply`` (with and without SiLU, the affine in x's
type and in f32) against their plain versions: the group sums within ``TOL_SUMS_REL``, y
within ``TOL`` (bf16: two bf16 steps; f32: 2e-4) of max(1, |plain|) per element, the same
bits from two runs, finite values.

``--quick`` runs small and ragged shapes only, untimed: the first run after a change
to a kernel. Without it the rows of ``GN_SHAPES`` (which ``chip_smoke.py``'s kernels
phase takes from here) are checked too and each kernel is timed by CUDA-graph replay
(device time, GB/s and share of the card's bound).

``--against DIR`` also builds ``DIR/omgsr_tpu_torch/csrc/group_norm_silu.cu`` (a checkout
of another commit: this interface, or the one before the persistent apply kernel, whose
apply entry took a chunk of rows per block in place of a count of row blocks; the
source says which), holds it to the same checks and times both builds' kernels in turns
(other, this, this, other) at every timed row.

``--sweep`` times this source's apply kernel over other block sizes, grids and
``APPLY_UNROLL`` values (built from a copy of the source with that constant changed)
at the bf16 rows of ``GN_SHAPES``: what the launch geometry was chosen by.

``--stages`` (with ``--against``) builds OMGSR-S at full SD2.1 width from seeds (bf16),
counts the apply launches of one 512x512 request by stage and shape, times each
such shape with both builds in turns beside its bound, and times the VAE encode and
decode stages (unfused) with this build's GroupNorm kernels and with the other's, in
turns, by CUDA events.

Exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from omgsr_tpu_torch.ops import fused_groupnorm as GN
from omgsr_tpu_torch.ops.flash_attention import sm_count
from omgsr_tpu_torch.ops.kernel_build import (
    BUILD_DIR,
    CSRC_DIR,
    NVCC_FLAGS,
    _find_nvcc,
    build_kernels,
    launch_kernel,
    load_kernel_library,
)
from omgsr_tpu_torch.tools.check_flash_fwd import PEAK_BYTES_PER_S, TOL, _build_other, _graph_ms, ptxas_report

GN_SHAPES = [
    # (B, H, W, C), groups, dtype, on the serving path?
    ((1, 512, 512, 128), 32, torch.bfloat16, True),  # the VAE's widest stage at 512 px
    ((1, 64, 64, 320), 32, torch.bfloat16, True),  # the UNet's first block
    ((1, 8, 8, 2560), 32, torch.bfloat16, True),  # the UNet's time-embedding-wide mid resnets
    ((1, 30, 10, 32), 32, torch.float32, False),  # f32, ragged
    ((4, 64, 64, 320), 32, torch.bfloat16, True),  # tile batch of the 768x768 request
    ((4, 8, 8, 2560), 32, torch.bfloat16, True),
    # the VAE's largest GroupNorms of a 512-px request besides the first row
    ((1, 512, 512, 256), 32, torch.bfloat16, True),  # decoder up3, first resnet
    ((1, 256, 256, 512), 32, torch.bfloat16, True),  # decoder up2
    ((1, 256, 256, 256), 32, torch.bfloat16, True),  # encoder down2, decoder up2's later resnets
    ((1, 2048, 2048, 128), 32, torch.bfloat16, True),  # the 2K exact route's widest stage
    ((1, 512, 640, 128), 32, torch.bfloat16, True),  # the VAE's widest stage at 640x512 (a padded request)
]
QUICK_SHAPES = [
    ((1, 16, 16, 128), 32, torch.bfloat16),
    ((2, 7, 9, 64), 8, torch.bfloat16),  # fewer rows than a block steps over
    ((1, 61, 45, 320), 32, torch.bfloat16),  # C / 8 vectors no power of two
    ((1, 3, 5, 2560), 32, torch.float32),  # three column segments, the last one short
    ((1, 30, 10, 32), 32, torch.float32),
    ((3, 40, 40, 256), 32, torch.bfloat16),
]
# group sums: max |kernel - plain| / max(1, |plain|) over the (batch, group) sums; f32 on
# both sides, added in another order
TOL_SUMS_REL = 1e-4
TOL_Y = {torch.bfloat16: TOL, torch.float32: 2e-4}
KERNELS = ("gn_stats_kernel", "gn_apply_kernel")
# the constant --sweep varies in a copy of the source
UNROLL_LINE = "constexpr int APPLY_UNROLL = {};"


def _randn(shape, dtype, seed, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to("cuda", dtype)


def gn_inputs(shape, dtype, seed):
    """x, weight, bias of one shape: x off-centre, so the mean matters."""
    c = shape[-1]
    return (_randn(shape, dtype, seed, 2.0, 0.5), _randn((c,), dtype, seed + 1, 0.1, 1.0),
            _randn((c,), dtype, seed + 2, 0.1))


def first_apply_geometry(rows, channels, elem_size, batch):
    """(cvb, k, chunk_rows) of the apply entry as it stood before the persistent
    grid: blocks of cvb vectors by k rows (about 256 threads) over chunks of
    chunk_rows rows, at most about 512 blocks over the batch."""
    cv = channels // GN._widest_vec(channels, elem_size)
    cvb = cv if cv <= 512 else 256
    min_rows = -(-16384 // (channels * elem_size))
    return cvb, max(1, 256 // cvb), max(-(-rows * batch // 512), min_rows, 1)


class Build:
    """The entries of one build of csrc/group_norm_silu.cu, called with the
    operands of ops.fused_groupnorm's wrappers (and none of their launch
    counts); ``source`` is the text it was built from, which says which apply
    interface it has."""

    def __init__(self, lib, source: str):
        vp, i = ctypes.c_void_p, ctypes.c_int
        self.lib = lib
        self.persistent = "group_norm_apply_blocks_per_sm" in source
        lib.group_norm_stats.argtypes = [vp, vp] + [i] * 10 + [vp]
        lib.group_norm_stats.restype = i
        lib.group_norm_apply.argtypes = [vp, vp, vp, vp, i, vp] + [i] * 10 + [ctypes.c_float, i, vp]
        lib.group_norm_apply.restype = i
        if self.persistent:
            lib.group_norm_apply_blocks_per_sm.argtypes = [i] * 5
            lib.group_norm_apply_blocks_per_sm.restype = i

    def stats(self, x, groups):
        b, h, w, c = x.shape
        geo = GN.launch_geometry(h * w, c, groups, x.element_size(), b)
        partial = torch.empty((b, geo.nchunks, groups, 2), dtype=torch.float32, device=x.device)
        launch_kernel(self.lib.group_norm_stats, "group_norm_stats", x.device, x.data_ptr(), partial.data_ptr(),
                      GN._DTYPE_CODE[x.dtype], geo.vec, b, h * w, c, groups, geo.chunk_rows, geo.nchunks,
                      geo.gpb, geo.k)
        return partial

    def row_blocks(self, x, groups, cvb, k):
        """One wave of apply blocks of (cvb, k), as the wrapper sizes it."""
        b, h, w, c = x.shape
        vec = GN._widest_vec(c, x.element_size())
        per_sm = self.lib.group_norm_apply_blocks_per_sm(GN._DTYPE_CODE[x.dtype], vec, cvb, k, groups)
        if per_sm < 1:
            raise RuntimeError(f"occupancy query failed: {per_sm}")
        return GN.apply_row_blocks(h * w, k, b, -(-(c // vec) // cvb), sm_count(x.device), per_sm)

    def apply(self, x, partial, weight, bias, groups, eps=1e-6, silu=True, geometry=None):
        """y as ``group_norm_apply`` returns it; ``geometry`` (cvb, k, row_blocks)
        in place of the wrapper's (persistent interface only)."""
        b, h, w, c = x.shape
        vec = GN._widest_vec(c, x.element_size())
        if self.persistent:
            if geometry is None:
                geo = GN.launch_geometry(h * w, c, groups, x.element_size(), b)
                geometry = (geo.cvb, geo.apply_k, self.row_blocks(x, groups, geo.cvb, geo.apply_k))
            shape_args = geometry
        else:
            cvb, k, chunk_rows = first_apply_geometry(h * w, c, x.element_size(), b)
            shape_args = (chunk_rows, cvb, k)
        y = torch.empty_like(x)
        launch_kernel(self.lib.group_norm_apply, "group_norm_apply", x.device, x.data_ptr(), partial.data_ptr(),
                      weight.data_ptr(), bias.data_ptr(),
                      int(weight.dtype == torch.float32 and x.dtype != torch.float32), y.data_ptr(),
                      GN._DTYPE_CODE[x.dtype], vec, b, h * w, c, groups, partial.shape[1], *shape_args,
                      float(eps), int(silu))
        return y


def scaled_error(got, ref):
    """max |got - ref| / max(1, |ref|) over the elements."""
    d = (got.float() - ref.float()).abs()
    return (d / ref.float().abs().clamp(min=1.0)).max().item()


def check(build, shape, groups, dtype, seed):
    """Both kernels of one build against their plain versions -> (ok, message)."""
    x, weight, bias = gn_inputs(shape, dtype, seed)
    partial = build.stats(x, groups)
    torch.cuda.synchronize()
    same = torch.equal(partial, build.stats(x, groups))
    err_sums = scaled_error(partial.sum(dim=1), GN.group_norm_stats_plain(x, groups)[:, 0])
    worst = 0.0
    for affine in (dtype, torch.float32):
        w, b = weight.to(affine), bias.to(affine)
        for silu in (True, False):
            y = build.apply(x, partial, w, b, groups, silu=silu)
            torch.cuda.synchronize()
            same = same and torch.equal(y, build.apply(x, partial, w, b, groups, silu=silu))
            same = same and bool(torch.isfinite(y.float()).all())
            worst = max(worst, scaled_error(y, GN.group_norm_silu_plain(x, w, b, groups, 1e-6, silu)))
    ok = err_sums <= TOL_SUMS_REL and worst <= TOL_Y[dtype] and same
    return ok, (f"sums err {err_sums:.3g} (bound {TOL_SUMS_REL}) over {partial.shape[1]} chunks, y err {worst:.3g} "
                f"(bound {TOL_Y[dtype]:.3g}), bit-identical twice and finite {same}")


def bounds(shape, dtype, nchunks):
    """(K3a bound ms, K3b bound ms): bytes over the card's rate (x read once
    by each, y written once, the partials and the affine), or the f32
    operations (3 an element for the sums; 6 for the affine and SiLU) over
    67 TFLOP/s, whichever is larger."""
    n = 1
    for d in shape:
        n *= d
    es = 2 if dtype == torch.bfloat16 else 4
    small = shape[0] * nchunks * 32 * 2 * 4
    t_stats = max((n * es + small) / PEAK_BYTES_PER_S, 3 * n / 67e12)
    t_apply = max((2 * n * es + small + 2 * shape[-1] * es) / PEAK_BYTES_PER_S, 6 * n / 67e12)
    return t_stats * 1e3, t_apply * 1e3


def per_graph_of(shape):
    n = 1
    for d in shape:
        n *= d
    return 5 if n > 2 ** 27 else 20


def time_row(builds, shape, groups, dtype, seed):
    """K3a and K3b of each build by CUDA-graph replay in turns -> {name: [ms]}."""
    x, weight, bias = gn_inputs(shape, dtype, seed)
    partials = {tag: build.stats(x, groups) for tag, build in builds.items()}
    calls = {}
    for tag, build in builds.items():
        calls[f"K3a {tag}"] = lambda build=build: build.stats(x, groups)
        calls[f"K3b {tag}"] = lambda build=build, tag=tag: build.apply(x, partials[tag], weight, bias, groups)
    dev = {k: [] for k in calls}
    order = ("against", "this", "this", "against") if "against" in builds else ("this", "this")
    for tag in order:
        for k in (f"K3a {tag}", f"K3b {tag}"):
            dev[k].append(_graph_ms(calls[k], per_graph_of(shape)))
    return dev, partials["this"].shape[1]


def label_of(shape, groups, dtype):
    return f"x{list(shape)} G{groups} {str(dtype)[6:]}"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true", help="small shapes only, no timing")
    parser.add_argument("--against", type=Path, help="a checkout of another commit to check and time in turns")
    parser.add_argument("--sweep", action="store_true", help="also time the apply kernel over other geometries")
    parser.add_argument("--stages", action="store_true",
                        help="with --against: launches by shape and the VAE stages of a 512-px request, in turns")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("check_group_norm needs a CUDA device")
    if args.stages and args.against is None:
        raise SystemExit("--stages needs --against")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)

    failed = []
    t0 = time.perf_counter()
    other_src = None if args.against is None else args.against / "omgsr_tpu_torch/csrc/group_norm_silu.cu"
    other = None if other_src is None else _build_other(other_src)
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        build_kernels(["group_norm_silu"], verbose=True)
    print(report.getvalue(), flush=True)
    print(f"build group_norm_silu: {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = {n: r for n, r in ptxas_report(report.getvalue()).items() if any(k in n for k in KERNELS)}
    if not kernels:
        print("ptxas: no report (the library was built before this run)", flush=True)
    for name, (regs, stores, loads) in sorted(kernels.items()):
        ok = stores == 0 and loads == 0
        print(f"ptxas: {name}: {regs} registers, spill stores {stores} bytes, loads {loads} bytes: "
              f"{'ok' if ok else 'SPILLS'}", flush=True)
        if not ok:
            failed.append(f"spills in {name}")

    builds = {"this": Build(load_kernel_library("group_norm_silu"), (CSRC_DIR / "group_norm_silu.cu").read_text())}
    if other is not None:
        path, proc = other
        out, _ = proc.communicate()
        print(f"--- build against (nvcc exit {proc.returncode}) ---\n{out}", flush=True)
        if proc.returncode != 0:
            raise SystemExit("build against failed")
        builds["against"] = Build(ctypes.CDLL(str(path)), other_src.read_text())
        print(f"builds done in {time.perf_counter() - t0:.1f} s", flush=True)

    rows = [(shape, groups, dtype, False) for shape, groups, dtype in QUICK_SHAPES]
    if not args.quick:
        rows += [(shape, groups, dtype, True) for shape, groups, dtype, _ in GN_SHAPES]
    for i, (shape, groups, dtype, timed) in enumerate(rows):
        label = label_of(shape, groups, dtype)
        for tag, build in builds.items():
            ok, msg = check(build, shape, groups, dtype, 5000 + 10 * i)
            print(f"{label} {tag}: {msg}: {'ok' if ok else 'FAILED'}", flush=True)
            if not ok:
                failed.append(f"{label} {tag}")
        if not timed:
            continue
        dev, nchunks = time_row(builds, shape, groups, dtype, 6000 + 10 * i)
        b3a, b3b = bounds(shape, dtype, nchunks)
        parts = []
        for k, t in dev.items():
            ms = statistics.mean(t)
            bound = b3a if k.startswith("K3a") else b3b
            parts.append(f"{k} {ms:.4f} ms ({' / '.join(f'{v:.4f}' for v in t)}; {bound / ms:.3f} of bound)")
        print(f"{label} device ms: " + "; ".join(parts) + f"; bounds K3a {b3a:.5f} K3b {b3b:.5f} (bytes)",
              flush=True)

    if args.sweep:
        sweep(builds["this"])
    if args.stages:
        stages(builds, card, failed)
    if failed:
        print("FAILED: " + ", ".join(failed), flush=True)
        sys.exit(1)
    print("all checks held", flush=True)


def _build_unroll(unroll):
    """This source with APPLY_UNROLL set to ``unroll``, built -> Build."""
    src = (CSRC_DIR / "group_norm_silu.cu").read_text()
    line = next(UNROLL_LINE.format(u) for u in range(1, 65) if UNROLL_LINE.format(u) in src)
    src = src.replace(line, UNROLL_LINE.format(unroll))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    variant = BUILD_DIR / f"group_norm_silu_unroll{unroll}.cu"
    variant.write_text(src)
    lib = BUILD_DIR / f"libgroup_norm_silu_unroll{unroll}.so"
    out = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(lib), str(variant)],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"--sweep: build failed\n{out.stdout}{out.stderr}")
    return Build(ctypes.CDLL(str(lib)), src)


def sweep(this):
    """The apply kernel at the bf16 rows of GN_SHAPES over block sizes (threads
    of about 256 or 512), grids (one wave, half a wave, two waves, and no
    more blocks than give each thread 8 or 16 rows) and APPLY_UNROLL (this
    build's, 2 and 8), by CUDA-graph replay."""
    variants = {"source": this}
    for u in (2, 8):
        variants[f"unroll {u}"] = _build_unroll(u)
    for i, (shape, groups, dtype, _) in enumerate(GN_SHAPES):
        if dtype != torch.bfloat16:
            continue
        x, weight, bias = gn_inputs(shape, dtype, 7000 + 10 * i)
        partial = this.stats(x, groups)
        b, h, w, c = shape
        cv = c // GN._widest_vec(c, 2)
        res = []
        for threads in (256, 512):
            cvb = cv if cv <= threads else threads // 2
            k = max(1, min(threads // cvb, h * w))
            for name, build in variants.items():
                wave = build.row_blocks(x, groups, cvb, k)
                grids = (("wave", wave), ("half", max(1, wave // 2)), ("2 waves", 2 * wave),
                         ("8 rows", min(wave, -(-h * w // (8 * k)))), ("16 rows", min(wave, -(-h * w // (16 * k)))))
                for tag, rb in grids:
                    ms = _graph_ms(lambda: build.apply(x, partial, weight, bias, groups, geometry=(cvb, k, rb)),
                                   per_graph_of(shape))
                    res.append(f"{threads} thr {name} {tag} ({rb} blocks) {ms:.4f}")
        print(f"sweep {label_of(shape, groups, dtype)} apply device ms: " + "; ".join(res), flush=True)


def stages(builds, card, failed):
    """Apply launches of one 512x512 request by stage and shape, each shape
    timed with both builds in turns beside its bound, and the unfused VAE
    stages with each build's GroupNorm kernels, in turns."""
    from omgsr_tpu_torch.convert.params import init_unet, init_vae
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models.configs import SD21_UNET, SD21_VAE

    dtype = torch.bfloat16
    vae = init_vae(0, SD21_VAE, dtype, "cuda")
    unet = init_unet(1, SD21_UNET, dtype, "cuda")
    pipe = OMGSRSPipeline(vae, unet, SD21_VAE, SD21_UNET, 273, device="cuda")
    rng = np.random.default_rng(2)
    lq = torch.from_numpy(rng.uniform(-1, 1, (1, 512, 512, 3)).astype(np.float32)).to("cuda", dtype)
    ctx = torch.from_numpy(rng.standard_normal((1, 77, 1024)).astype(np.float32)).to("cuda", dtype)

    seen = Counter()
    real_apply = GN._launch_apply

    def counting(x, partial, weight, bias, geo, groups, eps, apply_silu):
        seen[(stage_name[0], tuple(x.shape), groups, bool(apply_silu), str(weight.dtype)[6:])] += 1
        return real_apply(x, partial, weight, bias, geo, groups, eps, apply_silu)

    stage_name = [""]
    GN._launch_apply = counting
    try:
        with torch.inference_mode():
            stage_name[0] = "encode"
            z = pipe.encode(lq, sample_latent=False)
            stage_name[0] = "unet"
            z0 = pipe.latent_mid(z, ctx, 64, 32)
            stage_name[0] = "decode"
            pipe.decode(z0)
            torch.cuda.synchronize()
    finally:
        GN._launch_apply = real_apply
    by_stage = Counter()
    for (stage, *_), n in seen.items():
        by_stage[stage] += n
    print(f"stages: apply launches of one 512x512 request by stage {dict(by_stage)}", flush=True)

    by_shape = Counter()
    for (_, shape, groups, silu, wdt), n in seen.items():
        by_shape[(shape, groups, silu, wdt)] += n
    total_gap = {"this": 0.0, "against": 0.0}
    heaviest_first = sorted(by_shape.items(), key=lambda kv: -kv[1] * np.prod(kv[0][0]))
    for i, ((shape, groups, silu, wdt), n) in enumerate(heaviest_first):
        x, weight, bias = gn_inputs(shape, dtype, 8000 + 10 * i)
        weight, bias = weight.to(getattr(torch, wdt)), bias.to(getattr(torch, wdt))
        partials = {tag: build.stats(x, groups) for tag, build in builds.items()}
        ms = {"this": [], "against": []}
        for tag in ("against", "this", "this", "against"):
            ms[tag].append(_graph_ms(lambda: builds[tag].apply(x, partials[tag], weight, bias, groups, silu=silu),
                                     per_graph_of(shape)))
        bound = bounds(shape, dtype, partials["this"].shape[1])[1]
        stages_of = {s: c for (s, sh, g, si, wd), c in seen.items() if (sh, g, si, wd) == (shape, groups, silu, wdt)}
        row = []
        for tag in ("this", "against"):
            m = statistics.mean(ms[tag])
            total_gap[tag] += n * (m - bound)
            row.append(f"{tag} {m:.4f} ms ({' / '.join(f'{v:.4f}' for v in ms[tag])}), {bound / m:.3f} of bound, "
                       f"launches x (ms - bound) {n * (m - bound):.4f}")
        print(f"stages: apply x{list(shape)} G{groups} silu {silu} affine {wdt}: {n} launches {stages_of}; bound "
              f"{bound:.5f} ms; " + "; ".join(row), flush=True)
    print(f"stages: apply launches x (ms - bound) over one request: this {total_gap['this']:.4f} ms, against "
          f"{total_gap['against']:.4f} ms", flush=True)

    real_stats = GN._launch_stats

    def routed(tag):
        build = builds[tag]

        def stats(x, geo, groups):
            GN.stats_launches.add()
            return build.stats(x, groups)

        def apply(x, partial, weight, bias, geo, groups, eps, apply_silu):
            GN.apply_launches.add()
            return build.apply(x, partial, weight.contiguous(), bias.contiguous(), groups, eps, apply_silu)

        return stats, apply

    def time_stage(fn, tag):
        GN._launch_stats, GN._launch_apply = routed(tag)
        try:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / 5
        finally:
            GN._launch_stats, GN._launch_apply = real_stats, real_apply

    with torch.inference_mode():
        z = pipe.encode(lq, sample_latent=False)
        outs = {}
        for name, fn in (("vae_encode", lambda: pipe.encode(lq, sample_latent=False)),
                         ("vae_decode", lambda: pipe.decode(z))):
            ms = {"this": [], "against": []}
            for tag in ("against", "this", "this", "against"):
                ms[tag].append(time_stage(fn, tag))
            for tag in ("this", "against"):
                GN._launch_stats, GN._launch_apply = routed(tag)
                try:
                    outs[(name, tag)] = fn().float()
                finally:
                    GN._launch_stats, GN._launch_apply = real_stats, real_apply
            rel = ((outs[(name, "this")] - outs[(name, "against")]).norm() / outs[(name, "against")].norm()).item()
            ok = rel <= 0.05 and bool(torch.isfinite(outs[(name, "this")]).all())
            if not ok:
                failed.append(f"stage {name}")
            print(f"stages: 512x512 {name} device ms with this build's GroupNorm kernels "
                  f"{statistics.mean(ms['this']):.3f} ({' / '.join(f'{v:.3f}' for v in ms['this'])}), with the "
                  f"other's {statistics.mean(ms['against']):.3f} ({' / '.join(f'{v:.3f}' for v in ms['against'])}), "
                  f"in turns; rel L2 between the two {rel:.3g} (bound 0.05): {'ok' if ok else 'FAILED'} [{card}]",
                  flush=True)


if __name__ == "__main__":
    main()
