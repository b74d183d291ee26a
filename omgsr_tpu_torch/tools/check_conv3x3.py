"""A short first run for the 3x3-conv kernels on one NVIDIA GPU.

    python -m omgsr_tpu_torch.tools.check_conv3x3

Builds ``csrc/conv3x3.cu`` and ``csrc/group_norm_silu.cu`` (the compiler's
register and spill report is printed), runs ``conv3x3`` and
``conv3x3_gn_fused`` once at a few shapes and prints for each: the error of y
against the plain version over the largest |plain| value, the relative error
of the channel sums, whether two runs give the same bits, and the kernel's
time; then one ``fused_resblock`` against the unfused resnet. It asserts
nothing: it is meant for the first run after a change to a kernel, before
``chip_smoke.py``, which holds the path's shapes to their bounds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from omgsr_tpu_torch.models import vae
from omgsr_tpu_torch.ops import conv3x3 as C3
from omgsr_tpu_torch.ops.kernel_build import build_kernels

SHAPES = [
    # (H, W, C_in, C_out), dtype
    ((16, 16, 128, 128), torch.float32),
    ((13, 37, 128, 256), torch.float32),
    ((16, 16, 128, 128), torch.bfloat16),
    ((13, 37, 256, 128), torch.bfloat16),
    ((64, 64, 512, 512), torch.bfloat16),
    ((512, 512, 128, 128), torch.bfloat16),
]


def _randn(shape, dtype, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to("cuda", dtype)


def _time_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _err(a, r):
    return ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_conv3x3 needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False  # the plain f32 conv must be f32
    t0 = time.perf_counter()
    build_kernels(["conv3x3", "group_norm_silu"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    for i, ((h, w_, cin, cout), dtype) in enumerate(SHAPES):
        x = _randn((1, h, w_, cin), dtype, 10 * i)
        w = _randn((cout, cin, 3, 3), dtype, 10 * i + 1, 0.05).contiguous(memory_format=torch.channels_last)
        b = _randn((cout,), dtype, 10 * i + 2, 0.1)
        a = _randn((cin,), torch.float32, 10 * i + 3, 0.2) + 1.0
        c = _randn((cin,), torch.float32, 10 * i + 4, 0.5) + 0.5
        skip = _randn((1, h, w_, cout), dtype, 10 * i + 5)
        flops = 2.0 * 9 * cin * cout * h * w_
        for act in ("none", "silu"):
            y = C3.conv3x3(x, w, b, act)
            torch.cuda.synchronize()
            ref = C3.conv3x3_plain(x, w, b, act)
            ms = _time_ms(lambda: C3.conv3x3(x, w, b, act))
            print(f"conv3x3 x(1,{h},{w_},{cin})->{cout} {str(dtype)[6:]} act={act}: err/max|plain| "
                  f"{_err(y, ref):.2e}; finite {bool(torch.isfinite(y.float()).all())}; "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)
        for use_skip in (True, False):
            sk = skip if use_skip else None
            y, s, q = C3.conv3x3_gn_fused(x, w, b, a, c, skip=sk)
            torch.cuda.synchronize()
            y2, s2, q2 = C3.conv3x3_gn_fused(x, w, b, a, c, skip=sk)
            ref, rs, rq = C3.conv3x3_gn_fused_plain(x, w, b, a, c, skip=sk)
            es = ((s.sum(0) - rs[0]).abs() / rs[0].abs().clamp(min=1.0)).max().item()
            eq = ((q.sum(0) - rq[0]).abs() / rq[0].abs().clamp(min=1.0)).max().item()
            same = torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(q, q2)
            ms = _time_ms(lambda: C3.conv3x3_gn_fused(x, w, b, a, c, skip=sk))
            print(f"conv3x3_gn_fused x(1,{h},{w_},{cin})->{cout} {str(dtype)[6:]} skip={use_skip}: "
                  f"err/max|plain| {_err(y, ref):.2e}; sums rel err {es:.2e} / {eq:.2e} over "
                  f"{s.shape[0]} partials; bit-identical twice {same}; {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s)", flush=True)

    for (h, w_, cin, cout) in ((64, 64, 512, 512), (128, 128, 512, 256)):
        dtype = torch.bfloat16
        rng = np.random.default_rng(99)

        def t(shape, scale=1.0, shift=0.0):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale + shift).to("cuda", dtype)

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
        print(f"fused_resblock x(1,{h},{w_},{cin})->{cout} bf16: rel L2 against the unfused resnet {rel:.3g}, "
              f"err/max {_err(fused, ref):.2e}; fused {_time_ms(lambda: C3.fused_resblock(p, x, 32)):.4f} ms, "
              f"unfused {_time_ms(lambda: vae._resnet(p, x, 32)):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
