"""A short first run for the flash-attention kernels on one NVIDIA GPU.

    python -m omgsr_tpu_torch.tools.check_flash_bwd

Builds ``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu`` (the
compiler's register and spill report is printed), runs the forward and the
backward wrapper once at each training shape and at the VAE mid block's head
dim 512, and prints for each: the error of the output and of dq, dk, dv
against the plain versions over the largest |plain| value, whether the outputs
are finite and bit-identical when run twice, the error of the delta prologue,
and the time of each kernel alone. It asserts nothing: it is meant for the
first run after a change to a kernel, before ``chip_smoke.py``, which holds the
same shapes to their bounds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.ops.kernel_build import build_kernels

SHAPES = [
    # (B, Sq, H, D), Skv, dtype, packed q/k/v with a strided dO?
    ((1, 4096, 5, 64), 4096, torch.bfloat16, False),
    ((1, 4096, 5, 64), 77, torch.bfloat16, False),
    ((1, 1024, 10, 64), 1024, torch.bfloat16, False),
    ((1, 256, 20, 64), 256, torch.bfloat16, False),
    ((1, 64, 20, 64), 77, torch.bfloat16, False),
    ((2, 300, 3, 64), 300, torch.bfloat16, True),
    ((2, 300, 1, 64), 300, torch.float32, False),
    ((2, 300, 2, 128), 77, torch.float32, False),
    ((2, 300, 2, 128), 77, torch.bfloat16, False),
    ((1, 4608, 24, 128), 4608, torch.bfloat16, False),
    # the VAE mid block's single 512-wide head: 512 px, 1024 px, ragged
    ((1, 4096, 1, 512), 4096, torch.bfloat16, False),
    ((1, 16384, 1, 512), 16384, torch.bfloat16, False),
    ((2, 300, 2, 512), 300, torch.bfloat16, True),
    ((1, 300, 1, 512), 177, torch.float32, False),
]


def _randn(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_flash_bwd needs a CUDA device")
    t0 = time.perf_counter()
    build_kernels(["flash_attention_bwd", "flash_attention_fwd"], verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s on {torch.cuda.get_device_name(0)}", flush=True)
    for i, (shape, skv, dtype, packed) in enumerate(SHAPES):
        b, sq, h, d = shape
        if packed:
            q, k, v = _randn((b, sq, 3, h, d), dtype, i).unbind(2)
            dout = _randn((b, h, sq, d), dtype, i + 50).permute(0, 2, 1, 3)
        else:
            q = _randn(shape, dtype, i)
            k = _randn((b, skv, h, d), dtype, i + 20)
            v = _randn((b, skv, h, d), dtype, i + 40)
            dout = _randn(shape, dtype, i + 50)
        out, lse = FA.flash_attention(q, k, v, return_lse=True)
        ref_out = FA.flash_attention_plain(q, k, v)
        fwd_err = ((out.float() - ref_out.float()).abs().max() / ref_out.float().abs().max()).item()
        got = FA.flash_attention_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        again = FA.flash_attention_bwd(q, k, v, out, lse, dout)
        ref = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        errs = [((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                for a, r in zip(got, ref)]
        qo, ko, vo, oo, go = (FA._kernel_operand(t) for t in (q, k, v, out, dout))
        scale = d ** -0.5
        _, delta = FA._launch_dq(qo, ko, vo, oo, lse, go, scale)
        delta_ref = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).reshape(b * h, sq)
        print(
            f"q{list(shape)} kv{skv} {str(dtype)[6:]}{' packed' if packed else ''}: "
            f"err/max|plain| out {fwd_err:.2e}, fwd {_time_ms(lambda: FA.flash_attention(q, k, v)):.4f} ms; dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}; "
            f"finite {all(bool(torch.isfinite(a.float()).all()) for a in got)}; "
            f"bit-identical twice {all(torch.equal(a, c) for a, c in zip(got, again))}; "
            f"delta err {(delta - delta_ref).abs().max().item():.2e}; "
            f"dq {_time_ms(lambda: FA._launch_dq(qo, ko, vo, oo, lse, go, scale)):.4f} ms, "
            f"dkv {_time_ms(lambda: FA._launch_dkv(qo, ko, vo, lse, delta, go, scale)):.4f} ms",
            flush=True,
        )


if __name__ == "__main__":
    main()
