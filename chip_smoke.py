#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omgsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); exits non-zero without
them. Phases, each of which must pass:

  device   the card's name and power limit; TF32 switched off for f32 math
  build    every kernel source under omgsr_tpu_torch/csrc is compiled
  kernels  each hand-written kernel against its plain PyTorch version on the
           card at the shapes the serving path gives it (tolerances below),
           with its time, the plain version's, one library call's and the
           card's bound for the same work
  serve    OMGSR-S one-step serving at full SD2.1 width (random weights
           from a seed, bf16): an SRServer built by cli.serve.build_server
           answers four 512x512 requests and one 768x768 request (tiled
           latent) from client threads; outputs are checked, the kernels'
           launch counts are held against what the model's structure
           predicts, and one request is repeated with the kernels routed to
           their plain versions
  timings  per-request latency and the VAE-encode / UNet / VAE-decode split;
           with --profile also kernel time by name and each stage's idle share

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.cli import serve as serve_cli
from omgsr_tpu_torch.convert.params import init_unet, init_vae
from omgsr_tpu_torch.diffusion.tiling import tile_grid_2d
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
from omgsr_tpu_torch.inference.tiled import auto_tile_batch
from omgsr_tpu_torch.models.configs import SD21_UNET, SD21_VAE
from omgsr_tpu_torch.models.layers import count_params
from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.ops import fused_groupnorm as GN
from omgsr_tpu_torch.ops.kernel_build import build_kernels, kernel_sources, route_kernels_to_plain

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel against plain version.
#   group norm: max over the elements of |kernel - plain| / max(1, |plain|).
#   flash attention: max |kernel - plain| / max |plain| of the shape: attention
#         outputs are averages of v and shrink with Skv (about 0.13 at most for
#         4096 keys), so the error is held against the largest value of this
#         shape and not against 1.
#   bf16: both round their f32 result to bf16, and two f32 values that differ
#         in the last bits can land one bf16 step apart (2^-7 relative at
#         worst); the bound is two such steps. f32: summation order and the
#         fast exp / rsqrt approximations only.
TOL = {torch.bfloat16: 2.0 ** -6, torch.float32: 2e-4}
# log-sum-exp and group sums are f32 whatever the input type
# end to end, kernels against plain versions, one 512x512 request in bf16 at
# full depth with random weights: both runs round every activation to bf16
# (2^-8 relative) in different places, and ~200 random layers amplify that, so
# the uint8 images agree only on average: mean |difference| in uint8 steps
MAX_MEAN_STEPS = 6.0
# per stage on identical inputs, ||kernel - plain|| / ||plain|| in bf16
MAX_STAGE_REL_L2 = 0.05
TOL_LSE = 1e-3
TOL_SUMS_REL = 1e-4


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of one call, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(out, ref):
    """(max abs error, max error scaled by max(1, |ref|))."""
    d = (out.float() - ref.float()).abs()
    return d.max().item(), (d / ref.float().abs().clamp(min=1.0)).max().item()


def randn(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


# ----------------------------------------------------------------------------
# phase: device
# ----------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA device",
              file=sys.stderr)
        sys.exit(2)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    # f32 references must be f32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: torch {torch.__version__}, cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    return card


# ----------------------------------------------------------------------------
# phase: kernels
# ----------------------------------------------------------------------------

FLASH_SHAPES = [
    # (B, Sq, H, D), Skv, dtype, on the serving path?, q/k/v as views of one packed tensor?
    ((1, 4096, 5, 64), 4096, torch.bfloat16, True, False),
    ((1, 4096, 5, 64), 77, torch.bfloat16, True, False),
    ((1, 1024, 10, 64), 1024, torch.bfloat16, True, False),
    ((1, 64, 20, 64), 64, torch.bfloat16, True, False),
    ((1, 4608, 24, 128), 4608, torch.bfloat16, False, False),
    ((2, 300, 1, 64), 300, torch.float32, False, False),
    # ragged Sq and Skv through the tensor-core kernel, read by strides
    ((2, 300, 3, 64), 300, torch.bfloat16, False, True),
    # the 768x768 request runs its four latent tiles as one UNet batch of 4
    ((4, 1024, 10, 64), 1024, torch.bfloat16, True, False),
    ((4, 4096, 5, 64), 77, torch.bfloat16, True, False),
]

GN_SHAPES = [
    # (B, H, W, C), groups, dtype, on the serving path?
    ((1, 512, 512, 128), 32, torch.bfloat16, True),
    ((1, 64, 64, 320), 32, torch.bfloat16, True),
    ((1, 8, 8, 2560), 32, torch.bfloat16, True),
    ((1, 30, 10, 32), 32, torch.float32, False),
    ((4, 64, 64, 320), 32, torch.bfloat16, True),  # tile batch of the 768x768 request
    ((4, 8, 8, 2560), 32, torch.bfloat16, True),
]


def check_flash(shape, skv, dtype, seed, packed=False):
    b, sq, h, d = shape
    if packed:  # (B, S, 3, H, D): the kernel must take the views as they are
        assert skv == sq
        q, k, v = randn((b, sq, 3, h, d), dtype, seed).unbind(2)
        assert not q.is_contiguous() and FA._kernel_operand(q) is q
    else:
        q = randn(shape, dtype, seed)
        k = randn((b, skv, h, d), dtype, seed + 1)
        v = randn((b, skv, h, d), dtype, seed + 2)
    out, lse = FA.flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    ref, ref_lse = FA.flash_attention_plain(q, k, v, return_lse=True)
    err = errors(out, ref)[0]
    scaled = err / ref.float().abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    assert out.shape == shape and out.dtype == dtype and lse.shape == (b * h, sq, 1)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert scaled <= TOL[dtype], f"flash_attention {shape} kv {skv} {dtype}: scaled err {scaled}"
    assert err_lse <= TOL_LSE, f"flash_attention lse {shape} kv {skv}: max abs err {err_lse}"
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    flops = 4.0 * b * h * sq * skv * d
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + lse.numel() * 4
    t_flops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return {
        "shape": f"q{list(shape)} kv{skv} {str(dtype)[6:]}" + (" packed qkv" if packed else ""),
        "max_abs_err": err,
        "max_err_over_max_ref": scaled,
        "max_abs_err_lse": err_lse,
        "ms": time_ms(lambda: FA.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: FA.flash_attention_plain(q, k, v)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
    }


def check_group_norm(shape, groups, dtype, seed):
    b, hh, ww, c = shape
    x = randn(shape, dtype, seed) * 2 + 0.5
    weight = randn((c,), dtype, seed + 1) * 0.1 + 1
    bias = randn((c,), dtype, seed + 2) * 0.1
    eps = 1e-6
    ref_sums = GN.group_norm_stats_plain(x, groups)[:, 0]
    partial = GN.group_norm_stats(x, groups)
    torch.cuda.synchronize()
    sums = partial.sum(dim=1)
    err_sums = ((sums - ref_sums).abs() / ref_sums.abs().clamp(min=1.0)).max().item()
    assert err_sums <= TOL_SUMS_REL, f"group_norm_stats {shape}: max rel err {err_sums}"
    errs = {}
    for silu in (True, False):
        y = GN.group_norm_apply(x, partial, weight, bias, groups, eps, silu)
        torch.cuda.synchronize()
        ref = GN.group_norm_silu_plain(x, weight, bias, groups, eps, silu)
        fused = GN.fused_group_norm_silu(x, weight, bias, groups, eps, silu)
        assert y.shape == shape and y.dtype == dtype and torch.isfinite(y.float()).all()
        (err, scaled), (err_f, scaled_f) = errors(y, ref), errors(fused, ref)
        errs[silu] = max(err, err_f)
        assert max(scaled, scaled_f) <= TOL[dtype], \
            f"group_norm_apply {shape} silu={silu}: scaled err {max(scaled, scaled_f)}"
    xc = x.permute(0, 3, 1, 2)  # channels_last view for the library calls
    nbytes = x.numel() * x.element_size()
    small = partial.numel() * 4
    # f32 operations per element: stats add, multiply, add; apply multiply-add
    # and for SiLU negate, exp, add, divide
    f32_rate = PEAK_FLOPS[torch.float32]
    t_stats = ((nbytes + small) / PEAK_BYTES_PER_S, 3 * x.numel() / f32_rate)
    t_apply = ((2 * nbytes + small + 2 * c * weight.element_size()) / PEAK_BYTES_PER_S,
               6 * x.numel() / f32_rate)
    label = f"x{list(shape)} G{groups} {str(dtype)[6:]}"
    stats = {
        "shape": label,
        "max_abs_err": err_sums,
        "ms": time_ms(lambda: GN.group_norm_stats(x, groups)),
        "plain_ms": time_ms(lambda: GN.group_norm_stats_plain(x, groups)),
        "library_ms": time_ms(lambda: torch.var_mean(
            x.reshape(b, hh * ww, groups, c // groups), dim=(1, 3), correction=0)),
        "bound_ms": max(t_stats) * 1e3,
        "bound_by": "bytes" if t_stats[0] >= t_stats[1] else "operations",
    }
    apply = {
        "shape": label,
        "max_abs_err": max(errs.values()),
        "max_abs_err_silu": errs[True],
        "max_abs_err_no_silu": errs[False],
        "ms": time_ms(lambda: GN.group_norm_apply(x, partial, weight, bias, groups, eps, True)),
        "plain_ms": time_ms(lambda: GN.group_norm_silu_plain(x, weight, bias, groups, eps, True)),
        # the library call computes statistics and apply together
        "library_ms": time_ms(lambda: F.silu(F.group_norm(xc, groups, weight, bias, eps))),
        "library_covers": "stats+apply",
        "bound_ms": max(t_apply) * 1e3,
        "bound_by": "bytes" if t_apply[0] >= t_apply[1] else "operations",
    }
    return stats, apply


def check_refusals():
    """On the card a wrapper launches its kernel or raises: a dtype or head dim
    the kernels do not take is refused, through the model's dispatch too, and
    never computed by the plain version."""
    from omgsr_tpu_torch.ops.attention import dot_product_attention

    before = (FA.launches.count, GN.stats_launches.count, GN.apply_launches.count)
    q = randn((1, 64, 2, 64), torch.float16, 300)
    x = randn((1, 8, 8, 64), torch.float16, 301)
    w = torch.ones(64, dtype=torch.float16, device="cuda")
    refused = 0
    for call in (lambda: dot_product_attention(q, q, q),
                 lambda: FA.flash_attention(q, q, q),
                 lambda: FA.flash_attention(*[randn((1, 64, 1, 512), torch.bfloat16, 302)] * 3),
                 lambda: GN.fused_group_norm_silu(x, w, w, 32)):
        try:
            call()
        except NotImplementedError:
            refused += 1
    assert refused == 4, f"only {refused} of 4 unsupported calls were refused"
    assert before == (FA.launches.count, GN.stats_launches.count, GN.apply_launches.count)
    print("kernels: fp16 and head dim 512 are refused on the card by both wrappers", flush=True)


def phase_kernels():
    check_refusals()
    flash, gn_stats, gn_apply = [], [], []
    for i, (shape, skv, dtype, on_path, packed) in enumerate(FLASH_SHAPES):
        r = check_flash(shape, skv, dtype, 100 + 10 * i, packed)
        r["on_serving_path"] = on_path
        flash.append(r)
        print(f"kernels: flash_attention_fwd {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[dtype]:.3g}) "
              f"lse err {r['max_abs_err_lse']:.3g}; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
              f"library {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} ({r['bound_by']})",
              flush=True)
    for i, (shape, groups, dtype, on_path) in enumerate(GN_SHAPES):
        s, a = check_group_norm(shape, groups, dtype, 200 + 10 * i)
        for name, r, lst in (("group_norm_stats", s, gn_stats), ("group_norm_apply", a, gn_apply)):
            r["on_serving_path"] = on_path
            lst.append(r)
            print(f"kernels: {name} {r['shape']}: err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    return {"flash_attention_fwd": flash, "group_norm_stats": gn_stats, "group_norm_apply": gn_apply}


# ----------------------------------------------------------------------------
# phase: serve
# ----------------------------------------------------------------------------


def structure_counts(vae_cfg, unet_cfg):
    """Kernel launches of one encode, one UNet call and one decode, read off
    the model's structure: (flash, group_norm) per stage."""
    n_down = len(unet_cfg.down_block_types)
    attn_down = sum("CrossAttn" in t for t in unet_cfg.down_block_types) * unet_cfg.layers_per_block
    attn_up = sum("CrossAttn" in t for t in unet_cfg.up_block_types) * (unet_cfg.layers_per_block + 1)
    blocks = (attn_down + 1 + attn_up) * unet_cfg.transformer_layers_per_block
    resnets = n_down * unet_cfg.layers_per_block + 2 + n_down * (unet_cfg.layers_per_block + 1)
    n_vae = len(vae_cfg.block_out_channels)
    enc_resnets = n_vae * vae_cfg.layers_per_block + 2
    dec_resnets = n_vae * (vae_cfg.layers_per_block + 1) + 2
    head_dims = {c // h for c, h in zip(unet_cfg.block_out_channels, unet_cfg.num_attention_heads)}
    assert all(FA.supports(d, torch.bfloat16) for d in head_dims), head_dims
    return {
        "unet": (2 * blocks, 2 * resnets + 1),  # self + cross per block; 2 GN+SiLU per resnet + out
        "encode": (0, 2 * enc_resnets + 1),  # the VAE mid head (dim 512) takes the matmul path
        "decode": (0, 2 * dec_resnets + 1),
    }


def unet_calls(h_px, w_px, tile, overlap, downscale):
    h, w = h_px // downscale, w_px // downscale
    if h * w <= tile * tile:
        return 1
    t = min(tile, h, w)
    n = len(tile_grid_2d(h, w, t, min(overlap, t // 2)))
    tb = auto_tile_batch(n)
    return -(-n // tb)


def run_clients(server, jobs):
    """One client thread per (image, align); returns outputs in order."""
    outs, errors = [None] * len(jobs), []

    def client(i, img, align):
        try:
            outs[i] = server.process_array(img, align)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i, img, al)) for i, (img, al) in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    assert not any(t.is_alive() for t in threads), "a client thread did not finish"
    if errors:
        raise errors[0]
    return outs


def phase_serve(card, profile=False):
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    vae_params = init_vae(0, SD21_VAE, dtype, "cuda")
    unet_params = init_unet(1, SD21_UNET, dtype, "cuda")
    torch.cuda.synchronize()
    n_unet, n_vae = count_params(unet_params), count_params(vae_params)
    print(f"serve: SD2.1 UNet {n_unet / 1e6:.1f}M + VAE {n_vae / 1e6:.1f}M parameters, bf16, "
          f"from seeds, in {time.perf_counter() - t0:.1f} s", flush=True)
    assert abs(n_unet / 1e6 - 865.9) < 0.1 and abs(n_vae / 1e6 - 83.7) < 0.1
    rng = np.random.default_rng(2)
    prompt = rng.standard_normal((1, 77, 1024)).astype(np.float32)

    args = serve_cli.parse_args(
        ["--pipeline", "s", "--weight_dtype", "bf16", "--process_size", "512",
         "--mid_timestep", "273", "--latent", "mean", "--port", "0"]
    )
    server = serve_cli.build_server(args, params=(vae_params, unet_params), prompt_embeds=prompt)
    try:
        imgs512 = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(4)]
        img768 = rng.integers(0, 256, (768, 768, 3), dtype=np.uint8)
        jobs = [(imgs512[0], "nofix"), (imgs512[1], "adain"), (imgs512[2], "wavelet"),
                (imgs512[3], "nofix"), (img768, "adain")]

        tile, overlap = args.process_size // 8, args.process_size // 16
        per = structure_counts(SD21_VAE, SD21_UNET)
        expect_flash = expect_gn = 0
        for img, _ in jobs:
            calls = unet_calls(img.shape[0], img.shape[1], tile, overlap, SD21_VAE.downscale)
            expect_flash += per["encode"][0] + calls * per["unet"][0] + per["decode"][0]
            expect_gn += per["encode"][1] + calls * per["unet"][1] + per["decode"][1]

        for c in (FA.launches, GN.stats_launches, GN.apply_launches):
            c.reset()
        t0 = time.perf_counter()
        outs = run_clients(server, jobs)
        wall = time.perf_counter() - t0
        counts = {c.name: c.count for c in (FA.launches, GN.stats_launches, GN.apply_launches)}
        print(f"serve: 5 requests answered in {wall:.2f} s; launches {counts}; structure predicts "
              f"flash {expect_flash}, group_norm {expect_gn} "
              f"(one 512x512 request: flash {per['unet'][0]}, "
              f"group_norm {sum(v[1] for v in per.values())})", flush=True)
        assert counts["flash_attention_fwd"] == expect_flash > 0, counts
        assert counts["group_norm_stats"] == expect_gn > 0, counts
        assert counts["group_norm_apply"] == expect_gn, counts

        for (img, _), out in zip(jobs, outs):
            assert out.shape == img.shape and out.dtype == np.uint8, (out.shape, out.dtype)
            assert out.std() > 1.0, "constant output"
        # process_array raises on non-finite values before it quantises
        assert np.abs(outs[0].astype(int) - outs[3].astype(int)).mean() > 1.0, \
            "distinct inputs gave the same output"
        m = server.metrics()
        assert m["requests"] == 5 and m["errors"] == 0 and m["batched_images"] == 5, m
        health = server.health()
        assert health["backend"] == "cuda", health
        print(f"serve: metrics {json.dumps(m)}", flush=True)

        # the same request with every kernel wrapper routed to its plain version
        again = server.process_array(imgs512[0], "nofix")
        with route_kernels_to_plain():
            plain = server.process_array(imgs512[0], "nofix")
            plain2 = server.process_array(imgs512[0], "nofix")
        d_rerun = np.abs(again.astype(int) - outs[0].astype(int))
        d_plain = np.abs(again.astype(int) - plain.astype(int))
        d_plain2 = np.abs(plain2.astype(int) - plain.astype(int))
        print(f"serve: kernels vs plain versions on one 512x512 request (uint8 steps): "
              f"mean {d_plain.mean():.4f}, max {d_plain.max()}, "
              f"share within 8 steps {(d_plain <= 8).mean():.4f}; "
              f"same request twice with kernels: mean {d_rerun.mean():.4f}, max {d_rerun.max()}; "
              f"twice with plain versions: mean {d_plain2.mean():.4f}, max {d_plain2.max()}",
              flush=True)
        assert d_plain.mean() <= MAX_MEAN_STEPS and (d_plain <= 16).mean() >= 0.95, \
            (d_plain.mean(), (d_plain <= 16).mean())

        phase_http(server, imgs512[0][:128, :128])

        # ---- timings ----
        lat = []
        for i in range(6):
            t0 = time.perf_counter()
            server.process_array(imgs512[i % 4], "adain")
            lat.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(lat[1:])
        print(f"timings: 512x512 request latency p50 {p50:.2f} ms over {len(lat) - 1} requests "
              f"(first excluded: {lat[0]:.2f} ms) [{card}]", flush=True)
    finally:
        server.shutdown()

    pipe = OMGSRSPipeline(vae_params, unet_params, SD21_VAE, SD21_UNET, 273, device="cuda")
    lq = torch.from_numpy(imgs512[0].astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
    ctx = torch.from_numpy(prompt).to("cuda", dtype)
    with torch.inference_mode():
        z = pipe.encode(lq, sample_latent=False)
        z0 = pipe.latent_mid(z, ctx, tile, overlap)
        # each stage on identical inputs: kernels against their plain versions
        staged = {"vae_encode": lambda: pipe.encode(lq, sample_latent=False),
                  "unet": lambda: pipe.latent_mid(z, ctx, tile, overlap),
                  "vae_decode": lambda: pipe.decode(z0)}
        for name, fn in staged.items():
            a, a2 = fn().float(), fn().float()
            with route_kernels_to_plain():
                b = fn().float()
            rel = ((a - b).norm() / b.norm()).item()
            rel_rerun = ((a - a2).norm() / a.norm()).item()
            print(f"serve: {name} kernels vs plain versions, same input: rel L2 {rel:.3g} "
                  f"(kernels run twice: {rel_rerun:.3g})", flush=True)
            assert torch.isfinite(a).all() and rel <= MAX_STAGE_REL_L2, (name, rel)
        stages = {
            "vae_encode": time_ms(lambda: pipe.encode(lq, sample_latent=False), iters=5, warmup=1),
            "unet": time_ms(lambda: pipe.latent_mid(z, ctx, tile, overlap), iters=5, warmup=1),
            "vae_decode": time_ms(lambda: pipe.decode(z0), iters=5, warmup=1),
        }
        # how long the host takes to enqueue one stage (no synchronize inside):
        # where this reaches the device time, the stage waits for the host
        enqueue = {}
        for name, fn in staged.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enqueue[name] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        if profile:
            profile_stages(staged, stages, card)
    for name, ms in stages.items():
        print(f"timings: 512x512 {name} {ms:.2f} ms on the device, host enqueue "
              f"{enqueue[name]:.2f} ms [{card}]", flush=True)
    return counts, {"latency_ms_p50_512": p50, **{f"{k}_ms": v for k, v in stages.items()},
                    **{f"{k}_host_enqueue_ms": v for k, v in enqueue.items()}}


def profile_stages(staged, stages, card):
    """With --profile: kernel time by name from torch.profiler. A stage's busy
    share is the sum of its kernels' times over the elapsed time measured
    without the profiler (its own overhead stretches the host side only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    by_kernel = {}
    for name, fn in staged.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy_us = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            busy_us += us
            n, t = by_kernel.get(e.key, (0, 0.0))
            by_kernel[e.key] = (n + e.count, t + us)
        if busy_us == 0.0:
            print(f"profile: {name}: the profiler recorded no device time", flush=True)
            continue
        print(f"profile: 512x512 {name} kernels busy {busy_us / 1e3:.3f} ms of {stages[name]:.3f} ms "
              f"elapsed, idle share {1 - busy_us / 1e3 / stages[name]:.3f} [{card}]", flush=True)
    total = sum(t for _, t in by_kernel.values())
    for key, (n, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"profile: {t / 1e3:8.3f} ms {t / total:6.1%} {n:5d} x {key[:100]}", flush=True)


def phase_http(server, small_u8):
    """One PNG over HTTP, when Pillow is there to encode and decode it."""
    try:
        from PIL import Image
    except ImportError:
        print("http: skipped (PIL not installed)", flush=True)
        return
    import urllib.request

    httpd = server.make_httpd("127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    host, port = httpd.server_address[:2]
    buf = io.BytesIO()
    Image.fromarray(small_u8).save(buf, format="PNG")
    with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["backend"] == "cuda", health
    req = urllib.request.Request(f"http://{host}:{port}/v1/sr?align=adain", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.headers["Content-Type"] == "image/png"
        out = Image.open(io.BytesIO(r.read()))
    assert out.size == (512, 512), out.size
    print(f"http: /healthz {json.dumps(health)}; POST /v1/sr 128x128 -> {out.size}", flush=True)
    # the server's shutdown() stops this httpd and closes its socket


# ----------------------------------------------------------------------------


KERNELS = [
    # name (also its launch counter's), source, the TPU kernel it replaces
    ("flash_attention_fwd", "omgsr_tpu_torch/csrc/flash_attention_fwd.cu",
     "omgsr_tpu/ops/flash_attention.py:40"),
    ("group_norm_stats", "omgsr_tpu_torch/csrc/group_norm_silu.cu",
     "omgsr_tpu/ops/fused_groupnorm.py:38"),
    ("group_norm_apply", "omgsr_tpu_torch/csrc/group_norm_silu.cu",
     "omgsr_tpu/ops/fused_groupnorm.py:58"),
]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print kernel time by name and each stage's idle share")
    args = parser.parse_args()
    card = phase_device()

    t0 = time.perf_counter()
    built = build_kernels(kernel_sources(), verbose=True)
    for name, path in built.items():
        assert path.exists(), path
    print(f"build: {sorted(built)} compiled by nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    shapes = phase_kernels()
    counts, timings = phase_serve(card, args.profile)

    kernels = []
    for name, source, replaces in KERNELS:
        head = shapes[name][0]  # the largest shape of the serving path
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in shapes[name] if r["on_serving_path"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "shapes": shapes[name],
        })
    print(json.dumps({"timings": timings, "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
