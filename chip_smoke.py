#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omgsr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); exits non-zero without
them. Phases, each of which must pass:

  device   the card's name and power limit; TF32 switched off for f32 math
  build    every kernel source under omgsr_tpu_torch/csrc is compiled
  kernels  each hand-written kernel against its plain PyTorch version on the
           card at the shapes the serving and training paths give it
           (tolerances below), with its time, the plain version's, one library
           call's and the card's bound for the same work; the backward
           kernels are also run twice and must give the same bits
  serve    OMGSR-S one-step serving at full SD2.1 width (random weights
           from a seed, bf16): an SRServer built by cli.serve.build_server
           answers four 512x512 requests and one 768x768 request (tiled
           latent) from client threads; outputs are checked, the kernels'
           launch counts are held against what the model's structure
           predicts, and one request is repeated with the kernels routed to
           their plain versions
  timings  per-request latency and the VAE-encode / UNet / VAE-decode split;
           with --profile also kernel time by name and each stage's idle share
  serve-fused  the same weights served with VAEConfig.fused_resblocks=True
           (every VAE resnet through two launches of the fused GN+SiLU ->
           conv3x3 kernel): four 512x512 requests and one 1024x1024 request
           (nine latent tiles); launch counts against the structure's; the
           fused route against the plain route and against the unfused kernel
           route on identical inputs, per stage and on the image; request p50
           and stage times of the fused and the unfused server, interleaved
  train    OMGSR-S LoRA-GAN training at full width (SD2.1 VAE + UNet,
           ConvNeXt-L, 512x512, batch 1, LoRA ranks 16/32, bf16, weights from
           a seed): cli.train_omgsr_s.run_training takes 2 optimizer steps at
           gradient accumulation 2 on synthetic pairs; metrics, launch counts,
           the accumulation boundary and the frozen weights are checked, one
           micro-step is repeated with the kernels routed to their plain
           versions, and one is timed stage by stage
  serve-tiled  the tiled VAE at 2048x2048 (a 512x512 input upscaled 4x):
           a server built with --vae_tile 512 answers two requests with
           --vae_stats fast and one with --vae_stats exact (the full-image
           VAE); launch counts against the structure's, the flash kernel's
           launches at 65,536 tokens (the mid block's head on the whole
           256x256 latent) counted; each route's VAE stages against the
           full-image VAE at 2048 px, the fast route's also against its plain
           versions; latency, stage times and peak memory of each route

Where the VAE mid block's 512-wide head is timed, it is also timed on the
route it took before the flash kernels took head dim 512 (explicit matmul
attention, f32 scores), in turns, as a yardstick.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.cli import serve as serve_cli
from omgsr_tpu_torch.cli import train_omgsr_s as train_cli
from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.convert.params import init_convnext, init_unet, init_vae
from omgsr_tpu_torch.diffusion.tiling import tile_grid_2d
from omgsr_tpu_torch.inference import tiled_vae as TTV
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
from omgsr_tpu_torch.inference.tiled import auto_tile_batch
from omgsr_tpu_torch.losses.dists import init_dists
from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES, SD21_UNET, SD21_VAE
from omgsr_tpu_torch.models.layers import count_params
from omgsr_tpu_torch.ops import attention as ATT
from omgsr_tpu_torch.ops import conv3x3 as C3
from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.ops import fused_groupnorm as GN
from omgsr_tpu_torch.ops.kernel_build import build_kernels, kernel_sources, route_kernels_to_plain
from omgsr_tpu_torch.tools import check_conv3x3 as K45
from omgsr_tpu_torch.tools import check_flash_bwd as K2
from omgsr_tpu_torch.tools import check_flash_fwd as K1
from omgsr_tpu_torch.tools import check_group_norm as K3
from omgsr_tpu_torch.training.checkpoint import latest_checkpoint
from omgsr_tpu_torch.training.optim import global_norm
from omgsr_tpu_torch.training.trainer import draw_step_noise, grads_of
from omgsr_tpu_torch.utils.tree import flatten_dict

# published dense peaks of one H100 SXM (NVIDIA data sheet; f32 without tensor cores)
PEAK_BYTES_PER_S = K1.PEAK_BYTES_PER_S
PEAK_FLOPS = {torch.bfloat16: K1.PEAK_BF16_FLOPS, torch.float32: 67e12}

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
TOL = {torch.bfloat16: K1.TOL, torch.float32: 2e-4}
# log-sum-exp and group sums are f32 whatever the input type
# end to end, kernels against plain versions, one 512x512 request in bf16 at
# full depth with random weights: both runs round every activation to bf16
# (2^-8 relative) in different places, and ~200 random layers amplify that, so
# the uint8 images agree only on average: mean |difference| in uint8 steps
MAX_MEAN_STEPS = 6.0
# per stage on identical inputs, ||kernel - plain|| / ||plain|| in bf16
MAX_STAGE_REL_L2 = 0.05
TOL_LSE = K1.TOL_LSE
TOL_SUMS_REL = K3.TOL_SUMS_REL
# conv3x3: max |kernel - plain| over the largest |plain| value of the shape (as
# for flash attention), TOL per dtype; its channel sums and the fold of them as
# tools/check_conv3x3.py says (TOL_CONV_SUMS_REL, TOL_FOLD)
TOL_CONV_SUMS_REL = K45.TOL_CONV_SUMS_REL
TOL_FOLD = K45.TOL_FOLD
# training, kernels against plain versions, one micro-step in bf16 at full
# depth with random weights: relative difference of each loss (means over
# an image or a logit map, which average the per-element bf16 differences
# away), and of the generator's gradient norm (a sum over every LoRA leaf of
# gradients that passed through all ~200 layers twice)
MAX_LOSS_REL = 1e-3
MAX_GRAD_NORM_REL = 0.02


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


def sdpa_backend(qh, kh, vh):
    """The backend PyTorch's dispatcher picks for scaled_dot_product_attention."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(qh, kh, vh)).name


@contextlib.contextmanager
def mid_head_on_matmul_path():
    """A yardstick: the dispatch as it stood before the flash kernels took
    head dim 512, so the VAE mid block's head runs ops/attention.matmul_attention
    (f32 scores by cuBLAS). Never used for the checks."""
    saved = FA.SUPPORTED_HEAD_DIMS
    FA.SUPPORTED_HEAD_DIMS = tuple(d for d in saved if d != 512)
    try:
        yield
    finally:
        FA.SUPPORTED_HEAD_DIMS = saved


ALL_COUNTERS = (FA.launches, FA.merge_launches, FA.dq_launches, FA.dkv_launches, GN.stats_launches,
                GN.apply_launches, C3.conv3x3_launches, C3.gn_fused_launches, C3.fold_launches)


def reset_counts():
    for c in ALL_COUNTERS:
        c.reset()


def read_counts():
    return {c.name: c.count for c in ALL_COUNTERS}


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
    # bf16: the shapes of tools/check_flash_fwd.py, at D = 64 and 128 (K1_SHAPES) and at
    # 512 (K1_WIDE_SHAPES: the VAE mid block's single head at 512, 1024 and 2048 px, the
    # fast tiled decode's window, ragged packed); f32 ragged
    *((shape, skv, torch.bfloat16, on_path, packed) for shape, skv, on_path, packed in K1.K1_SHAPES),
    ((2, 300, 1, 64), 300, torch.float32, False, False),
    *((shape, skv, torch.bfloat16, on_path, packed) for shape, skv, on_path, packed in K1.K1_WIDE_SHAPES),
    ((1, 300, 1, 512), 177, torch.float32, False, False),
]
# the merge of a split kv loop (head dim 512): (B, Sq, H, D), Skv, chunks, on the paths?
MERGE_SHAPES = [((1, 4096, 1, 512), 4096, 2, True), ((1, 300, 2, 512), 1000, 3, False)]

GN_SHAPES = K3.GN_SHAPES  # (B, H, W, C), groups, dtype, on the serving path?


flash_plain_in_chunks = K1.flash_plain_in_chunks


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
    again = FA.flash_attention(q, k, v)
    ref, ref_lse = flash_plain_in_chunks(q, k, v)
    assert torch.equal(out, again), f"flash_attention {shape} kv {skv}: two runs differ"
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
    iters = 5 if sq * skv * d > 2 ** 36 else 20
    row = {
        "shape": f"q{list(shape)} kv{skv} {str(dtype)[6:]}" + (" packed qkv" if packed else ""),
        "max_abs_err": err,
        "max_err_over_max_ref": scaled,
        "max_abs_err_lse": err_lse,
        "bit_identical_twice": True,
        "ms": time_ms(lambda: FA.flash_attention(q, k, v), iters),
        "plain_ms": time_ms(lambda: flash_plain_in_chunks(q, k, v), iters),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters),
        "library_backend": sdpa_backend(qh, kh, vh),
        "bound_ms": max(t_flops, t_bytes) * 1e3,
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
    }
    row["tflops"] = flops / row["ms"] / 1e9
    row["bound_share"] = row["bound_ms"] / row["ms"]
    if dtype == torch.bfloat16 and d == 512:
        row["kv_loop_splits"] = FA.fwd_kv_splits(b, h, sq, skv, d, FA.sm_count(q.device))
    if d == 512 and b * h * sq * skv <= 2 ** 28:  # what ran at the VAE mid block before: explicit
        # matmul attention (its (S x S) f32 scores: 16 GiB at 65,536 tokens, not timed)
        row["matmul_attention_ms"] = time_ms(lambda: ATT.matmul_attention(q, k, v), iters)
    return row


def check_merge(shape, skv, splits, seed):
    """The merge of a split kv loop against its plain version, on the chunks
    the plain split makes of these inputs, twice for bit-identity, and timed."""
    b, sq, h, d = shape
    q = randn(shape, torch.bfloat16, seed)
    k = randn((b, skv, h, d), torch.bfloat16, seed + 1)
    v = randn((b, skv, h, d), torch.bfloat16, seed + 2)
    o_part, lse_part = FA.flash_attention_split_plain(q, k, v, d ** -0.5, splits)
    out, lse = FA.flash_attention_merge(o_part, lse_part, b, h)
    torch.cuda.synchronize()
    again = FA.flash_attention_merge(o_part, lse_part, b, h)
    ref, ref_lse = FA.flash_attention_merge_plain(o_part, lse_part, b, h)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1]), f"merge {shape}: two runs differ"
    assert out.shape == shape and torch.isfinite(out.float()).all() and lse.shape == (b * h, sq, 1)
    err = errors(out, ref)[0]
    scaled = err / ref.float().abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    assert scaled <= TOL[torch.bfloat16] and err_lse <= TOL_LSE, f"merge {shape}: {scaled}, {err_lse}"
    nbytes = (o_part.numel() + lse_part.numel()) * 4 + out.numel() * 2 + lse.numel() * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 3.0 * o_part.numel() / PEAK_FLOPS[torch.float32]  # weight, multiply-add per chunk element
    return {
        "shape": f"q{list(shape)} kv{skv} in {splits} chunks", "max_abs_err": err,
        "max_err_over_max_ref": scaled, "max_abs_err_lse": err_lse, "bit_identical_twice": True,
        "ms": time_ms(lambda: FA.flash_attention_merge(o_part, lse_part, b, h)),
        "plain_ms": time_ms(lambda: FA.flash_attention_merge_plain(o_part, lse_part, b, h)),
        "library_ms": None, "library_covers": "no one PyTorch call merges the chunks",
        "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def check_fold(shape, seed):
    """The fold of conv3x3_gn_fused's streamed sums into the next GroupNorm's
    (scale, shift) against its plain version, on the sums the kernel writes at
    a conv shape (bf16), twice for bit-identity, and timed."""
    h, w_, cin, cout = shape
    x, w, b, a, c, _ = K45.conv_inputs(shape, torch.bfloat16, seed)
    _, sums = C3._gn_fused(x, w, b, a, c, None, True)
    gamma = randn((cout,), torch.bfloat16, seed + 7) * 0.2 + 1
    beta = randn((cout,), torch.bfloat16, seed + 8) * 0.1
    got = C3.fold_gn_sums(sums, h * w_, 32, gamma, beta)
    torch.cuda.synchronize()
    again = C3.fold_gn_sums(sums, h * w_, 32, gamma, beta)
    ref = C3._affine_from_stacked_sums(sums, h * w_, 32, gamma, beta, 1e-6)
    assert all(torch.equal(g, r) for g, r in zip(got, again)), f"fold {shape}: two runs differ"
    err = max(errors(g, r)[1] for g, r in zip(got, ref))
    assert err <= TOL_FOLD, f"fold {shape}: {err}"
    nbytes = sums.numel() * 4 + 2 * cout * 2 + 2 * cout * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 2.0 * sums.numel() / PEAK_FLOPS[torch.float32]
    return {
        "shape": f"sums[2, {sums.shape[1]}, {cout}] of x[1, {h}, {w_}, {cin}]->{cout}, 32 groups",
        "max_abs_err": max(errors(g, r)[0] for g, r in zip(got, ref)), "max_err_scaled": err,
        "bit_identical_twice": True,
        "ms": time_ms(lambda: C3.fold_gn_sums(sums, h * w_, 32, gamma, beta)),
        "plain_ms": time_ms(lambda: C3._affine_from_stacked_sums(sums, h * w_, 32, gamma, beta, 1e-6)),
        "library_ms": None, "library_covers": "no one PyTorch call folds the sums",
        "bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
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
    assert torch.equal(partial, GN.group_norm_stats(x, groups)), f"group_norm_stats {shape}: two runs differ"
    sums = partial.sum(dim=1)
    err_sums = ((sums - ref_sums).abs() / ref_sums.abs().clamp(min=1.0)).max().item()
    assert err_sums <= TOL_SUMS_REL, f"group_norm_stats {shape}: max rel err {err_sums}"
    errs = {}
    for silu in (True, False):
        y = GN.group_norm_apply(x, partial, weight, bias, groups, eps, silu)
        torch.cuda.synchronize()
        assert torch.equal(y, GN.group_norm_apply(x, partial, weight, bias, groups, eps, silu)), \
            f"group_norm_apply {shape} silu={silu}: two runs differ"
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
    iters = 5 if x.numel() > 2 ** 28 else 20  # the 2K row's plain versions take tens of ms a call
    stats = {
        "shape": label,
        "max_abs_err": err_sums,
        "bit_identical_twice": True,
        "nchunks": partial.shape[1],
        "ms": time_ms(lambda: GN.group_norm_stats(x, groups), iters),
        "plain_ms": time_ms(lambda: GN.group_norm_stats_plain(x, groups), iters),
        "library_ms": time_ms(lambda: torch.var_mean(
            x.reshape(b, hh * ww, groups, c // groups), dim=(1, 3), correction=0), iters),
        "bound_ms": max(t_stats) * 1e3,
        "bound_by": "bytes" if t_stats[0] >= t_stats[1] else "operations",
    }
    apply = {
        "shape": label,
        "max_abs_err": max(errs.values()),
        "max_abs_err_silu": errs[True],
        "max_abs_err_no_silu": errs[False],
        "bit_identical_twice": True,
        "ms": time_ms(lambda: GN.group_norm_apply(x, partial, weight, bias, groups, eps, True), iters),
        "plain_ms": time_ms(lambda: GN.group_norm_silu_plain(x, weight, bias, groups, eps, True), iters),
        # the library call computes statistics and apply together
        "library_ms": time_ms(lambda: F.silu(F.group_norm(xc, groups, weight, bias, eps)), iters),
        "library_covers": "stats+apply",
        "bound_ms": max(t_apply) * 1e3,
        "bound_by": "bytes" if t_apply[0] >= t_apply[1] else "operations",
    }
    return stats, apply


# (B, Sq, H, D), Skv, dtype, on the training path?, packed q/k/v and a non-contiguous dO?
# The bf16 rows are check_flash_bwd's: at head dims 64 and 128 (K2_SHAPES) the training
# path's, the -F training shape, short kv at batch 4, and a row on each side of the dK/dV
# kernel's split choice; at 512 (WIDE_SHAPES) the VAE mid block's.
BWD_SHAPES = [(shape, skv, torch.bfloat16, on_path, packed)
              for shape, skv, on_path, packed in K2.K2_SHAPES + K2.WIDE_SHAPES] + [
    ((2, 300, 1, 64), 300, torch.float32, False, False),
    ((1, 300, 1, 512), 177, torch.float32, False, False),
]


def check_flash_bwd(shape, skv, dtype, seed, packed=False):
    """K2a and K2b against the plain backward, each also alone against its
    half of it, twice for bit-identity, and timed one by one."""
    b, sq, h, d = shape
    if packed:
        q, k, v = randn((b, sq, 3, h, d), dtype, seed).unbind(2)
        dout = randn((b, h, sq, d), dtype, seed + 3).permute(0, 2, 1, 3)  # as autograd may hand it over
        assert not dout.is_contiguous() and FA._kernel_operand(dout) is dout
    else:
        q = randn(shape, dtype, seed)
        k = randn((b, skv, h, d), dtype, seed + 1)
        v = randn((b, skv, h, d), dtype, seed + 2)
        dout = randn(shape, dtype, seed + 3)
    scale = 1.0 / math.sqrt(d)
    out, lse = FA.flash_attention(q, k, v, return_lse=True)
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout)
    ref = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    names = ("dq", "dk", "dv")
    errs, scaled = {}, {}
    for name, a, a2, r, like in zip(names, got, again, ref, (q, k, v)):
        assert a.shape == like.shape and a.dtype == dtype and torch.isfinite(a.float()).all(), name
        assert torch.equal(a, a2), f"flash_attention_bwd {name} {shape} kv {skv}: two runs differ"
        errs[name] = errors(a, r)[0]
        scaled[name] = errs[name] / r.float().abs().max().item()
        assert scaled[name] <= TOL[dtype], \
            f"flash_attention_bwd {name} {shape} kv {skv} {dtype}: scaled err {scaled[name]}"
    # through autograd: the same kernels, the same bits
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(FA.flash_attention(*leaves), leaves, dout)
    assert all(torch.equal(a, g) for a, g in zip(auto, got)), "autograd path differs from the wrapper"

    ops = [FA._kernel_operand(t) for t in (q, k, v, out, dout)]
    qo, ko, vo, oo, go = ops
    lse2 = lse.contiguous()
    _, delta = FA._launch_dq(qo, ko, vo, oo, lse2, go, scale)
    gh, qh, kh, vh = (t.detach().permute(0, 2, 1, 3) for t in (dout, q, k, v))
    lib = [t.clone().requires_grad_() for t in (qh, kh, vh)]
    lib_out = F.scaled_dot_product_attention(*lib)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, lib, gh, retain_graph=True), iters=10)
    backend = sdpa_backend(*lib)
    matmul_ms = None
    if d == 512:  # what ran at the VAE mid block before: autograd through matmul attention
        mm = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        mm_out = ATT.matmul_attention(*mm)
        matmul_ms = time_ms(lambda: torch.autograd.grad(mm_out, mm, dout, retain_graph=True), iters=10)
    es = q.element_size()
    work = b * h * sq * skv * d
    small = lse.numel() * 4
    rows = {}
    for name, mult, nbytes, fn, plain in (
        ("flash_attention_bwd_dq", 6.0,
         (3 * q.numel() + 2 * k.numel() + q.numel()) * es + 2 * small,  # q, out, dO, k, v in; dq out
         lambda: FA._launch_dq(qo, ko, vo, oo, lse2, go, scale),
         lambda: FA.flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, scale)),
        ("flash_attention_bwd_dkv", 8.0,
         (2 * q.numel() + 2 * k.numel() + 2 * k.numel()) * es + 2 * small,  # q, dO, k, v in; dk, dv out
         lambda: FA._launch_dkv(qo, ko, vo, lse2, delta, go, scale),
         lambda: FA.flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, scale)),
    ):
        t_flops, t_bytes = mult * work / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
        part = ("dq",) if name.endswith("dq") else ("dk", "dv")
        rows[name] = {
            "shape": f"q{list(shape)} kv{skv} {str(dtype)[6:]}" + (" packed qkv, strided dO" if packed else ""),
            "max_abs_err": max(errs[n] for n in part),
            "max_err_over_max_ref": max(scaled[n] for n in part),
            "bit_identical_twice": True,
            "ms": time_ms(fn, iters=10),
            "plain_ms": time_ms(plain, iters=10),
            "library_ms": library_ms,
            "library_covers": "dq+dk+dv (scaled_dot_product_attention backward)",
            "library_backend": backend,
            "bound_ms": max(t_flops, t_bytes) * 1e3,
            "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        }
    if dtype == torch.bfloat16 and d in (64, 128):
        rows["flash_attention_bwd_dkv"]["q_loop_splits"] = FA.dkv_splits(b, h, sq, skv, d, FA.sm_count(q.device))
    # the pair against the least work for all three gradients: five products
    pair_bytes = (3 * q.numel() + 4 * k.numel() + q.numel()) * es
    pair = max(10.0 * work / PEAK_FLOPS[dtype], pair_bytes / PEAK_BYTES_PER_S) * 1e3
    for r in rows.values():
        r["pair_bound_ms"] = pair
        if matmul_ms is not None:
            r["matmul_attention_bwd_ms"] = matmul_ms
    return rows


def check_group_norm_bwd(shape, groups, dtype, seed):
    """The GroupNorm+SiLU autograd function (kernels forward, tensor-code
    backward) against autograd through the plain version."""
    c = shape[-1]
    x = randn(shape, dtype, seed) * 2 + 0.5
    weight = randn((c,), dtype, seed + 1) * 0.1 + 1
    bias = randn((c,), dtype, seed + 2) * 0.1
    dy = randn(shape, dtype, seed + 3)
    a = [t.clone().requires_grad_() for t in (x, weight, bias)]
    r = [t.clone().requires_grad_() for t in (x, weight, bias)]
    before = (GN.stats_launches.count, GN.apply_launches.count)
    y = GN.fused_group_norm_silu(*a, groups, 1e-6)
    assert (GN.stats_launches.count, GN.apply_launches.count) == (before[0] + 1, before[1] + 1)
    got = torch.autograd.grad(y, a, dy, retain_graph=True)
    y_ref = GN.group_norm_silu_plain(*r, groups, 1e-6)
    ref = torch.autograd.grad(y_ref, r, dy, retain_graph=True)
    torch.cuda.synchronize()
    scaled = {}
    for name, g, want in zip(("dx", "dweight", "dbias"), got, ref):
        assert g.shape == want.shape and g.dtype == want.dtype and torch.isfinite(g.float()).all()
        scaled[name] = errors(g, want)[0] / want.float().abs().max().item()
        assert scaled[name] <= TOL[dtype], f"group_norm_silu backward {name} {shape}: scaled err {scaled[name]}"
    ms = time_ms(lambda: torch.autograd.grad(y, a, dy, retain_graph=True), iters=10)
    plain_ms = time_ms(lambda: torch.autograd.grad(y_ref, r, dy, retain_graph=True), iters=10)
    print(f"kernels: group_norm_silu backward (tensor code) x{list(shape)} {str(dtype)[6:]}: err over max "
          f"|plain| dx {scaled['dx']:.3g} dweight {scaled['dweight']:.3g} dbias {scaled['dbias']:.3g} "
          f"(bound {TOL[dtype]:.3g}); {ms:.4f} ms, autograd through plain {plain_ms:.4f} ms", flush=True)


CONV_SHAPES = K45.CONV_SHAPES  # (H, W, C_in, C_out), dtype, on the fused serving path?


def check_conv(shape, dtype, seed):
    """K4 (with and without SiLU) and K5 (with skip and sums; without either)
    against their plain versions, each twice for bit-identity, and timed."""
    h, w_, cin, cout = shape
    x, w, b, a, c, skip = K45.conv_inputs(shape, dtype, seed)  # silu(c) is far from 0: a wrong ring shows
    assert C3.kernel_weight(w, dtype) is w  # the parameter trees' layout is the kernels' own
    label = f"x[1, {h}, {w_}, {cin}]->{cout} {str(dtype)[6:]}"
    iters = 5 if h * w_ * cin * cout > 2 ** 32 else 20
    # the library's own count of sum rows: one per pixel tile of the kernel that runs
    rows = C3.gn_fused_tile_rows(h, w_, cout, FA.sm_count(x.device)) if dtype == torch.bfloat16 else 0
    n_partials = C3._library().conv3x3_partials(C3._DTYPE_CODE[dtype], h, w_, rows)

    def held(name, got, ref):
        assert got.shape == ref.shape and got.dtype == dtype and torch.isfinite(got.float()).all(), name
        err = errors(got, ref)[0]
        scaled = err / ref.float().abs().max().item()
        assert scaled <= TOL[dtype], f"{name} {label}: scaled err {scaled}"
        return err, scaled

    k4 = {}
    for act in ("none", "silu"):
        y = C3.conv3x3(x, w, b, act)
        torch.cuda.synchronize()
        assert torch.equal(y, C3.conv3x3(x, w, b, act)), f"conv3x3 {label} act={act}: two runs differ"
        k4[act] = held(f"conv3x3 act={act}", y, C3.conv3x3_plain(x, w, b, act))
    k5 = {}
    for use_skip in (True, False):
        sk = skip if use_skip else None
        y, ssum, ssq = C3.conv3x3_gn_fused(x, w, b, a, c, skip=sk)
        torch.cuda.synchronize()
        y2, ssum2, ssq2 = C3.conv3x3_gn_fused(x, w, b, a, c, skip=sk)
        y3, none1, none2 = C3.conv3x3_gn_fused(x, w, b, a, c, skip=sk, emit_stats=False)
        assert torch.equal(y, y2) and torch.equal(ssum, ssum2) and torch.equal(ssq, ssq2) and torch.equal(y, y3), \
            f"conv3x3_gn_fused {label} skip={use_skip}: two runs differ"
        assert none1 is None and none2 is None
        ref, rsum, rsq = C3.conv3x3_gn_fused_plain(x, w, b, a, c, skip=sk)
        err, scaled = held(f"conv3x3_gn_fused skip={use_skip}", y, ref)
        err_sum, err_sq = K45.sums_errors(ssum, ssq, ref, rsum, rsq)
        assert ssum.shape == ssq.shape == (n_partials, cout) and ssum.dtype == torch.float32
        assert max(err_sum, err_sq) <= TOL_CONV_SUMS_REL, f"conv3x3_gn_fused sums {label}: {err_sum}, {err_sq}"
        k5[use_skip] = (err, scaled, err_sum, err_sq)

    # the library call: cuDNN's convolution of the activated input, channels_last
    # (it covers the nine products and the bias, not the prologue, the skip or the sums)
    h32 = x.float() * a + c
    xa = (h32 * torch.sigmoid(h32)).to(dtype).permute(0, 3, 1, 2)
    xc = x.permute(0, 3, 1, 2)
    es = x.element_size()
    flops = 2.0 * 9 * cin * cout * h * w_
    small = (w.numel() + cout) * es
    n_part = ssum.shape[0]
    t_flops = flops / PEAK_FLOPS[dtype]

    def bound(nbytes):
        t_bytes = nbytes / PEAK_BYTES_PER_S
        return max(t_flops, t_bytes) * 1e3, "operations" if t_flops >= t_bytes else "bytes"

    b4 = bound((h * w_ * (cin + cout)) * es + small)
    b5 = bound((h * w_ * (cin + 2 * cout)) * es + small + 2 * cin * 4 + 2 * n_part * cout * 4)
    row4 = {
        "shape": label, "max_abs_err": max(k4["none"][0], k4["silu"][0]),
        "max_err_over_max_ref": max(k4["none"][1], k4["silu"][1]), "bit_identical_twice": True,
        "tile_rows": C3.CONV_TILE_ROWS if dtype == torch.bfloat16 else None,
        "ms": time_ms(lambda: C3.conv3x3(x, w, b), iters),
        "ms_silu": time_ms(lambda: C3.conv3x3(x, w, b, "silu"), iters),
        "plain_ms": time_ms(lambda: C3.conv3x3_plain(x, w, b), iters),
        "library_ms": time_ms(lambda: F.conv2d(xc, w, b, padding=1), iters),
        "library_covers": "F.conv2d, channels_last: the whole function without SiLU",
        "bound_ms": b4[0], "bound_by": b4[1],
    }
    row5 = {
        "shape": label + " skip+sums", "max_abs_err": max(k5[True][0], k5[False][0]),
        "max_err_over_max_ref": max(k5[True][1], k5[False][1]),
        "max_rel_err_sum": max(k5[True][2], k5[False][2]), "max_rel_err_sumsq": max(k5[True][3], k5[False][3]),
        "partials": n_part, "tile_rows": rows or None, "bit_identical_twice": True,
        "ms": time_ms(lambda: C3.conv3x3_gn_fused(x, w, b, a, c, skip=skip), iters),
        "ms_sums_no_skip": time_ms(lambda: C3.conv3x3_gn_fused(x, w, b, a, c), iters),
        "ms_skip_no_sums": time_ms(lambda: C3.conv3x3_gn_fused(x, w, b, a, c, skip=skip, emit_stats=False), iters),
        "plain_ms": time_ms(lambda: C3.conv3x3_gn_fused_plain(x, w, b, a, c, skip=skip), iters),
        "library_ms": time_ms(lambda: F.conv2d(xa, w, b, padding=1), iters),
        "library_covers": "F.conv2d, channels_last, on the activated input: products and bias only",
        "bound_ms": b5[0], "bound_by": b5[1],
    }
    return row4, row5


def check_refusals():
    """On the card a wrapper launches its kernel or raises: a dtype or head dim
    the kernels do not take is refused, through the model's dispatch too, and
    never computed by the plain version."""
    from omgsr_tpu_torch.ops.attention import dot_product_attention

    counters = (FA.launches, GN.stats_launches, GN.apply_launches, C3.conv3x3_launches, C3.gn_fused_launches)
    before = [c.count for c in counters]
    q = randn((1, 64, 2, 64), torch.float16, 300)
    x = randn((1, 8, 8, 64), torch.float16, 301)
    w = torch.ones(64, dtype=torch.float16, device="cuda")
    # conv3x3: a channel count that is no multiple of 128, and fp16
    cx, cw = randn((1, 16, 16, 192), torch.bfloat16, 303), randn((128, 192, 3, 3), torch.bfloat16, 304)
    hx, hw = randn((1, 16, 16, 128), torch.float16, 305), randn((128, 128, 3, 3), torch.float16, 306)
    cb, one = torch.zeros(128, dtype=torch.bfloat16, device="cuda"), torch.ones(192, device="cuda")
    calls = [(lambda: dot_product_attention(q, q, q), NotImplementedError),
             (lambda: FA.flash_attention(q, q, q), NotImplementedError),
             (lambda: FA.flash_attention(*[randn((1, 64, 1, 96), torch.bfloat16, 302)] * 3), NotImplementedError),
             (lambda: GN.fused_group_norm_silu(x, w, w, 32), NotImplementedError),
             (lambda: C3.conv3x3(cx, cw, cb), ValueError),
             (lambda: C3.conv3x3_gn_fused(cx, cw, cb, one, one), ValueError),
             (lambda: C3.conv3x3(hx, hw, cb.half()), NotImplementedError),
             (lambda: C3.conv3x3_gn_fused(hx, hw, cb.half(), one[:128], one[:128]), NotImplementedError)]
    refused = 0
    for call, error in calls:
        try:
            call()
        except error:
            refused += 1
    assert refused == len(calls), f"only {refused} of {len(calls)} unsupported calls were refused"
    assert before == [c.count for c in counters]
    print("kernels: fp16 and head dim 96 are refused on the card by the flash and GroupNorm wrappers, "
          "192 channels and fp16 by both conv3x3 wrappers", flush=True)


def phase_kernels():
    check_refusals()
    flash, gn_stats, gn_apply = [], [], []
    for i, (shape, skv, dtype, on_path, packed) in enumerate(FLASH_SHAPES):
        r = check_flash(shape, skv, dtype, 100 + 10 * i, packed)
        r["on_serving_path"] = on_path
        flash.append(r)
        print(f"kernels: flash_attention_fwd {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[dtype]:.3g}) "
              f"lse err {r['max_abs_err_lse']:.3g}, two runs bit-identical; {r['ms']:.4f} ms "
              f"({r['tflops']:.1f} TFLOP/s, {r['bound_share']:.3f} of the bound), plain "
              f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} (SDPA {r['library_backend']}), bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']})"
              + (f", matmul_attention {r['matmul_attention_ms']:.4f}" if "matmul_attention_ms" in r else ""),
              flush=True)
    merge = []
    for i, (shape, skv, splits, on_path) in enumerate(MERGE_SHAPES):
        r = check_merge(shape, skv, splits, 150 + 10 * i)
        r["on_serving_path"] = on_path
        merge.append(r)
        print(f"kernels: flash_attention_fwd_merge {r['shape']}: err {r['max_abs_err']:.3g} "
              f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[torch.bfloat16]:.3g}) lse err "
              f"{r['max_abs_err_lse']:.3g}, two runs bit-identical; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    for i, (shape, groups, dtype, on_path) in enumerate(GN_SHAPES):
        s, a = check_group_norm(shape, groups, dtype, 200 + 10 * i)
        for name, r, lst in (("group_norm_stats", s, gn_stats), ("group_norm_apply", a, gn_apply)):
            r["on_serving_path"] = on_path
            lst.append(r)
            print(f"kernels: {name} {r['shape']}: err {r['max_abs_err']:.3g}, two runs bit-identical; "
                  f"{r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    bwd = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    for i, (shape, skv, dtype, on_path, packed) in enumerate(BWD_SHAPES):
        for name, r in check_flash_bwd(shape, skv, dtype, 400 + 10 * i, packed).items():
            r["on_training_path"] = on_path
            bwd[name].append(r)
            print(f"kernels: {name} {r['shape']}: err {r['max_abs_err']:.3g} "
                  f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[dtype]:.3g}), two runs "
                  f"bit-identical; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library (dq+dk+dv, SDPA "
                  f"{r['library_backend']}) {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} ({r['bound_by']}), "
                  f"pair bound {r['pair_bound_ms']:.5f}"
                  + (f", q loop in {r['q_loop_splits']} chunks" if "q_loop_splits" in r else "")
                  + (f", autograd through matmul_attention (dq+dk+dv) {r['matmul_attention_bwd_ms']:.4f}"
                     if "matmul_attention_bwd_ms" in r else ""), flush=True)
    check_group_norm_bwd((1, 512, 512, 128), 32, torch.bfloat16, 600)
    check_group_norm_bwd((1, 64, 64, 320), 32, torch.bfloat16, 610)
    conv = {"conv3x3": [], "conv3x3_gn_fused": []}
    for i, (shape, dtype, on_path) in enumerate(CONV_SHAPES):
        for name, r in zip(conv, check_conv(shape, dtype, 700 + 10 * i)):
            r["on_serving_path"] = on_path and name == "conv3x3_gn_fused"
            conv[name].append(r)
            extra = (f", sums rel err {r['max_rel_err_sum']:.3g} / {r['max_rel_err_sumsq']:.3g} over "
                     f"{r['partials']} partials (tile rows {r['tile_rows']}; bound {TOL_CONV_SUMS_REL}); sums without skip "
                     f"{r['ms_sums_no_skip']:.4f} ms, skip without sums {r['ms_skip_no_sums']:.4f} ms"
                     if "partials" in r else f"; with SiLU {r['ms_silu']:.4f} ms")
            print(f"kernels: {name} {r['shape']}: err {r['max_abs_err']:.3g} "
                  f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[dtype]:.3g}), two runs "
                  f"bit-identical; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, "
                  f"bound {r['bound_ms']:.5f} ({r['bound_by']}){extra}", flush=True)
    fold = []
    for i, (shape, dtype, on_path) in enumerate(CONV_SHAPES):
        if dtype != torch.bfloat16:
            continue
        r = check_fold(shape, 800 + 10 * i)
        r["on_serving_path"] = on_path
        fold.append(r)
        print(f"kernels: conv3x3_fold_sums {r['shape']}: err {r['max_abs_err']:.3g} ({r['max_err_scaled']:.3g} scaled, "
              f"bound {TOL_FOLD}), two runs bit-identical; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    return {"flash_attention_fwd": flash, "flash_attention_fwd_merge": merge, "group_norm_stats": gn_stats,
            "group_norm_apply": gn_apply, **bwd, **conv, "conv3x3_fold_sums": fold}


# ----------------------------------------------------------------------------
# phase: serve
# ----------------------------------------------------------------------------


def vae_resnet_channels(cfg):
    """(C_in, C_out) of every resnet of the encoder and of the decoder."""
    bo = list(cfg.block_out_channels)
    enc, ch = [], bo[0]
    for out in bo:
        enc += [(ch if j == 0 else out, out) for j in range(cfg.layers_per_block)]
        ch = out
    enc += [(ch, ch)] * 2  # mid block
    dec = [(ch, ch)] * 2
    for out in reversed(bo):
        dec += [(ch if j == 0 else out, out) for j in range(cfg.layers_per_block + 1)]
        ch = out
    return enc, dec


def structure_counts(vae_cfg, unet_cfg):
    """Kernel launches of one encode, one UNet call and one decode at batch 1,
    read off the model's structure: {stage: {counter name: launches}}."""
    n_down = len(unet_cfg.down_block_types)
    attn_down = sum("CrossAttn" in t for t in unet_cfg.down_block_types) * unet_cfg.layers_per_block
    attn_up = sum("CrossAttn" in t for t in unet_cfg.up_block_types) * (unet_cfg.layers_per_block + 1)
    blocks = (attn_down + 1 + attn_up) * unet_cfg.transformer_layers_per_block
    resnets = n_down * unet_cfg.layers_per_block + 2 + n_down * (unet_cfg.layers_per_block + 1)
    head_dims = {c // h for c, h in zip(unet_cfg.block_out_channels, unet_cfg.num_attention_heads)}
    head_dims.add(vae_cfg.block_out_channels[-1])  # the VAE mid block's single head
    assert all(FA.supports(d, torch.bfloat16) for d in head_dims), head_dims

    def vae_stage(channels):
        # a fused resnet: one stats launch for GroupNorm 1 and two fused convs; any other: two
        # GroupNorm+SiLU (stats + apply); conv_norm_out: one more. The mid block's single head
        # (dim 512): one flash launch.
        m = C3.CHANNEL_MULTIPLE
        fused = sum(ci % m == 0 and co % m == 0 for ci, co in channels) if vae_cfg.fused_resblocks else 0
        plain = len(channels) - fused
        return {"flash_attention_fwd": int(vae_cfg.mid_block_attention), "flash_attention_fwd_merge": 0,
                "group_norm_stats": 2 * plain + fused + 1,
                "group_norm_apply": 2 * plain + 1, "conv3x3_gn_fused": 2 * fused, "conv3x3_fold_sums": fused}

    enc, dec = vae_resnet_channels(vae_cfg)
    assert len(enc) == len(vae_cfg.block_out_channels) * vae_cfg.layers_per_block + 2
    return {
        # self + cross attention per block; 2 GroupNorm+SiLU per resnet + the output norm
        "unet": {"flash_attention_fwd": 2 * blocks, "flash_attention_fwd_merge": 0,
                 "group_norm_stats": 2 * resnets + 1, "group_norm_apply": 2 * resnets + 1,
                 "conv3x3_gn_fused": 0, "conv3x3_fold_sums": 0},
        "encode": vae_stage(enc),
        "decode": vae_stage(dec),
    }


def mid_head_merges(tokens):
    """Merge launches of one flash forward of the VAE mid head over `tokens`
    latent pixels: 1 where its kv loop is split (fwd_kv_splits)."""
    return int(FA.fwd_kv_splits(1, 1, tokens, tokens, 512, FA.sm_count(torch.device("cuda"))) > 1)


def expected_launches(sizes, per, tile, overlap, downscale):
    """Launches the structure predicts for one request of each (H, W)."""
    total = dict.fromkeys(per["unet"], 0)
    for h, w in sizes:
        calls = unet_calls(h, w, tile, overlap, downscale)
        for name in total:
            total[name] += per["encode"][name] + calls * per["unet"][name] + per["decode"][name]
        heads = per["encode"]["flash_attention_fwd"] + per["decode"]["flash_attention_fwd"]
        total["flash_attention_fwd_merge"] += heads * mid_head_merges((h // downscale) * (w // downscale))
    return total


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


def init_sd21(dtype):
    t0 = time.perf_counter()
    vae_params = init_vae(0, SD21_VAE, dtype, "cuda")
    unet_params = init_unet(1, SD21_UNET, dtype, "cuda")
    torch.cuda.synchronize()
    n_unet, n_vae = count_params(unet_params), count_params(vae_params)
    print(f"serve: SD2.1 UNet {n_unet / 1e6:.1f}M + VAE {n_vae / 1e6:.1f}M parameters, bf16, "
          f"from seeds, in {time.perf_counter() - t0:.1f} s", flush=True)
    assert abs(n_unet / 1e6 - 865.9) < 0.1 and abs(n_vae / 1e6 - 83.7) < 0.1
    return vae_params, unet_params


def phase_serve(card, vae_params, unet_params, profile=False):
    dtype = torch.bfloat16
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
        expect = expected_launches([img.shape[:2] for img, _ in jobs], per, tile, overlap, SD21_VAE.downscale)
        reset_counts()
        t0 = time.perf_counter()
        outs = run_clients(server, jobs)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if k in expect}
        print(f"serve: 5 requests answered in {wall:.2f} s; launches {counts}; structure predicts "
              f"{expect} (one 512x512 request: "
              f"{expected_launches([(512, 512)], per, tile, overlap, SD21_VAE.downscale)})", flush=True)
        assert counts == expect and expect["flash_attention_fwd"] > 0 and expect["group_norm_stats"] > 0, counts
        assert expect["group_norm_stats"] == expect["group_norm_apply"] and expect["conv3x3_gn_fused"] == 0

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
        # how long the host takes to enqueue one stage (no synchronize inside),
        # median of five: where this reaches the device time, the stage waits
        # for the host
        enqueue = {}
        for name, fn in staged.items():
            samples = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            enqueue[name] = statistics.median(samples)
        if profile:
            profile_stages(staged, stages, card)
        mid_head = vae_stages_mid_head_routes(pipe, imgs512[0], card)
    for name, ms in stages.items():
        print(f"timings: 512x512 {name} {ms:.2f} ms on the device, host enqueue "
              f"{enqueue[name]:.2f} ms [{card}]", flush=True)
    return counts, {"latency_ms_p50_512": p50, **{f"{k}_ms": v for k, v in stages.items()},
                    **{f"{k}_host_enqueue_ms": v for k, v in enqueue.items()}, **mid_head}


def vae_stages_mid_head_routes(pipe, img512, card):
    """The VAE stages at 512 and 1024 px with the mid block's head on the flash
    kernel (the path) and on the matmul route it took before, in turns
    (matmul, flash, flash, matmul); device ms, means of the two turns."""
    dtype = torch.bfloat16
    out = {}
    for px in (512, 1024):
        img = img512 if px == 512 else np.kron(img512, np.ones((2, 2, 1), np.uint8))
        lq = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
        z = pipe.encode(lq, sample_latent=False)
        for name, fn in (("vae_encode", lambda: pipe.encode(lq, sample_latent=False)),
                         ("vae_decode", lambda: pipe.decode(z))):
            ms = {"flash": [], "matmul": []}
            for route in ("matmul", "flash", "flash", "matmul"):
                ctx = mid_head_on_matmul_path() if route == "matmul" else contextlib.nullcontext()
                with ctx:
                    ms[route].append(time_ms(fn, iters=5 if px == 512 else 3, warmup=1))
            for route, v in ms.items():
                out[f"{name}_{px}_mid_head_{route}_ms"] = statistics.mean(v)
            print(f"timings: {px}x{px} {name} on the device, mid head on the flash kernel "
                  f"{statistics.mean(ms['flash']):.2f} ms ({ms['flash'][0]:.2f}, {ms['flash'][1]:.2f}), on the "
                  f"matmul route {statistics.mean(ms['matmul']):.2f} ms ({ms['matmul'][0]:.2f}, "
                  f"{ms['matmul'][1]:.2f}), in turns [{card}]", flush=True)
    return out


def profile_stages(staged, stages, card, label="512x512"):
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
        print(f"profile: {label} {name} kernels busy {busy_us / 1e3:.3f} ms of {stages[name]:.3f} ms "
              f"elapsed, idle share {1 - busy_us / 1e3 / stages[name]:.3f} [{card}]", flush=True)
    total = sum(t for _, t in by_kernel.values())
    for key, (n, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"profile: {label} {t / 1e3:8.3f} ms {t / total:6.1%} {n:5d} x {key[:100]}", flush=True)


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
# phase: serve-fused
# ----------------------------------------------------------------------------


def mean_steps(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return d.mean(), d.max(), (d <= 16).mean()


def phase_serve_fused(card, vae_params, unet_params, profile=False):
    """The serving path in the fused-resblock configuration, beside the
    unfused one built from the same parameters."""
    dtype = torch.bfloat16
    rng = np.random.default_rng(4)
    prompt = rng.standard_normal((1, 77, 1024)).astype(np.float32)
    fused_cfg = dataclasses.replace(SD21_VAE, fused_resblocks=True)
    args = serve_cli.parse_args(
        ["--pipeline", "s", "--weight_dtype", "bf16", "--process_size", "512",
         "--mid_timestep", "273", "--latent", "mean", "--port", "0"]
    )
    tile, overlap = args.process_size // 8, args.process_size // 16
    servers = {
        "fused": serve_cli.build_server(args, params=(vae_params, unet_params),
                                        configs=(fused_cfg, SD21_UNET), prompt_embeds=prompt),
        "unfused": serve_cli.build_server(args, params=(vae_params, unet_params), prompt_embeds=prompt),
    }
    try:
        imgs512 = [rng.integers(0, 256, (512, 512, 3), dtype=np.uint8) for _ in range(4)]
        img1024 = rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8)  # a 256x256 input, upscaled 4x
        jobs = [(imgs512[0], "nofix"), (imgs512[1], "adain"), (imgs512[2], "wavelet"),
                (imgs512[3], "nofix"), (img1024, "nofix")]
        per = structure_counts(fused_cfg, SD21_UNET)
        one = expected_launches([(512, 512)], per, tile, overlap, SD21_VAE.downscale)
        expect = expected_launches([img.shape[:2] for img, _ in jobs], per, tile, overlap, SD21_VAE.downscale)
        n_resnets = sum(len(c) for c in vae_resnet_channels(fused_cfg))
        assert one["conv3x3_gn_fused"] == 2 * n_resnets == 48, one  # every SD2.1 VAE resnet is eligible
        assert unet_calls(1024, 1024, tile, overlap, SD21_VAE.downscale) > 1

        reset_counts()
        t0 = time.perf_counter()
        outs = run_clients(servers["fused"], jobs)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if k in expect}
        print(f"serve-fused: 5 requests (four 512x512, one 1024x1024) answered in {wall:.2f} s; launches "
              f"{counts}; structure predicts {expect} (one 512x512 request: {one})", flush=True)
        assert counts == expect, (counts, expect)
        for (img, _), out in zip(jobs, outs):
            assert out.shape == img.shape and out.dtype == np.uint8, (out.shape, out.dtype)
            assert out.std() > 1.0, "constant output"
        m = servers["fused"].metrics()
        assert m["requests"] == 5 and m["errors"] == 0, m

        # identical requests: fused kernels, the same with every wrapper routed to its plain
        # version, and the unfused kernel route (GroupNorm+SiLU kernels, cuDNN convolutions)
        for name, img in (("512x512", imgs512[0]), ("1024x1024", img1024)):
            fused = outs[0] if img is imgs512[0] else outs[4]
            with route_kernels_to_plain():
                plain = servers["fused"].process_array(img, "nofix")
            unfused = servers["unfused"].process_array(img, "nofix")
            again = servers["fused"].process_array(img, "nofix")
            assert np.array_equal(again, fused), "the fused route gave two answers to one request"
            for other, ref in (("its plain versions", plain), ("the unfused kernel route", unfused)):
                mean, mx, share = mean_steps(fused, ref)
                print(f"serve-fused: {name} request, fused route vs {other} (uint8 steps): mean {mean:.4f}, "
                      f"max {mx}, share within 16 steps {share:.4f} (bounds: mean {MAX_MEAN_STEPS}, share 0.95)",
                      flush=True)
                assert mean <= MAX_MEAN_STEPS and share >= 0.95, (name, other, mean, share)

        # request latency, fused beside unfused, in turns
        lat = {"fused": [], "unfused": []}
        for i in range(7):
            for name in (("unfused", "fused") if i % 2 else ("fused", "unfused")):
                t0 = time.perf_counter()
                servers[name].process_array(imgs512[i % 4], "adain")
                lat[name].append((time.perf_counter() - t0) * 1e3)
        p50 = {k: statistics.median(v[1:]) for k, v in lat.items()}
        print(f"timings: 512x512 request latency p50, in turns over 6 requests each (first excluded): fused "
              f"{p50['fused']:.2f} ms, unfused {p50['unfused']:.2f} ms [{card}]", flush=True)
    finally:
        for srv in servers.values():
            srv.shutdown()

    pipes = {"fused": OMGSRSPipeline(vae_params, unet_params, fused_cfg, SD21_UNET, 273, device="cuda"),
             "unfused": OMGSRSPipeline(vae_params, unet_params, SD21_VAE, SD21_UNET, 273, device="cuda")}
    ctx = torch.from_numpy(prompt).to("cuda", dtype)
    timings = {f"latency_ms_p50_512_{k}": v for k, v in p50.items()}
    with torch.inference_mode():
        for px, img in ((512, imgs512[0]), (1024, img1024)):
            lq = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
            z = pipes["unfused"].encode(lq, sample_latent=False)
            z0 = pipes["unfused"].latent_mid(z, ctx, tile, overlap)
            stages = {"vae_encode": lambda p: p.encode(lq, sample_latent=False),
                      "unet": lambda p: p.latent_mid(z, ctx, tile, overlap),
                      "vae_decode": lambda p: p.decode(z0)}
            for name in ("vae_encode", "vae_decode"):
                fn = stages[name]
                a, a2 = fn(pipes["fused"]).float(), fn(pipes["fused"]).float()
                with route_kernels_to_plain():
                    plain = fn(pipes["fused"]).float()
                unfused = fn(pipes["unfused"]).float()
                rel_plain = ((a - plain).norm() / plain.norm()).item()
                rel_unfused = ((a - unfused).norm() / unfused.norm()).item()
                print(f"serve-fused: {px}x{px} {name}, same input: fused route vs its plain versions rel L2 "
                      f"{rel_plain:.3g}, vs the unfused kernel route {rel_unfused:.3g} (bound "
                      f"{MAX_STAGE_REL_L2}); fused twice: {'the same bits' if torch.equal(a, a2) else 'DIFFERENT'}",
                      flush=True)
                assert torch.isfinite(a).all() and torch.equal(a, a2), name
                assert max(rel_plain, rel_unfused) <= MAX_STAGE_REL_L2, (name, rel_plain, rel_unfused)
            iters = 5 if px == 512 else 3
            for name, fn in stages.items():
                if name == "unet" and px != 512:
                    continue
                # in turns: unfused, fused, fused, unfused
                order = ("unfused", "fused", "fused", "unfused")
                ms = {k: [] for k in pipes}
                for k in order:
                    ms[k].append(time_ms(lambda: fn(pipes[k]), iters=iters, warmup=1))
                enqueue = {}
                for k in pipes:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(pipes[k])
                    enqueue[k] = (time.perf_counter() - t0) * 1e3
                    torch.cuda.synchronize()
                print(f"timings: {px}x{px} {name} on the device, in turns: fused {statistics.mean(ms['fused']):.2f} ms "
                      f"({ms['fused'][0]:.2f}, {ms['fused'][1]:.2f}), unfused {statistics.mean(ms['unfused']):.2f} ms "
                      f"({ms['unfused'][0]:.2f}, {ms['unfused'][1]:.2f}); host enqueue fused {enqueue['fused']:.2f} ms, "
                      f"unfused {enqueue['unfused']:.2f} ms [{card}]", flush=True)
                for k in pipes:
                    timings[f"{name}_{px}_{k}_ms"] = statistics.mean(ms[k])
                    timings[f"{name}_{px}_{k}_host_enqueue_ms"] = enqueue[k]
            if profile and px == 512:
                vae_stages = ("vae_encode", "vae_decode")
                profile_stages({n: (lambda fn=stages[n]: fn(pipes["fused"])) for n in vae_stages},
                               {n: timings[f"{n}_512_fused_ms"] for n in vae_stages}, card,
                               "512x512 fused")
    return counts, timings


# ----------------------------------------------------------------------------
# phase: train
# ----------------------------------------------------------------------------

LOSSES = ("loss_LRR", "loss_Dv3D", "loss_L1", "loss_G", "loss_D_fake", "loss_D_real")
METRICS = LOSSES + ("loss_total_G", "loss_total_D", "grad_norm_G", "grad_norm_D")


def micro_step_counts(vae_cfg, unet_cfg):
    """Kernel launches of one training micro-step, read off the structure:
    two VAE encodes (hq frozen, under no_grad; lq with LoRA), one UNet call,
    one decode; every flash forward under autograd (all but the hq encode's
    mid head) has one dQ and one dK/dV launch."""
    per = structure_counts(vae_cfg, unet_cfg)
    flash, gn = (2 * per["encode"][k] + per["unet"][k] + per["decode"][k]
                 for k in ("flash_attention_fwd", "group_norm_stats"))
    bwd = flash - per["encode"]["flash_attention_fwd"]
    heads = 2 * per["encode"]["flash_attention_fwd"] + per["decode"]["flash_attention_fwd"]
    return {"flash_attention_fwd": flash, "flash_attention_fwd_merge": heads * mid_head_merges(64 * 64),
            "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd, "group_norm_stats": gn,
            "group_norm_apply": gn, "conv3x3": 0, "conv3x3_gn_fused": 0, "conv3x3_fold_sums": 0}


def evaluate_micro_step(trainer, batch, noise):
    """The ten metrics of one micro-step on the trainer's current state,
    computed as train_step computes them but without any update."""
    state, frozen = trainer.state, trainer.frozen
    lora, heads = state["gen"]["lora"], state["disc"]["params"]
    g_total, (g_metrics, pred) = trainer._gen_loss(lora, batch, noise, frozen, heads, state["disc"]["sn"])
    g_grads = grads_of(g_total, lora)
    d_total, (_, d_metrics) = trainer._disc_loss(heads, state["disc"]["sn"], pred.detach(), batch["hq"],
                                                 noise, frozen)
    d_grads = grads_of(d_total, heads)
    out = {"loss_total_G": g_total, "loss_total_D": d_total, **g_metrics, **d_metrics,
           "grad_norm_G": global_norm(g_grads), "grad_norm_D": global_norm(d_grads)}
    return {k: float(v.detach()) for k, v in out.items()}


def timed_micro_step(trainer, batch, noise):
    """One real micro-step (state is updated) with a CUDA event between its
    stages; returns {stage: ms} and the host's enqueue time of the step."""
    state, frozen = trainer.state, trainer.frozen
    lora, heads = state["gen"]["lora"], state["disc"]["params"]
    marks = [("start", torch.cuda.Event(enable_timing=True))]
    host = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
        host.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    marks[0][1].record()
    g_total, (_, pred) = trainer._gen_loss(lora, batch, noise, frozen, heads, state["disc"]["sn"])
    mark("G forward")
    g_grads = grads_of(g_total, lora)
    mark("G backward")
    fake = pred.detach()
    del pred, g_total
    trainer.gen_tx.update(g_grads, state["gen"]["opt"], lora)
    mark("G optimizer")
    d_total, (sn, _) = trainer._disc_loss(heads, state["disc"]["sn"], fake, batch["hq"], noise, frozen)
    mark("D forward")
    d_grads = grads_of(d_total, heads)
    mark("D backward")
    trainer.disc_tx.update(d_grads, state["disc"]["opt"], heads)
    mark("D optimizer")
    state["disc"]["sn"] = sn
    state["step"] += 1
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    device = {name: marks[i][1].elapsed_time(ev) for i, (name, ev) in enumerate(marks[1:])}
    host_ms = {name: (t - prev) * 1e3 for (name, _), t, prev in zip(marks[1:], host, [t0] + host)}
    return device, host_ms, enqueue_ms


def snapshot(tree):
    return {p: v.detach().clone() for p, v in flatten_dict(tree).items()}


def moved(tree, before):
    return any(not torch.equal(v.detach(), before[p]) for p, v in flatten_dict(tree).items())


def phase_train(card, vae_params, unet_params, profile=False):
    dtype = torch.bfloat16
    t0 = time.perf_counter()
    cn_cfg = CONVNEXT_SIZES["large"]
    backbone = init_convnext(2, cn_cfg, dtype, "cuda")
    rng = np.random.default_rng(3)
    frozen = {
        "vae": vae_params, "vae_cfg": SD21_VAE, "unet": unet_params, "unet_cfg": SD21_UNET,
        "backbone": backbone, "dists": init_dists(backbone, cn_cfg.dims),
        "prompt_embeds": torch.from_numpy(rng.standard_normal((1, 77, 1024)).astype(np.float32)).to("cuda", dtype),
    }
    torch.cuda.synchronize()
    print(f"train: ConvNeXt-L {count_params(backbone) / 1e6:.1f}M parameters from a seed in "
          f"{time.perf_counter() - t0:.1f} s; frozen bundle "
          f"{sum(count_params(frozen[k]) for k in ('vae', 'unet', 'backbone')) * 2 / 1e9:.2f} GB in bf16", flush=True)
    frozen_before = {k: snapshot(frozen[k]) for k in ("vae", "unet", "backbone")}

    def pair(seed):
        r = np.random.default_rng(seed)
        hq = np.tanh(r.standard_normal((1, 512, 512, 3))).astype(np.float32)
        lq = np.clip(hq + 0.2 * r.standard_normal(hq.shape).astype(np.float32), -1, 1)
        return {"lq": lq, "hq": hq}

    loader = [pair(10 + i) for i in range(4)]
    with tempfile.TemporaryDirectory() as out_dir:
        cfg = TrainConfig(
            output_dir=out_dir, resolution=512, train_batch_size=1, vae_lora_rank=16, unet_lora_rank=32,
            mixed_precision="bf16", gradient_accumulation_steps=2, max_train_steps=2, lr_warmup_steps=0,
            checkpointing_steps=1000, save_img_steps=1000, seed=123,
            extra={"disc_channels": list(cn_cfg.dims[:3]), "metrics_jsonl": f"{out_dir}/metrics.jsonl"},
        )
        expect = micro_step_counts(SD21_VAE, SD21_UNET)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train_cli.run_training(cfg, frozen=frozen, loader=loader, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        lines = [json.loads(l) for l in open(f"{out_dir}/metrics.jsonl")]
        ckpt = latest_checkpoint(out_dir)
        assert ckpt is not None and ckpt.endswith("checkpoint-2.pt"), ckpt
    n_lora = sum(v.numel() for v in flatten_dict(trainer.state["gen"]["lora"]).values())
    n_heads = sum(v.numel() for v in flatten_dict(trainer.state["disc"]["params"]).values())
    print(f"train: run_training took 2 optimizer steps (4 micro-steps) in {wall:.2f} s; trainable "
          f"LoRA {n_lora / 1e6:.2f}M + heads {n_heads / 1e6:.2f}M; launches {counts}; one micro-step's "
          f"structure predicts {expect}", flush=True)
    assert trainer.state["step"] == 4 and trainer.state["gen"]["opt"]["count"] == 2
    assert [l["step"] for l in lines] == [1, 2], lines
    for l in lines:
        print(f"train: optimizer step {l['step']}: " + " ".join(f"{k}={l[k]:.4f}" for k in METRICS), flush=True)
        assert all(math.isfinite(l[k]) for k in METRICS), l
    assert (expect["flash_attention_fwd"], expect["flash_attention_bwd_dq"]) == (35, 34), expect
    for name, n in expect.items():
        assert counts[name] == 4 * n, (name, counts[name], 4 * n)

    # the accumulation boundary: nothing moves on the first micro-step of a window
    gen = torch.Generator(device="cuda").manual_seed(5)
    batches = [{k: torch.from_numpy(v).to("cuda", dtype) for k, v in b.items()} for b in loader]
    latent_shape = (1, 64, 64, 4)

    def noise():
        return draw_step_noise(gen, (1, 512, 512, 3), latent_shape, "cuda", dtype)

    lora0 = snapshot(trainer.state["gen"]["lora"])
    heads0 = snapshot(trainer.state["disc"]["params"])
    u0 = snapshot(trainer.state["disc"]["sn"])
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m1, pred = trainer.train_step(batches[0], noise())
    torch.cuda.synchronize()
    step_s = [time.perf_counter() - t0]
    one = read_counts()
    peak_step = torch.cuda.max_memory_allocated()
    assert one == expect, (one, expect)
    assert pred.shape == (1, 512, 512, 3) and torch.isfinite(pred.float()).all()
    assert pred.abs().max() <= 1.0 and pred.float().std() > 1e-3
    assert not moved(trainer.state["gen"]["lora"], lora0), "LoRA leaves moved inside an accumulation window"
    assert not moved(trainer.state["disc"]["params"], heads0), "heads moved inside an accumulation window"
    assert moved(trainer.state["disc"]["sn"], u0), "spectral-norm u did not advance"
    t0 = time.perf_counter()
    m2, _ = trainer.train_step(batches[1], noise())
    torch.cuda.synchronize()
    step_s.append(time.perf_counter() - t0)
    assert moved(trainer.state["gen"]["lora"], lora0), "LoRA leaves did not move at the accumulation boundary"
    assert moved(trainer.state["disc"]["params"], heads0), "heads did not move at the accumulation boundary"
    for m in (m1, m2):
        assert all(math.isfinite(float(m[k])) for k in METRICS), m
    for k in ("vae", "unet", "backbone"):
        assert not moved(frozen[k], frozen_before[k]), f"frozen {k} changed"
        assert all(v.grad is None for v in flatten_dict(frozen[k]).values())
    print(f"train: micro-step launches {one}; LoRA and heads unchanged after the first micro-step of a "
          f"window and changed after the second; u advanced; frozen VAE/UNet/ConvNeXt bit-unchanged", flush=True)

    # one micro-step with the kernels against the same one with their plain versions
    nz = noise()
    with_kernels = evaluate_micro_step(trainer, batches[2], nz)
    again = evaluate_micro_step(trainer, batches[2], nz)
    with route_kernels_to_plain():
        plain = evaluate_micro_step(trainer, batches[2], nz)
    rel = {k: abs(with_kernels[k] - plain[k]) / max(abs(plain[k]), 1e-6) for k in METRICS}
    rerun = {k: abs(with_kernels[k] - again[k]) / max(abs(again[k]), 1e-6) for k in METRICS}
    print("train: kernels vs plain versions, one micro-step, relative difference: "
          + " ".join(f"{k}={rel[k]:.3g}" for k in METRICS)
          + f" (bounds: losses {MAX_LOSS_REL}, grad_norm_G {MAX_GRAD_NORM_REL}); the same micro-step twice "
          f"with kernels: max {max(rerun.values()):.3g}", flush=True)
    for k in LOSSES:
        assert rel[k] <= MAX_LOSS_REL, (k, with_kernels[k], plain[k])
    assert rel["grad_norm_G"] <= MAX_GRAD_NORM_REL, (with_kernels["grad_norm_G"], plain["grad_norm_G"])

    # timings
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batches[(2 + i) % 4], noise())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # two consecutive micro-steps: the first of an accumulation window only folds its gradients
    # into the running mean, the second also clips and applies the update
    assert trainer.state["gen"]["opt"]["mini_step"] == 0
    timed = [timed_micro_step(trainer, batches[i], noise()) for i in range(2)]
    s_per = statistics.median(step_s[1:])
    print(f"timings: training micro-step {s_per:.4f} s (median of {len(step_s) - 1}, host clock to "
          f"synchronize; first after run_training {step_s[0]:.4f} s); peak memory allocated "
          f"{peak / 2**30:.2f} GiB in run_training, {peak_step / 2**30:.2f} GiB in one micro-step [{card}]",
          flush=True)
    for what, (stages, host_ms, enqueue_ms) in zip(("accumulating", "applying the update"), timed):
        g_ms = sum(v for k, v in stages.items() if k.startswith("G"))
        d_ms = sum(v for k, v in stages.items() if k.startswith("D"))
        print(f"timings: micro-step {what}, by stage, device ms (host enqueue ms): "
              + ", ".join(f"{k} {v:.2f} ({host_ms[k]:.2f})" for k, v in stages.items())
              + f"; G {g_ms:.2f} / D {d_ms:.2f}; host enqueue of the step {enqueue_ms:.2f} ms [{card}]",
              flush=True)
    encoder = encoder_step_mid_head_routes(trainer, batches[0], noise(), card)
    if profile:
        profile_micro_step(trainer, batches[1], noise(), sum(timed[0][0].values()), card)
    timings = {"train_micro_step_s": s_per, "train_G_ms": g_ms, "train_D_ms": d_ms,
               "train_host_enqueue_ms": enqueue_ms, "train_peak_memory_GiB": peak / 2**30,
               **{f"train_{k.replace(' ', '_')}_ms": v for k, v in stages.items()}, **encoder}
    return counts, timings


def encoder_step_mid_head_routes(trainer, batch, noise, card):
    """The micro-step's encoder: the lq encode with the VAE LoRA and the
    gradient of a scalar of its latent with respect to the LoRA leaves, with
    the mid block's head on the flash kernels (the path: K1, K2a, K2b) and on
    the matmul route it took before, in turns; device ms."""
    lora = trainer.state["gen"]["lora"]["vae_encoder"]

    def step():
        z = trainer.encode_lora(trainer.frozen, lora, batch["lq"], noise.lq)
        return grads_of(z.float().square().mean(), lora)

    ms = {"flash": [], "matmul": []}
    for route in ("matmul", "flash", "flash", "matmul"):
        ctx = mid_head_on_matmul_path() if route == "matmul" else contextlib.nullcontext()
        with ctx:
            ms[route].append(time_ms(step, iters=5, warmup=1))
    print(f"timings: training micro-step's encoder (lq encode with LoRA, forward + backward) on the device, "
          f"mid head on the flash kernels {statistics.mean(ms['flash']):.2f} ms ({ms['flash'][0]:.2f}, "
          f"{ms['flash'][1]:.2f}), on the matmul route {statistics.mean(ms['matmul']):.2f} ms "
          f"({ms['matmul'][0]:.2f}, {ms['matmul'][1]:.2f}), in turns [{card}]", flush=True)
    return {f"train_encoder_fwd_bwd_mid_head_{k}_ms": statistics.mean(v) for k, v in ms.items()}


# ----------------------------------------------------------------------------
# phase: serve-tiled
# ----------------------------------------------------------------------------

# The exact route is the full-image VAE (inference/tiled_vae.py), held to it with
# MAX_STAGE_REL_L2 on identical inputs. The fast route estimates the statistics
# from a downsampled copy, which with random weights at full depth is bounded by
# nothing by design (the JAX package measured a mean error of 1-4% of the output's
# range with pretrained-like weights, omgsr_tpu/inference/tiled_vae.py:55-72); this
# bound only catches a wrong window plan, crop or placement (rel L2 of order 1).
# Its kernels are held to their plain versions on the same route instead, with
# MAX_STAGE_REL_L2. Its accuracy for users waits for trained weights.
MAX_FAST_REL_L2 = 0.5


def tiled_stage_flash_launches(size, tile, pad, stats):
    """Flash launches of one tiled VAE stage of a size x size buffer: the mid
    head once on the whole buffer (exact), or once in the statistics pass and
    once per window (fast)."""
    if stats == "exact" or size <= tile + 2 * pad:
        return 1
    return 1 + math.ceil(size / tile) ** 2


@contextlib.contextmanager
def count_mid_head_tokens(counts):
    """Counts the flash forward launches at head dim 512 by sequence length."""
    real = FA._forward

    def spy(q, k, v, scale):
        if q.is_cuda and q.shape[-1] == 512:
            counts[q.shape[1]] = counts.get(q.shape[1], 0) + 1
        return real(q, k, v, scale)

    FA._forward = spy
    try:
        yield counts
    finally:
        FA._forward = real


def phase_serve_tiled(card, vae_params, unet_params):
    """2048x2048 requests through the tiled VAE (--vae_tile 512), fast and
    exact, beside the full-image VAE on the same inputs."""
    dtype = torch.bfloat16
    rng = np.random.default_rng(5)
    prompt = rng.standard_normal((1, 77, 1024)).astype(np.float32)
    vae_tile = 512
    imgs = [np.kron(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8), np.ones((4, 4, 1), np.uint8))
            for _ in range(2)]  # 512x512 inputs upscaled 4x (nearest)
    common = ["--pipeline", "s", "--weight_dtype", "bf16", "--process_size", "512", "--mid_timestep", "273",
              "--latent", "mean", "--port", "0", "--vae_tile", str(vae_tile)]
    tile, overlap = 512 // 8, 512 // 16
    per = structure_counts(SD21_VAE, SD21_UNET)
    calls = unet_calls(2048, 2048, tile, overlap, SD21_VAE.downscale)
    lat = {}
    counts = {}
    timings = {}
    outs = {}
    for stats, jobs in (("fast", imgs), ("exact", imgs[:1])):
        args = serve_cli.parse_args(common + ["--vae_stats", stats])
        server = serve_cli.build_server(args, params=(vae_params, unet_params), prompt_embeds=prompt)
        try:
            assert server.fused_infer_fn is None
            vae_k1 = (tiled_stage_flash_launches(2048, vae_tile, TTV.ENCODER_PAD, stats)
                      + tiled_stage_flash_launches(256, vae_tile // 8, TTV.DECODER_PAD, stats))
            expect = {k: len(jobs) * calls * per["unet"][k] for k in per["unet"]}
            if stats == "exact":  # the full-image VAE
                expect = {k: v + len(jobs) * (per["encode"][k] + per["decode"][k]) for k, v in expect.items()}
            else:  # the hooked VAE launches no K3
                expect["flash_attention_fwd"] += len(jobs) * vae_k1
            reset_counts()
            tokens = {}
            torch.cuda.reset_peak_memory_stats()
            lat[stats], outs[stats] = [], []
            with count_mid_head_tokens(tokens):
                for img in jobs:
                    t0 = time.perf_counter()
                    outs[stats].append(server.process_array(img, "adain"))
                    lat[stats].append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            # a mid head whose kv loop is split adds one merge: read off the heads' token counts
            expect["flash_attention_fwd_merge"] = sum(n * mid_head_merges(t) for t, n in tokens.items())
            counts[stats] = {k: v for k, v in read_counts().items() if k in expect}
            print(f"serve-tiled: {len(jobs)} 2048x2048 request(s), --vae_stats {stats}: latency "
                  f"{', '.join(f'{v:.1f}' for v in lat[stats])} ms; peak memory allocated {peak / 2**30:.2f} GiB; "
                  f"launches {counts[stats]}, structure predicts {expect}; flash launches at head dim 512 by "
                  f"tokens {dict(sorted(tokens.items()))} [{card}]", flush=True)
            assert counts[stats] == expect, (stats, counts[stats], expect)
            if stats == "exact":
                assert tokens == {256 * 256: 2}, tokens  # the encoder's and the decoder's mid head
            else:
                assert sum(tokens.values()) == vae_k1 * len(jobs) and 256 * 256 not in tokens, tokens
            for img, out in zip(jobs, outs[stats]):
                assert out.shape == img.shape and out.dtype == np.uint8 and out.std() > 1.0
            m = server.metrics()
            assert m["requests"] == len(jobs) and m["errors"] == 0, m
            timings[f"tiled_{stats}_latency_ms"] = statistics.mean(lat[stats])
            timings[f"tiled_{stats}_request_peak_memory_GiB"] = peak / 2**30
        finally:
            server.shutdown()
    d = np.abs(outs["fast"][0].astype(int) - outs["exact"][0].astype(int))
    print(f"serve-tiled: the first image, fast route vs exact route (uint8 steps): mean {d.mean():.4f}, "
          f"max {d.max()}", flush=True)

    # each route's VAE stages against the full-image VAE on identical inputs, the fast
    # route's also against its plain versions, and timed
    pipes = {name: OMGSRSPipeline(vae_params, unet_params, SD21_VAE, SD21_UNET, 273, device="cuda",
                                  vae_tile=None if name == "full" else vae_tile)
             for name in ("full", "fast")}
    ctx = torch.from_numpy(prompt).to("cuda", dtype)
    lq = torch.from_numpy(imgs[0].astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
    with torch.inference_mode():
        stage_fns = {
            "full": (lambda: pipes["full"].encode(lq, sample_latent=False), lambda z: pipes["full"].decode(z)),
            "fast": (lambda: pipes["fast"].encode(lq, sample_latent=False), lambda z: pipes["fast"].decode(z)),
            "exact": (lambda: TTV.exact_vae_encode(vae_params, SD21_VAE, lq),
                      lambda z: torch.clamp(TTV.exact_vae_decode(vae_params, SD21_VAE, z), -1.0, 1.0)),
        }
        z_full = stage_fns["full"][0]()
        z0 = pipes["full"].latent_mid(z_full, ctx, tile, overlap)
        img_full = stage_fns["full"][1](z0)
        for name in ("exact", "fast"):
            enc, dec = stage_fns[name]
            rel_enc = ((enc().float() - z_full.float()).norm() / z_full.float().norm()).item()
            rel_dec = ((dec(z0).float() - img_full.float()).norm() / img_full.float().norm()).item()
            bound = MAX_STAGE_REL_L2 if name == "exact" else MAX_FAST_REL_L2
            print(f"serve-tiled: {name} route vs the full-image VAE at 2048 px, same input: encode rel L2 "
                  f"{rel_enc:.3g}, decode rel L2 {rel_dec:.3g} (bound {bound})", flush=True)
            assert math.isfinite(rel_enc) and math.isfinite(rel_dec) and max(rel_enc, rel_dec) <= bound, \
                (name, rel_enc, rel_dec)
            timings[f"tiled_{name}_encode_rel_l2_vs_full"] = rel_enc
            timings[f"tiled_{name}_decode_rel_l2_vs_full"] = rel_dec
        # the fast route with its kernels (K1 on every window and on the statistics
        # pass; the hooked GroupNorms are tensor code) against its plain versions
        enc, dec = stage_fns["fast"]
        for stage, fn in (("encode", enc), ("decode", lambda: dec(z0))):
            a = fn().float()
            with route_kernels_to_plain():
                b = fn().float()
            rel = ((a - b).norm() / b.norm()).item()
            print(f"serve-tiled: fast route {stage} at 2048 px, kernels vs plain versions, same input: rel L2 "
                  f"{rel:.3g} (bound {MAX_STAGE_REL_L2})", flush=True)
            assert torch.isfinite(a).all() and rel <= MAX_STAGE_REL_L2, (stage, rel)
            timings[f"tiled_fast_{stage}_rel_l2_kernels_vs_plain"] = rel
        unet_ms = time_ms(lambda: pipes["full"].latent_mid(z_full, ctx, tile, overlap), iters=2, warmup=1)
        for name in ("full", "fast"):
            enc, dec = stage_fns[name]
            torch.cuda.reset_peak_memory_stats()
            enc_ms = time_ms(enc, iters=2, warmup=1)
            dec_ms = time_ms(lambda: dec(z0), iters=2, warmup=1)
            peak = torch.cuda.max_memory_allocated()
            print(f"timings: 2048x2048 {name} VAE: encode {enc_ms:.2f} ms, decode {dec_ms:.2f} ms on the device "
                  f"(UNet over the 49 latent tiles {unet_ms:.2f} ms); peak memory allocated "
                  f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
            timings.update({f"tiled_{name}_vae_encode_2048_ms": enc_ms, f"tiled_{name}_vae_decode_2048_ms": dec_ms,
                            f"tiled_{name}_vae_peak_memory_GiB": peak / 2**30})
        timings["unet_2048_ms"] = unet_ms
    total = {k: counts["fast"][k] + counts["exact"][k] for k in counts["fast"]}
    return total, timings


def profile_micro_step(trainer, batch, noise, elapsed_ms, card):
    """With --profile: kernel time by name over one micro-step, and the idle
    share of the step (1 - busy / elapsed without the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from torch.profiler import record_function

    # the GroupNorm+SiLU backward is tensor code: give it a named range, so
    # that the device time of the kernels it launches can be read off
    real_bwd = GN.group_norm_silu_bwd

    def ranged_bwd(*a, **kw):
        with record_function("group_norm_silu_bwd (tensor code)"):
            return real_bwd(*a, **kw)

    GN.group_norm_silu_bwd = ranged_bwd
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_step(batch, noise)
            torch.cuda.synchronize()
    finally:
        GN.group_norm_silu_bwd = real_bwd
    by_kernel, busy_us = {}, 0.0
    for e in prof.key_averages():
        if e.key.startswith("group_norm_silu_bwd"):
            # the range shows up once per side; the host side's device time
            # is the sum over the kernels launched inside it
            if e.device_type != DeviceType.CUDA:
                us = getattr(e, "device_time_total", None)
                if us is None:
                    us = e.cuda_time_total
                print(f"profile: train {e.key}: {e.count} calls, {us / 1e3:.3f} ms of device time in "
                      f"the kernels they launched", flush=True)
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        busy_us += us
        by_kernel[e.key] = (e.count, us)
    if busy_us == 0.0:
        print("profile: training micro-step: the profiler recorded no device time", flush=True)
        return
    print(f"profile: training micro-step kernels busy {busy_us / 1e3:.3f} ms of {elapsed_ms:.3f} ms elapsed, "
          f"idle share {1 - busy_us / 1e3 / elapsed_ms:.3f} [{card}]", flush=True)
    for key, (n, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:16]:
        print(f"profile: train {us / 1e3:8.3f} ms {us / busy_us:6.1%} {n:5d} x {key[:100]}", flush=True)
    flash_bwd = [(n, us) for key, (n, us) in by_kernel.items() if "flash_bwd" in key]
    us = sum(u for _, u in flash_bwd)
    print(f"profile: train flash backward kernels (K2a, K2b, the split reduction) {us / 1e3:.3f} ms over "
          f"{sum(n for n, _ in flash_bwd)} launches, {us / busy_us:.3f} of kernel time [{card}]", flush=True)

# ----------------------------------------------------------------------------


KERNELS = [
    # name (also its launch counter's), source, the TPU kernel it replaces, the CUDA kernels its
    # wrapper launches (bf16 at D = 64/128 first)
    ("flash_attention_fwd", "omgsr_tpu_torch/csrc/flash_attention_fwd.cu",
     "omgsr_tpu/ops/flash_attention.py:40",
     ["flash_fwd_wgmma_kernel", "flash_fwd_wide_wgmma_kernel", "flash_fwd_kernel"]),
    # the merge of K1's split kv loop at head dim 512 (the TPU kernel ran its kv axis in order)
    ("flash_attention_fwd_merge", "omgsr_tpu_torch/csrc/flash_attention_fwd.cu",
     "omgsr_tpu/ops/flash_attention.py:40", ["flash_fwd_merge_kernel"]),
    ("flash_attention_bwd_dq", "omgsr_tpu_torch/csrc/flash_attention_bwd.cu",
     "omgsr_tpu/ops/flash_attention.py:88",
     ["flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_wide_kernel", "flash_bwd_dq_kernel"]),
    ("flash_attention_bwd_dkv", "omgsr_tpu_torch/csrc/flash_attention_bwd.cu",
     "omgsr_tpu/ops/flash_attention.py:127",
     ["flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_reduce_kernel", "flash_bwd_dkv_wide_kernel",
      "flash_bwd_dkv_kernel"]),
    ("group_norm_stats", "omgsr_tpu_torch/csrc/group_norm_silu.cu",
     "omgsr_tpu/ops/fused_groupnorm.py:38", ["gn_stats_kernel"]),
    ("group_norm_apply", "omgsr_tpu_torch/csrc/group_norm_silu.cu",
     "omgsr_tpu/ops/fused_groupnorm.py:58", ["gn_apply_kernel"]),
    ("conv3x3", "omgsr_tpu_torch/csrc/conv3x3.cu", "omgsr_tpu/ops/conv3x3.py:30",
     ["conv3x3_wgmma_kernel<1, false>", "conv3x3_fma_kernel<false>"]),
    ("conv3x3_gn_fused", "omgsr_tpu_torch/csrc/conv3x3.cu", "omgsr_tpu/ops/conv3x3.py:90",
     ["conv3x3_wgmma_kernel<2, true>", "conv3x3_wgmma_kernel<1, true>", "conv3x3_fma_kernel<true>"]),
    # the fold of K5's streamed sums into the next GroupNorm's affine (the JAX package's
    # gn_affine_from_channel_sums, tensor code that XLA fuses beside the Pallas call)
    ("conv3x3_fold_sums", "omgsr_tpu_torch/csrc/conv3x3.cu", "omgsr_tpu/ops/conv3x3.py:310",
     ["gn_fold_kernel"]),
]
# conv3x3 has no caller in the JAX package outside its tests (the fused resblock is two
# launches of conv3x3_gn_fused), so no path of the port runs it: the kernels phase holds it
# against its plain version, and its count over the paths is 0
OFF_PATH = ("conv3x3",)


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
    vae_params, unet_params = init_sd21(torch.bfloat16)
    serve_counts, timings = phase_serve(card, vae_params, unet_params, args.profile)
    fused_counts, fused_timings = phase_serve_fused(card, vae_params, unet_params, args.profile)
    train_counts, train_timings = phase_train(card, vae_params, unet_params, args.profile)
    tiled_counts, tiled_timings = phase_serve_tiled(card, vae_params, unet_params)
    timings.update(fused_timings)
    timings.update(train_timings)
    timings.update(tiled_timings)

    kernels = []
    for name, source, replaces, cuda_kernels in KERNELS:
        head = shapes[name][0]  # the largest shape of the serving and training paths
        on_path = [r for r in shapes[name] if r.get("on_serving_path") or r.get("on_training_path")] \
            or shapes[name]
        launches_serve, launches_train = serve_counts.get(name, 0), train_counts[name]
        launches_fused, launches_tiled = fused_counts.get(name, 0), tiled_counts.get(name, 0)
        if name in OFF_PATH:
            assert launches_serve + launches_fused + launches_train + launches_tiled == 0, name
        elif name.startswith("conv3x3"):
            assert launches_fused > 0 and launches_serve == launches_train == 0, name
        elif name == "flash_attention_fwd_merge":  # the 512-px mid heads split their kv loop
            assert launches_serve > 0 and launches_fused > 0 and launches_train > 0, name
        else:
            assert launches_train > 0 and ("bwd" in name or (launches_serve > 0 and launches_fused > 0)), name
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "cuda_kernels": cuda_kernels,
            "launches": launches_serve + launches_fused + launches_train + launches_tiled,
            "launches_serve": launches_serve, "launches_serve_fused": launches_fused,
            "launches_train": launches_train, "launches_serve_tiled": launches_tiled,
            "on_a_path": name not in OFF_PATH,
            "max_abs_err": max(r["max_abs_err"] for r in on_path),
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
