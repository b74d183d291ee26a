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
  load     OMGSR-S from a checkpoint directory on disk: the same weights and a
           seeded SD2.1 CLIP text encoder written in the published layout (f32;
           the UNet in two shards with an index) with a synthetic vocabulary of
           the published size, each component ported back and held to the
           weights written; cli.infer_omgsr_s.main on four images (--prompt "",
           bf16, the adapters the train phase exported) against the in-memory
           pipeline on the same merged weights and embeddings, its launches
           against the structure's; a server built from --sd_path against the
           CLI's image; build_frozen_s and encode_fixed_prompt on the same
           directory (and a ConvNeXt-L .pth)
  data     OMGSR-S from files on disk end to end: eight images written from a
           seed (PNG and JPEG, 2040x1356 down to 400x600, an FFHQ face, two
           named in a .txt list); the host's decode + crop per image and the
           decoder that ran; the card's Real-ESRGAN degrade against the CPU's
           on the same draws for every image, stage by stage on the card's
           own input to each stage (a JPEG stage in its halves, before and
           after rounding its coefficients), the composed outputs' uint8
           steps shown, with cuDNN's TF32 on and off; the degrade's device ms and peak memory per 512-px batch;
           train_omgsr_s.main --config at full width from the load phase's
           directory (2 optimizer steps at accumulation 2) with its launches,
           the loader's wait and the micro-step beside the train phase's;
           mid_timestep_sd.main on the same folder (4 samples, f32 VAE) with
           its launches
  serve-f  OMGSR-F one-step serving at FLUX.1-dev's full width and depth (the
           11.9B DiT and the FLUX VAE, bf16, random weights from seeds, a
           synthetic 512-token prompt): a server built by build_server
           --pipeline f answers three 1024x1024 requests (one latent tile of
           4608 tokens each) and one 2048x2048 request (nine tiles); launch
           counts against the structure's (57 flash launches per tile
           forward); one request repeated with the kernels routed to their
           plain versions; one dual and one single block at full width on
           the kernels against the plain flash attention (the attention's
           output and the block's); request p50, the encode / DiT / decode
           split, peak memory, and the DiT stage at 9, 16 and 13 tiles, one
           tile a forward and a larger batch in turns (with --profile also
           the stages' idle share and kernel time by name)
  quant-f  the quantised DiT at FLUX.1-dev's full width and depth, from the
           serve-f weights: int8, int8_w8a8 and int4 quantised one at a time
           on the card by quantize_flux_for_serving (tree_bytes printed),
           each serving three 1024x1024 requests through build_server
           --quantize (launches against the structure's, p50, the DiT
           stage's device and enqueue ms and idle share, peak memory, the
           DiT latent's rel L2 and the image's uint8 steps against the bf16
           server), then freed; run_training on the frozen int8 and int4
           bases (2 micro-steps at 1024 px, ranks 64/64, recompute), launches,
           finite losses, s per micro-step and peak memory; after load-f,
           infer_omgsr_f --quantize int8 on load-f's directory, whose peak
           above what was resident while the pipeline is built stays below the
           directory's bf16 DiT bytes (the whole run's beside the bf16 CLI's)
  train-f  OMGSR-F LoRA-GAN training at FLUX.1-dev's full width and depth
           (the serve-f DiT and VAE, the train phase's ConvNeXt-L, 1024x1024,
           batch 1, LoRA ranks 64/64, gradient checkpointing with per-block
           recompute, bf16): cli.train_omgsr_f.run_training takes 2 optimizer
           steps at gradient accumulation 2; metrics, launch counts against the
           structure's (57 K2a/K2b at q(1,4608,24,128) and 2 at
           q(1,16384,1,512) a micro-step), the accumulation boundary and the
           frozen weights are checked, one micro-step is repeated with the
           kernels routed to their plain versions, and one is timed stage by
           stage with its peak memory; the -F adapters are exported
  load-f   OMGSR-F from a checkpoint directory on disk: FLUX.1-dev's T5-XXL at
           full width and depth from a seed encodes the empty prompt and one
           past 512 tokens (timed, then freed); the DiT at full width and 2 + 2
           blocks, the VAE, CLIP-L at full width and T5 at full width and 2 of
           24 layers with synthetic tokenizers at the published sizes, written
           in FLUX.1-dev's layout (tools/flux_checkpoint.py) and ported back;
           encode_prompt_flux on it against the in-memory encoders; with the
           train-f adapters cut to that depth, cli.infer_omgsr_f.main --prompt
           on four images against the in-memory pipeline on the same merged
           weights, one serve --pipeline f --flux_path request,
           mid_timestep_flux.main on the data phase's folder at 1024 px, and
           train_omgsr_f.main --config (the package's omgsr_f_1024.yml, the
           fixed prompt "" through the directory's encoders, 2 optimizer steps
           at 1024 px from the data phase's folder)
  eval     eval_sr.main --dists --lpips --clipiqa --niqe_params on eight
           GT/SR pairs (512x512 from a seed: blurred and noised, shifted,
           JPEG, one identical, one below --metric_crop) at published widths
           (ConvNeXt-L, VGG16, CLIP-L/14 at 224; weights from seeds written
           in the published layouts; a pristine model fitted by niqe.main),
           every per-image score on the card against the same CLI on the CPU;
           s per image per metric
  shard    multi-GPU serving on a one-rank NCCL group formed in-process (a
           TCP store on 127.0.0.1): -S tiles at 2048 px (49 tiles) against
           the unsharded pipeline and server; sharded_vae_encode / decode at
           2048 px against the full-image VAE; -F tiles, fsdp and tp on the
           serve-f weights (no copy) and tp on their int8 tree, each through
           build_server --shard on three 1024-px requests and one 2048-px
           request against the unsharded server (fsdp and tp the same bits),
           with p50, stage ms and peak; serve --shard tiles --sd_path over HTTP
           and POST /v1/reload of the train phase's adapters; then a world of
           two processes sharing the card over gloo runs the -S tile path and
           the sharded VAE at 2048 px against the one-rank references (the
           kernels' bound), and the same routes in f32 at 1024 px against the
           unsharded f32 pipeline and VAE. Within one uint8 step where the
           products differ; launch counts and shapes
  train-dist  multi-GPU LoRA-GAN training: on a one-rank NCCL group, -S at
           512 px and -F at 1024 px at full width and depth through
           run_training (2 optimizer steps at accumulation 2) on {data: 1}
           and {fsdp: 1}, the unsharded run's losses and LoRA and heads
           digests bit for bit; then a world of two processes sharing the
           card over gloo takes one step of -S {data: 2} (bf16 and f32),
           -S {fsdp: 2} (the UNet placed), -F {data: 2} at 2 + 2 blocks (bf16
           at 1024 px, f32 at 512 px) and -F {fsdp: 2} at full depth (the
           DiT placed block by block as it is drawn), each against the
           one-process step on the same global batch (bf16 deviations
           reported; f32 within rtol 1e-3 on the metrics and rel L2 1e-4 on
           the LoRA; FSDP the same bits, at worst the f32 bound); s a
           micro-step, all-reduce and gather ms (gloo, host-staged), peak per
           rank; launch counts and shapes

  dinov3   the DINOv3 ViTs through the hub entries (random bf16 weights from
           seeds): ViT-L (0.3B) at batch 8 / 224 px and batch 1 / 512 px and
           ViT-7B (6.7B) at batch 1 / 224 and 512 px at full width and depth,
           apply and get_intermediate_layers(n=4), the ViT-7B linear
           classifier's logits against its head over the backbone's features;
           ms a forward, images/s, peak memory, K1 launches a forward (the
           depth); each K1 shape of the ViTs (201 and 1029 tokens, q and k
           fresh after RoPE, v a view of the packed qkv) timed and held against
           its plain version; ViT-L in f32 on the card against the plain
           versions on the CPU (rel L2 of the tokens <= 1e-4); with
           --profile one forward traced by utils.observability.trace
  ssl      DINOv3 SSL pretraining at full ViT-L/16 width (omgsr_tpu_torch/configs/
           ssl_vitl16.yml: 24 blocks of width 1024, 65,536-prototype heads, batch
           8 of 2 x 224 + 8 x 96 px crops, bf16 over f32 masters) on 24
           synthetic images: pretrain_dinov3.main for 4 iterations with the
           k-NN eval, the teacher export read back through the hub's ViT, a
           run resumed from the iteration-2 checkpoint against the straight
           one; the step with per-block recompute (peak, s, 120 K1 a step);
           one step in f32 against the CPU at depth 2; one gram-anchored step
           on 512-px gram crops; one distillation step from a ViT-7B/16
           teacher (ssl_vitl16_distilled.yml); s per iteration, the loader's
           wait and share, peaks, launches a step; each new K1 and K2a/K2b
           shape timed and held against its plain version (with --profile
           one step traced)
  drill    cli.fire_drill --family sd (the SD2.1 VAE and UNet in f32, sharded
           at 2 GB with an index) and --family flux (19 + 38 blocks at width
           512, bf16) on the card: fabricate with the port's writers, the
           infer CLI, eval_sr, the adapter round trip, validate_checkpoint
           against the CPU reference; passed and worst parity <= 1e-3, stage
           times

Every phase that serves, trains or runs a CLI records the shapes at which K1,
K2a/K2b and K3a/K3b launched and holds each shape that the kernels phase does
not list (and no earlier phase held) against its plain version.

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
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.cli import infer_omgsr_f as infer_f_cli
from omgsr_tpu_torch.cli import infer_omgsr_s as infer_cli
from omgsr_tpu_torch.cli import mid_timestep_flux as calib_f_cli
from omgsr_tpu_torch.cli import mid_timestep_sd as calib_cli
from omgsr_tpu_torch.cli import serve as serve_cli
from omgsr_tpu_torch.cli import train_omgsr_f as train_f_cli
from omgsr_tpu_torch.cli import train_omgsr_s as train_cli
from omgsr_tpu_torch.cli.prompts import encode_prompt_flux, encode_prompt_sd
from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.convert import porters
from omgsr_tpu_torch.convert.hf_config import flux_config_from_json, vae_config_from_json
from omgsr_tpu_torch.convert.params import (
    init_convnext,
    init_flux,
    init_t5_encoder,
    init_unet,
    init_vae,
    to_hf_state_dict,
)
from omgsr_tpu_torch.data import degradation as DEG
from omgsr_tpu_torch.data import imgdec_native
from omgsr_tpu_torch.data.dataset import PairedDataset, PairedLoader
from omgsr_tpu_torch.data.kernels import KernelSynthesisConfig, random_kernels
from omgsr_tpu_torch.diffusion.packing import latent_image_ids
from omgsr_tpu_torch.diffusion.tiling import tile_grid_2d
from omgsr_tpu_torch.inference import tiled_vae as TTV
from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline, flux_tile_batch
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
from omgsr_tpu_torch.inference.tiled import auto_tile_batch
from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, merge_lora
from omgsr_tpu_torch.lora.adapter_io import load_adapter, save_adapter
from omgsr_tpu_torch.losses.dists import init_dists
from omgsr_tpu_torch.models.clip_text import clip_text_apply, init_clip_text
from omgsr_tpu_torch.models.clip_tokenizer import CLIPTokenizer
from omgsr_tpu_torch.models import flux as FLUXM
from omgsr_tpu_torch.models.configs import (
    CONVNEXT_SIZES,
    FLUX_CLIP_L,
    FLUX_DEV,
    FLUX_T5_XXL,
    FLUX_VAE,
    SD21_CLIP,
    SD21_UNET,
    SD21_VAE,
)
from omgsr_tpu_torch.models.layers import count_params
from omgsr_tpu_torch.models.t5 import t5_encode
from omgsr_tpu_torch.models.t5_tokenizer import T5Tokenizer
from omgsr_tpu_torch.ops import attention as ATT
from omgsr_tpu_torch.ops import conv3x3 as C3
from omgsr_tpu_torch.ops import diffjpeg as DJ
from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.ops import fused_groupnorm as GN
from omgsr_tpu_torch.ops.color import adain_color_fix
from omgsr_tpu_torch.ops.kernel_build import build_kernels, kernel_sources, plain_route_active, route_kernels_to_plain
from omgsr_tpu_torch.ops.noise import GeneratorDraws, ReplayDraws
from omgsr_tpu_torch.tools import check_conv3x3 as K45
from omgsr_tpu_torch.tools import check_flash_bwd as K2
from omgsr_tpu_torch.tools import check_flash_fwd as K1
from omgsr_tpu_torch.tools import check_group_norm as K3
from omgsr_tpu_torch.tools.flux_checkpoint import synthetic_text_tokenizers, t5_tokenizer_json, write_flux_checkpoint
from omgsr_tpu_torch.tools.sd_checkpoint import synthetic_bpe, write_sd_checkpoint
from omgsr_tpu_torch.training.checkpoint import latest_checkpoint
from omgsr_tpu_torch.training.optim import global_norm
from omgsr_tpu_torch.training.trainer import draw_step_noise, grads_of
from omgsr_tpu_torch.utils.image_io import load_image_rgb, postprocess_sr_output, preprocess_sr_input
from omgsr_tpu_torch.utils.quantize import quantize_flux_for_serving, tree_bytes
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict

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
    # fast tiled decode's window, the padded 640x512 request, ragged packed); f32 ragged
    *((shape, skv, torch.bfloat16, on_path, packed) for shape, skv, on_path, packed in K1.K1_SHAPES),
    ((2, 300, 1, 64), 300, torch.float32, False, False),
    *((shape, skv, torch.bfloat16, on_path, packed) for shape, skv, on_path, packed in K1.K1_WIDE_SHAPES),
    ((1, 300, 1, 512), 177, torch.float32, False, False),
]
# the merge of a split kv loop (head dim 512): (B, Sq, H, D), Skv, chunks, on the paths?
MERGE_SHAPES = [((1, 4096, 1, 512), 4096, 2, True), ((1, 300, 2, 512), 1000, 3, False)]

GN_SHAPES = K3.GN_SHAPES  # (B, H, W, C), groups, dtype, on the serving path?


flash_plain_in_chunks = K1.flash_plain_in_chunks


def check_flash(shape, skv, dtype, seed, packed=False, timed=True):
    """K1 through its wrapper (with the kv split and merge it picks) against the
    plain version at one shape; with ``timed`` also its times and bound."""
    b, sq, h, d = shape
    if packed == "v":  # the DINOv3 ViT's operands: q and k fresh after RoPE, v a view of the packed qkv
        assert skv == sq
        q, k = randn(shape, dtype, seed), randn(shape, dtype, seed + 1)
        v = randn((b, sq, 3, h, d), dtype, seed + 2)[:, :, 2]
        assert not v.is_contiguous() and FA._kernel_operand(v) is v
    elif packed:  # (B, S, 3, H, D): the kernel must take the views as they are
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
    label = f"q{list(shape)} kv{skv} {str(dtype)[6:]}" + {"v": " v packed", True: " packed qkv"}.get(packed, "")
    if not timed:
        return {"shape": label, "max_abs_err": err, "max_err_over_max_ref": scaled, "max_abs_err_lse": err_lse}
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    flops = 4.0 * b * h * sq * skv * d
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + lse.numel() * 4
    t_flops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    iters = 5 if sq * skv * d > 2 ** 36 else 20
    row = {
        "shape": label,
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


def check_group_norm(shape, groups, dtype, seed, affine_dtype=None, timed=True):
    """K3a and K3b (with and without SiLU) against their plain versions at one
    shape -> (stats row, apply row); with ``timed`` also their times and bounds."""
    b, hh, ww, c = shape
    x = randn(shape, dtype, seed) * 2 + 0.5
    weight = randn((c,), affine_dtype or dtype, seed + 1) * 0.1 + 1
    bias = randn((c,), affine_dtype or dtype, seed + 2) * 0.1
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
    label = f"x{list(shape)} G{groups} {str(dtype)[6:]}"
    if not timed:
        return {"shape": label, "max_abs_err": err_sums}, {"shape": label, "max_abs_err": max(errs.values())}
    xc = x.permute(0, 3, 1, 2)  # channels_last view for the library calls
    nbytes = x.numel() * x.element_size()
    small = partial.numel() * 4
    # f32 operations per element: stats add, multiply, add; apply multiply-add
    # and for SiLU negate, exp, add, divide
    f32_rate = PEAK_FLOPS[torch.float32]
    t_stats = ((nbytes + small) / PEAK_BYTES_PER_S, 3 * x.numel() / f32_rate)
    t_apply = ((2 * nbytes + small + 2 * c * weight.element_size()) / PEAK_BYTES_PER_S,
               6 * x.numel() / f32_rate)
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
# kernel's split choice; at 512 (WIDE_SHAPES) the VAE mid block's at 512 and 1024 px, ragged
# and packed.
BWD_SHAPES = [(shape, skv, torch.bfloat16, on_path, packed)
              for shape, skv, on_path, packed in K2.K2_SHAPES + K2.WIDE_SHAPES] + [
    ((2, 300, 1, 64), 300, torch.float32, False, False),
    ((1, 300, 1, 512), 177, torch.float32, False, False),
]


def check_flash_bwd(shape, skv, dtype, seed, packed=False):
    """K2a and K2b against the plain backward, each also alone against its
    half of it, twice for bit-identity, and timed one by one."""
    b, sq, h, d = shape
    if packed == "v":  # the DINOv3 ViT's operands: q and k fresh after RoPE, v a view of the packed qkv
        assert skv == sq
        q, k = randn(shape, dtype, seed), randn(shape, dtype, seed + 1)
        v = randn((b, sq, 3, h, d), dtype, seed + 2)[:, :, 2]
        dout = randn(shape, dtype, seed + 3)
        assert not v.is_contiguous() and FA._kernel_operand(v) is v
    elif packed:
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
            "shape": f"q{list(shape)} kv{skv} {str(dtype)[6:]}" + {"v": " v packed", True: " packed qkv, strided dO"}
            .get(packed, ""),
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


def vae_structure_counts(vae_cfg):
    """Kernel launches of one VAE encode and one decode at batch 1, read off
    the VAE's structure: {"encode" / "decode": {counter name: launches}}."""
    assert FA.supports(vae_cfg.block_out_channels[-1], torch.bfloat16)  # the mid block's single head

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
    return {"encode": vae_stage(enc), "decode": vae_stage(dec)}


def structure_counts(vae_cfg, unet_cfg):
    """Kernel launches of one encode, one UNet call and one decode at batch 1,
    read off the model's structure: {stage: {counter name: launches}}."""
    n_down = len(unet_cfg.down_block_types)
    attn_down = sum("CrossAttn" in t for t in unet_cfg.down_block_types) * unet_cfg.layers_per_block
    attn_up = sum("CrossAttn" in t for t in unet_cfg.up_block_types) * (unet_cfg.layers_per_block + 1)
    blocks = (attn_down + 1 + attn_up) * unet_cfg.transformer_layers_per_block
    resnets = n_down * unet_cfg.layers_per_block + 2 + n_down * (unet_cfg.layers_per_block + 1)
    head_dims = {c // h for c, h in zip(unet_cfg.block_out_channels, unet_cfg.num_attention_heads)}
    assert all(FA.supports(d, torch.bfloat16) for d in head_dims), head_dims
    return {
        # self + cross attention per block; 2 GroupNorm+SiLU per resnet + the output norm
        "unet": {"flash_attention_fwd": 2 * blocks, "flash_attention_fwd_merge": 0,
                 "group_norm_stats": 2 * resnets + 1, "group_norm_apply": 2 * resnets + 1,
                 "conv3x3_gn_fused": 0, "conv3x3_fold_sums": 0},
        **vae_structure_counts(vae_cfg),
    }


def flux_structure_counts(vae_cfg, flux_cfg):
    """As structure_counts for OMGSR-F: one joint attention per dual and per
    single block of a DiT forward (head dim 128), no GroupNorm in the DiT."""
    assert FA.supports(flux_cfg.attention_head_dim, torch.bfloat16)
    return {"dit": {"flash_attention_fwd": flux_cfg.num_layers + flux_cfg.num_single_layers,
                    "flash_attention_fwd_merge": 0, "group_norm_stats": 0, "group_norm_apply": 0,
                    "conv3x3_gn_fused": 0, "conv3x3_fold_sums": 0},
            **vae_structure_counts(vae_cfg)}


def mid_head_merges(tokens):
    """Merge launches of one flash forward of the VAE mid head over `tokens`
    latent pixels: 1 where its kv loop is split (fwd_kv_splits)."""
    return int(FA.fwd_kv_splits(1, 1, tokens, tokens, 512, FA.sm_count(torch.device("cuda"))) > 1)


def expected_launches(sizes, per, tile, overlap, downscale):
    """Launches the structure predicts for one request of each (H, W)."""
    denoiser = "dit" if "dit" in per else "unet"
    total = dict.fromkeys(per[denoiser], 0)
    for h, w in sizes:
        calls = denoiser_calls(h, w, tile, overlap, downscale)
        for name in total:
            total[name] += per["encode"][name] + calls * per[denoiser][name] + per["decode"][name]
        heads = per["encode"]["flash_attention_fwd"] + per["decode"]["flash_attention_fwd"]
        total["flash_attention_fwd_merge"] += heads * mid_head_merges((h // downscale) * (w // downscale))
    return total


def latent_tiles(h_px, w_px, tile, overlap, downscale):
    """Latent tiles of one request (1 where the tile covers the latent)."""
    h, w = h_px // downscale, w_px // downscale
    if h * w <= tile * tile:
        return 1
    t = min(tile, h, w)
    return len(tile_grid_2d(h, w, t, min(overlap, t // 2)))


def denoiser_calls(h_px, w_px, tile, overlap, downscale):
    """UNet or DiT calls of one request: its tiles in batches of
    tiled.auto_tile_batch's size (the -S pipeline's default; the -F one's,
    pipeline_f.flux_tile_batch, agrees at every size this script serves)."""
    n = latent_tiles(h_px, w_px, tile, overlap, downscale)
    return -(-n // auto_tile_batch(n))


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
        with launch_shapes() as seen:
            outs = run_clients(server, jobs)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if k in expect}
        print(f"serve: 5 requests answered in {wall:.2f} s; launches {counts}; structure predicts "
              f"{expect} (one 512x512 request: "
              f"{expected_launches([(512, 512)], per, tile, overlap, SD21_VAE.downscale)})", flush=True)
        assert counts == expect and expect["flash_attention_fwd"] > 0 and expect["group_norm_stats"] > 0, counts
        assert expect["group_norm_stats"] == expect["group_norm_apply"] and expect["conv3x3_gn_fused"] == 0
        n_seen = report_launch_shapes("serve", "the requests", seen, 8000)
        assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen

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


def profile_stages(staged, stages, card, label="512x512", top=12):
    """With --profile: kernel time by name from torch.profiler (the ``top``
    largest). A stage's busy share is the sum of its kernels' times over the
    elapsed time measured without the profiler (its own overhead stretches
    the host side only). Returns {stage: idle share}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    by_kernel, idle = {}, {}
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
        idle[name] = 1 - busy_us / 1e3 / stages[name]
        print(f"profile: {label} {name} kernels busy {busy_us / 1e3:.3f} ms of {stages[name]:.3f} ms "
              f"elapsed, idle share {idle[name]:.3f} [{card}]", flush=True)
    total = sum(t for _, t in by_kernel.values())
    for key, (n, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"profile: {label} {t / 1e3:8.3f} ms {t / total:6.1%} {n:5d} x {key[:100]}", flush=True)
    return idle


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
        assert denoiser_calls(1024, 1024, tile, overlap, SD21_VAE.downscale) > 1

        reset_counts()
        t0 = time.perf_counter()
        with launch_shapes() as seen:
            outs = run_clients(servers["fused"], jobs)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in read_counts().items() if k in expect}
        print(f"serve-fused: 5 requests (four 512x512, one 1024x1024) answered in {wall:.2f} s; launches "
              f"{counts}; structure predicts {expect} (one 512x512 request: {one})", flush=True)
        assert counts == expect, (counts, expect)
        n_seen = report_launch_shapes("serve-fused", "the requests", seen, 8500)
        assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen
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


def phase_train(card, vae_params, unet_params, work_dir, profile=False):
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
    out_dir = os.path.join(work_dir, "train")  # kept: the load phase serves the adapters exported here
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
    with launch_shapes() as seen:
        trainer = train_cli.run_training(cfg, frozen=frozen, loader=loader, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    lines = [json.loads(l) for l in open(f"{out_dir}/metrics.jsonl")]
    ckpt = latest_checkpoint(out_dir)
    assert ckpt is not None and ckpt.endswith("checkpoint-2.pt"), ckpt
    # the adapters of the last step, in the reference's layout, and the LoRA tree they hold
    export = {"dir": os.path.join(out_dir, "weight-2"),
              "lora": {part: {p: v.detach().clone() for p, v in flatten_dict(tree).items()}
                       for part, tree in trainer.state["gen"]["lora"].items()}}
    for name in ("vae_encoder_lora_adapter", "unet_lora_adapter"):
        assert sorted(os.listdir(os.path.join(export["dir"], name))) == [
            "adapter_config.json", "adapter_model.safetensors"], name
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
    n_seen = report_launch_shapes("train", "run_training", seen, 9000)
    assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen

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
    return counts, timings, export


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


def mid_head_tokens(seen):
    """{tokens: launches} of the flash forward at head dim 512 (the VAE mid
    block's head) in a launch_shapes record."""
    counts = {}
    for (shape, _, _), n in seen["flash_n"].items():
        if shape[-1] == 512:
            counts[shape[1]] = counts.get(shape[1], 0) + n
    return counts


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
    calls = denoiser_calls(2048, 2048, tile, overlap, SD21_VAE.downscale)
    lat = {}
    counts = {}
    timings = {}
    outs = {}
    seen = {"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}
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
            torch.cuda.reset_peak_memory_stats()
            lat[stats], outs[stats] = [], []
            with launch_shapes() as seen_route:
                for img in jobs:
                    t0 = time.perf_counter()
                    outs[stats].append(server.process_array(img, "adain"))
                    lat[stats].append((time.perf_counter() - t0) * 1e3)
            merge_seen(seen, seen_route)
            tokens = mid_head_tokens(seen_route)
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
    n_seen = report_launch_shapes("serve-tiled", "the requests", seen, 9500)
    assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen
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


# ----------------------------------------------------------------------------
# phase: load
# ----------------------------------------------------------------------------

# (W, H) of the CLI's inputs: three 512x512 outputs and one whose prepared size (608x512 after the
# min-side guard, upscale and snap) the 64 px size bucket pads to 640x512
LOAD_INPUTS = [(128, 128)] * 3 + [(120, 100)]


def same_tree(a, b, dtype=None):
    """Every leaf of b equals a's, cast to ``dtype``, bit for bit."""
    fa, fb = flatten_dict(a), flatten_dict(b)
    return set(fa) == set(fb) and all(torch.equal(fa[p].to(dtype or fa[p].dtype), fb[p]) for p in fa)


def ported_component(name, fn, path, written, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = fn(path, device="cuda", **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    nbytes = written[1]
    print(f"load: ported {name}: {nbytes / 1e9:.3f} GB in {dt:.3f} s, {nbytes / 1e9 / dt:.2f} GB/s "
          f"(files in the page cache -> the card)", flush=True)
    return tree, dt


@contextlib.contextmanager
def launch_shapes():
    """The shapes at which K1 (its kv split and merge included), K2a/K2b and
    K3a/K3b launch inside the block: {"flash": {(shape, Skv, dtype)},
    "flash_n": {(shape, Skv, dtype): launches}, "bwd_n": the same for the
    backward pair, "gn": {(shape, groups, dtype): the affine dtype}}."""
    seen = {"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}
    forward, backward, stats, apply = FA._forward, FA.flash_attention_bwd, GN._launch_stats, GN._launch_apply

    def seen_forward(q, k, v, scale):
        if q.is_cuda:
            key = (tuple(q.shape), k.shape[1], q.dtype)
            seen["flash"].add(key)
            seen["flash_n"][key] = seen["flash_n"].get(key, 0) + 1
        return forward(q, k, v, scale)

    def seen_backward(q, k, v, *a, **kw):
        if q.is_cuda and not plain_route_active():
            key = (tuple(q.shape), k.shape[1], q.dtype)
            seen["bwd_n"][key] = seen["bwd_n"].get(key, 0) + 1
        return backward(q, k, v, *a, **kw)

    def seen_stats(x, geo, groups):
        seen["gn"].setdefault((tuple(x.shape), groups, x.dtype), x.dtype)
        return stats(x, geo, groups)

    def seen_apply(x, partial, weight, *a):
        seen["gn"][(tuple(x.shape), a[2], x.dtype)] = weight.dtype
        return apply(x, partial, weight, *a)

    FA._forward, FA.flash_attention_bwd, GN._launch_stats, GN._launch_apply = (
        seen_forward, seen_backward, seen_stats, seen_apply)
    try:
        yield seen
    finally:
        FA._forward, FA.flash_attention_bwd, GN._launch_stats, GN._launch_apply = forward, backward, stats, apply


def merge_seen(into, seen):
    into["flash"] |= seen["flash"]
    for counts in ("flash_n", "bwd_n"):
        for key, n in seen[counts].items():
            into[counts][key] = into[counts].get(key, 0) + n
    into["gn"].update(seen["gn"])
    return into


# the launch shapes an earlier phase of this run held against the plain versions: each is held once
HELD = {"flash": set(), "bwd": set(), "gn": set()}


def hold_launch_shapes(seen, seed):
    """K1 and K3a/K3b against their plain versions (the kernels phase's checks,
    untimed) at each shape in ``seen`` that FLASH_SHAPES and GN_SHAPES do not
    list and no earlier phase held -> ({kernel: shapes launched}, [(kernel,
    row) of each shape held])."""
    listed_flash = {(shape, skv, dtype) for shape, skv, dtype, _, _ in FLASH_SHAPES}
    listed_gn = {(shape, groups, dtype) for shape, groups, dtype, _ in GN_SHAPES}
    held = []
    flash = sorted(seen["flash"] - listed_flash - HELD["flash"], key=str)
    for i, (shape, skv, dtype) in enumerate(flash):
        held.append(("flash_attention_fwd", check_flash(shape, skv, dtype, seed + 10 * i, timed=False)))
    HELD["flash"] |= set(flash)
    extra = sorted(((k, a) for k, a in seen["gn"].items()
                    if (k not in listed_gn or a != k[2]) and (k, a) not in HELD["gn"]), key=str)
    for i, ((shape, groups, dtype), affine) in enumerate(extra):
        s, a = check_group_norm(shape, groups, dtype, seed + 5000 + 10 * i, affine, timed=False)
        held += [("group_norm_stats", s), ("group_norm_apply", a)]
    HELD["gn"] |= set(extra)
    listed_bwd = {(shape, skv, dtype) for shape, skv, dtype, _, _ in BWD_SHAPES}
    bwd = sorted(set(seen["bwd_n"]) - listed_bwd - HELD["bwd"], key=str)
    for i, (shape, skv, dtype) in enumerate(bwd):
        held += list(check_flash_bwd(shape, skv, dtype, seed + 8000 + 10 * i).items())
    HELD["bwd"] |= set(bwd)
    return {"flash_attention_fwd": len(seen["flash"]), "flash_attention_bwd": len(seen["bwd_n"]),
            "group_norm": len(seen["gn"])}, held


def report_launch_shapes(phase, what, seen, seed):
    """hold_launch_shapes with its report; returns the number of shapes
    launched per kernel."""
    n_seen, held = hold_launch_shapes(seen, seed)
    for name, r in held:
        print(f"{phase}: {name} {r['shape']} (launched by {what}, not listed by the kernels phase): err "
              f"{r['max_abs_err']:.3g}, two runs bit-identical", flush=True)
    n_held = sum(name == "flash_attention_fwd" for name, _ in held)
    n_bwd = sum(name == "flash_attention_bwd_dq" for name, _ in held)
    print(f"{phase}: {what} launched K1 at {n_seen['flash_attention_fwd']} shapes, K2a/K2b at "
          f"{n_seen['flash_attention_bwd']} and K3a/K3b at {n_seen['group_norm']}; those that neither the kernels "
          f"phase lists nor an earlier phase held ({n_held}, {n_bwd} and {(len(held) - n_held - 2 * n_bwd) // 2}) "
          f"were held against the plain versions here", flush=True)
    return n_seen


def phase_load(card, vae_params, unet_params, export, work_dir):
    """OMGSR-S from a checkpoint directory on disk: an SD2.1-base directory at
    full width written by the port's writer, ported back, its text encoder run
    on the empty prompt, then cli.infer_omgsr_s.main, cli.serve.build_server
    --sd_path and cli.train_omgsr_s.build_frozen_s on it."""
    from PIL import Image

    dtype = torch.bfloat16
    root = os.path.join(work_dir, "sd21")
    torch.cuda.reset_peak_memory_stats()
    clip_params = init_clip_text(3, SD21_CLIP, torch.float32, "cuda")
    vocab, merges = synthetic_bpe()
    assert len(vocab) == SD21_CLIP.vocab_size and (vocab["<|startoftext|>"], vocab["<|endoftext|>"], vocab["!"]) == (
        49406, 49407, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = write_sd_checkpoint(root, vae_params, SD21_VAE, unet_params, SD21_UNET, clip_params, SD21_CLIP,
                                  (vocab, merges), torch.float32, unet_shards=2)
    write_s = time.perf_counter() - t0
    unet_files = sorted(os.listdir(os.path.join(root, "unet")))
    assert unet_files == ["config.json", "diffusion_pytorch_model-00001-of-00002.safetensors",
                          "diffusion_pytorch_model-00002-of-00002.safetensors",
                          "diffusion_pytorch_model.safetensors.index.json"], unet_files
    print(f"load: SD2.1-base checkpoint written in f32 in {write_s:.2f} s (text encoder "
          f"{count_params(clip_params) / 1e6:.1f}M parameters from a seed, vocabulary {len(vocab)} entries): "
          + ", ".join(f"{k} {b / 1e9:.3f} GB in {t:.2f} s" for k, (t, b) in written.items()) + f" [{card}]",
          flush=True)

    # each component through its porter, timed, and held to the weights written
    vae_p, vae_s = ported_component("vae", porters.port_diffusers_vae, os.path.join(root, "vae"), written["vae"],
                                    cfg=SD21_VAE, dtype=dtype)
    unet_p, unet_s = ported_component("unet (index + 2 shards)", porters.port_diffusers_unet,
                                      os.path.join(root, "unet"), written["unet"], cfg=SD21_UNET, dtype=dtype)
    clip_p, clip_s = ported_component("text_encoder", porters.port_clip_text, os.path.join(root, "text_encoder"),
                                      written["text_encoder"], cfg=SD21_CLIP, dtype=torch.float32)
    assert same_tree(vae_params, vae_p, dtype) and same_tree(unet_params, unet_p, dtype)
    assert same_tree(clip_params, clip_p)
    del vae_p, unet_p

    # the text encoder on the empty prompt: the CLI's function against the in-memory encoder
    tok = CLIPTokenizer.from_pretrained(os.path.join(root, "tokenizer"))
    ids = tok("").to("cuda")
    assert ids.shape == (1, 77) and ids[0, :3].tolist() == [49406, 49407, 0], ids[0, :4]
    with torch.no_grad():
        ref_hidden, pooled = clip_text_apply(clip_params, SD21_CLIP, ids)
        encode_ms = time_ms(lambda: clip_text_apply(clip_p, SD21_CLIP, ids), iters=5, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hidden = encode_prompt_sd(root, "", torch.float32, "cuda")
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - t0
    err = (hidden - ref_hidden).abs().max().item()
    assert hidden.shape == (1, 77, 1024) and torch.isfinite(hidden).all() and err <= 1e-5, err
    assert pooled.shape == (1, 1024) and torch.equal(pooled, ref_hidden[:, 1])
    embeds = hidden.to(dtype)
    print(f"load: text encoder on the empty prompt: {encode_ms:.3f} ms on the device (f32, 77 tokens); "
          f"encode_prompt_sd {prompt_s:.2f} s with its tokenizer and port; against the in-memory encoder max abs "
          f"{err:.3g} [{card}]", flush=True)
    del clip_p

    # the inference CLI in-process, with the adapters the train phase exported
    rng = np.random.default_rng(7)
    img_dir, out_dir = os.path.join(work_dir, "load_inputs"), os.path.join(work_dir, "load_outputs")
    os.makedirs(img_dir)
    names = []
    for i, (w, h) in enumerate(LOAD_INPUTS):
        names.append(os.path.join(img_dir, f"img{i}.png"))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(names[-1])
    prepared = [preprocess_sr_input(load_image_rgb(n), 512, 4, 64) for n in names]
    sizes = [item[0].shape[1:3] for item in prepared]
    assert sizes[-1] == (512, 640) and prepared[-1][4] == (512, 608) and prepared[-1][2], sizes
    tile, overlap = 512 // 8, 512 // 16
    expect = expected_launches(sizes, structure_counts(SD21_VAE, SD21_UNET), tile, overlap, SD21_VAE.downscale)
    args = infer_cli.parse_args(["--input_image", img_dir, "--output_dir", out_dir, "--sd_path", root,
                                 "--lora_path", export["dir"], "--prompt", "", "--weight_dtype", "bf16",
                                 "--process_size", "512", "--mid_timestep", "273"])
    log = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_shapes() as seen, contextlib.redirect_stdout(log):
        infer_cli.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if k in expect}
    per_image = [float(v) for v in re.findall(r"Inference time per image: (\S+)s", log.getvalue())]
    assert len(per_image) == len(names), log.getvalue()
    print(f"load: infer_omgsr_s.main answered {len(names)} images ({', '.join(f'{w}x{h}' for w, h in LOAD_INPUTS)}) "
          f"in {cli_s:.2f} s with the checkpoint's load; launches {counts}; the structure predicts {expect}",
          flush=True)
    assert counts == expect and expect["flash_attention_fwd"] > 0 and expect["group_norm_stats"] > 0, counts
    # every shape the CLI launched the kernels at, held against the plain versions (after the count)
    n_seen = report_launch_shapes("load", "the CLI", seen, 3000)
    assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen

    # the in-memory pipeline on the same merged weights and embeddings, with the CLI's noise (seed = index)
    lora = {part: unflatten_dict(flat) for part, flat in export["lora"].items()}
    vae_m = {**vae_params, "encoder": merge_lora(vae_params["encoder"], lora["vae_encoder"])}
    pipe = OMGSRSPipeline(vae_m, merge_lora(unet_params, lora["denoiser"]), SD21_VAE, SD21_UNET, 273, device="cuda")
    cli_out = []
    for i, (name, (lq, src01, resize_flag, orig, true_hw)) in enumerate(zip(names, prepared)):
        with torch.inference_mode():
            out = pipe(torch.from_numpy(lq).to("cuda", dtype), embeds, tile, overlap,
                       generator=torch.Generator(device="cuda").manual_seed(i), sample_latent=True)
            ref = np.asarray(postprocess_sr_output(out, src01, true_hw, adain_color_fix, resize_flag, orig, 4))
        got = np.asarray(Image.open(os.path.join(out_dir, os.path.basename(name))))
        cli_out.append(got)
        d = np.abs(got.astype(int) - ref.astype(int))
        w, h = LOAD_INPUTS[i]
        assert got.shape == ref.shape == (4 * h, 4 * w, 3) and got.std() > 1.0, (got.shape, ref.shape)
        assert d.max() <= 1, (name, d.max(), d.mean())
    print(f"load: the CLI's {len(names)} PNGs against the in-memory pipeline on the same merged weights and "
          f"prompt embeddings: within 1 uint8 step", flush=True)
    del pipe, vae_m

    # a server from --sd_path: its first request (index 1) draws the noise of the CLI's second image
    sargs = serve_cli.parse_args(["--sd_path", root, "--lora_path", export["dir"], "--prompt", "",
                                  "--weight_dtype", "bf16", "--process_size", "512", "--mid_timestep", "273",
                                  "--port", "0"])
    t0 = time.perf_counter()
    server = serve_cli.build_server(sargs)
    build_s = time.perf_counter() - t0
    try:
        with open(names[1], "rb") as f:
            body = f.read()
        reply = np.asarray(Image.open(io.BytesIO(server.process_image(body, "adain"))))
    finally:
        server.shutdown()
    d = np.abs(reply.astype(int) - cli_out[1].astype(int))
    print(f"load: serve --sd_path built in {build_s:.2f} s; one request against the CLI's image: max "
          f"{d.max()} uint8 steps", flush=True)
    assert reply.shape == cli_out[1].shape and d.max() <= 1, d.max()

    # the training CLI's frozen bundle and fixed prompt from the same directory (and a DINOv3 ConvNeXt-L .pth)
    cn_cfg = CONVNEXT_SIZES["large"]
    backbone = init_convnext(2, cn_cfg, dtype, "cuda", with_final_norm=True)
    pth = os.path.join(work_dir, "dinov3_convnext_large.pth")
    torch.save({"model": {k: v.float().cpu() for k, v in to_hf_state_dict(backbone).items()}}, pth)
    cfg = TrainConfig(sd_path=root, mixed_precision="bf16", extra={"dinov3_weights_path": pth})
    t0 = time.perf_counter()
    frozen, got_cn = train_cli.build_frozen_s(cfg, dtype, device="cuda")
    fixed = train_cli.encode_fixed_prompt(cfg, dtype, device="cuda")
    torch.cuda.synchronize()
    frozen_s = time.perf_counter() - t0
    assert got_cn == cn_cfg and frozen["vae_cfg"] == SD21_VAE and frozen["unet_cfg"] == SD21_UNET
    assert same_tree(vae_params, frozen["vae"], dtype) and same_tree(unet_params, frozen["unet"], dtype)
    assert same_tree(backbone, frozen["backbone"], dtype)
    assert fixed.shape == (1, 77, 1024) and torch.isfinite(fixed.float()).all() and torch.equal(fixed, embeds)
    peak = torch.cuda.max_memory_allocated()
    print(f"load: build_frozen_s + encode_fixed_prompt in {frozen_s:.2f} s (VAE, UNet and ConvNeXt-L equal to "
          f"the written weights in bf16; the fixed prompt's embeddings (1, 77, 1024), finite)", flush=True)
    s_per_image = statistics.mean(per_image[1:])
    print(f"timings: load phase: checkpoint written in {write_s:.2f} s; ported vae {vae_s:.3f} s, unet "
          f"{unet_s:.3f} s, text encoder {clip_s:.3f} s; text encoding {encode_ms:.3f} ms; CLI "
          f"{s_per_image:.4f} s per image (first image excluded: {per_image[0]:.4f} s); peak memory allocated "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    return counts, {"load_write_s": write_s, "load_port_vae_s": vae_s, "load_port_unet_s": unet_s,
                    "load_port_text_encoder_s": clip_s, "load_text_encode_ms": encode_ms,
                    "load_cli_s_per_image": s_per_image, "load_peak_memory_GiB": peak / 2**30}, \
        {"sd_path": root, "dinov3_weights_path": pth}


# ----------------------------------------------------------------------------
# phase: data
# ----------------------------------------------------------------------------

# (file, (W, H)) of the images the data phase writes: a DIV2K-sized pair, a smaller pair, a 512x512
# pair named only in a .txt list, one image under the crop on one side (reflect pad), one FFHQ face
# (LANCZOS to 512 on the host)
DATA_IMAGES = [("hq/div2k_0801.png", (2040, 1356)), ("hq/div2k_0802.jpg", (2040, 1356)),
               ("hq/photo_a.png", (1024, 768)), ("hq/photo_b.jpg", (1024, 768)),
               ("listed/square.png", (512, 512)), ("listed/square.jpg", (512, 512)),
               ("hq/portrait.png", (400, 600)), ("hq/ffhq_00042.png", (1024, 1024))]
DATA_TRAIN_STEPS, DATA_ACCUM = 2, 2
DATA_CALIB_SAMPLES = 4
# the card's degrade against the CPU's, stage by stage: each operation that DEG.degrade calls is run
# again on the CPU on the card's own input to it (its draws copied across) and must agree within
# DEGRADE_STAGE_ATOL (images in [0,1]; a uint8 step is 1/255); a JPEG stage is held in its two halves,
# the DCT coefficients before rounding within DEGRADE_COEF_ATOL quantization steps, and the decode of
# the card's rounded coefficients within DEGRADE_STAGE_ATOL; the final x*255 round of the card's last
# stage output must give the card's uint8 levels. The composed pipelines are not held to each other: the JPEG
# stages round every coefficient, so an f32 difference at a .5 boundary moves one coefficient a whole
# step and its 8x8 block (16x16 in chroma) by up to a quarter of its table entry, some uint8 steps,
# which the later stages carry on
DEGRADE_STAGE_ATOL = 1e-5
DEGRADE_COEF_ATOL = 2e-3
DEGRADE_STAGES = ("filter2d", "resize", "add_gaussian_noise", "add_poisson_noise", "diffjpeg", "rgb_to_gray",
                  "_color_jitter")


def write_data_images(root, seed):
    """Smooth colour fields with a little noise (decode costs like a photo's,
    not like noise's), saved as PNG or JPEG (quality 95); the .txt list names
    the images under listed/."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for name, (w, h) in DATA_IMAGES:
        small = Image.fromarray(rng.integers(0, 256, (max(h // 32, 2), max(w // 32, 2), 3), dtype=np.uint8))
        arr = np.asarray(small.resize((w, h), Image.BICUBIC), np.float32)
        arr = np.clip(arr + rng.normal(0, 6, arr.shape), 0, 255).astype(np.uint8)
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, quality=95)
        paths.append(path)
    listed = os.path.join(root, "listed.txt")
    with open(listed, "w") as f:
        f.write("".join(p + "\n" for p in paths if "/listed/" in p))
    return [os.path.join(root, "hq"), listed]


@contextlib.contextmanager
def timed_loader():
    """Around every PairedLoader iteration: the host seconds each next() of
    the consumer took (the wait for a batch and the dispatch of the next one's
    degradation) and the clock when it returned."""
    rec = {"wait": [], "at": []}
    iterate = PairedLoader.__iter__

    def timed(self):
        it = iterate(self)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                rec["at"].append(time.perf_counter())
                rec["wait"].append(rec["at"][-1] - t0)
                yield batch
        finally:
            it.close()

    PairedLoader.__iter__ = timed
    try:
        yield rec
    finally:
        PairedLoader.__iter__ = iterate


class RecordedDraws(GeneratorDraws):
    """A torch.Generator's draws, each also kept in ``recorded``."""

    def __init__(self, generator):
        super().__init__(generator)
        self.recorded = []

    def uniform(self, shape, lo=0.0, hi=1.0):
        self.recorded.append(super().uniform(shape, lo, hi))
        return self.recorded[-1]

    def normal(self, shape):
        self.recorded.append(super().normal(shape))
        return self.recorded[-1]

    def poisson(self, rates):
        self.recorded.append(super().poisson(rates))
        return self.recorded[-1]


@contextlib.contextmanager
def degrade_stages(draws):
    """Each operation of DEGRADE_STAGES that DEG.degrade calls (not those
    they call in turn), kept as (name, args, kwargs, output, the draws it took)."""
    calls, depth = [], [0]
    saved = {name: getattr(DEG, name) for name in DEGRADE_STAGES}

    def wrap(name, fn):
        def stage(*args, **kwargs):
            start = len(draws.recorded)
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append((name, args, kwargs, out, draws.recorded[start:]))
            return out
        return stage

    for name, fn in saved.items():
        setattr(DEG, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(DEG, name, fn)


def stage_on_cpu(name, args, kwargs, out, taken):
    """One recorded stage of the card's degrade run again on the CPU on the
    card's input and draws -> (max abs error against the card's output, and
    for a JPEG stage the coefficients' max abs error in quantization steps
    and how many coefficients round to another step)."""
    def cpu(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a

    replay = ReplayDraws([d.cpu() for d in taken], "cpu")
    cargs = [replay if isinstance(a, RecordedDraws) else cpu(a) for a in args]
    ckwargs = {k: cpu(v) for k, v in kwargs.items()}
    if name != "diffjpeg":
        got = getattr(DEG, name)(*cargs, **ckwargs)
        assert replay.left() == 0 and got.shape == out.shape, (name, replay.left())
        return (got - out.cpu()).abs().max().item(), None, None
    assert not taken and not kwargs, name
    (img, q), (h, w) = cargs, args[0].shape[1:3]
    card_coefs, card_tables = DJ.jpeg_coefficients(*args)
    card_q = [torch.round(c) for c in card_coefs]
    assert torch.equal(DJ.jpeg_decode(*card_q, card_tables, h, w, args[0].dtype), out), "diffjpeg != its halves"
    coefs, tables = DJ.jpeg_coefficients(img, q)
    coef_err = max((a.cpu() - c).abs().max().item() for a, c in zip(card_coefs, coefs))
    moved = sum(int((a.cpu() != torch.round(c)).sum()) for a, c in zip(card_q, coefs))
    got = DJ.jpeg_decode(*(a.cpu() for a in card_q), tables, h, w, img.dtype)
    return (got - out.cpu()).abs().max().item(), coef_err, moved


def degrade_against_cpu(opt, hq, seed):
    """One 512-px batch through the card's degrade (its draws and each
    stage's input and output recorded), each stage again on the CPU
    (``stage_on_cpu``), and the whole degrade on the CPU on the same
    kernels, plan and draws -> (plan, stage errors, the composed outputs'
    uint8-step histogram, the card's output under cudnn.allow_tf32 True
    equal to it under False?)."""
    rng = np.random.default_rng(seed)
    kcfg = KernelSynthesisConfig.from_opt(opt, 512)
    ks = [random_kernels(rng, kcfg) for _ in range(hq.shape[0])]
    kernels = [np.stack([k[i] for k in ks]) for i in range(3)]
    full = {**opt, "scale": 4}
    plan = DEG.draw_plan(rng, full, 512, 512, 4, True, 16)
    draws = RecordedDraws(torch.Generator(device="cuda").manual_seed(seed))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), degrade_stages(draws) as calls:
        card = DEG.degrade(hq.cuda(), tuple(torch.from_numpy(k).cuda() for k in kernels), draws, plan, full)
    recorded = [d.cpu() for d in draws.recorded]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        card_f32 = DEG.degrade(hq.cuda(), tuple(torch.from_numpy(k).cuda() for k in kernels),
                               ReplayDraws(recorded, "cuda"), plan, full)
    errs = {"stages": [name for name, *_ in calls], "max_abs_err": 0.0, "coef_err": 0.0, "coefs_moved": 0}
    for call in calls:
        err, coef_err, moved = stage_on_cpu(*call)
        errs["max_abs_err"] = max(errs["max_abs_err"], err)
        if coef_err is not None:
            errs["coef_err"] = max(errs["coef_err"], coef_err)
            errs["coefs_moved"] += moved
    # in uint8 levels: the card divides by 255 as a product with its reciprocal, one ulp off the CPU's quotient
    last = calls[-1][3].cpu().expand(card.shape)
    errs["final_round_equal"] = torch.equal(torch.clamp(torch.round(last * 255.0), 0, 255),
                                            torch.round(card.cpu() * 255.0))
    replay = ReplayDraws(recorded, "cpu")
    cpu = DEG.degrade(hq, tuple(torch.from_numpy(k) for k in kernels), replay, plan, full)
    assert replay.left() == 0 and card.shape == cpu.shape == hq.shape
    steps = (torch.round(card.cpu() * 255) - torch.round(cpu * 255)).abs()
    hist = {int(v): int((steps == v).sum()) for v in steps.unique()}
    return plan, errs, hist, torch.equal(card, card_f32)


def phase_data(card, work_dir, ckpt, train_metrics):
    """OMGSR-S from files on disk end to end: images written here, the
    Real-ESRGAN degradation on the card, train_omgsr_s.main from a YAML config
    (full SD2.1 width, the checkpoint directory of the load phase) and
    mid_timestep_sd.main on the same folder."""
    root = os.path.join(work_dir, "data")
    t0 = time.perf_counter()
    sources = write_data_images(root, 11)
    write_s = time.perf_counter() - t0
    gxx = shutil.which("g++")
    decoder = imgdec_native.status()
    print(f"data: {len(DATA_IMAGES)} images written in {write_s:.2f} s ("
          + ", ".join(f"{os.path.basename(n)} {w}x{h}" for n, (w, h) in DATA_IMAGES)
          + f"); g++: {gxx or 'not found'}; decoder: {decoder}", flush=True)

    # the host's decode + crop (+ flip) per image, as the loader's producer thread runs it
    ds = PairedDataset(sources, 512, seed=0)
    assert len(ds) == len(DATA_IMAGES), ds.gt_list
    host_ms = {}
    for i, path in enumerate(ds.gt_list):
        t0 = time.perf_counter()
        arr = ds[i]
        host_ms[os.path.basename(path)] = (time.perf_counter() - t0) * 1e3
        assert arr.shape == (512, 512, 3) and arr.dtype == np.float32 and 0 <= arr.min() <= arr.max() <= 1
    print("data: host decode + crop per image, ms: " + ", ".join(f"{k} {v:.2f}" for k, v in host_ms.items())
          + f"; decoders {dict(ds.decoders)} [{card}]", flush=True)

    # the card's degrade against the CPU's stage by stage, the draws copied across: every image, each in
    # its own 512-px crop, in the order of their paths (not the directory's listing order)
    opt = DEG.load_degradation_params()
    crops = PairedDataset(sources, 512, seed=0)
    crops.gt_list.sort()
    for i, path in enumerate(crops.gt_list):
        hq = torch.from_numpy(np.stack([crops[i]]))
        plan, errs, hist, tf32_same = degrade_against_cpu(opt, hq, 100 + i)
        print(f"data: degrade, card against CPU on the same draws, 512x512 {os.path.basename(path)} (seed {100 + i}): "
              f"stages {'/'.join(errs['stages'])}, max abs err {errs['max_abs_err']:.3e} "
              f"(atol {DEGRADE_STAGE_ATOL:g}), JPEG coefficients {errs['coef_err']:.3e} steps "
              f"(atol {DEGRADE_COEF_ATOL:g}), {errs['coefs_moved']} rounded to another step; final round "
              f"equal: {errs['final_round_equal']}; the composed outputs' uint8-step histogram {hist}; the card's "
              f"output with cudnn.allow_tf32 on equal to off: {tf32_same}; plan {plan}", flush=True)
        assert (errs["max_abs_err"] <= DEGRADE_STAGE_ATOL and errs["coef_err"] <= DEGRADE_COEF_ATOL
                and errs["final_round_equal"] and tf32_same), (path, errs, tf32_same)

    # the degrader's device time per 512-px batch, and the loader's dispatch of a pinned host batch (copy,
    # degrade, scale to [-1,1]): two calls at a time are enqueued while the device sleeps, so the events
    # time the device's work back to back, and neither may wait for the device: the two must be enqueued
    # well inside the sleep. (Two calls, some 500 launches, stay inside the stream's queue of pending
    # launches; more would make the host wait for a free slot, not for a result.)
    degrader = DEG.RealESRGANDegrader(opt, resolution=512, seed=3)
    loader = PairedLoader(ds, 1, degrader)
    pinned = torch.from_numpy(np.stack([ds[0]])).pin_memory()
    x = pinned.cuda()
    for _ in range(3):
        degrader(x)
        loader._dispatch(pinned)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    degrader(x)
    torch.cuda.synchronize()
    deg_peak = torch.cuda.max_memory_allocated() - base

    def behind_a_sleep(fn, rounds=5, n=2):
        """(device ms a call, host ms a call, the longest host time of a round
        over its sleep's ms)"""
        device, host, ratio = [], [], []
        for _ in range(rounds):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            marks[0].record()
            torch.cuda._sleep(4 * 10**8)
            marks[1].record()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            host.append((time.perf_counter() - t0) * 1e3)
            marks[2].record()
            torch.cuda.synchronize()
            device.append(marks[1].elapsed_time(marks[2]))
            ratio.append(host[-1] / marks[0].elapsed_time(marks[1]))
        assert max(ratio) < 0.5, f"the host waited for the device: {max(ratio):.2f} of the sleep"
        return sum(device) / (rounds * n), sum(host) / (rounds * n), max(ratio)

    deg_ms, enqueue_ms, deg_ratio = behind_a_sleep(lambda: degrader(x))
    dispatch_ms, dispatch_host_ms, dispatch_ratio = behind_a_sleep(lambda: loader._dispatch(pinned))
    print(f"timings: degrade of one 512x512 batch: {deg_ms:.3f} ms on the device (10 calls over their drawn "
          f"plans, two at a time enqueued while the device slept), host {enqueue_ms:.3f} ms a call (kernels, plan, "
          f"enqueue; at most {deg_ratio:.3f} of the sleep); the loader's dispatch of a pinned batch "
          f"{dispatch_ms:.3f} ms on the device, host {dispatch_host_ms:.3f} ms (at most {dispatch_ratio:.3f} of the "
          f"sleep); peak memory {deg_peak / 2**20:.1f} MiB above its input [{card}]", flush=True)

    # train_omgsr_s.main from a YAML config: the checkpoint directory, the ConvNeXt-L .pth, the folder
    import yaml

    out_dir = os.path.join(work_dir, "data_train")
    cfg_path = os.path.join(work_dir, "train_from_disk.yml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "sd_path": ckpt["sd_path"], "dinov3_weights_path": ckpt["dinov3_weights_path"], "fixed_prompt": "",
            "dataset_txt_or_dir_paths": sources, "output_dir": out_dir, "resolution": 512, "train_batch_size": 1,
            "gradient_accumulation_steps": DATA_ACCUM, "max_train_steps": DATA_TRAIN_STEPS, "mixed_precision": "bf16",
            "vae_lora_rank": 16, "unet_lora_rank": 32, "lr_warmup_steps": 0, "checkpointing_steps": 1000,
            "save_img_steps": 1000, "seed": 123, "metrics_jsonl": os.path.join(out_dir, "metrics.jsonl")}, f)
    micro = DATA_TRAIN_STEPS * DATA_ACCUM
    expect = micro_step_counts(SD21_VAE, SD21_UNET)
    reset_counts()
    t0 = time.perf_counter()
    # what the CLI runs under: PyTorch's default cudnn.allow_tf32 (the script turned it off for its checks)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), timed_loader() as waits, \
            launch_shapes() as seen_train:
        train_cli.main(["--config", cfg_path])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    lines = [json.loads(l) for l in open(os.path.join(out_dir, "metrics.jsonl"))]
    assert [l["step"] for l in lines] == list(range(1, DATA_TRAIN_STEPS + 1)), lines
    for l in lines:
        print(f"data: train from disk, optimizer step {l['step']}: " + " ".join(f"{k}={l[k]:.4f}" for k in METRICS),
              flush=True)
        assert all(math.isfinite(l[k]) for k in METRICS), l
    assert sorted(os.listdir(os.path.join(out_dir, f"weight-{DATA_TRAIN_STEPS}"))) == [
        "unet_lora_adapter", "vae_encoder_lora_adapter"]
    assert latest_checkpoint(out_dir).endswith(f"checkpoint-{DATA_TRAIN_STEPS}.pt")
    print(f"data: train_omgsr_s.main --config took {DATA_TRAIN_STEPS} optimizer steps ({micro} micro-steps) from "
          f"disk in {train_s:.2f} s with the checkpoint's load; launches {train_counts}; {micro} x the structure's "
          f"{expect}", flush=True)
    for name, n_one in expect.items():
        assert train_counts[name] == micro * n_one, (name, train_counts[name], micro * n_one)
    assert len(waits["wait"]) == micro, waits
    # the last accumulation window, between the two optimizer steps' metric lines (each written after a sync)
    window = lines[-1]["time"] - lines[-2]["time"]
    s_per_micro = window / DATA_ACCUM
    wait = sum(waits["wait"][-DATA_ACCUM:])
    mem = [json.loads(l) for l in open(train_metrics)]
    s_per_micro_mem = (mem[-1]["time"] - mem[-2]["time"]) / DATA_ACCUM
    print(f"timings: training micro-step from disk {s_per_micro:.4f} s (the last accumulation window over "
          f"{DATA_ACCUM}), of it waiting for the loader {wait / DATA_ACCUM * 1e3:.2f} ms a micro-step, share "
          f"{wait / window:.4f}; each micro-step's wait, ms: {', '.join(f'{w * 1e3:.2f}' for w in waits['wait'])}; "
          f"the train phase's in-memory pairs, the same window: {s_per_micro_mem:.4f} s [{card}]", flush=True)

    # mid_timestep_sd.main on the same folder (f32 VAE, as the JAX CLI), in the work directory (its plot)
    argv = ["--dataset_txt_or_dir_paths", *sources, "--sd_path", ckpt["sd_path"], "--max_samples",
            str(DATA_CALIB_SAMPLES)]
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), timed_loader() as batches, \
            launch_shapes() as seen_calib, contextlib.chdir(work_dir), contextlib.redirect_stdout(log):
        t_best, avg = calib_cli.main(argv)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_counts = read_counts()
    encodes = 2 * DATA_CALIB_SAMPLES
    per_encode = structure_counts(SD21_VAE, SD21_UNET)["encode"]  # f32: K1's kv loop is not split
    print(f"data: mid_timestep_sd.main on {DATA_CALIB_SAMPLES} samples in {calib_s:.2f} s with the VAE's load: "
          + log.getvalue().strip().replace("\n", "; ") + f"; launches {calib_counts}; {encodes} encodes x "
          f"{per_encode}", flush=True)
    assert 0 <= t_best <= 999 and avg.shape == (1000,) and np.isfinite(avg).all(), (t_best, avg)
    for name, n_one in per_encode.items():
        assert calib_counts[name] == encodes * n_one, (name, calib_counts[name], encodes * n_one)
    assert all(calib_counts[k] == 0 for k in calib_counts if k not in per_encode), calib_counts
    periods = np.diff(batches["at"])
    print(f"timings: calibration {statistics.median(periods):.4f} s a batch (median of {len(periods)}, two f32 "
          f"encodes and the sweep) [{card}]", flush=True)

    # every shape at which the two CLIs launched K1 and K3a/K3b, held against the plain versions
    report_launch_shapes("data", "the CLIs", merge_seen(seen_train, seen_calib), 7000)
    counts = {k: train_counts[k] + calib_counts[k] for k in train_counts}
    return counts, {"data_degrade_ms": deg_ms, "data_degrade_host_ms": enqueue_ms,
                    "data_dispatch_ms": dispatch_ms, "data_dispatch_host_ms": dispatch_host_ms,
                    "data_degrade_peak_MiB": deg_peak / 2**20,
                    "data_host_decode_crop_ms": statistics.mean(host_ms.values()),
                    "data_train_micro_step_s": s_per_micro, "data_train_loader_wait_ms": wait / DATA_ACCUM * 1e3,
                    "data_train_loader_wait_share": wait / window, "train_in_memory_micro_step_s": s_per_micro_mem,
                    "data_calibration_s_per_batch": statistics.median(periods), "data_decoder": decoder}


# ----------------------------------------------------------------------------
# phase: serve-f
# ----------------------------------------------------------------------------

FLUX_TXT_TOKENS = 512  # FLUX.1-dev's T5 prompt length
# the DiT stage timed at one tile a forward (the JAX package's rule from 4096 tokens a tile, measured on
# a TPU v5e) and at a larger batch in turns, on latents (H, W) in 128-tiles of 4608 tokens:
# 9 tiles (the 2048-px request) at 3 and 16 tiles at 8, the default's batches (pipeline_f.flux_tile_batch);
# 13 tiles at 7, tiled.auto_tile_batch's batch with one padded tile, where the default takes one
F_TILE_TURNS = {(256, 256): 3, (320, 320): 8, (128, 896): 7}
# one FLUX block at full width on the kernels against the same block with the flash attention on its
# plain version, identical bf16 inputs, ||kernel - plain|| / ||plain||: of the attention's output
# (captured inside the block; the two differ by bf16 roundings, a wrong attention reads about 1) and of
# the block's output (the residual sum dilutes the attention's share: the reading with the attention
# zeroed is printed beside it)
MAX_ATTN_REL_L2 = 0.01
MAX_BLOCK_REL_L2 = 0.01


def init_flux_dev(dtype):
    """FLUX.1-dev's DiT at full width and depth and the FLUX VAE, from seeds."""
    t0 = time.perf_counter()
    flux_params = init_flux(8, FLUX_DEV, dtype, "cuda")
    vae_params = init_vae(9, FLUX_VAE, dtype, "cuda")
    torch.cuda.synchronize()
    n_dit, n_vae = count_params(flux_params), count_params(vae_params)
    print(f"serve-f: FLUX.1-dev DiT {n_dit / 1e9:.3f}B parameters ({FLUX_DEV.num_layers} dual + "
          f"{FLUX_DEV.num_single_layers} single blocks, inner width {FLUX_DEV.inner_dim}, "
          f"{FLUX_DEV.num_attention_heads} heads of {FLUX_DEV.attention_head_dim}) + FLUX VAE {n_vae / 1e6:.1f}M, "
          f"bf16 ({(n_dit + n_vae) * 2 / 1e9:.2f} GB), from seeds, in {time.perf_counter() - t0:.1f} s", flush=True)
    assert n_dit == 11_901_408_320, n_dit
    return vae_params, flux_params


def flux_prompt(seed):
    """A synthetic prompt at FLUX.1-dev's shapes: T5 embeddings (1, 512, 4096),
    the pooled CLIP embedding (1, 768)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, FLUX_TXT_TOKENS, FLUX_DEV.joint_attention_dim)).astype(np.float32),
            rng.standard_normal((1, FLUX_DEV.pooled_projection_dim)).astype(np.float32))


@contextlib.contextmanager
def captured_attention(zero=False):
    """Inside, every attention output of models.flux is appended, in f32, to
    the list this yields; with ``zero`` the blocks get zeros in its place."""
    outs, inner = [], FLUXM.dot_product_attention

    def capture(*args, **kwargs):
        o = inner(*args, **kwargs)
        outs.append(o.float())
        return torch.zeros_like(o) if zero else o

    FLUXM.dot_product_attention = capture
    try:
        yield outs
    finally:
        FLUXM.dot_product_attention = inner


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def hold_flux_blocks(flux_params, card):
    """Dual block 0 and single block 0 at full width over 4608 tokens (a
    128x128-latent tile and 512 text tokens) on the kernels against the same
    block on the plain flash attention, at the attention's output and the
    block's; each block's device ms."""
    dtype, cfg = torch.bfloat16, FLUX_DEV
    g = torch.Generator(device="cuda").manual_seed(13)
    img = torch.randn((1, 4096, cfg.inner_dim), generator=g, device="cuda").to(dtype)
    txt = torch.randn((1, FLUX_TXT_TOKENS, cfg.inner_dim), generator=g, device="cuda").to(dtype)
    temb = torch.randn((1, cfg.inner_dim), generator=g, device="cuda").to(dtype)
    ids = torch.cat([torch.zeros((FLUX_TXT_TOKENS, 3), device="cuda"), latent_image_ids(64, 64, device="cuda")])
    cos, sin = FLUXM.rope_cos_sin(ids, cfg.axes_dims_rope, cfg.rope_theta)
    dual, single = flux_params["transformer_blocks"]["0"], flux_params["single_transformer_blocks"]["0"]
    blocks = {"dual": lambda: torch.cat(FLUXM._dual_block(dual, cfg, img, txt, temb, cos, sin)[::-1], dim=1),
              "single": lambda: FLUXM._single_block(single, cfg, torch.cat([txt, img], dim=1), temb, cos, sin)}
    out = {}
    with torch.inference_mode():
        for name, fn in blocks.items():
            with captured_attention() as attn:
                a = fn().float()
            a2 = fn().float()
            with route_kernels_to_plain(), captured_attention() as attn_plain:
                b = fn().float()
            with route_kernels_to_plain(), captured_attention(zero=True):
                b0 = fn().float()
            assert len(attn) == len(attn_plain) == 1, (len(attn), len(attn_plain))
            rel_attn, rel, rel0 = rel_l2(attn[0], attn_plain[0]), rel_l2(a, b), rel_l2(b0, b)
            ms = time_ms(fn, iters=10, warmup=2)
            print(f"serve-f: {name} block 0 at full width, 4608 tokens, kernels vs the plain flash attention: rel "
                  f"L2 of the attention's output {rel_attn:.3g} (bound {MAX_ATTN_REL_L2}), of the block's "
                  f"{rel:.3g} (bound {MAX_BLOCK_REL_L2}; {rel0:.3g} with the attention zeroed); twice with the "
                  f"kernels: {'the same bits' if torch.equal(a, a2) else 'rel L2 %.3g' % rel_l2(a2, a)}"
                  f"; {ms:.3f} ms on the device [{card}]", flush=True)
            assert torch.isfinite(a).all() and rel_attn <= MAX_ATTN_REL_L2 and rel <= MAX_BLOCK_REL_L2, (
                name, rel_attn, rel)
            out[f"f_{name}_block_ms"] = ms
    return out


def phase_serve_f(card, vae_params, flux_params, profile=False):
    """OMGSR-F one-step serving at FLUX.1-dev's full width and depth: an
    SRServer built by cli.serve.build_server --pipeline f answers three
    1024x1024 requests (one tile each) and one 2048x2048 request (nine tiles);
    then the stages, and the DiT stage at the tile batches of F_TILE_TURNS."""
    dtype = torch.bfloat16
    prompt, pooled = flux_prompt(12)
    args = serve_cli.parse_args(["--pipeline", "f", "--weight_dtype", "bf16", "--latent", "mean", "--port", "0"])
    assert (args.process_size, args.mid_timestep) == (1024, 244)
    server = serve_cli.build_server(args, params=(vae_params, flux_params), prompt_embeds=(prompt, pooled))
    tile, overlap = args.process_size // 8, args.process_size // 16
    ds = FLUX_VAE.downscale
    rng = np.random.default_rng(13)
    up4 = np.ones((4, 4, 1), np.uint8)
    imgs1024 = [np.kron(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8), up4) for _ in range(3)]
    img2048 = np.kron(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8), up4)  # 256 / 512 px inputs, x4
    jobs = [(imgs1024[0], "nofix"), (imgs1024[1], "adain"), (imgs1024[2], "wavelet"), (img2048, "adain")]
    per = flux_structure_counts(FLUX_VAE, FLUX_DEV)
    n_blocks = per["dit"]["flash_attention_fwd"]
    assert n_blocks == 57
    heads, dh = FLUX_DEV.num_attention_heads, FLUX_DEV.attention_head_dim
    tile_key = {b: ((b, 4608, heads, dh), 4608, dtype) for b in (1, 3)}  # 64 x 64 tokens + 512 text
    timings = {}
    try:
        sizes = [img.shape[:2] for img, _ in jobs]
        expect = expected_launches(sizes, per, tile, overlap, ds)
        assert [latent_tiles(h, w, tile, overlap, ds) for h, w in sizes] == [1, 1, 1, 9]
        assert denoiser_calls(2048, 2048, tile, overlap, ds) == 3
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with launch_shapes() as seen:
            outs = run_clients(server, jobs)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        tokens = mid_head_tokens(seen)
        expect["flash_attention_fwd_merge"] = sum(n * mid_head_merges(t) for t, n in tokens.items())
        counts = {k: v for k, v in read_counts().items() if k in expect}
        at_tile = {b: seen["flash_n"].get(key, 0) for b, key in tile_key.items()}
        print(f"serve-f: 4 requests (three 1024x1024, one 2048x2048) answered in {wall:.2f} s; launches {counts}; "
              f"structure predicts {expect}; K1 at q(1,4608,24,128) {at_tile[1]} launches (three one-tile "
              f"forwards), at q(3,4608,24,128) {at_tile[3]} (the nine tiles in three forwards), {n_blocks} per "
              f"forward; VAE mid heads by tokens {dict(sorted(tokens.items()))}; peak memory allocated "
              f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
        assert counts == expect and counts["flash_attention_fwd"] > 0 and counts["group_norm_stats"] > 0, counts
        assert at_tile == {1: 3 * n_blocks, 3: 3 * n_blocks}, seen["flash_n"]
        assert tokens == {128 * 128: 3 * 2, 256 * 256: 2}, tokens
        for (img, _), out in zip(jobs, outs):
            # process_array raises on non-finite values before it quantises
            assert out.shape == img.shape and out.dtype == np.uint8 and out.std() > 1.0, (out.shape, out.std())
        assert np.abs(outs[0].astype(int) - outs[1].astype(int)).mean() > 1.0, "distinct inputs, one output"
        m = server.metrics()
        assert m["requests"] == 4 and m["errors"] == 0, m
        timings["f_peak_memory_GiB"] = peak / 2**30

        # the same 1024-px request with every kernel wrapper routed to its plain version
        again = server.process_array(imgs1024[0], "nofix")
        with route_kernels_to_plain():
            plain = server.process_array(imgs1024[0], "nofix")
        mean, mx, share = mean_steps(again, plain)
        print(f"serve-f: kernels vs plain versions on one 1024x1024 request (uint8 steps): mean {mean:.4f}, max "
              f"{mx}, share within 16 steps {share:.4f} (bounds: mean {MAX_MEAN_STEPS}, share 0.95); the same "
              f"request twice with kernels: max {np.abs(again.astype(int) - outs[0].astype(int)).max()}", flush=True)
        assert mean <= MAX_MEAN_STEPS and share >= 0.95, (mean, share)

        # request latency at 1024 px
        lat = []
        for i in range(6):
            t0 = time.perf_counter()
            server.process_array(imgs1024[i % 3], "adain")
            lat.append((time.perf_counter() - t0) * 1e3)
        timings["f_latency_ms_p50_1024"] = statistics.median(lat[1:])
        print(f"timings: -F 1024x1024 request latency p50 {timings['f_latency_ms_p50_1024']:.2f} ms over "
              f"{len(lat) - 1} requests (first excluded: {lat[0]:.2f} ms) [{card}]", flush=True)
        lat = []
        for _ in range(3):
            t0 = time.perf_counter()
            server.process_array(img2048, "adain")
            lat.append((time.perf_counter() - t0) * 1e3)
        timings["f_latency_ms_2048"] = statistics.mean(lat)
        print(f"timings: -F 2048x2048 request latency mean {timings['f_latency_ms_2048']:.1f} ms over 3 requests "
              f"({', '.join(f'{x:.1f}' for x in lat)}) [{card}]", flush=True)
    finally:
        server.shutdown()
    n_seen = report_launch_shapes("serve-f", "the requests", seen, 10000)
    assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen

    timings.update(hold_flux_blocks(flux_params, card))

    # the stages at 1024 px, finite at each, on the device and on the host's clock
    pipe = OMGSRFPipeline(vae_params, flux_params, FLUX_VAE, FLUX_DEV, 244, device="cuda")
    lq = torch.from_numpy(imgs1024[0].astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
    ctx, pl = (torch.from_numpy(a).to("cuda", dtype) for a in (prompt, pooled))
    with torch.inference_mode():
        z = pipe.encode(lq, sample_latent=False)
        z0 = pipe.latent_mid(z, ctx, pl, tile, overlap)
        img = pipe.decode(z0)
        for name, v in (("latent", z), ("x0 latent", z0), ("image", img)):
            assert torch.isfinite(v.float()).all(), name
        assert z.shape == (1, 128, 128, 16) and img.shape == (1, 1024, 1024, 3)
        staged = {"vae_encode": lambda: pipe.encode(lq, sample_latent=False),
                  "dit": lambda: pipe.latent_mid(z, ctx, pl, tile, overlap),
                  "vae_decode": lambda: pipe.decode(z0)}
        stages = {name: time_ms(fn, iters=5, warmup=1) for name, fn in staged.items()}
        enqueue = {}
        for name, fn in staged.items():
            samples = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            enqueue[name] = statistics.median(samples)
        for name, ms in stages.items():
            timings[f"f_{name}_1024_ms"] = ms
            timings[f"f_{name}_1024_host_enqueue_ms"] = enqueue[name]
            print(f"timings: -F 1024x1024 {name} {ms:.2f} ms on the device, host enqueue {enqueue[name]:.2f} ms "
                  f"[{card}]", flush=True)
        if profile:
            profile_stages(staged, stages, card, "-F 1024x1024")
        timings.update(dit_tile_batch_turns(pipe, ctx, pl, tile, overlap, card))
    return counts, timings


def dit_tile_batch_turns(pipe, ctx, pooled, tile, overlap, card):
    """The DiT stage's device ms on each latent of F_TILE_TURNS at one tile a
    forward and at its batch, in turns (1, b, b, 1), each warmed once."""
    out = {}
    g = torch.Generator(device="cuda").manual_seed(14)
    ds = FLUX_VAE.downscale
    for (h, w), tb in F_TILE_TURNS.items():
        n = latent_tiles(h * ds, w * ds, tile, overlap, ds)
        default = flux_tile_batch(n, (tile // 2) ** 2 + FLUX_TXT_TOKENS)
        z = torch.randn((1, h, w, FLUX_VAE.latent_channels), generator=g, device="cuda").to(ctx.dtype)
        for b in (1, tb):
            pipe.tile_batch = b
            assert torch.isfinite(pipe.latent_mid(z, ctx, pooled, tile, overlap).float()).all(), (h, w, b)
        ms = {1: [], tb: []}
        for b in (1, tb, tb, 1):
            pipe.tile_batch = b
            ms[b].append(time_ms(lambda: pipe.latent_mid(z, ctx, pooled, tile, overlap), iters=1, warmup=0))
        pipe.tile_batch = None
        for b, v in ms.items():
            out[f"f_dit_{n}_tiles_tile_batch_{b}_ms"] = statistics.mean(v)
        print(f"timings: -F DiT stage, {n} tiles of 4608 tokens (a {h}x{w} latent), on the device in turns "
              f"(1, {tb}, {tb}, 1): " + "; ".join(
                  f"tile batch {b} {statistics.mean(v):.1f} ms ({', '.join(f'{x:.1f}' for x in v)})"
                  for b, v in ms.items()) + f"; the default takes {default} [{card}]", flush=True)
    return out


# ----------------------------------------------------------------------------
# phase: load-f
# ----------------------------------------------------------------------------

# (W, H) of the -F CLI's inputs: three 1024x1024 outputs and one 1224x1024 (the min-side guard takes
# 200 px to 1024; the 64 px size bucket pads to 1280x1024, a 128x160 latent in two 128-tiles, one forward)
F_LOAD_INPUTS = [(256, 256)] * 3 + [(240, 200)]
# the DiT written at full width and 2 dual + 2 single blocks (the full 23.8 GB is not written); the T5
# encoder at full width and 2 of its 24 layers
F_LOAD_DEPTH = (2, 2)
F_LOAD_T5_LAYERS = 2
F_LORA_RANK = 64  # omgsr_tpu/configs/omgsr_f_1024.yml: vae_lora_rank, flux_transformer_lora_rank
# the prompt the -F CLIs encode with the written T5 and CLIP-L; and a prompt past T5's 512 tokens
F_PROMPT = "a high resolution photo of a red fox in the snow, ｓｈａｒｐ　details"
F_LONG_PROMPT = " ".join(["a detailed photo of a mountain lake at dawn with mist over the water"] * 60)


def t5_xxl_encode_ms(t5_tok, card):
    """FLUX.1-dev's T5-XXL at full width and depth (4.76B, bf16) from a seed
    on the card: the empty prompt and one past 512 tokens, each tokenized on
    the host and encoded; device ms of an encode. The encoder is freed."""
    dtype = torch.bfloat16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t5 = init_t5_encoder(19, FLUX_T5_XXL, dtype, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = count_params(t5)
    assert n == 4_762_310_656, n
    out = {}
    for name, prompt in (("empty", ""), ("long", F_LONG_PROMPT)):
        t0 = time.perf_counter()
        ids = t5_tok(prompt, max_length=512).to("cuda")
        tok_ms = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            emb = t5_encode(t5, FLUX_T5_XXL, ids)
            ms = time_ms(lambda: t5_encode(t5, FLUX_T5_XXL, ids), iters=5, warmup=1)
        assert emb.shape == (1, 512, FLUX_T5_XXL.d_model) and torch.isfinite(emb.float()).all(), name
        n_tokens = int((ids != t5_tok.pad_token_id).sum())
        out[f"t5_xxl_encode_{name}_ms"], out[f"t5_xxl_tokenize_{name}_ms"] = ms, tok_ms
        print(f"load-f: T5-XXL ({n / 1e9:.3f}B parameters, {FLUX_T5_XXL.num_layers} layers, bf16, "
              f"{n * 2 / 1e9:.2f} GB, from a seed in {init_s:.3f} s) encodes the {name} prompt ({n_tokens} tokens "
              f"before the padding to 512; tokenized on the host in {tok_ms:.2f} ms) in {ms:.3f} ms on the device "
              f"[{card}]", flush=True)
    del t5, emb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cut_flux_lora(lora, cfg):
    """The DiT LoRA tree of the first cfg.num_layers dual and
    cfg.num_single_layers single blocks (and x_embedder's)."""
    out = dict(lora)
    for group, n in (("transformer_blocks", cfg.num_layers), ("single_transformer_blocks", cfg.num_single_layers)):
        out[group] = {str(i): lora[group][str(i)] for i in range(n)}
    return out


def phase_load_f(card, vae_params, flux_params, work_dir, export):
    """OMGSR-F from a checkpoint directory on disk: a FLUX.1-dev-layout
    directory (the DiT at full width and reduced depth, the serve-f VAE,
    CLIP-L at full width, T5 at full width and reduced depth, both synthetic
    tokenizers at the published sizes) written by tools/flux_checkpoint.py,
    ported back; the full T5-XXL timed in memory; encode_prompt_flux on the
    directory against the in-memory encoders; then, with the adapters the
    train-f phase exported (cut to the written depth), cli.infer_omgsr_f.main
    --prompt, cli.serve --pipeline f --flux_path, cli.mid_timestep_flux.main
    and cli.train_omgsr_f.main --config on it."""
    from PIL import Image

    dtype = torch.bfloat16
    root = os.path.join(work_dir, "flux1-dev")
    cfg = dataclasses.replace(FLUX_DEV, num_layers=F_LOAD_DEPTH[0], num_single_layers=F_LOAD_DEPTH[1])
    dit = {**flux_params,
           "transformer_blocks": {str(i): flux_params["transformer_blocks"][str(i)] for i in range(cfg.num_layers)},
           "single_transformer_blocks": {str(i): flux_params["single_transformer_blocks"][str(i)]
                                         for i in range(cfg.num_single_layers)}}
    t0 = time.perf_counter()
    (vocab, merges), (pieces, charsmap) = tokenizers = synthetic_text_tokenizers(seed=20)
    clip_tok = CLIPTokenizer(vocab, merges, pad_token="<|endoftext|>")
    t5_tok = T5Tokenizer(t5_tokenizer_json(pieces, charsmap))
    print(f"load-f: synthetic vocabularies: CLIP-L {len(vocab):,} entries ({len(merges):,} merges), T5 "
          f"{len(pieces):,} Unigram pieces + 100 extra ids, charsmap {len(charsmap):,} bytes, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    assert len(vocab) == 49_408 and len(pieces) == 32_000
    timings = t5_xxl_encode_ms(t5_tok, card)
    t5_cfg = dataclasses.replace(FLUX_T5_XXL, num_layers=F_LOAD_T5_LAYERS)
    t5 = init_t5_encoder(21, t5_cfg, dtype, "cuda")
    clip = init_clip_text(22, FLUX_CLIP_L, torch.float32, "cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = write_flux_checkpoint(root, vae_params, FLUX_VAE, dit, cfg, dtype, transformer_shards=2,
                                    clip=clip, clip_cfg=FLUX_CLIP_L, t5=t5, t5_cfg=t5_cfg, tokenizers=tokenizers)
    write_s = time.perf_counter() - t0
    files = sorted(os.listdir(os.path.join(root, "transformer")))
    assert files == ["config.json", "diffusion_pytorch_model-00001-of-00002.safetensors",
                     "diffusion_pytorch_model-00002-of-00002.safetensors",
                     "diffusion_pytorch_model.safetensors.index.json"], files
    assert sorted(os.listdir(os.path.join(root, "text_encoder_2"))) == [
        "config.json", "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors",
        "model.safetensors.index.json"]
    # the adapters the train-f phase exported, cut to the written depth
    lora = {"flux": cut_flux_lora(load_adapter(os.path.join(export, "flux_adapter"))[0], cfg),
            "vae": load_adapter(os.path.join(export, "vae_encoder_adapter"))[0]}
    lora_dir = os.path.join(root, "lora")
    save_adapter(lora["flux"], os.path.join(lora_dir, "flux_adapter"), rank=F_LORA_RANK, targets=FLUX_TARGET_MODULES)
    shutil.copytree(os.path.join(export, "vae_encoder_adapter"), os.path.join(lora_dir, "vae_encoder_adapter"))
    assert any(v.abs().max() > 0 for p, v in flatten_dict(lora["flux"]).items() if p[-1] == "lora_B")
    print(f"load-f: FLUX.1-dev-layout checkpoint written in {write_s:.2f} s (DiT {count_params(dit) / 1e9:.3f}B "
          f"at full width, {cfg.num_layers} dual + {cfg.num_single_layers} single blocks, bf16; CLIP-L "
          f"{count_params(clip) / 1e6:.1f}M f32; T5 {count_params(t5) / 1e6:.1f}M at full width, {t5_cfg.num_layers} of "
          f"{FLUX_T5_XXL.num_layers} layers, bf16): "
          + ", ".join(f"{k} {b / 1e9:.3f} GB in {t:.2f} s" for k, (t, b) in written.items())
          + f"; the train-f phase's rank-{F_LORA_RANK} adapters cut to the written depth "
          f"{sum(v.numel() for v in flatten_dict(lora).values()) / 1e6:.1f}M [{card}]", flush=True)
    assert flux_config_from_json(os.path.join(root, "transformer")) == cfg
    assert vae_config_from_json(os.path.join(root, "vae")) == FLUX_VAE

    dit_p, dit_s = ported_component("transformer (index + 2 shards)", porters.port_flux_transformer,
                                    os.path.join(root, "transformer"), written["transformer"], cfg=cfg, dtype=dtype)
    vae_p, vae_s = ported_component("vae", porters.port_diffusers_vae, os.path.join(root, "vae"), written["vae"],
                                    cfg=FLUX_VAE, dtype=dtype)
    t5_p, t5_s = ported_component("text_encoder_2 (index + 2 shards)", porters.port_t5_encoder,
                                  os.path.join(root, "text_encoder_2"), written["text_encoder_2"], cfg=t5_cfg)
    assert same_tree(dit, dit_p, dtype) and same_tree(vae_params, vae_p, dtype) and same_tree(t5, t5_p)
    del dit_p, vae_p, t5_p

    # the prompt through the directory's encoders, against the in-memory ones on the same ids
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embeds, pooled_e, txt_ids = encode_prompt_flux(root, F_PROMPT, dtype=dtype)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    with torch.no_grad():
        ref = t5_encode(t5, t5_cfg, t5_tok(F_PROMPT, max_length=512).to("cuda")).to(dtype)
        _, ref_pooled = clip_text_apply(clip, FLUX_CLIP_L, clip_tok(F_PROMPT).to("cuda"))
    assert embeds.shape == (1, 512, 4096) and pooled_e.shape == (1, 768) and txt_ids.shape == (512, 3)
    d_emb = (embeds.float() - ref.float()).abs().max().item()
    d_pool = (pooled_e.float() - ref_pooled.to(dtype).float()).abs().max().item()
    print(f"load-f: encode_prompt_flux on the directory (tokenizers, CLIP-L and T5 read from disk, both encoded) in "
          f"{encode_s:.2f} s; against the in-memory encoders on the same ids: max |difference| {d_emb:.3g} "
          f"(T5, bf16), {d_pool:.3g} (pooled CLIP-L) [{card}]", flush=True)
    assert d_emb <= 2.0**-7 * ref.float().abs().max().item() and d_pool <= 2.0**-7 * ref_pooled.abs().max().item()
    np.savez(os.path.join(root, "prompt.npz"), prompt_embeds=embeds.float().cpu().numpy(),
             pooled_prompt_embeds=pooled_e.float().cpu().numpy())
    timings.update({"f_encode_prompt_from_disk_s": encode_s, "f_load_port_t5_s": t5_s})
    del t5, clip

    # the inference CLI in-process
    rng = np.random.default_rng(16)
    img_dir, out_dir = os.path.join(work_dir, "load_f_inputs"), os.path.join(work_dir, "load_f_outputs")
    os.makedirs(img_dir)
    names = []
    for i, (w, h) in enumerate(F_LOAD_INPUTS):
        names.append(os.path.join(img_dir, f"img{i}.png"))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(names[-1])
    prepared = [preprocess_sr_input(load_image_rgb(n), 1024, 4, 64) for n in names]
    sizes = [item[0].shape[1:3] for item in prepared]
    assert sizes[-1] == (1024, 1280) and prepared[-1][4] == (1024, 1224), (sizes, prepared[-1][4])
    tile, overlap = 1024 // 8, 1024 // 16
    ds = FLUX_VAE.downscale
    assert [latent_tiles(h, w, tile, overlap, ds) for h, w in sizes] == [1, 1, 1, 2]
    expect = expected_launches(sizes, flux_structure_counts(FLUX_VAE, cfg), tile, overlap, ds)
    args = infer_f_cli.parse_args(["--input_image", img_dir, "--output_dir", out_dir, "--flux_path", root,
                                   "--lora_path", lora_dir, "--prompt", *F_PROMPT.split(" "), "--weight_dtype", "bf16"])
    log = io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_shapes() as seen, contextlib.redirect_stdout(log):
        infer_f_cli.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    expect["flash_attention_fwd_merge"] = sum(n * mid_head_merges(t) for t, n in mid_head_tokens(seen).items())
    cli_counts = {k: v for k, v in read_counts().items() if k in expect}
    per_image = [float(v) for v in re.findall(r"Inference time per image: (\S+)s", log.getvalue())]
    assert len(per_image) == len(names), log.getvalue()
    print(f"load-f: infer_omgsr_f.main --prompt answered {len(names)} images "
          f"({', '.join(f'{w}x{h}' for w, h in F_LOAD_INPUTS)}) in {cli_s:.2f} s with the checkpoint's load; "
          f"launches {cli_counts}; the structure predicts {expect}", flush=True)
    assert cli_counts == expect and expect["flash_attention_fwd"] > 0, cli_counts

    # the in-memory pipeline on the same merged weights and embeddings, with the CLI's noise (seed = index)
    vae_m = {**vae_params, "encoder": merge_lora(vae_params["encoder"], lora["vae"])}
    pipe = OMGSRFPipeline(vae_m, merge_lora(dit, lora["flux"]), FLUX_VAE, cfg, 244, device="cuda")
    ctx, pl = embeds, pooled_e
    cli_out = []
    for i, (name, (lq, src01, resize_flag, orig, true_hw)) in enumerate(zip(names, prepared)):
        with torch.inference_mode():
            out = pipe(torch.from_numpy(lq).to("cuda", dtype), ctx, pl, tile, overlap,
                       generator=torch.Generator(device="cuda").manual_seed(i), sample_latent=True)
            ref = np.asarray(postprocess_sr_output(out, src01, true_hw, adain_color_fix, resize_flag, orig, 4))
        got = np.asarray(Image.open(os.path.join(out_dir, os.path.basename(name))))
        cli_out.append(got)
        d = np.abs(got.astype(int) - ref.astype(int))
        w, h = F_LOAD_INPUTS[i]
        assert got.shape == ref.shape == (4 * h, 4 * w, 3) and got.std() > 1.0, (got.shape, ref.shape)
        assert d.max() <= 1, (name, d.max(), d.mean())
    print(f"load-f: the CLI's {len(names)} PNGs against the in-memory pipeline on the same merged weights and "
          f"the prompt's embeddings: within 1 uint8 step", flush=True)
    del pipe, vae_m

    # a server from --flux_path: its first request (index 1) draws the noise of the CLI's second image
    sargs = serve_cli.parse_args(["--pipeline", "f", "--flux_path", root, "--lora_path", lora_dir, "--prompt_npz",
                                  os.path.join(root, "prompt.npz"), "--weight_dtype", "bf16", "--port", "0"])
    t0 = time.perf_counter()
    server = serve_cli.build_server(sargs)
    build_s = time.perf_counter() - t0
    try:
        with open(names[1], "rb") as f:
            body = f.read()
        with launch_shapes() as seen_serve:
            reply = np.asarray(Image.open(io.BytesIO(server.process_image(body, "adain"))))
    finally:
        server.shutdown()
    d = np.abs(reply.astype(int) - cli_out[1].astype(int))
    print(f"load-f: serve --pipeline f --flux_path built in {build_s:.2f} s; one request against the CLI's image: "
          f"max {d.max()} uint8 steps", flush=True)
    assert reply.shape == cli_out[1].shape and d.max() <= 1, d.max()

    # mid_timestep_flux.main on the data phase's folder at 1024 px (f32 VAE, as the JAX CLI)
    sources = [os.path.join(work_dir, "data", "hq"), os.path.join(work_dir, "data", "listed.txt")]
    argv = ["--dataset_txt_or_dir_paths", *sources, "--flux_path", root, "--resolution", "1024",
            "--max_samples", str(DATA_CALIB_SAMPLES)]
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), timed_loader() as batches, \
            launch_shapes() as seen_calib, contextlib.chdir(work_dir), contextlib.redirect_stdout(log):
        t_best, avg = calib_f_cli.main(argv)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_counts = read_counts()
    encodes = 2 * DATA_CALIB_SAMPLES
    per_encode = vae_structure_counts(FLUX_VAE)["encode"]  # f32: K1's kv loop is not split
    print(f"load-f: mid_timestep_flux.main on {DATA_CALIB_SAMPLES} samples at 1024 px in {calib_s:.2f} s with the "
          f"VAE's load: " + log.getvalue().strip().replace("\n", "; ") + f"; launches {calib_counts}; {encodes} "
          f"encodes x {per_encode}", flush=True)
    assert 0 <= t_best <= 999 and avg.shape == (1000,) and np.isfinite(avg).all(), (t_best, avg)
    for name, n_one in per_encode.items():
        assert calib_counts[name] == encodes * n_one, (name, calib_counts[name], encodes * n_one)
    periods = np.diff(batches["at"])
    peak = torch.cuda.max_memory_allocated()

    # train_omgsr_f.main --config: the package's omgsr_f_1024.yml, the directory (its text encoders encode the
    # fixed prompt ""), the data phase's folder, 2 optimizer steps at accumulation 2
    out_dir = os.path.join(work_dir, "load_f_train")
    argv = ["--config", train_f_cli.DEFAULT_CONFIG, f"flux_path={root}",
            f"dataset_txt_or_dir_paths=[{sources[0]}, {sources[1]}]", f"output_dir={out_dir}", "max_train_steps=2",
            "gradient_accumulation_steps=2", "checkpointing_steps=1000", "save_img_steps=1000",
            f"metrics_jsonl={out_dir}/metrics.jsonl"]
    expect = f_micro_step_counts(FLUX_VAE, cfg, F_TRAIN_RES)
    reset_counts()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True), timed_loader() as waits, \
            launch_shapes() as seen_train:
        trainer = train_f_cli.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_counts = read_counts()
    lines = [json.loads(l) for l in open(os.path.join(out_dir, "metrics.jsonl"))]
    assert [l["step"] for l in lines] == [1, 2], lines
    for l in lines:
        print(f"load-f: train_omgsr_f.main from disk, optimizer step {l['step']}: "
              + " ".join(f"{k}={l[k]:.4f}" for k in METRICS), flush=True)
        assert all(math.isfinite(l[k]) for k in METRICS), l
    assert trainer.cfg.resolution == F_TRAIN_RES and trainer.cfg.gradient_checkpointing
    assert trainer.frozen["prompt_embeds"].shape == (1, 512, 4096) and trainer.frozen["flux_cfg"] == cfg
    assert sorted(os.listdir(os.path.join(out_dir, "weight-2"))) == ["flux_adapter", "vae_encoder_adapter"]
    assert len(waits["wait"]) == 4, waits
    s_train = statistics.median(np.diff(waits["at"]))
    del trainer
    print(f"load-f: train_omgsr_f.main --config (omgsr_f_1024.yml, fixed prompt \"\" through the directory's "
          f"encoders, {cfg.num_layers} + {cfg.num_single_layers} DiT blocks) took 2 optimizer steps (4 micro-steps) at "
          f"{F_TRAIN_RES} px from the data phase's folder in {train_s:.2f} s with the load; launches {train_counts}; "
          f"4 x the structure's {expect}; {s_train:.3f} s a micro-step [{card}]", flush=True)
    for name, n_one in expect.items():
        assert train_counts[name] == 4 * n_one, (name, train_counts[name], 4 * n_one)

    seen_all = merge_seen(merge_seen(merge_seen(seen, seen_serve), seen_calib), seen_train)
    n_seen = report_launch_shapes("load-f", "the CLIs", seen_all, 11000)
    assert n_seen["flash_attention_fwd"] and n_seen["flash_attention_bwd"] and n_seen["group_norm"], n_seen
    s_per_image = statistics.mean(per_image[1:])
    gbps = written["transformer"][1] / 1e9 / dit_s
    print(f"timings: load-f phase: checkpoint written in {write_s:.2f} s; ported transformer {dit_s:.3f} s "
          f"({gbps:.2f} GB/s), vae {vae_s:.3f} s; CLI {s_per_image:.4f} s per image (first image excluded: "
          f"{per_image[0]:.4f} s); serve --flux_path built in {build_s:.2f} s; calibration "
          f"{statistics.median(periods):.4f} s a batch (two f32 encodes at 1024 px); peak memory allocated "
          f"{peak / 2**30:.2f} GiB [{card}]", flush=True)
    counts = {k: cli_counts.get(k, 0) + calib_counts[k] + train_counts[k] for k in calib_counts}
    timings.update({"f_load_write_s": write_s, "f_load_port_transformer_s": dit_s,
                    "f_load_port_transformer_GBps": gbps, "f_load_port_vae_s": vae_s,
                    "f_load_cli_s_per_image": s_per_image, "f_load_serve_build_s": build_s,
                    "f_calibration_s_per_batch": statistics.median(periods), "f_load_peak_memory_GiB": peak / 2**30,
                    "f_load_train_main_s": train_s, "f_load_train_main_micro_step_s": s_train})
    return counts, timings


# ----------------------------------------------------------------------------
# phase: train-f
# ----------------------------------------------------------------------------

F_TRAIN_RES = 1024  # omgsr_tpu/configs/omgsr_f_1024.yml: resolution, ranks 64 / 64, gradient checkpointing


def f_micro_step_counts(vae_cfg, flux_cfg, size):
    """Kernel launches of one OMGSR-F training micro-step at size x size px
    under gradient checkpointing, read off the structure: the hq encode once
    (no grad); the LoRA encode and the decode forward, again in their
    recompute, and every resnet of theirs a third time in its own recompute;
    each DiT block forward and again in its recompute; one dQ and one dK/dV
    launch per attention under autograd (the mid heads of the LoRA encode and
    of the decode, one joint attention per block)."""
    per = flux_structure_counts(vae_cfg, flux_cfg)
    enc, dec, dit = per["encode"], per["decode"], per["dit"]
    k1 = "flash_attention_fwd"
    out = {name: 3 * enc[name] + 2 * dit[name] + 2 * dec[name] for name in enc}
    resnets = sum(len(c) for c in vae_resnet_channels(vae_cfg))
    out["group_norm_stats"] += 2 * resnets
    out["group_norm_apply"] += 2 * resnets
    out["flash_attention_fwd_merge"] = (3 * enc[k1] + 2 * dec[k1]) * mid_head_merges((size // vae_cfg.downscale) ** 2)
    out["flash_attention_bwd_dq"] = out["flash_attention_bwd_dkv"] = enc[k1] + dit[k1] + dec[k1]
    out["conv3x3"] = 0
    return out


def digest(tree):
    """Per leaf, the sum and the sum of squares of its 16-bit words as
    integers: any change of a bit changes them but for a vanishing chance (a
    copy of the 23.8 GB DiT does not fit beside the train step)."""
    out = {}
    for p, v in flatten_dict(tree).items():
        words = v.detach().reshape(-1).view(torch.int16).long()
        out[p] = (int(words.sum()), int((words * words).sum()))
    return out


def f_pair(seed, size=F_TRAIN_RES):
    r = np.random.default_rng(seed)
    hq = np.tanh(r.standard_normal((1, size, size, 3))).astype(np.float32)
    lq = np.clip(hq + 0.2 * r.standard_normal(hq.shape).astype(np.float32), -1, 1)
    return {"lq": lq, "hq": hq}


def phase_train_f(card, vae_params, flux_params, work_dir, profile=False):
    """OMGSR-F LoRA-GAN training at FLUX.1-dev's full width and depth (the
    serve-f DiT and VAE, the train phase's ConvNeXt-L from its seed, bf16,
    1024x1024, batch 1, ranks 64 / 64, gradient checkpointing):
    cli.train_omgsr_f.run_training takes 2 optimizer steps at gradient
    accumulation 2; metrics, launch counts (K2 at q(1,4608,24,128) 57 a
    micro-step), the accumulation boundary and the frozen weights are checked;
    one micro-step is repeated with the kernels routed to their plain
    versions, and one is timed stage by stage."""
    dtype = torch.bfloat16
    cn_cfg = CONVNEXT_SIZES["large"]
    backbone = init_convnext(2, cn_cfg, dtype, "cuda")  # the train phase's, from its seed
    prompt, pooled = flux_prompt(17)
    frozen = {"vae": vae_params, "vae_cfg": FLUX_VAE, "flux": flux_params, "flux_cfg": FLUX_DEV,
              "backbone": backbone, "dists": init_dists(backbone, cn_cfg.dims),
              "prompt_embeds": torch.from_numpy(prompt).to("cuda", dtype),
              "pooled_prompt_embeds": torch.from_numpy(pooled).to("cuda", dtype)}
    t0 = time.perf_counter()
    before = {k: digest(frozen[k]) for k in ("vae", "flux", "backbone")}
    digest_s = time.perf_counter() - t0
    loader = [f_pair(30 + i) for i in range(4)]
    out_dir = os.path.join(work_dir, "train_f")
    cfg = TrainConfig(
        model="omgsr_f_1024", output_dir=out_dir, resolution=F_TRAIN_RES, train_batch_size=1, vae_lora_rank=64,
        flux_transformer_lora_rank=64, mixed_precision="bf16", gradient_accumulation_steps=2, max_train_steps=2,
        gradient_checkpointing=True, mid_timestep=244, lr_warmup_steps=0, checkpointing_steps=1000,
        save_img_steps=1000, seed=123,
        extra={"disc_channels": list(cn_cfg.dims[:3]), "metrics_jsonl": f"{out_dir}/metrics.jsonl"},
    )
    expect = f_micro_step_counts(FLUX_VAE, FLUX_DEV, F_TRAIN_RES)
    assert (expect["flash_attention_fwd"], expect["flash_attention_bwd_dq"]) == (119, 59), expect
    joint = ((1, 4608, FLUX_DEV.num_attention_heads, FLUX_DEV.attention_head_dim), 4608, dtype)
    head = ((1, 128 * 128, 1, 512), 128 * 128, dtype)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with launch_shapes() as seen:
        trainer = train_f_cli.run_training(cfg, frozen=frozen, loader=loader, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    lines = [json.loads(l) for l in open(f"{out_dir}/metrics.jsonl")]
    export = os.path.join(out_dir, "weight-2")
    for name in ("vae_encoder_adapter", "flux_adapter"):
        assert sorted(os.listdir(os.path.join(export, name))) == ["adapter_config.json",
                                                                   "adapter_model.safetensors"], name
    n_dit_lora = sum(v.numel() for v in flatten_dict(trainer.state["gen"]["lora"]["denoiser"]).values())
    n_vae_lora = sum(v.numel() for v in flatten_dict(trainer.state["gen"]["lora"]["vae_encoder"]).values())
    n_heads = sum(v.numel() for v in flatten_dict(trainer.state["disc"]["params"]).values())
    print(f"train-f: run_training took 2 optimizer steps (4 micro-steps) at {F_TRAIN_RES}x{F_TRAIN_RES} in "
          f"{wall:.2f} s; trainable DiT LoRA {n_dit_lora:,} + VAE-encoder LoRA {n_vae_lora:,} + heads {n_heads:,}; "
          f"launches {counts}; one micro-step's structure predicts {expect}; K2 at "
          f"{ {k[0]: n for k, n in seen['bwd_n'].items()} }; peak memory allocated {peak / 2**30:.2f} GiB [{card}]",
          flush=True)
    # 7.08M a dual block x 19, 1.18M a single block x 38, 0.2M on x_embedder at rank 64
    assert n_dit_lora == 179_507_200, n_dit_lora
    assert trainer.state["step"] == 4 and trainer.state["gen"]["opt"]["count"] == 2
    assert [l["step"] for l in lines] == [1, 2], lines
    for l in lines:
        print(f"train-f: optimizer step {l['step']}: " + " ".join(f"{k}={l[k]:.4f}" for k in METRICS), flush=True)
        assert all(math.isfinite(l[k]) for k in METRICS), l
    for name, n in expect.items():
        assert counts[name] == 4 * n, (name, counts[name], 4 * n)
    assert seen["bwd_n"] == {joint: 4 * 57, head: 4 * 2}, seen["bwd_n"]
    # K1: each block forward and again in its recompute; the mid head in the hq encode, twice in the LoRA encode
    # and twice in the decode
    assert {k: seen["flash_n"][k] for k in (joint, head)} == {joint: 4 * 2 * 57, head: 4 * 5}, seen["flash_n"]
    n_seen = report_launch_shapes("train-f", "run_training", seen, 12000)
    assert n_seen["flash_attention_fwd"] and n_seen["flash_attention_bwd"] and n_seen["group_norm"], n_seen

    # the accumulation boundary: nothing moves on the first micro-step of a window
    gen = torch.Generator(device="cuda").manual_seed(18)
    batches = [{k: torch.from_numpy(v).to("cuda", dtype) for k, v in b.items()} for b in loader]
    latent_shape = (1, F_TRAIN_RES // 8, F_TRAIN_RES // 8, FLUX_VAE.latent_channels)

    def noise():
        return draw_step_noise(gen, (1, F_TRAIN_RES, F_TRAIN_RES, 3), latent_shape, "cuda", dtype)

    lora0, heads0 = snapshot(trainer.state["gen"]["lora"]), snapshot(trainer.state["disc"]["params"])
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
    assert pred.shape == (1, F_TRAIN_RES, F_TRAIN_RES, 3) and torch.isfinite(pred.float()).all()
    assert pred.float().std() > 1e-3
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
    for k in ("vae", "flux", "backbone"):
        assert digest(frozen[k]) == before[k], f"frozen {k} changed"
        assert all(v.grad is None and not v.requires_grad for v in flatten_dict(frozen[k]).values())
    print(f"train-f: micro-step launches {one}; the pred unclamped in [{pred.min().item():.3f}, "
          f"{pred.max().item():.3f}]; LoRA and heads unchanged after the first micro-step of a window and changed "
          f"after the second; u advanced; frozen VAE/DiT/ConvNeXt unchanged (word sums of every leaf, "
          f"{digest_s:.2f} s) and without gradient", flush=True)
    del pred

    # one micro-step with the kernels against the same one with their plain versions
    nz = noise()
    with_kernels = evaluate_micro_step(trainer, batches[2], nz)
    again = evaluate_micro_step(trainer, batches[2], nz)
    torch.cuda.reset_peak_memory_stats()
    with route_kernels_to_plain():
        plain = evaluate_micro_step(trainer, batches[2], nz)
    peak_plain = torch.cuda.max_memory_allocated()
    rel = {k: abs(with_kernels[k] - plain[k]) / max(abs(plain[k]), 1e-6) for k in METRICS}
    rerun = {k: abs(with_kernels[k] - again[k]) / max(abs(again[k]), 1e-6) for k in METRICS}
    print("train-f: kernels vs plain versions, one micro-step, relative difference: "
          + " ".join(f"{k}={rel[k]:.3g}" for k in METRICS)
          + f" (bounds: losses {MAX_LOSS_REL}, grad_norm_G {MAX_GRAD_NORM_REL}); the same micro-step twice "
          f"with kernels: max {max(rerun.values()):.3g}; peak memory of the plain micro-step (its backward holds "
          f"(24, 4608, 4608) f32 scores a call) {peak_plain / 2**30:.2f} GiB [{card}]", flush=True)
    for k in LOSSES:
        assert rel[k] <= MAX_LOSS_REL, (k, with_kernels[k], plain[k])
    assert rel["grad_norm_G"] <= MAX_GRAD_NORM_REL, (with_kernels["grad_norm_G"], plain["grad_norm_G"])

    # timings
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batches[(3 + i) % 4], noise())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    # two consecutive micro-steps: the first of an accumulation window, then the one that applies the update
    assert trainer.state["gen"]["opt"]["mini_step"] == 0
    timed = [timed_micro_step(trainer, batches[i], noise()) for i in range(2)]
    s_per = statistics.median(step_s[1:])
    print(f"timings: -F training micro-step {s_per:.4f} s (median of {len(step_s) - 1}, host clock to synchronize; "
          f"first after run_training {step_s[0]:.4f} s); peak memory allocated {peak / 2**30:.2f} GiB in "
          f"run_training, {peak_step / 2**30:.2f} GiB in one micro-step, {peak_plain / 2**30:.2f} GiB in the plain "
          f"one [{card}]", flush=True)
    for what, (stages, host_ms, enqueue_ms) in zip(("accumulating", "applying the update"), timed):
        g_ms = sum(v for k, v in stages.items() if k.startswith("G"))
        d_ms = sum(v for k, v in stages.items() if k.startswith("D"))
        print(f"timings: -F micro-step {what}, by stage, device ms (host enqueue ms): "
              + ", ".join(f"{k} {v:.2f} ({host_ms[k]:.2f})" for k, v in stages.items())
              + f"; G {g_ms:.2f} / D {d_ms:.2f}; host enqueue of the step {enqueue_ms:.2f} ms [{card}]",
              flush=True)
    if profile:
        profile_micro_step(trainer, batches[1], noise(), sum(timed[0][0].values()), card, "train-f")
    timings = {"train_f_micro_step_s": s_per, "train_f_G_ms": g_ms, "train_f_D_ms": d_ms,
               "train_f_host_enqueue_ms": enqueue_ms, "train_f_peak_memory_GiB": peak / 2**30,
               "train_f_micro_step_peak_memory_GiB": peak_step / 2**30,
               "train_f_plain_micro_step_peak_memory_GiB": peak_plain / 2**30,
               **{f"train_f_{k.replace(' ', '_')}_ms": v for k, v in stages.items()}}
    return counts, timings, export


def profile_micro_step(trainer, batch, noise, elapsed_ms, card, label="train"):
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
                print(f"profile: {label} {e.key}: {e.count} calls, {us / 1e3:.3f} ms of device time in "
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
        print(f"profile: {label} micro-step: the profiler recorded no device time", flush=True)
        return
    print(f"profile: {label} micro-step kernels busy {busy_us / 1e3:.3f} ms of {elapsed_ms:.3f} ms elapsed, "
          f"idle share {1 - busy_us / 1e3 / elapsed_ms:.3f} [{card}]", flush=True)
    for key, (n, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:16]:
        print(f"profile: {label} {us / 1e3:8.3f} ms {us / busy_us:6.1%} {n:5d} x {key[:100]}", flush=True)
    flash_bwd = [(n, us) for key, (n, us) in by_kernel.items() if "flash_bwd" in key]
    us = sum(u for _, u in flash_bwd)
    print(f"profile: {label} flash backward kernels (K2a, K2b, the split reduction) {us / 1e3:.3f} ms over "
          f"{sum(n for n, _ in flash_bwd)} launches, {us / busy_us:.3f} of kernel time [{card}]", flush=True)
    # the D = 512 pair (the VAE encoder's mid head) on its own: the kernels named "wide"
    wide = [(re.search(r"flash_bwd_\w+", key).group(0), n, u) for key, (n, u) in by_kernel.items()
            if "flash_bwd" in key and "wide" in key]
    print(f"profile: {label} flash backward at D = 512 (K2a, K2b) "
          + (", ".join(f"{name} {u / 1e3:.3f} ms over {n} launches" for name, n, u in wide) or "none")
          + f", {sum(u for *_, u in wide) / 1e3:.3f} ms, {sum(u for *_, u in wide) / busy_us:.4f} of kernel time "
          f"[{card}]", flush=True)

# ----------------------------------------------------------------------------


# ----------------------------------------------------------------------------
# phase: quant-f (the quantised DiT, serving and training)
# ----------------------------------------------------------------------------

QUANT_MODES = ("int8", "int8_w8a8", "int4")
QUANT_TRAIN_MODES = ("int8", "int4")


def quant_f_serving(card, vae_params, qflux, mode, prompt, pooled, imgs, ref_outs, z, z0_ref):
    """One quantised DiT served through build_server --quantize: three
    1024-px requests with their launches, p50, the DiT stage's device and
    enqueue ms and idle share, and the deviation from the bf16 server."""
    dtype = torch.bfloat16
    args = serve_cli.parse_args(["--pipeline", "f", "--weight_dtype", "bf16", "--latent", "mean", "--port", "0",
                                 "--quantize", mode])
    server = serve_cli.build_server(args, params=(vae_params, qflux), prompt_embeds=(prompt, pooled))
    tile, overlap = args.process_size // 8, args.process_size // 16
    per = flux_structure_counts(FLUX_VAE, FLUX_DEV)
    expect = expected_launches([im.shape[:2] for im in imgs], per, tile, overlap, FLUX_VAE.downscale)
    joint = ((1, 4608, FLUX_DEV.num_attention_heads, FLUX_DEV.attention_head_dim), 4608, dtype)
    out = {}
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with launch_shapes() as seen:
            outs = run_clients(server, [(im, "nofix") for im in imgs])
        peak = torch.cuda.max_memory_allocated()
        counts = {k: v for k, v in read_counts().items() if k in expect}
        expect["flash_attention_fwd_merge"] = sum(n * mid_head_merges(t) for t, n in mid_head_tokens(seen).items())
        assert counts == expect, (mode, counts, expect)
        assert seen["flash_n"].get(joint, 0) == 3 * per["dit"]["flash_attention_fwd"] == 3 * 57, seen["flash_n"]
        lat = []
        for i in range(6):
            t0 = time.perf_counter()
            server.process_array(imgs[i % 3], "adain")
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        server.shutdown()
    steps = [mean_steps(o, r) for o, r in zip(outs, ref_outs)]
    for o in outs:
        assert o.shape == imgs[0].shape and o.dtype == np.uint8 and o.std() > 1.0
    pipe = OMGSRFPipeline(vae_params, qflux, FLUX_VAE, FLUX_DEV, 244, device="cuda")
    ctx, pl = (torch.from_numpy(a).to("cuda", dtype) for a in (prompt, pooled))
    with torch.inference_mode():
        dit = lambda: pipe.latent_mid(z, ctx, pl, tile, overlap)  # noqa: E731
        z0 = dit()
        assert torch.isfinite(z0.float()).all()
        rel = rel_l2(z0.float(), z0_ref.float())
        dit_ms = time_ms(dit, iters=5, warmup=1)
        enq = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dit()
            enq.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        idle = profile_stages({"dit": dit}, {"dit": dit_ms}, card, f"quant-f {mode} 1024x1024", top=6)
    out.update({f"quant_f_{mode}_latency_ms_p50_1024": statistics.median(lat[1:]), f"quant_f_{mode}_dit_ms": dit_ms,
                f"quant_f_{mode}_dit_host_enqueue_ms": statistics.median(enq),
                f"quant_f_{mode}_dit_idle_share": idle.get("dit"), f"quant_f_{mode}_peak_memory_GiB": peak / 2**30,
                f"quant_f_{mode}_latent_rel_l2": rel,
                f"quant_f_{mode}_image_mean_steps": float(np.mean([s[0] for s in steps])),
                f"quant_f_{mode}_image_max_steps": int(max(s[1] for s in steps))})
    print(f"quant-f: {mode}: 3 requests at 1024x1024 through serve --quantize {mode}: launches {counts} (the "
          f"structure's; K1 {per['dit']['flash_attention_fwd']} a tile forward); request p50 "
          f"{out[f'quant_f_{mode}_latency_ms_p50_1024']:.2f} ms (first excluded: {lat[0]:.2f}); the DiT stage "
          f"{dit_ms:.2f} ms on the device, host enqueue {statistics.median(enq):.2f} ms, idle share "
          f"{idle.get('dit', float('nan')):.3f}; peak memory allocated {peak / 2**30:.2f} GiB (the bf16 DiT "
          f"resident beside it); against the bf16 server on the same inputs: DiT latent rel L2 {rel:.4g}, image "
          + ", ".join(f"mean {m:.3f} / max {x} uint8 steps" for m, x, _ in steps) + f" [{card}]", flush=True)
    n_seen = report_launch_shapes("quant-f", f"serve --quantize {mode}", seen, 14000 + 100 * QUANT_MODES.index(mode))
    assert n_seen["flash_attention_fwd"] and n_seen["group_norm"], n_seen
    return counts, out


def quant_f_training(card, vae_params, qflux, mode, backbone, cn_cfg, work_dir, bf16_dit_bytes):
    """train_omgsr_f.run_training on the quantised frozen DiT: two
    micro-steps (one optimizer step at accumulation 2) at 1024 px, then one
    timed micro-step; launches against the structure's, losses finite, peak
    memory."""
    dtype = torch.bfloat16
    prompt, pooled = flux_prompt(17)
    frozen = {"vae": vae_params, "vae_cfg": FLUX_VAE, "flux": qflux, "flux_cfg": FLUX_DEV, "backbone": backbone,
              "dists": init_dists(backbone, cn_cfg.dims), "prompt_embeds": torch.from_numpy(prompt).to("cuda", dtype),
              "pooled_prompt_embeds": torch.from_numpy(pooled).to("cuda", dtype)}
    out_dir = os.path.join(work_dir, f"quant_f_{mode}")
    cfg = TrainConfig(
        model="omgsr_f_1024", output_dir=out_dir, resolution=F_TRAIN_RES, train_batch_size=1, vae_lora_rank=64,
        flux_transformer_lora_rank=64, mixed_precision="bf16", gradient_accumulation_steps=2, max_train_steps=1,
        gradient_checkpointing=True, mid_timestep=244, lr_warmup_steps=0, checkpointing_steps=1000,
        save_img_steps=1000, seed=124, quantize_base=mode,
        extra={"disc_channels": list(cn_cfg.dims[:3]), "metrics_jsonl": f"{out_dir}/metrics.jsonl"})
    expect = f_micro_step_counts(FLUX_VAE, FLUX_DEV, F_TRAIN_RES)
    loader = [f_pair(40 + i) for i in range(2)]
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with launch_shapes() as seen:
        trainer = train_f_cli.run_training(cfg, frozen=frozen, loader=loader, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    lines = [json.loads(line) for line in open(f"{out_dir}/metrics.jsonl")]
    lora = trainer.state["gen"]["lora"]["denoiser"]
    a = lora["transformer_blocks"]["0"]["attn"]["to_q"]["lora_A"]
    assert a.dtype == dtype and a.shape == (64, FLUX_DEV.inner_dim), (a.dtype, a.shape)
    assert trainer.state["step"] == 2 and trainer.state["gen"]["opt"]["count"] == 1
    assert [line["step"] for line in lines] == [1] and all(math.isfinite(lines[0][k]) for k in METRICS), lines
    for name, n in expect.items():
        assert counts[name] == 2 * n, (mode, name, counts[name], 2 * n)
    assert all(not v.requires_grad and v.grad is None for v in flatten_dict(qflux).values())
    gen = torch.Generator(device="cuda").manual_seed(19)
    batch = {k: torch.from_numpy(v).to("cuda", dtype) for k, v in loader[0].items()}
    latent_shape = (1, F_TRAIN_RES // 8, F_TRAIN_RES // 8, FLUX_VAE.latent_channels)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m, pred = trainer.train_step(batch, draw_step_noise(gen, (1, F_TRAIN_RES, F_TRAIN_RES, 3), latent_shape, "cuda",
                                                         dtype))
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_step = torch.cuda.max_memory_allocated()
    assert read_counts() == expect and all(math.isfinite(float(m[k])) for k in METRICS), m
    assert torch.isfinite(pred.float()).all()
    print(f"quant-f: {mode} base: run_training took 1 optimizer step (2 micro-steps) at {F_TRAIN_RES}x{F_TRAIN_RES} "
          f"in {wall:.2f} s, launches {counts} (2 x the structure's: K1 {expect['flash_attention_fwd']}, K2a/K2b "
          f"{expect['flash_attention_bwd_dq']}, K3a/K3b {expect['group_norm_stats']} a micro-step); losses "
          + " ".join(f"{k}={lines[0][k]:.4f}" for k in LOSSES)
          + f"; a micro-step {step_s:.4f} s; peak memory allocated {peak / 2**30:.2f} GiB in run_training, "
          f"{peak_step / 2**30:.2f} GiB in the micro-step; without the resident bf16 DiT "
          f"{(peak - bf16_dit_bytes) / 2**30:.2f} / {(peak_step - bf16_dit_bytes) / 2**30:.2f} GiB [{card}]",
          flush=True)
    n_seen = report_launch_shapes("quant-f", f"run_training on the {mode} base", seen,
                                  14500 + 100 * QUANT_TRAIN_MODES.index(mode))
    assert n_seen["flash_attention_fwd"] and n_seen["flash_attention_bwd"] and n_seen["group_norm"], n_seen
    return counts, {f"quant_f_train_{mode}_micro_step_s": step_s,
                    f"quant_f_train_{mode}_peak_memory_GiB": peak / 2**30,
                    f"quant_f_train_{mode}_peak_without_bf16_dit_GiB": (peak - bf16_dit_bytes) / 2**30,
                    f"quant_f_train_{mode}_micro_step_peak_without_bf16_dit_GiB": (peak_step - bf16_dit_bytes) / 2**30}


def phase_quant_f(card, vae_params, flux_params, work_dir):
    """The quantised FLUX.1-dev DiT at full width and depth, from the serve-f
    weights: each of int8, int8_w8a8 and int4 quantised by
    quantize_flux_for_serving (its bytes), served (quant_f_serving) and freed
    before the next; then the frozen int8 and int4 bases under
    train_omgsr_f.run_training (quant_f_training)."""
    dtype = torch.bfloat16
    prompt, pooled = flux_prompt(12)
    rng = np.random.default_rng(23)
    up4 = np.ones((4, 4, 1), np.uint8)
    imgs = [np.kron(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8), up4) for _ in range(3)]
    bf16_bytes = tree_bytes(flux_params)
    # the bf16 server's outputs and DiT latent on the same inputs
    args = serve_cli.parse_args(["--pipeline", "f", "--weight_dtype", "bf16", "--latent", "mean", "--port", "0"])
    server = serve_cli.build_server(args, params=(vae_params, flux_params), prompt_embeds=(prompt, pooled))
    try:
        ref_outs = [server.process_array(im, "nofix") for im in imgs]
    finally:
        server.shutdown()
    pipe = OMGSRFPipeline(vae_params, flux_params, FLUX_VAE, FLUX_DEV, 244, device="cuda")
    lq = torch.from_numpy(imgs[0].astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
    ctx, pl = (torch.from_numpy(a).to("cuda", dtype) for a in (prompt, pooled))
    with torch.inference_mode():
        z = pipe.encode(lq, sample_latent=False)
        z0_ref = pipe.latent_mid(z, ctx, pl, 128, 64)
    del pipe
    counts, timings = {}, {}
    for mode in QUANT_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qflux = quantize_flux_for_serving(flux_params, act_quant=mode == "int8_w8a8", bits=4 if mode == "int4" else 8)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        nbytes = tree_bytes(qflux)
        kinds = {}
        for p in flatten_dict(qflux):
            kinds[p[-1]] = kinds.get(p[-1], 0) + 1
        print(f"quant-f: {mode}: quantize_flux_for_serving on the card, tensor by tensor, in {q_s:.2f} s: tree_bytes "
              f"{nbytes / 1e9:.3f} GB against the bf16 tree's {bf16_bytes / 1e9:.3f} GB ({nbytes / bf16_bytes:.3f}); "
              f"leaves {dict(sorted(kinds.items()))} [{card}]", flush=True)
        timings[f"quant_f_{mode}_tree_GB"] = nbytes / 1e9
        c, t = quant_f_serving(card, vae_params, qflux, mode, prompt, pooled, imgs, ref_outs, z, z0_ref)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        timings.update(t)
        del qflux
    cn_cfg = CONVNEXT_SIZES["large"]
    backbone = init_convnext(2, cn_cfg, dtype, "cuda")
    for mode in QUANT_TRAIN_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        qflux = quantize_flux_for_serving(flux_params, bits=4 if mode == "int4" else 8)
        c, t = quant_f_training(card, vae_params, qflux, mode, backbone, cn_cfg, work_dir, bf16_bytes)
        counts = {k: counts.get(k, 0) + v for k, v in c.items()}
        timings.update(t)
        del qflux
    del backbone
    timings["quant_f_bf16_tree_GB"] = bf16_bytes / 1e9
    return counts, timings


def quant_f_cli(card, work_dir):
    """infer_omgsr_f --quantize int8 on the load-f directory (the DiT at full
    width and 2 + 2 blocks): the DiT is ported and merged on the CPU and only
    its codes reach the card, so the card's peak above what was resident
    while the pipeline is built stays below the directory's bf16 DiT bytes,
    and the whole run's below the bf16 CLI's; its PNGs against the bf16 CLI's
    on the same inputs."""
    from PIL import Image

    root = os.path.join(work_dir, "flux1-dev")
    dit_bytes = sum(os.path.getsize(os.path.join(root, "transformer", f))
                    for f in os.listdir(os.path.join(root, "transformer")) if f.endswith(".safetensors"))
    img_dir = os.path.join(work_dir, "quant_f_inputs")
    os.makedirs(img_dir)
    rng = np.random.default_rng(24)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(os.path.join(img_dir, f"q{i}.png"))
    base = ["--input_image", img_dir, "--flux_path", root, "--lora_path", os.path.join(root, "lora"), "--prompt_npz",
            os.path.join(root, "prompt.npz"), "--weight_dtype", "bf16"]
    outs, peaks, built = {}, {}, {}
    counts = {}
    real_build = infer_f_cli.build_pipeline
    for mode in ("none", "int8"):
        out_dir = os.path.join(work_dir, f"quant_f_outputs_{mode}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()

        def build(*a, **kw):  # the peak while the DiT is ported, merged and placed, before any request
            pipe = real_build(*a, **kw)
            torch.cuda.synchronize()
            built[mode] = (torch.cuda.max_memory_allocated() - resident, torch.cuda.memory_allocated() - resident)
            return pipe

        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        infer_f_cli.build_pipeline = build
        t0 = time.perf_counter()
        try:
            with launch_shapes() as seen, contextlib.redirect_stdout(io.StringIO()):
                infer_f_cli.main(infer_f_cli.parse_args(base + ["--output_dir", out_dir, "--quantize", mode]))
        finally:
            infer_f_cli.build_pipeline = real_build
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peaks[mode] = torch.cuda.max_memory_allocated() - resident
        outs[mode] = [np.asarray(Image.open(os.path.join(out_dir, f"q{i}.png"))) for i in range(2)]
        if mode == "int8":
            counts = read_counts()
            print(f"quant-f: infer_omgsr_f --quantize int8 on the load-f directory (2 images, 64 px -> 256 px) in "
                  f"{wall:.2f} s, launches {counts} [{card}]", flush=True)
            report_launch_shapes("quant-f", "infer_omgsr_f --quantize int8", seen, 15000)
    steps = [mean_steps(a, b) for a, b in zip(outs["int8"], outs["none"])]
    print(f"quant-f: infer_omgsr_f device memory above what was resident, --quantize int8 / bf16: peak while the "
          f"pipeline was built {built['int8'][0] / 1e9:.3f} / {built['none'][0] / 1e9:.3f} GB (held after it "
          f"{built['int8'][1] / 1e9:.3f} / {built['none'][1] / 1e9:.3f} GB), peak of the whole run with the VAE at "
          f"1024 px {peaks['int8'] / 1e9:.3f} / {peaks['none'] / 1e9:.3f} GB, against the directory's bf16 DiT "
          f"{dit_bytes / 1e9:.3f} GB; int8 against bf16 PNGs: "
          + ", ".join(f"mean {m:.3f} / max {x} uint8 steps" for m, x, _ in steps) + f" [{card}]", flush=True)
    # the card never held the bf16 DiT: the build's peak stays below its bytes, and the run's below the bf16 run's
    assert built["int8"][0] < dit_bytes < built["none"][0], (built, dit_bytes)
    assert peaks["int8"] < peaks["none"], peaks
    for o in outs["int8"]:
        assert o.shape == (256, 256, 3) and o.std() > 1.0
    return counts, {"quant_f_cli_int8_build_peak_GB": built["int8"][0] / 1e9,
                    "quant_f_cli_bf16_build_peak_GB": built["none"][0] / 1e9,
                    "quant_f_cli_int8_peak_GB": peaks["int8"] / 1e9, "quant_f_cli_bf16_peak_GB": peaks["none"] / 1e9,
                    "quant_f_cli_dir_dit_GB": dit_bytes / 1e9}


# ----------------------------------------------------------------------------
# phase: eval (eval_sr with every metric, at published widths)
# ----------------------------------------------------------------------------

EVAL_GT = 512
EVAL_CROP = 256
EVAL_TOL = 1e-5  # as tests/test_torch_port_eval.py holds the port to the JAX package
EVAL_NIQE_TOL = 1e-9


def write_eval_inputs(root, seed):
    """Eight GT/SR pairs (GT 512x512 from a seed; SR blurred and noised,
    shifted, JPEG-compressed, one identical copy, one pair 200x200, below the
    metric crop), a pristine folder, and the metric weights from seeds
    written in the published layouts: a ConvNeXt-L .pth, the LPIPS .pth
    files, a CLIP-L/14 vision directory with its projection and logit_scale,
    and a prompt pair."""
    from PIL import Image, ImageFilter

    from omgsr_tpu_torch.convert.safetensors_io import save_file
    from omgsr_tpu_torch.models.clip_vision import CLIP_L_VISION, init_clip_vision
    from omgsr_tpu_torch.utils.lpips import init_lpips

    rng = np.random.default_rng(seed)
    gt, sr, pristine = (os.path.join(root, d) for d in ("gt", "sr", "pristine"))
    for d in (gt, sr, pristine):
        os.makedirs(d)

    def scene(size):  # smooth colour fields with edges: a texture NIQE and the towers respond to
        y, x = np.mgrid[0:size, 0:size] / size
        img = np.stack([np.sin(6 * x + rng.uniform(0, 6)) * np.cos(4 * y), np.sin(9 * y + 3 * x),
                        (x > rng.uniform(0.3, 0.7)) * 0.6], -1)
        img = 0.5 + 0.4 * img + 0.05 * rng.standard_normal(img.shape)
        return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))

    for i in range(8):
        size = 200 if i == 7 else EVAL_GT
        g = scene(size)
        g.save(os.path.join(gt, f"im{i}.png"))
        if i == 6:
            s = g
        elif i % 3 == 0:
            a = np.asarray(g.filter(ImageFilter.GaussianBlur(1.5)), np.float32)
            s = Image.fromarray(np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8))
        elif i % 3 == 1:
            s = Image.fromarray(np.roll(np.asarray(g), 2 + i, axis=1))
        else:
            buf = io.BytesIO()
            g.save(buf, format="JPEG", quality=20)
            s = Image.open(buf).convert("RGB")
        s.save(os.path.join(sr, f"im{i}.png"))
    for i in range(4):
        scene(EVAL_GT).save(os.path.join(pristine, f"p{i}.png"))

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cn = init_convnext(gen, CONVNEXT_SIZES["large"], torch.float32, "cuda")
    torch.save({"model": {k: v.cpu() for k, v in to_hf_state_dict(cn).items()}}, os.path.join(root, "cn.pth"))
    lp = init_lpips(gen, device="cuda")
    sd_v = {f"features.{k}.{n}": v.cpu() for k, p in lp["features"].items() for n, v in p.items()}
    torch.save(sd_v, os.path.join(root, "vgg16.pth"))
    torch.save({f"lin{i}.model.1.weight": lp["lins"][str(i)].cpu().reshape(1, -1, 1, 1) for i in range(5)},
               os.path.join(root, "vgg_lins.pth"))
    clip = init_clip_vision(gen, CLIP_L_VISION, torch.float32, "cuda")
    state = to_hf_state_dict(clip)
    state["logit_scale"] = torch.tensor(math.log(100.0))
    os.makedirs(os.path.join(root, "clip"))
    save_file({k: v.cpu() for k, v in state.items()}, os.path.join(root, "clip", "model.safetensors"))
    with open(os.path.join(root, "clip", "config.json"), "w") as f:
        json.dump({"vision_config": dataclasses.asdict(CLIP_L_VISION), "projection_dim": 768}, f)
    p0 = rng.standard_normal(768)
    np.savez(os.path.join(root, "prompts.npz"),
             prompt_embeds=np.stack([p0, p0 + 0.05 * rng.standard_normal(768)]).astype(np.float32))
    return gt, sr, pristine


def phase_eval(card, work_dir):
    """eval_sr.main with --dists --lpips --clipiqa --niqe_params at published
    widths (ConvNeXt-L, VGG16, CLIP-L/14 at 224; weights from seeds written in
    the published layouts; a pristine model fitted by niqe.main on seeded
    images) on the card, every per-image score against the same CLI on the
    CPU; then s per image per metric on the card."""
    from omgsr_tpu_torch.cli import eval_sr
    from omgsr_tpu_torch.utils import metrics, niqe

    root = os.path.join(work_dir, "eval")
    t0 = time.perf_counter()
    gt, sr, pristine = write_eval_inputs(root, 31)
    with contextlib.redirect_stdout(io.StringIO()):
        niqe.main(["fit", pristine, os.path.join(root, "pristine.npz")])
    setup_s = time.perf_counter() - t0
    args = ["--sr_dir", sr, "--gt_dir", gt, "--crop_border", "4", "--metric_crop", str(EVAL_CROP), "--dists",
            "--dinov3_weights_path", os.path.join(root, "cn.pth"), "--lpips", "--lpips_vgg",
            os.path.join(root, "vgg16.pth"), "--lpips_lins", os.path.join(root, "vgg_lins.pth"), "--clipiqa",
            "--clip_vision_path", os.path.join(root, "clip"), "--clipiqa_prompts_npz", os.path.join(root, "prompts.npz"),
            "--niqe_params", os.path.join(root, "pristine.npz")]
    walls, results = {}, {}
    for where, device in (("card", "cuda"), ("cpu", "cpu")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            eval_sr.main(args + ["--device", device, "--output", os.path.join(root, f"{where}.json")])
        walls[where] = time.perf_counter() - t0
        with open(os.path.join(root, f"{where}.json")) as f:
            results[where] = json.load(f)
    rows = {d: {r["name"]: r for r in results[d]["per_image"]} for d in results}
    assert len(rows["card"]) == 8 and set(rows["card"]) == set(rows["cpu"])
    worst = {}
    for name, r in rows["card"].items():
        c = rows["cpu"][name]
        for k in ("psnr", "ssim", "dists", "lpips", "clipiqa", "niqe"):
            assert math.isfinite(r[k]), (name, k, r[k])
            d = abs(r[k] - c[k])
            tol = (EVAL_NIQE_TOL if k == "niqe" else EVAL_TOL) * max(1.0, abs(c[k]))
            assert d <= tol, (name, k, r[k], c[k])
            worst[k] = max(worst.get(k, 0.0), d)
    same = rows["card"]["im6.png"]
    assert same["psnr"] == 120.0 and same["lpips"] < 1e-6 and same["dists"] < 1e-5, same
    s = results["card"]["summary"]
    print(f"eval: eval_sr.main --dists --lpips --clipiqa --niqe_params over 8 pairs (GT {EVAL_GT}x{EVAL_GT}, one "
          f"200x200 below --metric_crop {EVAL_CROP}; ConvNeXt-L, VGG16, CLIP-L/14 at 224 from seeds, f32) in "
          f"{walls['card']:.2f} s on the card, {walls['cpu']:.2f} s on the CPU (inputs and weights written in "
          f"{setup_s:.2f} s); means PSNR {s['psnr_mean']:.3f} SSIM {s['ssim_mean']:.4f} DISTS {s['dists_mean']:.4f} "
          f"LPIPS {s['lpips_mean']:.4f} CLIP-IQA {s['clipiqa_mean']:.4f} NIQE {s['niqe_mean']:.3f}; the identical "
          f"pair PSNR {same['psnr']} (the clamp at mse 1e-12); card against CPU, max |difference| "
          + " ".join(f"{k} {v:.3g}" for k, v in worst.items()) + f" (bounds {EVAL_TOL} relative past 1, NIQE "
          f"{EVAL_NIQE_TOL}) [{card}]", flush=True)

    # s per image per metric on the card, the closures eval_sr builds
    pairs, _ = eval_sr.pair_by_stem(sorted(os.path.join(sr, f) for f in os.listdir(sr)),
                                    sorted(os.path.join(gt, f) for f in os.listdir(gt)))
    imgs = [(eval_sr._load01(a), eval_sr._load01(b)) for a, b in pairs]
    crops = [eval_sr._center_crop_multiple(a, b, EVAL_CROP, os.path.basename(p)) for (a, b), (p, _) in zip(imgs, pairs)]
    fns = {"dists": eval_sr.build_dists_fn(os.path.join(root, "cn.pth"), device="cuda"),
           "lpips": eval_sr.build_lpips_fn(os.path.join(root, "vgg16.pth"), os.path.join(root, "vgg_lins.pth"),
                                           device="cuda"),
           "clipiqa": eval_sr.build_clipiqa_fn(os.path.join(root, "clip"), os.path.join(root, "prompts.npz"),
                                               device="cuda")}
    pristine_model = niqe.load_pristine(os.path.join(root, "pristine.npz"))
    def psnr_ssim(a, b, ca, cb):
        ta, tb = (torch.from_numpy(np.ascontiguousarray(v))[None].cuda() for v in (a, b))
        return float(metrics.psnr(ta, tb)[0]), float(metrics.ssim(ta, tb)[0])

    calls = {"psnr+ssim": psnr_ssim,
             "dists": lambda a, b, ca, cb: fns["dists"](ca, cb), "lpips": lambda a, b, ca, cb: fns["lpips"](ca, cb),
             "clipiqa": lambda a, b, ca, cb: fns["clipiqa"](a), "niqe": lambda a, b, ca, cb: niqe.niqe(a, pristine_model)}
    per_image = {}
    for name, fn in calls.items():
        fn(*imgs[0], *crops[0])  # warm
        t0 = time.perf_counter()
        for (a, b), (ca, cb) in zip(imgs, crops):
            fn(a, b, ca, cb)
        torch.cuda.synchronize()
        per_image[name] = (time.perf_counter() - t0) / len(imgs)
    print("timings: eval s per image on the card (host clock, 8 images, 512 px but one 200 px; NIQE on the host): "
          + ", ".join(f"{k} {v:.4f}" for k, v in per_image.items()) + f" [{card}]", flush=True)
    return {f"eval_{k.replace('+', '_')}_s_per_image": v for k, v in per_image.items()} | {
        "eval_card_s": walls["card"], "eval_cpu_s": walls["cpu"]}


# ----------------------------------------------------------------------------
# phase: shard (multi-GPU serving on a process group of one rank, and of two ranks on the one card)
# ----------------------------------------------------------------------------

# on one rank, a sharded output that does not run the same products in the same order as the unsharded
# pipeline: uint8 steps of the image. On two ranks the GroupNorm sums of two bands and the tile batches of
# another size round otherwise in bf16, which random weights amplify: there the bf16 routes are held as
# the kernels are to their plain versions (MAX_MEAN_STEPS, and 95% of the pixels within 16 steps), and the
# same routes in f32 (TF32 off) at SHARD_F32_SIZE px, where no bf16 rounding hides a seam, within
# MAX_SHARD_STEPS at every pixel
MAX_SHARD_STEPS = 1
SHARD_S_INPUT = 512  # the -S request: a 512-px input served at 2048 px, 49 latent tiles of 64
SHARD_F32_SIZE = 1024  # the f32 hold of the world of two: its top-left crop, 9 latent tiles of 64
SHARD_WORLD_TIMEOUT_S = 420.0


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def image_steps(a, b):
    """(max, mean, share within 16) uint8 steps between two images in [-1, 1]
    (any float dtype)."""
    def u8(x):
        return torch.clamp((x.float() + 1.0) * 127.5, 0, 255).round()

    d = (u8(a) - u8(b)).abs()
    return int(d.max().item()), d.mean().item(), (d <= 16).float().mean().item()


def within_two_rank_bound(steps):
    return steps[1] <= MAX_MEAN_STEPS and steps[2] >= 0.95


def shard_s_inputs(seed=31):
    """The -S 2048-px request of the shard phase and a prompt, as numpy."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.integers(0, 256, (SHARD_S_INPUT, SHARD_S_INPUT, 3), dtype=np.uint8),
                  np.ones((4, 4, 1), np.uint8))
    prompt = rng.standard_normal((1, 77, SD21_UNET.cross_attention_dim)).astype(np.float32)
    return img, prompt


def shard_world_rank(rank, world, port, z, z0, out_path):
    """One rank of a world of two sharing the one card over gloo: SD2.1 from
    init_sd21's seeds; the -S tile path on the parent's 2048-px latent ``z``,
    the sharded VAE encode of the request and decode of the parent's ``z0``;
    then the f32 hold (``shard_world_f32``). Rank 0 saves the outputs and the
    f32 hold's steps, both ranks their launch shapes and counts."""
    from omgsr_tpu_torch.parallel import create_mesh, distributed

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cuda:0", backend="gloo",
                           timeout_s=SHARD_WORLD_TIMEOUT_S)
    dtype = torch.bfloat16
    vae_params, unet_params = init_vae(0, SD21_VAE, dtype, "cuda"), init_unet(1, SD21_UNET, dtype, "cuda")
    img, prompt = shard_s_inputs()
    lq = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
    ctx = torch.from_numpy(prompt).to("cuda", dtype)
    mesh = create_mesh({"data": world})
    pipe = OMGSRSPipeline(vae_params, unet_params, SD21_VAE, SD21_UNET, device="cuda").shard_for_mesh(mesh)
    reset_counts()
    with torch.inference_mode(), launch_shapes() as seen:
        out = {"z0": pipe.latent_mid(torch.from_numpy(z).to("cuda", dtype), ctx, 64, 32),
               "encode": TTV.sharded_vae_encode(vae_params, SD21_VAE, lq, mesh),
               "decode": TTV.sharded_vae_decode(vae_params, SD21_VAE, torch.from_numpy(z0).to("cuda", dtype), mesh)}
        torch.cuda.synchronize()
    counts = read_counts()
    f32 = shard_world_f32(rank, mesh, lq[:, :SHARD_F32_SIZE, :SHARD_F32_SIZE], prompt)
    torch.save({"rank": rank, "seen": seen, "counts": counts, "f32": f32,
                **({k: v.float().cpu() for k, v in out.items()} if rank == 0 else {})}, f"{out_path}.{rank}")
    distributed.shutdown()


def shard_world_f32(rank, mesh, lq, prompt):
    """The world of two's f32 hold, after its bf16 run (neither counted nor
    shape-logged): SD2.1 in f32 from the same seeds with TF32 off, the tile
    path and the sharded VAE on ``lq``; rank 0 then runs the unsharded
    pipeline and the full-image VAE on the same inputs. Returns rank 0's
    uint8 steps (max / mean / share within 16) of each route and the latents'
    rel L2, None on rank 1. The decode takes the tile path's x0 latent, the
    same on both ranks; the encode's latent is held through the full decoder."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    vae, unet = init_vae(0, SD21_VAE, torch.float32, "cuda"), init_unet(1, SD21_UNET, torch.float32, "cuda")
    ref = OMGSRSPipeline(vae, unet, SD21_VAE, SD21_UNET, device="cuda")
    sharded = OMGSRSPipeline(vae, unet, SD21_VAE, SD21_UNET, device="cuda").shard_for_mesh(mesh)
    lq, ctx = lq.float(), torch.from_numpy(prompt).to("cuda")
    with torch.inference_mode():
        z = ref.encode(lq, sample_latent=False)
        dist.broadcast(z, src=0)  # one input for both ranks, whatever the convolutions' algorithms
        assert latent_tiles(SHARD_F32_SIZE, SHARD_F32_SIZE, 64, 32, 8) == 9
        z0 = sharded.latent_mid(z, ctx, 64, 32)
        enc = TTV.sharded_vae_encode(vae, SD21_VAE, lq, mesh)
        dec = TTV.sharded_vae_decode(vae, SD21_VAE, z0, mesh)
        torch.cuda.synchronize()
        if rank != 0:
            return None
        z0_ref = ref.latent_mid(z, ctx, 64, 32)
        dec_ref = ref.decode(z0)
        return {"tiles": image_steps(dec_ref, ref.decode(z0_ref)), "tiles_rel_l2": rel_l2(z0, z0_ref),
                "encode": image_steps(ref.decode(enc), ref.decode(z)), "encode_rel_l2": rel_l2(enc, z),
                "decode": image_steps(torch.clamp(dec, -1, 1), dec_ref),
                "decode_rel_l2": rel_l2(torch.clamp(dec, -1, 1), dec_ref)}  # the pipeline's decode clamps


def shard_two_ranks(card, z, z0, work_dir):
    """Two processes on the one card over gloo; returns rank 0's outputs
    and the merged launch shapes and counts of both ranks."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port, out_path = free_port(), os.path.join(work_dir, "shard_world2.pt")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=shard_world_rank, args=(r, 2, port, z, z0, out_path)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_WORLD_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert not alive and codes == [0, 0], f"the world of two: ranks {alive} still running, exit codes {codes}"
    results = [torch.load(f"{out_path}.{r}", weights_only=False) for r in range(2)]
    seen = merge_seen(merge_seen({"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}, results[0]["seen"]),
                      results[1]["seen"])
    counts = {k: results[0]["counts"][k] + results[1]["counts"][k] for k in results[0]["counts"]}
    print(f"shard: a world of two processes on the one card over gloo ran in {time.perf_counter() - t0:.1f} s "
          f"(spawn, SD2.1 from seeds, the tile path and the sharded VAE at 2048 px) [{card}]", flush=True)
    return results[0], seen, counts


def shard_s(card, vae_params, unet_params, work_dir, mesh, timings):
    """-S at 2048 px: the tile-parallel UNet (49 tiles) and the sharded VAE on
    a group of one rank against the unsharded pipeline and the full-image
    VAE, stage by stage and by server; then the same on two ranks sharing
    the card. Returns the launch shapes of the two ranks and their counts."""
    dtype = torch.bfloat16
    img, prompt = shard_s_inputs()
    lq = torch.from_numpy(img.astype(np.float32) / 127.5 - 1.0)[None].to("cuda", dtype)
    ctx = torch.from_numpy(prompt).to("cuda", dtype)
    ref = OMGSRSPipeline(vae_params, unet_params, SD21_VAE, SD21_UNET, device="cuda")
    sharded = OMGSRSPipeline(vae_params, unet_params, SD21_VAE, SD21_UNET, device="cuda").shard_for_mesh(mesh)
    with torch.inference_mode():
        z = ref.encode(lq, sample_latent=False)
        assert z.shape == (1, 256, 256, 4) and latent_tiles(2048, 2048, 64, 32, 8) == 49
        z0 = ref.latent_mid(z, ctx, 64, 32)
        z0_sh = sharded.latent_mid(z, ctx, 64, 32)
        out_ref, out_sh = ref.decode(z0), sharded.decode(z0_sh)
        same = torch.equal(z0, z0_sh)
        steps = image_steps(out_sh, out_ref)
        print(f"shard: -S tiles on one rank, 2048x2048 (49 tiles): the x0 latent "
              f"{'the same bits as' if same else 'rel L2 %.3g from' % rel_l2(z0_sh.float(), z0.float())} the "
              f"unsharded pipeline's; image max {steps[0]} / mean {steps[1]:.4f} uint8 steps", flush=True)
        assert torch.isfinite(out_sh.float()).all() and steps[0] <= MAX_SHARD_STEPS, steps
        unet_ms = {"unsharded": [], "tiles": []}
        for name in in_turns(list(unet_ms), 2):
            p = ref if name == "unsharded" else sharded
            unet_ms[name].append(time_ms(lambda: p.latent_mid(z, ctx, 64, 32), iters=3, warmup=1))
        for name, ms in unet_ms.items():
            timings[f"shard_s_{name}_unet_2048_ms"] = statistics.mean(ms)

        # the sharded VAE against the full-image VAE at 2048 px
        vae_rows = {}
        enc_ref = ref.encode(lq, sample_latent=False)
        torch.cuda.reset_peak_memory_stats()
        enc_sh = TTV.sharded_vae_encode(vae_params, SD21_VAE, lq, mesh)
        vae_rows["encode peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        dec_sh = TTV.sharded_vae_decode(vae_params, SD21_VAE, z0, mesh)
        vae_rows["decode peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        dec_ref = ref.decode(z0)
        vae_rows["full decode peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        enc_steps = image_steps(ref.decode(enc_sh), ref.decode(enc_ref))
        dec_steps = image_steps(torch.clamp(dec_sh, -1, 1), dec_ref)
        for name, fn in (("sharded encode", lambda: TTV.sharded_vae_encode(vae_params, SD21_VAE, lq, mesh)),
                         ("full encode", lambda: ref.encode(lq, sample_latent=False)),
                         ("sharded decode", lambda: TTV.sharded_vae_decode(vae_params, SD21_VAE, z0, mesh)),
                         ("full decode", lambda: ref.decode(z0))):
            vae_rows[f"{name} ms"] = time_ms(fn, iters=3, warmup=1)
        print(f"shard: sharded VAE on one rank at 2048x2048 against the full-image VAE: encode latent rel L2 "
              f"{rel_l2(enc_sh.float(), enc_ref.float()):.3g} (its decoded image max {enc_steps[0]} / mean "
              f"{enc_steps[1]:.4f} uint8 steps), decode max {dec_steps[0]} / mean {dec_steps[1]:.4f} uint8 steps; "
              + ", ".join(f"{k} {v:.3f}" for k, v in vae_rows.items()) + f" [{card}]", flush=True)
        assert enc_steps[0] <= MAX_SHARD_STEPS and dec_steps[0] <= MAX_SHARD_STEPS, (enc_steps, dec_steps)
        timings.update({f"shard_vae_2048_{k.replace(' ', '_')}": v for k, v in vae_rows.items()})

    # through servers: the 2048-px request, unsharded and --shard tiles, in turns
    base = ["--weight_dtype", "bf16", "--latent", "mean", "--port", "0", "--process_size", "512"]
    servers = {name: serve_cli.build_server(serve_cli.parse_args(base + extra), params=(vae_params, unet_params),
                                            prompt_embeds=prompt)
               for name, extra in (("unsharded", []), ("tiles", ["--shard", "tiles"]))}
    try:
        outs, lat, peaks = {}, {name: [] for name in servers}, {}
        for name, server in servers.items():
            torch.cuda.reset_peak_memory_stats()
            outs[name] = server.process_array(img, "adain")
            peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        for name in in_turns(list(servers), 4):
            t0 = time.perf_counter()
            servers[name].process_array(img, "adain")
            lat[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        for server in servers.values():
            server.shutdown()
    d = np.abs(outs["tiles"].astype(int) - outs["unsharded"].astype(int)).max()
    for name in servers:
        timings[f"shard_s_{name}_2048_p50_ms"] = statistics.median(lat[name])
        timings[f"shard_s_{name}_2048_peak_GiB"] = peaks[name]
        print(f"timings: -S 2048x2048 request through serve{' --shard tiles' if name == 'tiles' else ''}: p50 "
              f"{timings[f'shard_s_{name}_2048_p50_ms']:.1f} ms over 4 in turns "
              f"({', '.join(f'{x:.1f}' for x in lat[name])}), "
              f"peak {peaks[name]:.2f} GiB, UNet stage {timings[f'shard_s_{name}_unet_2048_ms']:.2f} ms on the device "
              f"(in turns: {', '.join(f'{x:.2f}' for x in unet_ms[name])}) [{card}]", flush=True)
    print(f"shard: the --shard tiles server's 2048-px image against the unsharded server's: max {d} uint8 steps",
          flush=True)
    assert d <= MAX_SHARD_STEPS, d

    # two ranks on the one card over gloo (which takes CUDA tensors for all-reduce, broadcast and
    # all-gather; its send / recv of a CUDA tensor aborts the process, and the port uses neither)
    out2, seen2, counts2 = shard_two_ranks(card, z.float().cpu().numpy(), z0.float().cpu().numpy(), work_dir)
    with torch.inference_mode():
        z0_2 = out2["z0"].to("cuda", dtype)
        tiles_steps = image_steps(ref.decode(z0_2), out_ref)
        enc2_steps = image_steps(ref.decode(out2["encode"].to("cuda", dtype)), ref.decode(enc_ref))
        dec2_steps = image_steps(torch.clamp(out2["decode"].to("cuda"), -1, 1), dec_ref)
    print(f"shard: two ranks over gloo on the one card at 2048x2048, uint8 steps (max / mean / share within "
          f"16; bounds: mean {MAX_MEAN_STEPS}, share 0.95): -S tiles (25 tiles a rank, one padded; x0 latent rel "
          f"L2 {rel_l2(z0_2.float(), z0.float()):.3g}) " + "%d / %.4f / %.4f" % tiles_steps + " from the "
          f"unsharded pipeline's image; sharded VAE (two bands of 1024 rows, 128 latent rows) encode's image "
          + "%d / %.4f / %.4f" % enc2_steps + ", decode " + "%d / %.4f / %.4f" % dec2_steps + " from the "
          f"full-image VAE; launches of both ranks {counts2}", flush=True)
    assert all(within_two_rank_bound(x) for x in (tiles_steps, enc2_steps, dec2_steps)), (tiles_steps, enc2_steps,
                                                                                          dec2_steps)
    f32 = out2["f32"]
    print(f"shard: two ranks over gloo on the one card in f32 (TF32 off) at {SHARD_F32_SIZE}x{SHARD_F32_SIZE}, "
          f"uint8 steps (max / mean / share within 16; bound: max {MAX_SHARD_STEPS}): "
          + "; ".join(f"{k} " + "%d / %.4f / %.4f" % f32[k] + f" (latent rel L2 {f32[k + '_rel_l2']:.3g})"
                      for k in ("tiles", "encode", "decode"))
          + " against the unsharded pipeline and the full-image VAE", flush=True)
    assert all(f32[k][0] <= MAX_SHARD_STEPS for k in ("tiles", "encode", "decode")), f32
    assert min(counts2["flash_attention_fwd"], counts2["group_norm_stats"], counts2["group_norm_apply"]) > 0
    return seen2, counts2


def in_turns(names, rounds):
    """The order of ``rounds`` rounds over ``names``, every other round
    reversed (a, b, b, a, ...)."""
    return [n for r in range(rounds) for n in (names if r % 2 == 0 else names[::-1])]


def shard_f(card, flux_vae, flux_params, timings):
    """-F on a group of one rank: tiles, fsdp and tp on the serve-f weights
    (no copy: one rank's parts are the tensors themselves), and tp on the
    int8 tree, each through build_server --shard on three 1024-px requests
    and one 2048-px request against the unsharded server, then the 1024-px
    request p50 and the stages' device ms of every configuration in turns."""
    from omgsr_tpu_torch.parallel import create_mesh

    prompt, pooled = flux_prompt(12)
    rng = np.random.default_rng(13)
    up4 = np.ones((4, 4, 1), np.uint8)
    jobs = [(np.kron(rng.integers(0, 256, (256, 256, 3), dtype=np.uint8), up4), al)
            for al in ("nofix", "adain", "wavelet")]
    jobs.append((np.kron(rng.integers(0, 256, (512, 512, 3), dtype=np.uint8), up4), "adain"))
    lq = torch.from_numpy(jobs[0][0].astype(np.float32) / 127.5 - 1.0)[None].to("cuda", torch.bfloat16)
    ctx, pl = (torch.from_numpy(a).to("cuda", torch.bfloat16) for a in (prompt, pooled))
    t0 = time.perf_counter()
    q8 = quantize_flux_for_serving(flux_params, min_params=1 << 16, device="cuda")
    torch.cuda.synchronize()
    print(f"shard: the serve-f DiT quantised to int8 on the card in {time.perf_counter() - t0:.2f} s "
          f"({tree_bytes(q8) / 1e9:.3f} GB)", flush=True)
    base = ["--pipeline", "f", "--weight_dtype", "bf16", "--latent", "mean", "--port", "0"]
    configs = {"unsharded": (None, flux_params, None), "tiles": ("tiles", flux_params, "unsharded"),
               "fsdp": ("fsdp", flux_params, "unsharded"), "tp": ("tp", flux_params, "unsharded"),
               "int8 unsharded": (None, q8, None), "int8 tp": ("tp", q8, "int8 unsharded")}
    servers, pipes, served, latents, rows = {}, {}, {}, {}, {}
    try:
        for name, (shard, tree, against) in configs.items():
            extra = ["--shard", shard] if shard else []
            servers[name] = server = serve_cli.build_server(serve_cli.parse_args(base + extra),
                                                            params=(flux_vae, tree), prompt_embeds=(prompt, pooled))
            torch.cuda.reset_peak_memory_stats()
            served[name] = outs = [server.process_array(img, al) for img, al in jobs]
            rows[name] = {"peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
            pipes[name] = pipe = OMGSRFPipeline(flux_vae, tree, FLUX_VAE, FLUX_DEV, 244, device="cuda")
            if shard:
                pipe.shard_for_mesh(create_mesh({"data" if shard == "tiles" else shard: 1}), shard)
            with torch.inference_mode():
                z = pipe.encode(lq, sample_latent=False)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
                latents[name] = (z, pipe.latent_mid(z, ctx, pl, 128, 64))
                rows[name]["dit_peak_above_resident_GiB"] = (torch.cuda.max_memory_allocated() - resident) / 2**30
            for (img, _), out in zip(jobs, outs):
                assert out.shape == img.shape and out.dtype == np.uint8 and out.std() > 1.0, (name, out.std())
            if against:
                d = [np.abs(a.astype(int) - b.astype(int)).max() for a, b in zip(outs, served[against])]
                same = torch.equal(latents[name][1], latents[against][1])
                rows[name]["note"] = (f"against {against}: the DiT latent {'the same bits' if same else 'differs'}, "
                                      f"the four images max {max(d)} uint8 steps")
                if shard in ("fsdp", "tp"):  # the same products in the same order
                    assert same and max(d) == 0, (name, same, d)
                assert max(d) <= MAX_SHARD_STEPS, (name, d)
        # the 1024-px request and the stages, every configuration in turns
        lat = {name: [] for name in configs}
        for name in in_turns(list(configs), 4):
            t0 = time.perf_counter()
            servers[name].process_array(jobs[len(lat[name]) % 3][0], "adain")
            lat[name].append((time.perf_counter() - t0) * 1e3)
        with torch.inference_mode():
            for name in in_turns(list(configs), 2):
                pipe, (z, z0) = pipes[name], latents[name]
                for stage, fn in (("vae_encode", lambda: pipe.encode(lq, sample_latent=False)),
                                  ("dit", lambda: pipe.latent_mid(z, ctx, pl, 128, 64)),
                                  ("vae_decode", lambda: pipe.decode(z0))):
                    rows[name].setdefault(stage, []).append(time_ms(fn, iters=3, warmup=1))
    finally:
        for server in servers.values():
            server.shutdown()
    del pipes, latents, q8
    gc.collect()
    torch.cuda.empty_cache()
    for name, row in rows.items():
        key = name.replace(" ", "_")
        timings[f"shard_f_{key}_1024_p50_ms"] = statistics.median(lat[name])
        timings[f"shard_f_{key}_peak_GiB"] = row["peak_GiB"]
        timings[f"shard_f_{key}_dit_peak_above_resident_GiB"] = row["dit_peak_above_resident_GiB"]
        for stage in ("vae_encode", "dit", "vae_decode"):
            timings[f"shard_f_{key}_{stage}_1024_ms"] = statistics.mean(row[stage])
        print(f"timings: -F {name}: 1024x1024 p50 {timings[f'shard_f_{key}_1024_p50_ms']:.2f} ms over 4 in turns "
              f"({', '.join(f'{x:.1f}' for x in lat[name])}); encode / DiT / decode "
              + " / ".join(f"{statistics.mean(row[st]):.2f}" for st in ("vae_encode", "dit", "vae_decode"))
              + f" ms on the device (DiT in turns: {', '.join(f'{x:.2f}' for x in row['dit'])}); peak "
              f"{row['peak_GiB']:.2f} GiB over the four requests, the 1024-px DiT stage's "
              f"{row['dit_peak_above_resident_GiB']:.3f} GiB above what was resident"
              + (f"; {row['note']}" if "note" in row else "")
              + f" [{card}]", flush=True)


def shard_serve_reload(card, ckpt_dir, adapter_dir, timings):
    """serve --shard tiles from the load phase's directory over HTTP, then
    POST /v1/reload with the adapters the train phase exported: the output
    after the reload is the output of a server built on them."""
    from PIL import Image
    import urllib.request

    rng = np.random.default_rng(37)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)).save(buf, format="PNG")
    body = buf.getvalue()
    common = ["--sd_path", ckpt_dir, "--prompt", "", "--weight_dtype", "bf16", "--process_size", "512",
              "--port", "0", "--latent", "mean", "--align_method", "nofix"]

    def post(url, data):
        with urllib.request.urlopen(urllib.request.Request(url, data=data, method="POST"), timeout=600) as r:
            return r.read()

    def sr(base):
        return np.asarray(Image.open(io.BytesIO(post(f"{base}/v1/sr", body)))).astype(int)

    outs = {}
    for name, lora in (("served", None), ("fresh", adapter_dir)):
        args = serve_cli.parse_args(common + ["--shard", "tiles"] + (["--lora_path", lora] if lora else []))
        server, httpd = serve_cli.main(args, serve_forever=False)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = "http://%s:%d" % httpd.server_address[:2]
        try:
            outs[f"{name} before"] = sr(base)
            if name == "served":
                t0 = time.perf_counter()
                reply = json.loads(post(f"{base}/v1/reload", json.dumps({"lora_path": adapter_dir}).encode()))
                timings["shard_reload_s"] = time.perf_counter() - t0
                assert reply == {"status": "reloaded", "lora_path": adapter_dir}, reply
                outs["served after"] = sr(base)
        finally:
            server.shutdown()
    moved = np.abs(outs["served after"] - outs["served before"])
    print(f"shard: serve --shard tiles --sd_path over HTTP, then /v1/reload of the train phase's adapters in "
          f"{timings['shard_reload_s']:.2f} s (the old pipeline freed first, the directory ported again): the "
          f"output moved by mean {moved.mean():.4f} / max {moved.max()} uint8 steps, and equals a server built on "
          f"those adapters: {np.array_equal(outs['served after'], outs['fresh before'])} [{card}]", flush=True)
    assert np.array_equal(outs["served after"], outs["fresh before"])


def phase_shard(card, vae_params, unet_params, flux_vae, flux_params, ckpt_dir, adapter_dir, work_dir):
    """Multi-GPU serving on a one-rank NCCL group formed in-process (a TCP
    store on 127.0.0.1): -S tiles at 2048 px, the sharded VAE at 2048 px, -F
    tiles / fsdp / tp (and tp on the int8 tree), serve --shard tiles with a
    /v1/reload; then two ranks on the one card over gloo. Returns the launch
    counts of the whole phase."""
    from omgsr_tpu_torch.parallel import create_mesh, distributed

    assert distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda", timeout_s=600)
    timings = {}
    try:
        reset_counts()
        with launch_shapes() as seen:
            seen2, counts2 = shard_s(card, vae_params, unet_params, work_dir, create_mesh({"data": 1}), timings)
            shard_f(card, flux_vae, flux_params, timings)
            shard_serve_reload(card, ckpt_dir, adapter_dir, timings)
        counts = read_counts()
    finally:
        distributed.shutdown()
    print(f"shard: launches on the one-rank group {counts} [{card}]", flush=True)
    assert min(counts["flash_attention_fwd"], counts["group_norm_stats"], counts["group_norm_apply"]) > 0, counts
    report_launch_shapes("shard", "the one-rank group", seen, 14000)
    report_launch_shapes("shard", "the two ranks on the one card", seen2, 15000)
    return {k: counts[k] + counts2[k] for k in counts}, timings


# ----------------------------------------------------------------------------
# phase: train-dist (multi-GPU LoRA-GAN training on a one-rank NCCL group, and two ranks on the one card)
# ----------------------------------------------------------------------------

# the two-rank holds in f32 (TF32 off): the gradient is a mean of two halves, so only the order of the f32
# sums differs from the one-process step on the whole batch
TD_METRIC_RTOL = 1e-3
TD_LORA_REL_L2 = 1e-4
TD_F_DEPTH = F_LOAD_DEPTH  # -F {data: 2}: two whole bf16 DiTs and two steps do not fit one card
TD_F32_F_RES = 512  # the -F {data: 2} f32 hold: two f32 steps of the 2 + 2-block DiT share the card
TD_WORLD_TIMEOUT_S = 600.0
# the cases of the world of two: (name, kind, dtype, resolution, global batch, mesh axis); the batch of an
# "fsdp" case is replicated, so each rank runs the train phases' shapes at batch 1
TD_CASES = [("-S {data: 2} bf16", "s", torch.bfloat16, 512, 2, "data"),
            ("-S {fsdp: 2} bf16", "s", torch.bfloat16, 512, 1, "fsdp"),
            ("-S {data: 2} f32", "s", torch.float32, 512, 2, "data"),
            ("-F {data: 2} bf16", "f", torch.bfloat16, F_TRAIN_RES, 2, "data"),
            ("-F {data: 2} f32", "f", torch.float32, TD_F32_F_RES, 2, "data"),
            ("-F {fsdp: 2} bf16", "f", torch.bfloat16, F_TRAIN_RES, 1, "fsdp")]


def collective_summary(ct, micro_steps, forwards):
    """The gradient and metric means a micro-step and the gathers a forward,
    with their counts and medians, from ``collective_times``' lists."""
    def med(xs):
        return statistics.median(xs) if xs else 0.0

    return (f"gradient and metric means {sum(ct['all_reduce']) / micro_steps:.2f} ms a micro-step "
            f"({len(ct['all_reduce'])} all-reduces, median {med(ct['all_reduce']):.2f} ms); FSDP gathers "
            f"{sum(ct['gather']) / forwards:.1f} ms a forward ({len(ct['gather'])} gathers of "
            f"{ct['gather_bytes'] / forwards / 1e9:.3f} GB, median {med(ct['gather']):.2f} ms)")


def case_key(name):
    return re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")


def fsdp_bytes(tree):
    """Bytes of the whole leaves that gathering ``tree``'s FSDP chunks makes."""
    from omgsr_tpu_torch.parallel.sharding import FSDPLeaf

    if isinstance(tree, dict):
        return sum(fsdp_bytes(v) for v in tree.values())
    return math.prod(tree.shape) * tree.dtype.itemsize if isinstance(tree, FSDPLeaf) else 0


@contextlib.contextmanager
def collective_times():
    """Inside, the ms of every mean over "data" of the trainers (gradients
    and metrics) and of every FSDP gather of a subtree, listed in the dict
    this yields once the block has ended, with the bytes the gathers made.
    Each call is bracketed by two CUDA events on the current stream, read
    after the block: no host sync is added, so a step timed inside runs as
    it runs without them (a gloo collective blocks the host by itself)."""
    from omgsr_tpu_torch.parallel import sharding as SH
    from omgsr_tpu_torch.training import trainer as TR

    out = {"all_reduce": [], "gather": [], "gather_bytes": 0}
    pending = {"all_reduce": [], "gather": []}
    reduce, gather = TR.all_reduce_mean_tree, SH.Sharding.gather

    def timed(fn, key):
        def call(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if key == "gather":
                out["gather_bytes"] += fsdp_bytes(a[1])
            start.record()
            r = fn(*a, **kw)
            end.record()
            pending[key].append((start, end))
            return r

        return call

    TR.all_reduce_mean_tree, SH.Sharding.gather = timed(reduce, "all_reduce"), timed(gather, "gather")
    try:
        yield out
    finally:
        TR.all_reduce_mean_tree, SH.Sharding.gather = reduce, gather
        torch.cuda.synchronize()
        for key, events in pending.items():
            out[key] = [a.elapsed_time(b) for a, b in events]


def td_forwards(kind):
    """Denoiser forwards a micro-step runs: -F recomputes each DiT block in
    its backward (the gathers run again), -S trains without recompute."""
    return 2 if kind == "f" else 1


def td_frozen(kind, dtype, flux_cfg=FLUX_DEV, vae_params=None, denoiser=None, finish=None):
    """The frozen bundle of the train (-S) and train-f (-F) phases from their
    seeds in ``dtype`` (or the weights handed in): SD2.1 or FLUX.1-dev at
    ``flux_cfg``'s depth, ConvNeXt-L, the prompt. ``finish`` places each DiT
    block as it is drawn. A denoiser handed in enters the bundle as a copy
    of its dicts (the same tensors): run_training consumes the tree it
    places. Returns (bundle, the ConvNeXt config)."""
    cn_cfg = CONVNEXT_SIZES["large"]
    if denoiser is not None:
        denoiser = unflatten_dict(flatten_dict(denoiser))
    backbone = init_convnext(2, cn_cfg, dtype, "cuda")
    frozen = {"backbone": backbone, "dists": init_dists(backbone, cn_cfg.dims)}
    if kind == "s":
        prompt = np.random.default_rng(3).standard_normal((1, 77, 1024)).astype(np.float32)
        frozen.update(vae=vae_params if vae_params is not None else init_vae(0, SD21_VAE, dtype, "cuda"),
                      vae_cfg=SD21_VAE, unet=denoiser if denoiser is not None else init_unet(1, SD21_UNET, dtype, "cuda"),
                      unet_cfg=SD21_UNET, prompt_embeds=torch.from_numpy(prompt).to("cuda", dtype))
    else:
        prompt, pooled = flux_prompt(17)
        frozen.update(vae=vae_params if vae_params is not None else init_vae(9, FLUX_VAE, dtype, "cuda"),
                      vae_cfg=FLUX_VAE,
                      flux=denoiser if denoiser is not None else init_flux(8, flux_cfg, dtype, "cuda", finish=finish),
                      flux_cfg=flux_cfg, prompt_embeds=torch.from_numpy(prompt).to("cuda", dtype),
                      pooled_prompt_embeds=torch.from_numpy(pooled).to("cuda", dtype))
    return frozen, cn_cfg


def td_cfg(kind, dtype, res, out_dir, accumulation=1, steps=1):
    """The train / train-f phases' configuration (LoRA ranks 16 / 32 and 64 /
    64, -F under per-block recompute, seed 123)."""
    kw = dict(output_dir=out_dir, resolution=res, train_batch_size=1, gradient_accumulation_steps=accumulation,
              max_train_steps=steps, lr_warmup_steps=0, checkpointing_steps=1000, save_img_steps=1000, seed=123,
              mixed_precision="bf16" if dtype == torch.bfloat16 else "no",
              extra={"disc_channels": list(CONVNEXT_SIZES["large"].dims[:3]),
                     "metrics_jsonl": os.path.join(out_dir, "metrics.jsonl")})
    if kind == "s":
        kw.update(vae_lora_rank=16, unet_lora_rank=32)
    else:
        kw.update(model="omgsr_f_1024", vae_lora_rank=64, flux_transformer_lora_rank=64, gradient_checkpointing=True,
                  mid_timestep=244)
    return TrainConfig(**kw)


def td_pairs(kind, n, res, seed=60):
    """A global batch of ``n`` synthetic pairs (numpy, [-1, 1])."""
    pairs = [f_pair(seed + i, res) for i in range(n)]
    return {k: np.concatenate([p[k] for p in pairs]) for k in ("lq", "hq")}


def td_step(kind, cfg, frozen, cn_cfg, batch, mesh=None):
    """One micro-step (accumulation 1) of a fresh trainer drawn as
    run_training draws it (the VAE-encoder LoRA, the denoiser's, the heads,
    then the step's noise for the global batch, from one generator seeded
    with cfg.seed), on this rank's rows of ``batch``; the frozen denoiser is
    placed already where the mesh has "fsdp". Returns (metrics, trainer, s)."""
    from omgsr_tpu_torch.convert.params import init_discriminator
    from omgsr_tpu_torch.lora import SD_TARGET_MODULES, init_lora_tree
    from omgsr_tpu_torch.parallel.sharding import data_rows
    from omgsr_tpu_torch.training.trainer import TrainerF, TrainerS, step_noise_rows

    dtype = torch.bfloat16 if cfg.mixed_precision == "bf16" else torch.float32
    gen = torch.Generator(device="cuda").manual_seed(int(cfg.seed))
    key, targets, rank = (("unet", SD_TARGET_MODULES, cfg.unet_lora_rank) if kind == "s"
                          else ("flux", FLUX_TARGET_MODULES, cfg.flux_transformer_lora_rank))
    lora = {"vae_encoder": init_lora_tree(gen, frozen["vae"]["encoder"], SD_TARGET_MODULES, cfg.vae_lora_rank, dtype),
            "denoiser": init_lora_tree(gen, frozen[key], targets, rank, dtype)}
    disc = init_discriminator(gen, cn_cfg.dims[:3], cfg.resolution, dtype, "cuda")
    trainer = (TrainerS if kind == "s" else TrainerF)(cfg, frozen, lora, disc, mesh)
    b, res, vcfg = batch["hq"].shape[0], cfg.resolution, frozen["vae_cfg"]
    noise = draw_step_noise(gen, (b, res, res, 3), (b, res // vcfg.downscale, res // vcfg.downscale,
                                                    vcfg.latent_channels), "cuda", dtype)
    start, count = data_rows(b, mesh)
    rows = {k: torch.from_numpy(v[start:start + count]).to("cuda", dtype) for k, v in batch.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, _ = trainer.train_step(rows, step_noise_rows(noise, start, count))
    torch.cuda.synchronize()
    return {k: float(v) for k, v in metrics.items()}, trainer, time.perf_counter() - t0


def td_outputs(metrics, trainer):
    """The metrics, LoRA and heads after a step, on the host."""
    return {"metrics": metrics, **{what: {p: v.detach().cpu() for p, v in flatten_dict(tree).items()}
                                   for what, tree in (("lora", trainer.state["gen"]["lora"]),
                                                      ("heads", trainer.state["disc"]["params"]))}}


def td_against(got, ref):
    """(the same bits, max relative metric difference, LoRA rel L2, heads rel
    L2) of a step's outputs against the reference step's."""
    same = got["metrics"] == ref["metrics"] and all(
        torch.equal(got[w][p], ref[w][p]) for w in ("lora", "heads") for p in ref[w])
    rel = max(abs(got["metrics"][k] - ref["metrics"][k]) / max(abs(ref["metrics"][k]), 1e-6) for k in METRICS)

    def l2(what):
        d = sum(float((got[what][p].double() - ref[what][p].double()).square().sum()) for p in ref[what])
        n = sum(float(ref[what][p].double().square().sum()) for p in ref[what])
        return math.sqrt(d / n)

    return same, rel, l2("lora"), l2("heads")


def td_run_training(kind, frozen, cn_cfg, work_dir, name, mesh):
    """run_training (2 optimizer steps at accumulation 2) with the train or
    train-f phase's pairs; returns (losses of the two steps, LoRA and heads
    digests, wall s, collective times)."""
    res = 512 if kind == "s" else F_TRAIN_RES
    out_dir = os.path.join(work_dir, f"train_dist_{kind}_{name}")
    cfg = td_cfg(kind, torch.bfloat16, res, out_dir, accumulation=2, steps=2)
    loader = [f_pair((10 if kind == "s" else 30) + i, res) for i in range(4)]
    cli = train_cli if kind == "s" else train_f_cli
    with collective_times() as ct:
        t0 = time.perf_counter()
        trainer = cli.run_training(cfg, frozen=frozen, loader=loader, device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    losses = [[l[k] for k in METRICS] for l in map(json.loads, open(os.path.join(out_dir, "metrics.jsonl")))]
    assert len(losses) == 2 and all(math.isfinite(x) for l in losses for x in l), losses
    out = (losses, digest(trainer.state["gen"]["lora"]), digest(trainer.state["disc"]["params"]), wall, ct)
    del trainer
    return out


def train_dist_one_rank(card, vae_params, unet_params, flux_vae, flux_params, work_dir, timings):
    """-S at 512 px and -F at 1024 px at full width and depth through
    run_training (2 optimizer steps at accumulation 2) unsharded, on {data: 1}
    and on {fsdp: 1} of a one-rank NCCL group formed in-process: the same
    losses and LoRA and heads digests. Then the reference of the world's -F
    {fsdp: 2} case: one micro-step on the serve-f DiT. Returns it, with the
    launch counts and shapes."""
    from omgsr_tpu_torch.parallel import create_mesh, distributed

    assert distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cuda", timeout_s=600)
    try:
        reset_counts()
        with launch_shapes() as seen:
            for kind in ("s", "f"):
                runs = {}
                for name, shape in (("unsharded", None), ("data", {"data": 1}), ("fsdp", {"fsdp": 1})):
                    frozen, cn_cfg = td_frozen(kind, torch.bfloat16, vae_params=vae_params if kind == "s" else flux_vae,
                                               denoiser=unet_params if kind == "s" else flux_params)
                    rest = torch.cuda.memory_allocated() / 2**30
                    torch.cuda.reset_peak_memory_stats()
                    runs[name] = td_run_training(kind, frozen, cn_cfg, work_dir, name,
                                                 create_mesh(shape) if shape else None)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    del frozen
                    gc.collect()
                    torch.cuda.empty_cache()
                    losses, lora_d, heads_d, wall, ct = runs[name]
                    same = name == "unsharded" or (losses, lora_d, heads_d) == runs["unsharded"][:3]
                    label = f"-{kind.upper()} " + (name if shape is None else "{%s: 1}" % name)
                    timings[f"train_dist_one_rank_{kind}_{name}_s"] = wall
                    print(f"train-dist: {label} on the one-rank NCCL group: run_training 2 optimizer steps (4 "
                          f"micro-steps) in {wall:.2f} s ({wall / 4:.4f} s a micro-step, the loop's host work "
                          f"included); {collective_summary(ct, 4, 4 * td_forwards(kind))}; peak {peak:.2f} GiB ("
                          f"{rest:.2f} GiB allocated before it, earlier phases' weights included); "
                          f"losses, LoRA and heads digests "
                          f"{'the unsharded run_training bits' if same else 'DIFFER'} [{card}]", flush=True)
                    assert same, (label, losses, runs["unsharded"][0])
            # the reference of the world's -F {fsdp: 2} case: one micro-step on the whole DiT, unsharded
            frozen, cn_cfg = td_frozen("f", torch.bfloat16, vae_params=flux_vae, denoiser=flux_params)
            name, kind, dtype, res, b, _ = TD_CASES[-1]
            metrics, trainer, s = td_step(kind, td_cfg(kind, dtype, res, work_dir), frozen, cn_cfg,
                                          td_pairs(kind, b, res))
            f_ref = td_outputs(metrics, trainer)
            del trainer, frozen
        counts = read_counts()
    finally:
        distributed.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train-dist: the one-rank group's launches {counts}; the reference micro-step of {name} (the whole DiT "
          f"on one process) {s:.4f} s [{card}]", flush=True)
    return f_ref, counts, seen


def td_tree_digest(trainer):
    """One int64 tensor on the card: the word sums of the LoRA, the heads and
    the spectral-norm u (for the ranks' all-gather)."""
    words = [sum(digest(trainer.state[a][b]).values(), ()) for a, b in (("gen", "lora"), ("disc", "params"),
                                                                         ("disc", "sn"))]
    return torch.tensor([sum(w[0::2]) for w in words] + [sum(w[1::2]) for w in words], dtype=torch.float64,
                        device="cuda")


def train_dist_rank(rank, world, port, work_dir):
    """One rank of the world of two sharing the card over gloo: every case
    of TD_CASES from the seeds of the references (the -F {fsdp: 2} DiT drawn
    block by block and placed as each block is drawn); rank 0 saves each
    case's outputs, both ranks their times, peaks, launch counts and shapes."""
    import torch.distributed as dist

    from omgsr_tpu_torch.parallel import create_mesh, distributed
    from omgsr_tpu_torch.parallel.sharding import shard_params_fsdp

    distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cuda:0", backend="gloo",
                           timeout_s=TD_WORLD_TIMEOUT_S)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    reset_counts()
    with launch_shapes() as seen:
        for name, kind, dtype, res, b, axis in TD_CASES:
            mesh = create_mesh({axis: world})
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            if kind == "f" and axis == "fsdp":
                frozen, cn_cfg = td_frozen(kind, dtype, finish=lambda _, part: shard_params_fsdp(part, mesh, consume=True))
            else:
                depth = {} if kind == "s" else dict(num_layers=TD_F_DEPTH[0], num_single_layers=TD_F_DEPTH[1])
                frozen, cn_cfg = td_frozen(kind, dtype, dataclasses.replace(FLUX_DEV, **depth))
                if axis == "fsdp":
                    frozen["unet"] = shard_params_fsdp(frozen["unet"], mesh, consume=True)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            rest = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()  # the step's peak, not the build's
            with collective_times() as ct:
                metrics, trainer, s = td_step(kind, td_cfg(kind, dtype, res, work_dir), frozen, cn_cfg,
                                              td_pairs(kind, b, res), mesh)
            parts = distributed.all_gather(td_tree_digest(trainer), None)
            rows[name] = {"s": s, "build_s": build_s, "ct": ct, "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
                          "rest_GiB": rest / 2**30, "before_GiB": before / 2**30,
                          "same_on_ranks": all(torch.equal(parts[0], p) for p in parts[1:])}
            if rank == 0:
                torch.save(td_outputs(metrics, trainer), os.path.join(work_dir, f"td_{case_key(name)}.pt"))
            del frozen, trainer
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.synchronize()
    torch.save({"rows": rows, "seen": seen, "counts": read_counts()}, os.path.join(work_dir, f"td_rank{rank}.pt"))
    distributed.shutdown()


def train_dist_worlds(card, vae_params, unet_params, work_dir, f_ref, timings):
    """The references of the world's cases on this process (no group; the
    -F {fsdp: 2} one from train_dist_one_rank), then the world of two on the
    card over gloo, each case against its reference: bf16 deviations
    reported, f32 held to TD_METRIC_RTOL and TD_LORA_REL_L2, FSDP the same
    bits (at worst the f32 bound). Returns the launch counts and shapes of
    both ranks."""
    import multiprocessing

    refs = {TD_CASES[-1][0]: f_ref}
    t0 = time.perf_counter()
    for name, kind, dtype, res, b, axis in TD_CASES[:-1]:
        depth = {} if kind == "s" else dict(num_layers=TD_F_DEPTH[0], num_single_layers=TD_F_DEPTH[1])
        frozen, cn_cfg = td_frozen(kind, dtype, dataclasses.replace(FLUX_DEV, **depth),
                                   vae_params=vae_params if (kind, dtype) == ("s", torch.bfloat16) else None,
                                   denoiser=unet_params if (kind, dtype) == ("s", torch.bfloat16) else None)
        metrics, trainer, _ = td_step(kind, td_cfg(kind, dtype, res, work_dir), frozen, cn_cfg, td_pairs(kind, b, res))
        refs[name] = td_outputs(metrics, trainer)
        del frozen, trainer
        gc.collect()
        torch.cuda.empty_cache()
    print(f"train-dist: the one-process references of the world's cases in {time.perf_counter() - t0:.1f} s",
          flush=True)

    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=train_dist_rank, args=(r, 2, port, work_dir)) for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TD_WORLD_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    wall = time.perf_counter() - t0
    assert not alive and codes == [0, 0], f"train-dist world of two: ranks {alive} still running, exit codes {codes}"
    ranks = [torch.load(os.path.join(work_dir, f"td_rank{r}.pt"), weights_only=False) for r in range(2)]
    timings["train_dist_world_s"] = wall
    print(f"train-dist: a world of two processes on the one card over gloo ran {len(TD_CASES)} cases in {wall:.1f} s "
          f"(spawn and every model from seeds included) [{card}]", flush=True)
    for name, kind, dtype, res, b, axis in TD_CASES:
        got = torch.load(os.path.join(work_dir, f"td_{case_key(name)}.pt"), weights_only=False)
        same, rel, lora_l2, heads_l2 = td_against(got, refs[name])
        rows = [rk["rows"][name] for rk in ranks]
        key = case_key(name)
        timings.update({f"train_dist_{key}_s_rank{r}": row["s"] for r, row in enumerate(rows)})
        timings.update({f"train_dist_{key}_peak_GiB_rank{r}": row["peak_GiB"] for r, row in enumerate(rows)})
        timings.update({f"train_dist_{key}_rest_GiB_rank{r}": row["rest_GiB"] for r, row in enumerate(rows)})
        timings[f"train_dist_{key}_all_reduce_ms"] = sum(rows[0]["ct"]["all_reduce"])
        timings[f"train_dist_{key}_gather_ms_per_forward"] = sum(rows[0]["ct"]["gather"]) / td_forwards(kind)
        against = "the same bits" if same else \
            f"max metric rel diff {rel:.3g}, LoRA rel L2 {lora_l2:.3g}, heads rel L2 {heads_l2:.3g}"
        print(f"train-dist: {name}, {res} px, global batch {b}: against the one-process step {against}; ranks "
              f"equal after the step {[row['same_on_ranks'] for row in rows]}; s a micro-step per rank "
              f"{', '.join('%.3f' % row['s'] for row in rows)} (built in "
              f"{', '.join('%.1f' % row['build_s'] for row in rows)} s); "
              f"{collective_summary(rows[0]['ct'], 1, td_forwards(kind))} (gloo, host-staged: no NCCL or NVLink "
              f"figure); peak per rank in the step {', '.join('%.2f' % row['peak_GiB'] for row in rows)} GiB, "
              f"at rest after the build {', '.join('%.2f' % row['rest_GiB'] for row in rows)} GiB (before it "
              f"{', '.join('%.2f' % row['before_GiB'] for row in rows)}) [{card}]",
              flush=True)
        assert all(row["same_on_ranks"] for row in rows), name
        assert all(math.isfinite(x) for x in got["metrics"].values()), got["metrics"]
        if dtype == torch.float32 or axis == "fsdp":
            assert same or (rel <= TD_METRIC_RTOL and lora_l2 <= TD_LORA_REL_L2), (name, rel, lora_l2)
    seen = merge_seen(merge_seen({"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}, ranks[0]["seen"]),
                      ranks[1]["seen"])
    counts = {k: ranks[0]["counts"][k] + ranks[1]["counts"][k] for k in ranks[0]["counts"]}
    return counts, seen


def phase_train_dist_report(counts, seen, counts2, seen2):
    """The launch counts of the phase; each launch shape that no earlier
    phase held against its plain version."""
    print(f"train-dist: launches on the one-rank group {counts}, of the two ranks {counts2}", flush=True)
    for c in (counts, counts2):
        assert min(c["flash_attention_fwd"], c["flash_attention_bwd_dq"], c["flash_attention_bwd_dkv"],
                   c["group_norm_stats"], c["group_norm_apply"]) > 0, c
    report_launch_shapes("train-dist", "the one-rank group", seen, 16000)
    report_launch_shapes("train-dist", "the two ranks on the one card", seen2, 17000)
    return {k: counts[k] + counts2[k] for k in counts}


# ----------------------------------------------------------------------------
# phase: dinov3 (the DINOv3 ViT backbones through the hub, their heads on K1 at the ViT's token counts)
# ----------------------------------------------------------------------------

# (batch, px) of each backbone's counted forwards: ViT-L at batch 8 / 224 px and batch 1 / 512 px,
# ViT-7B at batch 1 / 224 and 512 px
DINO_RUNS = {"vitl16": [(8, 224), (1, 512)], "vit7b16": [(1, 224), (1, 512)]}
# ViT-L in f32 on the card (TF32 off) against the same tree through the plain versions on the CPU:
# ||card - CPU|| / ||CPU|| of the patch, class and register tokens at batch 1 / 224 px; summation
# order and the f32 kernel's fast exp only
DINO_F32_REL_L2 = 1e-4
DINO_ITERS = {"vitl16": 10, "vit7b16": 5}


def vit_k1_shape(cfg, batch, px):
    """((B, Sq, H, D), Skv) of the ViT's heads: 1 + registers + h*w tokens."""
    tokens = 1 + cfg.n_storage_tokens + (px // cfg.patch_size) ** 2
    return (batch, tokens, cfg.num_heads, cfg.head_dim), tokens


def counted(seen_all, counts_all, fn, inference=True):
    """fn() with the counts set to 0 just before it and read just after (the
    main path's window), its launch shapes merged into ``seen_all``."""
    reset_counts()
    with launch_shapes() as seen, torch.inference_mode(inference):
        out = fn()
        torch.cuda.synchronize()
    c = read_counts()
    merge_seen(seen_all, seen)
    for k, v in c.items():
        counts_all[k] = counts_all.get(k, 0) + v
    return out, c


def vit_forwards(card, name, m, seed, seen_all, counts_all, timings, profile_dir=None):
    """The counted apply and get_intermediate_layers(n=4) forwards of one hub
    ViT at DINO_RUNS[name]; each K1 launch count per forward is the depth and
    nothing else launches. -> {(batch, px): apply output}."""
    cfg = m.cfgs["backbone"]
    outs = {}
    for i, (batch, px) in enumerate(DINO_RUNS[name]):
        x = randn((batch, px, px, 3), torch.bfloat16, seed + i)
        hw = (px // cfg.patch_size) ** 2
        out, c = counted(seen_all, counts_all, lambda: m.apply(m.params, x))
        assert c["flash_attention_fwd"] == cfg.depth and sum(c.values()) == cfg.depth, (name, batch, px, c)
        assert out["x_norm_patchtokens"].shape == (batch, hw, cfg.embed_dim), out["x_norm_patchtokens"].shape
        assert out["x_storage_tokens"].shape == (batch, cfg.n_storage_tokens, cfg.embed_dim)
        assert all(torch.isfinite(v.float()).all() for v in out.values()), (name, batch, px)
        feats, c2 = counted(seen_all, counts_all, lambda: m.extras["get_intermediate_layers"](
            m.params, x, n=4, reshape=True, return_class_token=True))
        assert c2 == c, (c2, c)
        assert len(feats) == 4 and feats[-1][0].shape == (batch, px // cfg.patch_size, px // cfg.patch_size,
                                                          cfg.embed_dim)
        # the last block's patch map, normed, is the apply's patch tokens: the same kernels, the same bits
        assert torch.equal(feats[-1][0].reshape(batch, hw, -1), out["x_norm_patchtokens"]), name
        assert all(torch.isfinite(f.float()).all() and torch.isfinite(cl.float()).all() for f, cl in feats)
        outs[(batch, px)] = out
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats()
            at_rest = torch.cuda.memory_allocated()
            ms = time_ms(lambda: m.apply(m.params, x), DINO_ITERS[name], warmup=2)
            peak = torch.cuda.max_memory_allocated()
        shape, _ = vit_k1_shape(cfg, batch, px)
        blocks = -(-shape[1] // 128) * shape[2] * batch  # K1's wgmma grid: 128-row q tiles x heads x batch
        key = f"dinov3 {name} b{batch} {px}px"
        timings[key] = {"ms_per_forward": ms, "images_per_s": batch * 1e3 / ms, "k1_launches_per_forward": cfg.depth,
                        "peak_gib": peak / 2 ** 30, "at_rest_gib": at_rest / 2 ** 30, "k1_grid_blocks": blocks}
        print(f"dinov3: {name} batch {batch} at {px} px ({shape[1]} tokens): {ms:.3f} ms a forward (CUDA events, "
              f"warm, {DINO_ITERS[name]} forwards), {batch * 1e3 / ms:.1f} images/s, peak {peak / 2 ** 30:.2f} GiB "
              f"({at_rest / 2 ** 30:.2f} at rest), K1 {cfg.depth} launches a forward on a grid of {blocks} blocks "
              f"({-(-shape[1] // 128)} q tiles x {shape[2]} heads x {batch}) for {FA.sm_count(x.device)} SMs; "
              f"get_intermediate_layers(n=4) the same launches, its last map the apply's bits [{card}]", flush=True)
        if profile_dir is not None:
            from torch.autograd import DeviceType

            from omgsr_tpu_torch.utils.observability import trace

            with torch.inference_mode(), trace(profile_dir) as prof:
                m.apply(m.params, x)
                torch.cuda.synchronize()
            by_kernel = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    us = getattr(e, "self_device_time_total", None)
                    n, t = by_kernel.get(e.key, (0, 0.0))
                    by_kernel[e.key] = (n + e.count, t + (e.self_cuda_time_total if us is None else us))
            busy = sum(t for _, t in by_kernel.values()) / 1e3
            k1_n, k1_us = map(sum, zip(*[v for k, v in by_kernel.items() if "flash_fwd" in k]))
            size = os.path.getsize(prof.trace_path)
            timings[key].update(trace_mib=size / 2 ** 20, busy_ms=busy, idle_share=1 - busy / ms,
                                k1_device_ms=k1_us / 1e3 / k1_n)
            print(f"profile: dinov3 {name} b{batch} {px}px one forward traced by utils.observability.trace: "
                  f"{os.path.basename(prof.trace_path)}, {size / 2 ** 20:.2f} MiB; kernels busy {busy:.3f} ms of "
                  f"{ms:.3f} ms a forward (idle share {1 - busy / ms:.3f}); K1 {k1_n} launches, "
                  f"{k1_us / 1e3 / k1_n:.5f} ms of device time each [{card}]", flush=True)
            for k, (n, t) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]:
                print(f"profile: dinov3 {name} b{batch} {px}px {t / 1e3:8.3f} ms {t / 1e3 / busy:6.1%} {n:4d} x "
                      f"{k[:90]}", flush=True)
    return outs


def phase_dinov3(card, work_dir, profile=False):
    """The DINOv3 ViTs through the hub entries on the card, bf16, random
    weights from seeds: ViT-L (0.3B) and ViT-7B (6.7B) at full width and
    depth, apply and get_intermediate_layers(n=4) at DINO_RUNS, the ViT-7B
    linear classifier; each new K1 shape timed and held against its plain
    version; ViT-L in f32 against the CPU."""
    from omgsr_tpu_torch import hub
    from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply
    from omgsr_tpu_torch.models.layers import dense
    from omgsr_tpu_torch.utils.devices import tree_to

    seen_all = {"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}
    counts_all, timings = {}, {}
    profile_dir = os.path.join(work_dir, "dinov3_trace") if profile else None

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = hub.dinov3_vitl16(seed=40, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    cfg_l = m.cfgs["backbone"]
    print(f"dinov3: hub.dinov3_vitl16 drew {count_params(m.params) / 1e9:.3f}B parameters in bf16 in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    vit_forwards(card, "vitl16", m, 4000, seen_all, counts_all, timings, profile_dir)

    # f32 on the card (TF32 off, phase device) against the plain versions on the CPU, same tree
    x = randn((1, 224, 224, 3), torch.float32, 4100)
    p32 = tree_to(m.params, dtype=torch.float32)
    out32, c = counted(seen_all, counts_all, lambda: m.apply(p32, x))
    assert c["flash_attention_fwd"] == cfg_l.depth, c
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = dinov3_vit_apply(tree_to(p32["backbone"], device="cpu"), cfg_l, x.cpu())
    cpu_s = time.perf_counter() - t0
    rels = {k: rel_l2(out32[k].cpu(), ref[k]) for k in ("x_norm_patchtokens", "x_norm_clstoken", "x_storage_tokens")}
    print(f"dinov3: vitl16 f32 batch 1 at 224 px on the card (K1's f32 kernel, TF32 off) against the plain versions "
          f"on the CPU ({cpu_s:.2f} s): rel L2 " + ", ".join(f"{k} {v:.3g}" for k, v in rels.items())
          + f" (bound {DINO_F32_REL_L2} on each)", flush=True)
    assert max(rels.values()) <= DINO_F32_REL_L2, rels
    timings["dinov3 vitl16 f32 rel_l2"] = rels
    del m, p32, out32
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m = hub.dinov3_vit7b16(seed=41, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    cfg_7b = m.cfgs["backbone"]
    weights_gb = sum(t.numel() * t.element_size() for t in flatten_dict(m.params).values()) / 1e9
    print(f"dinov3: hub.dinov3_vit7b16 drew {count_params(m.params) / 1e9:.3f}B parameters ({weights_gb:.2f} GB "
          f"in bf16) in {time.perf_counter() - t0:.2f} s", flush=True)
    outs = vit_forwards(card, "vit7b16", m, 4200, seen_all, counts_all, timings, profile_dir)
    del m
    gc.collect()
    torch.cuda.empty_cache()
    # the linear classifier draws the same backbone from the same seed: its logits are its head over the
    # features of the backbone's forward above
    lc = hub.dinov3_vit7b16_lc(seed=41, dtype=torch.bfloat16, device="cuda")
    batch, px = DINO_RUNS["vit7b16"][0]
    x = randn((batch, px, px, 3), torch.bfloat16, 4200)  # the backbone's first input above
    logits, c = counted(seen_all, counts_all, lambda: lc.apply(lc.params, x))
    assert c["flash_attention_fwd"] == cfg_7b.depth, c
    f = outs[(batch, px)]
    with torch.inference_mode():
        z = torch.cat([f["x_norm_clstoken"], f["x_norm_patchtokens"].mean(dim=1)], dim=-1)
        want = dense(lc.params["linear_head"], z)
    err = (logits.float() - want.float()).abs().max().item() / want.float().abs().max().item()
    assert logits.shape == (batch, 1000) and torch.isfinite(logits.float()).all() and err <= TOL[torch.bfloat16], err
    ms = time_ms(lambda: lc.apply(lc.params, x), DINO_ITERS["vit7b16"], warmup=2)
    timings[f"dinov3 vit7b16_lc b{batch} {px}px"] = {"ms_per_forward": ms}
    print(f"dinov3: dinov3_vit7b16_lc logits ({batch}, 1000) at {px} px finite, {err:.3g} of max |logit| from the head over the "
          f"backbone's features; {ms:.3f} ms a forward [{card}]", flush=True)
    del lc
    gc.collect()
    torch.cuda.empty_cache()

    # each K1 shape of the bf16 forwards timed and held against the plain version, with the ViT's operands
    rows = []
    for i, (name, cfg) in enumerate((("vitl16", cfg_l), ("vit7b16", cfg_7b))):
        for j, (batch, px) in enumerate(DINO_RUNS[name]):
            shape, skv = vit_k1_shape(cfg, batch, px)
            assert seen_all["flash_n"][(shape, skv, torch.bfloat16)] >= 2 * cfg.depth
            r = check_flash(shape, skv, torch.bfloat16, 4300 + 20 * i + 10 * j, packed="v")
            r.update(on_dinov3_path=True, launches_per_forward=cfg.depth, backbone=name)
            HELD["flash"].add((shape, skv, torch.bfloat16))
            rows.append(r)
            print(f"dinov3: flash_attention_fwd {r['shape']} ({name}): err {r['max_abs_err']:.3g} "
                  f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[torch.bfloat16]:.3g}) lse err "
                  f"{r['max_abs_err_lse']:.3g}, two runs bit-identical; {r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
                  f"{r['bound_share']:.3f} of the bound), plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} "
                  f"(SDPA {r['library_backend']}), bound {r['bound_ms']:.5f} ({r['bound_by']}); {cfg.depth} a "
                  f"forward [{card}]", flush=True)
    report_launch_shapes("dinov3", "the DINOv3 ViTs", seen_all, 18000)
    print(f"dinov3: launches {counts_all}", flush=True)
    return counts_all, timings, rows


# ----------------------------------------------------------------------------
# phase: ssl (DINOv3 SSL pretraining at full ViT-L/16 width; K1, K2a/K2b at the ViT's ragged token counts)
# ----------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
SSL_RECIPE = os.path.join(ROOT, "omgsr_tpu_torch", "configs", "ssl_vitl16.yml")
SSL_DISTILLED = os.path.join(ROOT, "omgsr_tpu_torch", "configs", "ssl_vitl16_distilled.yml")
SSL_ITERS = 4
SSL_LOADER_STEPS = 8  # steps behind the loader thread; the first 3 take pre-filled batches
SSL_IMAGES = 24  # random sizes 256-512 px
SSL_KNN_PER_CLASS = 8  # a 2-class ImageFolder, train and val the same
# the run resumed from iteration 2 against the straight run on the card: iterations 3 and 4's losses (relative) and
# the teacher (max |difference|): the same code on the same inputs, up to the order of atomic adds (the gradient of
# KoLeo's nearest-neighbour gather)
SSL_RESUME_LOSS_REL = 1e-4
SSL_RESUME_TEACHER_ABS = 1e-5
# one step in f32 on the card (TF32 off) against the CPU at ViT-L width, 65,536 prototypes and depth 2, batch 2:
# the losses (relative), each tree of the student, teacher and Adam moments (rel L2 over the tree) and its worst
# leaf (rel L2). The f32 step is ill-conditioned with random weights and LayerScale 1e-5: f32 and f64 gradients
# differ by up to 5.9e-3 (rel L2) on the CPU alone in leaves whose gradient is near 0 (the norm2 weights, |g|
# 8e-7), and Adam's first step moves an entry by about lr whatever its gradient's size. On an H100 80GB HBM3 at
# 700 W the card read 1.45e-4 (Adam mu) and 1.70e-4 (nu) over the trees and 6.35e-3 in the worst leaf, the same
# in four runs; the bounds sit 3-5x above. The same step with TF32 on is the control and must break a bound (its
# gradients in those leaves were 0.67-2.7 off f64, the card's f32 ones 4.9e-3-9.0e-3)
SSL_F32_DEPTH = 2
SSL_F32_LOSS_REL = 1e-5
SSL_F32_TREE_REL_L2 = 5e-4
SSL_F32_REL_L2 = 3e-2
SSL_STEP = dict(lr=2e-4, wd=0.04, teacher_temp=0.05, momentum=0.992, last_layer_lr=2e-4)
# the distillation teacher's depth (ViT-7B/16 has 40 blocks)
SSL_DISTILL_TEACHER_DEPTH = 40


def write_ssl_images(root, seed):
    """SSL_IMAGES JPEGs of random sizes 256-512 px, and a 2-class ImageFolder
    (knn/c0, knn/c1) of SSL_KNN_PER_CLASS images each; smooth random colour
    fields with noise, so the crops and the k-NN classes differ."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs = os.path.join(root, "images")
    os.makedirs(imgs)
    for i in range(SSL_IMAGES):
        h, w = (int(v) for v in rng.integers(256, 513, 2))
        base = rng.uniform(0, 255, (h // 32 + 2, w // 32 + 2, 3)).astype(np.float32)
        up = np.asarray(Image.fromarray(base.astype(np.uint8)).resize((w, h), Image.BICUBIC), np.float32)
        arr = np.clip(up + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(imgs, f"img_{i:02d}.jpg"), quality=92)
    knn = os.path.join(root, "knn")
    for c in range(2):
        os.makedirs(os.path.join(knn, f"c{c}"))
        for j in range(SSL_KNN_PER_CLASS):
            arr = rng.normal(70 + 110 * c, 25, (288, 320, 3)).clip(0, 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(knn, f"c{c}", f"{j}.png"))
    return imgs, knn


def ssl_args(out_dir, imgs, knn, extra=()):
    return ["--config", SSL_RECIPE, f"output_dir={out_dir}", f"dataset_paths={imgs}", "epochs=1",
            f"official_epoch_length={SSL_ITERS}", "saveckp_freq=2", "print_freq=1",
            f"eval_period_iterations={SSL_ITERS}", f"eval_knn_train_dir={knn}", f"eval_knn_val_dir={knn}", *extra]


def tree_diff(a, b):
    """(max |a - b|, worst leaf rel L2, that leaf's path, rel L2 over the
    whole tree) of two trees of the same structure."""
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert set(fa) == set(fb)
    worst_abs, worst_rel, worst_leaf, d2, n2 = 0.0, 0.0, "", 0.0, 0.0
    for k in fb:
        x, y = fa[k].detach().double().cpu(), fb[k].detach().double().cpu()
        worst_abs = max(worst_abs, (x - y).abs().max().item())
        d2, n2 = d2 + (x - y).pow(2).sum().item(), n2 + y.pow(2).sum().item()
        r = rel_l2(x, y)
        if r >= worst_rel:
            worst_rel, worst_leaf = r, ".".join(k)
    return worst_abs, worst_rel, worst_leaf, math.sqrt(d2 / n2) if n2 > 0 else math.sqrt(d2)


def ssl_f32_against_cpu(card, cfg, mcfg, vit_cfg, b32, seen_all, counts_all):
    """One SSL step in f32 at ViT-L width and depth SSL_F32_DEPTH on the
    batch ``b32`` (CPU tensors), from the same seeded student: on the card
    with TF32 off, on the CPU, in f64 on the CPU (the yardstick), and on the
    card with TF32 on (the control, which must break a bound). The card's
    losses, student, teacher, Adam moments and centers are held against the
    CPU's. Each step's optimizer records the gradients it is handed, before
    the clip: their global norm and the heads' leaves, against f64. The DINO
    cross-entropy's gradient alone, from the f64 student's logits rounded to
    f32, shows where the card's head gradients leave the CPU's."""
    from omgsr_tpu_torch.cli import pretrain_dinov3 as PD
    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.losses.ssl import dino_loss, sinkhorn_knopp
    from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply
    from omgsr_tpu_torch.training.ssl import dino_head_apply
    from omgsr_tpu_torch.training.ssl_meta_arch import copy_tree, init_center_state, init_ssl_student, make_ssl_train_step
    from omgsr_tpu_torch.utils.devices import tree_to

    vc32 = dataclasses.replace(vit_cfg, depth=SSL_F32_DEPTH)
    student_cpu = init_ssl_student(71, vc32, mcfg, init_dinov3_vit, torch.float32, "cpu")
    tf32_before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    runs = {}
    for name, dev, dt, tf32 in (("card", "cuda", torch.float32, False), ("card TF32", "cuda", torch.float32, True),
                                ("CPU", "cpu", torch.float32, False), ("CPU f64", "cpu", torch.float64, False)):
        st = copy_tree(tree_to(student_cpu, device=dev, dtype=dt))
        te = copy_tree(st)
        opt = PD.build_ssl_optimizer(cfg, vc32, st)
        state = opt.init(st)
        handed = {}

        def recording_update(grads, *a, _update=opt.update, _handed=handed, **kw):
            flat = flatten_dict(grads)
            _handed["norm"] = math.sqrt(sum(g.double().pow(2).sum().item() for g in flat.values()))
            _handed["heads"] = {k: g.detach().double().cpu() for k, g in flat.items() if k[0] != "backbone"}
            return _update(grads, *a, **kw)

        opt.update = recording_update
        step = make_ssl_train_step(opt, cfg=mcfg, vit_cfg=vc32)
        bd = {k: (v.to(dev, dt) if v.is_floating_point() else v.to(dev)) for k, v in b32.items()}
        centers = {k: v.to(dt) for k, v in init_center_state(mcfg, dev).items()}
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        t0 = time.perf_counter()
        try:
            if name == "card":
                out, _ = counted(seen_all, counts_all, lambda: step(st, te, state, centers, bd, **SSL_STEP),
                                 inference=False)
            else:
                out = step(st, te, state, centers, bd, **SSL_STEP)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32_before
        runs[name] = (out, time.perf_counter() - t0, handed)
    cpu, f64 = runs["CPU"][0], runs["CPU f64"][2]

    def against_cpu(run):
        loss_rel = max(abs(float(run[4][k]) - float(cpu[4][k])) / abs(float(cpu[4][k])) for k in cpu[4])
        return loss_rel, {"student": tree_diff(run[0], cpu[0]), "teacher": tree_diff(run[1], cpu[1]),
                          "adam mu": tree_diff(run[2]["mu"], cpu[2]["mu"]),
                          "adam nu": tree_diff(run[2]["nu"], cpu[2]["nu"]), "centers": tree_diff(run[3], cpu[3])}

    def breaks(loss_rel, devs):
        return (loss_rel > SSL_F32_LOSS_REL or max(v[3] for v in devs.values()) > SSL_F32_TREE_REL_L2
                or max(v[1] for v in devs.values()) > SSL_F32_REL_L2)

    loss_rel, devs = against_cpu(runs["card"][0])
    loss_tf32, devs_tf32 = against_cpu(runs["card TF32"][0])
    pre = {}
    for name in ("card", "card TF32", "CPU"):
        h = runs[name][2]
        heads = {k: rel_l2(h["heads"][k], f64["heads"][k]) for k in f64["heads"]}
        worst = max(heads, key=heads.get)
        pre[name] = {"norm_rel": abs(h["norm"] - f64["norm"]) / f64["norm"], "norm": h["norm"],
                     "dino_head": max(v for k, v in heads.items() if k[0] == "dino_head"),
                     "ibot_head": max((v for k, v in heads.items() if k[0] == "ibot_head"), default=0.0),
                     "worst_head_leaf": (".".join(worst), heads[worst])}

    # the DINO CE alone (each student crop's log-softmax at T_s against the other crops' Sinkhorn targets): its
    # gradient w.r.t. the student's global logits, from the f64 student's logits rounded to f32, on the card and
    # the CPU through losses/ssl.dino_loss (which computes in f32 whatever it is given, so the steps' f64 run
    # shares the CPU's rounding there), against the same formula in f64; and its log-softmax's backward alone
    s64 = copy_tree(tree_to(student_cpu, dtype=torch.float64))
    with torch.no_grad():
        cls = dinov3_vit_apply(s64["backbone"], vc32, b32["global_crops"].double())["x_norm_clstoken"]
        logits = dino_head_apply(s64["dino_head"], cls).float()
        targets = sinkhorn_knopp(logits, SSL_STEP["teacher_temp"], n_iterations=mcfg.sinkhorn_iterations)
    n_g, t_s = mcfg.n_global_crops, mcfg.student_temp
    x_crops, t_crops = logits.reshape(n_g, -1, logits.shape[-1]), targets.reshape(n_g, -1, logits.shape[-1])
    off_diag = 1.0 - torch.eye(n_g, dtype=torch.float64)
    x64 = x_crops.double().requires_grad_(True)
    logp64 = torch.log_softmax(x64 / t_s, -1)
    pairs = -torch.einsum("sbk,tbk->st", logp64, t_crops.double()) * off_diag
    up64, g64 = torch.autograd.grad(pairs.sum() / (x_crops.shape[1] * n_g * (n_g - 1)), (logp64, x64))
    ce = {"grad_over_softmax": g64.norm().item() * t_s / torch.exp(logp64).norm().item()}
    for name, dev in (("card", "cuda"), ("CPU", "cpu")):
        x = x_crops.to(dev).requires_grad_(True)
        grad = torch.autograd.grad(dino_loss(x, t_crops.to(dev), t_s, ignore_diagonal=True), x)[0]
        logp = torch.log_softmax(x.detach() / t_s, -1)
        lsm_bwd = torch._log_softmax_backward_data(up64.float().to(dev), logp64.detach().float().to(dev), -1,
                                                   torch.float32)
        ce[name] = {"grad": rel_l2(grad.double().cpu(), g64), "logp_max_abs":
                    (logp.double().cpu() - logp64.detach()).abs().max().item(), "log_softmax_bwd_alone":
                    rel_l2(lsm_bwd.double().cpu(), g64 * t_s)}

    (gpu, gpu_s, _), cpu_s = runs["card"], runs["CPU"][1]
    fa, fb = flatten_dict(gpu[2]["mu"]), flatten_dict(cpu[2]["mu"])
    ranked = sorted(((rel_l2(fa[k].float().cpu(), fb[k].float()), ".".join(k)) for k in fb), reverse=True)[:6]
    print(f"ssl: one step in f32 (TF32 off) at ViT-L width, depth {SSL_F32_DEPTH}, {mcfg.dino_out_dim} prototypes, "
          f"batch {b32['global_crops'].shape[0] // 2} on the card ({gpu_s:.2f} s) against the CPU ({cpu_s:.2f} s; f64 "
          f"{runs['CPU f64'][1]:.2f} s): losses within {loss_rel:.3g} relative (bound {SSL_F32_LOSS_REL}); rel L2 over "
          "each tree " + ", ".join(f"{k} {v[3]:.3g}" for k, v in devs.items()) + f" (bound {SSL_F32_TREE_REL_L2}); "
          "its worst leaf " + ", ".join(f"{k} {v[1]:.3g} ({v[2]})" for k, v in devs.items())
          + f" (bound {SSL_F32_REL_L2}); the gradients' (Adam mu) largest: "
          + ", ".join(f"{n} {r:.3g}" for r, n in ranked) + f" [{card}]", flush=True)
    print(f"ssl: the control, the same step on the card with TF32 on, against the CPU: losses within {loss_tf32:.3g}; "
          "rel L2 over each tree " + ", ".join(f"{k} {v[3]:.3g}" for k, v in devs_tf32.items()) + "; its worst leaf "
          + ", ".join(f"{k} {v[1]:.3g} ({v[2]})" for k, v in devs_tf32.items())
          + f"; it breaks a bound: {breaks(loss_tf32, devs_tf32)} [{card}]", flush=True)
    print(f"ssl: the gradients handed to the optimizer (before the clip at {cfg.clip_grad}) against f64: global norm "
          f"{f64['norm']:.6g} in f64; " + "; ".join(
              f"{k} {v['norm']:.6g} (rel {v['norm_rel']:.3g}), dino_head leaves up to {v['dino_head']:.3g}, ibot_head "
              f"{v['ibot_head']:.3g} (rel L2), worst head leaf {v['worst_head_leaf'][0]} {v['worst_head_leaf'][1]:.3g}"
              for k, v in pre.items())
          + f" (the losses' log-softmax and Sinkhorn compute in f32 in all of them) [{card}]", flush=True)
    print(f"ssl: the DINO CE alone (global crops, batch {x_crops.shape[1]}, {logits.shape[1]} prototypes) from the "
          f"same f32 logits against its formula in f64 (the gradient is {ce['grad_over_softmax']:.3g} of the "
          "softmax it is left of): " + "; ".join(
              f"{k} gradient {v['grad']:.3g} (rel L2), log-softmax max abs {v['logp_max_abs']:.3g}, its backward "
              f"alone from the f64 upstream and log-probabilities {v['log_softmax_bwd_alone']:.3g}"
              for k, v in ce.items() if k in ("card", "CPU")) + f" [{card}]", flush=True)
    out = {"loss_rel": loss_rel, **{k: v[3] for k, v in devs.items()},
           **{f"{k} worst leaf": v[1] for k, v in devs.items()}, "card_s": gpu_s, "cpu_s": cpu_s,
           "tf32_control": {"loss_rel": loss_tf32, **{k: v[3] for k, v in devs_tf32.items()},
                            **{f"{k} worst leaf": v[1] for k, v in devs_tf32.items()}},
           "before_clip": pre, "f64_norm": f64["norm"], "dino_ce_grad": ce}
    assert not breaks(loss_rel, devs), out
    assert breaks(loss_tf32, devs_tf32), f"the bounds do not see TF32: {out}"
    return out


def phase_ssl(card, work_dir, profile=False):
    """pretrain_dinov3 at full ViT-L/16 width (the published recipe, 4
    iterations, the k-NN eval, the teacher export read back), a run resumed
    from its iteration-2 checkpoint against the straight one, the step with
    per-block recompute, one step in f32 against the CPU, one gram-anchored
    step on 512-px gram crops and one distillation step from a ViT-7B/16
    teacher; each new K1 and K2a/K2b shape timed and held against its plain
    version."""
    from omgsr_tpu_torch import hub
    from omgsr_tpu_torch.cli import pretrain_dinov3 as PD
    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.eval import probes
    from omgsr_tpu_torch.models.configs import VIT_SIZES
    from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply
    from omgsr_tpu_torch.training.checkpoint import restore_train_state
    from omgsr_tpu_torch.training.ssl_meta_arch import (
        copy_tree,
        init_center_state,
        init_ssl_student,
        make_distill_train_step,
        make_gram_ssl_train_step,
        make_ssl_train_step,
    )

    seen_all = {"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}
    counts_all, timings = {}, {}
    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "ssl")
    imgs, knn = write_ssl_images(root, 9000)
    free_gb = shutil.disk_usage(root).free / 1e9
    cfg = PD.load_ssl_config(SSL_RECIPE, ssl_args("x", imgs, knn)[2:])
    vit_cfg, mcfg = PD.vit_config(cfg), PD.meta_cfg(cfg)
    b, g, nl = cfg.batch_size_per_device, 2, cfg.local_crops_number
    k1_global, skv_g = vit_k1_shape(vit_cfg, g * b, cfg.global_crops_size)
    k1_local, skv_l = vit_k1_shape(vit_cfg, nl * b, cfg.local_crops_size)
    k1_knn, _ = vit_k1_shape(vit_cfg, 32, cfg.eval_crop_size)
    print(f"ssl: {SSL_IMAGES} images of 256-512 px and a 2 x {SSL_KNN_PER_CLASS} ImageFolder written; {free_gb:.1f} GB "
          f"free under the work directory; {os.path.basename(SSL_RECIPE)}: ViT-L/16 {vit_cfg.depth} blocks, width "
          f"{vit_cfg.embed_dim}, {vit_cfg.num_heads} heads of {vit_cfg.head_dim}; batch {b}, {g} x "
          f"{cfg.global_crops_size} px + {nl} x {cfg.local_crops_size} px, heads of {cfg.dino_out_dim} / "
          f"{cfg.ibot_out_dim} prototypes, {cfg.mixed_precision} over f32 masters", flush=True)

    # (1) the main path: pretrain_dinov3.main, 4 iterations from the recipe, the k-NN eval at the last
    out_a = os.path.join(root, "straight")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    # the k-NN vote's operands and result, as run_knn_eval hands them to eval/probes.knn_classify
    knn_devices, knn_classify = [], probes.knn_classify

    def knn_recorded(train_f, train_l, test_f, **kw):
        out = knn_classify(train_f, train_l, test_f, **kw)
        knn_devices.append({t.device.type for t in (train_f, train_l, test_f, *out.values())})
        return out

    probes.knn_classify = knn_recorded
    t0 = time.perf_counter()
    try:
        res_a, c = counted(seen_all, counts_all, lambda: PD.main(ssl_args(out_a, imgs, knn)), inference=False)
    finally:
        probes.knn_classify = knn_classify
    wall_a = time.perf_counter() - t0
    assert knn_devices and all(d == {"cuda"} for d in knn_devices), f"the k-NN vote ran on {knn_devices}"
    peak_a = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    hist = res_a["history"]
    assert [h["it"] for h in hist] == list(range(SSL_ITERS)), hist
    assert all(math.isfinite(h[k]) for h in hist for k in h if k.endswith("loss")), hist
    knn_n = 2 * vit_cfg.depth  # train and val features: one padded batch of 32 each, in f32
    per_it = {"flash_attention_fwd": 3 * vit_cfg.depth, "flash_attention_bwd_dq": 2 * vit_cfg.depth,
              "flash_attention_bwd_dkv": 2 * vit_cfg.depth}
    assert c["flash_attention_fwd"] == SSL_ITERS * per_it["flash_attention_fwd"] + knn_n, c
    assert c["flash_attention_bwd_dq"] == c["flash_attention_bwd_dkv"] == SSL_ITERS * per_it["flash_attention_bwd_dq"], c
    assert sum(c.values()) == c["flash_attention_fwd"] + 2 * c["flash_attention_bwd_dq"], c
    fn = seen_all["flash_n"]
    assert fn[(k1_global, skv_g, torch.bfloat16)] == SSL_ITERS * 2 * vit_cfg.depth, fn
    assert fn[(k1_local, skv_l, torch.bfloat16)] == SSL_ITERS * vit_cfg.depth, fn
    assert fn[(k1_knn, skv_g, torch.float32)] == knn_n, fn
    its = [h["iter_s"] for h in hist[1:]]
    waits = [h["loader_wait_s"] for h in hist]
    made = [h["loader_batch_s"] for h in hist]
    s_it = statistics.median(its)
    wait_it = statistics.median(waits[1:])
    accs = json.load(open(os.path.join(out_a, "eval", f"knn-{SSL_ITERS - 1}.json")))
    ckpt_gb = os.path.getsize(os.path.join(out_a, "checkpoints", "checkpoint-1.pt")) / 1e9
    timings["ssl main"] = {"wall_s": wall_a, "s_per_iteration": s_it, "iter_s": [h["iter_s"] for h in hist],
                           "loader_wait_s": waits, "loader_batch_s": made, "loader_share": wait_it / s_it, "peak_above_resident_gib": peak_a,
                           "checkpoint_gb": ckpt_gb, "knn": accs, "losses": [h["total_loss"] for h in hist]}
    print(f"ssl: pretrain_dinov3.main ({SSL_ITERS} iterations of the recipe, k-NN eval, 2 checkpoints of "
          f"{ckpt_gb:.2f} GB and teacher exports) in {wall_a:.1f} s; s per iteration {s_it:.4f} (median of iterations "
          f"2-{SSL_ITERS}, host clock to the logged metrics; all: " + ", ".join(f"{v:.4f}" for v in timings["ssl main"]
                                                                            ["iter_s"])
          + f"); the loader's wait {wait_it:.4f} s an iteration ({wait_it / s_it:.3f} of it; first "
          f"{waits[0]:.3f} s; its queue of two pre-filled, so a wait of 0 bounds nothing); the thread made each batch in "
          + ", ".join(f"{v:.4f}" for v in made) + f" s; device peak {peak_a:.2f} GiB above resident; total loss "
          + ", ".join(f"{v:.4f}" for v in timings["ssl main"]["losses"]) + f"; k-NN {accs} (the vote on the card); "
          f"launches per iteration "
          f"K1 {per_it['flash_attention_fwd']} (q{list(k1_global)} {2 * vit_cfg.depth}, q{list(k1_local)} "
          f"{vit_cfg.depth}), K2a {per_it['flash_attention_bwd_dq']}, K2b {per_it['flash_attention_bwd_dkv']}; the k-NN "
          f"eval K1 {knn_n} at q{list(k1_knn)} f32 [{card}]", flush=True)

    # the teacher export, read back into an init_dinov3_vit tree (the hub entry's) and run through the hub's apply
    m = hub.dinov3_vitl16(seed=0, dtype=torch.float32, device="cuda")
    back = restore_train_state(os.path.join(out_a, "eval", f"teacher-{SSL_ITERS - 1}", "backbone.pt"),
                               m.params["backbone"])
    same = all(torch.equal(x, y) for x, y in zip(flatten_dict(back).values(),
                                                 flatten_dict(res_a["teacher"]["backbone"]).values()))
    x = randn((2, 224, 224, 3), torch.float32, 9100)
    with torch.inference_mode():
        f_hub = m.apply(m.params, x)
        f_ref = dinov3_vit_apply(res_a["teacher"]["backbone"], vit_cfg, x)
    assert same and all(torch.equal(f_hub[k], f_ref[k]) for k in f_ref), "the teacher export does not read back"
    assert all(torch.isfinite(v).all() for v in f_hub.values())
    del m, back, f_hub, f_ref

    # (1b) a second run in a fresh directory resumed from the first run's iteration-2 checkpoint
    out_b = os.path.join(root, "resumed")
    os.makedirs(os.path.join(out_b, "checkpoints"))
    shutil.move(os.path.join(out_a, "checkpoints", "checkpoint-1.pt"), os.path.join(out_b, "checkpoints"))
    shutil.rmtree(out_a)
    t0 = time.perf_counter()
    res_b, c_b = counted(seen_all, counts_all, lambda: PD.main(ssl_args(out_b, imgs, knn)), inference=False)
    wall_b = time.perf_counter() - t0
    assert [h["it"] for h in res_b["history"]] == list(range(2, SSL_ITERS)), res_b["history"]
    loss_rel = max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(res_b["history"], hist[2:]) for k in y
                   if k.endswith("loss") and y[k] != 0)
    teacher_abs, teacher_rel = tree_diff(res_b["teacher"], res_a["teacher"])[:2]
    bits = loss_rel == 0 and teacher_abs == 0
    timings["ssl resume"] = {"wall_s": wall_b, "loss_rel": loss_rel, "teacher_max_abs": teacher_abs,
                             "teacher_rel_l2": teacher_rel, "bit_identical": bits}
    print(f"ssl: resumed from the iteration-2 checkpoint in a fresh directory ({wall_b:.1f} s): iterations 3-4's "
          f"losses within {loss_rel:.3g} relative of the straight run's (bound {SSL_RESUME_LOSS_REL}), the teacher "
          f"within {teacher_abs:.3g} max abs (bound {SSL_RESUME_TEACHER_ABS}), rel L2 {teacher_rel:.3g}"
          + ("; the same bits" if bits else "") + f" [{card}]", flush=True)
    assert loss_rel <= SSL_RESUME_LOSS_REL and teacher_abs <= SSL_RESUME_TEACHER_ABS, timings["ssl resume"]
    shutil.rmtree(out_b)
    del res_a
    gc.collect()
    torch.cuda.empty_cache()

    # (2) the step without and with per-block recompute, on the resumed run's state and one batch of its loader
    student, teacher, opt_state, centers = res_b["student"], res_b["teacher"], res_b["opt"], res_b["centers"]
    del res_b
    opt = PD.build_ssl_optimizer(cfg, vit_cfg, student)
    loader = PD.SSLLoader(dataclasses.replace(cfg, output_dir=root), start_iter=SSL_ITERS)
    try:
        batch = PD.batch_to_device(next(loader), "cuda", torch.bfloat16)
    finally:
        loader.close()
    steps = {}
    for remat in (False, True):
        vc = dataclasses.replace(vit_cfg, remat_blocks=remat)
        step = make_ssl_train_step(opt, cfg=mcfg, vit_cfg=vc)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        secs, cs = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            out, c = counted(seen_all, counts_all, lambda: step(student, teacher, opt_state, centers, batch,
                                                                 **SSL_STEP), inference=False)
            secs.append(time.perf_counter() - t0)
            cs.append(c)
            assert math.isfinite(float(out[4]["total_loss"])), out[4]
        k1 = (5 if remat else 3) * vit_cfg.depth
        assert all(c["flash_attention_fwd"] == k1 and c["flash_attention_bwd_dq"] == c["flash_attention_bwd_dkv"]
                   == 2 * vit_cfg.depth for c in cs), cs
        steps[remat] = {"s_per_step": statistics.median(secs[1:]), "peak_above_resident_gib":
                        (torch.cuda.max_memory_allocated() - resident) / 2 ** 30, "k1_per_step": k1}
        del out
    # the same step behind the CLI's loader thread (a batch taken and copied each step). The thread first fills
    # its queue of two and makes a third batch while this thread sleeps: the seconds a batch takes alone. Then
    # SSL_LOADER_STEPS steps: once the pre-filled batches are used up (the first three steps), each wait is what
    # the thread's rate leaves, with no checkpoint or eval inside the window
    loader = PD.SSLLoader(dataclasses.replace(cfg, output_dir=root), start_iter=SSL_ITERS + 1)
    step = make_ssl_train_step(opt, cfg=mcfg, vit_cfg=vit_cfg)
    secs = []
    try:
        t_fill = time.perf_counter()
        while len(loader.batch_s) < 3 and time.perf_counter() - t_fill < 60:
            time.sleep(0.005)
        alone = list(loader.batch_s[:3])
        for _ in range(SSL_LOADER_STEPS):
            t0 = time.perf_counter()
            batch_i = PD.batch_to_device(next(loader), "cuda", torch.bfloat16)
            out = step(student, teacher, opt_state, centers, batch_i, **SSL_STEP)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        beside = list(loader.batch_s[3:SSL_LOADER_STEPS])
    finally:
        loader.close()
    assert len(alone) == 3 and beside, (alone, beside)
    steady = slice(3, SSL_LOADER_STEPS)
    steps["loader_batch_alone_s"] = statistics.median(alone)
    steps["loader_batch_beside_step_s"] = statistics.median(beside)
    steps["with_loader_s_per_step"] = statistics.median(secs[steady])
    steps["with_loader_wait_s"] = statistics.median(loader.wait_s[steady])
    steps["with_loader_wait_share"] = steps["with_loader_wait_s"] / steps["with_loader_s_per_step"]
    del out, batch_i
    timings["ssl recompute"] = steps
    print(f"ssl: the loader thread makes a batch ({b} images, {g + nl} crops each) in "
          + ", ".join(f"{v:.4f}" for v in alone) + f" s with this thread asleep (median "
          f"{steps['loader_batch_alone_s']:.4f}), " + ", ".join(f"{v:.4f}" for v in beside) + " s beside the steps "
          f"(median {steps['loader_batch_beside_step_s']:.4f}); {SSL_LOADER_STEPS} steps behind it, a batch taken, "
          f"copied and stepped each (synced): " + ", ".join(f"{v:.4f}" for v in secs) + f" s; steps 4-"
          f"{SSL_LOADER_STEPS} (the pre-filled batches used up) {steps['with_loader_s_per_step']:.4f} s a step, "
          f"the wait for the batch {steps['with_loader_wait_s']:.4f} s ({steps['with_loader_wait_share']:.3f} of "
          f"the step; all waits " + ", ".join(f"{v:.4f}" for v in loader.wait_s) + f") [{card}]", flush=True)
    print(f"ssl: one step (synced) without recompute {steps[False]['s_per_step']:.4f} s, peak "
          f"{steps[False]['peak_above_resident_gib']:.2f} GiB above resident, K1 {steps[False]['k1_per_step']}; with "
          f"vit: {{remat_blocks: true}} {steps[True]['s_per_step']:.4f} s, peak "
          f"{steps[True]['peak_above_resident_gib']:.2f} GiB, K1 {steps[True]['k1_per_step']} (the blocks' forwards "
          f"again in the backward); K2a / K2b {2 * vit_cfg.depth} each [{card}]", flush=True)
    if profile:
        from torch.autograd import DeviceType

        from omgsr_tpu_torch.utils.observability import trace

        step = make_ssl_train_step(opt, cfg=mcfg, vit_cfg=vit_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace(os.path.join(work_dir, "ssl_trace")) as prof:
            step(student, teacher, opt_state, centers, batch, **SSL_STEP)
            torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                n, tt = by_kernel.get(e.key, (0, 0.0))
                by_kernel[e.key] = (n + e.count, tt + (e.self_cuda_time_total if us is None else us))
        busy = sum(tt for _, tt in by_kernel.values()) / 1e3
        step_ms = steps[False]["s_per_step"] * 1e3
        timings["ssl recompute"][False].update(busy_ms=busy, idle_share=1 - busy / step_ms, traced_ms=traced_ms)
        print(f"profile: ssl one step traced by utils.observability.trace: kernels busy {busy:.2f} ms of "
              f"{step_ms:.2f} ms a step untraced (idle share {1 - busy / step_ms:.3f}; the traced step took "
              f"{traced_ms:.1f} ms) [{card}]", flush=True)
        groups = {}
        for k, (n, tt) in by_kernel.items():
            low = k.lower()
            grp = ("K1 flash_fwd" if "flash_fwd" in low else "K2a/K2b flash_bwd" if "flash_bwd" in low
                   else "GEMM (cuBLAS / CUTLASS)" if any(w in low for w in ("gemm", "xmma", "cutlass", "wgmma",
                                                                             "nvjet"))
                   else "optimizer / EMA (multi-tensor)" if "multi_tensor_apply" in low
                   else "copies and casts" if "copy" in low or "catarray" in low
                   else "reductions" if "reduce" in low or "norm" in low or "softmax" in low
                   else "elementwise" if "elementwise" in low else "other")
            gn, gt = groups.get(grp, (0, 0.0))
            groups[grp] = (gn + n, gt + tt)
        timings["ssl recompute"][False]["kernel_ms_by_group"] = {k: v[1] / 1e3 for k, v in groups.items()}
        for k, (n, tt) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
            print(f"profile: ssl group {tt / 1e3:8.3f} ms {tt / 1e3 / busy:6.1%} {n:6d} launches  {k}", flush=True)
        for k, (n, tt) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:12]:
            print(f"profile: ssl {tt / 1e3:8.3f} ms {tt / 1e3 / busy:6.1%} {n:5d} x {k[:90]}", flush=True)

    # (3) one gram-anchored step: a frozen gram backbone on 512-px gram crops, its 32 x 32 grid resized to 14 x 14
    gram_cfg = dataclasses.replace(mcfg, gram_loss_weight=1.0)
    gram_backbone = copy_tree(teacher["backbone"])
    batch_g = dict(batch, gram_teacher_crops=randn((g * b, 512, 512, 3), torch.bfloat16, 9200))
    k1_gram, skv_gram = vit_k1_shape(vit_cfg, g * b, 512)
    gram_step = make_gram_ssl_train_step(opt, cfg=gram_cfg, vit_cfg=vit_cfg)
    t0 = time.perf_counter()
    out, c = counted(seen_all, counts_all, lambda: gram_step(student, teacher, gram_backbone, opt_state, centers,
                                                             batch_g, **SSL_STEP), inference=False)
    gram_s = time.perf_counter() - t0
    gram = float(out[4]["gram_loss"])
    assert math.isfinite(gram) and gram > 0 and math.isfinite(float(out[4]["total_loss"])), out[4]
    assert c["flash_attention_fwd"] == 4 * vit_cfg.depth and c["flash_attention_bwd_dq"] == 2 * vit_cfg.depth, c
    assert seen_all["flash_n"][(k1_gram, skv_gram, torch.bfloat16)] == vit_cfg.depth
    timings["ssl gram"] = {"s": gram_s, "gram_loss": gram}
    print(f"ssl: make_gram_ssl_train_step: gram crops 512 px (K1 at q{list(k1_gram)}, {vit_cfg.depth} launches), "
          f"the 32 x 32 patch grid resized to 14 x 14; gram loss {gram:.5f}, total {float(out[4]['total_loss']):.4f}; "
          f"{gram_s:.3f} s; launches {c} [{card}]", flush=True)
    del out, gram_backbone, batch_g

    # (4) one step in f32 on the card (TF32 off) against the same step on the CPU, ViT-L width at depth 2,
    # 65,536 prototypes, batch 2 (the first two samples of the batch above; crop c of sample i is row c * B + i)
    rows_g = [c_ * b + i for c_ in range(g) for i in range(2)]
    rows_l = [c_ * b + i for c_ in range(nl) for i in range(2)]
    b32 = {"global_crops": batch["global_crops"][rows_g].float().cpu(),
           "local_crops": batch["local_crops"][rows_l].float().cpu(), "masks": batch["masks"][rows_g].cpu()}
    timings["ssl f32"] = ssl_f32_against_cpu(card, cfg, mcfg, vit_cfg, b32, seen_all, counts_all)
    del student, teacher, opt_state, batch, b32
    gc.collect()
    torch.cuda.empty_cache()

    # (5) one distillation step: the published distilled recipe's student (ViT-L, batch 3, 256 / 112 px, heads of
    # 262,144 and 98,304 prototypes) under a frozen ViT-7B/16 teacher at full width, stored in f32 as
    # run_pretraining holds it (each layer casts its weights to the bf16 crops' dtype at the call)
    dcfg = PD.load_ssl_config(SSL_DISTILLED, [f"dataset_paths={imgs}", f"output_dir={root}"])
    d_meta, s_vit = PD.meta_cfg(dcfg), PD.vit_config(dcfg)
    t_vit = dataclasses.replace(VIT_SIZES[dcfg.distillation_arch], depth=SSL_DISTILL_TEACHER_DEPTH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_student = init_ssl_student(80, s_vit, d_meta, init_dinov3_vit, torch.float32, "cuda")
    d_teacher = init_ssl_student(81, t_vit, d_meta, init_dinov3_vit, torch.float32, "cuda")
    teacher_gib = sum(v.numel() * v.element_size() for v in flatten_dict(d_teacher).values()) / 2 ** 30
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    d_ema = copy_tree(d_student)
    d_opt = PD.build_ssl_optimizer(dcfg, s_vit, d_student)
    d_state = d_opt.init(d_student)
    d_centers = init_center_state(d_meta, "cuda")
    loader = PD.SSLLoader(dcfg)
    try:
        d_batch = PD.batch_to_device(next(loader), "cuda", torch.bfloat16)
    finally:
        loader.close()
    db = dcfg.batch_size_per_device
    k1_t, skv_t = vit_k1_shape(t_vit, g * db, dcfg.global_crops_size)
    k1_s, _ = vit_k1_shape(s_vit, g * db, dcfg.global_crops_size)
    k1_sl, _ = vit_k1_shape(s_vit, nl * db, dcfg.local_crops_size)
    d_step = make_distill_train_step(d_opt, cfg=d_meta, vit_cfg=s_vit, teacher_vit_cfg=t_vit)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    before = d_teacher["dino_head"]["last_layer"]["weight"][:4].clone()
    out, c = counted(seen_all, counts_all, lambda: d_step(d_student, d_teacher, d_ema, d_state, d_centers, d_batch,
                                                          **SSL_STEP), inference=False)
    d_s = time.perf_counter() - t0
    d_peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    assert math.isfinite(float(out[4]["total_loss"])), out[4]
    assert torch.equal(before, d_teacher["dino_head"]["last_layer"]["weight"][:4]), "the frozen teacher moved"
    assert c["flash_attention_fwd"] == t_vit.depth + 2 * s_vit.depth, c
    assert c["flash_attention_bwd_dq"] == c["flash_attention_bwd_dkv"] == 2 * s_vit.depth, c
    params_b = (count_params(d_teacher) / 1e9, count_params(d_student) / 1e9)
    timings["ssl distill"] = {"s": d_s, "init_s": init_s, "peak_above_resident_gib": d_peak,
                              "teacher_depth": t_vit.depth, "teacher_gib": teacher_gib, "losses": {k: float(v) for k, v in out[4].items()}}
    print(f"ssl: make_distill_train_step: student ViT-L ({params_b[1]:.3f}B with heads of {d_meta.dino_out_dim} / "
          f"{d_meta.ibot_out_dim} prototypes, f32 masters), frozen ViT-7B/16 teacher at width {t_vit.embed_dim} and "
          f"{t_vit.depth} of 40 blocks ({params_b[0]:.3f}B, {teacher_gib:.2f} GiB resident in f32, computing in bf16), batch {db}, {dcfg.global_crops_size} / "
          f"{dcfg.local_crops_size} px: total loss {float(out[4]['total_loss']):.4f}; drawn in {init_s:.1f} s, the "
          f"step {d_s:.3f} s, peak {d_peak:.2f} GiB above resident; K1 at q{list(k1_t)} {t_vit.depth}, "
          f"q{list(k1_s)} {s_vit.depth}, q{list(k1_sl)} {s_vit.depth} [{card}]", flush=True)
    del out, d_student, d_teacher, d_ema, d_state, d_batch, d_opt
    gc.collect()
    torch.cuda.empty_cache()

    # each new bf16 shape timed and held against its plain version, with the ViT's operands; SDPA as the library
    fwd_rows, bwd_rows = [], {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    fwd_shapes = [(k1_global, "globals"), (k1_local, "locals"), (k1_gram, "gram crops"), (k1_t, "7B teacher"),
                  (k1_s, "distilled globals"), (k1_sl, "distilled locals")]
    for i, (shape, what) in enumerate(fwd_shapes):
        key = (shape, shape[1], torch.bfloat16)
        n = seen_all["flash_n"].get(key, 0)
        r = check_flash(shape, shape[1], torch.bfloat16, 9300 + 10 * i, packed="v")
        r.update(on_ssl_path=True, ssl_launches=n, ssl_site=what)
        HELD["flash"].add(key)
        fwd_rows.append(r)
        print(f"ssl: flash_attention_fwd {r['shape']} ({what}; {n} launches in the phase): err {r['max_abs_err']:.3g} "
              f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[torch.bfloat16]:.3g}) lse err "
              f"{r['max_abs_err_lse']:.3g}, two runs bit-identical; {r['ms']:.4f} ms ({r['bound_share']:.3f} of the "
              f"bound), plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f} (SDPA {r['library_backend']}), bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}) [{card}]", flush=True)
    for i, (shape, what) in enumerate([(k1_global, "globals"), (k1_local, "locals"), (k1_s, "distilled globals"),
                                       (k1_sl, "distilled locals")]):
        key = (shape, shape[1], torch.bfloat16)
        n = seen_all["bwd_n"].get(key, 0)
        for name, r in check_flash_bwd(shape, shape[1], torch.bfloat16, 9400 + 10 * i, packed="v").items():
            r.update(on_ssl_path=True, ssl_launches=n, ssl_site=what)
            bwd_rows[name].append(r)
            print(f"ssl: {name} {r['shape']} ({what}; {n} launches in the phase): err {r['max_abs_err']:.3g} "
                  f"({r['max_err_over_max_ref']:.3g} of max |plain|, bound {TOL[torch.bfloat16]:.3g}), two runs "
                  f"bit-identical; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library (dq+dk+dv, SDPA "
                  f"{r['library_backend']}) {r['library_ms']:.4f}, bound {r['bound_ms']:.5f} ({r['bound_by']})"
                  + (f", q loop in {r['q_loop_splits']} chunks" if "q_loop_splits" in r else "") + f" [{card}]",
                  flush=True)
        HELD["bwd"].add(key)
    report_launch_shapes("ssl", "SSL pretraining", seen_all, 20000)
    timings["ssl phase_s"] = time.perf_counter() - t_phase
    print(f"ssl: launches {counts_all}; the phase took {timings['ssl phase_s']:.1f} s", flush=True)
    shutil.rmtree(root)
    return counts_all, timings, fwd_rows, bwd_rows


# ----------------------------------------------------------------------------
# phase: drill (cli.fire_drill at the published SD2.1 architecture and FLUX at full depth)
# ----------------------------------------------------------------------------


def phase_drill(card, work_dir):
    """fire_drill.main --family sd (the SD2.1 VAE and UNet in f32, 2 GB shards
    with an index) and --family flux (19 + 38 blocks at width 512, bf16) on the
    card: fabricate, the infer CLI, eval_sr, the adapter round trip and
    validate_checkpoint against the CPU reference; each must pass."""
    from omgsr_tpu_torch.cli import fire_drill

    seen_all = {"flash": set(), "flash_n": {}, "bwd_n": {}, "gn": {}}
    counts_all, timings = {}, {}
    for family in ("sd", "flux"):
        root = os.path.join(work_dir, f"drill_{family}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        report, c = counted(seen_all, counts_all, lambda: fire_drill.main(
            ["--family", family, "--root", root, "--device", "cuda"]), inference=False)
        wall = time.perf_counter() - t0
        st = report["stages"]
        assert report["passed"] and report["worst_parity_max_rel"] <= 1e-3 and st["adapter_roundtrip_exact"], report
        assert c["flash_attention_fwd"] > 0 and c["group_norm_stats"] > 0 and c["group_norm_apply"] > 0, c
        assert c["flash_attention_bwd_dq"] == c["flash_attention_bwd_dkv"] == 0, c
        summary = st["eval_sr"]["summary"]
        assert all(math.isfinite(summary[k]) for k in ("psnr_mean", "ssim_mean", "dists_mean", "lpips_mean",
                                                         "niqe_mean")), summary
        parity = {k: v["max_rel"] for k, v in st["torch_parity"].items() if "max_rel" in v}
        timings[f"drill {family}"] = {"wall_s": wall, "worst_parity_max_rel": report["worst_parity_max_rel"],
                                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                                      **{k: v for k, v in st.items() if k.endswith("_s")}}
        print(f"drill: fire_drill --family {family}: passed, worst parity max_rel "
              f"{report['worst_parity_max_rel']:.3g} (bound 1e-3; " + ", ".join(f"{k} {v:.3g}" for k, v in parity.items())
              + f"); files {st['checkpoint_files']}; stages fabricate {st['fabricate_s']} s, port and infer "
              f"{st['port_and_infer_s']} s, eval_sr {st['eval_sr_s']} s, adapter round trip "
              f"{st['adapter_roundtrip_s']} s, torch parity {st['torch_parity_s']} s; {wall:.1f} s in all, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {c} [{card}]", flush=True)
        shutil.rmtree(root)
        gc.collect()
        torch.cuda.empty_cache()
    report_launch_shapes("drill", "the fire drills", seen_all, 19000)
    return counts_all, timings


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
     ["flash_bwd_dq_wgmma_kernel", "flash_bwd_dq_wide_wgmma_kernel", "flash_bwd_dq_kernel"]),
    ("flash_attention_bwd_dkv", "omgsr_tpu_torch/csrc/flash_attention_bwd.cu",
     "omgsr_tpu/ops/flash_attention.py:127",
     ["flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_reduce_kernel", "flash_bwd_dkv_wide_wgmma_kernel",
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
    t_start = time.perf_counter()
    phase_s, last = {}, [t_start]

    def done(phase):
        """Each phase's wall seconds, printed as it ends."""
        now = time.perf_counter()
        phase_s[phase] = now - last[0]
        last[0] = now
        print(f"clock: phase {phase} {phase_s[phase]:.1f} s, {now - t_start:.1f} s since the build began", flush=True)

    t0 = time.perf_counter()
    built = build_kernels(kernel_sources(), verbose=True)
    for name, path in built.items():
        assert path.exists(), path
    print(f"build: {sorted(built)} compiled by nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    shapes = phase_kernels()
    done("build+kernels")
    vae_params, unet_params = init_sd21(torch.bfloat16)
    serve_counts, timings = phase_serve(card, vae_params, unet_params, args.profile)
    done("serve")
    fused_counts, fused_timings = phase_serve_fused(card, vae_params, unet_params, args.profile)
    done("serve-fused")
    with tempfile.TemporaryDirectory() as work_dir:
        train_counts, train_timings, export = phase_train(card, vae_params, unet_params, work_dir, args.profile)
        done("train")
        tiled_counts, tiled_timings = phase_serve_tiled(card, vae_params, unet_params)
        done("serve-tiled")
        load_counts, load_timings, ckpt = phase_load(card, vae_params, unet_params, export, work_dir)
        done("load")
        data_counts, data_timings = phase_data(card, work_dir, ckpt, os.path.join(work_dir, "train", "metrics.jsonl"))
        done("data")
        flux_vae, flux_params = init_flux_dev(torch.bfloat16)
        serve_f_counts, serve_f_timings = phase_serve_f(card, flux_vae, flux_params, args.profile)
        done("serve-f")
        gc.collect()
        torch.cuda.empty_cache()
        quant_f_counts, quant_f_timings = phase_quant_f(card, flux_vae, flux_params, work_dir)
        done("quant-f")
        gc.collect()
        torch.cuda.empty_cache()
        train_f_counts, train_f_timings, f_export = phase_train_f(card, flux_vae, flux_params, work_dir, args.profile)
        done("train-f")
        gc.collect()
        torch.cuda.empty_cache()
        load_f_counts, load_f_timings = phase_load_f(card, flux_vae, flux_params, work_dir, f_export)
        done("load-f")
        gc.collect()
        torch.cuda.empty_cache()
        cli_counts, cli_timings = quant_f_cli(card, work_dir)
        quant_f_counts = {k: quant_f_counts.get(k, 0) + v for k, v in cli_counts.items()}
        done("quant-f cli")
        reset_counts()
        eval_timings = phase_eval(card, work_dir)
        eval_counts = read_counts()  # no kernel of the seven is on the eval path
        assert not any(eval_counts.values()), eval_counts
        done("eval")
        shard_counts, shard_timings = phase_shard(card, vae_params, unet_params, flux_vae, flux_params,
                                                  ckpt["sd_path"], export["dir"], work_dir)
        done("shard")
        train_dist_timings = {}
        f_ref, td_counts, td_seen = train_dist_one_rank(card, vae_params, unet_params, flux_vae, flux_params, work_dir,
                                                        train_dist_timings)
        del flux_vae, flux_params  # the -F weights: 23.8 GB, freed before two ranks share the card
        gc.collect()
        torch.cuda.empty_cache()
        td_counts2, td_seen2 = train_dist_worlds(card, vae_params, unet_params, work_dir, f_ref, train_dist_timings)
        train_dist_counts = phase_train_dist_report(td_counts, td_seen, td_counts2, td_seen2)
        done("train-dist")
        dinov3_counts, dinov3_timings, dinov3_rows = phase_dinov3(card, work_dir, args.profile)
        shapes["flash_attention_fwd"] += dinov3_rows
        done("dinov3")
        ssl_counts, ssl_timings, ssl_fwd_rows, ssl_bwd_rows = phase_ssl(card, work_dir, args.profile)
        shapes["flash_attention_fwd"] += ssl_fwd_rows
        for name, rows in ssl_bwd_rows.items():
            shapes[name] += rows
        done("ssl")
        drill_counts, drill_timings = phase_drill(card, work_dir)
        done("drill")
    for more in (fused_timings, train_timings, tiled_timings, load_timings, data_timings, serve_f_timings,
                 quant_f_timings, train_f_timings, load_f_timings, cli_timings, eval_timings, shard_timings,
                 train_dist_timings, dinov3_timings, ssl_timings, drill_timings):
        timings.update(more)

    kernels = []
    for name, source, replaces, cuda_kernels in KERNELS:
        head = shapes[name][0]  # the largest shape of the serving and training paths
        on_path = [r for r in shapes[name]
                   if r.get("on_serving_path") or r.get("on_training_path") or r.get("on_dinov3_path")
                   or r.get("on_ssl_path")] or shapes[name]
        launches_serve, launches_train = serve_counts.get(name, 0), train_counts[name]
        launches_fused, launches_tiled = fused_counts.get(name, 0), tiled_counts.get(name, 0)
        launches_load, launches_data = load_counts.get(name, 0), data_counts.get(name, 0)
        launches_serve_f, launches_load_f = serve_f_counts.get(name, 0), load_f_counts.get(name, 0)
        launches_train_f = train_f_counts.get(name, 0)
        launches_quant_f = quant_f_counts.get(name, 0)
        launches_shard = shard_counts.get(name, 0)
        launches_train_dist = train_dist_counts.get(name, 0)
        launches_dinov3, launches_drill = dinov3_counts.get(name, 0), drill_counts.get(name, 0)
        launches_ssl = ssl_counts.get(name, 0)
        launches = (launches_serve + launches_fused + launches_train + launches_tiled + launches_load + launches_data
                    + launches_serve_f + launches_quant_f + launches_train_f + launches_load_f + launches_shard
                    + launches_train_dist + launches_dinov3 + launches_ssl + launches_drill)
        # the ViTs run K1 alone, SSL pretraining K1 and K2a/K2b (head dims 64 and 128: no merge); the drills' VAE,
        # UNet and DiT K1 and K3a/K3b, no fused resblock, no backward
        if name == "flash_attention_fwd":
            assert launches_dinov3 > 0 and launches_drill > 0 and launches_ssl > 0, name
        elif "bwd" in name:
            assert launches_ssl > 0 and launches_dinov3 == launches_drill == 0, name
        elif name.startswith("group_norm"):
            assert launches_drill > 0 and launches_dinov3 == launches_ssl == 0, name
        elif name != "flash_attention_fwd_merge":
            assert launches_dinov3 == launches_drill == launches_ssl == 0, name
        else:
            assert launches_ssl == 0, name
        if name in OFF_PATH:
            assert launches == 0, name
        elif name.startswith("conv3x3"):
            assert launches_fused > 0 and launches_serve == launches_train == launches_load == launches_data == 0, name
            assert launches_serve_f == launches_quant_f == launches_train_f == launches_load_f == 0, name
            assert launches_shard == 0, name  # the sharded VAE runs no fused resblock, as in the JAX package
            assert launches_train_dist == 0, name  # nor does training
        elif name == "flash_attention_fwd_merge":  # the 512-px bf16 mid heads split their kv loop
            assert min(launches_serve, launches_fused, launches_train, launches_load, launches_data) > 0, name
        elif "bwd" in name:  # training only: -S in train and data, -F in train-f and load-f's train_omgsr_f.main
            assert min(launches_train, launches_data, launches_train_f, launches_load_f, launches_quant_f,
                       launches_train_dist) > 0, name
            assert launches_serve_f == 0, name
        else:
            assert min(launches_train, launches_data, launches_serve, launches_fused, launches_load,
                       launches_serve_f, launches_quant_f, launches_train_f, launches_load_f, launches_shard,
                       launches_train_dist) > 0, name
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "cuda_kernels": cuda_kernels,
            "launches": launches,
            "launches_serve": launches_serve, "launches_serve_fused": launches_fused,
            "launches_train": launches_train, "launches_serve_tiled": launches_tiled, "launches_load": launches_load,
            "launches_data": launches_data, "launches_serve_f": launches_serve_f,
            "launches_quant_f": launches_quant_f, "launches_train_f": launches_train_f,
            "launches_load_f": launches_load_f, "launches_eval": eval_counts.get(name, 0),
            "launches_shard": launches_shard, "launches_train_dist": launches_train_dist,
            "launches_dinov3": launches_dinov3, "launches_ssl": launches_ssl, "launches_drill": launches_drill,
            "on_a_path": name not in OFF_PATH,
            "max_abs_err": max(r["max_abs_err"] for r in on_path),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "shapes": shapes[name],
        })
    timings["phase_s"] = phase_s
    print(json.dumps({"timings": timings, "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
