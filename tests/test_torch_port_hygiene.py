"""The port imports torch, never jax and nothing of omgsr_tpu; its entry
points run on the GPU unless the caller asks for the CPU."""

import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import omgsr_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

def _module_names():
    names = ["omgsr_tpu_torch"]
    for m in pkgutil.walk_packages(omgsr_tpu_torch.__path__, "omgsr_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    names = _module_names()
    assert len(names) > 35
    for sub in ("config", "lora.lora", "losses.dists", "losses.diffaug", "losses.discriminator",
                "models.convnext", "training.optim", "training.trainer", "training.checkpoint",
                "cli.train_omgsr_s", "utils.tree", "ops.conv3x3", "tools.check_conv3x3",
                "inference.tiled_vae", "inference.vae_routing", "convert.safetensors_io", "convert.hf_config",
                "convert.porters", "lora.adapter_io", "models.clip_text", "models.clip_tokenizer", "cli.prompts",
                "inference.batch_runner", "cli.infer_omgsr_s", "tools.sd_checkpoint", "data.kernels",
                "data.degradation", "data.dataset", "data.imgdec_native", "ops.filters", "ops.resize", "ops.noise",
                "ops.diffjpeg", "diffusion.calibration", "cli.mid_timestep_sd", "models.flux",
                "diffusion.packing", "inference.pipeline_f", "cli.infer_omgsr_f", "cli.mid_timestep_flux",
                "tools.flux_checkpoint", "models.t5", "models.t5_tokenizer", "cli.train_omgsr_f",
                "utils.quantize", "utils.metrics", "utils.niqe", "utils.lpips", "models.clip_vision",
                "cli.eval_sr", "parallel", "parallel.distributed", "parallel.sharding", "models.dinov3_vit", "hub",
                "utils.observability", "cli.validate_checkpoint", "cli.fire_drill", "losses.ssl", "training.ssl",
                "training.ssl_meta_arch", "data.ssl", "data.datasets", "eval.probes", "cli.pretrain_dinov3"):
        assert f"omgsr_tpu_torch.{sub}" in names, sub
    code = (
        "import importlib, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'omgsr_tpu' or m.startswith('omgsr_tpu.')]\n"
        "assert not bad, bad\n"
        "# the load path carries its own safetensors reader and CLIP tokenizer: the card lacks these\n"
        "absent = ('safetensors', 'transformers', 'tokenizers', 'regex', 'ftfy')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in absent]\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules, 'PIL must be imported lazily'\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'yaml' not in sys.modules, 'yaml must be imported where a file is read or written'\n"
        "print('imported', len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"imported {len(names)}" in r.stdout


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "omgsr_tpu_torch").rglob("*.py")))
def test_sources_name_neither_jax_nor_the_jax_package(path):
    src = (ROOT / path).read_text()
    imports = [l for l in src.splitlines() if re.match(r"\s*(import|from)\s", l)]
    for line in imports:
        assert not re.search(r"\b(jax|jaxlib|flax|optax)\b", line), (path, line)
        assert not re.search(r"\bomgsr_tpu\b(?!_torch)", line), (path, line)
    # finished-kernel routes the port must not take
    for banned in ("scaled_dot_product_attention", "torch.compile", "F.group_norm(", "torch.group_norm(",
                   "nn.GroupNorm", "spectral_norm("):
        if path != "chip_smoke.py":  # the smoke script times them as yardsticks only
            assert banned not in src, (path, banned)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device works here")


def test_entry_points_raise_without_cuda(tmp_path):
    _no_cuda()
    from omgsr_tpu_torch.cli import infer_omgsr_f, infer_omgsr_s, mid_timestep_flux, mid_timestep_sd, serve, \
        train_omgsr_f, train_omgsr_s
    from omgsr_tpu_torch.data.dataset import PairedDataset, PairedLoader
    from omgsr_tpu_torch.cli.prompts import encode_prompt_flux, encode_prompt_sd
    from omgsr_tpu_torch.config import TrainConfig
    from omgsr_tpu_torch.convert import porters
    from omgsr_tpu_torch.lora import adapter_io
    from omgsr_tpu_torch.models.clip_text import init_clip_text
    from omgsr_tpu_torch.models.configs import SD21_CLIP
    from omgsr_tpu_torch.convert.params import (
        from_jax_tree,
        init_convnext,
        init_discriminator,
        init_flux,
        init_t5_encoder,
        init_unet,
        init_vae,
    )
    from omgsr_tpu_torch.inference.pipeline_f import OMGSRFPipeline
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models.configs import ConvNeXtConfig, FluxConfig, T5Config, UNetConfig, VAEConfig
    from omgsr_tpu_torch.serving import SRServer
    from omgsr_tpu_torch.serving.server import make_fused_infer
    from omgsr_tpu_torch.cli import eval_sr
    from omgsr_tpu_torch.models.clip_vision import CLIP_L_VISION, init_clip_vision
    from omgsr_tpu_torch.utils.lpips import init_lpips
    from omgsr_tpu_torch.utils.quantize import init_flux_quantized, quantize_flux_for_serving
    from omgsr_tpu_torch.tools import multiproc_check
    from omgsr_tpu_torch import hub
    from omgsr_tpu_torch.cli import fire_drill, validate_checkpoint
    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.models.configs import DinoV3ViTConfig
    from omgsr_tpu_torch.cli import pretrain_dinov3
    from omgsr_tpu_torch.training.ssl import init_dino_head
    from omgsr_tpu_torch.training.ssl_meta_arch import SSLMetaConfig, init_center_state, init_ssl_student

    vit_cfg = DinoV3ViTConfig(embed_dim=64, depth=1, num_heads=1)
    vc = VAEConfig(block_out_channels=(8, 16), norm_num_groups=4)
    uc = UNetConfig(block_out_channels=(8, 16, 16, 16), num_attention_heads=(1, 2, 2, 2),
                    cross_attention_dim=16, norm_num_groups=4)
    vp, up = init_vae(0, vc, device="cpu"), init_unet(1, uc, device="cpu")
    fc = FluxConfig(num_layers=1, num_single_layers=1, attention_head_dim=8, num_attention_heads=2,
                    joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(2, 4, 2))
    fp = init_flux(2, fc, device="cpu")
    calls = {
        "init_vae": lambda: init_vae(0, vc),
        "init_unet": lambda: init_unet(0, uc),
        "from_jax_tree": lambda: from_jax_tree({"kernel": np.zeros((2, 3), np.float32)}),
        "init_convnext": lambda: init_convnext(0, ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 8, 8, 8))),
        "init_discriminator": lambda: init_discriminator(0, (8, 8, 8)),
        "run_training": lambda: train_omgsr_s.run_training(
            TrainConfig(output_dir=str(tmp_path)), frozen={}, loader=[]),
        "pipeline": lambda: OMGSRSPipeline(vp, up, vc, uc),
        "tiled pipeline": lambda: OMGSRSPipeline(vp, up, vc, uc, vae_tile=64, vae_stats="exact"),
        "server": lambda: SRServer(lambda lq, i: lq),
        "fused": lambda: make_fused_infer(lambda lq, i: lq, torch.float32),
        "build_server": lambda: serve.build_server(
            serve.parse_args([]), params=(vp, up), configs=(vc, uc),
            prompt_embeds=np.zeros((1, 7, 16), np.float32)),
        "build_server --vae_tile": lambda: serve.build_server(
            serve.parse_args(["--vae_tile", "64", "--vae_stats", "auto"]), params=(vp, up), configs=(vc, uc),
            prompt_embeds=np.zeros((1, 7, 16), np.float32)),
        # the load path: each raises before it reads a file
        "infer_omgsr_s.main": lambda: infer_omgsr_s.main(infer_omgsr_s.parse_args(
            ["--input_image", str(tmp_path), "--output_dir", str(tmp_path), "--sd_path", str(tmp_path)])),
        "build_server --sd_path": lambda: serve.build_server(serve.parse_args(["--sd_path", str(tmp_path)])),
        "port_diffusers_vae": lambda: porters.port_diffusers_vae(str(tmp_path)),
        "port_diffusers_unet": lambda: porters.port_diffusers_unet(str(tmp_path)),
        "port_clip_text": lambda: porters.port_clip_text(str(tmp_path)),
        "port_dinov3_convnext": lambda: porters.port_dinov3_convnext(str(tmp_path / "x.pth")),
        "encode_prompt_sd": lambda: encode_prompt_sd(str(tmp_path), "a cat"),
        "load_adapter": lambda: adapter_io.load_adapter(str(tmp_path)),
        "import_peft_adapter": lambda: adapter_io.import_peft_adapter(str(tmp_path)),
        "init_clip_text": lambda: init_clip_text(0, SD21_CLIP),
        "build_frozen_s": lambda: train_omgsr_s.build_frozen_s(TrainConfig(sd_path=str(tmp_path)), torch.float32),
        "encode_fixed_prompt": lambda: train_omgsr_s.encode_fixed_prompt(
            TrainConfig(sd_path=str(tmp_path)), torch.float32),
        # the data path and the calibration: each raises before it reads a file
        "PairedLoader": lambda: PairedLoader(PairedDataset([], 64), 1),
        "build_loader": lambda: train_omgsr_s.build_loader(TrainConfig()),
        "mid_timestep_sd.main": lambda: mid_timestep_sd.main(
            ["--dataset_txt_or_dir_paths", str(tmp_path), "--sd_path", str(tmp_path)]),
        # the -F slice: each raises before it reads a file
        "init_flux": lambda: init_flux(0, fc),
        "pipeline f": lambda: OMGSRFPipeline(vp, fp, vc, fc),
        "build_server --pipeline f": lambda: serve.build_server(
            serve.parse_args(["--pipeline", "f"]), params=(vp, fp), configs=(vc, fc),
            prompt_embeds=(np.zeros((1, 5, 16), np.float32), np.zeros((1, 8), np.float32))),
        "build_server --flux_path": lambda: serve.build_server(
            serve.parse_args(["--pipeline", "f", "--flux_path", str(tmp_path)])),
        "infer_omgsr_f.main": lambda: infer_omgsr_f.main(infer_omgsr_f.parse_args(
            ["--input_image", str(tmp_path), "--output_dir", str(tmp_path), "--flux_path", str(tmp_path)])),
        "port_flux_transformer": lambda: porters.port_flux_transformer(str(tmp_path)),
        "mid_timestep_flux.main": lambda: mid_timestep_flux.main(
            ["--dataset_txt_or_dir_paths", str(tmp_path), "--flux_path", str(tmp_path)]),
        # -F training and FLUX's prompt encoders: each raises before it reads a file
        "infer_omgsr_f.main --prompt": lambda: infer_omgsr_f.main(infer_omgsr_f.parse_args(
            ["--input_image", str(tmp_path), "--output_dir", str(tmp_path), "--flux_path", str(tmp_path),
             "--prompt", "a", "cat"])),
        "encode_prompt_flux": lambda: encode_prompt_flux(str(tmp_path), "a cat"),
        "port_t5_encoder": lambda: porters.port_t5_encoder(str(tmp_path)),
        "init_t5_encoder": lambda: init_t5_encoder(0, T5Config(vocab_size=8, d_model=8, d_kv=4, d_ff=8,
                                                               num_layers=1, num_heads=2)),
        "build_frozen_f": lambda: train_omgsr_f.build_frozen_f(TrainConfig(flux_path=str(tmp_path)), torch.float32),
        "encode_fixed_prompt_f": lambda: train_omgsr_f.encode_fixed_prompt_f(
            TrainConfig(flux_path=str(tmp_path)), torch.float32),
        "run_training f": lambda: train_omgsr_f.run_training(
            TrainConfig(model="omgsr_f_1024", output_dir=str(tmp_path)), frozen={}, loader=[]),
        "train_omgsr_f.main": lambda: train_omgsr_f.main(["output_dir=" + str(tmp_path)]),
        # the quantised DiT and the eval path: each raises before it reads a file
        "init_flux_quantized": lambda: init_flux_quantized(0, fc),
        "quantize_flux_for_serving": lambda: quantize_flux_for_serving(fp),
        "build_server --quantize": lambda: serve.build_server(
            serve.parse_args(["--pipeline", "f", "--quantize", "int8"]), params=(vp, fp), configs=(vc, fc),
            prompt_embeds=(np.zeros((1, 5, 16), np.float32), np.zeros((1, 8), np.float32))),
        "eval_sr.main": lambda: eval_sr.main(["--sr_dir", str(tmp_path), "--gt_dir", str(tmp_path)]),
        "port_clip_vision": lambda: porters.port_clip_vision(str(tmp_path)),
        "init_clip_vision": lambda: init_clip_vision(0, CLIP_L_VISION),
        "init_lpips": lambda: init_lpips(0),
        # multi-GPU training: the multi-process check raises before it starts a process
        "multiproc_check.main": lambda: multiproc_check.main(["--nprocs", "2"]),
        # the DINOv3 ViT, the hub and the real-weight tools: each raises before it reads a file or draws
        "init_dinov3_vit": lambda: init_dinov3_vit(0, vit_cfg),
        "port_dinov3_vit": lambda: porters.port_dinov3_vit(str(tmp_path / "x.pth")),
        "hub ViT": lambda: hub.dinov3_vitl16(depth=1),
        "hub ConvNeXt": lambda: hub.dinov3_convnext_tiny(depths=(1, 1, 1, 1)),
        "hub classifier": lambda: hub.dinov3_vit7b16_lc(backbone_overrides={"depth": 1}),
        "validate_checkpoint.main": lambda: validate_checkpoint.main(["--sd_path", str(tmp_path)]),
        "fire_drill.main": lambda: fire_drill.main(["--family", "sd", "--root", str(tmp_path / "drill")]),
        "fire_drill.fabricate": lambda: fire_drill.fabricate("sd", str(tmp_path / "drill"), 0, 2.0),
        # SSL pretraining: the CLI and the functions that make its state raise before they read an image or draw
        "pretrain_dinov3.main": lambda: pretrain_dinov3.main(["output_dir=" + str(tmp_path / "ssl"),
                                                              "dataset_paths=" + str(tmp_path)]),
        "init_ssl_student": lambda: init_ssl_student(0, vit_cfg, SSLMetaConfig(dino_out_dim=8, ibot_out_dim=8),
                                                     init_dinov3_vit),
        "init_dino_head": lambda: init_dino_head(0, 8, 8, 8, 8),
        "init_center_state": lambda: init_center_state(SSLMetaConfig()),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # and the same calls work when the CPU is asked for
    OMGSRSPipeline(vp, up, vc, uc, device="cpu")
    OMGSRFPipeline(vp, fp, vc, fc, device="cpu")


def test_unported_options_raise_naming_their_slice():
    from omgsr_tpu_torch.cli import serve
    from omgsr_tpu_torch.convert.params import init_unet, init_vae
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models.configs import UNetConfig, VAEConfig

    vc = VAEConfig(block_out_channels=(8, 16), norm_num_groups=4)
    uc = UNetConfig(block_out_channels=(8, 16, 16, 16), num_attention_heads=(1, 2, 2, 2),
                    cross_attention_dim=16, norm_num_groups=4)
    vp, up = init_vae(0, vc, device="cpu"), init_unet(1, uc, device="cpu")
    from omgsr_tpu_torch.inference import tiled_vae

    # the tiled VAE and the multi-GPU paths are ported (tests/test_torch_port_parallel.py): a mesh needs a
    # process group, and -S has one strategy
    from omgsr_tpu_torch.parallel import create_mesh

    OMGSRSPipeline(vp, up, vc, uc, vae_tile=64, vae_stats="exact", device="cpu")
    assert callable(tiled_vae.sharded_vae_encode) and callable(tiled_vae.sharded_vae_decode)
    with pytest.raises(RuntimeError, match="parallel.initialize"):
        create_mesh({"data": 1})
    with pytest.raises(ValueError, match="strategy='tiles'"):
        OMGSRSPipeline(vp, up, vc, uc, device="cpu").shard_for_mesh(None, strategy="fsdp")
    # the load path is ported: a checkpoint directory that is not there is named
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        serve.build_server(serve.parse_args(["--sd_path", "/nowhere", "--device", "cpu"]))
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        serve.build_server(serve.parse_args(["--sd_path", "/nowhere", "--prompt_npz", "/nowhere/p.npz",
                                             "--device", "cpu"]))
    from omgsr_tpu_torch.convert.porters import load_safetensors_dir

    with pytest.raises(FileNotFoundError, match="/nowhere"):
        load_safetensors_dir("/nowhere/vae")
    from omgsr_tpu_torch.cli import infer_omgsr_s

    with pytest.raises(FileNotFoundError, match="/nowhere"):  # --shard tiles takes its mesh in main
        infer_omgsr_s.build_pipeline(infer_omgsr_s.parse_args(
            ["--input_image", "x", "--output_dir", "x", "--sd_path", "/nowhere", "--shard", "tiles"]), torch.float32,
            "cpu")
    # -F serving is ported: its defaults are -F's, and it needs a checkpoint or parameters in memory
    args = serve.parse_args(["--pipeline", "f", "--device", "cpu", "--prompt_npz", "/nowhere/p.npz"])
    assert (args.process_size, args.mid_timestep) == (1024, 244)
    with pytest.raises(ValueError, match="--flux_path"):
        serve.build_server(args)
    with pytest.raises(SystemExit):
        serve.parse_args(["--pipeline", "x"])
    # the quantised DiT is ported: --quantize and quantize_base build, and --shard reaches the directory
    from omgsr_tpu_torch.cli import infer_omgsr_f, train_omgsr_f
    from omgsr_tpu_torch.config import TrainConfig
    from omgsr_tpu_torch.convert.params import init_flux
    from omgsr_tpu_torch.models.configs import FluxConfig

    fc = FluxConfig(num_layers=1, num_single_layers=1, attention_head_dim=8, num_attention_heads=2,
                    joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(2, 4, 2))
    fvc = VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, latent_channels=16)
    fvp, fp = init_vae(0, fvc, device="cpu"), init_flux(2, fc, device="cpu")
    for mode, key in (("int8", "weight_q"), ("int8_w8a8", "act_quant"), ("int4", "weight_q4")):
        server = serve.build_server(
            serve.parse_args(["--pipeline", "f", "--quantize", mode, "--quantize_min_params", "64", "--device", "cpu",
                              "--weight_dtype", "fp32"]), params=(fvp, fp), configs=(fvc, fc),
            prompt_embeds=(np.zeros((1, 5, 16), np.float32), np.zeros((1, 8), np.float32)))
        server.shutdown()
        assert key in infer_omgsr_f.quantize_flux(fp, mode, 64, "cpu")["transformer_blocks"]["0"]["attn"]["to_q"]
    with pytest.raises(ValueError, match="flux_path"):  # quantize_base passes its check, then needs a directory
        train_omgsr_f.build_frozen_f(TrainConfig(quantize_base="int4"), torch.float32, "cpu")
    with pytest.raises(FileNotFoundError, match="/nowhere"):
        infer_omgsr_f.build_pipeline(infer_omgsr_f.parse_args(
            ["--input_image", "x", "--output_dir", "x", "--flux_path", "/nowhere", "--quantize", "int8",
             "--shard", "fsdp"]), torch.float32, "cpu")


def test_backward_kernels_hold_no_atomics_and_no_library_calls():
    """The dQ and dK/dV kernels fix the order of every sum: their source
    holds no atomic operation and no library product. The bf16 kernels at head
    dims 64 and 128 are the TMA + wgmma ones (with the fixed-order reduction of
    the split dK/dV partials), those at 512 the same on clusters of two CTAs
    that add each other's partial scores, and the mma.sync kernels they
    replaced are gone."""
    src = (ROOT / "omgsr_tpu_torch" / "csrc" / "flash_attention_bwd.cu").read_text()
    code = "\n".join(l.split("//")[0] for l in src.splitlines())
    assert "flash_bwd_dq_kernel" in code and "flash_bwd_dkv_kernel" in code
    for banned in ("atomic", "cublas", "cudnn", "cutlass", "scaled_dot_product", "sdpa"):
        assert banned not in code.lower(), banned
    for kernel in ("flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dkv_reduce_kernel"):
        assert kernel in code, kernel
    for gone in ("flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel", "launch_dq_mma", "launch_dkv_mma"):
        assert gone not in code, gone
    assert '#include "sm90.cuh"' in code and "__grid_constant__ CUtensorMap" in code
    # at D = 512 the TMA + wgmma kernels on clusters of two CTAs; the mma.sync kernels (ldmatrix
    # fragments from padded rows staged by all threads, products from registers) are gone
    for kernel in ("flash_bwd_dq_wide_wgmma_kernel", "flash_bwd_dkv_wide_wgmma_kernel"):
        assert kernel in code, kernel
    for gone in ("flash_bwd_dq_wide_kernel", "flash_bwd_dkv_wide_kernel", "launch_dq_wide(", "launch_dkv_wide(",
                 "wide_dq_smem_bytes", "wide_dkv_smem_bytes", "mma_bf16(", "ldmatrix", "stage_rows_bf16"):
        assert gone not in code, gone
    assert "__cluster_dims__(2, 1, 1)" in code and "wgmma_rs_m64n256k16_tb(" in code
    assert "mapa_shared(" in code and "st_async_v4(" in code and "mbar_wait_cluster(" in code
    sm90 = "\n".join(l.split("//")[0] for l in (ROOT / "omgsr_tpu_torch" / "csrc" / "sm90.cuh").read_text().splitlines())
    for instruction in ("mapa.shared::cluster", "st.async.shared::cluster", "mbarrier.arrive.release.cluster",
                        "acquire.cluster", "barrier.cluster.arrive"):
        assert instruction in sm90, instruction


def test_forward_kernels_hold_no_atomics_and_no_library_calls():
    """The forward kernels fix the order of every sum and compute their own
    products: no atomic operation and no library call in the forward source or
    the Hopper header it includes; the bf16 kernels at head dims 64/128 and 512
    are the TMA + wgmma ones (with the fixed-order merge of a split kv loop),
    and the mma.sync kernels they replaced are gone."""
    csrc = ROOT / "omgsr_tpu_torch" / "csrc"
    fwd = "\n".join(l.split("//")[0] for l in (csrc / "flash_attention_fwd.cu").read_text().splitlines())
    sm90 = "\n".join(l.split("//")[0] for l in (csrc / "sm90.cuh").read_text().splitlines())
    for code in (fwd, sm90):
        for banned in ("atomic", "cublas", "cudnn", "cutlass", "scaled_dot_product", "sdpa"):
            assert banned not in code.lower(), banned
    assert "flash_fwd_wgmma_kernel" in fwd and '#include "sm90.cuh"' in fwd
    assert "flash_fwd_mma_kernel" not in fwd and "launch_mma" not in fwd
    for kernel in ("flash_fwd_wide_wgmma_kernel", "flash_fwd_merge_kernel"):
        assert kernel in fwd, kernel
    # the D = 512 kernel's mma.sync body (ldmatrix fragments, products from registers) is gone
    for gone in ("flash_fwd_wide_kernel", "mma_bf16(", "ldmatrix", "stage_rows_bf16"):
        assert gone not in fwd, gone
    assert "wgmma_rs_m64n256k16_tb(" in fwd and "tma_load_4d(" in fwd
    assert "cuTensorMapEncodeTiled" in sm90 and "encode_bshd(" in fwd and "__grid_constant__ CUtensorMap" in fwd
    for instruction in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait", "setmaxnreg"):
        assert instruction in sm90, instruction


def test_conv_kernels_hold_no_atomics_and_no_library_calls():
    """The 3x3-conv kernels write one row of channel sums per block and the
    fold kernel adds the rows in a fixed order: their source holds no atomic
    operation, and the nine products are its own, not a library's. Both bf16
    functions (the resblock half and the plain conv) are the one TMA + wgmma
    kernel, and the mma.sync plain conv is gone; f32 stays on FMAs."""
    src = (ROOT / "omgsr_tpu_torch" / "csrc" / "conv3x3.cu").read_text()
    code = "\n".join(l.split("//")[0] for l in src.splitlines())
    assert "conv3x3_fma_kernel" in code
    for banned in ("atomic", "cublas", "cudnn", "cutlass"):
        assert banned not in code.lower(), banned
    for kernel in ("conv3x3_wgmma_kernel", "gn_fold_kernel"):
        assert kernel in code, kernel
    assert '#include "sm90.cuh"' in code and "__grid_constant__ CUtensorMap" in code
    assert "wgmma_ss_m64n128k16(" in code and "tma_load_3d(" in code and "tma_store_3d(" in code
    # the mma.sync plain conv (ldmatrix fragments, products from registers) is gone
    for gone in ("conv3x3_mma_kernel", "mma_bf16(", "ldmatrix", "MMA_SMEM"):
        assert gone not in code, gone
    # the plain conv's bf16 entry launches the wgmma kernel without the prologue, at both tile heights
    entry = code[code.index('extern "C" int conv3x3('):code.index('extern "C" int conv3x3_gn_fused(')]
    assert "launch_wgmma_rows<false>(tile_rows," in entry
    assert "launch_wgmma<2, FUSED>" in code and "launch_wgmma<1, FUSED>" in code


def test_group_norm_kernels_hold_no_atomics_and_no_library_calls():
    """The GroupNorm kernels fix the order of every sum: the stats kernel writes
    one partial per chunk and the apply kernel folds them in a fixed order, so
    their source holds no atomic operation and calls no library."""
    src = (ROOT / "omgsr_tpu_torch" / "csrc" / "group_norm_silu.cu").read_text()
    code = "\n".join(l.split("//")[0] for l in src.splitlines())
    for banned in ("atomic", "cublas", "cudnn", "cutlass", "cub::", "thrust", "#include <c10", "#include <torch"):
        assert banned not in code.lower(), banned
    for kernel in ("gn_stats_kernel", "gn_apply_kernel"):
        assert kernel in code, kernel
    # the apply kernel's fold reads partials coalesced, not one lane per chunk
    assert "for (int c = lane; c < nchunks; c += 32)" not in code


@pytest.mark.parametrize("module", ["flash_attention", "fused_groupnorm", "conv3x3"])
def test_kernel_wrappers_hold_no_try_that_gives_way(module):
    """On a CUDA tensor a wrapper launches its kernel or raises: no wrapper
    module catches an exception, and each reads the test-only plain route."""
    src = (ROOT / "omgsr_tpu_torch" / "ops" / f"{module}.py").read_text()
    assert not re.search(r"^\s*(try|except)\b", src, re.M)
    assert "plain_route_active()" in src and "LaunchCounter(" in src


def test_conv_wrappers_refuse_on_a_cuda_tensor_what_the_kernels_do_not_take(monkeypatch):
    """The checks that run before a launch, driven on meta tensors made to
    look like CUDA ones: a channel count that is no multiple of 128, fp16 and
    batch 2 raise; nothing is computed by the plain version."""
    from omgsr_tpu_torch.ops import conv3x3 as C3

    def called(*a, **k):
        raise AssertionError("the plain version was taken")

    monkeypatch.setattr(C3, "conv3x3_plain", called)
    monkeypatch.setattr(C3, "conv3x3_gn_fused_plain", called)

    class OnCard(torch.Tensor):
        is_cuda = True

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta").as_subclass(OnCard)

    for x, w, err in (
        (meta(1, 8, 8, 192), meta(128, 192, 3, 3), ValueError),
        (meta(1, 8, 8, 128), meta(64, 128, 3, 3), ValueError),
        (meta(1, 8, 8, 128, dtype=torch.float16), meta(128, 128, 3, 3, dtype=torch.float16), NotImplementedError),
        (meta(2, 8, 8, 128), meta(128, 128, 3, 3), NotImplementedError),
    ):
        cout, cin = w.shape[:2]
        with pytest.raises(err):
            C3.conv3x3(x, w, meta(cout))
        with pytest.raises(err):
            C3.conv3x3_gn_fused(x, w, meta(cout), meta(cin, dtype=torch.float32), meta(cin, dtype=torch.float32))


def test_fold_and_merge_wrappers_refuse_on_a_cuda_tensor_what_the_kernels_do_not_take(monkeypatch):
    """The fold of the streamed sums and the merge of a split kv loop, driven
    on meta tensors made to look like CUDA ones: a type or head dim their
    kernels do not take raises; nothing is computed by the plain versions."""
    from omgsr_tpu_torch.ops import conv3x3 as C3
    from omgsr_tpu_torch.ops import flash_attention as FA

    def called(*a, **k):
        raise AssertionError("the plain version was taken")

    monkeypatch.setattr(C3, "_affine_from_stacked_sums", called)
    monkeypatch.setattr(FA, "flash_attention_merge_plain", called)

    class OnCard(torch.Tensor):
        is_cuda = True

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta").as_subclass(OnCard)

    with pytest.raises(NotImplementedError):  # f16 gamma and beta
        C3.fold_gn_sums(meta(2, 8, 128), 64, 32, meta(128, dtype=torch.float16), meta(128, dtype=torch.float16))
    with pytest.raises(NotImplementedError):  # f64 sums
        C3.fold_gn_sums(meta(2, 8, 128, dtype=torch.float64), 64, 32, meta(128), meta(128))
    with pytest.raises(ValueError):  # a channel count no multiple of the groups
        C3.fold_gn_sums(meta(2, 8, 120), 64, 32, meta(120), meta(120))
    with pytest.raises(NotImplementedError):  # head dim 64: the kernel merges head dim 512 only
        FA.flash_attention_merge(meta(2, 1, 100, 64), meta(2, 1, 100), 1, 1)
    with pytest.raises(NotImplementedError):  # bf16 chunks
        FA.flash_attention_merge(meta(2, 1, 100, 512, dtype=torch.bfloat16), meta(2, 1, 100), 1, 1)
    with pytest.raises(ValueError):  # lse chunks of another shape
        FA.flash_attention_merge(meta(2, 1, 100, 512), meta(3, 1, 100), 1, 1)


def test_kernel_sources_ship_with_the_package():
    from omgsr_tpu_torch.ops import kernel_build

    assert kernel_build.kernel_sources() == ["conv3x3", "flash_attention_bwd", "flash_attention_fwd",
                                             "group_norm_silu"]
    # the headers the sources include ship beside them and take part in the build's hash
    assert sorted(p.name for p in kernel_build.CSRC_DIR.glob("*.cuh")) == ["mma_bf16.cuh", "sm90.cuh"]
    assert '"csrc/*.cuh"' in (ROOT / "pyproject.toml").read_text()
    # no nvcc on a CPU host: a build is refused loudly, never skipped
    import shutil

    if shutil.which("nvcc") is None and not (pathlib.Path("/usr/local/cuda/bin/nvcc").exists()):
        with pytest.raises(kernel_build.KernelBuildError):
            kernel_build.build_kernels()
