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
                "inference.tiled_vae", "inference.vae_routing"):
        assert f"omgsr_tpu_torch.{sub}" in names, sub
    code = (
        "import importlib, sys\n"
        f"names = {names!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'omgsr_tpu' or m.startswith('omgsr_tpu.')]\n"
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
    from omgsr_tpu_torch.cli import serve, train_omgsr_s
    from omgsr_tpu_torch.config import TrainConfig
    from omgsr_tpu_torch.convert.params import (
        from_jax_tree,
        init_convnext,
        init_discriminator,
        init_unet,
        init_vae,
    )
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models.configs import ConvNeXtConfig, UNetConfig, VAEConfig
    from omgsr_tpu_torch.serving import SRServer
    from omgsr_tpu_torch.serving.server import make_fused_infer

    vc = VAEConfig(block_out_channels=(8, 16), norm_num_groups=4)
    uc = UNetConfig(block_out_channels=(8, 16, 16, 16), num_attention_heads=(1, 2, 2, 2),
                    cross_attention_dim=16, norm_num_groups=4)
    vp, up = init_vae(0, vc, device="cpu"), init_unet(1, uc, device="cpu")
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
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # and the same calls work when the CPU is asked for
    OMGSRSPipeline(vp, up, vc, uc, device="cpu")


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

    # the tiled VAE is ported; its multi-GPU sharded mode is not
    OMGSRSPipeline(vp, up, vc, uc, vae_tile=64, vae_stats="exact", device="cpu")
    for fn in (tiled_vae.sharded_vae_encode, tiled_vae.sharded_vae_decode):
        with pytest.raises(NotImplementedError, match="distribution slice"):
            fn(vp, vc, torch.zeros(1, 16, 16, 3), None)
    with pytest.raises(NotImplementedError, match="distribution slice"):
        OMGSRSPipeline(vp, up, vc, uc, device="cpu").shard_for_mesh(None)
    with pytest.raises(NotImplementedError, match="load-path slice"):
        serve.build_server(serve.parse_args(["--sd_path", "/nowhere", "--device", "cpu"]))
    with pytest.raises(SystemExit):
        serve.parse_args(["--pipeline", "f"])


def test_backward_kernels_hold_no_atomics_and_no_library_calls():
    """The dQ and dK/dV kernels fix the order of every sum: their source
    holds no atomic operation and no library product. The bf16 kernels at head
    dims 64 and 128 are the TMA + wgmma ones (with the fixed-order reduction of
    the split dK/dV partials), and the mma.sync kernels they replaced are gone."""
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
