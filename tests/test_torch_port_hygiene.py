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
    assert len(names) > 20
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
    for banned in ("scaled_dot_product_attention", "torch.compile", "F.group_norm("):
        if path != "chip_smoke.py":  # the smoke script times them as yardsticks only
            assert banned not in src, (path, banned)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device works here")


def test_entry_points_raise_without_cuda():
    _no_cuda()
    from omgsr_tpu_torch.cli import serve
    from omgsr_tpu_torch.convert.params import from_jax_tree, init_unet, init_vae
    from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline
    from omgsr_tpu_torch.models.configs import UNetConfig, VAEConfig
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
        "pipeline": lambda: OMGSRSPipeline(vp, up, vc, uc),
        "server": lambda: SRServer(lambda lq, i: lq),
        "fused": lambda: make_fused_infer(lambda lq, i: lq, torch.float32),
        "build_server": lambda: serve.build_server(
            serve.parse_args([]), params=(vp, up), configs=(vc, uc),
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
    with pytest.raises(NotImplementedError, match="tiled-VAE slice"):
        OMGSRSPipeline(vp, up, vc, uc, vae_tile=64, device="cpu")
    with pytest.raises(NotImplementedError, match="tiled-VAE slice"):
        OMGSRSPipeline(vp, up, vc, uc, vae_stats="exact", device="cpu")
    with pytest.raises(NotImplementedError, match="distribution slice"):
        OMGSRSPipeline(vp, up, vc, uc, device="cpu").shard_for_mesh(None)
    with pytest.raises(NotImplementedError, match="load-path slice"):
        serve.build_server(serve.parse_args(["--sd_path", "/nowhere", "--device", "cpu"]))
    with pytest.raises(SystemExit):
        serve.parse_args(["--pipeline", "f"])


def test_kernel_sources_ship_with_the_package():
    from omgsr_tpu_torch.ops import kernel_build

    assert kernel_build.kernel_sources() == ["flash_attention_fwd", "group_norm_silu"]
    # no nvcc on a CPU host: a build is refused loudly, never skipped
    import shutil

    if shutil.which("nvcc") is None and not (pathlib.Path("/usr/local/cuda/bin/nvcc").exists()):
        with pytest.raises(kernel_build.KernelBuildError):
            kernel_build.build_kernels()
