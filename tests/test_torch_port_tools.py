"""The port's real-weight tools against the JAX package's, on the CPU:
utils/observability.py, cli/validate_checkpoint.py (on tiny SD2.1- and
FLUX.1-dev-layout directories written by the port's own writers) and
cli/fire_drill.py (save_sharded_safetensors read back by both packages'
loaders; the whole drill at tiny model configs).

The JAX package's validate_flux runs once, on the FLUX directory, with its
VAE and DiT functions compiled as one jit each (XLA at optimisation level 0,
the same functions) instead of op by op."""

import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu_torch.cli import fire_drill as FD
from omgsr_tpu_torch.cli import validate_checkpoint as VC
from omgsr_tpu_torch.convert.params import init_flux, init_t5_encoder, init_unet, init_vae
from omgsr_tpu_torch.models.clip_text import init_clip_text
from omgsr_tpu_torch.models.configs import CLIPTextConfig, FluxConfig, VAEConfig
from omgsr_tpu_torch.utils import observability as OBS
from tests.torch_port_helpers import (
    T_TINY_UNET,
    TINY_CLIP_KW,
    TINY_MERGES,
    TINY_T5_PIECES,
    charsmap_rules,
    jax_once,
    tiny_flux_configs,
    tiny_text_configs,
)

# ----------------------------------------------------------------------------
# observability
# ----------------------------------------------------------------------------


def test_observability_matches_the_jax_package(tmp_path):
    """MetricLogger / SmoothedValue strings and numbers, check_finite paths
    and all_nan equal the JAX package's; StepTimer waits and times; trace()
    on the CPU writes a Chrome trace of the ops it saw; guard_nans toggles
    autograd's anomaly mode."""
    from omgsr_tpu.utils import observability as J

    values = [1.0, 2.5, 3.25, 4.0, 0.125]
    jl, tl = J.MetricLogger(window=3), OBS.MetricLogger(window=3)
    for i, v in enumerate(values):
        jl.update(loss=v, lr=0.1 * i, step=np.float32(i))
        tl.update(loss=v, lr=0.1 * i, step=torch.tensor(float(i)))
    assert str(tl) == str(jl)
    js, ts = J.SmoothedValue(window=2), OBS.SmoothedValue(window=2)
    for v, n in ((1.0, 1), (3.0, 2), (8.0, 1)):
        js.update(v, n)
        ts.update(v, n)
    assert (ts.median, ts.avg, ts.global_avg) == (js.median, js.avg, js.global_avg)

    bad = {"a": np.ones(3, np.float32), "b": {"c": np.array([1.0, np.nan], np.float32), "d": np.zeros(2)},
           "e": {"f": {"g": np.array([np.inf], np.float32)}}}
    want = J.check_finite(jax.tree.map(jnp.asarray, bad), "params")
    assert want == ["params.b.c", "params.e.f.g"]
    assert OBS.check_finite(jax.tree.map(torch.from_numpy, bad), "params") == want
    as_list = [np.ones(2), [np.array([np.nan]), np.zeros(1)], np.array([np.inf])]
    assert OBS.check_finite([torch.from_numpy(np.asarray(a)) if not isinstance(a, list) else
                             [torch.from_numpy(b) for b in a] for a in as_list]) == \
        J.check_finite([jnp.asarray(a) if not isinstance(a, list) else [jnp.asarray(b) for b in a]
                        for a in as_list])
    for x in (np.full(4, np.nan), np.array([1.0, np.nan]), np.zeros(3)):
        assert OBS.all_nan(torch.from_numpy(x)) == J.all_nan(jnp.asarray(x))

    with OBS.StepTimer() as timer:
        y = torch.ones(64, 64) @ torch.ones(64, 64)
        timer.stop({"y": y})
    assert timer.seconds > 0
    with OBS.trace(str(tmp_path / "trace")) as prof:
        torch.relu(torch.ones(8, 8) @ torch.ones(8, 8))
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "trace")
    assert any("aten::relu" in e.get("name", "") for e in events)
    OBS.guard_nans(True)
    assert torch.is_anomaly_enabled()
    OBS.guard_nans(False)
    assert not torch.is_anomaly_enabled()


# ----------------------------------------------------------------------------
# validate_checkpoint
# ----------------------------------------------------------------------------

_TINY_VAE = VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, layers_per_block=1)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Tiny SD2.1- and FLUX.1-dev-layout directories written by the port's
    writers (tools/sd_checkpoint.py, tools/flux_checkpoint.py), with their
    text encoders and synthetic tokenizers; the -F DiT at head dim 64."""
    from omgsr_tpu_torch.tools.flux_checkpoint import precompiled_charsmap, synthetic_unigram, write_flux_checkpoint
    from omgsr_tpu_torch.tools.sd_checkpoint import synthetic_bpe, write_sd_checkpoint

    root = tmp_path_factory.mktemp("validate")
    clip_cfg = CLIPTextConfig(**TINY_CLIP_KW)
    write_sd_checkpoint(str(root / "sd"), init_vae(0, _TINY_VAE, device="cpu"), _TINY_VAE,
                        init_unet(1, T_TINY_UNET, device="cpu"), T_TINY_UNET,
                        clip=init_clip_text(2, clip_cfg, device="cpu"), clip_cfg=clip_cfg,
                        tokenizer=synthetic_bpe(TINY_MERGES, 0))
    _, fvae, _, fcfg = tiny_flux_configs()
    fcfg = dataclasses.replace(fcfg, attention_head_dim=64, num_attention_heads=2, axes_dims_rope=(8, 28, 28))
    _, tclip, _, tt5 = tiny_text_configs()
    write_flux_checkpoint(str(root / "flux"), init_vae(3, fvae, device="cpu"), fvae, init_flux(4, fcfg, device="cpu"),
                          fcfg, dtype=torch.float32, clip=init_clip_text(5, tclip, device="cpu"), clip_cfg=tclip,
                          t5=init_t5_encoder(6, tt5, device="cpu"), t5_cfg=tt5,
                          tokenizers=(synthetic_bpe(TINY_MERGES, 0),
                                      (synthetic_unigram(TINY_T5_PIECES, 0), precompiled_charsmap(charsmap_rules()))))
    return root


# the JAX CLI's SD stages and verdict keys (omgsr_tpu/cli/validate_checkpoint.py validate_sd and main)
_JAX_SD_STAGES = {"vae_encode_moments", "vae_decode", "unet_eps_t273", "clip_text_vs_transformers"}
_JAX_VERDICT_KEYS = {"worst_max_rel", "errored_stages", "passes_1e-3_target"}


@pytest.fixture(scope="module")
def jax_flux_report(checkpoints):
    """The JAX package's validate_flux on the FLUX directory, its VAE and
    DiT functions run as one jit each."""
    from omgsr_tpu.cli import validate_checkpoint as JVC
    from omgsr_tpu.models import flux as JF
    from omgsr_tpu.models import vae as JV

    def one_jit(fn):
        def call(params, cfg, *args, **kw):
            return jax_once(lambda p, *a: fn(p, cfg, *a, **kw), params, *args)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((JV, "vae_encode_features"), (JF, "flux_apply")):
            mp.setattr(mod, name, one_jit(getattr(mod, name)))
        return JVC.validate_flux(str(checkpoints / "flux"), tokens=16)


def test_validate_checkpoint_sd_and_flux(checkpoints, jax_flux_report, tmp_path):
    """The port's CLI with --device cpu on both directories in one call:
    every stage within 1e-3 of the independent torch reference (and of
    transformers' towers), as the JAX package's stages are on the same FLUX
    weights; the report's keys the JAX CLI's (-F also holds CLIP-L and T5
    against transformers, two stages the JAX CLI lacks)."""
    report_path = tmp_path / "report.json"
    report = VC.main(["--sd_path", str(checkpoints / "sd"), "--flux_path", str(checkpoints / "flux"),
                      "--flux_tokens", "16", "--device", "cpu", "--report", str(report_path)])
    assert json.loads(report_path.read_text()) == report
    jax_stages = {"sd": _JAX_SD_STAGES, "flux": set(jax_flux_report)}
    for comp in ("sd", "flux"):
        extra = {"clip_l_pooled_vs_transformers", "t5_vs_transformers"} if comp == "flux" else set()
        assert set(report[comp]) == jax_stages[comp] | extra, comp
        for stage, r in report[comp].items():
            assert set(r) == {"max_abs", "max_rel", "mean_rel"}, (comp, stage, r)
            assert r["max_rel"] < 1e-3, (comp, stage, r)
    for stage, r in jax_flux_report.items():
        assert r["max_rel"] < 1e-3, ("jax", stage, r)
    assert set(report) == {"sd", "flux"} | _JAX_VERDICT_KEYS
    assert report["passes_1e-3_target"] and report["errored_stages"] == []
    assert report["worst_max_rel"] == max(r["max_rel"] for c in ("sd", "flux") for r in report[c].values())


def test_validate_checkpoint_fails_without_transformers(checkpoints, monkeypatch):
    """A transformers comparison that cannot run is an error entry, as in
    the JAX CLI: without transformers the SD text tower is never compared,
    so the report does not pass, while the other stages still do."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    report = VC.main(["--sd_path", str(checkpoints / "sd"), "--device", "cpu"])
    assert "transformers" in report["sd"]["clip_text_vs_transformers"]["error"]
    assert report["errored_stages"] == ["sd.clip_text_vs_transformers"]
    assert report["passes_1e-3_target"] is False
    assert all(r["max_rel"] < 1e-3 for k, r in report["sd"].items() if k != "clip_text_vs_transformers")


def test_validate_dinov3_refuses_without_its_reference(tmp_path):
    """--dinov3_pth compares against the vendored DINOv3 tree at --ref_root,
    which has no default: without the flag, or where the directory lacks the
    tree, the CLI exits non-zero naming the flag or the path and reports
    nothing."""
    with pytest.raises(SystemExit) as e:
        VC.main(["--dinov3_pth", str(tmp_path / "vit.pth"), "--device", "cpu", "--report", str(tmp_path / "r.json")])
    assert e.value.code != 0 and "--ref_root" in str(e.value.code)
    absent = tmp_path / "no_reference"
    with pytest.raises(SystemExit) as e:
        VC.main(["--dinov3_pth", str(tmp_path / "vit.pth"), "--ref_root", str(absent), "--device", "cpu",
                 "--report", str(tmp_path / "r.json")])
    assert e.value.code != 0 and str(absent) in str(e.value.code)
    assert not (tmp_path / "r.json").exists()
    with pytest.raises(FileNotFoundError, match=str(absent)):
        VC.validate_dinov3(str(tmp_path / "vit.pth"), ref_root=str(absent), device="cpu")


# ----------------------------------------------------------------------------
# fire_drill
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("max_shard_bytes", [40 * 1024, 1 << 30])
def test_save_sharded_safetensors_reads_back_in_both_packages(tmp_path, max_shard_bytes):
    """Shards + index (40 KB shards of 16 KB tensors) and the single file
    without an index: both packages' loaders read every tensor back byte for
    byte (f32 and bf16)."""
    from omgsr_tpu.convert.porters import load_safetensors_dir as jax_load
    from omgsr_tpu_torch.convert.porters import load_safetensors_dir

    rng = np.random.default_rng(0)
    tensors = {f"block.{i}.weight": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
               for i in range(8)}
    tensors["half.weight"] = torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)).to(torch.bfloat16)
    d = tmp_path / "ckpt"
    n = FD.save_sharded_safetensors(tensors, str(d), max_shard_bytes=max_shard_bytes)
    indexed = any(f.endswith(".index.json") for f in os.listdir(d))
    assert (n > 1) == indexed == (max_shard_bytes < (1 << 20))
    assert n == len([f for f in os.listdir(d) if f.endswith(".safetensors")])
    mine, theirs = load_safetensors_dir(str(d)), jax_load(str(d))
    assert set(mine) == set(theirs) == set(tensors)
    for k, v in tensors.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
        got = np.asarray(theirs[k])
        assert got.tobytes() == v.view(torch.int16 if v.dtype == torch.bfloat16 else torch.int32).numpy().tobytes(), k
    # numpy input, as the JAX function takes
    FD.save_sharded_safetensors({k: v.float().numpy() for k, v in tensors.items()}, str(tmp_path / "np"),
                                max_shard_bytes)
    assert torch.equal(load_safetensors_dir(str(tmp_path / "np"))["block.3.weight"], tensors["block.3.weight"])


# every code path of the published architectures at a few channels: the VAE at four levels
# (downscale 8, so --process_size 128 gives one 16x16 latent tile), the DiT at head dim 64
DRILL_CONFIGS = {
    "sd": (VAEConfig(block_out_channels=(8, 8, 16, 16), norm_num_groups=4, layers_per_block=1), T_TINY_UNET),
    "flux": (VAEConfig(block_out_channels=(8, 8, 16, 16), norm_num_groups=4, layers_per_block=1, latent_channels=16,
                       scaling_factor=0.3611, shift_factor=0.1159, use_quant_conv=False, use_post_quant_conv=False),
             FluxConfig(num_layers=2, num_single_layers=2, attention_head_dim=64, num_attention_heads=2,
                        joint_attention_dim=32, pooled_projection_dim=16, axes_dims_rope=(8, 28, 28))),
}


@pytest.mark.parametrize("family", ["sd", "flux"])
def test_fire_drill_at_tiny_configs(family, tmp_path):
    """The whole drill through main on the CPU, the model configs given as
    keyword arguments: the denoiser in shards with an index (20 KB shards)
    and the VAE in one file, the infer CLI, eval_sr, the adapter round trip
    and validate_checkpoint pass, and only the report is left behind."""
    vae_cfg, denoiser_cfg = DRILL_CONFIGS[family]
    root = tmp_path / family
    (root / "keep.txt").parent.mkdir()
    (root / "keep.txt").write_text("a file that was there before")
    report = FD.main(["--family", family, "--root", str(root), "--device", "cpu",
                      "--max_shard_gb", str(20000 / (1 << 30))], vae_cfg=vae_cfg, denoiser_cfg=denoiser_cfg)
    assert report["passed"] and report["worst_parity_max_rel"] <= 1e-3
    assert report["stages"]["adapter_roundtrip_exact"]
    files = report["stages"]["checkpoint_files"]
    assert files["vae"] == 1 and files["unet" if family == "sd" else "transformer"] > 1, files
    summary = report["stages"]["eval_sr"]["summary"]
    assert math.isfinite(summary["psnr_mean"]) and 0.0 <= summary["ssim_mean"] <= 1.0
    assert all(math.isfinite(summary[k]) for k in ("dists_mean", "lpips_mean", "niqe_mean"))
    assert sorted(os.listdir(root)) == ["drill_report.json", "keep.txt"]
    assert json.loads((root / "drill_report.json").read_text()) == report
    with pytest.raises(SystemExit, match="already contains"):  # never over a checkpoint
        (root / "vae").mkdir()
        FD.fabricate(family, str(root), 0, 1.0, vae_cfg=vae_cfg, denoiser_cfg=denoiser_cfg, device="cpu")
