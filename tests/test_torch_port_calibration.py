"""The port's -S mid-timestep calibration against the JAX package on the CPU:
the FLUX schedule (equal), the SNR gaps and the argmin (rel 1e-6 of the
curve's largest value), ``mid_timestep_sd.run`` over the same batches with
the posterior-mean encoder (the same t, the curve within 1e-5), and
``mid_timestep_sd.main`` from a VAE directory and a folder of images."""

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.cli import mid_timestep_sd as JCLI
from omgsr_tpu.diffusion import calibration as JC
from omgsr_tpu.diffusion import schedules as JS
from omgsr_tpu.models import vae as JV
from omgsr_tpu_torch.cli import mid_timestep_sd as CLI
from omgsr_tpu_torch.diffusion import calibration as TC
from omgsr_tpu_torch.diffusion import schedules as TS
from omgsr_tpu_torch.models import vae as TV
from tests.torch_port_helpers import FAST_COMPILE, J_TINY_VAE, T_TINY_VAE, bridge, jax_init, t, torch_layout


def _close(got, ref, rel, what=""):
    """|got - ref| <= rel * max |ref| elementwise: near the argmin the gap
    crosses zero, where an elementwise relative bound means nothing."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, (what, err)


@pytest.mark.parametrize("kw", [{}, {"num_steps": 50, "image_seq_len": 1024}, {"shift": False}])
def test_flux_schedule_is_the_jax_package_s(kw):
    a, b = TS.flux_shifted_sigmas(**kw), JS.flux_shifted_sigmas(**kw)
    assert np.array_equal(a, b) and a[0] == 1.0 and a[-1] == 0.0
    for mid in (0, 1, len(a) // 3, len(a) - 1):
        assert TS.flux_sigma_at_mid_timestep(mid, a) == JS.flux_sigma_at_mid_timestep(mid, b)
    assert TS.flux_sigma_at_mid_timestep(273) == JS.flux_sigma_at_mid_timestep(273)


@pytest.mark.parametrize("which", ["sd", "flux"])
def test_snr_gap_and_calibrate_match(which):
    rng = np.random.default_rng(1)
    hq = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    lq = hq + 0.4 * rng.normal(size=hq.shape).astype(np.float32)
    fn_t, fn_j = (TC.snr_gap_sd, JC.snr_gap_sd) if which == "sd" else (TC.snr_gap_flux, JC.snr_gap_flux)
    got, ref = fn_t(t(hq), t(lq)), np.asarray(fn_j(jnp.asarray(hq), jnp.asarray(lq)))
    assert got.dtype == torch.float32 and got.shape == (1000,)
    _close(got.numpy(), ref, 1e-6, which)
    (t_got, v_got), (t_ref, v_ref) = TC.calibrate(got.double().numpy()), JC.calibrate(np.asarray(ref, np.float64))
    assert t_got == t_ref
    assert abs(v_got - v_ref) <= 1e-6 * np.abs(ref).max()


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        hq = np.tanh(rng.normal(size=(1, 32, 32, 3))).astype(np.float32)
        out.append({"hq": hq, "lq": np.clip(hq + 0.3 * rng.normal(size=hq.shape), -1, 1).astype(np.float32)})
    return out


def test_run_with_the_posterior_mean_matches(capsys):
    jp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    tp = bridge(jp)
    batches = _batches(3, 2)
    encode = jax.jit(lambda x: JV.vae_encode(jp, J_TINY_VAE, x)).lower(
        jnp.asarray(batches[0]["hq"])).compile(compiler_options=FAST_COMPILE)
    args = argparse.Namespace(max_samples=None)
    t_ref, avg_ref = JCLI.run(args, lambda x, k: encode(x), batches)
    t_got, avg_got = CLI.run(args, lambda x, g: TV.vae_encode(tp, T_TINY_VAE, x, sample=False), batches)
    assert t_got == t_ref and 0 <= t_got < 1000
    assert avg_got.dtype == np.float64 and avg_got.shape == (1000,)
    _close(avg_got, avg_ref, 1e-5)
    # max_samples stops after the batch that reaches it, as the JAX CLI does
    t2, _ = CLI.run(argparse.Namespace(max_samples=2), lambda x, g: TV.vae_encode(tp, T_TINY_VAE, x, sample=False),
                    batches)
    assert capsys.readouterr().out.count("best_t=") == 3 + 3 + 2


def test_main_calibrates_from_a_vae_directory_and_a_folder(tmp_path, monkeypatch, capsys):
    from safetensors.numpy import save_file

    vae = tmp_path / "sd" / "vae"
    vae.mkdir(parents=True)
    save_file(torch_layout(jax_init(JV.init_vae, 0, J_TINY_VAE)), str(vae / "diffusion_pytorch_model.safetensors"))
    (vae / "config.json").write_text(json.dumps({"block_out_channels": [8, 16], "norm_num_groups": 4,
                                                 "latent_channels": 4, "layers_per_block": 1}))
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(3)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it: the plot is skipped
    argv = ["--dataset_txt_or_dir_paths", str(imgs), "--sd_path", str(tmp_path / "sd"), "--resolution", "64",
            "--max_samples", "3", "--batch_size", "2", "--device", "cpu"]
    t_best, avg = CLI.main(argv)
    out = capsys.readouterr().out
    assert 0 <= t_best < 1000 and np.isfinite(avg).all() and avg.shape == (1000,)
    assert out.count("best_t=") == 2 and f"Optimal timestep t: {t_best}" in out
    assert "matplotlib unavailable; skipping plot" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            CLI.main(argv[:-2])
