"""The port's one-step pipeline, tiled denoiser and colour fixes against the
JAX package. fp32 on the CPU, tiny configs, shared weights.

Pipeline tolerance 1e-3: VAE encode, UNet and VAE decode chained (each
within 1e-4), the x0 step dividing by sqrt(abar) = 0.83, and the stitch
normalising by summed gaussian weights. Colour fixes 1e-5 (single ops)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.inference.pipeline_s import OMGSRSPipeline as JPipeline
from omgsr_tpu.inference.tiled import tiled_denoise as j_tiled_denoise
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu.ops import color as JC
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline as TPipeline
from omgsr_tpu_torch.inference.tiled import tiled_denoise
from omgsr_tpu_torch.ops import color as TC
from tests.torch_port_helpers import (
    J_TINY_UNET,
    J_TINY_VAE,
    T_TINY_UNET,
    T_TINY_VAE,
    assert_close,
    bridge,
    jax_init,
    jax_once,
    t,
)

PIPE_TOL = 1e-3
COLOR_TOL = 1e-5


@pytest.fixture(scope="module")
def pipes():
    vp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    up = jax_init(JU.init_unet, 1, J_TINY_UNET)
    jpipe = JPipeline(vp, up, J_TINY_VAE, J_TINY_UNET)
    tpipe = TPipeline(bridge(vp), bridge(up), T_TINY_VAE, T_TINY_UNET, device="cpu")
    prompt = np.random.default_rng(2).standard_normal((1, 7, 16)).astype(np.float32)
    return jpipe, tpipe, prompt


@pytest.mark.parametrize(
    "hw,tile,overlap",
    [
        ((32, 32), 16, 8),  # latent 16x16 = one tile: untiled
        ((32, 32), 8, 4),  # latent 16x16 in 8x8 tiles, 9 tiles, batch 3
        ((40, 40), 8, 4),  # last tile snapped to the edge; 16 tiles
    ],
)
def test_pipeline_matches_jax(pipes, hw, tile, overlap):
    jpipe, tpipe, prompt = pipes
    lq = np.random.default_rng(3).uniform(-1, 1, (1, *hw, 3)).astype(np.float32)
    # the JAX pipeline as one jit at XLA optimisation level 0 (the same sums; it compiles sooner)
    ref = jax_once(lambda x, p: jpipe(x, p, tile, overlap, sample_latent=False), jnp.asarray(lq), jnp.asarray(prompt))
    out = tpipe(lq, prompt, tile, overlap, sample_latent=False)
    assert out.shape == (1, *hw, 3) and out.dtype == torch.float32
    assert float(out.min()) >= -1.0 and float(out.max()) <= 1.0
    assert_close(out, ref, PIPE_TOL)


def test_pipeline_batch_and_noise(pipes):
    jpipe, tpipe, prompt = pipes
    lq = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    # no noise source: the posterior mean, whatever sample_latent says (as in the JAX package)
    ref = jax_once(lambda x, p: jpipe(x, p, 8, 4), jnp.asarray(lq), jnp.asarray(prompt))
    assert_close(tpipe(lq, prompt, 8, 4), ref, PIPE_TOL)
    # explicit noise changes the result, reproducibly
    noise = np.random.default_rng(5).standard_normal((2, 16, 16, 4)).astype(np.float32)
    a = tpipe(lq, prompt, 8, 4, noise=noise)
    b = tpipe(lq, prompt, 8, 4, noise=noise)
    assert torch.equal(a, b) and not torch.allclose(a, tpipe(lq, prompt, 8, 4))
    g = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    assert torch.equal(tpipe(lq, prompt, 8, 4, generator=g()), tpipe(lq, prompt, 8, 4, generator=g()))


@pytest.mark.parametrize("tile_batch", [1, 4, None])
@pytest.mark.parametrize("shape,tile,overlap", [((2, 20, 12, 3), 8, 4), ((1, 6, 40, 2), 16, 8)])
def test_tiled_denoise_matches_jax(shape, tile, overlap, tile_batch):
    """A pointwise 'denoiser' isolates the gather / pad / stitch logic; the
    second shape clamps the tile to the short side and the overlap with it."""
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    ref = j_tiled_denoise(jnp.asarray(x), lambda tl: jnp.tanh(tl) * 2 + 1, tile, overlap, tile_batch)
    seen = []

    def denoise(tl):
        seen.append(tl.shape[0])
        return torch.tanh(tl) * 2 + 1

    out = tiled_denoise(t(x), denoise, tile, overlap, tile_batch)
    assert_close(out, ref, COLOR_TOL)
    assert len(set(seen)) == 1  # every denoiser batch has the same size


def _images(seed, shape=(2, 24, 20, 3)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, shape).astype(np.float32), rng.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("fix", ["adain_color_fix", "wavelet_color_fix"])
def test_color_fix(fix):
    tgt, src = _images(7)
    ref = getattr(JC, fix)(jnp.asarray(tgt), jnp.asarray(src))
    assert_close(getattr(TC, fix)(t(tgt), t(src)), ref, COLOR_TOL)


def test_wavelet_parts():
    tgt, _ = _images(8)
    for radius in (1, 4, 16):
        assert_close(TC.wavelet_blur(t(tgt), radius), JC.wavelet_blur(jnp.asarray(tgt), radius), COLOR_TOL)
    jh, jl = JC.wavelet_decomposition(jnp.asarray(tgt))
    th, tl = TC.wavelet_decomposition(t(tgt))
    assert_close(th, jh, COLOR_TOL)
    assert_close(tl, jl, COLOR_TOL)


@pytest.mark.parametrize("fix", ["masked_adain_color_fix", "masked_wavelet_color_fix"])
@pytest.mark.parametrize("hw", [(24, 20), (17, 9)])
def test_masked_color_fix(fix, hw):
    tgt, src = _images(9, (1, 24, 20, 3))
    h, w = hw
    ref = getattr(JC, fix)(jnp.asarray(tgt), jnp.asarray(src), jnp.int32(h), jnp.int32(w))
    out = getattr(TC, fix)(t(tgt), t(src), h, w)
    assert_close(out[:, :h, :w], np.asarray(ref)[:, :h, :w], COLOR_TOL)
    # and it equals crop -> unmasked fix, which is what it stands for
    plain = getattr(TC, fix.replace("masked_", ""))(t(tgt)[:, :h, :w], t(src)[:, :h, :w])
    assert_close(out[:, :h, :w], plain.numpy(), 2e-5)


def test_switched_color_fix_batch():
    tgt, src = _images(10, (3, 24, 20, 3))
    hw = np.asarray([[24, 20], [17, 9], [20, 20]], np.int32)
    idx = np.asarray([TC.ALIGN_IDX["wavelet"], TC.ALIGN_IDX["adain"], TC.ALIGN_IDX["nofix"]], np.int32)
    assert TC.ALIGN_IDX == JC.ALIGN_IDX
    ref = np.asarray(jax_once(JC.switched_color_fix_batch, jnp.asarray(tgt), jnp.asarray(src), jnp.asarray(hw),
                              jnp.asarray(idx)))
    out = TC.switched_color_fix_batch(t(tgt), t(src), hw, idx)
    for i, (h, w) in enumerate(hw):
        assert_close(out[i, :h, :w], ref[i, :h, :w], COLOR_TOL, f"image {i}")
    with pytest.raises(ValueError):
        TC.switched_color_fix_batch(t(tgt), t(src), hw, [0, 1, 7])
