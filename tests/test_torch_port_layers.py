"""Layers, schedules and tiling tables of the port against the JAX package.
fp32 on the CPU, inputs and weights made with numpy from a seed.

Tolerance 1e-5 throughout: the same f32 arithmetic summed in another order
(XLA and ATen pick different reduction trees); integer tables are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.diffusion import schedules as JS
from omgsr_tpu.diffusion import tiling as JT
from omgsr_tpu.inference.tiled import auto_tile_batch as j_auto_tile_batch
from omgsr_tpu.models import layers as JL
from omgsr_tpu.models import vae as JV
from omgsr_tpu.utils.dtypes import resolve_dtype as j_resolve_dtype
from omgsr_tpu_torch.diffusion import schedules as TS
from omgsr_tpu_torch.diffusion import tiling as TT
from omgsr_tpu_torch.inference.tiled import auto_tile_batch
from omgsr_tpu_torch.models import layers as TL
from omgsr_tpu_torch.models import vae as TV
from omgsr_tpu_torch.utils.dtypes import resolve_dtype
from tests.torch_port_helpers import assert_close, bridge, t

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _conv_params(rng, kh, kw, cin, cout, bias=True):
    p = {"kernel": (rng.standard_normal((kh, kw, cin, cout)) * 0.2).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(cout).astype(np.float32)
    return p


def _jax(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("use_bias", [True, False])
def test_dense(use_bias):
    rng = _rng(1)
    p = {"kernel": rng.standard_normal((12, 7)).astype(np.float32)}
    if use_bias:
        p["bias"] = rng.standard_normal(7).astype(np.float32)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    assert_close(TL.dense(bridge(p), t(x)), JL.dense(_jax(p), jnp.asarray(x)), TOL)


@pytest.mark.parametrize(
    "k,stride,padding",
    [
        (3, 1, "SAME"), (3, 1, "VALID"), (3, 1, 1), (1, 1, 0), (3, 2, 1), (3, 2, "SAME"),
        (3, 2, "VALID"), (3, 1, ((0, 1), (2, 0))), (3, (2, 1), ((1, 1), (0, 1))),
    ],
)
def test_conv2d(k, stride, padding):
    rng = _rng(2)
    p = _conv_params(rng, k, k, 5, 6)
    x = rng.standard_normal((2, 9, 10, 5)).astype(np.float32)
    ref = JL.conv2d(_jax(p), jnp.asarray(x), stride=stride, padding=padding)
    assert_close(TL.conv2d(bridge(p), t(x), stride=stride, padding=padding), ref, TOL)


def _norm_params(rng, c):
    return {"scale": (rng.standard_normal(c) * 0.1 + 1).astype(np.float32),
            "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("fn", ["group_norm", "group_norm_silu"])
@pytest.mark.parametrize("groups,eps", [(4, 1e-6), (8, 1e-5)])
def test_group_norm(fn, groups, eps):
    rng = _rng(4)
    p = _norm_params(rng, 16)
    x = (rng.standard_normal((2, 6, 5, 16)) * 3 + 1).astype(np.float32)
    ref = getattr(JL, fn)(_jax(p), jnp.asarray(x), groups, eps)
    assert_close(getattr(TL, fn)(bridge(p), t(x), groups, eps), ref, TOL)


@pytest.mark.parametrize("params", ["affine", "scale_only", "none"])
def test_layer_norm(params):
    rng = _rng(5)
    p = _norm_params(rng, 16)
    if params == "scale_only":
        del p["bias"]
    x = (rng.standard_normal((2, 7, 16)) * 2 - 1).astype(np.float32)
    jp, tp = (None, None) if params == "none" else (_jax(p), bridge(p))
    assert_close(TL.layer_norm(tp, t(x)), JL.layer_norm(jp, jnp.asarray(x)), TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_and_silu(approximate):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    assert_close(TL.gelu(t(x), approximate), JL.gelu(jnp.asarray(x), approximate), TOL)
    assert_close(TL.silu(t(x)), JL.silu(jnp.asarray(x)), TOL)


@pytest.mark.parametrize("dim,flip,shift", [(8, True, 0.0), (9, False, 1.0), (320, True, 0.0)])
def test_timestep_embedding(dim, flip, shift):
    ts = np.asarray([273, 0, 999], np.int32)
    ref = JL.timestep_embedding(jnp.asarray(ts), dim, flip, shift)
    out = TL.timestep_embedding(torch.from_numpy(ts.astype(np.int64)), dim, flip, shift)
    # arguments reach 999 rad: sin/cos of a 1-ulp different f32 product differ by ~6e-5
    assert_close(out, ref, 1e-4)


def test_upsample():
    rng = _rng(6)
    p = _conv_params(rng, 3, 3, 4, 6)
    x = rng.standard_normal((2, 5, 7, 4)).astype(np.float32)
    assert_close(TL.nearest_upsample_2x(t(x)), JL.nearest_upsample_2x(jnp.asarray(x)), 0)
    # the JAX package computes this as four phase-decomposed 2x2 convs
    assert_close(TL.upsample_conv_2x(bridge(p), t(x)), JL.upsample_conv_2x(_jax(p), jnp.asarray(x)), TOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_downsample_conv_2x(hw):
    rng = _rng(7)
    p = _conv_params(rng, 3, 3, 4, 4)
    x = rng.standard_normal((1, *hw, 4)).astype(np.float32)
    assert_close(TV.downsample_conv_2x(bridge(p), t(x)), JV.downsample_conv_2x(_jax(p), jnp.asarray(x)), TOL)


def test_sample_diagonal_gaussian_and_scaling():
    from tests.torch_port_helpers import J_TINY_VAE, T_TINY_VAE

    rng = _rng(8)
    moments = (rng.standard_normal((1, 4, 4, 8)) * 20).astype(np.float32)  # logvar beyond the clamp
    noise = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    mean, logvar = np.split(moments, 2, axis=-1)
    ref = mean + np.exp(0.5 * np.clip(logvar, -30, 20)) * noise
    out = TV.sample_diagonal_gaussian(t(moments), noise=t(noise))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    assert_close(TV.sample_diagonal_gaussian(t(moments), sample=False), mean, 0)
    gen = torch.Generator().manual_seed(0)
    a = TV.sample_diagonal_gaussian(t(moments), generator=gen)
    b = TV.sample_diagonal_gaussian(t(moments), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TV.sample_diagonal_gaussian(t(moments))
    z = t(noise)
    assert_close(TV.scale_latent(T_TINY_VAE, z), JV.scale_latent(J_TINY_VAE, jnp.asarray(noise)), 1e-7)
    assert_close(TV.unscale_latent(T_TINY_VAE, z), JV.unscale_latent(J_TINY_VAE, jnp.asarray(noise)), 1e-6)


def test_schedules_exact():
    np.testing.assert_array_equal(TS.ddpm_alphas_cumprod(), JS.ddpm_alphas_cumprod())
    for ts in (0, 273, 999):
        assert TS.mid_timestep_coeffs_sd(ts) == JS.mid_timestep_coeffs_sd(ts)


@pytest.mark.parametrize("size,tile,overlap", [(96, 64, 32), (64, 64, 32), (100, 64, 32), (20, 8, 4), (5, 8, 4)])
def test_tile_grids_exact(size, tile, overlap):
    assert TT.tile_grid_1d(size, tile, overlap) == JT.tile_grid_1d(size, tile, overlap)
    assert TT.tile_grid_2d(size, size + 3, tile, overlap) == JT.tile_grid_2d(size, size + 3, tile, overlap)


def test_tile_tables_exact():
    np.testing.assert_array_equal(TT.gaussian_tile_weights(64, 64), JT.gaussian_tile_weights(64, 64))
    np.testing.assert_array_equal(TT.gaussian_tile_weights(8, 5), JT.gaussian_tile_weights(8, 5))
    with pytest.raises(ValueError):
        TT.tile_grid_1d(20, 8, 8)
    assert [auto_tile_batch(n) for n in range(0, 60)] == [j_auto_tile_batch(n) for n in range(0, 60)]


def test_resolve_dtype_names_agree():
    for name in ("no", "fp32", "float32", "bf16", "bfloat16", "fp16", "float16"):
        assert str(resolve_dtype(name)).split(".")[-1] == jnp.dtype(j_resolve_dtype(name)).name
    assert resolve_dtype(torch.bfloat16) is torch.bfloat16
