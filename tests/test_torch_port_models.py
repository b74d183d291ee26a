"""Tiny VAE / UNet of the port against the JAX package, with weights in the
JAX package's tree structure (values drawn with numpy) carried across the
bridge. fp32 on the CPU.

Tolerance 1e-4: a few dozen f32 layers, each summed in another order on the
two sides (every single layer agrees to 1e-5, see test_torch_port_layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu.models.configs import SD21_UNET as J_SD21_UNET
from omgsr_tpu.models.configs import SD21_VAE as J_SD21_VAE
from omgsr_tpu.models.layers import count_params as j_count_params
from omgsr_tpu_torch.convert.params import from_jax_tree, init_unet, init_vae
from omgsr_tpu_torch.models import unet_sd as TU
from omgsr_tpu_torch.models import vae as TV
from omgsr_tpu_torch.models.configs import SD21_UNET, SD21_VAE
from omgsr_tpu_torch.models.layers import count_params
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
    to_numpy_tree,
)

TOL = 1e-4


@pytest.fixture(scope="module")
def vae_pair():
    jp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    return jp, bridge(jp)


@pytest.fixture(scope="module")
def unet_pair():
    jp = jax_init(JU.init_unet, 1, J_TINY_UNET)
    return jp, bridge(jp)


def _pixels(seed, shape=(2, 16, 16, 3)):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def test_vae_encode_features(vae_pair):
    jp, tp = vae_pair
    x = _pixels(0)
    ref = jax_once(lambda p, x: JV.vae_encode_features(p, J_TINY_VAE, x), jp, jnp.asarray(x))
    assert_close(TV.vae_encode_features(tp, T_TINY_VAE, t(x)), ref, TOL)


def test_vae_encode_mean(vae_pair):
    jp, tp = vae_pair
    x = _pixels(1)
    ref = jax_once(lambda p, x: JV.vae_encode(p, J_TINY_VAE, x, rng=None), jp, jnp.asarray(x))
    assert_close(TV.vae_encode(tp, T_TINY_VAE, t(x)), ref, TOL)
    assert_close(TV.vae_encode(tp, T_TINY_VAE, t(x), sample=False, noise=t(x[..., :1])), ref, TOL)


def test_vae_encode_with_shared_noise(vae_pair):
    """The two frameworks draw different numbers from a seed, so the test
    draws the noise with numpy and applies the JAX package's own formula to
    its moments."""
    jp, tp = vae_pair
    x = _pixels(2)
    noise = np.random.default_rng(3).standard_normal((2, 8, 8, 4)).astype(np.float32)
    moments = jax_once(lambda p, x: JV.vae_encode_features(p, J_TINY_VAE, x), jp, jnp.asarray(x))
    mean, logvar = jnp.split(moments, 2, axis=-1)
    ref = JV.scale_latent(J_TINY_VAE, mean + jnp.exp(0.5 * jnp.clip(logvar, -30.0, 20.0)) * noise)
    assert_close(TV.vae_encode(tp, T_TINY_VAE, t(x), noise=t(noise)), ref, TOL)


def test_vae_decode(vae_pair):
    jp, tp = vae_pair
    z = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(np.float32) * 0.2
    ref = jax_once(lambda p, z: JV.vae_decode(p, J_TINY_VAE, z), jp, jnp.asarray(z))
    assert_close(TV.vae_decode(tp, T_TINY_VAE, t(z)), ref, TOL)
    ref_raw = jax_once(lambda p, z: JV.vae_decode(p, J_TINY_VAE, z, unscale=False), jp, jnp.asarray(z))
    assert_close(TV.vae_decode(tp, T_TINY_VAE, t(z), unscale=False), ref_raw, TOL)


@pytest.mark.parametrize("batch,timestep", [(1, 273), (2, 999)])
def test_unet_apply(unet_pair, batch, timestep):
    jp, tp = unet_pair
    rng = np.random.default_rng(5)
    z = rng.standard_normal((batch, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((batch, 7, 16)).astype(np.float32)
    ref = jax_once(lambda p, a, c: JU.unet_apply(p, J_TINY_UNET, a, timestep, c), jp, jnp.asarray(z), jnp.asarray(ctx))
    assert_close(TU.unet_apply(tp, T_TINY_UNET, t(z), timestep, t(ctx)), ref, TOL)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("which", ["vae", "unet"])
def test_bridge_keeps_paths_and_transposes(which, vae_pair, unet_pair):
    jp, tp = vae_pair if which == "vae" else unet_pair
    jleaves = dict(_paths(to_numpy_tree(jp)))
    tleaves = dict(_paths(tp))
    rename = {"kernel": "weight", "scale": "weight"}
    assert {p[:-1] + (rename.get(p[-1], p[-1]),) for p in jleaves} == set(tleaves)
    for path, a in jleaves.items():
        b = tleaves[path[:-1] + (rename.get(path[-1], path[-1]),)]
        if path[-1] == "kernel" and a.ndim == 4:
            assert tuple(b.shape) == (a.shape[3], a.shape[2], a.shape[0], a.shape[1])
            np.testing.assert_array_equal(b.numpy(), a.transpose(3, 2, 0, 1))
        elif path[-1] == "kernel":
            np.testing.assert_array_equal(b.numpy(), a.T)
        else:
            np.testing.assert_array_equal(b.numpy(), a)
    # the seed-based initialisers build the same structure and shapes
    init = init_vae(0, T_TINY_VAE, device="cpu") if which == "vae" else init_unet(0, T_TINY_UNET, device="cpu")
    assert {p: tuple(v.shape) for p, v in _paths(init)} == {p: tuple(v.shape) for p, v in tleaves.items()}
    assert count_params(init) == count_params(tp) == j_count_params(jp)


def test_bridge_casts_and_refuses_odd_kernels():
    p = from_jax_tree({"a": {"kernel": np.ones((3, 3, 2, 4), np.float32), "bias": np.ones(4, np.float32)}},
                      dtype=torch.bfloat16, device="cpu")
    assert p["a"]["weight"].dtype == torch.bfloat16 and p["a"]["weight"].shape == (4, 2, 3, 3)
    assert p["a"]["weight"].is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        from_jax_tree({"kernel": np.ones((2, 2, 2), np.float32)}, device="cpu")


@pytest.mark.parametrize("which", ["vae", "unet"])
def test_full_width_parameter_count_equals_jax(which, monkeypatch):
    """SD2.1 width on both sides, with no full-width allocation on either:
    jax.eval_shape there, torch's meta device here."""
    from omgsr_tpu_torch.convert import params as P

    if which == "vae":
        shapes = jax.eval_shape(lambda k: JV.init_vae(k, J_SD21_VAE), jax.random.key(0))
    else:
        shapes = jax.eval_shape(lambda k: JU.init_unet(k, J_SD21_UNET), jax.random.key(0))
    want = j_count_params(shapes)

    # route the initialiser's two allocation points to the meta device
    monkeypatch.setattr(P._Init, "_uniform", lambda self, shape, bound: torch.empty(shape, device="meta"))
    monkeypatch.setattr(P._Init, "norm", lambda self, dim: {
        "weight": torch.empty(dim, device="meta"), "bias": torch.empty(dim, device="meta")})
    monkeypatch.setattr(P, "_conv_weight", lambda w: w)
    tree = P.init_vae(0, SD21_VAE, device="cpu") if which == "vae" else P.init_unet(0, SD21_UNET, device="cpu")
    assert count_params(tree) == want
    assert round(want / 1e6, 1) == (83.7 if which == "vae" else 865.9)
