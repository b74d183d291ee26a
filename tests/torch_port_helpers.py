"""Shared helpers of the tests/test_torch_port_*.py files: tiny configs on
both sides and the weight bridge from a JAX parameter tree."""

import jax
import numpy as np
import torch

from omgsr_tpu.models.configs import UNetConfig as JUNetConfig
from omgsr_tpu.models.configs import VAEConfig as JVAEConfig
from omgsr_tpu_torch.convert.params import from_jax_tree
from omgsr_tpu_torch.models.configs import UNetConfig, VAEConfig

_TINY_VAE = dict(block_out_channels=(8, 16), norm_num_groups=4, latent_channels=4)
_TINY_UNET = dict(
    block_out_channels=(8, 16, 16, 16),
    num_attention_heads=(1, 2, 2, 2),
    cross_attention_dim=16,
    norm_num_groups=4,
)
J_TINY_VAE, T_TINY_VAE = JVAEConfig(**_TINY_VAE), VAEConfig(**_TINY_VAE)
J_TINY_UNET, T_TINY_UNET = JUNetConfig(**_TINY_UNET), UNetConfig(**_TINY_UNET)


def to_numpy_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def bridge(jax_tree):
    """JAX parameter tree -> the port's parameters on the CPU, fp32."""
    return from_jax_tree(to_numpy_tree(jax_tree), dtype=torch.float32, device="cpu")


def t(a):
    """numpy -> CPU tensor (a copy, so neither side can alias the other)."""
    return torch.from_numpy(np.array(a, copy=True))


def assert_close(port_out, jax_out, tol, what=""):
    a = port_out.detach().cpu().numpy() if isinstance(port_out, torch.Tensor) else np.asarray(port_out)
    b = np.asarray(jax_out)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=what)


def jax_init(init_fn, seed, cfg):
    """A parameter tree with the structure and shapes of the JAX package's
    initialiser (taken with jax.eval_shape, which allocates and compiles
    nothing) and values drawn with numpy from a seed: kernels uniform in
    +-1/sqrt(fan_in) like the initialiser's, biases and norm parameters
    perturbed so that no affine term is trivially 0 or 1. Returned as jnp
    arrays; ``bridge`` carries it to the port."""
    shapes = jax.eval_shape(lambda k: init_fn(k, cfg), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            a = rng.uniform(-bound, bound, leaf.shape)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return jax.numpy.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)
