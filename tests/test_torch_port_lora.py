"""LoRA in the port against the JAX package: the low-rank branches of dense
and conv2d, merge, attach/split, the bridge both ways and the initialiser's
structure. fp32 on the CPU, values drawn with numpy from a seed.

Tolerance 1e-5: one or two f32 products per function, summed in another
order on the two sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.lora import lora as JL
from omgsr_tpu.models import layers as JLayers
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu_torch.convert.params import from_jax_tree, to_jax_tree
from omgsr_tpu_torch.lora import lora as TL
from omgsr_tpu_torch.models import layers as TLayers
from omgsr_tpu_torch.models import vae as TV
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import (
    J_TINY_UNET,
    J_TINY_VAE,
    T_TINY_VAE,
    assert_close,
    bridge,
    jax_init,
    jax_lora_tree,
    jax_once,
    t,
    to_numpy_tree,
)

TOL = 1e-5


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("bias", [True, False])
def test_dense_lora_branch(bias):
    rng = np.random.default_rng(0)
    p = {"kernel": rng.standard_normal((12, 20)).astype(np.float32) * 0.2,
         "lora_A": rng.standard_normal((12, 4)).astype(np.float32) * 0.3,
         "lora_B": rng.standard_normal((4, 20)).astype(np.float32) * 0.3}
    if bias:
        p["bias"] = rng.standard_normal(20).astype(np.float32)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    tp = from_jax_tree(p, device="cpu")
    assert tp["lora_A"].shape == (4, 12) and tp["lora_B"].shape == (20, 4)
    assert_close(TLayers.dense(tp, t(x)), JLayers.dense(_jnp(p), jnp.asarray(x)), TOL)
    # the branch adds something: without it the result differs
    base = {k: v for k, v in tp.items() if not k.startswith("lora")}
    assert (TLayers.dense(tp, t(x)) - TLayers.dense(base, t(x))).abs().max() > 1e-2


@pytest.mark.parametrize("kh,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0), (3, 2, "VALID"), (3, 1, "SAME")])
def test_conv_lora_branch(kh, stride, padding):
    rng = np.random.default_rng(1)
    p = {"kernel": rng.standard_normal((kh, kh, 6, 10)).astype(np.float32) * 0.2,
         "bias": rng.standard_normal(10).astype(np.float32),
         "lora_A": rng.standard_normal((kh, kh, 6, 3)).astype(np.float32) * 0.3,
         "lora_B": rng.standard_normal((1, 1, 3, 10)).astype(np.float32) * 0.3}
    x = rng.standard_normal((2, 9, 8, 6)).astype(np.float32)
    tp = from_jax_tree(p, device="cpu")
    assert tp["lora_A"].shape == (3, 6, kh, kh) and tp["lora_B"].shape == (10, 3, 1, 1)
    ref = JLayers.conv2d(_jnp(p), jnp.asarray(x), stride=stride, padding=padding)
    assert_close(TLayers.conv2d(tp, t(x), stride=stride, padding=padding), ref, TOL)


def test_upsampler_with_lora_takes_the_plain_path():
    rng = np.random.default_rng(2)
    p = {"kernel": rng.standard_normal((3, 3, 4, 4)).astype(np.float32) * 0.2,
         "bias": rng.standard_normal(4).astype(np.float32),
         "lora_A": rng.standard_normal((3, 3, 4, 2)).astype(np.float32) * 0.3,
         "lora_B": rng.standard_normal((1, 1, 2, 4)).astype(np.float32) * 0.3}
    x = rng.standard_normal((1, 5, 6, 4)).astype(np.float32)
    ref = JLayers.upsample_conv_2x(_jnp(p), jnp.asarray(x))
    assert_close(TLayers.upsample_conv_2x(from_jax_tree(p, device="cpu"), t(x)), ref, TOL)


def test_depthwise_conv_matches_jax():
    rng = np.random.default_rng(3)
    p = {"kernel": rng.standard_normal((7, 7, 1, 6)).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, 10, 9, 6)).astype(np.float32)
    tp = from_jax_tree(p, device="cpu")
    assert tp["weight"].shape == (6, 1, 7, 7)
    assert_close(TLayers.depthwise_conv2d(tp, t(x), padding=3),
                 JLayers.depthwise_conv2d(_jnp(p), jnp.asarray(x), padding=3), TOL)


@pytest.fixture(scope="module")
def vae_with_lora():
    jp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    jl = jax_lora_tree(jp["encoder"], 2, seed=10)
    return jp, jl


def test_vae_encode_with_attached_lora(vae_with_lora):
    """1e-4 as for the models: a few dozen f32 layers."""
    jp, jl = vae_with_lora
    x = np.random.default_rng(4).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    jparams = dict(jp)
    jparams["encoder"] = JL.attach_lora(jp["encoder"], jl)
    ref = jax_once(lambda p, x: JV.vae_encode(p, J_TINY_VAE, x, rng=None), jparams, jnp.asarray(x))
    tp, tl = bridge(jp), bridge(jl)
    tparams = dict(tp)
    tparams["encoder"] = TL.attach_lora(tp["encoder"], tl)
    out = TV.vae_encode(tparams, T_TINY_VAE, t(x))
    assert_close(out, ref, 1e-4)
    assert (out - TV.vae_encode(tp, T_TINY_VAE, t(x))).abs().max() > 1e-3
    # attach copies nothing and split undoes it
    base, lora = TL.split_lora(tparams["encoder"])
    assert {p: v.data_ptr() for p, v in flatten_dict(base).items()} == \
        {p: v.data_ptr() for p, v in flatten_dict(tp["encoder"]).items()}
    assert set(flatten_dict(lora)) == set(flatten_dict(tl))


def test_merge_lora_matches_jax_and_the_attached_forward(vae_with_lora):
    jp, jl = vae_with_lora
    jm = JL.merge_lora(jp["encoder"], jl)
    tp, tl = bridge(jp), bridge(jl)
    tm = TL.merge_lora(tp["encoder"], tl)
    want = flatten_dict(bridge(jm))
    got = flatten_dict(tm)
    assert set(got) == set(want)
    for path in want:
        assert_close(got[path], want[path].numpy(), TOL, ".".join(path))
    x = np.random.default_rng(5).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    merged = dict(tp)
    merged["encoder"] = tm
    attached = dict(tp)
    attached["encoder"] = TL.attach_lora(tp["encoder"], tl)
    assert_close(TV.vae_encode(merged, T_TINY_VAE, t(x)),
                 TV.vae_encode(attached, T_TINY_VAE, t(x)).numpy(), 1e-4)


@pytest.mark.parametrize("which", ["vae_encoder", "unet"])
def test_init_lora_tree_structure_equals_jax(which):
    if which == "vae_encoder":
        jp = jax_init(JV.init_vae, 0, J_TINY_VAE)["encoder"]
    else:
        jp = jax_init(JU.init_unet, 1, J_TINY_UNET)
    rank = 3
    jl = jax.eval_shape(lambda k: JL.init_lora_tree(k, jp, JL.SD_TARGET_MODULES, rank), jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tl = TL.init_lora_tree(gen, bridge(jp), TL.SD_TARGET_MODULES, rank)
    back = to_jax_tree(tl)
    jshapes = {tuple(k.key for k in p): tuple(v.shape) for p, v in jax.tree_util.tree_leaves_with_path(jl)}
    assert {p: v.shape for p, v in flatten_dict(back).items()} == jshapes
    assert TL.lora_param_count(tl) == sum(int(np.prod(s)) for s in jshapes.values())
    flat = flatten_dict(tl)
    a = torch.cat([v.flatten() for p, v in flat.items() if p[-1] == "lora_A"])
    assert all((v == 0).all() for p, v in flat.items() if p[-1] == "lora_B")
    # A ~ N(0, 1) / rank
    assert abs(a.std().item() * rank - 1.0) < 0.1 and abs(a.mean().item()) < 0.05
    # the same generator state gives the same tree, a later state another
    again = TL.init_lora_tree(torch.Generator().manual_seed(0), bridge(jp), TL.SD_TARGET_MODULES, rank)
    assert all(torch.equal(v, flatten_dict(again)[p]) for p, v in flat.items())
    with pytest.raises(ValueError):
        TL.init_lora_tree(gen, bridge(jp), ("no_such_module",), rank)


def test_target_matching_equals_jax():
    for path in ("down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_q", "conv_in",
                 "encoder.conv_norm_out", "mid_block.resnets.0.conv_shortcut", "to_out.0",
                 "ff.net.0.proj", "downsamplers.0.conv", "time_emb_proj"):
        assert TL.path_matches_targets(path, TL.SD_TARGET_MODULES) == \
            JL.path_matches_targets(path, JL.SD_TARGET_MODULES), path
    assert TL.SD_TARGET_MODULES == JL.SD_TARGET_MODULES


def test_bridge_round_trip_of_a_lora_tree(vae_with_lora):
    _, jl = vae_with_lora
    want = to_numpy_tree(jl)
    back = to_jax_tree(bridge(jl))
    flat_w, flat_b = flatten_dict(want), flatten_dict(back)
    assert set(flat_w) == set(flat_b)
    for p in flat_w:
        np.testing.assert_array_equal(flat_b[p], flat_w[p])
