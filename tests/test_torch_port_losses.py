"""The training losses of the port against the JAX package on bridged
weights: ConvNeXt features, DISTS, DiffAugment with shared draws, the
spectral-norm discriminator. fp32 on the CPU, inputs drawn with numpy.

Tolerances: values 1e-4 (a dozen f32 layers summed in another order);
gradients 1e-3 of the gradient's largest entry (they pass through the same
layers twice and through divisions by small variances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.losses import diffaug as JDA
from omgsr_tpu.losses import discriminator as JD
from omgsr_tpu.losses import dists as JDISTS
from omgsr_tpu.models import convnext as JCN
from omgsr_tpu.models.configs import CONVNEXT_SIZES as J_CONVNEXT_SIZES
from omgsr_tpu.models.configs import ConvNeXtConfig as JConvNeXtConfig
from omgsr_tpu_torch.convert.params import init_convnext, init_discriminator, to_jax_tree
from omgsr_tpu_torch.losses import diffaug as TDA
from omgsr_tpu_torch.losses import discriminator as TD
from omgsr_tpu_torch.losses import dists as TDISTS
from omgsr_tpu_torch.models import convnext as TCN
from omgsr_tpu_torch.models.configs import CONVNEXT_SIZES, ConvNeXtConfig
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict
from tests.torch_port_helpers import (
    assert_close,
    bridge,
    jax_diffaug_draws,
    jax_init,
    jit_unoptimised,
    t,
)

VAL_TOL = 1e-4
GRAD_TOL = 1e-3

J_TINY_CN = JConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))
T_TINY_CN = ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))
TINY_HEADS = [([0.5, 1.0], [1, 2]), ([0.5], [1]), ([0.5], [1])]


def assert_grad_close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= GRAD_TOL * scale, (what, np.abs(got - want).max(), scale)


def _image(seed, shape=(2, 64, 64, 3)):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def backbone():
    jp = jax_init(lambda k, c: JCN.init_convnext(k, c), 0, J_TINY_CN)
    # gamma is 1e-6 in the initialiser: make the blocks count
    jp = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.5 if p[-1].key == "gamma" else v, jp)
    return jp, bridge(jp)


@pytest.fixture(scope="module")
def heads():
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(
        lambda k: JD.init_discriminator(k, J_TINY_CN.dims[:3], configs=TINY_HEADS)[:2], jax.random.key(0))
    fill = lambda leaf: jnp.asarray((rng.standard_normal(leaf.shape) * 0.3).astype(np.float32))
    jparams, jsn = jax.tree.map(fill, shapes)
    meta = {str(i): list(TINY_HEADS[i][1]) for i in range(3)}
    return (jparams, jsn, meta), (bridge(jparams), bridge(jsn), meta)


def test_convnext_features(backbone):
    jp, tp = backbone
    x = _image(0) * 2
    ref = jit_unoptimised(lambda p, a: JCN.convnext_features(p, a, num_stages=3), jp, jnp.asarray(x))
    out = TCN.convnext_features(tp, t(x), num_stages=3)
    assert len(out) == 3
    for i, (a, b) in enumerate(zip(out, ref)):
        assert_close(a, b, VAL_TOL, f"stage {i}")
    assert_close(TCN.normalize_from_pm1(t(x)), JCN.normalize_from_pm1(jnp.asarray(x)), 1e-6)


def test_l2_pool_and_blur_pool():
    x = np.random.default_rng(2).standard_normal((2, 9, 10, 6)).astype(np.float32)
    assert_close(TDISTS.l2_pool(t(x)), JDISTS.l2_pool(jnp.asarray(x)), 1e-6)
    assert_close(TD.blur_pool(t(x)), JD.blur_pool(jnp.asarray(x)), 1e-6)
    # l2_pool works in f32 whatever the input type
    assert TDISTS.l2_pool(t(x).bfloat16()).dtype == torch.bfloat16


def test_dists_loss_value_and_gradient(backbone):
    jp, tp = backbone
    x, y = _image(3), _image(4)
    jstate = JDISTS.init_dists(jp, J_TINY_CN.dims)
    tstate = TDISTS.init_dists(tp, T_TINY_CN.dims)
    assert tstate["channels"] == jstate["channels"] == [3, 8, 16, 24]
    ref, ref_grad = jit_unoptimised(
        jax.value_and_grad(lambda a, b: JDISTS.dists_loss(jstate, a, b)), jnp.asarray(x), jnp.asarray(y))
    xt = t(x).requires_grad_()
    out = TDISTS.dists_loss(tstate, xt, t(y))
    assert_close(out, ref, VAL_TOL)
    assert_grad_close(torch.autograd.grad(out, xt)[0], ref_grad)
    assert abs(TDISTS.dists_loss(tstate, t(x), t(x)).item()) < 1e-5


@pytest.mark.parametrize("policy", ["color,translation,cutout", "color", "translation", "cutout", ""])
def test_diff_augment_with_shared_draws(policy):
    x = _image(5, (3, 32, 24, 3))
    key = jax.random.key(11)
    # the JAX function consumes its 8 keys in policy order: replay them for
    # this policy by asking for the full policy's draws only when it is full
    if policy in ("color,translation,cutout", "color", ""):
        draws = jax_diffaug_draws(key, x.shape)
    else:
        # a single element takes the first key of the split
        ks = jax.random.split(key, 8)
        k1, k2 = jax.random.split(ks[0])
        b, h, w, _ = x.shape
        if policy == "translation":
            lo_y, hi_y, lo_x, hi_x = -int(h * 0.125 + 0.5), int(h * 0.125 + 0.5) + 1, \
                -int(w * 0.125 + 0.5), int(w * 0.125 + 0.5) + 1
        else:
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            lo_y, hi_y, lo_x, hi_x = 0, h + (1 - ch % 2), 0, w + (1 - cw % 2)
        a = t(np.asarray(jax.random.randint(k1, (b, 1, 1), lo_y, hi_y))).long()
        c = t(np.asarray(jax.random.randint(k2, (b, 1, 1), lo_x, hi_x))).long()
        z = torch.zeros(b, 1, 1, 1)
        draws = TDA.DiffAugDraws(z, z, z, a, c, a, c)
    ref = jit_unoptimised(lambda k, x: JDA.diff_augment(k, x, policy), key, jnp.asarray(x))
    assert_close(TDA.diff_augment(t(x), draws, policy), ref, 1e-6)


def test_draw_diffaug_ranges_and_determinism():
    shape = (64, 32, 24, 3)
    d = TDA.draw_diffaug(torch.Generator().manual_seed(0), shape, "cpu")
    for u in (d.brightness, d.saturation, d.contrast):
        assert u.shape == (64, 1, 1, 1) and 0 <= u.min() and u.max() < 1
    assert d.ty.min() >= -4 and d.ty.max() <= 4 and d.tx.min() >= -3 and d.tx.max() <= 3
    assert d.oy.min() >= 0 and d.oy.max() <= 32 and d.ox.min() >= 0 and d.ox.max() <= 24
    again = TDA.draw_diffaug(torch.Generator().manual_seed(0), shape, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    with pytest.raises(ValueError):
        TDA.diff_augment(torch.zeros(shape), d, "color,flip")


def test_spectral_normalize_value_state_and_gradient():
    """sigma's gradient flows through v but not through u: equal to the JAX
    package's, and different from a version that detaches v as torch's
    spectral_norm does."""
    rng = np.random.default_rng(6)
    k = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    u = rng.standard_normal(7).astype(np.float32)
    probe = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    (ref, ref_u), ref_grad = jax.value_and_grad(
        lambda kk: (lambda wn, un: ((wn * probe).sum(), un))(*JD._spectral_normalize(kk, jnp.asarray(u))),
        has_aux=True)(jnp.asarray(k))
    w = t(k.transpose(3, 2, 0, 1)).requires_grad_()
    wn, u_new = TD._spectral_normalize(w, t(u))
    out = (wn * t(probe.transpose(3, 2, 0, 1))).sum()
    assert_close(out, ref, 1e-4)
    assert_close(u_new, ref_u, 1e-5)
    assert not u_new.requires_grad
    grad = torch.autograd.grad(out, w)[0].permute(2, 3, 1, 0)
    assert_grad_close(grad, ref_grad)
    # detaching v (torch.nn.utils.spectral_norm's way) gives another gradient
    w2d = w.detach().permute(2, 3, 1, 0).reshape(-1, 7)
    v = w2d @ t(u)
    v = v / v.norm()
    wd = w.detach().clone().requires_grad_()
    sigma = v @ (wd.permute(2, 3, 1, 0).reshape(-1, 7) @ u_new)
    other = torch.autograd.grad(((wd / sigma) * t(probe.transpose(3, 2, 0, 1))).sum(), wd)[0]
    assert (other.permute(2, 3, 1, 0) - grad).abs().max() > 10 * GRAD_TOL * grad.abs().max()


@pytest.mark.parametrize("policy,for_real,for_G", [
    ("", True, False), ("", False, False), ("", False, True),
    ("color,translation,cutout", True, False), ("color,translation,cutout", False, True),
])
def test_discriminator_loss_value_state_and_gradients(backbone, heads, policy, for_real, for_G):
    jp, tp = backbone
    (jparams, jsn, meta), (tparams, tsn, _) = heads
    x = _image(7)
    key = jax.random.key(13)

    def jloss(dp, img):
        return JD.discriminator_loss(dp, jsn, meta, jp, key, img, for_real=for_real, for_G=for_G, policy=policy)

    (ref, ref_sn), (ref_gp, ref_gx) = jit_unoptimised(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True), jparams, jnp.asarray(x))
    draws = jax_diffaug_draws(key, x.shape) if policy else None
    leaves = {p: v.clone().requires_grad_() for p, v in flatten_dict(tparams).items()}
    xt = t(x).requires_grad_()
    out, new_sn = TD.discriminator_loss(unflatten_dict(leaves), tsn, meta, tp, draws, xt,
                                        for_real=for_real, for_G=for_G, policy=policy)
    assert_close(out, ref, VAL_TOL)
    want_sn = flatten_dict(bridge(ref_sn))
    got_sn = flatten_dict(new_sn)
    assert set(got_sn) == set(want_sn)
    for p in want_sn:
        assert_close(got_sn[p], want_sn[p].numpy(), 1e-5, ".".join(p))
        assert not got_sn[p].requires_grad
    grads = torch.autograd.grad(out, [xt] + list(leaves.values()))
    assert_grad_close(grads[0], ref_gx, "image")
    want = flatten_dict(bridge(ref_gp))
    for p, g in zip(leaves, grads[1:]):
        assert_grad_close(g, want[p].numpy(), ".".join(p))


def test_head_apply_refuses_collapsed_maps(heads):
    _, (tparams, tsn, meta) = heads
    with pytest.raises(ValueError, match="collapsed"):
        TD._head_apply(tparams["decoders"]["0"], tsn["decoders"]["0"], meta["0"], torch.zeros(1, 1, 1, 8))


@pytest.mark.parametrize("resolution", [512, 1024])
def test_initialisers_build_the_jax_structures(resolution):
    assert TD._head_configs(resolution) == JD._head_configs(resolution)
    chans = (8, 16, 24)
    jshapes = jax.eval_shape(lambda k: JD.init_discriminator(k, chans, resolution)[:2], jax.random.key(0))
    jmeta = {str(i): list(strides) for i, (_, strides) in enumerate(JD._head_configs(resolution))}
    params, sn, meta = init_discriminator(0, chans, resolution, device="cpu")
    assert meta == jmeta
    want = {tuple(k.key for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(jshapes[0])}
    got = {p[:-1] + ("kernel" if p[-1] == "weight" else p[-1],):
           (tuple(v.shape[2:]) + (v.shape[1], v.shape[0]) if p[-1] == "weight" else tuple(v.shape))
           for p, v in flatten_dict(params).items()}
    assert got == want
    assert {p: tuple(v.shape) for p, v in flatten_dict(sn).items()} == \
        {tuple(k.key for k in p): tuple(v.shape) for p, v in jax.tree_util.tree_leaves_with_path(jshapes[1])}
    assert all(v.dtype == torch.float32 for v in flatten_dict(sn).values())


def test_init_convnext_builds_the_jax_structure_and_the_large_size():
    jshapes = jax.eval_shape(lambda k: JCN.init_convnext(k, J_TINY_CN), jax.random.key(0))
    tp = init_convnext(0, T_TINY_CN, device="cpu")
    want = {tuple(k.key for k in p): tuple(v.shape) for p, v in jax.tree_util.tree_leaves_with_path(jshapes)}
    got = {p: tuple(v.shape) for p, v in flatten_dict(to_jax_tree(tp)).items()}
    assert got == want
    assert {k: (tuple(v.depths), tuple(v.dims)) for k, v in CONVNEXT_SIZES.items()} == \
        {k: (tuple(v.depths), tuple(v.dims)) for k, v in J_CONVNEXT_SIZES.items()}
