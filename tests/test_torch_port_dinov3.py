"""The DINOv3 ViT (omgsr_tpu_torch/models/dinov3_vit.py), its hub porter and
the hub entries of the port, held against the JAX package on the same
weights (carried over by convert.params.from_jax_tree), in f32 on the CPU,
where the port's attention runs the flash kernel's plain version and the JAX
ViT runs jax.nn.dot_product_attention.

The tiny ViT: embed 128, 2 heads (head dim 64, a dim the flash kernel takes
on the card), depth 2, patch 16, on a non-square 48x32 input (a 3x2 patch
grid, 1 + 4 + 6 tokens). Each JAX reference is computed once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omgsr_tpu.hub as jhub
import omgsr_tpu_torch.hub as thub
from omgsr_tpu.models import dinov3_vit as JV
from omgsr_tpu.models.configs import DinoV3ViTConfig as JC
from omgsr_tpu_torch.convert.params import from_jax_tree, init_dinov3_vit, to_jax_tree
from omgsr_tpu_torch.models import dinov3_vit as TV
from omgsr_tpu_torch.models.configs import VIT_SIZES, DinoV3ViTConfig
from tests.torch_port_helpers import bridge, jax_init, t, torch_layout

TINY = dict(embed_dim=128, num_heads=2, depth=2, patch_size=16)
TOL = 1e-5  # max |port - JAX| / max |JAX|, f32

CONFIGS = {
    "mlp": {},  # rope_normalize_coords "separate", tied norms
    "swiglu": dict(ffn_layer="swiglu", ffn_ratio=6.0),
    "swiglu64": dict(ffn_layer="swiglu64", ffn_ratio=3.0, qkv_bias=False),
    "untied": dict(untie_cls_and_patch_norms=True),
    "rope_min": dict(rope_normalize_coords="min"),
    "rope_max": dict(rope_normalize_coords="max"),
}

_X = np.random.default_rng(7).standard_normal((2, 48, 32, 3)).astype(np.float32)
_MASKS = np.array([[1, 0, 0, 1, 0, 1], [0, 0, 1, 0, 0, 0]], bool)
_cache = {}


def _case(name):
    """(JAX config, port config, JAX tree, port tree) of a tiny config, made once."""
    if name not in _cache:
        jc, tc = JC(**TINY, **CONFIGS[name]), DinoV3ViTConfig(**TINY, **CONFIGS[name])
        jp = jax_init(JV.init_dinov3_vit, 3, jc)
        jp["rope_embed"]["periods"] = jnp.asarray(JV.rope_periods(jc), jnp.float32)
        _cache[name] = jc, tc, jp, bridge(jp)
    return _cache[name]


def _rel_err(port, ref):
    a = port.detach().float().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.size == 0:  # ConvNeXt's storage tokens (B, 0, C)
        return 0.0
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _assert_tree_close(port, ref, what):
    pl, rl = jax.tree.leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl), what
    for i, (a, b) in enumerate(zip(pl, rl)):
        err = _rel_err(a, b)
        assert err <= TOL, (what, i, err)


APPLY_CASES = [(name, False) for name in CONFIGS] + [("mlp", True), ("untied", True)]
GIL_FLAGS = [(n, reshape, norm, cls, extra) for n in (1, (0, 1)) for reshape in (False, True)
             for norm in (False, True) for cls in (False, True) for extra in (False, True)]


def _vit_cases():
    cases = [pytest.param("apply", name, masked, id=f"apply-{name}" + ("-masks" if masked else ""))
             for name, masked in APPLY_CASES]
    cases += [pytest.param("intermediate", name, flags, id=f"gil-{name}-n{flags[0]}-" + "".join(
        str(int(f)) for f in flags[1:])) for name in ("mlp", "untied") for flags in GIL_FLAGS]
    cases += [pytest.param("features", name, layers, id=f"vit_features-{name}-{layers}")
              for name in ("mlp", "swiglu64") for layers in (2, (1,))]
    return cases


@pytest.mark.parametrize("kind,name,arg", _vit_cases())
def test_vit_matches_jax(kind, name, arg):
    """dinov3_vit_apply (every ffn, both norm layouts, every RoPE coordinate
    mode, masks), get_intermediate_layers at every flag combination and
    vit_features, against the JAX package's functions."""
    jc, tc, jp, tp = _case(name)
    x, tx = jnp.asarray(_X), t(_X)
    if kind == "apply":
        masks = _MASKS if arg else None
        ref = JV.dinov3_vit_apply(jp, jc, x, masks=None if masks is None else jnp.asarray(masks))
        out = TV.dinov3_vit_apply(tp, tc, tx, masks=None if masks is None else torch.from_numpy(masks))
        assert set(out) == set(ref)
        for k in ref:
            assert _rel_err(out[k], ref[k]) <= TOL, k
    elif kind == "intermediate":
        n, reshape, norm, cls, extra = arg
        n = list(n) if isinstance(n, tuple) else n
        kw = dict(n=n, reshape=reshape, norm=norm, return_class_token=cls, return_extra_tokens=extra)
        ref = JV.get_intermediate_layers(jp, jc, x, **kw)
        out = TV.get_intermediate_layers(tp, tc, tx, **kw)
        assert len(out) == len(ref) == (1 if n == 1 else 2)
        _assert_tree_close(out, ref, kw)
    else:
        layers = list(arg) if isinstance(arg, tuple) else arg
        _assert_tree_close(TV.vit_features(tp, tc, tx, layers), JV.vit_features(jp, jc, x, layers), layers)


def test_configs_rope_and_init_structure():
    """VIT_SIZES and the derived widths equal the JAX package's; the RoPE
    tables equal its at a non-square grid in each mode; init_dinov3_vit has
    the JAX initialiser's tree (shapes, blocks "0".."depth-1", f32 periods);
    remat_blocks builds and gives the same features, with and without
    grad."""
    from omgsr_tpu.models.configs import VIT_SIZES as J_VIT_SIZES

    assert set(VIT_SIZES) == set(J_VIT_SIZES)
    for arch, cfg in VIT_SIZES.items():
        j = J_VIT_SIZES[arch]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j), arch
        assert (cfg.head_dim, cfg.swiglu_hidden) == (j.head_dim, j.swiglu_hidden), arch
    for name in ("mlp", "rope_min", "rope_max"):
        jc, tc, jp, tp = _case(name)
        for (a, b) in zip(TV.rope_sincos(tp, tc, 5, 3), JV.rope_sincos(jp, jc, 5, 3)):
            assert _rel_err(a, b) <= 1e-6, name
    for name in ("swiglu64", "untied"):
        jc, tc, _, _ = _case(name)
        want = jax.eval_shape(lambda k: JV.init_dinov3_vit(k, jc), jax.random.key(0))
        got = to_jax_tree(init_dinov3_vit(0, tc, torch.bfloat16, "cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(want)]
        assert sorted(got["blocks"], key=int) == [str(i) for i in range(tc.depth)]
    tree = init_dinov3_vit(0, _case("mlp")[1], torch.bfloat16, "cpu")
    assert tree["rope_embed"]["periods"].dtype == torch.float32 and tree["cls_token"].dtype == torch.bfloat16
    bf16 = from_jax_tree(jax.tree.map(np.asarray, _case("mlp")[2]), dtype=torch.bfloat16, device="cpu")
    assert bf16["rope_embed"]["periods"].dtype == torch.float32 and bf16["norm"]["weight"].dtype == torch.bfloat16
    jc, tc, _, tp = _case("mlp")
    remat = dataclasses.replace(tc, remat_blocks=True)
    assert remat.remat_blocks and dataclasses.replace(remat, remat_blocks=False) == tc
    want = TV.dinov3_vit_apply(tp, tc, t(_X), masks=torch.from_numpy(_MASKS))
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got = TV.dinov3_vit_apply(tp, remat, t(_X), masks=torch.from_numpy(_MASKS))
        assert all(torch.equal(got[k], want[k]) for k in want), grad


def _hub_state_dict(jp, jc):
    """The hub .pth layout of a JAX tree: torch-layout tensors, a k-masked qkv
    bias (bias_mask 0 on the k third) and the train-only local_cls_norm."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in torch_layout(jp).items()}
    d = jc.embed_dim
    for i in range(jc.depth):
        if f"blocks.{i}.attn.qkv.bias" in sd:
            mask = torch.ones(3 * d)
            mask[d:2 * d] = 0.0
            sd[f"blocks.{i}.attn.qkv.bias_mask"] = mask
    sd["local_cls_norm.weight"], sd["local_cls_norm.bias"] = torch.ones(d), torch.zeros(d)
    return sd


@pytest.mark.parametrize("name", ["mlp", "swiglu64", "untied"])
def test_port_dinov3_vit_matches_the_jax_porter(name, tmp_path):
    """port_dinov3_vit on a hub-layout .pth (and the same state dict in
    memory) gives the JAX porter's tree: the masked k bias folded, the
    local_cls_norm dropped, the leaves validated; a non-finite mask raises."""
    from omgsr_tpu.convert.porters import port_dinov3_vit as jax_port
    from omgsr_tpu_torch.convert.porters import port_dinov3_vit

    jc, tc, jp, _ = _case(name)
    sd = _hub_state_dict(jp, jc)
    torch.save({"model": sd}, tmp_path / "vit.pth")
    want = jax_port(str(tmp_path / "vit.pth"), cfg=jc)
    for src in (str(tmp_path / "vit.pth"), sd):
        got = to_jax_tree(port_dinov3_vit(src, cfg=tc, device="cpu"))
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    if jc.qkv_bias:
        folded = to_jax_tree(port_dinov3_vit(sd, cfg=tc, device="cpu"))["blocks"]["0"]["attn"]["qkv"]["bias"]
        d = jc.embed_dim
        assert not folded[d:2 * d].any() and folded[:d].any()
        bad = dict(sd)
        bad["blocks.1.attn.qkv.bias_mask"] = torch.full((3 * d,), float("nan"))
        with pytest.raises(ValueError, match="non-finite"):
            port_dinov3_vit(bad, cfg=tc, device="cpu")
    wrong = dict(sd)
    del wrong["blocks.0.norm1.weight"]
    with pytest.raises(ValueError, match="dinov3_vit port mismatch"):
        port_dinov3_vit(wrong, cfg=tc, device="cpu")


_HUB_X = np.random.default_rng(8).standard_normal((1, 64, 64, 3)).astype(np.float32)
HUB_VIT = dict(embed_dim=128, depth=2, num_heads=2)
HUB_CONVNEXT = dict(depths=(1, 1, 1, 1), dims=(8, 8, 8, 16))


@pytest.mark.parametrize("entry", [n for n in thub.__all__ if n != "HubModel" and not n.endswith("_lc")])
def test_hub_backbone_entries_build_and_match_jax(entry):
    """Every backbone entry builds at tiny overrides from a seed, with the JAX
    hub's config and tree structure; given that tree as a state dict
    (``weights=``), the port's and the JAX hub's apply (and
    get_intermediate_layers / forward_features) agree."""
    from omgsr_tpu_torch.convert.params import to_hf_state_dict

    convnext = "convnext" in entry
    over = HUB_CONVNEXT if convnext else HUB_VIT
    tm = getattr(thub, entry)(seed=0, device="cpu", **over)
    sd = to_hf_state_dict(tm.params["backbone"])
    jm = getattr(jhub, entry)(weights=sd, **over)
    assert dataclasses.asdict(tm.cfgs["backbone"]) == dataclasses.asdict(jm.cfgs["backbone"])
    mine = to_jax_tree(tm.params)
    assert jax.tree.structure(mine) == jax.tree.structure(jm.params)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(jm.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tm = getattr(thub, entry)(weights=sd, device="cpu", **over)
    x = _HUB_X if convnext else _X  # the ViT parity tests' input: their JAX primitives are compiled already
    _assert_tree_close(tm.apply(tm.params, t(x)), jm.apply(jm.params, jnp.asarray(x)), entry)
    if convnext:
        _assert_tree_close(tm.extras["forward_features"](tm.params, t(x)),
                           jm.extras["forward_features"](jm.params, jnp.asarray(x)), entry)
    else:
        kw = dict(n=2, reshape=True, return_class_token=True)
        _assert_tree_close(tm.extras["get_intermediate_layers"](tm.params, t(x), **kw),
                           jm.extras["get_intermediate_layers"](jm.params, jnp.asarray(x), **kw), entry)


def test_hub_linear_classifier_matches_jax():
    """dinov3_vit7b16_lc at a tiny ViT-7B-shaped backbone (swiglu64, no qkv
    bias): random weights from a seed build; with the backbone and the head
    given as state dicts, its logits match the JAX hub's on the same
    inputs."""
    over = dict(embed_dim=128, depth=2, num_heads=1)  # head dim 128, as ViT-7B's
    tm = thub.dinov3_vit7b16_lc(seed=0, device="cpu", num_classes=10, backbone_overrides=over)
    assert tm.apply(tm.params, t(_X)).shape == (2, 10)
    jc = JC(**{**dataclasses.asdict(tm.cfgs["backbone"])})
    jp = jax_init(JV.init_dinov3_vit, 5, jc)
    jp["rope_embed"]["periods"] = jnp.asarray(JV.rope_periods(jc), jnp.float32)
    backbone = _hub_state_dict(jp, jc)
    rng = np.random.default_rng(9)
    head = {"weight": torch.from_numpy(rng.standard_normal((10, 256)).astype(np.float32) * 0.1),
            "bias": torch.from_numpy(rng.standard_normal(10).astype(np.float32))}
    jm = jhub.dinov3_vit7b16_lc(weights=head, backbone_weights=backbone, num_classes=10, backbone_overrides=over)
    tm = thub.dinov3_vit7b16_lc(weights=head, backbone_weights=backbone, device="cpu", num_classes=10,
                                backbone_overrides=over)
    assert _rel_err(tm.apply(tm.params, t(_X)), jm.apply(jm.params, jnp.asarray(_X))) <= TOL
