"""The port's SR eval path against the JAX package on the CPU: PSNR and SSIM
(1e-5), NIQE's features, pristine fit and score (1e-9; the same numpy code),
LPIPS, DISTS and CLIP-IQA on seeded random weights (1e-5), the LPIPS and
CLIP-vision porters from files in the published layouts (equal), and
eval_sr.main on tiny PNG pairs against the JAX CLI's JSON, field by field,
with the port's four intended divergences asserted."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.cli import eval_sr as JEVAL
from omgsr_tpu.losses import dists as JD
from omgsr_tpu.models import clip_vision as JCV
from omgsr_tpu.models import convnext as JCN
from omgsr_tpu.utils import lpips as JL
from omgsr_tpu.utils import metrics as JM
from omgsr_tpu.utils import niqe as JN
from omgsr_tpu_torch.cli import eval_sr as EVAL
from omgsr_tpu_torch.convert import porters as PORT
from omgsr_tpu_torch.losses import dists as TD
from omgsr_tpu_torch.models import clip_vision as TCV
from omgsr_tpu_torch.utils import lpips as TL
from omgsr_tpu_torch.utils import metrics as TM
from omgsr_tpu_torch.utils import niqe as TN
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import assert_close, bridge, jax_init, jax_once, t, to_numpy_tree, torch_layout

TOL = 1e-5
NIQE_TOL = 1e-9
_TINY_CLIP = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2, image_size=32,
                  patch_size=8, projection_dim=16)
J_CLIP, T_CLIP = JCV.CLIPVisionConfig(**_TINY_CLIP), TCV.CLIPVisionConfig(**_TINY_CLIP)
_CN = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))


def _images(seed, shape=(2, 40, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    return a, np.clip(a + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)


def test_psnr_and_ssim_match():
    a, b = _images(0)
    assert_close(TM.psnr(t(a), t(b)), JM.psnr(jnp.asarray(a), jnp.asarray(b)), TOL, "psnr")
    assert_close(TM.ssim(t(a), t(b)), JM.ssim(jnp.asarray(a), jnp.asarray(b)), TOL, "ssim")
    y = a[..., :1]
    assert_close(TM.ssim(t(y), t(b[..., :1])), JM.ssim(jnp.asarray(y), jnp.asarray(b[..., :1])), TOL, "ssim Y")


def test_niqe_features_fit_and_score_match():
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 1, (130, 100, 3)) for _ in range(3)]
    gray = TN.to_gray255(imgs[0])
    np.testing.assert_allclose(gray, JN.to_gray255(imgs[0]), rtol=0, atol=NIQE_TOL)
    f, s = TN.image_features(gray)
    jf, js = JN.image_features(gray)
    np.testing.assert_allclose(f, jf, rtol=NIQE_TOL, atol=NIQE_TOL)
    np.testing.assert_allclose(s, js, rtol=NIQE_TOL, atol=NIQE_TOL)
    model, jmodel = TN.fit_pristine(imgs[:2]), JN.fit_pristine(imgs[:2])
    for k in ("mu", "cov"):
        np.testing.assert_allclose(model[k], jmodel[k], rtol=NIQE_TOL, atol=NIQE_TOL)
    assert abs(TN.niqe(imgs[2], model) - JN.niqe(imgs[2], jmodel)) <= NIQE_TOL


def _jax_lpips_to_port(tree):
    """The JAX LPIPS tree (convs HWIO under "weight") in the port's layout (OIHW)."""
    feats = {k: {"weight": t(np.transpose(np.asarray(v["weight"]), (3, 2, 0, 1))), "bias": t(np.asarray(v["bias"]))}
             for k, v in tree["features"].items()}
    return {"features": feats, "lins": {k: t(np.asarray(v)) for k, v in tree["lins"].items()}}


def test_lpips_dists_and_clipiqa_match_on_seeded_weights():
    a, b = _images(2, (2, 32, 32, 3))
    jl = JL.init_lpips(jax.random.key(0))
    assert_close(TL.lpips(_jax_lpips_to_port(jl), t(a) * 2 - 1, t(b) * 2 - 1),
                 jax_once(JL.lpips, jl, a * 2 - 1, b * 2 - 1), TOL, "lpips")
    from omgsr_tpu.models.configs import ConvNeXtConfig as JConvNeXtConfig

    jcfg = JConvNeXtConfig(**_CN)
    jb = jax_init(lambda k, c: JCN.init_convnext(k, c), 3, jcfg)
    jb = jax.tree_util.tree_map_with_path(lambda p, v: v + 0.5 if p[-1].key == "gamma" else v, jb)
    ref = jax_once(lambda p, x, y: JD.dists_loss(JD.init_dists(p, jcfg.dims), x, y), jb, a * 2 - 1, b * 2 - 1)
    assert_close(TD.dists_loss(TD.init_dists(bridge(jb), _CN["dims"]), t(a) * 2 - 1, t(b) * 2 - 1), ref, TOL,
                 "dists")
    jc = jax_init(JCV.init_clip_vision, 4, J_CLIP)
    prompts = np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)
    ref = jax_once(lambda p, x, e: JCV.clipiqa_score(p, J_CLIP, x, e), jc, a, prompts)
    tc = bridge(jc)
    assert_close(TCV.clipiqa_score(tc, T_CLIP, t(a), t(prompts)), ref, TOL, "clipiqa")
    # the hidden states and the pooled output on their own
    px = np.asarray(JCV.clip_preprocess(jnp.asarray(a), J_CLIP))
    assert_close(TCV.clip_preprocess(t(a), T_CLIP), px, TOL, "preprocess")
    jh, jp = jax_once(lambda p, x: JCV.clip_vision_apply(p, J_CLIP, x), jc, px)
    th, tp = TCV.clip_vision_apply(tc, T_CLIP, t(px))
    assert_close(th, jh, TOL, "hidden")
    assert_close(tp, jp, TOL, "pooled")


def _lpips_pths(root, seed=0):
    g = torch.Generator().manual_seed(seed)
    sd_v, cin = {}, 3
    for slice_idxs, cout in zip(TL.VGG16_SLICES, TL.VGG16_CHANNELS):
        for idx in slice_idxs:
            sd_v[f"features.{idx}.weight"] = torch.randn((cout, cin, 3, 3), generator=g) / math.sqrt(9 * cin)
            sd_v[f"features.{idx}.bias"] = torch.randn((cout,), generator=g) * 0.01
            cin = cout
    sd_v["classifier.0.weight"] = torch.zeros(2, 2)
    sd_l = {f"lin{i}.model.1.weight": torch.rand((1, c, 1, 1), generator=g) / c
            for i, c in enumerate(TL.VGG16_CHANNELS)}
    torch.save(sd_v, root / "vgg16.pth")
    torch.save(sd_l, root / "vgg_lins.pth")
    return str(root / "vgg16.pth"), str(root / "vgg_lins.pth")


def _clip_dir(root, seed=6, logit_scale=math.log(100.0)):
    """A CLIPModel directory in the published layout: the tiny vision tower
    with its projection, a text tower, text_projection, logit_scale and a
    config.json nesting vision_config."""
    from safetensors.numpy import save_file

    from omgsr_tpu.models import clip_text as JCT
    from omgsr_tpu.models.configs import CLIPTextConfig as JCLIPTextConfig

    root.mkdir(parents=True, exist_ok=True)
    jc = jax_init(JCV.init_clip_vision, seed, J_CLIP)
    text_cfg = dict(vocab_size=64, hidden_size=16, intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
                    eos_token_id=63)
    jt = jax_init(JCT.init_clip_text, seed + 1, JCLIPTextConfig(**text_cfg))
    state = {**torch_layout(jc), **torch_layout(jt)}
    rng = np.random.default_rng(seed)
    state["text_projection.weight"] = rng.standard_normal((16, 16)).astype(np.float32)
    state["logit_scale"] = np.asarray(logit_scale, np.float32)
    state["vision_model.embeddings.position_ids"] = np.arange(17, dtype=np.int64)[None]
    save_file(state, str(root / "model.safetensors"))
    (root / "config.json").write_text(json.dumps({"vision_config": _TINY_CLIP, "text_config": text_cfg,
                                                  "projection_dim": 16}))
    return jc


def test_porters_read_the_published_layouts(tmp_path):
    vgg, lins = _lpips_pths(tmp_path)
    got = TL.port_lpips(vgg, lins, device="cpu")
    want = JL.port_lpips(vgg, lins)
    assert_close(got["lins"]["4"], want["lins"]["4"], 0)
    for k, v in want["features"].items():
        np.testing.assert_array_equal(got["features"][k]["weight"].numpy(),
                                      np.transpose(np.asarray(v["weight"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(got["features"][k]["bias"].numpy(), np.asarray(v["bias"]))
    with pytest.raises(ValueError, match="expected"):
        TL.port_lpips(vgg, {f"lin{i}.model.1.weight": torch.zeros(1, 3, 1, 1) for i in range(5)}, device="cpu")

    _clip_dir(tmp_path / "clip")
    params = PORT.port_clip_vision(str(tmp_path / "clip"), device="cpu")  # the tiny config from config.json
    assert float(params.pop("logit_scale")) == pytest.approx(math.log(100.0))
    from omgsr_tpu.convert.porters import port_clip_vision as j_port_clip_vision

    want = flatten_dict(to_numpy_tree(j_port_clip_vision(str(tmp_path / "clip"), cfg=J_CLIP)))
    got = flatten_dict(bridge_back(params))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    with pytest.raises(ValueError, match="clip_vision port mismatch"):
        PORT.port_clip_vision(str(tmp_path / "clip"), cfg=TCV.CLIPVisionConfig(**{**_TINY_CLIP, "patch_size": 4}),
                              device="cpu")


def bridge_back(params):
    from omgsr_tpu_torch.convert.params import to_jax_tree

    tree = to_jax_tree(params)
    # the JAX porter keeps the 2-D position table under "weight" (the bridge names 2-D weights "kernel")
    emb = tree["vision_model"]["embeddings"]
    emb["position_embedding"] = {"weight": emb["position_embedding"].pop("kernel").T}
    return tree


# ----------------------------------------------------------------------------
# eval_sr.main against the JAX CLI
# ----------------------------------------------------------------------------


def _save(path, arr01):
    Image.fromarray((np.clip(arr01, 0, 1) * 255).round().astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """GT/SR pairs (a degraded copy, a shifted copy, an identical copy, and
    one pair smaller than the metric crop and the NIQE grid), a pristine
    model fitted by niqe.main on seeded images, the LPIPS .pth files, a
    ConvNeXt .pth, a CLIPModel directory and the prompt pair."""
    root = tmp_path_factory.mktemp("eval")
    gt, sr, pristine = root / "gt", root / "sr", root / "pristine"
    for d in (gt, sr, pristine):
        d.mkdir()
    rng = np.random.default_rng(7)
    for name, size in (("deg", 96), ("shift", 96), ("same", 96), ("tiny", 24)):
        img = rng.uniform(0.1, 0.9, (size, size, 3)).astype(np.float32)
        _save(gt / f"{name}.png", img)
        img = np.asarray(Image.open(gt / f"{name}.png"), np.float32) / 255.0
        out = {"deg": np.clip(img + rng.normal(0, 0.08, img.shape), 0, 1), "shift": np.roll(img, 3, axis=1),
               "same": img, "tiny": np.clip(img + 0.1, 0, 1)}[name]
        _save(sr / f"{name}_out.png" if name == "deg" else sr / f"{name}.png", out)
    for i in range(2):
        _save(pristine / f"p{i}.png", rng.uniform(0, 1, (128, 128, 3)))
    TN.main(["fit", str(pristine), str(root / "pristine.npz")])
    vgg, lins = _lpips_pths(root)
    from omgsr_tpu.models.configs import ConvNeXtConfig as JConvNeXtConfig

    cn = jax_init(lambda k, c: JCN.init_convnext(k, c, with_final_norm=True), 8, JConvNeXtConfig(**_CN))
    torch.save({"model": {k: torch.from_numpy(np.array(v)) for k, v in torch_layout(cn).items()}}, root / "cn.pth")
    _clip_dir(root / "clip")
    # an antonym pair close enough that the softmax at temperature 100 does not saturate
    p0 = rng.standard_normal(16)
    np.savez(root / "prompts.npz", prompt_embeds=np.stack([p0, p0 + 0.05 * rng.standard_normal(16)]).astype(np.float32))
    args = ["--sr_dir", str(sr), "--gt_dir", str(gt), "--crop_border", "2", "--metric_crop", "32", "--dists",
            "--dinov3_weights_path", str(root / "cn.pth"), "--dinov3_size", "micro", "--lpips", "--lpips_vgg", vgg,
            "--lpips_lins", lins, "--clipiqa", "--clip_vision_path", str(root / "clip"), "--clipiqa_prompts_npz",
            str(root / "prompts.npz"), "--niqe_params", str(root / "pristine.npz")]
    return root, args


@pytest.fixture(scope="module")
def both_cli_json(eval_dirs):
    """Both CLIs on the same files. The JAX CLI builds its CLIP tower from
    CLIP-L's config whatever the directory says (the port reads the
    directory's), so it is handed the tiny config."""
    from omgsr_tpu.models import configs as JCFG
    from omgsr_tpu_torch.models import configs as TCFG

    root, args = eval_dirs
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JCFG.CONVNEXT_SIZES, "micro", JCFG.ConvNeXtConfig(**_CN))
        mp.setitem(TCFG.CONVNEXT_SIZES, "micro", TCFG.ConvNeXtConfig(**_CN))
        mp.setattr(JCV, "CLIP_L_VISION", J_CLIP)
        JEVAL.main(args + ["--output", str(root / "jax.json")])
        EVAL.main(args + ["--output", str(root / "port.json"), "--device", "cpu"])
    return json.load(open(root / "jax.json")), json.load(open(root / "port.json"))


def test_eval_main_matches_the_jax_cli(both_cli_json):
    jout, out = both_cli_json
    assert [r["name"] for r in out["per_image"]] == [r["name"] for r in jout["per_image"]] == \
        ["same.png", "shift.png", "tiny.png", "deg_out.png"]
    for r, jr in zip(out["per_image"], jout["per_image"]):
        assert set(r) == set(jr), r["name"]
        for k in ("psnr", "ssim", "dists", "lpips", "clipiqa"):
            assert abs(r[k] - jr[k]) <= TOL * max(1.0, abs(jr[k])), (r["name"], k, r[k], jr[k])
        if jr["niqe"] is None:  # the 24-px pair is below the NIQE grid: null in both
            assert r["niqe"] is None and r["name"] == "tiny.png"
        else:
            assert abs(r["niqe"] - jr["niqe"]) <= NIQE_TOL, r["name"]
    assert all(0.05 < r["clipiqa"] < 0.99 for r in out["per_image"])  # not saturated
    same = out["per_image"][0]
    assert same["psnr"] == pytest.approx(120.0) and same["lpips"] == pytest.approx(0.0, abs=1e-6)
    for k, v in jout["summary"].items():
        got = out["summary"][k]
        assert got == pytest.approx(v, rel=TOL, abs=NIQE_TOL if "niqe" in k else TOL), k


def test_eval_divergences_are_the_port_s_intended_behaviour(eval_dirs, tmp_path, caplog):
    """The four ADVICE findings on the JAX CLI, fixed in the port: (1)
    infinities serialise as "inf" in rows and summary alike, NaN as null;
    (2) the CLIP config comes from the directory (the JAX CLI needed CLIP-L's
    patched over); (3) the checkpoint's logit_scale is used; (4) an image
    smaller than --metric_crop is scored at full size with a warning."""
    root, _ = eval_dirs
    assert EVAL.strict_json({"summary": {"psnr_mean": math.inf}, "per_image": [{"psnr": -math.inf, "niqe": math.nan}]}) \
        == {"summary": {"psnr_mean": "inf"}, "per_image": [{"psnr": "-inf", "niqe": None}]}
    # (2) and (3): a directory whose logit_scale is log(50) scores at temperature 50
    _clip_dir(tmp_path / "clip50", logit_scale=math.log(50.0))
    fn = EVAL.build_clipiqa_fn(str(tmp_path / "clip50"), str(root / "prompts.npz"), device="cpu")
    img = np.asarray(Image.open(root / "sr" / "shift.png"), np.float32) / 255.0
    params = PORT.port_clip_vision(str(tmp_path / "clip50"), device="cpu")
    prompts = torch.from_numpy(np.load(root / "prompts.npz")["prompt_embeds"])
    with torch.no_grad():
        want50 = float(TCV.clipiqa_score(params, T_CLIP, t(img)[None], prompts)[0])
        want100 = float(TCV.clipiqa_score(params, T_CLIP, t(img)[None], prompts, logit_scale=100.0)[0])
    assert fn(img) == pytest.approx(want50, abs=1e-7) and abs(want50 - want100) > 1e-3
    # (4)
    a = np.zeros((24, 24, 3), np.float32)
    with caplog.at_level("WARNING", logger="omgsr_tpu_torch.eval_sr"):
        out = EVAL._center_crop_multiple(a, a, 32, "tiny.png")
    assert out[0].shape == (24, 24, 3) and "smaller than --metric_crop 32" in caplog.text
