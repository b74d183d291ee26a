"""The SSL data path, the k-NN probe and the pretraining CLI of the port
(omgsr_tpu_torch/data/ssl.py, data/datasets.py, eval/probes.py,
cli/pretrain_dinov3.py) on the CPU.

The host modules are held bit for bit to the JAX package's on the same
images and the same np.random.Generator draws: the multi-crop augmentation,
the collate and its iBOT block masks, the samplers' streams, the dataset
specs on tiny fixtures (tests/test_datasets.py's), the eval transform. The
k-NN vote is held to the JAX one. The CLI runs end to end on the CPU
(``device=cpu``, ``arch=custom`` with a ``vit:`` override): a run resumed
from its iteration-2 checkpoint in a fresh directory gives the straight
run's iterations 3 and 4 and its teacher, and the teacher export reads back
into an ``init_dinov3_vit`` tree."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.data import datasets as JD
from omgsr_tpu.data import ssl as JS
from omgsr_tpu_torch.data import datasets as TD
from omgsr_tpu_torch.data import ssl as TS
from tests.test_datasets import _make_coco, _make_imagenet, _make_imagenet22k, _png_bytes


def _image(seed, w=77, h=61):
    return Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8), "RGB")


def _assert_batches_equal(a, b):
    assert set(a) == set(b), (set(a), set(b))
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


CROP_CASES = {
    "default": {},
    "gram-no-distortions": dict(gram_teacher_crops_size=48, gram_teacher_no_distortions=True),
    "gram-teacher-no-jitter": dict(gram_teacher_crops_size=40, teacher_no_color_jitter=True),
    "no-flips": dict(horizontal_flips=False, local_crops_number=3),
}


@pytest.mark.parametrize("name", sorted(CROP_CASES))
def test_multicrop_and_collate_bit_equal(name):
    """MultiCropAugmentation on four images and collate_ssl_batch (crops,
    masks, mask weights, counts) give the JAX package's arrays bit for bit
    from the same seeds."""
    kw = {**dict(global_crops_size=32, local_crops_size=16, local_crops_number=4), **CROP_CASES[name]}
    out = []
    for mod in (JS, TS):
        aug = mod.MultiCropAugmentation(mod.MultiCropConfig(**kw))
        rng = np.random.default_rng((5, 7))
        samples = [aug(rng, _image(i, 77 + 9 * i, 61 + 5 * i)) for i in range(4)]
        out.append(mod.collate_ssl_batch(samples, rng, mod.BlockMaskingGenerator(8), mask_ratio_tuple=(0.1, 0.5),
                                         mask_probability=0.5))
    _assert_batches_equal(out[1], out[0])
    assert out[1]["masks"].any() and out[1]["global_crops"].shape == (8, 32, 32, 3)


def test_block_masks_and_crop_primitives_bit_equal():
    """The block-mask generator at several counts and grids, random_resized_crop
    and color_jitter: equal draws, equal outputs."""
    for grid, counts in ((14, (0, 19, 58, 98)), ((6, 9), (5, 27))):
        for c in counts:
            a = JS.BlockMaskingGenerator(grid)(np.random.default_rng(c), c)
            b = TS.BlockMaskingGenerator(grid)(np.random.default_rng(c), c)
            np.testing.assert_array_equal(b, a)
            assert b.sum() == c
    img = _image(3)
    for seed in range(4):
        a = JS.random_resized_crop(np.random.default_rng(seed), img, 24, (0.05, 0.4))
        b = TS.random_resized_crop(np.random.default_rng(seed), img, 24, (0.05, 0.4))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        a = JS.color_jitter(np.random.default_rng(seed), img)
        b = TS.color_jitter(np.random.default_rng(seed), img)
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("kind", ["epoch", "infinite", "infinite-advance", "sharded", "sharded-advance", "unshuffled"])
def test_sampler_streams_equal(kind):
    def stream(mod):
        if kind == "epoch":
            s = mod.EpochSampler(size=23, sample_count=10, shuffle=True, seed=3, start=1, step=2)
            s.set_epoch(2)
            return list(s)
        if kind.startswith("infinite") or kind == "unshuffled":
            it = iter(mod.InfiniteSampler(sample_count=7, shuffle=kind != "unshuffled", seed=4, start=1, step=2,
                                          advance=9 if kind.endswith("advance") else 0))
        else:
            it = iter(mod.ShardedInfiniteSampler(sample_count=11, shuffle=True, seed=5, start=2, step=3,
                                                 advance=13 if kind.endswith("advance") else 0))
        return [next(it) for _ in range(40)]

    assert stream(TS) == stream(JS)


def test_dataset_specs_read_the_same_items(tmp_path):
    """ImageNet, ImageNet22k (with a gzipped tar member), ADE20K and
    CocoCaptions through make_dataset on the fixtures of tests/test_datasets.py:
    the port's items equal the JAX package's pixel for pixel, targets too;
    list_ssl_images of both CLIs agree on a spec and on a directory."""
    from omgsr_tpu.cli.pretrain_dinov3 import list_ssl_images as j_list
    from omgsr_tpu_torch.cli.pretrain_dinov3 import list_ssl_images as t_list

    rng = np.random.default_rng(11)
    in1k = _make_imagenet(tmp_path, rng)
    in1k_extra = str(tmp_path / "extra1k")
    TD.ImageNetDataset(root=in1k, extra=in1k_extra, split="train").dump_extra()
    in22k, _ = _make_imagenet22k(tmp_path, rng)
    in22k_extra = str(tmp_path / "extra22k")
    TD.ImageNet22kDataset(root=in22k, extra=in22k_extra).dump_extra()
    ade = tmp_path / "ade"
    (ade / "images").mkdir(parents=True)
    (ade / "annotations").mkdir()
    names = ["ADE_train_00000001.jpg", "ADE_train_00000002.jpg"]
    for n in names:
        (ade / "images" / n).write_bytes(_png_bytes(rng))
        Image.fromarray(rng.integers(0, 150, (24, 32), dtype=np.uint8), "L").save(
            ade / "annotations" / (os.path.splitext(n)[0] + ".png"))
    (ade / "ADE20K_object150_train.txt").write_text("\n".join(names) + "\n")
    coco = _make_coco(tmp_path, rng)
    specs = [f"ImageNet:split=TRAIN:root={in1k}:extra={in1k_extra}", f"ImageNet22k:root={in22k}:extra={in22k_extra}",
             f"ADE20K:split=TRAIN:root={ade}", f"CocoCaptions:split=TRAIN:root={coco}"]
    for spec in specs:
        assert TD.is_dataset_spec(spec) and JD.is_dataset_spec(spec)
        a, b = JD.make_dataset(spec), TD.make_dataset(spec)
        assert type(b).__name__ == type(a).__name__ and len(b) == len(a) > 0, spec
        for i in range(len(a)):
            (ia, ta), (ib, tb) = a[i], b[i]
            np.testing.assert_array_equal(np.asarray(ib), np.asarray(ia))
            if isinstance(ta, Image.Image):
                np.testing.assert_array_equal(np.asarray(tb), np.asarray(ta))
            elif not spec.startswith("CocoCaptions"):  # a caption is a draw per access
                assert tb == ta, (spec, i)
        for ds in (a, b):
            if hasattr(ds, "close"):
                ds.close()
    got, want = t_list(specs[1]), j_list(specs[1])
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    assert t_list(os.path.join(in1k, "train", "n01440764")) == j_list(os.path.join(in1k, "train", "n01440764"))
    assert not TD.is_dataset_spec("/data/images") and not TD.is_dataset_spec(["a", "b"])
    with pytest.raises(ValueError):
        TD.make_dataset("FooSet:root=/x")


def test_knn_probe_matches_jax(tmp_path):
    """knn_classify (with and without skipping the first neighbour), the eval
    transform, list_imagefolder and extract_features against the JAX
    package's."""
    from omgsr_tpu.eval import probes as JP
    from omgsr_tpu_torch.eval import probes as TP

    rng = np.random.default_rng(12)
    tr = rng.standard_normal((30, 16)).astype(np.float32)
    tr /= np.linalg.norm(tr, axis=-1, keepdims=True)
    te = rng.standard_normal((7, 16)).astype(np.float32)
    te /= np.linalg.norm(te, axis=-1, keepdims=True)
    labels = rng.integers(0, 4, 30)
    for skip in (False, True):
        a = JP.knn_classify(jnp.asarray(tr), jnp.asarray(labels), jnp.asarray(te), ks=(1, 5, 20), num_classes=4,
                            skip_first_nn=skip)
        b = TP.knn_classify(torch.from_numpy(tr), torch.from_numpy(labels), torch.from_numpy(te), ks=(1, 5, 20),
                            num_classes=4, skip_first_nn=skip)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=1e-5, atol=1e-6)
    for ci in range(2):
        (tmp_path / "f" / f"c{ci}").mkdir(parents=True)
        for j in range(3):
            _image(20 + 3 * ci + j, 50 + 7 * j, 40).save(tmp_path / "f" / f"c{ci}" / f"{j}.png")
    (pa, la, ca), (pb, lb, cb) = JP.list_imagefolder(str(tmp_path / "f")), TP.list_imagefolder(str(tmp_path / "f"))
    assert pa == pb and ca == cb and la.tolist() == lb.tolist()
    for mod in (JP, TP):
        assert mod.make_eval_transform(36, 32)(_image(5)).shape == (32, 32, 3)
    np.testing.assert_array_equal(TP.make_eval_transform(36, 32)(_image(5)), JP.make_eval_transform(36, 32)(_image(5)))
    w = rng.standard_normal((32 * 32 * 3, 5)).astype(np.float32)
    fa = JP.extract_features(lambda x: jnp.asarray(x).reshape(x.shape[0], -1) @ w, pa, 4, JP.make_eval_transform(36, 32))
    fb = TP.extract_features(lambda x: torch.from_numpy(x).reshape(x.shape[0], -1) @ torch.from_numpy(w), pb, 4,
                             TP.make_eval_transform(36, 32))
    assert fb.shape == (6, 5)
    np.testing.assert_allclose(fb, fa, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# the CLI end to end on the CPU
# ----------------------------------------------------------------------------


def _write_images(root, n=6):
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (64, 80, 3), dtype=np.uint8), "RGB").save(root / f"{i}.png")


def _tiny(tmp_path, out, **kw):
    from omgsr_tpu_torch.cli.pretrain_dinov3 import SSLPretrainConfig

    base = dict(output_dir=str(tmp_path / out), dataset_paths=str(tmp_path / "imgs"), batch_size_per_device=2,
                official_epoch_length=4, epochs=1, warmup_epochs=0, warmup_teacher_temp_epochs=0,
                freeze_last_layer_epochs=0, saveckp_freq=2, print_freq=1, arch="custom", device="cpu",
                mixed_precision="no", global_crops_size=32, local_crops_size=16, local_crops_number=4,
                dino_out_dim=64, dino_hidden_dim=32, dino_bottleneck_dim=16, dino_nlayers=2, ibot_out_dim=64,
                ibot_hidden_dim=32, ibot_bottleneck_dim=16, ibot_nlayers=2,
                extra={"vit": {"embed_dim": 128, "depth": 2, "num_heads": 2, "patch_size": 8}})
    base.update(kw)
    return SSLPretrainConfig(**base)


def test_pretrain_cli_resumes_like_the_straight_run(tmp_path):
    """Four iterations on the CPU at head dim 64 (the ViT's heads through the
    flash Function's plain versions); a second run in a fresh directory that
    resumes from the first run's iteration-2 checkpoint gives iterations 3 and
    4 and the teacher of the straight run, bit for bit; the teacher export
    reads back into an init_dinov3_vit tree and runs through the hub's ViT;
    the k-NN eval writes its accuracies."""
    from omgsr_tpu_torch import hub
    from omgsr_tpu_torch.cli.pretrain_dinov3 import main, run_pretraining
    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.training.checkpoint import restore_train_state
    from omgsr_tpu_torch.utils.tree import flatten_dict

    _write_images(tmp_path / "imgs")
    for ci in range(2):
        _write_images(tmp_path / "knn" / f"c{ci}", 2)
    straight = run_pretraining(_tiny(tmp_path, "straight", eval_period_iterations=4,
                                     eval_knn_train_dir=str(tmp_path / "knn"), eval_resize_size=36,
                                     eval_crop_size=32))
    assert [h["it"] for h in straight["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["total_loss"]) and h["loader_wait_s"] >= 0 and h["loader_batch_s"] > 0
               for h in straight["history"])
    out = tmp_path / "straight"
    assert sorted(os.listdir(out / "checkpoints")) == ["checkpoint-1.pt", "checkpoint-3.pt"]
    assert os.path.exists(out / "eval" / "knn-3.json")
    (tmp_path / "resumed" / "checkpoints").mkdir(parents=True)
    shutil.copy(out / "checkpoints" / "checkpoint-1.pt", tmp_path / "resumed" / "checkpoints")
    resumed = main(["output_dir=" + str(tmp_path / "resumed"), "dataset_paths=" + str(tmp_path / "imgs")]
                   + [f"{k}={v}" for k, v in _cli_overrides().items()])
    assert [h["it"] for h in resumed["history"]] == [2, 3]
    for a, b in zip(resumed["history"], straight["history"][2:]):
        assert {k: v for k, v in a.items() if k.endswith("loss")} == {k: v for k, v in b.items() if k.endswith("loss")}
    for tree in ("teacher", "student"):
        fa, fb = flatten_dict(resumed[tree]), flatten_dict(straight[tree])
        assert all(torch.equal(fa[k], fb[k]) for k in fb), tree
    cfg = _tiny(tmp_path, "x")
    from omgsr_tpu_torch.cli.pretrain_dinov3 import vit_config

    vit_cfg = vit_config(cfg)
    back = restore_train_state(str(out / "eval" / "teacher-3" / "backbone.pt"), init_dinov3_vit(1, vit_cfg,
                                                                                                device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(flatten_dict(back).values(),
                                                  flatten_dict(straight["teacher"]["backbone"]).values()))
    m = hub.dinov3_vitl16(device="cpu", **cfg.extra["vit"])
    feats = m.apply({"backbone": back}, torch.zeros(1, 32, 32, 3))
    assert feats["x_norm_patchtokens"].shape == (1, 16, 128) and torch.isfinite(feats["x_norm_clstoken"]).all()


def _cli_overrides():
    return {"batch_size_per_device": 2, "official_epoch_length": 4, "epochs": 1, "warmup_epochs": 0,
            "warmup_teacher_temp_epochs": 0, "freeze_last_layer_epochs": 0, "saveckp_freq": 2, "print_freq": 1,
            "arch": "custom", "device": "cpu", "mixed_precision": "fp32", "global_crops_size": 32,
            "local_crops_size": 16, "local_crops_number": 4, "dino_out_dim": 64, "dino_hidden_dim": 32,
            "dino_bottleneck_dim": 16, "dino_nlayers": 2, "ibot_out_dim": 64, "ibot_hidden_dim": 32,
            "ibot_bottleneck_dim": 16, "ibot_nlayers": 2,
            "vit": "{embed_dim: 128, depth: 2, num_heads: 2, patch_size: 8}"}


def test_pretrain_config_and_world_refusal(tmp_path, monkeypatch):
    """load_ssl_config reads the port's recipes as the JAX package reads its
    own (every key, the unknown ones into extra), takes key=value overrides,
    and has the one added key ``device``; a torchrun world of two raises
    naming ROADMAP Queue 1 item 3.2b before it builds anything."""
    import dataclasses

    from omgsr_tpu.cli.pretrain_dinov3 import SSLPretrainConfig as JCfg
    from omgsr_tpu.cli.pretrain_dinov3 import load_ssl_config as j_load
    from omgsr_tpu_torch.cli.pretrain_dinov3 import SSLPretrainConfig, load_ssl_config, run_pretraining

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("ssl_vitl16", "ssl_vitl16_distilled", "ssl_vit7b16_pretrain", "ssl_vit7b16_gram_anchor",
                 "ssl_vit7b16_high_res_adapt"):
        ov = ["dataset_paths=/data", "vit={remat_blocks: true}", "lr=2e-3"]
        a = load_ssl_config(os.path.join(root, "omgsr_tpu_torch", "configs", f"{name}.yml"), ov)
        b = j_load(os.path.join(root, "omgsr_tpu", "configs", f"{name}.yml"), ov)
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("device") == "cuda" and da == db, name
    assert {f.name for f in dataclasses.fields(SSLPretrainConfig)} - {f.name for f in dataclasses.fields(JCfg)} \
        == {"device"}
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="3.2b"):
        run_pretraining(_tiny(tmp_path, "world"))
    assert not os.path.exists(tmp_path / "world")
