"""The port's OMGSR-S data path against the JAX package on the CPU: the blur
kernels and plans from one numpy seed (equal), filter2d / usm_sharp /
resize / DiffJPEG / noise / colour jitter (f32 tolerances below), the whole
Real-ESRGAN ``degrade`` in uint8 steps, the degrader's numpy stream, the
paired dataset (equal arrays, native decoder and PIL), the loader's order
and length, and the loader with the degradation as a whole.

The port draws its random numbers from a torch.Generator; here it is handed
the JAX package's draws instead (``jax_with_draws`` records every
``jax.random`` call of one jitted JAX function, ``ReplayDraws`` hands them out
in the same order), so the two compute on the same numbers."""

import dataclasses
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omgsr_tpu.data import dataset as JDS
from omgsr_tpu.data import degradation as JDG
from omgsr_tpu.data import kernels as JK
from omgsr_tpu_torch.data import dataset as TDS
from omgsr_tpu_torch.data import degradation as TDG
from omgsr_tpu_torch.data import imgdec_native
from omgsr_tpu_torch.data import kernels as TK
from omgsr_tpu_torch.ops import diffjpeg as TD
from omgsr_tpu_torch.ops import filters as TF
from omgsr_tpu_torch.ops import noise as TN
from omgsr_tpu_torch.ops import resize as TR
from omgsr_tpu_torch.ops.noise import ReplayDraws
from tests.torch_port_helpers import assert_close, jax_once, jax_with_draws, t

# omgsr_tpu.ops re-exports functions under its modules' names
JF, JR, JD, JN = (importlib.import_module(f"omgsr_tpu.ops.{m}") for m in ("filters", "resize", "diffjpeg", "noise"))

OPT = TDG.load_degradation_params()


def _img(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_the_package_copy_of_the_parameters_is_the_jax_package_s():
    import yaml

    with open("omgsr_tpu/configs/params_realesrgan.yml") as f:
        assert OPT == yaml.safe_load(f)


# --------------------------------------------------------------------------- host draws


@pytest.mark.parametrize("resolution", [512, 1024])
def test_random_kernels_equal_over_five_calls(resolution):
    jcfg, tcfg = JK.KernelSynthesisConfig.from_opt(OPT, resolution), TK.KernelSynthesisConfig.from_opt(OPT, resolution)
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(5):
        for a, b in zip(JK.random_kernels(rj, jcfg), TK.random_kernels(rt, tcfg)):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (jcfg.kernel_max,) * 2
            assert np.array_equal(a, b)
    assert rj.bit_generator.state == rt.bit_generator.state


@pytest.mark.parametrize("snap", [1, 16])
def test_draw_plan_equal_over_five_calls(snap):
    opt = {**OPT, "gray_prob": 0.5, "color_jitter_prob": 0.5}
    rj, rt = np.random.default_rng(12), np.random.default_rng(12)
    for _ in range(5):
        pj = JDG.draw_plan(rj, opt, 100, 84, 4, True, snap)
        pt = TDG.draw_plan(rt, opt, 100, 84, 4, True, snap)
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
    assert rj.bit_generator.state == rt.bit_generator.state


# --------------------------------------------------------------------------- device ops

@pytest.mark.parametrize("h, w, p", [(5, 7, 2), (5, 7, 4), (5, 7, 9), (3, 2, 10), (1, 4, 3), (1, 1, 2)])
def test_reflect_pad_is_numpy_s(h, w, p):
    x = np.arange(2 * h * w, dtype=np.float32).reshape(2, h, w)
    assert np.array_equal(TF.reflect_pad(t(x), p).numpy(), np.pad(x, ((0, 0), (p, p), (p, p)), mode="reflect"))


@pytest.mark.parametrize("kernel", ["shared 21", "per-sample 21", "per-sample 41"])
def test_filter2d_matches(kernel):
    x = _img((2, 44, 50, 3), 1)
    k = int(kernel.split()[1])
    rng = np.random.default_rng(2)
    # anisotropic kernels: not symmetric, so a flipped kernel would show
    w = rng.uniform(0, 1, (1 if kernel.startswith("shared") else 2, k, k)).astype(np.float32)
    w /= w.sum(axis=(1, 2), keepdims=True)
    w = w[0] if kernel.startswith("shared") else w
    ref = jax_once(JF.filter2d, jnp.asarray(x), jnp.asarray(w))
    assert_close(TF.filter2d(t(x), t(w)), ref, 1e-5, kernel)


def test_usm_sharp_matches():
    x = _img((2, 40, 36, 3), 3)
    ref = jax_once(lambda a: JF.usm_sharp(a, radius=11), jnp.asarray(x))
    assert_close(TF.usm_sharp(t(x), radius=11), ref, 1e-5)


@pytest.mark.parametrize("mode", ["area", "bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(33, 47), (9, 13), (20, 28)], ids=["up", "down", "keep"])
def test_resize_matches(mode, size):
    x = _img((2, 20, 28, 3), 4)
    ref = JR.resize(jnp.asarray(x), *size, mode)
    assert_close(TR.resize(t(x), *size, mode), ref, 1e-5, mode)


@pytest.mark.parametrize("snap", [1, 16])
def test_resize_by_scale_matches(snap):
    x = _img((1, 20, 28, 3), 4)
    ref = JR.resize_by_scale(jnp.asarray(x), 1.37, "bicubic", snap)
    assert_close(TR.resize_by_scale(t(x), 1.37, "bicubic", snap), ref, 1e-5)


@pytest.mark.parametrize("quality", ["scalar", "per-sample"])
def test_diffjpeg_matches(quality):
    """At 36x44, no multiple of 16 (padded inside). The rounding of each DCT
    coefficient is the one place an f32 difference could become a whole
    quantisation step; on these inputs none does, so 1e-4 holds everywhere."""
    x = _img((2, 36, 44, 3), 5)
    q = np.float32(71.5) if quality == "scalar" else np.array([35.0, 92.0], np.float32)
    ref = jax_once(JD.diffjpeg, jnp.asarray(x), jnp.asarray(q))
    got = TD.diffjpeg(t(x), float(q) if quality == "scalar" else t(q))
    assert_close(got, ref, 1e-4, quality)
    assert np.abs(got.numpy() - x).max() > 0.01  # it did compress


@pytest.mark.parametrize("kind", ["gaussian", "poisson"])
def test_noise_matches_with_jax_draws(kind):
    x = _img((3, 12, 10, 3), 6)
    if kind == "gaussian":
        ref, draws = jax_with_draws(lambda k, a: JN.add_gaussian_noise(k, a, (1, 15), 0.5), jax.random.key(7),
                                    jnp.asarray(x))
        replay = ReplayDraws(draws, "cpu")
        got = TN.add_gaussian_noise(replay, t(x), (1, 15), 0.5)
    else:
        ref, draws = jax_with_draws(lambda k, a: JN.add_poisson_noise(k, a, (0.05, 2.0), 0.5), jax.random.key(7),
                                    jnp.asarray(x))
        replay = ReplayDraws(draws, "cpu")
        got = TN.add_poisson_noise(replay, t(x), (0.05, 2.0), 0.5)
    assert replay.left() == 0 and len(draws) == 4
    assert_close(got, ref, 1e-6, kind)


def test_unique_value_counts_are_exact():
    rng = np.random.default_rng(8)
    # per sample a different number of levels, quantised as the noise function does
    x = np.stack([np.round(rng.integers(0, n, (9, 7, 3)) * (255 // n)) / 255.0 for n in (1, 3, 17, 200)])
    x = x.astype(np.float32)
    ref = np.asarray(JN._unique_vals(jnp.asarray(x)))
    got = TN.unique_vals(t(x)).numpy()
    assert np.array_equal(got, ref), (got, ref)


def test_color_jitter_matches_with_jax_draws():
    x = _img((2, 10, 12, 3), 9)
    order = (3, 1, 0, 2)
    ref, draws = jax_with_draws(lambda k, a: JDG._color_jitter(k, a, order), jax.random.key(3), jnp.asarray(x))
    replay = ReplayDraws(draws, "cpu")
    assert_close(TDG._color_jitter(replay, t(x), order), ref, 1e-5)
    assert replay.left() == 0


# --------------------------------------------------------------------------- degrade

# every branch of the plan at least once: both noise kinds in both stages, both orders of the final
# JPEG and resize, the second blur, gray, jitter, resize-back; the last one at unsnapped sizes
_PLANS = {
    "gauss-poisson,resize-then-jpeg,blur2": dict(gaussian1=True, gaussian2=False, resize_then_jpeg=True,
                                                 second_blur=True, gray=False, jitter=False, resize_bak=True),
    "poisson-gauss,jpeg-then-resize,gray,jitter": dict(gaussian1=False, gaussian2=True, resize_then_jpeg=False,
                                                       second_blur=False, gray=True, jitter=True, resize_bak=True),
    "poisson-poisson,jitter,no-bak": dict(gaussian1=False, gaussian2=False, resize_then_jpeg=True, second_blur=True,
                                          gray=False, jitter=True, resize_bak=False),
    "gauss-gauss,gray,unsnapped": dict(gaussian1=True, gaussian2=True, resize_then_jpeg=False, second_blur=True,
                                       gray=True, jitter=False, resize_bak=True, size1=(45, 53), size2=(13, 17)),
}
# uint8 steps: the last operation rounds x*255 to an integer, so a pixel that sits within a few f32
# ulps of a .5 boundary can land one step apart on the two sides; at most this share of pixels may
MAX_ONE_STEP_SHARE = 1e-3


@pytest.mark.parametrize("name", list(_PLANS))
def test_degrade_matches_in_uint8_steps(name):
    rng = np.random.default_rng(40 + list(_PLANS).index(name))
    opt = {**OPT, "scale": 4}
    kcfg = TK.KernelSynthesisConfig.from_opt(OPT, 512)
    ks = [TK.random_kernels(rng, kcfg) for _ in range(2)]
    kernels = [np.stack([k[i] for k in ks]) for i in range(3)]
    modes = [str(m) for m in rng.choice(TDG._MODES, 4)]
    plan = dataclasses.replace(
        TDG.draw_plan(rng, opt, 64, 64, 4, True, 16), mode1=modes[0], mode2=modes[1], final_mode=modes[2],
        bak_mode=modes[3], jitter_order=tuple(int(i) for i in rng.permutation(4)), **_PLANS[name])
    x = _img((2, 64, 64, 3), 10)
    jplan = JDG.DegradationPlan(**dataclasses.asdict(plan))
    ref, draws = jax_with_draws(lambda a, k, key: JDG.degrade(a, k, key, jplan, opt), jnp.asarray(x),
                                tuple(jnp.asarray(k) for k in kernels), jax.random.key(5))
    replay = ReplayDraws(draws, "cpu")
    got = TDG.degrade(t(x), tuple(t(k) for k in kernels), replay, plan, opt).numpy()
    assert replay.left() == 0
    ref = np.asarray(ref)
    assert got.shape == ref.shape == ((2, 64, 64, 3) if plan.resize_bak else (2, 16, 16, 3))
    steps = np.abs(np.round(got * 255) - np.round(ref * 255))
    assert steps.max() <= 1, (name, steps.max())
    assert (steps > 0).mean() <= MAX_ONE_STEP_SHARE, (name, (steps > 0).mean())
    if plan.resize_bak:
        assert np.abs(got - x).mean() > 0.01  # it did degrade


def test_degrader_draws_the_jax_package_s_stream():
    """Three calls: the same kernels, plans and per-call seeds, the numpy
    stream in lockstep (the device work is left out on both sides)."""
    jdeg = JDG.RealESRGANDegrader(OPT, resolution=512, size_snap=16, seed=4)
    tdeg = TDG.RealESRGANDegrader(OPT, resolution=512, size_snap=16, seed=4)
    seen_j, seen_t = [], []
    jdeg._degrade = lambda plan: (lambda img, kernels, key: seen_j.append(
        (plan, [np.asarray(k) for k in kernels], int(jax.random.key_data(key)[-1]))) or img)
    real = TDG.degrade
    TDG.degrade = lambda img, kernels, draws, plan, opt: seen_t.append(
        (plan, [k.numpy() for k in kernels], draws.generator.initial_seed())) or img
    try:
        for i in range(3):
            x = _img((2, 96, 80, 3), 20 + i)
            jdeg(jnp.asarray(x))
            tdeg(t(x))
    finally:
        TDG.degrade = real
    assert len(seen_j) == len(seen_t) == 3
    for (pj, kj, sj), (pt, kt, st) in zip(seen_j, seen_t):
        assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
        assert all(np.array_equal(a, b) for a, b in zip(kj, kt))
        assert sj == st
    assert jdeg.rng.bit_generator.state == tdeg.rng.bit_generator.state


# --------------------------------------------------------------------------- dataset and loader


def _smooth(h, w, rng):
    """A natural-looking image: low-frequency colour fields plus a little noise."""
    small = Image.fromarray(rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8))
    arr = np.asarray(small.resize((w, h), Image.BILINEAR), np.float32)
    return np.clip(arr + rng.normal(0, 4, arr.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    """PNG and JPEG files: one larger than the crop each way, one smaller than
    it in one side (reflect pad), one smaller in both (pad and bilinear
    resize), an FFHQ face (LANCZOS to 512), two named only in a .txt list."""
    root = tmp_path_factory.mktemp("hq")
    rng = np.random.default_rng(30)
    (root / "a").mkdir()
    (root / "b").mkdir()
    files = {"a/big.png": (560, 640), "a/big.jpg": (520, 700), "a/short.png": (400, 600),
             "a/tiny.jpeg": (200, 300), "a/ffhq_00001.png": (256, 256), "b/listed.png": (530, 530),
             "b/listed.jpg": (600, 520)}
    for name, (h, w) in files.items():
        Image.fromarray(_smooth(h, w, rng)).save(root / name, quality=90)
    (root / "list.txt").write_text(f"{root / 'b' / 'listed.png'}\n{root / 'b' / 'listed.jpg'}\n")
    return [str(root / "a"), str(root / "list.txt")]


def test_native_decoder_builds_under_build_and_decodes_as_the_jax_one(image_dirs):
    from omgsr_tpu.data import imgdec_native as JNATIVE

    assert imgdec_native.load_library() is not None, imgdec_native.status()
    assert "omgsr_tpu_torch/build/libimgdec-" in imgdec_native.status()
    for path in TDS.collect_paths(image_dirs):
        if "ffhq" not in path:
            assert np.array_equal(imgdec_native.decode_rgb(path), JNATIVE.decode_rgb(path)), path
    assert imgdec_native.decode_rgb(image_dirs[1]) is None  # not an image type it reads


def test_dataset_gives_the_jax_package_s_arrays(image_dirs):
    jds, tds = JDS.PairedDataset(image_dirs, 512, seed=3), TDS.PairedDataset(image_dirs, 512, seed=3)
    assert jds.gt_list == tds.gt_list and len(tds) == 7
    for _ in range(2):  # twice: the crops and flips move on with the stream
        for i in range(len(tds)):
            a, b = jds[i], tds[i]
            assert b.shape == (512, 512, 3) and b.dtype == np.float32
            assert np.array_equal(a, b), tds.gt_list[i]
    assert tds.decoders == {"native": 12, "pil": 2}


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_and_length_are_the_jax_package_s(image_dirs, drop_last):
    jds, tds = JDS.PairedDataset(image_dirs, 64, seed=1), TDS.PairedDataset(image_dirs, 64, seed=1)
    jl = JDS.PairedLoader(jds, 3, None, seed=2, drop_last=drop_last)
    tl = TDS.PairedLoader(tds, 3, None, seed=2, drop_last=drop_last, device="cpu")
    assert len(jl) == len(tl) == (2 if drop_last else 3)
    for _ in range(2):  # a second epoch reshuffles
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            assert isinstance(b["hq"], torch.Tensor) and b["hq"].dtype == torch.float32
            assert np.array_equal(np.asarray(a["hq"]), b["hq"].numpy())
            assert np.array_equal(b["lq"].numpy(), b["hq"].numpy())
        assert tb[-1]["hq"].shape[0] == (3 if drop_last else 1)


def test_loader_with_the_degradation_matches_the_jax_package_s(image_dirs):
    """The slice as a whole: dataset, loader and degrader of both packages
    from the same seeds, the port handed each JAX call's draws."""
    jdeg = JDG.RealESRGANDegrader(OPT, resolution=512, size_snap=16, seed=6)
    tdeg = TDG.RealESRGANDegrader(OPT, resolution=512, size_snap=16, seed=6)
    recorded = []

    def jax_build(plan):
        def run(img, kernels, key):
            out, draws = jax_with_draws(lambda a, k, kk: JDG.degrade(a, k, kk, plan, jdeg.opt), img, kernels, key)
            recorded.append(draws)
            return out
        return run

    jdeg._degrade = jax_build
    real_call = tdeg.__call__

    def replayed(img):
        out = real_call(img, draws=ReplayDraws(recorded.pop(0), img.device))
        tdeg.rng.integers(0, 2**31)  # the per-call seed the JAX degrader draws for its key
        return out

    jl = JDS.PairedLoader(JDS.PairedDataset(image_dirs, 64, seed=1), 3, jdeg, seed=2)
    tl = TDS.PairedLoader(TDS.PairedDataset(image_dirs, 64, seed=1), 3, None, seed=2, device="cpu")
    tl.degrader = replayed
    jb = list(jl)
    tb = list(tl)
    assert len(jb) == len(tb) == 2 and not recorded
    for a, b in zip(jb, tb):
        assert np.array_equal(np.asarray(a["hq"]), b["hq"].numpy())
        lq_j, lq_t = (np.asarray(a["lq"]) + 1) * 127.5, (b["lq"].numpy() + 1) * 127.5
        steps = np.abs(np.round(lq_j) - np.round(lq_t))
        assert steps.max() <= 1 and (steps > 0).mean() <= MAX_ONE_STEP_SHARE, (steps.max(), (steps > 0).mean())
    assert jdeg.rng.bit_generator.state == tdeg.rng.bit_generator.state


def test_loader_raises_the_producer_s_error_and_stops_its_thread(image_dirs):
    class Broken(TDS.PairedDataset):
        def __getitem__(self, idx):
            if idx == 2:
                raise OSError("unreadable image")
            return np.zeros((8, 8, 3), np.float32)

    loader = TDS.PairedLoader(Broken(image_dirs, 8), 1, None, shuffle=False, device="cpu")
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="unreadable"):
        list(loader)
    # a consumer that stops early stops the producer
    for _ in TDS.PairedLoader(TDS.PairedDataset(image_dirs, 8), 1, None, prefetch=1, device="cpu"):
        break
    assert not set(threading.enumerate()) - before  # no producer thread left behind
