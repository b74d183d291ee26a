"""The port's tiled VAE (streaming fast-stats and exact modes), its
routing, the pipeline's tiled routes and one served request, against the JAX
package. fp32 on the CPU, the tiny VAE of tests/test_tiled_vae.py (blocks
(8, 16), 4 groups), weights from numpy through the bridge, inputs from numpy
seeds, posterior mean (the frameworks draw different noise).

Tolerances: one VAE pass 1e-4 (test_torch_port_models' bound: a few dozen f32
layers summed in another order); the pipeline 1e-3 (test_torch_port_pipeline's
bound)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.inference import tiled_vae as JT
from omgsr_tpu.inference import vae_routing as JR
from omgsr_tpu.inference.pipeline_s import OMGSRSPipeline as JPipeline
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu_torch.inference import tiled_vae as TT
from omgsr_tpu_torch.inference import vae_routing as TR
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline as TPipeline
from omgsr_tpu_torch.models import vae as TV
from tests.torch_port_helpers import (
    FAST_COMPILE,
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

TOL = 1e-4
PIPE_TOL = 1e-3


@pytest.fixture(scope="module")
def vae_pair():
    jp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    return jp, bridge(jp)


@pytest.fixture(scope="module")
def unet_pair():
    jp = jax_init(JU.init_unet, 1, J_TINY_UNET)
    return jp, bridge(jp)


def _pixels(shape, seed):
    return np.tanh(np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _latent(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("what", ["encode", "decode"])
def test_streaming_fast_matches_jax(vae_pair, what):
    """Several windows along both axes, the last one snapped to the edge (the
    sizes are no multiple of the tile), statistics from a downsampled,
    renormalised copy, and the mid block's attention per window."""
    jp, tp = vae_pair
    if what == "encode":
        x = _pixels((1, 40, 88, 3), 0)  # tile 16: 3 x 6 windows of 32 x 32
        ref = jax_once(lambda p, x: JT.streaming_vae_encode(p, J_TINY_VAE, x, tile=16, pad=8, est_size=24),
                       jp, jnp.asarray(x))
        out = TT.streaming_vae_encode(tp, T_TINY_VAE, t(x), tile=16, pad=8, est_size=24)
    else:
        z = _latent((1, 21, 37, 4), 1)  # odd sizes: 3 x 5 windows of 8 + 2 * 4
        ref = jax_once(lambda p, z: JT.streaming_vae_decode(p, J_TINY_VAE, z, tile=8, pad=4, est_size=16),
                       jp, jnp.asarray(z))
        out = TT.streaming_vae_decode(tp, T_TINY_VAE, t(z), tile=8, pad=4, est_size=16)
    assert_close(out, ref, TOL, what)


@pytest.mark.parametrize("what", ["encode", "decode"])
def test_exact_matches_jax_and_the_full_image_vae(vae_pair, what):
    """The JAX package's op plan, with row chunks that do not divide the
    buffers (stat_rows 5 / 7), against the port's exact mode, which is its
    full-image VAE."""
    jp, tp = vae_pair
    if what == "encode":
        x = _pixels((1, 48, 40, 3), 2)
        ref = jax_once(lambda p, x: JT.exact_vae_encode(p, J_TINY_VAE, x, stat_rows=7), jp, jnp.asarray(x))
        out = TT.exact_vae_encode(tp, T_TINY_VAE, t(x))
        full = TV.vae_encode(tp, T_TINY_VAE, t(x))
    else:
        z = _latent((1, 24, 20, 4), 3)
        ref = jax_once(lambda p, z: JT.exact_vae_decode(p, J_TINY_VAE, z, stat_rows=5), jp, jnp.asarray(z))
        out = TT.exact_vae_decode(tp, T_TINY_VAE, t(z))
        full = TV.vae_decode(tp, T_TINY_VAE, t(z))
    assert_close(out, ref, TOL, what)
    assert_close(out, full.numpy(), TOL, f"{what} vs the port's full-image VAE")


@pytest.mark.parametrize("ratio", ["within", "beyond"])
@pytest.mark.parametrize("what", ["encode", "decode"])
def test_streaming_auto_matches_jax(vae_pair, what, ratio):
    """stats="auto": the fast mode while max(H, W) / est_size stays within
    AUTO_EXACT_RATIO, the exact mode beyond it, on both sides alike."""
    jp, tp = vae_pair
    if what == "encode":
        x = _pixels((1, 40, 88, 3), 0)
        est = 24 if ratio == "within" else 16  # 88 / 24 = 3.7, 88 / 16 = 5.5
        ref = jax_once(lambda p, x: JT.streaming_vae_encode(p, J_TINY_VAE, x, tile=16, pad=8, est_size=est,
                                                             stats="auto"), jp, jnp.asarray(x))
        out = TT.streaming_vae_encode(tp, T_TINY_VAE, t(x), tile=16, pad=8, est_size=est, stats="auto")
        full = TV.vae_encode(tp, T_TINY_VAE, t(x))
    else:
        z = _latent((1, 21, 37, 4), 1)
        est = 16 if ratio == "within" else 8  # 37 / 16 = 2.3, 37 / 8 = 4.6
        ref = jax_once(lambda p, z: JT.streaming_vae_decode(p, J_TINY_VAE, z, tile=8, pad=4, est_size=est,
                                                             stats="auto"), jp, jnp.asarray(z))
        out = TT.streaming_vae_decode(tp, T_TINY_VAE, t(z), tile=8, pad=4, est_size=est, stats="auto")
        full = TV.vae_decode(tp, T_TINY_VAE, t(z))
    assert_close(out, ref, TOL, what)
    # the exact mode is the full-image VAE; the fast mode estimates its statistics
    assert torch.equal(out, full) == (ratio == "beyond")


def test_routed_batch_of_two_matches_jax(vae_pair):
    """Two images through the streaming routes one by one (mean), and a
    small batch that stays on the full-image route."""
    jp, tp = vae_pair
    x = _pixels((2, 32, 56, 3), 5)
    ref = jax_once(lambda p, x: JR.routed_vae_encode(p, J_TINY_VAE, x, 16, jax.random.key(0), sample=False),
                   jp, jnp.asarray(x))
    z = TR.routed_vae_encode(tp, T_TINY_VAE, t(x), 16, sample=False)
    assert_close(z, ref, TOL, "encode")
    ref = jax_once(lambda p, z: JR.routed_vae_decode(p, J_TINY_VAE, z, 16), jp, jnp.asarray(z.numpy()))
    assert_close(TR.routed_vae_decode(tp, T_TINY_VAE, z, 16), ref, TOL, "decode")
    small = _pixels((2, 16, 16, 3), 6)
    assert_close(TR.routed_vae_encode(tp, T_TINY_VAE, t(small), 16, sample=False),
                 jax_once(lambda p, x: JV.vae_encode(p, J_TINY_VAE, x, rng=None), jp, jnp.asarray(small)),
                 TOL, "untiled")


def test_sampled_tiles_and_images_draw_their_own_noise(vae_pair):
    """A constant image: no two tiles and no two images of a batch share a
    noise draw, and the same generator seed draws the same numbers again."""
    _, tp = vae_pair
    x = torch.ones(2, 32, 96, 3)

    def encode():
        return TR.routed_vae_encode(tp, T_TINY_VAE, x, 16, sample=True,
                                    generator=torch.Generator().manual_seed(3))

    z = encode()
    lt = 16 // T_TINY_VAE.downscale
    patches = [z[0, :, i * lt : (i + 1) * lt] for i in range(z.shape[2] // lt)]
    assert min((a - b).abs().max().item() for a, b in zip(patches, patches[1:])) > 0.0
    assert (z[0] - z[1]).abs().max().item() > 0.0
    assert torch.equal(z, encode())
    with pytest.raises(ValueError, match="generator"):
        TR.routed_vae_encode(tp, T_TINY_VAE, x, 16, sample=True, noise=torch.zeros(2, 16, 48, 4))


@pytest.mark.parametrize(
    "tile,stats",
    [(None, "fast"), (64, "fast"), (64, "exact"), (64, "auto"), (8, "fast"), (2, "fast"),
     (0, "fast"), (-2, "fast"), (12, "fast"), (3, "exact"), (64, "bogus")],
)
def test_validate_vae_opts_agrees_with_jax(tile, stats):
    def outcome(fn):
        try:
            fn(tile, stats, J_TINY_VAE.downscale)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(TR.validate_vae_opts) == outcome(JR.validate_vae_opts)


@pytest.mark.parametrize("stats", ["fast", "exact", "auto"])
@pytest.mark.parametrize("tile", [None, 64, 128, 256])
@pytest.mark.parametrize("hw", [(128, 128), (64, 256), (640, 640), (256, 2048)])
def test_wants_exact_path_agrees_with_jax(stats, tile, hw):
    img = np.zeros((1, *hw, 3), np.float32)
    assert TR.wants_exact_path(stats, tile, t(img)) == JR.wants_exact_path(stats, tile, img)


def test_gn_hook_runs_every_resnet_plain(vae_pair, monkeypatch):
    """With fused_resblocks on, a hooked pass never reaches the fused kernel:
    the fused kernels take no statistics from outside."""
    import dataclasses

    _, tp = vae_pair

    def refuse(*a, **k):
        raise AssertionError("fused resnet under a GroupNorm hook")

    monkeypatch.setattr(TV, "fused_resblock", refuse)
    monkeypatch.setattr(TV, "fused_resblock_eligible", lambda *a: True)
    cfg = dataclasses.replace(T_TINY_VAE, fused_resblocks=True)
    hook = TT._CollectHook()
    z = t(_latent((1, 8, 8, 4), 7))
    out = TV.vae_decode(tp, cfg, z, gn_hook=hook)
    # the hook saw every GroupNorm of the decoder, and its statistics are the
    # full-image ones, so the output is the plain decode's
    norms = [k for k in _keys(tp["decoder"]) if k in ("norm1", "norm2", "group_norm", "conv_norm_out")]
    assert len(hook.stats) == len(norms) > 10
    assert_close(out, TV.vae_decode(tp, T_TINY_VAE, z).numpy(), 1e-5)


def _keys(tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield k
            yield from _keys(v)


@pytest.fixture(scope="module")
def pipelines(vae_pair, unet_pair):
    """Weights, prompt, the inputs and the JAX pipelines, built once. The fast
    route runs a 64 x 80 input, the exact route a 128 x 160 one: the size at
    which the served 16 x 20 PNG below reaches the pipeline (process_size 128),
    so the served request reuses what the exact route compiled. Both inputs
    are larger than the 48-px VAE tile along both axes. Each JAX pipeline runs
    as one jit compiled at optimisation level 0, once per route and shape."""
    (jv, tv), (ju, tu) = vae_pair, unet_pair
    prompt = np.random.default_rng(8).standard_normal((1, 7, 16)).astype(np.float32)
    lq = {"fast": _pixels((1, 64, 80, 3), 9), "exact": _pixels((1, 128, 160, 3), 9)}
    jpipes = {s: JPipeline(jv, ju, J_TINY_VAE, J_TINY_UNET, vae_tile=48, vae_stats=s) for s in ("fast", "exact")}
    compiled = {}

    def jax_pipeline(stats, x):
        x, pr = jnp.asarray(x, jnp.float32), jnp.asarray(prompt)
        if (stats, x.shape) not in compiled:
            compiled[stats, x.shape] = jax.jit(
                lambda img, p: jpipes[stats](img, p, 16, 8, sample_latent=False)
            ).lower(x, pr).compile(compiler_options=FAST_COMPILE)
        return compiled[stats, x.shape](x, pr)

    return jax_pipeline, tv, tu, prompt, lq


@pytest.mark.parametrize("stats", ["fast", "exact"])
def test_pipeline_tiled_matches_jax(pipelines, stats):
    jax_pipeline, tv, tu, prompt, lq = pipelines
    tpipe = TPipeline(tv, tu, T_TINY_VAE, T_TINY_UNET, vae_tile=48, vae_stats=stats, device="cpu")
    ref = jax_pipeline(stats, lq[stats])
    out = tpipe(lq[stats], prompt, 16, 8, sample_latent=False)
    assert out.shape == lq[stats].shape
    assert_close(out, ref, PIPE_TOL, stats)


def test_pipeline_exact_route_matches_its_full_image_route(pipelines):
    _, tv, tu, prompt, lq = pipelines
    exact = TPipeline(tv, tu, T_TINY_VAE, T_TINY_UNET, vae_tile=48, vae_stats="exact", device="cpu")
    full = TPipeline(tv, tu, T_TINY_VAE, T_TINY_UNET, device="cpu")
    x = lq["fast"]
    assert_close(exact(x, prompt, 16, 8), full(x, prompt, 16, 8).numpy(), TOL)


def test_served_request_exact_route_matches_jax(pipelines, tmp_path):
    """One PNG (16 x 20, run at 128 x 160, returned at 64 x 80) through build_server(--vae_tile 48
    --vae_stats exact) on the CPU, against the JAX pipeline's exact route
    behind the JAX server (no fused colour fix under --vae_tile on either
    side): within one uint8 step."""
    from PIL import Image

    from omgsr_tpu.serving.server import ServeOptions as JServeOptions
    from omgsr_tpu.serving.server import SRServer as JSRServer
    from omgsr_tpu_torch.cli import serve as serve_cli

    jax_pipeline, tv, tu, prompt, _ = pipelines
    np.savez(tmp_path / "prompt.npz", prompt_embeds=prompt)
    args = serve_cli.parse_args([
        "--prompt_npz", str(tmp_path / "prompt.npz"), "--process_size", "128", "--upscale", "4",
        "--size_bucket", "16", "--weight_dtype", "fp32", "--device", "cpu", "--latent", "mean",
        "--vae_tile", "48", "--vae_stats", "exact",
    ])
    server = serve_cli.build_server(args, params=(tv, tu), configs=(T_TINY_VAE, T_TINY_UNET))
    jsrv = JSRServer(
        lambda lq, i: jax_pipeline("exact", lq),
        JServeOptions(process_size=128, upscale=4, size_bucket=16), np_dtype=np.float32,
    )
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(11).integers(0, 255, (16, 20, 3), dtype=np.uint8)).save(buf, "PNG")
    try:
        assert server.fused_infer_fn is None
        a = np.asarray(Image.open(io.BytesIO(server.process_image(buf.getvalue(), align="adain"))))
        b = np.asarray(Image.open(io.BytesIO(jsrv.process_image(buf.getvalue(), align="adain"))))
    finally:
        server.shutdown()
        jsrv.shutdown()
    assert a.shape == b.shape == (64, 80, 3)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
