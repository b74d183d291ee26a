"""The port's 3x3-conv kernels' plain versions, the fused resblock and the
fused-resblock configuration of the VAE, the pipeline and the server against
the JAX package (its Pallas kernels in interpret mode on the CPU). fp32, the
same numpy inputs from a seed on both sides; on the CPU the port's wrappers
compute their plain versions and count no launch.

Tolerances: single kernels 1e-4 (the JAX conv test's own bound: nine f32
products summed in another order), their channel sums 1e-4 relative, the
folded affine 1e-6, a fused resblock 2e-3 and a fused decoder / encoder 3e-3
(the JAX tests' own bounds: E[x^2] - mean^2 statistics from streamed sums
against two-pass statistics), the pipeline 1e-3 as in
test_torch_port_pipeline.py, one served image within 1 uint8 step.

Every JAX result is computed once per module, in one interpret-mode context,
and every chain of Pallas calls under one ``jax.jit`` (``jax_once``: compiled at
optimisation level 0): run op by op, the interpreter's callbacks can deadlock
against the thread that dispatches the next call.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.inference.pipeline_s import OMGSRSPipeline as JPipeline
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu.models.configs import VAEConfig as JVAEConfig
from omgsr_tpu.ops import conv3x3 as JC
from omgsr_tpu_torch.cli import serve as serve_cli
from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline as TPipeline
from omgsr_tpu_torch.models import vae as TV
from omgsr_tpu_torch.models.configs import VAEConfig
from omgsr_tpu_torch.ops import conv3x3 as TC
from omgsr_tpu_torch.ops import fused_groupnorm as TGN
from tests.torch_port_helpers import J_TINY_UNET, T_TINY_UNET, assert_close, bridge, jax_init, jax_once, t

CONV_TOL = 1e-4
SUMS_RTOL = 1e-4
AFFINE_TOL = 1e-6
RESBLOCK_TOL = 2e-3
VAE_TOL = 3e-3
PIPE_TOL = 1e-3

K4_CASES = [(16, 128, 128, 128, "none"), (16, 128, 128, 128, "silu"),
            (32, 256, 128, 256, "none"), (8, 128, 256, 128, "silu")]
K5_CASES = [(True, True), (True, False), (False, True), (False, False)]  # (skip, emit_stats)
RESBLOCK_CASES = [(128, 128), (128, 256)]  # the second has a conv_shortcut

_FUSED_VAE = dict(block_out_channels=(128, 256), norm_num_groups=32, latent_channels=4,
                  mid_block_attention=False, layers_per_block=1, fused_resblocks=True)
J_FUSED_VAE, T_FUSED_VAE = JVAEConfig(**_FUSED_VAE), VAEConfig(**_FUSED_VAE)


def _oihw(w_hwio):
    """HWIO numpy -> the port's conv weight (OIHW, channels_last memory)."""
    return t(w_hwio).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _conv_inputs(h, w_, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((1, h, w_, cin)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _k5_inputs():
    """A prologue whose silu(shift) is far from 0 everywhere, so that a pad
    ring that was activated instead of kept at zero would show."""
    rng = np.random.default_rng(11)
    x, w, b = _conv_inputs(16, 128, 128, 128, 12)
    a = (rng.standard_normal(128) * 0.2 + 1.0).astype(np.float32)
    c = (rng.standard_normal(128) * 0.3 + 1.5).astype(np.float32)
    skip = rng.standard_normal((1, 16, 128, 128)).astype(np.float32)
    return x, w, b, a, c, skip


def _resblock_params(cin, cout, seed):
    """One VAE resnet in the JAX package's layout, values from numpy."""
    rng = np.random.default_rng(seed)

    def norm(c):
        return {"scale": (rng.standard_normal(c) * 0.2 + 1).astype(np.float32),
                "bias": (rng.standard_normal(c) * 0.1).astype(np.float32)}

    def conv(k, i, o):
        return {"kernel": (rng.standard_normal((k, k, i, o)) * 0.05).astype(np.float32),
                "bias": (rng.standard_normal(o) * 0.1).astype(np.float32)}

    p = {"norm1": norm(cin), "conv1": conv(3, cin, cout), "norm2": norm(cout), "conv2": conv(3, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = conv(1, cin, cout)
    x = (rng.standard_normal((1, 16, 128, cin)) * 0.5).astype(np.float32)
    return p, x


def _vae_inputs():
    p = jax_init(JV.init_vae, 21, J_FUSED_VAE)
    rng = np.random.default_rng(22)
    z = (rng.standard_normal((1, 8, 16, 4)) * 0.3).astype(np.float32)
    u8 = rng.integers(0, 256, (16, 32, 3), dtype=np.uint8)
    img = ((u8.astype(np.float32) / 255.0)[None] * 2.0 - 1.0).astype(np.float32)  # as the server makes it
    prompt = rng.standard_normal((1, 7, 16)).astype(np.float32)
    return p, z, img, prompt, u8


@pytest.fixture(scope="module")
def jax_side():
    """Everything the JAX package computes for this file, once."""
    from jax.experimental.pallas import tpu as pltpu

    out = {}
    with pltpu.force_tpu_interpret_mode():
        for case in K4_CASES:
            h, w_, cin, cout, act = case
            x, w, b = (jnp.asarray(a) for a in _conv_inputs(h, w_, cin, cout, 1))
            out["k4", case] = tuple(np.asarray(v) for v in jax_once(
                lambda x, w, b: (JC.conv3x3_pallas(x, w, b, act=act, bh=8),
                                 JC.conv3x3_reference(x, w, b, act=act)), x, w, b))
        x, w, b, a, c, skip = (jnp.asarray(v) for v in _k5_inputs())
        for use_skip, emit in K5_CASES:
            y, ssum, ssq = jax_once(
                lambda x, w, b, a, c, skip: JC.conv3x3_gn_fused(
                    x, w, b, a, c, skip=skip if use_skip else None, bh=8, emit_stats=emit),
                x, w, b, a, c, skip)
            out["k5", use_skip, emit] = tuple(np.asarray(v) for v in (y, ssum, ssq))
        for cin, cout in RESBLOCK_CASES:
            p, xr = _resblock_params(cin, cout, 30 + cout)
            out["resblock", cin, cout] = np.asarray(
                jax_once(lambda p, x: JC.fused_resblock(p, x, 32), jax.tree.map(jnp.asarray, p), jnp.asarray(xr)))
        vp, z, img, prompt, _ = _vae_inputs()
        out["decode"] = np.asarray(jax_once(lambda p, z: JV.vae_decode(p, J_FUSED_VAE, z), vp, jnp.asarray(z)))
        out["encode"] = np.asarray(
            jax_once(lambda p, x: JV.vae_encode_features(p, J_FUSED_VAE, x), vp, jnp.asarray(img)))
        up = jax_init(JU.init_unet, 1, J_TINY_UNET)
        jpipe = JPipeline(vp, up, J_FUSED_VAE, J_TINY_UNET)
        out["pipeline"] = np.asarray(jpipe(jnp.asarray(img), jnp.asarray(prompt), 16, 8, sample_latent=False))
        out["unet_params"] = up
    return out


@pytest.fixture(autouse=True)
def _no_launch_on_the_cpu():
    counters = (TC.conv3x3_launches, TC.gn_fused_launches, TC.fold_launches, TGN.stats_launches,
                TGN.apply_launches)
    before = [c.count for c in counters]
    yield
    assert [c.count for c in counters] == before


@pytest.mark.parametrize("case", K4_CASES, ids=lambda c: "-".join(map(str, c)))
def test_conv3x3_plain_matches_pallas_and_xla(jax_side, case):
    h, w_, cin, cout, act = case
    x, w, b = _conv_inputs(h, w_, cin, cout, 1)
    pallas, reference = jax_side["k4", case]
    plain = TC.conv3x3_plain(t(x), _oihw(w), t(b), act)
    assert_close(plain, pallas, CONV_TOL, "plain vs pallas interpret")
    assert_close(plain, reference, CONV_TOL, "plain vs conv3x3_reference")
    assert_close(TC.conv3x3(t(x), _oihw(w), t(b), act), pallas, CONV_TOL, "wrapper on the CPU")


@pytest.mark.parametrize("pos,taps", [((4, 64), 9), ((0, 0), 4), ((0, 64), 6), ((4, 127), 6)])
def test_conv3x3_border_values_exact(pos, taps):
    """SAME zero padding at the interior, a corner and two edges."""
    x, w, b = torch.ones(1, 8, 128, 128), torch.ones(128, 128, 3, 3), torch.zeros(128)
    out = TC.conv3x3(x, w, b)
    assert out[0, pos[0], pos[1]].eq(taps * 128).all()
    a, c = torch.ones(128), torch.full((128,), 2.0)  # silu(3) at every valid pixel, 0 on the ring
    fused, _, _ = TC.conv3x3_gn_fused(x, w, b, a, c, emit_stats=False)
    silu3 = 3.0 / (1.0 + np.exp(-3.0))
    np.testing.assert_allclose(fused[0, pos[0], pos[1]].numpy(), taps * 128 * silu3, rtol=1e-4)  # f32 sum of 1152 terms


@pytest.mark.parametrize("use_skip,emit", K5_CASES)
def test_conv3x3_gn_fused_plain_matches_pallas(jax_side, use_skip, emit):
    x, w, b, a, c, skip = _k5_inputs()
    jy, jsum, jsq = jax_side["k5", use_skip, emit]
    sk = t(skip) if use_skip else None
    for fn in (TC.conv3x3_gn_fused_plain, TC.conv3x3_gn_fused):
        y, ssum, ssq = fn(t(x), _oihw(w), t(b), t(a), t(c), skip=sk, emit_stats=emit)
        assert_close(y, jy, CONV_TOL, fn.__name__)
        if not emit:
            assert ssum is None and ssq is None
            continue
        assert ssum.shape[1:] == (128,) and ssum.dtype == torch.float32
        np.testing.assert_allclose(ssum.sum(0).numpy(), jsum.sum(0), rtol=SUMS_RTOL, atol=SUMS_RTOL)
        np.testing.assert_allclose(ssq.sum(0).numpy(), jsq.sum(0), rtol=SUMS_RTOL)
        # the sums are those of the f32 output
        np.testing.assert_allclose(ssum.sum(0).numpy(), y.double().sum((0, 1, 2)).numpy(), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(ssq.sum(0).numpy(), (y.double() ** 2).sum((0, 1, 2)).numpy(), rtol=1e-4)


def test_conv3x3_gn_fused_pad_ring_is_zero_after_the_activation():
    """With weights of one tap only, a border pixel reads the ring: it must
    see 0 there and not silu(shift)."""
    x = torch.zeros(1, 4, 4, 128)
    w = torch.zeros(128, 128, 3, 3)
    w[:, :, 0, 0] = torch.eye(128)  # y[i, j] = act[i - 1, j - 1]
    a, c = torch.ones(128), torch.full((128,), 1.5)
    y, _, _ = TC.conv3x3_gn_fused(x, w, torch.zeros(128), a, c, emit_stats=False)
    silu = 1.5 / (1.0 + np.exp(-1.5))
    assert y[0, 0].eq(0).all() and y[0, :, 0].eq(0).all()
    np.testing.assert_allclose(y[0, 1:, 1:].numpy(), silu, rtol=1e-6)


@pytest.mark.parametrize("n,c,groups", [(1, 128, 32), (4, 128, 4), (2, 256, 32)])
def test_gn_affine_from_channel_sums_matches_jax(n, c, groups):
    rng = np.random.default_rng(5)
    hw = 640
    y = rng.standard_normal((n, hw // n, c)).astype(np.float32) * 2 + 0.5
    ssum, ssq = y.sum(1), (y * y).sum(1)
    gamma = (rng.standard_normal(c) * 0.2 + 1).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ref = JC.gn_affine_from_channel_sums(jnp.asarray(ssum), jnp.asarray(ssq), hw, groups,
                                         jnp.asarray(gamma), jnp.asarray(beta), 1e-6)
    out = TC.gn_affine_from_channel_sums(t(ssum), t(ssq), hw, groups, t(gamma), t(beta), 1e-6)
    assert_close(out[0], ref[0], AFFINE_TOL, "scale")
    assert_close(out[1], ref[1], AFFINE_TOL, "shift")


@pytest.mark.parametrize("n,c,groups", [(1, 128, 32), (3, 256, 32), (5, 512, 32)])
def test_fold_gn_sums_matches_jax(n, c, groups):
    """The fold kernel's wrapper on the CPU (its plain version) takes the sums
    as the fused conv streams them, (2, n_partials, C), and gives the JAX
    package's affine; it counts no launch."""
    rng = np.random.default_rng(6)
    hw = 960
    y = rng.standard_normal((n, hw // n, c)).astype(np.float32) * 2 + 0.5
    ssum, ssq = y.sum(1), (y * y).sum(1)
    gamma = (rng.standard_normal(c) * 0.2 + 1).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    ref = JC.gn_affine_from_channel_sums(jnp.asarray(ssum), jnp.asarray(ssq), hw, groups,
                                         jnp.asarray(gamma), jnp.asarray(beta), 1e-6)
    before = TC.fold_launches.count
    out = TC.fold_gn_sums(torch.stack([t(ssum), t(ssq)]), hw, groups, t(gamma), t(beta), 1e-6)
    assert TC.fold_launches.count == before
    assert_close(out[0], ref[0], AFFINE_TOL, "scale")
    assert_close(out[1], ref[1], AFFINE_TOL, "shift")


H100_SMS = 132  # the SMs of an H100 SXM, which gn_fused_tile_rows' cost was fitted on


@pytest.mark.parametrize("h,w,cout,rows", [
    # the fused serving path's shapes: 4-row tiles where they fill the card, 2-row ones at the
    # 64 x 64 mid blocks (16 tiles by 4 channel tiles unsplit) and at small ragged images
    (512, 512, 128, 4), (512, 512, 256, 4), (256, 256, 256, 4), (128, 128, 512, 4),
    (64, 64, 512, 2), (1024, 1024, 128, 4), (61, 45, 128, 2), (16, 16, 128, 2),
])
def test_gn_fused_tile_rows(h, w, cout, rows):
    """The bf16 resblock kernel's tile height on an H100, and the blocks it
    gives: no more waves than the other height would, weighted as the choice
    weighs them."""
    got = TC.gn_fused_tile_rows(h, w, cout, H100_SMS)
    assert got == rows
    other = 6 - got
    blocks = lambda r: -(-h // r) * -(-w // TC.GN_TILE_COLS) * cout // 128  # noqa: E731
    waves = lambda r: -(-blocks(r) // H100_SMS)  # noqa: E731
    assert waves(got) * got * (1.0 if got == 4 else TC._TWO_ROW_COST) <= \
        waves(other) * other * (1.0 if other == 4 else TC._TWO_ROW_COST)


def test_gn_tile_width_matches_the_kernel_source():
    """gn_fused_tile_rows counts pixel tiles with the kernel's own tile width
    (GW in the CUDA source)."""
    import re
    from pathlib import Path

    src = (Path(TC.__file__).parent.parent / "csrc" / "conv3x3.cu").read_text()
    assert int(re.search(r"constexpr int GW = (\d+);", src).group(1)) == TC.GN_TILE_COLS


def test_conv_tile_matches_the_kernel_source():
    """The bf16 plain conv (K4) runs the resblock half's wgmma kernel without the
    prologue: its tile is GW = 64 columns by GBN = 128 output channels (the
    wrappers' channel multiple) over chunks of GKC = 64 input channels, and
    the tile heights the wrappers pick (K4's CONV_TILE_ROWS; 4 or 2 from
    gn_fused_tile_rows) are the two the C entries launch (MT = 2, 1 rows a
    consumer warpgroup)."""
    import re
    from pathlib import Path

    src = (Path(TC.__file__).parent.parent / "csrc" / "conv3x3.cu").read_text()
    const = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in ("GW", "GBN", "GKC")}
    assert const["GW"] == TC.GN_TILE_COLS and const["GBN"] == TC.CHANNEL_MULTIPLE
    assert TC.CHANNEL_MULTIPLE % const["GKC"] == 0
    rows = src[src.index("int launch_wgmma_rows("):src.index("// The FMA kernels (f32)")]
    assert "tile_rows == 4)\n    return launch_wgmma<2, FUSED>" in rows
    assert "tile_rows == 2)\n    return launch_wgmma<1, FUSED>" in rows
    conv = src[src.index('extern "C" int conv3x3('):src.index('extern "C" int conv3x3_gn_fused(')]
    assert "launch_wgmma_rows<false>(tile_rows," in conv
    assert {TC.gn_fused_tile_rows(h, w, 128, 132) for h, w in ((64, 64), (512, 512), (7, 9))} == {2, 4}
    assert TC.CONV_TILE_ROWS in (2, 4)


@pytest.mark.parametrize("cin,cout", RESBLOCK_CASES)
def test_fused_resblock_matches_jax_and_the_unfused_resnet(jax_side, cin, cout):
    p, x = _resblock_params(cin, cout, 30 + cout)
    tp = bridge(p)
    assert TC.fused_resblock_eligible(tp, t(x), 32)
    out = TC.fused_resblock(tp, t(x), 32)
    assert_close(out, jax_side["resblock", cin, cout], RESBLOCK_TOL, "vs the JAX fused resblock")
    assert_close(out, TV._resnet(tp, t(x), 32).numpy(), RESBLOCK_TOL, "vs the port's unfused resnet")


@pytest.mark.parametrize(
    "shape,cout,groups,jax_takes,port_takes",
    [
        ((1, 16, 128, 128), 128, 32, True, True),
        ((1, 512, 512, 128), 128, 32, True, True),  # the decoder's last stage at 512 px
        # the JAX rule also asks for a row stripe of >= 4 rows inside the TPU's VMEM budget
        ((1, 1024, 1024, 128), 128, 32, False, True),
        ((1, 256, 256, 512), 256, 32, False, True),
        ((1, 7, 128, 128), 128, 32, False, True),  # no stripe height divides 7 rows
        ((1, 16, 128, 64), 128, 32, False, False),
        ((1, 16, 128, 128), 192, 32, False, False),
        ((2, 16, 128, 128), 128, 32, False, False),
        ((1, 16, 128, 128), 128, 48, False, False),  # channels not divisible by the groups
    ],
)
def test_fused_resblock_eligible(shape, cout, groups, jax_takes, port_takes):
    cin = shape[-1]
    jp = {"conv1": {"kernel": jax.ShapeDtypeStruct((3, 3, cin, cout), jnp.float32)}}
    assert JC.fused_resblock_eligible(jp, jax.ShapeDtypeStruct(shape, jnp.float32), groups) == jax_takes
    tp = {"conv1": {"weight": torch.empty(cout, cin, 3, 3, device="meta")},
          "conv2": {"weight": torch.empty(cout, cout, 3, 3, device="meta")}}
    x = torch.empty(shape, device="meta")
    assert TC.fused_resblock_eligible(tp, x, groups) == port_takes
    if port_takes:  # an input that wants a gradient, or a LoRA branch on either conv, stays unfused
        assert not TC.fused_resblock_eligible(tp, x.clone().requires_grad_(), groups)
        with torch.no_grad():
            assert TC.fused_resblock_eligible(tp, x.clone().requires_grad_(), groups)
        tp["conv2"]["lora_A"] = torch.empty(4, cout, 3, 3, device="meta")
        assert not TC.fused_resblock_eligible(tp, x, groups)


def test_kernel_weight_is_made_once():
    w = torch.randn(128, 128, 3, 3)
    ready = w.contiguous(memory_format=torch.channels_last)
    assert TC.kernel_weight(ready, torch.float32) is ready  # the parameter trees' layout: as it is
    first = TC.kernel_weight(w, torch.float32)
    assert first is TC.kernel_weight(w, torch.float32) and first is not w
    assert first.is_contiguous(memory_format=torch.channels_last) and torch.equal(first, w)
    half = TC.kernel_weight(ready, torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half is TC.kernel_weight(ready, torch.bfloat16)
    w.mul_(2.0)  # a changed weight is converted again
    assert torch.equal(TC.kernel_weight(w, torch.float32), w)


def test_wrappers_refuse_what_does_not_fit():
    x, w, b = torch.zeros(1, 4, 4, 128), torch.zeros(128, 128, 3, 3), torch.zeros(128)
    with pytest.raises(ValueError):
        TC.conv3x3(x, w[:, :64], b)
    with pytest.raises(ValueError):
        TC.conv3x3(x, w, b, act="gelu")
    with pytest.raises(ValueError):
        TC.conv3x3_gn_fused(x, w, b, torch.ones(64), torch.zeros(128))
    with pytest.raises(ValueError):
        TC.conv3x3_gn_fused(x, w, b, torch.ones(128), torch.zeros(128), skip=torch.zeros(1, 4, 4, 64))


@pytest.mark.parametrize("stage", ["decode", "encode"])
def test_fused_vae_matches_jax_fused_and_port_unfused(jax_side, stage):
    vp, z, img, _, _ = _vae_inputs()
    tp = bridge(vp)
    plain_cfg = replace(T_FUSED_VAE, fused_resblocks=False)
    if stage == "decode":
        out = TV.vae_decode(tp, T_FUSED_VAE, t(z))
        unfused = TV.vae_decode(tp, plain_cfg, t(z))
    else:
        out = TV.vae_encode_features(tp, T_FUSED_VAE, t(img))
        unfused = TV.vae_encode_features(tp, plain_cfg, t(img))
    assert_close(out, jax_side[stage], VAE_TOL, "port fused vs JAX fused")
    assert_close(out, unfused.numpy(), VAE_TOL, "port fused vs port unfused")
    assert not torch.equal(out, unfused)  # the flag did change the route


def test_fused_vae_routes_every_eligible_resnet(monkeypatch):
    """With the flag on the tiny VAE sends all its resnets (channels 128 and
    256) through fused_resblock, without it none."""
    vp, z, img, _, _ = _vae_inputs()
    tp = bridge(vp)
    seen = []
    real = TC.fused_resblock

    def counting(p, x, groups, eps):
        seen.append(tuple(x.shape))
        return real(p, x, groups, eps)

    monkeypatch.setattr(TV, "fused_resblock", counting)
    TV.vae_decode(tp, T_FUSED_VAE, t(z))
    assert len(seen) == 2 + 2 * 2  # mid block + (layers_per_block + 1) per up block
    TV.vae_encode_features(tp, T_FUSED_VAE, t(img))
    assert len(seen) == 6 + 2 * 1 + 2
    TV.vae_decode(tp, replace(T_FUSED_VAE, fused_resblocks=False), t(z))
    assert len(seen) == 10


def test_fused_pipeline_and_server_match_jax(jax_side):
    vp, _, img, prompt, u8 = _vae_inputs()
    params = (bridge(vp), bridge(jax_side["unet_params"]))
    tpipe = TPipeline(*params, T_FUSED_VAE, T_TINY_UNET, device="cpu")
    assert tpipe.vae_cfg.fused_resblocks
    assert_close(tpipe(img, prompt, 16, 8, sample_latent=False), jax_side["pipeline"], PIPE_TOL)

    # the same image as one request through cli.serve.build_server ->
    # SRServer.process_array; process_size 128 gives the tile 16 and overlap 8 used above
    args = serve_cli.parse_args(["--device", "cpu", "--weight_dtype", "fp32", "--process_size", "128",
                                 "--latent", "mean", "--size_bucket", "16"])
    server = serve_cli.build_server(args, params=params, configs=(T_FUSED_VAE, T_TINY_UNET),
                                    prompt_embeds=prompt)
    try:
        served = server.process_array(u8, "nofix")
    finally:
        server.shutdown()
    want = np.round(np.clip(jax_side["pipeline"][0] * 0.5 + 0.5, 0.0, 1.0) * 255.0).astype(int)
    assert served.shape == (16, 32, 3) and served.dtype == np.uint8
    assert np.abs(served.astype(int) - want).max() <= 1
