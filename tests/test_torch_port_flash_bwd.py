"""The backward of the port's two kernel wrappers on the CPU: the plain
flash-attention backward against the JAX package's Pallas backward kernels
(interpret mode), against jax.vjp of jax.nn.dot_product_attention and against
torch autograd through the plain forward; the GroupNorm+SiLU autograd
function against autograd through its plain version. fp32 (f64 for
gradcheck), inputs made with numpy from a seed; each JAX reference runs as one
jit compiled at optimisation level 0 (``jax_once``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.ops import flash_attention as JFA
from omgsr_tpu_torch.ops import flash_attention as TFA
from omgsr_tpu_torch.ops import fused_groupnorm as TGN
from tests.torch_port_helpers import assert_close, jax_once, t


@pytest.fixture(autouse=True)
def _interpret_on_cpu():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _operands(shape, skv, seed):
    rng = np.random.default_rng(seed)
    b, _, h, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, g


# 2e-3 is the JAX flash test's own bound for the forward (the Pallas kernels
# and the plain versions sum in different block orders); the gradients are
# held to the same bound, relative to 1 or to the value, whichever is larger.
FLASH_TOL = 2e-3

SHAPES = [
    pytest.param((1, 256, 2, 64), 256, None, id="self"),
    pytest.param((1, 256, 2, 64), 77, None, id="cross77"),
    pytest.param((2, 300, 3, 64), 300, None, id="ragged"),
    pytest.param((1, 128, 1, 128), 128, 0.5, id="d128-scale"),
]


def _plain_grads(q, k, v, g, scale):
    out, lse = TFA.flash_attention_plain(t(q), t(k), t(v), scale, return_lse=True)
    return TFA.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(g), scale)


@functools.lru_cache(maxsize=None)
def _pallas_grads(shape, skv, scale, seed):
    """(dq, dk, dv) of the JAX package's Pallas backward kernels (interpret
    mode) at _operands(shape, skv, seed), computed once per module run."""
    q, k, v, g = _operands(shape, skv, seed)
    ref = jax_once(lambda a, b, c, gg: jax.vjp(lambda a, b, c: JFA.flash_attention_bshd(a, b, c, scale),
                                               a, b, c)[1](gg),
                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g))
    return tuple(np.asarray(r) for r in ref)


@pytest.mark.parametrize("shape,skv,scale", SHAPES)
def test_flash_bwd_plain_matches_pallas_interpret(shape, skv, scale):
    q, k, v, g = _operands(shape, skv, 0)
    ref = _pallas_grads(shape, skv, scale, 0)
    for name, got, want in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, g, scale), ref):
        assert_close(got, want, FLASH_TOL, name)


H100_SMS = 132  # the SMs of an H100 SXM, which dkv_splits' cost was fitted on


def _q_chunks(sq, splits):
    """The [start, stop) q rows of each chunk of the dK/dV kernel's split q
    loop, cut as the kernel cuts them: chunk z takes q tiles z*n // splits ..
    (z+1)*n // splits - 1 of the n = ceil(Sq / 64)."""
    n = -(-sq // TFA.Q_TILE_ROWS)
    return [(z * n // splits * TFA.Q_TILE_ROWS, min(sq, (z + 1) * n // splits * TFA.Q_TILE_ROWS))
            for z in range(splits)]


def _dkv_chunked_plain(q, k, v, out, lse, dout, scale, splits):
    """(dk, dv) summed as the split dK/dV kernel sums them, in tensor code:
    per q chunk the f32 partials dS^T q and P^T dout over the chunk's rows,
    added in chunk order, dk scaled after the sum."""
    p, ds, qh, _, gh = TFA._bwd_plain_scores(q, k, v, out, lse, dout, scale)
    dk = dv = 0.0
    for lo, hi in _q_chunks(q.shape[1], splits):
        dk = dk + torch.matmul(ds[:, :, lo:hi].transpose(-1, -2), qh[:, :, lo:hi])
        dv = dv + torch.matmul(p[:, :, lo:hi].transpose(-1, -2), gh[:, :, lo:hi])
    return (dk * scale).permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def test_split_tile_sizes_match_the_kernel_source():
    """dkv_splits counts blocks and q tiles with the dK/dV kernel's own tile
    sizes: HO of its launcher and the streamed tile HS in the CUDA source; and
    wide_bwd_ctas counts the D = 512 kernels' CTAs with theirs: WROWS rows a
    tile, a cluster of two CTAs along grid x, and WCOLS = WD / 2 columns a
    dK/dV CTA holds (the split _wide_pair_plain sums)."""
    import re
    from pathlib import Path

    src = (Path(TFA.__file__).parent.parent / "csrc" / "flash_attention_bwd.cu").read_text()
    assert int(re.search(r"constexpr int HS = (\d+);", src).group(1)) == TFA.Q_TILE_ROWS
    launcher = src[src.index("int launch_dkv_wgmma("):]
    assert int(re.search(r"constexpr int HO = (\d+);", launcher).group(1)) == TFA.DKV_BLOCK_ROWS
    wd = int(re.search(r"constexpr int WD = (\d+);", src).group(1))
    assert int(re.search(r"constexpr int WROWS = (\d+);", src).group(1)) == TFA.WIDE_BWD_ROWS
    assert "constexpr int WCOLS = WD / 2;" in src and wd // 2 == TFA.WIDE_BWD_COLS
    assert src.count("__cluster_dims__(2, 1, 1)") == 2
    for rows in ("Sq", "Skv"):
        assert f"dim3 grid(2, ({rows} + WROWS - 1) / WROWS, B * H);" in src, rows


@pytest.mark.parametrize("sq,waves,fill", [(4096, 1, 0.96), (16384, 4, 0.87)], ids=["512px", "1024px"])
def test_wide_bwd_pairs_fill_the_card_without_a_split(sq, waves, fill):
    """The bf16 backward at head dim 512 (the VAE mid block's single head,
    self-attention) launches a pair of CTAs for each 64-row owned tile and
    does not split its streamed loop: at 4096 tokens 128 CTAs, one wave of an
    H100's 132 SMs; at 16,384 tokens 512, whose last of four waves is 0.88
    full."""
    dq, dkv = TFA.wide_bwd_ctas(1, 1, sq, sq)
    assert dq == dkv == 2 * -(-sq // TFA.WIDE_BWD_ROWS)
    assert -(-dq // H100_SMS) == waves and dq / (waves * H100_SMS) >= fill
    assert TFA.wide_bwd_ctas(2, 3, 300, 77) == (2 * 5 * 6, 2 * 2 * 6)


@pytest.mark.parametrize("b,h,sq,skv,d,split", [
    # split: whether the q loop must be split ("yes": the training path's cross-attention with
    # a long q loop, or 160 blocks whose second wave is mostly empty), must not be ("no": the
    # grid fills whole waves or its partials cost more than they save, or kv of 256 or more
    # within one wave), or either (None)
    (1, 5, 4096, 77, 64, "yes"), (1, 10, 1024, 77, 64, "yes"), (4, 10, 1024, 77, 64, "yes"),
    (1, 20, 256, 77, 64, None), (1, 20, 64, 77, 64, "no"), (1, 20, 256, 256, 64, "no"),
    (1, 5, 4096, 4096, 64, "yes"), (1, 24, 4608, 4608, 128, "no"), (1, 10, 1024, 640, 64, None),
    (1, 10, 1024, 1700, 64, "no"), (2, 3, 300, 300, 64, None), (1, 2, 300, 77, 64, "yes"),
    (2, 2, 300, 77, 128, "yes"), (1, 1, 128, 128, 128, None),
])
def test_dkv_splits_cover_sq_once_and_fill_the_card(b, h, sq, skv, d, split):
    """The split of the bf16 dK/dV kernel's q loop on an H100: its chunks are
    whole q tiles (the last may be ragged) that cover Sq exactly once and
    differ by at most one tile; at most one wave of blocks, or 2 chunks where
    the grid unsplit takes a wave or more; the f32 scratch of the partials
    stays within the bound dkv_splits states."""
    splits = TFA.dkv_splits(b, h, sq, skv, d, H100_SMS)
    blocks = -(-skv // TFA.DKV_BLOCK_ROWS) * b * h
    n_tiles = -(-sq // TFA.Q_TILE_ROWS)
    chunks = _q_chunks(sq, splits)
    assert len(chunks) == splits and 1 <= splits <= n_tiles
    covered = np.zeros(sq, dtype=int)
    for lo, hi in chunks:
        assert lo < hi and lo % TFA.Q_TILE_ROWS == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()
    sizes = [-(-(hi - lo) // TFA.Q_TILE_ROWS) for lo, hi in chunks]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == n_tiles
    if splits > 1:  # the scratch is allocated only for a split
        assert splits * blocks <= H100_SMS or splits == 2
        scratch = splits * 2 * b * h * skv * d
        assert scratch <= max(2 * H100_SMS * TFA.DKV_BLOCK_ROWS * d, 2 * 2 * b * h * skv * d)
    if split is not None:
        assert (splits > 1) == (split == "yes"), splits


@pytest.mark.parametrize("shape,skv,with_pallas", [((1, 256, 2, 64), 77, True), ((1, 300, 2, 64), 77, False)],
                         ids=["cross77", "ragged77"])
def test_dkv_chunked_sum_matches_plain_and_pallas(shape, skv, with_pallas):
    """The f32 partials of the split dK/dV kernel, added in chunk order,
    against the unsplit plain backward and, at the cross-attention shape,
    against the Pallas kernels in interpret mode (the reference
    test_flash_bwd_plain_matches_pallas_interpret computed), at FLASH_TOL;
    short kv, so the kernel splits."""
    b, sq, h, d = shape
    splits = TFA.dkv_splits(b, h, sq, skv, d, H100_SMS)
    assert splits > 1
    q, k, v, g = _operands(shape, skv, 0)
    out, lse = TFA.flash_attention_plain(t(q), t(k), t(v), return_lse=True)
    got = _dkv_chunked_plain(t(q), t(k), t(v), out, lse, t(g), d ** -0.5, splits)
    _, dk, dv = TFA.flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(g))
    for name, a, want in zip(("dk", "dv"), got, (dk, dv)):
        assert_close(a, want.numpy(), FLASH_TOL, name)
    if with_pallas:
        for name, a, want in zip(("dk", "dv"), got, _pallas_grads(shape, skv, None, 0)[1:]):
            assert_close(a, want, FLASH_TOL, name)


@pytest.mark.parametrize("shape,skv,scale", SHAPES)
def test_flash_bwd_plain_matches_jax_dot_product_attention(shape, skv, scale):
    q, k, v, g = _operands(shape, skv, 1)
    ref = jax_once(lambda a, b, c, gg: jax.vjp(lambda a, b, c: jax.nn.dot_product_attention(a, b, c, scale=scale),
                                               a, b, c)[1](gg),
                   jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g))
    for name, got, want in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, g, scale), ref):
        assert_close(got, want, FLASH_TOL, name)


@pytest.mark.parametrize("shape,skv,scale", SHAPES)
def test_flash_bwd_plain_matches_torch_autograd(shape, skv, scale):
    """1e-5: the same f32 formulas, summed in another order."""
    q, k, v, g = _operands(shape, skv, 2)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    ref = torch.autograd.grad(TFA.flash_attention_plain(*leaves, scale), leaves, t(g))
    for name, got, want in zip(("dq", "dk", "dv"), _plain_grads(q, k, v, g, scale), ref):
        assert_close(got, want, 1e-5, name)


def test_flash_attention_under_autograd_uses_the_paired_backward(monkeypatch):
    """The wrapper's autograd function saves (q, k, v, out, lse) and calls
    flash_attention_bwd; on CPU tensors no kernel is counted."""
    q, k, v, g = _operands((2, 40, 2, 64), 24, 3)
    seen = []
    real = TFA.flash_attention_bwd

    def spy(*args):
        seen.append([tuple(a.shape) for a in args[:6]])
        return real(*args)

    monkeypatch.setattr(TFA, "flash_attention_bwd", spy)
    before = (TFA.launches.count, TFA.dq_launches.count, TFA.dkv_launches.count)
    leaves = [t(a).requires_grad_() for a in (q, k, v)]
    # dout arrives with other strides than q's
    out = TFA.flash_attention(*leaves)
    got = torch.autograd.grad(out, leaves, t(g.transpose(0, 2, 1, 3).copy()).permute(0, 2, 1, 3))
    assert seen == [[(2, 40, 2, 64), (2, 24, 2, 64), (2, 24, 2, 64), (2, 40, 2, 64), (4, 40, 1), (2, 40, 2, 64)]]
    leaves2 = [t(a).requires_grad_() for a in (q, k, v)]
    ref = torch.autograd.grad(TFA.flash_attention_plain(*leaves2), leaves2, t(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert_close(a, b, 1e-5, name)
    assert before == (TFA.launches.count, TFA.dq_launches.count, TFA.dkv_launches.count)
    # without grad the function is not entered, and lse is not differentiable
    with torch.no_grad():
        assert not TFA.flash_attention(*leaves).requires_grad
    _, lse = TFA.flash_attention(*leaves, return_lse=True)
    assert not lse.requires_grad


def test_flash_bwd_wrapper_refuses_operands_that_do_not_belong():
    q, k, v, g = (t(a) for a in _operands((1, 16, 1, 64), 8, 4))
    out, lse = TFA.flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, out, lse[:, :8], g)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k, v, out[:, :8], lse, g)
    with pytest.raises(ValueError):
        TFA.flash_attention_bwd(q, k[:, :, :, :32], v, out, lse, g)


def _gn_inputs(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(dtype)
    w = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(dtype)
    b = (rng.standard_normal(shape[-1]) * 0.1).astype(dtype)
    dy = rng.standard_normal(shape).astype(dtype)
    return x, w, b, dy


@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_silu_function_gradcheck_f64(apply_silu):
    x, w, b, _ = (t(a).requires_grad_() for a in _gn_inputs((2, 3, 4, 8), 5, np.float64))
    assert torch.autograd.gradcheck(
        lambda x, w, b: TGN.fused_group_norm_silu(x, w, b, 4, 1e-6, apply_silu), (x, w, b))


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("shape,groups", [((1, 16, 16, 32), 4), ((2, 8, 24, 16), 8), ((1, 30, 10, 32), 32)])
def test_group_norm_silu_function_matches_autograd_through_plain(shape, groups, apply_silu):
    """1e-5 of the largest gradient: the explicit backward and autograd's
    take the same f32 sums in another order."""
    x, w, b, dy = _gn_inputs(shape, 6)
    a = [t(v).requires_grad_() for v in (x, w, b)]
    r = [t(v).requires_grad_() for v in (x, w, b)]
    got = torch.autograd.grad(TGN.fused_group_norm_silu(*a, groups, 1e-6, apply_silu), a, t(dy))
    ref = torch.autograd.grad(TGN.group_norm_silu_plain(*r, groups, 1e-6, apply_silu), r, t(dy))
    for name, g, want in zip(("dx", "dweight", "dbias"), got, ref):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert (g - want).abs().max() <= 1e-5 * max(1.0, want.abs().max().item()), name
    # from the partial sums of the stats half, as the card's backward gets them
    partial = TGN.group_norm_stats(t(x), groups)
    again = TGN.group_norm_silu_bwd(t(x), partial, t(w), t(b), t(dy), groups, 1e-6, apply_silu)
    for g, want in zip(again, got):
        assert_close(g, want.numpy(), 1e-6)


# bf16 at D = 512: both sides round q, k, v, the output and the gradients to
# bf16 and the Pallas kernels also round P and dS for their second products;
# two bf16 steps of the largest value (found: 7.8e-4 forward, 1.9e-3 backward)
D512_BF16_TOL = 2.0 ** -7


@functools.lru_cache(maxsize=None)
def _pallas_d512(dtype_name):
    """(out, (dq, dk, dv)) of flash_attention_bshd in interpret mode and
    jax.vjp of it at the VAE mid block's single 512-wide head, ragged (300
    tokens), inputs _operands((1, 300, 1, 512), 300, 5) in ``dtype_name``
    ("float32" or "bfloat16"), computed once per module run."""
    q, k, v, g = _operands((1, 300, 1, 512), 300, 5)
    out_ref, grads_ref = jax_once(
        lambda a, b, c, gg: (lambda o, vjp: (o, vjp(gg)))(*jax.vjp(JFA.flash_attention_bshd, a, b, c)),
        *(jnp.asarray(a, dtype_name) for a in (q, k, v, g)))
    return out_ref, grads_ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_d512_matches_pallas_interpret(dtype):
    """The VAE mid block's single 512-wide head, ragged (300 tokens): the
    port's forward and, under autograd, its backward (the wrapper's autograd
    function, plain versions on the CPU) against flash_attention_bshd in
    interpret mode and jax.vjp of it."""
    q, k, v, g = _operands((1, 300, 1, 512), 300, 5)
    out_ref, grads_ref = _pallas_d512(str(dtype)[6:])
    assert TFA.supports(512, dtype)
    leaves = [t(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = TFA.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, t(g).to(dtype))
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out.detach(), *grads), (out_ref, *grads_ref)):
        assert got.dtype == dtype, name
        want = np.asarray(want.astype(jnp.float32))
        if dtype == torch.float32:
            assert_close(got, want, FLASH_TOL, name)
        else:
            err = np.abs(got.float().numpy() - want).max()
            assert err <= D512_BF16_TOL * np.abs(want).max(), (name, err)


def _wide_pair_plain(q, k, v, out, lse, dout, scale):
    """(dq, dk, dv) summed as the D = 512 dK/dV kernel's pair of CTAs sums
    them, in tensor code: each CTA's partial scores S_c and dP_c over its
    WIDE_BWD_COLS columns of D, added (S = S_0 + S_1), then each CTA's columns
    of the outputs from the whole P and dS (dq too, which the dQ kernel's pair
    forms from unsplit products)."""
    b, sq, h, d = q.shape
    qh, kh, vh, oh, gh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, out, dout))
    cols = [slice(c, c + TFA.WIDE_BWD_COLS) for c in range(0, d, TFA.WIDE_BWD_COLS)]
    assert len(cols) == 2
    s = sum(torch.matmul(qh[..., c], kh[..., c].transpose(-1, -2)) for c in cols)
    dp = sum(torch.matmul(gh[..., c], vh[..., c].transpose(-1, -2)) for c in cols)
    p = torch.exp(s * scale - lse.reshape(b, h, sq, 1))
    ds = p * (dp - (gh * oh).sum(dim=-1, keepdim=True))
    dq = torch.cat([torch.matmul(ds, kh[..., c]) for c in cols], dim=-1) * scale
    dk = torch.cat([torch.matmul(ds.transpose(-1, -2), qh[..., c]) for c in cols], dim=-1) * scale
    dv = torch.cat([torch.matmul(p.transpose(-1, -2), gh[..., c]) for c in cols], dim=-1)
    return tuple(x.permute(0, 2, 1, 3) for x in (dq, dk, dv))


def test_wide_pair_sum_matches_plain_and_pallas():
    """The D = 512 dK/dV kernel's split of the score products over the two
    CTAs of a pair, in f32 tensor code at the VAE mid block's ragged 300-token
    head:
    against the unsplit plain backward (1e-5: the same sums in another order)
    and against the Pallas kernels in interpret mode (FLASH_TOL, the reference
    test_flash_d512_matches_pallas_interpret computed)."""
    q, k, v, g = (t(a) for a in _operands((1, 300, 1, 512), 300, 5))
    out, lse = TFA.flash_attention_plain(q, k, v, return_lse=True)
    got = _wide_pair_plain(q, k, v, out, lse, g, 512 ** -0.5)
    want = TFA.flash_attention_bwd_plain(q, k, v, out, lse, g)
    for name, a, w, ref in zip(("dq", "dk", "dv"), got, want, _pallas_d512("float32")[1]):
        assert_close(a, w.numpy(), 1e-5, name)
        assert_close(a, np.asarray(ref), FLASH_TOL, name)


def test_encoder_mid_attention_gradient_goes_through_flash(monkeypatch):
    """The training path's VAE-encoder mid attention (one 512-wide head) under
    autograd: dot_product_attention sends it to the flash wrapper, whose
    autograd function calls flash_attention_bwd at D = 512; the gradient with
    respect to the block's input agrees with jax.vjp of the JAX package's
    _mid_attention (1e-4: GroupNorm, four dense layers and the attention, f32
    sums in another order)."""
    from omgsr_tpu.models import vae as JV
    from omgsr_tpu_torch.models import vae as TV
    from tests.torch_port_helpers import bridge, jax_init

    jp = jax_init(lambda key, ch: JV._init_attn(key, ch, jnp.float32), 0, 512)
    tp = bridge(jp)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 6, 5, 512)).astype(np.float32)
    g = rng.standard_normal((1, 6, 5, 512)).astype(np.float32)
    ref_out, (ref_dx,) = jax_once(
        lambda p, a, gg: (lambda o, vjp: (o, vjp(gg)))(*jax.vjp(lambda a: JV._mid_attention(p, a, 32), a)),
        jp, jnp.asarray(x), jnp.asarray(g))
    seen = []
    real = TFA.flash_attention_bwd

    def spy(*args):
        seen.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(TFA, "flash_attention_bwd", spy)
    xt = t(x).requires_grad_()
    out = TV._mid_attention(tp, xt, 32)
    (dx,) = torch.autograd.grad(out, xt, t(g))
    assert seen == [(1, 30, 1, 512)]
    assert_close(out.detach(), ref_out, 1e-4, "out")
    assert_close(dx, ref_dx, 1e-4, "dx")
