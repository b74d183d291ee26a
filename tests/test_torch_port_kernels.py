"""The plain PyTorch versions of the port's kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and its unfused
references. All fp32, inputs made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.models.layers import group_norm as j_group_norm
from omgsr_tpu.models.layers import silu as j_silu
from omgsr_tpu.ops import flash_attention as JFA
from omgsr_tpu.ops.attention import dot_product_attention as j_dot_product_attention
from omgsr_tpu.ops.fused_groupnorm import fused_group_norm_silu as j_fused_group_norm_silu
from omgsr_tpu_torch.ops import attention as TA
from omgsr_tpu_torch.ops import flash_attention as TFA
from omgsr_tpu_torch.ops import fused_groupnorm as TGN
from tests.torch_port_helpers import assert_close, jax_once, t


@pytest.fixture(autouse=True)
def _interpret_on_cpu():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _qkv(shape, skv, seed):
    rng = np.random.default_rng(seed)
    b, _, h, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    return q, k, v


# 2e-3 is the JAX flash test's own bound: the Pallas kernel and the plain
# version sum the softmax in different block orders.
FLASH_TOL = 2e-3


@pytest.mark.parametrize(
    "shape,skv,scale",
    [
        ((1, 256, 2, 64), 256, None),
        ((2, 300, 1, 64), 300, None),  # ragged: not a multiple of any block
        ((1, 256, 2, 64), 77, None),  # cross-attention over 77 text tokens
        ((1, 128, 1, 64), 128, 0.5),  # scale override
    ],
)
def test_flash_plain_matches_pallas_interpret(shape, skv, scale):
    q, k, v = _qkv(shape, skv, 0)
    ref = jax_once(lambda a, b, c: JFA.flash_attention_bshd(a, b, c, scale), *(jnp.asarray(a) for a in (q, k, v)))
    out = TFA.flash_attention_plain(t(q), t(k), t(v), scale)
    assert_close(out, ref, FLASH_TOL)
    # the wrapper takes the plain version for CPU tensors, and counts nothing
    before = TFA.launches.count
    assert_close(TFA.flash_attention(t(q), t(k), t(v), scale), ref, FLASH_TOL)
    assert TFA.launches.count == before


def test_flash_plain_log_sum_exp_matches_pallas():
    q, k, v = _qkv((2, 300, 1, 64), 77, 1)
    _, ref_lse = JFA._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    _, lse = TFA.flash_attention_plain(t(q), t(k), t(v), return_lse=True)
    assert_close(lse, ref_lse, FLASH_TOL)


@pytest.mark.parametrize("d,bias", [(8, False), (16, True), (64, False)])
def test_dot_product_attention_matches_jax(d, bias):
    rng = np.random.default_rng(2)
    q, k, v = _qkv((2, 24, 2, d), 10, 3)
    bb = rng.standard_normal((2, 2, 24, 10)).astype(np.float32) if bias else None
    ref = j_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=None if bb is None else jnp.asarray(bb), implementation="xla",
    )
    out = TA.dot_product_attention(t(q), t(k), t(v), bias=None if bb is None else t(bb))
    # 1e-5: same math, f32 matmuls summed in another order
    assert_close(out, ref, 1e-5)


@pytest.mark.parametrize("shape,skv,bias", [((1, 256, 1, 512), 256, False), ((2, 64, 2, 64), 48, True)])
def test_matmul_attention_bf16_keeps_f32_scores(shape, skv, bias):
    """bf16 on the CPU: one 512-wide head and a biased site against
    jax.nn.dot_product_attention, which keeps the scores
    as the f32 accumulator. Bound: one bf16 rounding of the output, 2^-8 of
    its largest value (found: 0.0020 at |out| <= 4.2 and 0.0010 at 3.9; with
    scores rounded to bf16 before the softmax 0.148 and 0.168). Inputs three
    times the unit normal, so that the scores are large enough to show it."""
    rng = np.random.default_rng(0)
    b, s, h, d = shape
    q = jnp.asarray(rng.standard_normal(shape) * 3.0, jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, skv, h, d)) * 3.0, jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, skv, h, d)), jnp.bfloat16)
    bb = jnp.asarray(rng.standard_normal((b, h, s, skv)), jnp.bfloat16) if bias else None
    ref = np.asarray(j_dot_product_attention(q, k, v, bias=bb, implementation="xla").astype(jnp.float32))

    def bf16(a):
        return t(np.asarray(a.astype(jnp.float32))).bfloat16()

    # matmul_attention itself: the dispatch sends the bias-free 512-wide head to flash attention
    out = TA.matmul_attention(bf16(q), bf16(k), bf16(v), bias=None if bb is None else bf16(bb))
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2.0 ** -8 * np.abs(ref).max()


@pytest.mark.parametrize(
    "make,copied",
    [
        # q, k, v as views of one packed (B, S, 3, H, D) tensor, at D = 64 and 128
        (lambda: torch.zeros(2, 300, 3, 3, 64, dtype=torch.bfloat16).unbind(2)[1], False),
        (lambda: torch.zeros(2, 300, 3, 3, 128, dtype=torch.bfloat16).unbind(2)[0], False),
        (lambda: torch.zeros(1, 64, 20, 64, dtype=torch.bfloat16), False),
        # head strides of 68 bf16 (136 bytes) and 66 f32 (264 bytes) are no multiples
        # of 16 bytes; 72 bf16 (144 bytes) and 68 f32 (272 bytes) are
        (lambda: torch.zeros(1, 64, 2, 68, dtype=torch.bfloat16)[..., :64], True),
        (lambda: torch.zeros(1, 64, 2, 66)[..., :64], True),
        (lambda: torch.zeros(1, 64, 2, 72, dtype=torch.bfloat16)[..., :64], False),
        (lambda: torch.zeros(1, 64, 2, 68)[..., :64], False),
        # an expanded batch (stride 0) cannot go into a TMA tensor map
        (lambda: torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16).expand(3, 64, 2, 64), True),
        # D not contiguous
        (lambda: torch.zeros(1, 64, 64, 2, dtype=torch.bfloat16).transpose(2, 3), True),
    ],
)
def test_kernel_operand_copies_only_what_the_kernels_cannot_read(make, copied):
    """The operands go to the kernels as they are where the kernels (and the
    TMA tensor maps of the D = 64/128 bf16 kernel) can read them: a 16-byte
    aligned base, a contiguous D axis, strides that are nonzero multiples of 16
    bytes; anything else is copied to a contiguous tensor first."""
    x = make()
    y = TFA._kernel_operand(x)
    assert (y is not x) == copied
    assert torch.equal(y, x)
    if copied:
        assert y.is_contiguous() and y.stride(0) > 0


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (t(a) for a in _qkv((1, 8, 1, 64), 8, 4))
    with pytest.raises(ValueError):
        TFA.flash_attention(q, k[:, :, :, :32], v)
    assert TFA.supports(64, torch.bfloat16) and TFA.supports(128, torch.float32)
    assert TFA.supports(512, torch.bfloat16) and TFA.supports(512, torch.float32)
    assert not TFA.supports(96, torch.bfloat16) and not TFA.supports(64, torch.float16)


@pytest.mark.parametrize(
    "d,dtype,bias,to_kernel",
    [(64, torch.float32, False, True), (128, torch.bfloat16, False, True),
     # a dtype the kernel does not take still goes to its wrapper, which raises
     # on the card: the dispatch never picks the matmul path for it
     (64, torch.float16, False, True),
     # the VAE mid block's single 512-wide head goes to the kernel too; a head
     # dim it does not take goes to the matmul path
     (64, torch.float32, True, False), (512, torch.float32, False, True), (96, torch.float32, False, False)],
)
def test_dot_product_attention_routes_by_head_dim_and_bias_only(monkeypatch, d, dtype, bias, to_kernel):
    seen = []

    def wrapper(q, k, v, scale=None):
        seen.append((q.shape[-1], q.dtype))
        return TFA.flash_attention_plain(q, k, v, scale)

    monkeypatch.setattr(TFA, "flash_attention", wrapper)
    q, k, v = (t(a).to(dtype) for a in _qkv((1, 8, 2, d), 6, 7))
    bb = torch.zeros(1, 2, 8, 6) if bias else None
    out = TA.dot_product_attention(q, k, v, bias=bb)
    assert out.shape == q.shape and out.dtype == dtype
    assert seen == ([(d, dtype)] if to_kernel else [])


def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1 + 1).astype(np.float32)
    bias = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    return x, scale, bias


# 2e-5 is the JAX fused-GroupNorm test's own bound: E[x^2]-mean^2 in the
# Pallas kernel against a two-pass variance, both f32.
GN_TOL = 2e-5


@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize(
    "shape,groups", [((1, 16, 16, 32), 4), ((2, 8, 24, 16), 8), ((1, 30, 10, 32), 32)]
)
def test_group_norm_silu_plain_matches_pallas_and_unfused(shape, groups, apply_silu):
    x, scale, bias = _gn_inputs(shape, 5)
    def jax_side(x, scale, bias):
        pallas = j_fused_group_norm_silu(x, scale, bias, groups, 1e-6, apply_silu=apply_silu, block_rows=64)
        unfused = j_group_norm({"scale": scale, "bias": bias}, x, groups, 1e-6)
        return pallas, j_silu(unfused) if apply_silu else unfused

    pallas, unfused = jax_once(jax_side, *(jnp.asarray(a) for a in (x, scale, bias)))
    plain = TGN.group_norm_silu_plain(t(x), t(scale), t(bias), groups, 1e-6, apply_silu)
    assert_close(plain, pallas, GN_TOL, "plain vs pallas interpret")
    assert_close(plain, unfused, GN_TOL, "plain vs silu(group_norm)")
    # the wrapper and its two halves take the plain route on the CPU
    before = (TGN.stats_launches.count, TGN.apply_launches.count)
    fused = TGN.fused_group_norm_silu(t(x), t(scale), t(bias), groups, 1e-6, apply_silu)
    halves = TGN.group_norm_apply(
        t(x), TGN.group_norm_stats(t(x), groups), t(scale), t(bias), groups, 1e-6, apply_silu
    )
    assert_close(fused, pallas, GN_TOL, "wrapper vs pallas interpret")
    assert_close(halves, pallas, GN_TOL, "stats+apply vs pallas interpret")
    assert (TGN.stats_launches.count, TGN.apply_launches.count) == before


@pytest.mark.parametrize(
    "rows,c,groups,elem,batch",
    [(512 * 512, 128, 32, 2, 1), (64 * 64, 320, 32, 2, 1), (64, 2560, 32, 2, 1),
     (300, 32, 32, 4, 1), (32 * 32, 1920, 32, 2, 4), (7, 8, 4, 4, 2)],
)
def test_group_norm_launch_geometry(rows, c, groups, elem, batch):
    geo = TGN.launch_geometry(rows, c, groups, elem, batch)
    cg = c // groups
    assert cg % geo.vec == 0 and geo.vec * elem <= 16
    assert c % geo.apply_vec == 0 and geo.apply_vec * elem <= 16
    chunk_rows, nchunks = geo.chunk_rows, geo.nchunks
    assert nchunks == -(-rows // chunk_rows) and (nchunks - 1) * chunk_rows < rows
    assert nchunks * batch <= 512
    # stats block: whole groups by k rows, within the 1024-thread block
    assert 1 <= geo.gpb <= groups and 1 <= geo.gpb * (cg // geo.vec) * geo.k <= 1024
    # apply block: cvb vectors by k rows (no more rows than the image has), rounded up to
    # whole warps and to a thread for each (group, sum) of the fold, within APPLY_THREADS
    assert 1 <= geo.apply_k <= rows and 1 <= geo.cvb <= c // geo.apply_vec
    threads = max(-(-geo.cvb * geo.apply_k // 32), -(-2 * groups // 32)) * 32
    assert threads <= TGN.APPLY_THREADS


@pytest.mark.parametrize("apply_silu", [True, False])
def test_group_norm_apply_plain_on_many_chunks_matches_pallas(apply_silu):
    """K3b's plain route on partial sums cut into many uneven chunks of rows (as
    the stats kernel writes them on the card; the apply kernel folds them all)
    against the Pallas kernel in interpret mode."""
    shape, groups = (2, 12, 10, 32), 8
    x, scale, bias = _gn_inputs(shape, 9)
    pallas = jax_once(
        lambda x, s, b: j_fused_group_norm_silu(x, s, b, groups, 1e-6, apply_silu=apply_silu, block_rows=64),
        *(jnp.asarray(a) for a in (x, scale, bias)))
    rows = t(x).reshape(2, 120, 1, 32)
    cuts = [0, 1, 9, 10, 33, 64, 65, 100, 120]  # eight chunks of 1 to 35 rows
    partial = torch.cat([TGN.group_norm_stats_plain(rows[:, a:b], groups) for a, b in zip(cuts, cuts[1:])], dim=1)
    assert partial.shape == (2, 8, groups, 2)
    before = TGN.apply_launches.count
    y = TGN.group_norm_apply(t(x), partial, t(scale), t(bias), groups, 1e-6, apply_silu)
    assert TGN.apply_launches.count == before
    assert_close(y, pallas, GN_TOL, "apply on 8 chunks vs pallas interpret")


@pytest.mark.parametrize("rows,k,batch,segments,per_sm,want", [
    (512 * 512, 32, 1, 1, 2, 264),  # one wave of 132 SMs x 2 blocks
    (64 * 64, 12, 4, 1, 2, 66),  # the batch shares the wave
    (64, 1, 1, 1, 2, 64),  # no more blocks than k-row steps
    (15, 2, 1, 3, 1, 8),
    (7, 7, 2, 1, 4, 1),
    (100, 4, 300, 1, 1, 1),  # more (batch, segment) pairs than a wave: one block each
])
def test_apply_row_blocks_fill_one_wave(rows, k, batch, segments, per_sm, want):
    got = TGN.apply_row_blocks(rows, k, batch, segments, 132, per_sm)
    assert got == want
    assert 1 <= got <= -(-rows // k)
    assert got * batch * segments <= max(132 * per_sm, batch * segments)


def test_apply_block_matches_the_kernel_source():
    """The wrapper's cap on an apply block is the kernel's own (APPLY_MAX_THREADS
    in the CUDA source, also its launch bound)."""
    import re
    from pathlib import Path

    src = (Path(TGN.__file__).parent.parent / "csrc" / "group_norm_silu.cu").read_text()
    assert int(re.search(r"constexpr int APPLY_MAX_THREADS = (\d+);", src).group(1)) == TGN.APPLY_THREADS
    assert "__launch_bounds__(APPLY_MAX_THREADS) gn_apply_kernel" in src


def test_group_norm_wrapper_refuses_bad_shapes():
    x, scale, bias = (t(a) for a in _gn_inputs((1, 4, 4, 12), 6))
    with pytest.raises(ValueError):
        TGN.fused_group_norm_silu(x, scale, bias, 5)
    with pytest.raises(ValueError):
        TGN.group_norm_apply(x, TGN.group_norm_stats(x, 4), scale[:6], bias, 4)


def test_plain_route_context_restores_itself():
    from omgsr_tpu_torch.ops.kernel_build import plain_route_active, route_kernels_to_plain

    assert not plain_route_active()
    with route_kernels_to_plain():
        assert plain_route_active()
    assert not plain_route_active()


H100_SMS = 132  # the SMs of an H100 SXM, which fwd_kv_splits' cost was fitted on


def _kv_chunks(skv, splits):
    """The [start, stop) kv rows of each chunk of the bf16 D = 512 forward's
    split kv loop, cut as the kernel cuts them: chunk z takes kv tiles
    z*n // splits .. (z+1)*n // splits - 1 of the n = ceil(Skv / 64)."""
    n = -(-skv // TFA.WIDE_KV_ROWS)
    return [(z * n // splits * TFA.WIDE_KV_ROWS, min(skv, (z + 1) * n // splits * TFA.WIDE_KV_ROWS))
            for z in range(splits)]


def test_wide_tile_sizes_match_the_kernel_source():
    """fwd_kv_splits counts blocks and kv tiles with the D = 512 kernel's own
    tile sizes (WQ and WKV in the CUDA source)."""
    import re
    from pathlib import Path

    src = (Path(TFA.__file__).parent.parent / "csrc" / "flash_attention_fwd.cu").read_text()
    assert int(re.search(r"constexpr int WQ = (\d+);", src).group(1)) == TFA.WIDE_Q_ROWS
    assert int(re.search(r"constexpr int WKV = (\d+);", src).group(1)) == TFA.WIDE_KV_ROWS


@pytest.mark.parametrize("b,h,sq,skv,d,split", [
    # split: whether the kv loop must be split ("yes": q tiles that leave SMs idle, the VAE mid
    # head at 512 px), must not be ("no": a wave or more of q tiles, the 1024- and 2048-px heads
    # and the fast tiled decode's window; head dims 64 and 128, whose kernel does not split), or
    # either (None)
    (1, 1, 4096, 4096, 512, "yes"), (1, 1, 16384, 16384, 512, "no"), (1, 1, 65536, 65536, 512, "no"),
    (1, 1, 7396, 7396, 512, "no"), (2, 2, 300, 300, 512, None), (1, 1, 200, 1000, 512, "yes"),
    (1, 1, 64, 64, 512, "no"), (1, 1, 100, 77, 512, None), (1, 5, 4096, 77, 64, "no"),
    (1, 24, 4608, 4608, 128, "no"),
])
def test_fwd_kv_splits_cover_kv_once_and_fill_the_card(b, h, sq, skv, d, split):
    """The split of the bf16 D = 512 forward's kv loop on an H100: its chunks
    are whole kv tiles (the last may be ragged) that cover Skv exactly once and
    differ by at most one tile, and a split grid stays within one wave."""
    splits = TFA.fwd_kv_splits(b, h, sq, skv, d, H100_SMS)
    n_tiles = -(-skv // TFA.WIDE_KV_ROWS)
    chunks = _kv_chunks(skv, splits)
    assert 1 <= splits <= n_tiles
    covered = np.zeros(skv, dtype=int)
    for lo, hi in chunks:
        assert lo < hi and lo % TFA.WIDE_KV_ROWS == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()
    sizes = [-(-(hi - lo) // TFA.WIDE_KV_ROWS) for lo, hi in chunks]
    assert max(sizes) - min(sizes) <= 1
    if splits > 1:
        assert d == 512 and splits * -(-sq // TFA.WIDE_Q_ROWS) * b * h <= H100_SMS
    if split is not None:
        assert (splits > 1) == (split == "yes"), splits


# the split kv loop and its merge against the unsplit function, f32: the same
# products, the softmax normalised per chunk and the chunks weighted by
# exp(lse_z - lse); only the order of the f32 sums differs
SPLIT_TOL = 1e-5


@pytest.mark.parametrize("shape,skv,splits", [((1, 100, 1, 512), 300, 3), ((2, 70, 1, 512), 130, 2)],
                         ids=["ragged3", "batch2"])
def test_split_and_merge_matches_plain_and_pallas(shape, skv, splits):
    """The plain model of the D = 512 forward with its kv loop split in chunks
    (partial O and lse per chunk) and merged in chunk order, in f32, against
    flash_attention_plain and against the Pallas kernel in interpret mode; the
    merge wrapper on the CPU gives the same merge rounded to bf16."""
    b, sq, h, d = shape
    q, k, v = _qkv(shape, skv, 7)
    o_part, lse_part = TFA.flash_attention_split_plain(t(q), t(k), t(v), d ** -0.5, splits)
    assert o_part.shape == (splits, b * h, sq, d) and lse_part.shape == (splits, b * h, sq)
    out, lse = TFA.flash_attention_merge_plain(o_part, lse_part, b, h, torch.float32)
    # the merge wrapper on the CPU: its plain version (bf16 out, as the kernel's), no launch
    before = TFA.merge_launches.count
    wrapped, wrapped_lse = TFA.flash_attention_merge(o_part, lse_part, b, h)
    assert TFA.merge_launches.count == before and wrapped.dtype == torch.bfloat16
    assert torch.equal(wrapped, out.to(torch.bfloat16)) and torch.equal(wrapped_lse, lse)
    ref, ref_lse = TFA.flash_attention_plain(t(q), t(k), t(v), return_lse=True)
    assert_close(out, ref.numpy(), SPLIT_TOL, "merged vs unsplit plain")
    assert_close(lse, ref_lse.numpy(), SPLIT_TOL, "merged lse vs unsplit plain")
    pallas, pallas_lse = jax_once(lambda a, b_, c: JFA._forward(a, b_, c, None), *(jnp.asarray(a) for a in (q, k, v)))
    assert_close(out, np.asarray(pallas), SPLIT_TOL, "merged vs pallas interpret")
    assert_close(lse, np.asarray(pallas_lse).reshape(lse.shape), SPLIT_TOL, "merged lse vs pallas interpret")
