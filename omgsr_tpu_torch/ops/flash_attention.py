"""Flash attention, forward and backward: hand-written CUDA kernels, their
wrappers and their plain PyTorch versions. (B, S, H, D) layout, as in the JAX
package.

Source note. ``flash_attention`` replaces the Pallas TPU kernel
``omgsr_tpu/ops/flash_attention.py:_fwd_kernel`` (reached through
``_forward`` / ``flash_attention_bshd``). On an H100 the function is bound
by operations: 4*B*H*Sq*Skv*D flops against inputs that are read once. The
kernels (``csrc/flash_attention_fwd.cu``) give one block a q tile of one
(batch, head) and loop over kv tiles inside the block, which takes the place
of the TPU's sequential kv grid axis; they read q/k/v through their strides
(no head-major transpose copy), mask the ragged ends of Sq and Skv
themselves (no padding in device memory), accumulate in f32 and also write
the f32 log-sum-exp per query row. bf16 inputs at head dims 64 and 128 go to
a kernel built for Hopper: TMA loads through tensor maps over the caller's
strides into a ring of shared-memory stages guarded by mbarriers, ``wgmma``
for both products, a producer warpgroup and two consumer warpgroups of 64 q
rows that take turns on the tensor cores. At D = 512 (the VAE mid block's
single head) the bf16 kernel is built the same way on a 64-row q tile whose
two consumer warpgroups each own half of O's 512 columns and compute the
scores themselves (so P stays in registers), with one K and one V tile of 64
kv rows in flight; where its q tiles leave SMs idle (``fwd_kv_splits``) the kv
loop is split in chunks whose f32 partial O and lse a second kernel merges in
chunk order (``flash_attention_merge``). f32 inputs go to a kernel that
multiplies with f32 FMAs and is exact. PERF.md holds their times beside the
bound.

``flash_attention_bwd`` replaces the Pallas TPU kernels ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` of the same file (reached through ``_backward``, the
``custom_vjp`` of ``flash_attention_bshd``). Both are bound by operations
(6 and 8 times B*H*Sq*Skv*D flops). ``csrc/flash_attention_bwd.cu`` keeps the
split that fixes the order of every sum: in the dQ kernel one block owns a q
tile and loops over kv tiles, in the dK/dV kernel one block owns a kv tile and
loops over q tiles; no atomics, so the same inputs give the same bits on every
run. Both read their operands through strides and mask the ragged ends
themselves. bf16 inputs at head dims 64 and 128 go to kernels built for
Hopper: blocks of 128 owned rows (two consumer warpgroups; 192, three, for
the dQ kernel at D = 64 where that takes fewer waves) fed by a producer
warpgroup's TMA loads through tensor maps over the caller's strides into a
ring of shared-memory stages guarded by mbarriers, the score products and the
output products by ``wgmma`` (P and dS rounded to bf16 as register fragments
of the second products; the dK/dV kernel takes its scores transposed, so its
rows are kv rows). Where ceil(Skv/128)*B*H blocks would leave SMs idle
(77 text tokens) or a partial last wave, ``dkv_splits`` may cut the dK/dV
kernel's q loop into chunks whose f32 partials a second kernel of the same
launch adds in chunk order. At D = 512 (the VAE mid block's single head) the
bf16 kernels are built the same way on clusters of two CTAs that share a
64-row owned tile (``WIDE_BWD_ROWS``) and hand score tiles to each other
through distributed shared memory: in the dQ kernel one CTA makes S, P, dS and
all of dQ while the other makes dP and sends it ahead; in the dK/dV kernel each
CTA holds ``WIDE_BWD_COLS`` of the 512 columns of every operand and output and
the two add each other's partial scores. Every product is made once, each
streamed byte is read once, and 4096 tokens fill one wave of 128 CTAs with no
split (``wide_bwd_ctas``); f32 inputs go to kernels that multiply with f32 FMAs
from shared memory and are exact. delta =
rowsum(dout * O), which the JAX package computes with tensor code outside its
kernels, is a prologue of the dQ kernel here: it writes the (B*H, Sq) f32 sums
that the dK/dV kernel, launched after it on the same stream, reads.

Under autograd ``flash_attention`` pairs the forward kernel (which saves q, k,
v, out and the log-sum-exp) with the two backward kernels in one
``torch.autograd.Function``; on CPU tensors the same Function computes both
directions with the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from omgsr_tpu_torch.ops.kernel_build import (
    LaunchCounter,
    launch_kernel,
    load_kernel_library,
    plain_route_active,
)

SUPPORTED_HEAD_DIMS = (64, 128, 512)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# the bf16 backward kernels built for Hopper (the dK/dV one can split its q loop)
_SPLIT_HEAD_DIMS = (64, 128)
# the dK/dV kernel's tile sizes (HO and HS in csrc/flash_attention_bwd.cu)
DKV_BLOCK_ROWS = 128  # kv rows a block owns
Q_TILE_ROWS = 64  # q rows of a tile it streams
# the cost dkv_splits weighs, fitted to the kernel's device time on an H100 SXM
_Q_TILE_US = {64: 1.2, 128: 2.5}  # one streamed q tile of a dK/dV block
_SPLIT_US = 2.0  # the reduction kernel's launch
_SPLIT_US_PER_MB = 0.5  # per MB of f32 partials (written, then read back by the reduction)

# the bf16 forward at head dim 512: q and kv rows of a tile, and the cost
# fwd_kv_splits weighs, read off the kernels' device time on an H100 SXM
# (check_flash_fwd: about 2.8 us a kv tile at 16,384 and 65,536 tokens, the
# merge about 22 us for 2 x 33.6 MB of partials at 4096)
WIDE_Q_ROWS = 64
WIDE_KV_ROWS = 64
_WIDE_TILE_US = 2.8  # one kv tile of a block
_MERGE_US = 3.0  # the merge kernel's launch
_MERGE_US_PER_MB = 0.6  # per MB of f32 partials (written, then read back by the merge)

# the bf16 backward at head dim 512: the rows of every tile a CTA owns or streams,
# and the columns of D each CTA of a dK/dV pair holds (each consumer of dQ owns
# as many); WROWS and WCOLS in csrc/flash_attention_bwd.cu
WIDE_BWD_ROWS = 64
WIDE_BWD_COLS = 256

launches = LaunchCounter("flash_attention_fwd")
merge_launches = LaunchCounter("flash_attention_fwd_merge")
dq_launches = LaunchCounter("flash_attention_bwd_dq")
dkv_launches = LaunchCounter("flash_attention_bwd_dkv")


def flash_attention_plain(q, k, v, scale: float | None = None, return_lse: bool = False, out_dtype=None):
    """softmax(q k^T * scale) v by explicit matmul -> softmax(f32) -> matmul.

    q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D) in q's dtype (or
    ``out_dtype``), and with ``return_lse`` the f32 log-sum-exp (B*H, Sq, 1).
    The same function as the kernel, used for CPU tensors, by the tests, and
    as the comparison on the card."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.matmul(torch.exp(s - lse), vh).permute(0, 2, 1, 3).to(out_dtype or q.dtype)
    if return_lse:
        return out, lse.reshape(b * h, sq, 1)
    return out


def flash_attention_split_plain(q, k, v, scale: float, splits: int):
    """The bf16 D = 512 kernel's function with its kv loop split in ``splits``
    chunks, in explicit tensor code: chunk z takes kv tiles z*n // G ..
    (z+1)*n // G - 1 of the n = ceil(Skv / 64) and gives its own softmax
    average of v, O_z (f32), and log-sum-exp lse_z. Returns (o_part (G, B*H,
    Sq, D), lse_part (G, B*H, Sq)), both f32."""
    b, sq, h, d = q.shape
    n = -(-k.shape[1] // WIDE_KV_ROWS)
    outs, lses = [], []
    for z in range(splits):
        lo, hi = z * n // splits * WIDE_KV_ROWS, (z + 1) * n // splits * WIDE_KV_ROWS
        o, lse = flash_attention_plain(q, k[:, lo:hi], v[:, lo:hi], scale, return_lse=True, out_dtype=torch.float32)
        outs.append(o.permute(0, 2, 1, 3).reshape(b * h, sq, d))
        lses.append(lse.reshape(b * h, sq))
    return torch.stack(outs), torch.stack(lses)


def flash_attention_merge_plain(o_part, lse_part, b: int, h: int, dtype=torch.bfloat16):
    """The chunks of a split kv loop (``flash_attention_split_plain``'s) ->
    (out (B, Sq, H, D) in ``dtype``, lse (B*H, Sq, 1) f32): lse = log sum_z
    exp(lse_z), out = sum_z exp(lse_z - lse) O_z. The merge kernel's function
    in tensor code."""
    g, bh, sq, d = o_part.shape
    lse = torch.logsumexp(lse_part, dim=0)
    out = (torch.exp(lse_part - lse)[..., None] * o_part).sum(dim=0)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(dtype), lse.reshape(bh, sq, 1)


@functools.lru_cache(maxsize=None)
def fwd_kv_splits(b: int, h: int, sq: int, skv: int, d: int, sms: int) -> int:
    """Chunks of the kv loop of the bf16 forward at head dim 512 on a card of
    ``sms`` SMs (1 at the other head dims: their kernel does not split).

    The G that minimises the waves of G * ceil(Sq / 64) * B * H blocks (one
    block an SM) times the longest chunk's kv tiles at ``_WIDE_TILE_US`` each,
    plus for G > 1 the merge's launch and the f32 partials written and read
    back. G runs up to one wave of blocks: 4096 tokens (64 q tiles) split in
    2; 7396 (116 tiles) and more, which fill a wave or more unsplit, do not."""
    if d != 512:
        return 1
    blocks = -(-sq // WIDE_Q_ROWS) * b * h
    n = -(-skv // WIDE_KV_ROWS)
    best, best_us = 1, -(-blocks // sms) * n * _WIDE_TILE_US
    for g in range(2, min(n, sms // blocks) + 1):
        partial_mb = 2 * g * b * h * sq * (d + 1) * 4 / 1e6
        us = -(-g * blocks // sms) * -(-n // g) * _WIDE_TILE_US + _MERGE_US + _MERGE_US_PER_MB * partial_mb
        if us < best_us:
            best, best_us = g, us
    return best


def supports(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this head dim and dtype."""
    return head_dim in SUPPORTED_HEAD_DIMS and dtype in _DTYPE_CODE


def _fwd_library():
    """(flash_attention_fwd, flash_attention_fwd_split, flash_attention_fwd_merge)
    of the forward library, bound."""
    lib = load_kernel_library("flash_attention_fwd")
    fn, split, merge = lib.flash_attention_fwd, lib.flash_attention_fwd_split, lib.flash_attention_fwd_merge
    if not fn.argtypes:
        vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i] + [ll] * 9 + [f, vp]
        split.argtypes = [vp] * 5 + [i] * 5 + [ll] * 9 + [f, vp]
        merge.argtypes = [vp] * 4 + [i] * 4 + [vp]
        fn.restype = split.restype = merge.restype = ctypes.c_int
    return fn, split, merge


def _library():
    return _fwd_library()[0]


def _kernel_operand(x):
    """The operand as the kernels take it, copied only where they cannot: they
    read 16-byte vectors along a contiguous D axis, and the bf16 kernel at head
    dims 64 and 128 reads through a TMA tensor map, whose base and strides are
    multiples of 16 bytes and whose strides are not 0 (an expanded dimension)."""
    vec = 16 // x.element_size()
    ok = (
        x.stride(3) == 1
        and x.data_ptr() % 16 == 0
        and all(x.stride(i) % vec == 0 and (x.stride(i) > 0 or x.shape[i] == 1) for i in range(3))
    )
    return x if ok else x.contiguous()


def _bwd_plain_scores(q, k, v, out, lse, dout, scale):
    """(P, dS, q, k, dout) head-major in f32: P = exp(scale q k^T - lse),
    delta = rowsum(dout * out), dS = P * (dout v^T - delta)."""
    b, sq, h, d = q.shape
    qh, kh, vh, oh, gh = (t.permute(0, 2, 1, 3).float() for t in (q, k, v, out, dout))
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))
    p = torch.exp(s - lse.reshape(b, h, sq, 1))
    delta = (gh * oh).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(gh, vh.transpose(-1, -2)) - delta)
    return p, ds, qh, kh, gh


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, scale: float):
    """dq = scale dS k: the dQ kernel's function in explicit tensor code."""
    _, ds, _, kh, _ = _bwd_plain_scores(q, k, v, out, lse, dout, scale)
    return (torch.matmul(ds, kh) * scale).permute(0, 2, 1, 3).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, out, lse, dout, scale: float):
    """(dk, dv) = (scale dS^T q, P^T dout): the dK/dV kernel's function in
    explicit tensor code."""
    p, ds, qh, _, gh = _bwd_plain_scores(q, k, v, out, lse, dout, scale)
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.transpose(-1, -2), gh)
    return dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The SMs of a CUDA device: the grid a dK/dV launch should fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def dkv_splits(b: int, h: int, sq: int, skv: int, d: int, sms: int) -> int:
    """Chunks of the q loop of the bf16 dK/dV kernel (head dims 64 and 128) on
    a card of ``sms`` SMs, each chunk z taking q tiles z*n // G .. (z+1)*n // G - 1
    of the n = ceil(Sq / 64).

    The G that minimises a cost fitted to the kernel on an H100
    (``check_flash_bwd``'s sweep of the splits): the waves of G * blocks
    blocks (one block an SM) times the longest chunk's q tiles at
    ``_Q_TILE_US[d]`` each, plus for G > 1 the reduction's launch and the f32
    partials written and read back. G runs up to one wave of blocks, or 2
    where the ceil(Skv / 128) * B * H blocks unsplit take a wave or more: a
    partial last wave (160 blocks, q(1,4096,5,64) kv 4096) gains from 2, and
    the scratch, G * 2 * B * H * Skv * D floats, stays below the larger of
    2 * sms * 128 * D floats and twice dK and dV in f32. Short kv with a long
    q loop (77 text tokens) splits; kv of 256 or more within one wave, whose
    partials weigh as much as the tiles they save, does not."""
    blocks = -(-skv // DKV_BLOCK_ROWS) * b * h
    n_tiles = -(-sq // Q_TILE_ROWS)
    best, best_us = 1, -(-blocks // sms) * n_tiles * _Q_TILE_US[d]
    for g in range(2, min(n_tiles, max(sms // blocks, 2)) + 1):
        partial_mb = g * 2 * b * h * skv * d * 4 / 1e6
        us = (-(-g * blocks // sms) * -(-n_tiles // g) * _Q_TILE_US[d]
              + _SPLIT_US + _SPLIT_US_PER_MB * partial_mb)
        if us < best_us:
            best, best_us = g, us
    return best


def wide_bwd_ctas(b: int, h: int, sq: int, skv: int) -> tuple[int, int]:
    """The CTAs the bf16 dQ and dK/dV kernels at head dim 512 launch: a pair
    (one cluster of two CTAs) for each owned 64-row tile of q (dQ) or of kv
    (dK/dV) of each (batch, head)."""
    return (2 * -(-sq // WIDE_BWD_ROWS) * b * h, 2 * -(-skv // WIDE_BWD_ROWS) * b * h)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention_plain`` for the cotangent ``dout``,
    from the saved output and log-sum-exp, in explicit tensor code with the
    kernels' formulas: P = exp(scale q k^T - lse), delta = rowsum(dout * out),
    dS = P * (dout v^T - delta), dq = scale dS k, dk = scale dS^T q,
    dv = P^T dout; everything in f32, results in the inputs' dtypes. Used for
    CPU tensors, by the tests, and as the comparison on the card."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds, qh, kh, gh = _bwd_plain_scores(q, k, v, out, lse, dout, scale)
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.transpose(-1, -2), gh)
    return (dq.permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected (B,S,H,D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")


def _check_kernel_operands(q, k, v):
    """What the kernels take on the card; raises otherwise."""
    b, sq, h, d = q.shape
    if not (k.is_cuda and v.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on the same CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or not supports(d, q.dtype):
        raise NotImplementedError(
            f"flash_attention kernel takes bf16/f32 at head dim {SUPPORTED_HEAD_DIMS}, "
            f"got {q.dtype}, {k.dtype}, {v.dtype} at head dim {d}"
        )
    if min(b, sq, h, k.shape[1]) < 1:
        raise ValueError(f"empty attention operand: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if b * h > 65535:
        raise NotImplementedError(f"batch*heads = {b * h} exceeds the kernel's grid")


def _strides(*tensors):
    flat = [t.stride(i) for t in tensors for i in range(3)]
    return (ctypes.c_longlong * len(flat))(*flat)


def _forward(q, k, v, scale):
    """(out, lse): the forward kernel on CUDA tensors, else the plain version."""
    if not q.is_cuda or plain_route_active():
        return flash_attention_plain(q, k, v, scale, return_lse=True)
    _check_kernel_operands(q, k, v)
    b, sq, h, d = q.shape
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    if q.dtype == torch.bfloat16:
        splits = fwd_kv_splits(b, h, sq, k.shape[1], d, sm_count(q.device))
        if splits > 1:
            return _forward_split(q, k, v, scale, splits)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    launch_kernel(
        _library(), "flash_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, sq, k.shape[1], d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale),
    )
    launches.add()
    return out, lse


def _forward_split(q, k, v, scale, splits):
    """The bf16 D = 512 kernel with its kv loop in ``splits`` chunks on checked
    operands, then the merge of the chunks -> (out, lse)."""
    b, sq, h, d = q.shape
    o_part = torch.empty((splits, b * h, sq, d), dtype=torch.float32, device=q.device)
    lse_part = torch.empty((splits, b * h, sq), dtype=torch.float32, device=q.device)
    launch_kernel(
        _fwd_library()[1], "flash_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(),
        splits, b, h, sq, k.shape[1],
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale),
    )
    launches.add()
    return flash_attention_merge(o_part, lse_part, b, h)


def flash_attention_merge(o_part, lse_part, b: int, h: int):
    """The chunks of a split kv loop, o_part (G, B*H, Sq, D) and lse_part (G,
    B*H, Sq) f32 -> (out (B, Sq, H, D) bf16, lse (B*H, Sq, 1) f32), added in
    chunk order. On CUDA tensors this launches the merge kernel (head dim 512)
    or raises; the plain version runs only for CPU tensors."""
    g, bh, sq, d = o_part.shape
    if lse_part.shape != (g, bh, sq) or bh != b * h:
        raise ValueError(f"o_part {tuple(o_part.shape)} and lse_part {tuple(lse_part.shape)} do not fit "
                         f"batch {b} x heads {h}")
    if not o_part.is_cuda or plain_route_active():
        return flash_attention_merge_plain(o_part, lse_part, b, h)
    if d != 512 or o_part.dtype != torch.float32 or lse_part.dtype != torch.float32:
        raise NotImplementedError(f"the merge kernel takes f32 chunks at head dim 512, got {o_part.dtype} "
                                  f"at {d}")
    o_part, lse_part = o_part.contiguous(), lse_part.contiguous()
    out = torch.empty((b, sq, h, d), dtype=torch.bfloat16, device=o_part.device)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=o_part.device)
    launch_kernel(_fwd_library()[2], "flash_attention_fwd_merge", o_part.device,
                  o_part.data_ptr(), lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(), g, b, h, sq)
    merge_launches.add()
    return out, lse


def _bwd_library():
    """(flash_attention_bwd_dq, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_split) of the backward library, bound."""
    lib = load_kernel_library("flash_attention_bwd")
    dq, dkv, split = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv, lib.flash_attention_bwd_dkv_split
    if not dq.argtypes:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        dq.argtypes = [vp] * 8 + [i] * 6 + [strides, f, vp]
        dkv.argtypes = [vp] * 8 + [i] * 6 + [strides, f, vp]
        split.argtypes = [vp] * 8 + [i] * 6 + [strides, f, i, vp, vp]
        dq.restype = dkv.restype = split.restype = ctypes.c_int
    return dq, dkv, split


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent ``dout``, from
    the forward's output (B, Sq, H, D) and f32 log-sum-exp (B*H, Sq, 1).

    On CUDA tensors this launches the dQ kernel, then the dK/dV kernel (and,
    when its q loop is split, the kernel that adds the chunks' partials), or
    raises; the plain version runs only for CPU tensors."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b * h, sq, 1):
        raise ValueError(
            f"out {tuple(out.shape)}, dout {tuple(dout.shape)} or lse {tuple(lse.shape)} "
            f"do not belong to q {tuple(q.shape)}"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda or plain_route_active():
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, scale)
    _check_kernel_operands(q, k, v)
    if not all(t.device == q.device for t in (out, lse, dout)):
        raise ValueError("out, lse and dout must lie on q's CUDA device")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise NotImplementedError(
            f"out and dout must have q's dtype and lse f32, got {out.dtype}, {dout.dtype}, {lse.dtype}"
        )
    q, k, v, out, dout = (_kernel_operand(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    dq, delta = _launch_dq(q, k, v, out, lse, dout, scale)
    dk, dv = _launch_dkv(q, k, v, lse, delta, dout, scale)
    return dq, dk, dv


def _launch_dq(q, k, v, out, lse, dout, scale):
    """The dQ kernel on checked operands -> (dq, delta (B*H, Sq) f32)."""
    b, sq, h, d = q.shape
    delta = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    launch_kernel(
        _bwd_library()[0], "flash_attention_bwd_dq", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, sq, k.shape[1], d, _strides(q, k, v, out, dout), float(scale),
    )
    dq_launches.add()
    return dq, delta


def _launch_dkv(q, k, v, lse, delta, dout, scale, splits=None):
    """The dK/dV kernel on checked operands and the dQ kernel's delta; for the
    bf16 kernel at head dims 64 and 128 with its q loop split in ``splits``
    chunks (default ``dkv_splits``') through the split entry, whose f32
    partials go to scratch allocated here."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dk = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
    if splits is None:
        splits = (dkv_splits(b, h, sq, skv, d, sm_count(q.device))
                  if q.dtype == torch.bfloat16 and d in _SPLIT_HEAD_DIMS else 1)
    split = ()
    if splits > 1:
        partial = torch.empty((splits, 2, b * h, skv, d), dtype=torch.float32, device=q.device)
        split = (splits, partial.data_ptr())
    launch_kernel(
        _bwd_library()[2 if split else 1], "flash_attention_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, sq, skv, d, _strides(q, k, v, dout), float(scale), *split,
    )
    dkv_launches.add()
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel paired with the two backward kernels (plain versions
    for CPU tensors). Saves q, k, v, out and the log-sum-exp; the scores are
    recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: float | None = None, return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D) [, lse (B*H, Sq, 1)].

    On CUDA tensors this launches the forward kernel, and under autograd the
    dQ and dK/dV kernels in the backward, or raises; the plain versions run
    only for CPU tensors."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out, lse = _FlashAttention.apply(q, k, v, scale)
    else:
        out, lse = _forward(q, k, v, scale)
    if return_lse:
        return out, lse
    return out
