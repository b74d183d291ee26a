"""Flash attention, forward and backward: hand-written CUDA kernels, their
wrappers and their plain PyTorch versions. (B, S, H, D) layout, as in the JAX
package.

Source note. ``flash_attention`` replaces the Pallas TPU kernel
``omgsr_tpu/ops/flash_attention.py:_fwd_kernel`` (reached through
``_forward`` / ``flash_attention_bshd``). On an H100 the function is bound
by operations: 4*B*H*Sq*Skv*D flops against inputs that are read once. The
kernel (``csrc/flash_attention_fwd.cu``) gives one block a 64-row q tile of
one (batch, head) and loops over 64-row kv tiles inside the block, which
takes the place of the TPU's sequential kv grid axis; it reads q/k/v through
their strides (no head-major transpose copy), masks the ragged ends of Sq
and Skv itself (no padding in device memory), accumulates in f32 and also
writes the f32 log-sum-exp per query row. bf16 inputs go to a tensor-core
kernel (``mma.sync`` m16n8k16, Q fragments and the accumulator in registers,
K/V tiles in shared memory read with ``ldmatrix``); f32 inputs go to a
kernel that multiplies with f32 FMAs and is exact. Head dims 64, 128 and 512
(the VAE mid block's single head). At D = 512 a warp cannot hold 16 rows of
fragments and their 16 x 512 accumulator in registers, so the bf16 kernel
there stages the q tile in shared memory and its eight warps split the score
block and the output columns, exchanging P through shared memory; the f32
kernel takes smaller tiles. None uses ``wgmma`` or TMA yet; PERF.md holds
their times beside the bound.

``flash_attention_bwd`` replaces the Pallas TPU kernels ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` of the same file (reached through ``_backward``, the
``custom_vjp`` of ``flash_attention_bshd``). Both are bound by operations
(6 and 8 times B*H*Sq*Skv*D flops). ``csrc/flash_attention_bwd.cu`` keeps the
split that fixes the order of every sum: in the dQ kernel one block owns a
64-row q tile and loops over kv tiles, in the dK/dV kernel one block owns a
64-row kv tile and loops over q tiles; no atomics, so the same inputs give the
same bits on every run. Both read their operands through strides and mask the
ragged ends themselves. bf16 inputs go to tensor-core kernels (``mma.sync``
m16n8k16: the owned tile's operand fragments and the accumulators in
registers, the streamed tiles in shared memory read with ``ldmatrix``, P and
dS rounded to bf16 only for the second products; at D = 512 the owned tile
is staged in shared memory too, the warps split the score blocks and the
output columns and exchange P and dS through shared memory); f32 inputs go
to kernels that multiply with f32 FMAs from shared memory and are exact. delta =
rowsum(dO * O), which the JAX package computes with tensor code outside its
kernels, is a prologue of the dQ kernel here: it writes the (B*H, Sq) f32 sums
that the dK/dV kernel, launched after it on the same stream, reads.

Under autograd ``flash_attention`` pairs the forward kernel (which saves q, k,
v, out and the log-sum-exp) with the two backward kernels in one
``torch.autograd.Function``; on CPU tensors the same Function computes both
directions with the plain versions.
"""

from __future__ import annotations

import ctypes
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

launches = LaunchCounter("flash_attention_fwd")
dq_launches = LaunchCounter("flash_attention_bwd_dq")
dkv_launches = LaunchCounter("flash_attention_bwd_dkv")


def flash_attention_plain(q, k, v, scale: float | None = None, return_lse: bool = False):
    """softmax(q k^T * scale) v by explicit matmul -> softmax(f32) -> matmul.

    q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D) in q's dtype, and
    with ``return_lse`` the f32 log-sum-exp (B*H, Sq, 1). The same function
    as the kernel, used for CPU tensors, by the tests, and as the comparison
    on the card."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qh = q.permute(0, 2, 1, 3).float()
    kh = k.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.matmul(torch.exp(s - lse), vh).permute(0, 2, 1, 3).to(q.dtype)
    if return_lse:
        return out, lse.reshape(b * h, sq, 1)
    return out


def supports(head_dim: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes this head dim and dtype."""
    return head_dim in SUPPORTED_HEAD_DIMS and dtype in _DTYPE_CODE


def _library():
    fn = load_kernel_library("flash_attention_fwd").flash_attention_fwd
    if not fn.argtypes:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i] + [ll] * 9 + [ctypes.c_float, vp]
        fn.restype = ctypes.c_int
    return fn


def _kernel_operand(x):
    """The kernel reads 16-byte vectors along a contiguous D axis."""
    vec = 16 // x.element_size()
    ok = (
        x.stride(3) == 1
        and x.data_ptr() % 16 == 0
        and all(x.stride(i) % vec == 0 for i in range(3))
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


def _bwd_library():
    lib = load_kernel_library("flash_attention_bwd")
    dq, dkv = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
    if not dq.argtypes:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        dq.argtypes = [vp] * 8 + [i] * 6 + [strides, f, vp]
        dq.restype = ctypes.c_int
        dkv.argtypes = [vp] * 8 + [i] * 6 + [strides, f, vp]
        dkv.restype = ctypes.c_int
    return dq, dkv


def flash_attention_bwd(q, k, v, out, lse, dout, scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent ``dout``, from
    the forward's output (B, Sq, H, D) and f32 log-sum-exp (B*H, Sq, 1).

    On CUDA tensors this launches the dQ kernel, then the dK/dV kernel, or
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


def _launch_dkv(q, k, v, lse, delta, dout, scale):
    """The dK/dV kernel on checked operands and the dQ kernel's delta."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dk = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
    launch_kernel(
        _bwd_library()[1], "flash_attention_bwd_dkv", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, sq, skv, d, _strides(q, k, v, dout), float(scale),
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
