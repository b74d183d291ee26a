"""Flash-attention forward: hand-written CUDA kernel, its wrapper and its
plain PyTorch version. (B, S, H, D) layout, as in the JAX package.

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
kernel that multiplies with f32 FMAs and is exact. Neither uses ``wgmma`` or
TMA yet; PERF.md holds their times beside the bound.

No backward yet: the wrapper refuses inputs that require grad on CUDA.
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

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

launches = LaunchCounter("flash_attention_fwd")


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


def flash_attention(q, k, v, scale: float | None = None, return_lse: bool = False):
    """q (B, Sq, H, D), k/v (B, Skv, H, D) -> (B, Sq, H, D) [, lse (B*H, Sq, 1)].

    On a CUDA tensor this launches the kernel or raises; the plain version
    runs only for CPU tensors."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected (B,S,H,D) tensors, got {q.shape}, {k.shape}, {v.shape}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} disagree")
    if not q.is_cuda or plain_route_active():
        return flash_attention_plain(q, k, v, scale, return_lse)
    if not (k.is_cuda and v.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on the same CUDA device")
    if not (q.dtype == k.dtype == v.dtype) or not supports(d, q.dtype):
        raise NotImplementedError(
            f"flash_attention kernel takes bf16/f32 at head dim {SUPPORTED_HEAD_DIMS}, "
            f"got {q.dtype}, {k.dtype}, {v.dtype} at head dim {d}"
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention has no backward kernel yet")
    skv = k.shape[1]
    if min(b, sq, h, skv) < 1:
        raise ValueError(f"empty attention operand: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if b * h > 65535:
        raise NotImplementedError(f"batch*heads = {b * h} exceeds the kernel's grid")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q, k, v = _kernel_operand(q), _kernel_operand(k), _kernel_operand(v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    launch_kernel(
        _library(), "flash_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPE_CODE[q.dtype], b, h, sq, skv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale),
    )
    launches.add()
    if return_lse:
        return out, lse
    return out
