"""DINOv3 SSL pretraining building blocks: the projection head, schedules,
parameter groups, the SSL optimizer and the EMA teacher.

The port of ``omgsr_tpu/training/ssl.py`` (dinov3/layers/dino_head.py,
dinov3/train/cosine_lr_scheduler.py, dinov3/train/param_groups.py and the
EMA update of dinov3/train/ssl_meta_arch.py:707-720):

- The DINO / iBOT head is a pure function over a parameter dict in the torch
  state dict's layout (``mlp.0.weight`` (out, in), ..., ``last_layer.weight``
  (K, bottleneck)), so a hub checkpoint's head loads by key.
- Schedules are precomputed numpy tables indexed by iteration (the
  reference's CosineScheduler); the host reads scalars from them.
- Parameter groups are two multiplier trees (lr, weight decay) aligned with
  the parameter tree, plus the last-layer mask: the functional form of
  torch param groups (param_groups.py:56-109, the code's weight-decay
  condition, not its comment).
- ``SSLOptimizer`` reproduces the JAX package's optax chain in its order:
  clip by global norm, bias-corrected Adam (eps outside the square root),
  the per-leaf lr multiplier, then the decoupled weight decay times its
  multiplier (so decay is not scaled by the lr multiplier), then times
  -lr, or -last_layer_lr on the prototype layers. It is not
  ``torch.optim.AdamW``.
- ``ema_update`` is one multi-tensor pass in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from omgsr_tpu_torch.models.layers import dense
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.tree import flatten_dict

__all__ = [
    "init_dino_head",
    "dino_head_apply",
    "cosine_schedule",
    "linear_warmup_cosine_decay",
    "TabulatedSchedule",
    "vit_lr_decay_rate",
    "ssl_param_groups",
    "last_layer_mask",
    "SSLOptimizer",
    "ema_update",
]


# ---------------------------------------------------------------------------
# DINO head (dino_head.py:11-68)
# ---------------------------------------------------------------------------


def _init_head_dense(gen, in_dim, out_dim, bias, dtype, device):
    # torch trunc_normal_(std=0.02) truncates at +-2 std; drawn in f32 on the CPU generator, then cast
    w = torch.empty((out_dim, in_dim), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=gen)
    p = {"weight": w.to(device=device, dtype=dtype)}
    if bias:
        p["bias"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def init_dino_head(seed, in_dim: int, out_dim: int, hidden_dim: int = 2048, bottleneck_dim: int = 256,
                   nlayers: int = 3, mlp_bias: bool = True, dtype=torch.float32, device="cuda"):
    """An MLP, L2 normalisation, then the prototype layer (dino_head.py:11-50).

    Key paths mirror the torch Sequential's state dict: for nlayers >= 2 the
    MLP lives at mlp.{0, 2, 4, ...} (the GELUs take the odd slots); for
    nlayers == 1 ``mlp`` is the single dense. ``last_layer`` has no bias (the
    K prototypes). trunc_normal(0.02) weights, zero biases (:34-41), drawn
    from ``seed`` (an integer or a CPU torch.Generator, which is advanced)."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    nlayers = max(nlayers, 1)
    if nlayers == 1:
        mlp = _init_head_dense(gen, in_dim, bottleneck_dim, mlp_bias, dtype, device)
    else:
        mlp = {"0": _init_head_dense(gen, in_dim, hidden_dim, mlp_bias, dtype, device)}
        for i in range(nlayers - 2):
            mlp[str(2 * (i + 1))] = _init_head_dense(gen, hidden_dim, hidden_dim, mlp_bias, dtype, device)
        mlp[str(2 * (nlayers - 1))] = _init_head_dense(gen, hidden_dim, bottleneck_dim, mlp_bias, dtype, device)
    return {"mlp": mlp, "last_layer": _init_head_dense(gen, bottleneck_dim, out_dim, False, dtype, device)}


def dino_head_apply(params, x, no_last_layer: bool = False, only_last_layer: bool = False):
    """(..., in_dim) -> (..., out_dim) logits (dino_head.py:43-50), in x's
    dtype; each weight is cast to it at the call."""
    if not only_last_layer:
        mlp = params["mlp"]
        if "weight" in mlp:  # nlayers == 1
            x = dense(mlp, x)
        else:
            for i, idx in enumerate(sorted(mlp, key=int)):
                if i > 0:
                    x = F.gelu(x, approximate="none")
                x = dense(mlp[idx], x)
        eps = 1e-6 if x.dtype == torch.float16 else 1e-12
        x32 = x.float()
        x = (x32 / torch.clamp(torch.linalg.vector_norm(x32, dim=-1, keepdim=True), min=eps)).to(x.dtype)
    if not no_last_layer:
        x = dense(params["last_layer"], x)
    return x


# ---------------------------------------------------------------------------
# Schedules (cosine_lr_scheduler.py:13-90)
# ---------------------------------------------------------------------------


def cosine_schedule(base_value: float, final_value: float, total_iters: int, warmup_iters: int = 0,
                    start_warmup_value: float = 0.0, freeze_iters: int = 0, trunc_extra: float = 0.0) -> np.ndarray:
    """The reference CosineScheduler's precomputed table (:24-46):
    [freeze zeros | linear warmup | (possibly truncated) cosine]."""
    freeze = np.zeros((freeze_iters,))
    warmup = np.linspace(start_warmup_value, base_value, warmup_iters)
    cosine_steps = total_iters - warmup_iters - freeze_iters
    if trunc_extra == 0.0:
        iters = np.arange(cosine_steps)
        sched = final_value + 0.5 * (base_value - final_value) * (1 + np.cos(np.pi * iters / len(iters)))
    else:
        iters = np.linspace(0, np.pi, int((1 + trunc_extra) * cosine_steps))[:cosine_steps]
        sched = (np.cos(iters) + 1) / 2
        sched = (sched - sched[-1]) / (1 - sched[-1])
        sched = sched * (base_value - final_value) + final_value
    out = np.concatenate((freeze, warmup, sched), dtype=np.float64)
    assert len(out) == total_iters
    return out


def linear_warmup_cosine_decay(start: float, peak: float, end: float, warmup_iterations: int, total_iterations: int,
                               cosine_iterations: int | None = None) -> np.ndarray:
    """Linear warmup, cosine, constant tail (:54-90)."""
    linear = np.linspace(start, peak, warmup_iterations, endpoint=False)
    if cosine_iterations is None:
        cosine_iterations = total_iterations - warmup_iterations
    cos = (np.cos(np.linspace(0, np.pi, cosine_iterations)) + 1) / 2
    cos = (peak - end) * cos + end
    remaining = total_iterations - cosine_iterations - warmup_iterations
    assert remaining >= 0
    return np.concatenate([linear, cos, np.full((remaining,), end)])


class TabulatedSchedule:
    """__getitem__ of the reference CosineScheduler (:47-51): past the end of
    the table, ``final_value``."""

    def __init__(self, table: np.ndarray, final_value: float | None = None):
        self.table = np.asarray(table, np.float64)
        self.final_value = float(table[-1]) if final_value is None else float(final_value)

    def __len__(self):
        return len(self.table)

    def __getitem__(self, it: int) -> float:
        return self.final_value if it >= len(self.table) else float(self.table[it])


# ---------------------------------------------------------------------------
# Param groups (param_groups.py:12-109) as multiplier trees
# ---------------------------------------------------------------------------

_LAYER0_MARKERS = ("pos_embed", "patch_embed", "mask_token", "cls_token", "storage_tokens")


def vit_lr_decay_rate(path: str, lr_decay_rate: float, num_layers: int) -> float:
    """Layer-wise lr decay of one parameter path (param_groups.py:12-53, the
    force_is_backbone branch): embeddings and tokens take layer 0, blocks.N
    takes N + 1, everything else (final norm, heads) num_layers + 1."""
    layer_id = num_layers + 1
    if any(m in path for m in _LAYER0_MARKERS):
        layer_id = 0
    elif "blocks." in path and "residual." not in path:
        layer_id = int(path[path.find("blocks."):].split(".")[1]) + 1
    return lr_decay_rate ** (num_layers + 1 - layer_id)


def ssl_param_groups(params, lr_decay_rate: float = 1.0, num_layers: int = 12, patch_embed_lr_mult: float = 1.0,
                     dino_head_wd_multiplier: float = 1.0):
    """(lr_mult_tree, wd_mult_tree) of floats aligned with ``params``.

    get_params_groups_with_decay (param_groups.py:56-109): no weight decay on
    paths that end in "bias" or contain "norm" / "gamma" (biases, LayerNorm
    weights through the module path, LayerScale). The RoPE periods (torch
    buffers, absent from named_parameters upstream) take lr and weight decay
    0."""

    def walk(node, path):
        if isinstance(node, dict):
            lr, wd = {}, {}
            for k, v in node.items():
                lr[k], wd[k] = walk(v, f"{path}.{k}" if path else k)
            return lr, wd
        if "rope_embed" in path:
            return 0.0, 0.0
        lr_mult = vit_lr_decay_rate(path, lr_decay_rate, num_layers)
        if "patch_embed" in path:
            lr_mult *= patch_embed_lr_mult
        wd_mult = dino_head_wd_multiplier if "dino_head" in path else 1.0
        if path.endswith("bias") or "norm" in path or "gamma" in path:
            wd_mult = 0.0
        return lr_mult, wd_mult

    return walk(params, "")


def last_layer_mask(params):
    """Bool tree marking the DINO / iBOT prototype layers: the reference's
    ``is_last_layer`` group (param_groups.py:93-100), driven by the
    last_layer_lr schedule (zero for the first freeze_last_layer_epochs)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        return "last_layer" in path

    return walk(params, "")


# ---------------------------------------------------------------------------
# The SSL optimizer: the JAX package's optax chain (training/ssl.py make_ssl_optimizer)
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    """A scalar rounded to f32, as the JAX chain holds its hyperparameters."""
    return float(np.float32(x))


class SSLOptimizer:
    """clip_by_global_norm -> scale_by_adam -> x lr multiplier -> + wd * wd
    multiplier * p -> x (-lr or -last_layer_lr), in that order, as
    ``make_ssl_optimizer`` chains them in optax.

    Built from the multiplier trees of ``ssl_param_groups`` and the tree of
    ``last_layer_mask``. The state is {"count", "mu", "nu"}, the moments in
    the parameters' dtype; ``update`` changes the state and the parameters
    in place, one multi-tensor launch per stage over every leaf, outside
    the autograd graph. lr, wd and last_layer_lr are the step's
    hyperparameters (f32 scalars, as optax's injected ones)."""

    def __init__(self, lr_mult_tree, wd_mult_tree, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 clip_norm: float = 3.0, last_layer_mask_tree=None):
        self.lr_mult = flatten_dict(lr_mult_tree)
        self.wd_mult = flatten_dict(wd_mult_tree)
        self.last_layer = (flatten_dict(last_layer_mask_tree) if last_layer_mask_tree is not None
                           else {k: False for k in self.lr_mult})
        self.paths = list(self.lr_mult)
        self.b1, self.b2, self.eps, self.clip_norm = b1, b2, eps, clip_norm

    def init(self, params):
        flat = flatten_dict(params)
        if set(flat) != set(self.paths):
            raise ValueError("the parameter tree differs from the multiplier trees")

        def zeros():
            out = {}
            for path in self.paths:
                node = out
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = torch.zeros_like(flat[path])
            return out

        return {"count": 0, "mu": zeros(), "nu": zeros()}

    def _leaves(self, tree):
        flat = flatten_dict(tree)
        return [flat[p] for p in self.paths]

    @torch.no_grad()
    def update(self, grads, state, params, *, lr: float, wd: float, last_layer_lr: float | None = None):
        """One step: ``params`` and ``state`` change in place; ``grads`` is a
        tree like ``params``."""
        p = self._leaves(params)
        g = self._leaves(grads)
        g = [x if x.dtype == q.dtype else x.to(q.dtype) for x, q in zip(g, p)]
        # optax.clip_by_global_norm: unchanged below the limit, else g / norm * limit
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g, 2)).float())
        under = norm < self.clip_norm
        g = torch._foreach_div(g, torch.where(under, torch.ones_like(norm), norm).to(p[0].dtype))
        torch._foreach_mul_(g, torch.where(under, torch.ones_like(norm), torch.full_like(norm, self.clip_norm))
                            .to(p[0].dtype))
        # optax.scale_by_adam: moments, then bias corrections with f32 decay ** count
        count = state["count"] + 1
        mu, nu = self._leaves(state["mu"]), self._leaves(state["nu"])
        torch._foreach_mul_(mu, _f32(self.b1))
        torch._foreach_add_(mu, g, alpha=_f32(1.0 - self.b1))
        torch._foreach_mul_(nu, _f32(self.b2))
        torch._foreach_addcmul_(nu, g, g, value=_f32(1.0 - self.b2))
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(count))
        u = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        del den
        # x the lr multiplier, then + wd * multiplier * p (decay is not scaled by the lr multiplier)
        torch._foreach_mul_(u, [self.lr_mult[path] for path in self.paths])
        decay = torch._foreach_mul(p, [_f32(np.float32(wd) * np.float32(self.wd_mult[path])) for path in self.paths])
        torch._foreach_add_(u, decay)
        del decay
        ll = lr if last_layer_lr is None else last_layer_lr
        torch._foreach_mul_(u, [-_f32(ll) if self.last_layer[path] else -_f32(lr) for path in self.paths])
        torch._foreach_add_(p, u)
        state["count"] = count
        return params, state


# ---------------------------------------------------------------------------
# EMA teacher (ssl_meta_arch.py:707-720)
# ---------------------------------------------------------------------------


@torch.no_grad()
def ema_update(teacher_params, student_params, momentum):
    """teacher <- m * teacher + (1 - m) * student in f32, in place (the
    reference's torch._foreach_mul_ / add_ pass); momentum from the schedule
    table. Returns the teacher tree."""
    m = np.float32(momentum)
    one_minus = float(np.float32(1.0) - m)
    flat_t = flatten_dict(teacher_params)
    flat_s = flatten_dict(student_params)
    t = [flat_t[k] for k in flat_t]
    s = [flat_s[k] for k in flat_t]
    if all(x.dtype == torch.float32 for x in t + s):
        torch._foreach_mul_(t, float(m))
        torch._foreach_add_(t, s, alpha=one_minus)
    else:
        for a, b in zip(t, s):
            a.copy_((float(m) * a.float() + one_minus * b.float()).to(a.dtype))
    return teacher_params
