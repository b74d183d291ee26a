"""DINOv3 SSL meta-architecture: the pretraining step as one function.

The port of ``omgsr_tpu/training/ssl_meta_arch.py`` (dinov3/train/
ssl_meta_arch.py: forward_backward :349-424, get_teacher_output :426-468,
get_student_output :524-576, compute_losses :578-678):

- One step: the teacher's forward under ``torch.no_grad``, the student's
  forward (global crops with the iBOT masks, local crops), both heads, the
  four objectives, the gradients by ``torch.autograd.grad`` over the
  student's leaves, ``training/ssl.SSLOptimizer``, the EMA teacher and the
  center EMA.
- Static shapes, as in the JAX package: the iBOT head runs on every patch
  token and the masked Sinkhorn / masked CE take the (B, N) mask, where the
  reference gathers the masked patches.
- State is threaded: (student, teacher, opt_state, centers) in, the same
  out. The tensors are updated in place and returned.
- One process: every batch statistic is over this process's batch. The
  data-parallel step (sums over "data", KoLeo over the global batch, the
  gradient mean) is ROADMAP Queue 1 item 3.2b.

Defaults mirror dinov3/configs/ssl_default_config.yaml.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from omgsr_tpu_torch.losses.ssl import (
    dino_loss,
    dino_softmax_center_teacher,
    dino_update_center,
    gram_loss,
    ibot_patch_loss,
    ibot_softmax_center_teacher,
    ibot_update_center,
    koleo_loss,
    masked_gram_loss,
    sinkhorn_knopp,
)
from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply
from omgsr_tpu_torch.training.ssl import dino_head_apply, ema_update, init_dino_head
from omgsr_tpu_torch.utils.devices import resolve_device
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict


@dataclasses.dataclass(frozen=True)
class SSLMetaConfig:
    """Loss and head knobs (ssl_default_config.yaml dino / ibot / gram / teacher)."""

    n_global_crops: int = 2
    n_local_crops: int = 8
    dino_out_dim: int = 65536
    dino_hidden_dim: int = 2048
    dino_bottleneck_dim: int = 256
    dino_nlayers: int = 3
    ibot_separate_head: bool = True
    ibot_out_dim: int = 65536
    ibot_hidden_dim: int = 2048
    ibot_bottleneck_dim: int = 256
    ibot_nlayers: int = 3
    dino_loss_weight: float = 1.0
    koleo_loss_weight: float = 0.1
    ibot_loss_weight: float = 1.0
    dino_global_ignore_diagonal: bool = True
    student_temp: float = 0.1
    # the vendored meta-arch asserts "sinkhorn_knopp"; "softmax" is kept for DINOv2-style runs
    centering: str = "sinkhorn_knopp"
    center_momentum: float = 0.9
    sinkhorn_iterations: int = 3
    gram_loss_weight: float = 0.0
    gram_img_level: bool = False
    gram_remove_neg: bool = False
    gram_tokens_used: str = "all"  # all | masked | unmasked
    gram_ema_teacher: bool = False


def init_ssl_student(seed, vit_cfg, cfg: SSLMetaConfig, init_backbone, dtype=torch.float32, device="cuda"):
    """The student tree {backbone, dino_head[, ibot_head]}: the backbone from
    ``init_backbone(seed, vit_cfg, dtype, device)`` (e.g.
    ``convert.params.init_dinov3_vit``), the heads from one CPU generator
    seeded with ``seed + 1``. The teacher starts as a copy
    (SSLMetaArch.init_weights:296-347)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed) + 1)
    params = {
        "backbone": init_backbone(seed, vit_cfg, dtype, device),
        "dino_head": init_dino_head(gen, vit_cfg.embed_dim, cfg.dino_out_dim, cfg.dino_hidden_dim,
                                    cfg.dino_bottleneck_dim, cfg.dino_nlayers, dtype=dtype, device=device),
    }
    if cfg.ibot_separate_head:
        params["ibot_head"] = init_dino_head(gen, vit_cfg.embed_dim, cfg.ibot_out_dim, cfg.ibot_hidden_dim,
                                             cfg.ibot_bottleneck_dim, cfg.ibot_nlayers, dtype=dtype, device=device)
    return params


def init_center_state(cfg: SSLMetaConfig, device="cuda"):
    """EMA centers of softmax centering; carried as zeros under Sinkhorn too,
    so the state has one structure in both modes."""
    device = resolve_device(device)
    return {
        "dino": torch.zeros((cfg.dino_out_dim,), dtype=torch.float32, device=device),
        "ibot": torch.zeros((cfg.ibot_out_dim if cfg.ibot_separate_head else cfg.dino_out_dim,),
                            dtype=torch.float32, device=device),
    }


def copy_tree(tree):
    """A copy of every tensor of a nested dict, detached."""
    if isinstance(tree, dict):
        return {k: copy_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def init_distill_ema(student):
    """The separate student EMA kept under distillation (ssl_meta_arch.py
    :131-141: with distillation.enabled a frozen pretrained teacher takes the
    teacher's slot and the EMA is its own copy of the student)."""
    return copy_tree(student)


def _ibot_head_apply(params, cfg: SSLMetaConfig, x):
    return dino_head_apply(params["ibot_head"] if cfg.ibot_separate_head else params["dino_head"], x)


def _teacher_targets(teacher, vit_cfg, cfg, crops, masks, teacher_temp, centers, group):
    """get_teacher_output (:426-468), without gradients: backbone, heads,
    centred targets. Returns (cls_probs (G*B, K), patch_probs (G*B, N, K),
    the patch tokens before the head, new_centers)."""
    with torch.no_grad():
        out = dinov3_vit_apply(teacher["backbone"], vit_cfg, crops)
        cls = out["x_norm_clstoken"]
        patch = out["x_norm_patchtokens"]
        cls_logits = dino_head_apply(teacher["dino_head"], cls)
        patch_logits = _ibot_head_apply(teacher, cfg, patch)
        new_centers = centers
        if cfg.centering == "sinkhorn_knopp":
            cls_probs = sinkhorn_knopp(cls_logits, teacher_temp, n_iterations=cfg.sinkhorn_iterations, group=group)
            flat = patch_logits.reshape(-1, patch_logits.shape[-1])
            patch_probs = sinkhorn_knopp(flat, teacher_temp, n_iterations=cfg.sinkhorn_iterations, group=group,
                                         sample_mask=masks.reshape(-1)).reshape(patch_logits.shape)
        elif cfg.centering == "softmax":
            cls_probs = dino_softmax_center_teacher(cls_logits, centers["dino"], teacher_temp)
            patch_probs = ibot_softmax_center_teacher(patch_logits, centers["ibot"], teacher_temp)
            new_centers = {
                "dino": dino_update_center(centers["dino"], cls_logits, cfg.center_momentum, group).reshape(-1),
                "ibot": ibot_update_center(centers["ibot"], patch_logits, cfg.center_momentum, group).reshape(-1),
            }
        else:
            raise ValueError(f"unknown centering {cfg.centering!r}")
    return cls_probs, patch_probs, patch, new_centers


def ssl_losses(student, teacher, batch, centers, *, cfg: SSLMetaConfig, vit_cfg, teacher_temp, local_loss_weight=1.0,
               gram_teacher_patches=None, gram_weight=None, teacher_vit_cfg=None, distillation=False, group=None):
    """forward + compute_losses (:349-678). Returns (total_loss, aux) with
    aux = {"metrics": {name: 0-dim tensor}, "centers": new centers}.

    batch: global_crops (G*B, S, S, 3), local_crops (L*B, s, s, 3), masks
    (G*B, N) bool, optional global_crops_teacher. gram_teacher_patches:
    (G*B, N, D) features of a frozen gram teacher; None with
    gram_loss_weight > 0 anchors on the EMA teacher's patch tokens.

    Distillation (:134-141, :263-294, :533): ``teacher`` is a frozen
    pretrained model, possibly larger (``teacher_vit_cfg``; same patch size
    and head widths), and the student's global forward skips the mask-token
    swap while the iBOT CE still reads the masked positions."""
    g, n_local = cfg.n_global_crops, cfg.n_local_crops
    global_crops, local_crops, masks = batch["global_crops"], batch["local_crops"], batch["masks"]
    b = global_crops.shape[0] // g
    t_vit_cfg = vit_cfg if teacher_vit_cfg is None else teacher_vit_cfg
    if t_vit_cfg.patch_size != vit_cfg.patch_size:
        raise ValueError("distillation requires matching patch sizes (:273)")
    teacher_crops = batch.get("global_crops_teacher", global_crops)
    t_cls_probs, t_patch_probs, t_patch_pre_head, new_centers = _teacher_targets(
        teacher, t_vit_cfg, cfg, teacher_crops, masks, teacher_temp, centers, group)

    # student: the global crops see the iBOT masks (get_student_output:531-537), the local crops do not;
    # under distillation the student sees clean pixels (:533)
    s_global = dinov3_vit_apply(student["backbone"], vit_cfg, global_crops, None if distillation else masks)
    s_local = dinov3_vit_apply(student["backbone"], vit_cfg, local_crops)
    s_g_cls = s_global["x_norm_clstoken"]
    s_g_patch = s_global["x_norm_patchtokens"]
    s_g_cls_logits = dino_head_apply(student["dino_head"], s_g_cls)
    s_l_cls_logits = dino_head_apply(student["dino_head"], s_local["x_norm_clstoken"])
    s_patch_logits = _ibot_head_apply(student, cfg, s_g_patch)

    # loss scales (compute_losses:589-599, the DINOv2 convention)
    g_terms = g * (g - 1) if cfg.dino_global_ignore_diagonal else g * g
    l_terms = g * n_local
    g_scale = g_terms / (g_terms + l_terms)
    l_scale = l_terms / (g_terms + l_terms)

    t_probs_crops = t_cls_probs.reshape(g, b, -1)
    dino_local = dino_loss(s_l_cls_logits.reshape(n_local, b, -1), t_probs_crops, cfg.student_temp)
    dino_global = dino_loss(s_g_cls_logits.reshape(g, b, -1), t_probs_crops, cfg.student_temp,
                            ignore_diagonal=cfg.dino_global_ignore_diagonal)
    cls_crops = s_g_cls.reshape(g, b, -1)
    koleo = sum(koleo_loss(cls_crops[i]) for i in range(g)) / g
    ibot = ibot_patch_loss(s_patch_logits, t_patch_probs, masks, cfg.student_temp)

    total = (cfg.dino_loss_weight * (l_scale * local_loss_weight * dino_local + g_scale * dino_global)
             + cfg.koleo_loss_weight * g * koleo
             + cfg.ibot_loss_weight * ibot)
    metrics = {"dino_local_crops_loss": dino_local, "dino_global_crops_loss": dino_global, "koleo_loss": koleo,
               "ibot_loss": ibot}

    if cfg.gram_loss_weight > 0.0:
        anchor = (t_patch_pre_head if gram_teacher_patches is None else gram_teacher_patches).detach()
        if cfg.gram_tokens_used == "all":
            gram = gram_loss(s_g_patch, anchor, img_level=cfg.gram_img_level, remove_neg=cfg.gram_remove_neg)
        else:
            sel = masks if cfg.gram_tokens_used == "masked" else ~masks
            gram = masked_gram_loss(s_g_patch, anchor, sel, remove_neg=cfg.gram_remove_neg)
        # the loss_weight_schedule path (ssl_meta_arch.py:186-201): a tabulated weight, else the static one
        w = cfg.gram_loss_weight if gram_weight is None else gram_weight
        total = total + w * gram
        metrics["gram_loss"] = gram

    metrics["total_loss"] = total
    return total, {"metrics": {k: v.detach() for k, v in metrics.items()}, "centers": new_centers}


# ---------------------------------------------------------------------------
# jax.image.resize, separable: the gram teacher's patch grid
# ---------------------------------------------------------------------------


def _keys_cubic(x):
    # Keys' cubic convolution kernel, a = -0.5 (jax/_src/image/scale.py _keys_cubic_kernel)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - x, min=0.0)


# the methods jax.image.resize names for these kernels; the recipes use "bicubic"
_RESIZE_KERNELS = {"cubic": _keys_cubic, "bicubic": _keys_cubic, "linear": _triangle, "bilinear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str = "bicubic", antialias: bool = True, device="cpu"):
    """(in_size, out_size) f32 weights of ``jax.image.resize`` along one axis
    (``compute_weight_mat`` of jax/_src/image/scale.py, scale out/in,
    translation 0): half-pixel sample centres, the kernel widened by 1/scale
    when downscaling with ``antialias``, columns normalised to 1, samples
    outside the input zeroed."""
    kernel = _RESIZE_KERNELS[method]
    inv_scale = float(np.float32(1.0 / (out_size / in_size)))  # a Python float, rounded where it meets f32
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    x = x / kernel_scale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_gram_teacher_patches(patches, src_hw, dst_hw, method="bicubic"):
    """A frozen gram teacher's patch grid resized to the student's
    (get_gram_teacher_output:493-508): (B, src_h*src_w, D) ->
    (B, dst_h*dst_w, D) as ``jax.image.resize(method=...)`` computes it:
    Keys' cubic with a = -0.5, antialiased when downscaling (not
    ``F.interpolate``'s a = -0.75), applied as one separable weight matrix
    per axis in f32."""
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"resize method {method!r}: one of {sorted(_RESIZE_KERNELS)}")
    bsz, n, d = patches.shape
    (sh, sw), (dh, dw) = src_hw, dst_hw
    assert n == sh * sw
    grid = patches.reshape(bsz, sh, sw, d).float()
    if sh != dh:
        grid = torch.einsum("bhwd,hy->bywd", grid, resize_weights(sh, dh, method, device=patches.device))
    if sw != dw:
        grid = torch.einsum("bywd,wx->byxd", grid, resize_weights(sw, dw, method, device=patches.device))
    return grid.reshape(bsz, dh * dw, d).to(patches.dtype)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _grads(total, student):
    """d total / d student as a tree like it, zeros for a leaf the loss does
    not reach (the mask token under distillation), as jax.grad gives them."""
    flat = flatten_dict(student)
    grads = torch.autograd.grad(total, list(flat.values()), allow_unused=True)
    return unflatten_dict({k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(flat.items(), grads)})


def _requires_grad(tree):
    for leaf in flatten_dict(tree).values():
        if not leaf.requires_grad:
            leaf.requires_grad_(True)


def make_ssl_train_step(opt, *, cfg: SSLMetaConfig, vit_cfg, group=None):
    """One SSL pretraining step: losses, the student's gradients, the
    optimizer (``training/ssl.SSLOptimizer``), the EMA teacher, the center
    EMA. The schedule scalars (lr, wd, teacher_temp, momentum,
    local_loss_weight, last_layer_lr) are the host's reads of the tabulated
    schedules (train/train.py:418-440).

    step(student, teacher, opt_state, centers, batch, *, lr, wd, teacher_temp,
    momentum, ...) -> (student, teacher, opt_state, centers, metrics)."""
    if group is not None:
        raise NotImplementedError("the data-parallel SSL step is ROADMAP Queue 1 item 3.2b; pass group=None")

    def step(student, teacher, opt_state, centers, batch, *, lr, wd, teacher_temp, momentum, local_loss_weight=1.0,
             last_layer_lr=None, gram_teacher_patches=None, gram_weight=None):
        _requires_grad(student)
        total, aux = ssl_losses(student, teacher, batch, centers, cfg=cfg, vit_cfg=vit_cfg, teacher_temp=teacher_temp,
                                local_loss_weight=local_loss_weight, gram_teacher_patches=gram_teacher_patches,
                                gram_weight=gram_weight)
        grads = _grads(total, student)
        del total
        opt.update(grads, opt_state, student, lr=lr, wd=wd, last_layer_lr=last_layer_lr)
        del grads
        ema_update(teacher, student, momentum)
        return student, teacher, opt_state, aux["centers"], aux["metrics"]

    return step


def gram_teacher_patches(gram_backbone, vit_cfg, batch, resize_method="bicubic"):
    """The frozen gram teacher's patch tokens on the gram crops (or the global
    crops), resized to the student's grid where they differ."""
    crops = batch.get("gram_teacher_crops", batch["global_crops"])
    with torch.no_grad():
        patches = dinov3_vit_apply(gram_backbone, vit_cfg, crops)["x_norm_patchtokens"]
    gc = batch["global_crops"]
    n_t = patches.shape[1]
    n_s = (gc.shape[1] // vit_cfg.patch_size) * (gc.shape[2] // vit_cfg.patch_size)
    if n_t != n_s:
        src, dst = int(round(n_t ** 0.5)), int(round(n_s ** 0.5))
        patches = resize_gram_teacher_patches(patches, (src, src), (dst, dst), method=resize_method)
    return patches


def make_gram_ssl_train_step(opt, *, cfg: SSLMetaConfig, vit_cfg, resize_method="bicubic", group=None):
    """The SSL step with a frozen gram-teacher backbone
    (get_gram_teacher_output:470-523, gram.ema_teacher=false): its patch
    tokens anchor the student's Gram matrices, the patch grid resized down
    when the gram crops are larger (:488-503). The host swaps the gram
    parameters from the EMA teacher on the reference's schedule."""
    base = make_ssl_train_step(opt, cfg=cfg, vit_cfg=vit_cfg, group=group)

    def step(student, teacher, gram_backbone, opt_state, centers, batch, **kw):
        patches = gram_teacher_patches(gram_backbone, vit_cfg, batch, resize_method)
        return base(student, teacher, opt_state, centers, batch, gram_teacher_patches=patches, **kw)

    return step


def make_distill_train_step(opt, *, cfg: SSLMetaConfig, vit_cfg, teacher_vit_cfg=None, group=None):
    """One distillation step (distillation.enabled=true): the frozen
    pretrained teacher gives the targets and never moves; the EMA tracks the
    student into ``model_ema`` (the eval artifact, ssl_meta_arch.py
    :131-141). The student's global forward skips the mask-token swap (:533).

    step(student, teacher, model_ema, opt_state, centers, batch, *, lr, wd,
    teacher_temp, momentum, ...) -> (student, model_ema, opt_state, centers,
    metrics)."""
    if group is not None:
        raise NotImplementedError("the data-parallel SSL step is ROADMAP Queue 1 item 3.2b; pass group=None")

    def step(student, teacher, model_ema, opt_state, centers, batch, *, lr, wd, teacher_temp, momentum,
             local_loss_weight=1.0, last_layer_lr=None, gram_weight=None):
        _requires_grad(student)
        total, aux = ssl_losses(student, teacher, batch, centers, cfg=cfg, vit_cfg=vit_cfg,
                                teacher_vit_cfg=teacher_vit_cfg, teacher_temp=teacher_temp,
                                local_loss_weight=local_loss_weight, gram_weight=gram_weight, distillation=True)
        grads = _grads(total, student)
        del total
        opt.update(grads, opt_state, student, lr=lr, wd=wd, last_layer_lr=last_layer_lr)
        del grads
        ema_update(model_ema, student, momentum)
        return student, model_ema, opt_state, aux["centers"], aux["metrics"]

    return step
