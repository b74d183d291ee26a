"""DINOv3 SSL objectives (DINO cls-token, iBOT patch, KoLeo, Gram) as pure
functions over tensors.

The port of ``omgsr_tpu/losses/ssl.py``, which re-owns the vendored loss
library (dinov3/loss/{dino_clstoken_loss,ibot_patch_loss,koleo_loss,
gram_loss}.py). Every loss returns a value and never mutates a buffer: the
centering EMA returns the new center. Every reduction runs in f32, whatever
the logits' dtype.

The JAX functions take a mesh ``axis_name`` whose psums make the batch
statistics global under a sharded batch. Here that argument is ``group``, a
process group, and it must be None: the data-parallel SSL step (Sinkhorn
sums, centers and loss means over "data") is ROADMAP Queue 1 item 3.2b.
"""

from __future__ import annotations

import torch


def _psum(x, group):
    if group is not None:
        raise NotImplementedError(
            "the SSL losses over a process group (sums over 'data') are ROADMAP Queue 1 item 3.2b; "
            "pass group=None")
    return x


def _l2_normalize(x, eps=1e-8):
    # torch F.normalize: x / max(||x||, eps)
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


# ---------------------------------------------------------------------------
# DINO cls-token loss (dino_clstoken_loss.py:16-126)
# ---------------------------------------------------------------------------


def dino_softmax_center_teacher(teacher_logits, center, teacher_temp):
    """Centered and sharpened teacher distribution (:36-40). teacher_logits
    (..., K), center (1, K) or (K,)."""
    return torch.softmax((teacher_logits - center.reshape(1, -1)) / teacher_temp, dim=-1)


def dino_update_center(center, teacher_logits, momentum=0.9, group=None):
    """EMA center update (:104-126): returns the new center (1, K).
    teacher_logits (B, K)."""
    batch_sum = _psum(torch.sum(teacher_logits, dim=0, keepdim=True), group)
    count = _psum(float(teacher_logits.shape[0]), group)
    return center * momentum + (batch_sum / count) * (1.0 - momentum)


def sinkhorn_knopp(teacher_logits, teacher_temp, n_iterations: int = 3, group=None, total_samples=None,
                   sample_mask=None):
    """Sinkhorn-Knopp teacher assignment (:42-71): rows (prototypes) to
    uniform 1/K mass, columns (samples) to uniform 1/B. teacher_logits (B, K);
    ``total_samples`` overrides the sample count. Returns (B, K) assignments
    summing to 1 per sample.

    ``sample_mask`` (B,) bool is the static-shape form of the reference's
    masked-patch gather: excluded samples carry zero mass through every
    normalisation and come back as zero rows, the others equal to running
    on the gathered subset. ``exp`` without max-subtraction, in f32, as
    written upstream."""
    q = torch.exp(teacher_logits.float() / teacher_temp).t()  # (K, B)
    k = q.shape[0]
    if sample_mask is not None:
        q = q * sample_mask[None].to(q.dtype)
    if total_samples is None:
        count = (sample_mask.float().sum() if sample_mask is not None
                 else torch.tensor(float(q.shape[1]), device=q.device))
        total_samples = _psum(count, group)
    b = torch.as_tensor(total_samples, dtype=torch.float32, device=q.device)
    q = q / _psum(torch.sum(q), group)
    for _ in range(n_iterations):
        rows = _psum(torch.sum(q, dim=1, keepdim=True), group)
        q = q / rows / k
        cols = torch.sum(q, dim=0, keepdim=True)
        # excluded columns are exactly zero: they stay zero instead of 0/0
        q = torch.where(cols > 0, q / torch.where(cols > 0, cols, torch.ones_like(cols)) / b,
                        torch.zeros_like(q))
    return (q * b).t()


def dino_loss(student_logits, teacher_probs, student_temp=0.1, ignore_diagonal=False):
    """Cross-entropy between teacher probabilities and the student's
    log-softmax (:73-101). student_logits (S, B, K), S student crops;
    teacher_probs (T, B, K). ``ignore_diagonal`` skips the s == t pairs."""
    s_crops, b, _ = student_logits.shape
    t_crops = teacher_probs.shape[0]
    logp = torch.log_softmax(student_logits.float() / student_temp, dim=-1)
    per_pair = -torch.einsum("sbk,tbk->st", logp, teacher_probs.float())
    if not ignore_diagonal:
        return torch.sum(per_pair) / (b * s_crops * t_crops)
    m = min(s_crops, t_crops)
    per_pair = per_pair - per_pair * torch.eye(s_crops, t_crops, dtype=per_pair.dtype, device=per_pair.device)
    return torch.sum(per_pair) / (b * s_crops * t_crops - b * m)


# ---------------------------------------------------------------------------
# iBOT patch loss (ibot_patch_loss.py:62-146)
# ---------------------------------------------------------------------------


def ibot_softmax_center_teacher(teacher_patch_logits, center, teacher_temp):
    """(:78-82). teacher_patch_logits (B, N, K), center broadcastable (K,)."""
    return torch.softmax((teacher_patch_logits - center.reshape(1, 1, -1)) / teacher_temp, dim=-1)


def ibot_update_center(center, teacher_patch_logits, momentum=0.9, group=None):
    """EMA over the per-image patch mean (:124-146)."""
    batch_sum = torch.sum(torch.mean(teacher_patch_logits, dim=1), dim=0, keepdim=True)
    count = float(teacher_patch_logits.shape[0])
    return center * momentum + (_psum(batch_sum, group) / _psum(count, group)) * (1.0 - momentum)


def ibot_patch_loss(student_patch_logits, teacher_probs, student_masks, student_temp=0.1):
    """Masked-patch cross-entropy (:84-96): per image, the mean CE over its
    masked patches, then the mean over images. student_patch_logits /
    teacher_probs (B, N, K); student_masks (B, N) bool."""
    logp = torch.log_softmax(student_patch_logits.float() / student_temp, dim=-1)
    ce = torch.sum(teacher_probs.float() * logp, dim=-1)  # (B, N)
    w = student_masks.float()
    per_image = torch.sum(ce * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return -torch.mean(per_image)


# ---------------------------------------------------------------------------
# KoLeo (koleo_loss.py:14-44)
# ---------------------------------------------------------------------------


def koleo_loss(student_output, eps=1e-8):
    """Kozachenko-Leonenko differential-entropy regulariser: -mean log of the
    distance to each sample's nearest neighbour (:33-44). L2-normalises,
    finds the neighbour by the largest inner product (diagonal excluded) and
    keeps torch PairwiseDistance's ||x - y + eps||."""
    x = _l2_normalize(student_output.float(), eps)
    dots = x @ x.t()
    n = x.shape[0]
    dots = torch.where(torch.eye(n, dtype=torch.bool, device=x.device), torch.full_like(dots, -1.0), dots)
    idx = torch.argmax(dots, dim=1)
    distances = torch.linalg.vector_norm(x - x[idx] + eps, dim=-1)
    return -torch.mean(torch.log(distances + eps))


# ---------------------------------------------------------------------------
# Gram loss (gram_loss.py:11-86)
# ---------------------------------------------------------------------------


def _gram_pair(s, t, remove_neg, remove_only_teacher_neg):
    t_sim = t @ t.transpose(-1, -2)
    s_sim = s @ s.transpose(-1, -2)
    if remove_neg:
        t_sim = torch.clamp(t_sim, min=0.0)
        s_sim = torch.clamp(s_sim, min=0.0)
    elif remove_only_teacher_neg:
        # upstream's branch order: the teacher mask first, so the student condition never fires
        t_sim = torch.clamp(t_sim, min=0.0)
        s_sim = torch.where((s_sim < 0) & (t_sim < 0), torch.zeros_like(s_sim), s_sim)
    return s_sim, t_sim


def gram_loss(output_feats, target_feats, apply_norm: bool = True, img_level: bool = True, remove_neg: bool = True,
              remove_only_teacher_neg: bool = False):
    """MSE between the student's and the teacher's feature Gram (similarity)
    matrices (:34-86). ``img_level`` computes per-image (B, N, N)
    similarities; False flattens to one (B*N, B*N) matrix. ``remove_neg``
    zeroes negative similarities on both sides."""
    assert not (remove_neg and remove_only_teacher_neg)
    s, t = output_feats.float(), target_feats.float()
    if apply_norm:
        s, t = _l2_normalize(s), _l2_normalize(t)
    if not img_level:
        if s.dim() == 3:
            s = s.reshape(-1, s.shape[-1])
        if t.dim() == 3:
            t = t.reshape(-1, t.shape[-1])
    s_sim, t_sim = _gram_pair(s, t, remove_neg, remove_only_teacher_neg)
    return torch.mean((s_sim - t_sim) ** 2)


def masked_gram_loss(output_feats, target_feats, mask, apply_norm: bool = True, remove_neg: bool = True,
                     remove_only_teacher_neg: bool = False):
    """``gram_loss`` over the rows that ``mask`` selects: the static-shape
    form of the reference's ``patches[masks]`` gather (ssl_meta_arch.py
    :509-512). The full pairwise error weighted by w_i * w_j and
    renormalised equals the loss on the gathered subset. output/target
    (B, N, D) or (M, D); mask matches the leading dims."""
    assert not (remove_neg and remove_only_teacher_neg)
    s = output_feats.float().reshape(-1, output_feats.shape[-1])
    t = target_feats.float().reshape(-1, target_feats.shape[-1])
    w = mask.float().reshape(-1)
    if apply_norm:
        s, t = _l2_normalize(s), _l2_normalize(t)
    s_sim, t_sim = _gram_pair(s, t, remove_neg, remove_only_teacher_neg)
    pair_w = w[:, None] * w[None, :]
    denom = torch.clamp(torch.sum(pair_w), min=1.0)
    return torch.sum(pair_w * (s_sim - t_sim) ** 2) / denom
