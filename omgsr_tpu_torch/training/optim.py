"""Optimizers & LR schedules matching the reference's training recipe.

AdamW(lr 5e-5, betas (0.9, 0.999), weight decay 1e-4, eps 1e-8) with
clip-by-global-norm 1.0 and a constant-with-warmup schedule (500 steps),
grad accumulation 4 (configs/omgsr_s_512.yml:25-42,
train/train_omgsr_s.py:294-343, :469-475). Two independent optimizers:
generator (LoRA params) and discriminator heads.

``Optimizer`` reproduces the JAX package's optax chain, in its order and
with its arithmetic: micro-step gradients are averaged over
``gradient_accumulation_steps`` calls and nothing is applied until the last
of them (optax.MultiSteps); then the averaged gradient is clipped by its
global norm, goes through Adam's bias-corrected moments, gains
``weight_decay * parameter``, and is scaled by ``-lr(count)`` where count is
the number of updates applied before this one, so a warm-up schedule starts
at lr = 0 (optax.adamw). State and parameters are nested dicts of tensors,
the moments in the parameters' dtype; ``update`` changes them in place and
never touches the autograd graph.
"""

from __future__ import annotations

import math

import torch

from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict


def _linear(init, end, steps, count):
    frac = 1.0 - min(count, steps) / steps
    return (init - end) * frac + end


def lr_schedule(cfg: TrainConfig):
    """count -> learning rate; the schedules of the JAX package's optim.py."""
    lr, warm = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_scheduler == "constant":
        if warm > 0:
            return lambda count: _linear(0.0, lr, warm, count)
        return lambda count: lr
    if cfg.lr_scheduler == "cosine":
        decay_steps = cfg.max_train_steps or 10000

        def cosine(count):
            if count < warm:
                return _linear(0.0, lr, warm, count)
            frac = min(count - warm, decay_steps - warm) / (decay_steps - warm)
            return lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return cosine
    if cfg.lr_scheduler == "linear":
        total = cfg.max_train_steps or 10000

        def linear(count):
            if count < warm:
                return _linear(0.0, lr, warm, count)
            return _linear(lr, 0.0, total - warm, count - warm)

        return linear
    raise ValueError(f"unsupported lr_scheduler: {cfg.lr_scheduler}")


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in f32 (one fused launch
    over all leaves, then the norm of the per-leaf norms)."""
    leaves = list(flatten_dict(tree).values())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(leaves, 2, dtype=torch.float32)))


class Optimizer:
    """clip-by-global-norm -> AdamW, inside gradient accumulation.

    A LoRA tree has hundreds of small leaves, so every step of the update is
    one multi-tensor (``torch._foreach_*``) call over all of them rather
    than a loop of per-leaf launches."""

    def __init__(self, cfg: TrainConfig, accumulate: bool = True):
        self.cfg = cfg
        self.schedule = lr_schedule(cfg)
        self.every = cfg.gradient_accumulation_steps if accumulate else 1
        self.every = max(int(self.every), 1)

    def init(self, params):
        """Fresh state for a parameter tree: update count, micro-step count,
        the accumulated gradient and Adam's two moments."""
        def zeros():
            return unflatten_dict({p: torch.zeros_like(v) for p, v in flatten_dict(params).items()})

        state = {"count": 0, "mini_step": 0, "mu": zeros(), "nu": zeros()}
        if self.every > 1:
            state["acc_grads"] = zeros()
        return state

    @torch.no_grad()
    def update(self, grads, state, params) -> bool:
        """One micro-step: fold ``grads`` into the running mean; on the
        ``every``-th call apply the update to ``params`` in place. Returns
        whether parameters changed."""
        cfg = self.cfg
        flat_p = flatten_dict(params)
        paths = list(flat_p)
        p = [flat_p[path] for path in paths]

        def leaves(tree):
            flat = flatten_dict(tree)
            return [flat[path] for path in paths]

        g = [x if x.dtype == q.dtype else x.to(q.dtype) for x, q in zip(leaves(grads), p)]
        acc = None
        if self.every > 1:
            acc = leaves(state["acc_grads"])
            k = state["mini_step"]
            diff = torch._foreach_sub(g, acc)  # optax MultiSteps' running mean
            torch._foreach_div_(diff, k + 1)
            torch._foreach_add_(acc, diff)
            state["mini_step"] = k + 1
            if state["mini_step"] < self.every:
                return False
            state["mini_step"] = 0
            g = acc
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g, 2, dtype=torch.float32)))
        # optax.clip_by_global_norm: unchanged below max_grad_norm, else g / norm * max_grad_norm
        factor = torch.where(norm < cfg.max_grad_norm, torch.ones_like(norm), cfg.max_grad_norm / norm)
        g = torch._foreach_mul(g, factor.to(p[0].dtype))
        count = state["count"]
        lr = self.schedule(count)
        c1 = 1.0 - cfg.adam_beta1 ** (count + 1)
        c2 = 1.0 - cfg.adam_beta2 ** (count + 1)
        mu, nu = leaves(state["mu"]), leaves(state["nu"])
        torch._foreach_mul_(mu, cfg.adam_beta1)
        torch._foreach_add_(mu, g, alpha=1.0 - cfg.adam_beta1)
        torch._foreach_mul_(nu, cfg.adam_beta2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - cfg.adam_beta2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.adam_epsilon)
        step = torch._foreach_div(mu, c1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(step, p, alpha=cfg.adam_weight_decay)  # decay on the parameter
        torch._foreach_add_(p, step, alpha=-lr)
        state["count"] = count + 1
        if acc is not None:
            torch._foreach_zero_(acc)
        return True


def make_optimizer(cfg: TrainConfig, accumulate: bool = True) -> Optimizer:
    return Optimizer(cfg, accumulate)
