"""The DINOv3 SSL objectives of the port (omgsr_tpu_torch/losses/ssl.py)
against the JAX package's (omgsr_tpu/losses/ssl.py) on the same numpy
inputs, in f32 on the CPU: every loss in each of its modes, held to 1e-5 of
the largest |JAX| value. Each JAX reference is one jit at optimisation
level 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.losses import ssl as JL
from omgsr_tpu_torch.losses import ssl as TL
from tests.torch_port_helpers import jax_once, t

TOL = 1e-5
B, K, N, D = 6, 32, 10, 16


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(port, ref):
    a = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


_MASK = np.random.default_rng(9).random(B * N) < 0.4
_MASK_BN = _MASK.reshape(B, N)


def _cases():
    """name -> (JAX function of the numpy inputs, port function of the tensors, inputs)."""
    s_logits, t_probs = _rand(4, B, K, seed=1), np.asarray(jax.nn.softmax(_rand(2, B, K, seed=2), -1))
    cls_logits, patch_logits = _rand(B, K, seed=3, scale=0.3), _rand(B, N, K, seed=4, scale=0.3)
    center, feats_s, feats_t = _rand(K, seed=5), _rand(B, N, D, seed=6), _rand(B, N, D, seed=7)
    cases = {}
    for diag in (False, True):
        cases[f"dino_loss-diag{int(diag)}"] = (
            lambda s, tp, d=diag: JL.dino_loss(s, tp, 0.1, ignore_diagonal=d),
            lambda s, tp, d=diag: TL.dino_loss(s, tp, 0.1, ignore_diagonal=d), (s_logits, t_probs))
    cases["dino_loss-global"] = (lambda s, tp: JL.dino_loss(s[:2], tp, 0.1, ignore_diagonal=True),
                                 lambda s, tp: TL.dino_loss(s[:2], tp, 0.1, ignore_diagonal=True), (s_logits, t_probs))
    cases["dino_softmax_center"] = (lambda x, c: JL.dino_softmax_center_teacher(x, c, 0.07),
                                    lambda x, c: TL.dino_softmax_center_teacher(x, c, 0.07), (cls_logits, center))
    cases["dino_update_center"] = (lambda x, c: JL.dino_update_center(c, x, 0.9),
                                   lambda x, c: TL.dino_update_center(c, x, 0.9), (cls_logits, center))
    cases["ibot_softmax_center"] = (lambda x, c: JL.ibot_softmax_center_teacher(x, c, 0.07),
                                    lambda x, c: TL.ibot_softmax_center_teacher(x, c, 0.07), (patch_logits, center))
    cases["ibot_update_center"] = (lambda x, c: JL.ibot_update_center(c, x, 0.9),
                                   lambda x, c: TL.ibot_update_center(c, x, 0.9), (patch_logits, center))
    cases["sinkhorn"] = (lambda x: JL.sinkhorn_knopp(x, 0.07, 3), lambda x: TL.sinkhorn_knopp(x, 0.07, 3),
                         (cls_logits,))
    cases["sinkhorn-masked"] = (
        lambda x, m: JL.sinkhorn_knopp(x.reshape(-1, K), 0.07, 3, sample_mask=m),
        lambda x, m: TL.sinkhorn_knopp(x.reshape(-1, K), 0.07, 3, sample_mask=m), (patch_logits, _MASK))
    cases["sinkhorn-total"] = (lambda x: JL.sinkhorn_knopp(x, 0.07, 2, total_samples=11.0),
                               lambda x: TL.sinkhorn_knopp(x, 0.07, 2, total_samples=11.0), (cls_logits,))
    probs = np.asarray(jax.nn.softmax(_rand(B, N, K, seed=8), -1))
    cases["ibot_patch_loss"] = (lambda s, tp, m: JL.ibot_patch_loss(s, tp, m, 0.1),
                                lambda s, tp, m: TL.ibot_patch_loss(s, tp, m, 0.1), (patch_logits, probs, _MASK_BN))
    cases["koleo"] = (JL.koleo_loss, TL.koleo_loss, (_rand(B, D, seed=10),))
    for img_level in (True, False):
        for mode in ("remove_neg", "keep_neg", "only_teacher_neg"):
            kw = dict(img_level=img_level, remove_neg=mode == "remove_neg",
                      remove_only_teacher_neg=mode == "only_teacher_neg")
            cases[f"gram-img{int(img_level)}-{mode}"] = (
                lambda s, tt, kw=kw: JL.gram_loss(s, tt, **kw), lambda s, tt, kw=kw: TL.gram_loss(s, tt, **kw),
                (feats_s, feats_t))
    cases["gram-2d-nonorm"] = (lambda s, tt: JL.gram_loss(s.reshape(-1, D), tt.reshape(-1, D), apply_norm=False),
                               lambda s, tt: TL.gram_loss(s.reshape(-1, D), tt.reshape(-1, D), apply_norm=False),
                               (feats_s, feats_t))
    for mode in ("remove_neg", "keep_neg", "only_teacher_neg"):
        kw = dict(remove_neg=mode == "remove_neg", remove_only_teacher_neg=mode == "only_teacher_neg")
        cases[f"masked_gram-{mode}"] = (
            lambda s, tt, m, kw=kw: JL.masked_gram_loss(s, tt, m, **kw),
            lambda s, tt, m, kw=kw: TL.masked_gram_loss(s, tt, m, **kw), (feats_s, feats_t, _MASK_BN))
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_ssl_loss_matches_jax(name):
    """Each objective and its mode on the same inputs: the port within 1e-5
    of the largest |JAX| value."""
    jfn, tfn, inputs = CASES[name]
    ref = jax_once(jfn, *(jnp.asarray(a) for a in inputs))
    out = tfn(*(t(a) for a in inputs))
    err = _rel(out, ref)
    assert err <= TOL, (name, err)
    if name.startswith("sinkhorn-masked"):  # excluded samples come back as zero rows, the others sum to 1
        rows = out.numpy()
        assert not rows[~_MASK].any() and np.allclose(rows[_MASK].sum(-1), 1.0, atol=1e-5)


def test_process_groups_wait_for_the_data_parallel_slice():
    """A process group (the JAX axis_name) raises naming ROADMAP Queue 1
    item 3.2b; None runs on the process's batch."""
    x = t(_rand(B, K, seed=3))
    with pytest.raises(NotImplementedError, match="3.2b"):
        TL.sinkhorn_knopp(x, 0.07, group=object())
    with pytest.raises(NotImplementedError, match="3.2b"):
        TL.dino_update_center(t(_rand(K)), x, group=object())
    assert torch.isfinite(TL.sinkhorn_knopp(x, 0.07, group=None)).all()
