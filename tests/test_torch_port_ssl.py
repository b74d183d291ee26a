"""DINOv3 SSL pretraining of the port (omgsr_tpu_torch/training/ssl.py,
training/ssl_meta_arch.py and the ViT's backward with recompute) against the
JAX package on the same numpy inputs, in f32 on the CPU.

The heads, schedules, parameter groups, the SSL optimizer and the EMA;
the ViT's forward and gradients with masks and with ``remat_blocks`` (one
case at head dim 64, so the gradient goes through the flash autograd
Function's plain backward); two full SSL steps in each centering mode; one
gram step with the resize; one distillation step. The tiny sizes are those
of tests/test_ssl_meta_arch.py. Each JAX reference is one jit at
optimisation level 0 (tests/torch_port_helpers.jax_once)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.models import dinov3_vit as JV
from omgsr_tpu.models.configs import DinoV3ViTConfig as JC
from omgsr_tpu.training import ssl as JS
from omgsr_tpu.training import ssl_meta_arch as JM
from omgsr_tpu_torch.models import dinov3_vit as TV
from omgsr_tpu_torch.models.configs import DinoV3ViTConfig
from omgsr_tpu_torch.ops import flash_attention as FA
from omgsr_tpu_torch.training import ssl as TS
from omgsr_tpu_torch.training import ssl_meta_arch as TM
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict
from tests.torch_port_helpers import bridge, jax_once, t

TOL = 1e-5  # max |port - JAX| / max |JAX| per leaf, f32
OPT_TOL = 1e-6

VIT = dict(patch_size=4, embed_dim=16, depth=2, num_heads=2, n_storage_tokens=1)
META = dict(n_global_crops=2, n_local_crops=4, dino_out_dim=32, dino_hidden_dim=24, dino_bottleneck_dim=8,
            ibot_out_dim=32, ibot_hidden_dim=24, ibot_bottleneck_dim=8)
B, GS, LS = 4, 16, 8
STEP_KW = [dict(lr=1e-3, wd=0.04, teacher_temp=0.07, momentum=0.99, last_layer_lr=0.0),
           dict(lr=2e-3, wd=0.05, teacher_temp=0.06, momentum=0.98, last_layer_lr=5e-4)]


def _fill(shapes, seed):
    """Values for a tree of jax.ShapeDtypeStruct from numpy: kernels uniform
    in +-1/sqrt(fan_in), norm scales near 1, the rest N(0, 0.1); the RoPE
    periods are set by the caller."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            a = rng.uniform(-1, 1, leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            a = 0.1 * rng.standard_normal(leaf.shape)
        return jnp.asarray(a.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _student(jvit, jmeta, seed):
    shapes = jax.eval_shape(lambda k: JM.init_ssl_student(k, jvit, jmeta, JV.init_dinov3_vit), jax.random.key(0))
    tree = _fill(shapes, seed)
    tree["backbone"]["rope_embed"]["periods"] = jnp.asarray(JV.rope_periods(jvit), jnp.float32)
    return tree


def _batch(seed=0, gram_px=None):
    rng = np.random.default_rng(seed)
    n = (GS // VIT["patch_size"]) ** 2
    masks = np.zeros((2 * B, n), bool)
    for i in range(B):  # half the rows masked, about 40% of their patches
        masks[i, rng.choice(n, max(1, int(n * 0.4)), replace=False)] = True
    batch = {"global_crops": rng.standard_normal((2 * B, GS, GS, 3)).astype(np.float32),
             "local_crops": rng.standard_normal((4 * B, LS, LS, 3)).astype(np.float32),
             "masks": masks[rng.permutation(2 * B)]}
    if gram_px:
        batch["gram_teacher_crops"] = rng.standard_normal((2 * B, gram_px, gram_px, 3)).astype(np.float32)
    return batch


def _flat_jax(tree, dtype=np.float32):
    """{port path: numpy} of a JAX-layout tree: kernels transposed to torch's
    (out, in) / OIHW, kernel and scale named weight."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = tuple(p.key for p in path)
        a = np.asarray(leaf, dtype)
        if keys[-1] == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            keys = keys[:-1] + ("weight",)
        elif keys[-1] == "scale":
            keys = keys[:-1] + ("weight",)
        out[keys] = a
    return out


def _rel(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)) if a.size else 0.0


def _rel_l2(a, b):
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)) if a.size else 0.0


def _assert_tree(port, ref, tol, what, measure=_rel):
    p, r = flatten_dict(port), _flat_jax(ref)
    assert set(p) == set(r), (what, set(p) ^ set(r))
    worst = max(((measure(p[k], r[k]), k) for k in r))
    assert worst[0] <= tol, (what, worst)


def _adam(opt_state):
    """(mu, nu) of an optax inject_hyperparams chain's scale_by_adam state."""
    import optax

    adam = [s for s in opt_state.inner_state if isinstance(s, optax.ScaleByAdamState)][0]
    return adam.mu, adam.nu


# ----------------------------------------------------------------------------
# head, schedules, parameter groups
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("nlayers", [1, 2, 3])
def test_dino_head_matches_jax(nlayers):
    """init_dino_head has the JAX tree in the torch layout (mlp.0 / 2 / 4,
    last_layer without bias); on that JAX tree dino_head_apply matches, also
    with no_last_layer / only_last_layer."""
    shapes = jax.eval_shape(lambda k: JS.init_dino_head(k, 16, 32, 24, 8, nlayers), jax.random.key(0))
    jtree = _fill(shapes, 10 + nlayers)
    mine = TS.init_dino_head(0, 16, 32, 24, 8, nlayers, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_dict(mine).items()} == \
        {k: v.shape for k, v in _flat_jax(jtree).items()}
    w = mine["last_layer"]["weight"]
    assert "bias" not in mine["last_layer"] and float(w.abs().max()) <= 0.04 and 0.015 < float(w.std()) < 0.025
    x = np.random.default_rng(3).standard_normal((5, 16)).astype(np.float32)
    tp = bridge(jtree)
    for kw in ({}, {"no_last_layer": True}):
        ref = jax_once(lambda p, x: JS.dino_head_apply(p, x, **kw), jtree, jnp.asarray(x))
        assert _rel(TS.dino_head_apply(tp, t(x), **kw), ref) <= TOL, kw
    x8 = np.random.default_rng(4).standard_normal((5, 8)).astype(np.float32)
    ref = jax_once(lambda p, x: JS.dino_head_apply(p, x, only_last_layer=True), jtree, jnp.asarray(x8))
    assert _rel(TS.dino_head_apply(tp, t(x8), only_last_layer=True), ref) <= TOL


def test_schedules_and_groups_match_jax():
    """The schedule tables (cosine with warmup, freeze and truncation, the
    linear-warmup cosine, clamp past the end), build_ssl_schedulers of both
    CLIs on the published recipes' knobs, and the lr / wd multiplier and
    last-layer trees of a student are equal to the JAX package's."""
    from omgsr_tpu.cli import pretrain_dinov3 as JCLI
    from omgsr_tpu_torch.cli import pretrain_dinov3 as TCLI

    for args in [(1e-3, 1e-6, 50, 10), (0.04, 0.4, 30, 0, 0.0, 5), (1.0, 0.2, 40, 4, 0.1, 0, 0.5)]:
        np.testing.assert_array_equal(TS.cosine_schedule(*args), JS.cosine_schedule(*args))
    for args in [(0.0, 1.0, 0.1, 5, 30), (0.0, 2.0, 0.5, 3, 30, 10)]:
        np.testing.assert_array_equal(TS.linear_warmup_cosine_decay(*args), JS.linear_warmup_cosine_decay(*args))
    ts, js = TS.TabulatedSchedule(np.arange(4.0), 9.0), JS.TabulatedSchedule(np.arange(4.0), 9.0)
    assert [ts[i] for i in range(7)] == [js[i] for i in range(7)] and len(ts) == len(js)
    for kw in ({}, dict(lr_schedule={"start": 0.0, "peak": 0.0, "end": 5e-5, "warmup_epochs": 0, "cosine_epochs": 1},
                        freeze_last_layer_epochs=0, warmup_teacher_temp_epochs=0),
               dict(scaling_rule="linear_wrt_256", gram_loss_weight_schedule={"start": 0, "peak": 2, "end": 1,
                                                                              "warmup_epochs": 1},
                    local_loss_weight_schedule={"start": 1, "peak": 1, "end": 0.5, "warmup_epochs": 0})):
        common = {**dict(official_epoch_length=7, epochs=3, warmup_epochs=1, warmup_teacher_temp_epochs=2), **kw}
        a = TCLI.build_ssl_schedulers(TCLI.SSLPretrainConfig(**common), 64)
        b = JCLI.build_ssl_schedulers(JCLI.SSLPretrainConfig(**common), 64)
        assert set(a) == set(b)
        for k in a:
            if b[k] is None:
                assert a[k] is None, k
            else:
                assert [a[k][i] for i in range(25)] == [b[k][i] for i in range(25)], k
    jvit, jmeta = JC(**VIT), JM.SSLMetaConfig(**META)
    jtree = _student(jvit, jmeta, 0)
    ttree = bridge(jtree)
    for kw in (dict(lr_decay_rate=0.9, num_layers=2, patch_embed_lr_mult=0.2, dino_head_wd_multiplier=0.5), {}):
        for mine, ref in zip(TS.ssl_param_groups(ttree, **kw), JS.ssl_param_groups(jtree, **kw)):
            want = {k: float(v) for k, v in _flat_jax(ref, np.float64).items()}
            assert flatten_dict(mine) == want, kw
    ll_ref = {k: bool(v) for k, v in _flat_jax(JS.last_layer_mask(jtree), bool).items()}
    assert flatten_dict(TS.last_layer_mask(ttree)) == ll_ref
    assert sum(ll_ref.values()) == 2  # the two prototype layers


def test_optimizer_three_steps_match_optax():
    """SSLOptimizer against make_ssl_optimizer over three steps whose lr,
    wd and last_layer_lr change, the first clipped by the global norm and
    the others not: parameters and Adam moments within 1e-6."""
    jvit, jmeta = JC(**VIT), JM.SSLMetaConfig(**META)
    jtree = _student(jvit, jmeta, 1)
    lr_t, wd_t = JS.ssl_param_groups(jtree, lr_decay_rate=0.9, num_layers=2, patch_embed_lr_mult=0.2)
    tx = JS.make_ssl_optimizer(lr_t, wd_t, clip_norm=3.0, last_layer_mask_tree=JS.last_layer_mask(jtree))
    rng = np.random.default_rng(2)
    scales = (10.0, 0.01, 0.02)
    grads = [jax.tree.map(lambda a, s=s: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * s), jtree)
             for s in scales]
    hyper = [(1e-3, 0.04, 0.0), (2e-3, 0.06, 1e-3), (5e-4, 0.4, 2e-3)]

    def run(params, grads):
        state = tx.init(params)
        for g, (lr, wd, ll) in zip(grads, hyper):
            state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
            state.hyperparams["weight_decay"] = jnp.asarray(wd, jnp.float32)
            state.hyperparams["last_layer_lr"] = jnp.asarray(ll, jnp.float32)
            updates, state = tx.update(g, state, params)
            params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, _adam(state)

    ref_p, (ref_mu, ref_nu) = jax_once(run, jtree, grads)
    p = bridge(jtree)
    tl, tw = TS.ssl_param_groups(p, lr_decay_rate=0.9, num_layers=2, patch_embed_lr_mult=0.2)
    opt = TS.SSLOptimizer(tl, tw, clip_norm=3.0, last_layer_mask_tree=TS.last_layer_mask(p))
    state = opt.init(p)
    norms = [float(torch.linalg.vector_norm(torch.cat([v.reshape(-1) for v in flatten_dict(bridge(g)).values()])))
             for g in grads]
    assert norms[0] > 3.0 > max(norms[1:]), norms
    for g, (lr, wd, ll) in zip(grads, hyper):
        opt.update(bridge(g), state, p, lr=lr, wd=wd, last_layer_lr=ll)
    assert state["count"] == 3
    _assert_tree(p, ref_p, OPT_TOL, "params")
    _assert_tree(state["mu"], ref_mu, OPT_TOL, "mu")
    _assert_tree(state["nu"], ref_nu, OPT_TOL, "nu")
    # the RoPE periods take lr 0: unchanged
    assert torch.equal(p["backbone"]["rope_embed"]["periods"], bridge(jtree)["backbone"]["rope_embed"]["periods"])


def test_ema_update_matches_jax():
    jvit, jmeta = JC(**VIT), JM.SSLMetaConfig(**META)
    a, b = _student(jvit, jmeta, 3), _student(jvit, jmeta, 4)
    ref = jax_once(lambda x, y: JS.ema_update(x, y, 0.994), a, b)
    mine = TS.ema_update(bridge(a), bridge(b), 0.994)
    _assert_tree(mine, ref, 1e-7, "ema")


# ----------------------------------------------------------------------------
# the ViT's forward and gradients, with masks and recompute
# ----------------------------------------------------------------------------

VIT_GRAD_CASES = {
    "d8-masks": (dict(embed_dim=16, num_heads=2, depth=2, patch_size=4, n_storage_tokens=1), True, False),
    "d64-masks-remat": (dict(embed_dim=128, num_heads=2, depth=2, patch_size=8), True, True),
    "d64-remat-swiglu": (dict(embed_dim=128, num_heads=2, depth=2, patch_size=8, ffn_layer="swiglu",
                              untie_cls_and_patch_norms=True), False, True),
}


@pytest.mark.parametrize("name", sorted(VIT_GRAD_CASES))
def test_vit_forward_and_gradients_match_jax(name, monkeypatch):
    """dinov3_vit_apply's outputs and the gradients of a weighted sum of them
    with respect to every parameter (RoPE periods included) and the input,
    against jax.value_and_grad; with remat_blocks the same bits as without.
    At head dim 64 the backward runs the flash Function's plain version."""
    over, masked, remat = VIT_GRAD_CASES[name]
    jc = JC(**over)
    shapes = jax.eval_shape(lambda k: JV.init_dinov3_vit(k, jc), jax.random.key(0))
    jp = _fill(shapes, 20)
    jp["rope_embed"]["periods"] = jnp.asarray(JV.rope_periods(jc), jnp.float32)
    p = over["patch_size"]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 2 * p, 3 * p, 3)).astype(np.float32)
    masks = np.array([[1, 0, 0, 1, 0, 1], [0, 0, 1, 0, 0, 0]], bool) if masked else None
    keys = ("x_norm_clstoken", "x_storage_tokens", "x_norm_patchtokens", "x_prenorm")
    shapes_out = jax.eval_shape(lambda a, b: JV.dinov3_vit_apply(a, jc, b), jp, jnp.asarray(x))
    wts = {k: rng.standard_normal(shapes_out[k].shape).astype(np.float32) for k in keys}

    def loss(params, x):
        out = JV.dinov3_vit_apply(params, jc, x, None if masks is None else jnp.asarray(masks))
        return sum(jnp.sum(out[k] * wts[k]) for k in keys)

    ref_l, (ref_gp, ref_gx) = jax_once(lambda a, b: jax.value_and_grad(loss, argnums=(0, 1))(a, b), jp, jnp.asarray(x))
    bwd_calls = []
    real_bwd = FA.flash_attention_bwd
    monkeypatch.setattr(FA, "flash_attention_bwd", lambda *a, **k: bwd_calls.append(1) or real_bwd(*a, **k))
    grads = {}
    for r in sorted({False, remat}):
        tc = DinoV3ViTConfig(**over, remat_blocks=r)
        tp = bridge(jp)
        leaves = list(flatten_dict(tp).values())
        for leaf in leaves:
            leaf.requires_grad_(True)
        tx = t(x).requires_grad_(True)
        out = TV.dinov3_vit_apply(tp, tc, tx, None if masks is None else torch.from_numpy(masks))
        total = sum(torch.sum(out[k] * t(wts[k])) for k in keys)
        g = [torch.zeros_like(a) if b is None else b  # the mask token without masks, as jax.grad gives it
             for a, b in zip(leaves + [tx], torch.autograd.grad(total, leaves + [tx], allow_unused=True))]
        grads[r] = (float(total.detach()), dict(zip(flatten_dict(tp), g[:-1])), g[-1])
    total, gp, gx = grads[remat]
    assert abs(total - float(ref_l)) <= TOL * abs(float(ref_l)), (total, float(ref_l))
    _assert_tree(unflatten_dict(gp), ref_gp, TOL, name)
    assert _rel(gx, ref_gx) <= TOL
    if remat:
        assert grads[False][0] == total and torch.equal(grads[False][2], gx)
        assert all(torch.equal(grads[False][1][k], gp[k]) for k in gp)
    assert (len(bwd_calls) > 0) == (over["embed_dim"] // over["num_heads"] == 64), bwd_calls


# ----------------------------------------------------------------------------
# full steps: SSL (both centerings), gram, distillation
# ----------------------------------------------------------------------------


def _jax_steps(kind, jmeta, jvit, student, batch, teacher_tree=None, teacher_vit=None):
    """The JAX step(s) as one jit: (student, teacher, adam (mu, nu), centers, [metrics per step])."""
    lr_t, wd_t = JS.ssl_param_groups(student, lr_decay_rate=0.9, num_layers=jvit.depth)
    tx = JS.make_ssl_optimizer(lr_t, wd_t, last_layer_mask_tree=JS.last_layer_mask(student))
    if kind == "ssl":
        fn = JM.make_ssl_train_step(tx, cfg=jmeta, vit_cfg=jvit)
    elif kind == "gram":
        fn = JM.make_gram_ssl_train_step(tx, cfg=jmeta, vit_cfg=jvit)
    else:
        fn = JM.make_distill_train_step(tx, cfg=jmeta, vit_cfg=jvit, teacher_vit_cfg=teacher_vit)
    n_steps = 2 if kind == "ssl" else 1
    hyper = {k: jnp.asarray([kw[k] for kw in STEP_KW[:n_steps]], jnp.float32) for k in STEP_KW[0]}

    def run(student, other, batch, hyper):
        def body(carry, kw):  # the steps as a scan: the step is traced and compiled once
            student, ema, state, centers = carry
            if kind == "ssl":
                student, ema, state, centers, m = fn(student, ema, state, centers, batch, **kw)
            elif kind == "gram":
                student, ema, state, centers, m = fn(student, ema, other, state, centers, batch, **kw)
            else:
                student, ema, state, centers, m = fn(student, other, ema, state, centers, batch, **kw)
            return (student, ema, state, centers), m

        carry = (student, jax.tree.map(jnp.copy, student), tx.init(student), JM.init_center_state(jmeta))
        (student, ema, state, centers), metrics = jax.lax.scan(body, carry, hyper)
        return student, ema, _adam(state), centers, [jax.tree.map(lambda a, i=i: a[i], metrics)
                                                     for i in range(n_steps)]

    other = teacher_tree if kind == "distill" else (student["backbone"] if kind == "gram" else None)
    return jax_once(run, student, other, {k: jnp.asarray(v) for k, v in batch.items()}, hyper)


def _port_steps(kind, tmeta, tvit, student, batch, other=None, teacher_vit=None):
    lr_t, wd_t = TS.ssl_param_groups(student, lr_decay_rate=0.9, num_layers=tvit.depth)
    opt = TS.SSLOptimizer(lr_t, wd_t, last_layer_mask_tree=TS.last_layer_mask(student))
    state = opt.init(student)
    centers = TM.init_center_state(tmeta, device="cpu")
    ema = TM.copy_tree(student)
    tb = {k: t(v) for k, v in batch.items()}
    if kind == "ssl":
        fn = TM.make_ssl_train_step(opt, cfg=tmeta, vit_cfg=tvit)
    elif kind == "gram":
        fn = TM.make_gram_ssl_train_step(opt, cfg=tmeta, vit_cfg=tvit)
    else:
        fn = TM.make_distill_train_step(opt, cfg=tmeta, vit_cfg=tvit, teacher_vit_cfg=teacher_vit)
    metrics = []
    for kw in STEP_KW[:2 if kind == "ssl" else 1]:
        if kind == "ssl":
            student, ema, state, centers, m = fn(student, ema, state, centers, tb, **kw)
        elif kind == "gram":
            student, ema, state, centers, m = fn(student, ema, other, state, centers, tb, **kw)
        else:
            student, ema, state, centers, m = fn(student, other, ema, state, centers, tb, **kw)
        metrics.append(m)
    return student, ema, (state["mu"], state["nu"]), centers, metrics


STEP_CASES = {
    "ssl-sinkhorn": ("ssl", {}, None),
    "ssl-softmax": ("ssl", dict(centering="softmax"), None),
    "gram-masked-resize": ("gram", dict(gram_loss_weight=1.0, gram_tokens_used="masked"), 28),
    "distill": ("distill", dict(koleo_loss_weight=0.2), None),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_train_steps_match_jax(name):
    """make_ssl_train_step twice in each centering mode, make_gram_ssl_train_step
    once with a frozen gram backbone on 28-px gram crops (a 7x7 patch grid
    resized to 4x4), make_distill_train_step once with a wider frozen
    teacher: the metrics, the student, the teacher (EMA), the centers and the
    Adam moments within 1e-5 of the JAX package's."""
    kind, over, gram_px = STEP_CASES[name]
    jvit, jmeta = JC(**VIT), JM.SSLMetaConfig(**META, **over)
    tvit, tmeta = DinoV3ViTConfig(**VIT), TM.SSLMetaConfig(**META, **over)
    jstudent = _student(jvit, jmeta, 30)
    batch = _batch(31, gram_px)
    jteacher = jt_vit = tt_vit = None
    if kind == "distill":
        t_over = dict(VIT, embed_dim=24, num_heads=3)
        jt_vit, tt_vit = JC(**t_over), DinoV3ViTConfig(**t_over)
        jteacher = _student(jt_vit, jmeta, 32)
    ref = _jax_steps(kind, jmeta, jvit, jstudent, batch, jteacher, jt_vit)
    student = bridge(jstudent)
    other = bridge(jteacher) if kind == "distill" else (bridge(jstudent)["backbone"] if kind == "gram" else None)
    mine = _port_steps(kind, tmeta, tvit, student, batch, other, tt_vit)
    for i, (m, r) in enumerate(zip(mine[4], ref[4])):
        assert set(m) == set(r), (set(m), set(r))
        for k in r:
            assert abs(float(m[k]) - float(r[k])) <= TOL * max(abs(float(r[k])), 1e-3), (name, i, k, float(m[k]),
                                                                                         float(r[k]))
    # after Adam each leaf is held in rel L2: an update divides each entry's gradient by that entry's own
    # magnitude, so an entry whose gradient is within rounding of zero moves by a share of lr in either package
    for i, what in ((0, "student"), (1, "teacher")):
        _assert_tree(mine[i], ref[i], TOL, what, _rel_l2)
    _assert_tree(mine[2][0], ref[2][0], TOL, "mu", _rel_l2)
    # the second moment through its square root, the scale an update divides by (squaring doubles a relative
    # error: the RoPE periods' gradient, a sum that cancels to 1/40 of its terms, is 2.9e-06 from its f64 value
    # here against the JAX package's 5.1e-07)
    _assert_tree(unflatten_dict({k: v.sqrt() for k, v in flatten_dict(mine[2][1]).items()}),
                 jax.tree.map(jnp.sqrt, ref[2][1]), TOL, "sqrt(nu)", _rel_l2)
    for k in ("dino", "ibot"):
        assert _rel(mine[3][k], ref[3][k]) <= TOL if np.abs(np.asarray(ref[3][k])).max() > 0 \
            else not mine[3][k].any(), k
    if kind == "gram":
        assert float(mine[4][0]["gram_loss"]) > 0
    if kind == "distill":  # the frozen teacher did not move
        assert all(torch.equal(a, b) for a, b in zip(flatten_dict(other).values(),
                                                      flatten_dict(bridge(jteacher)).values()))


@pytest.mark.parametrize("src,dst,method", [(32, 14, "bicubic"), (37, 16, "bicubic"), (7, 4, "bicubic"),
                                            (4, 6, "bicubic"), (5, 5, "bicubic"), (37, 16, "bilinear")])
def test_resize_gram_teacher_patches_matches_jax_image_resize(src, dst, method):
    """Keys' cubic (a = -0.5), antialiased when downscaling, as
    jax.image.resize(method="bicubic") through the JAX function (and the
    triangle kernel of "bilinear"); the same grid is returned unchanged."""
    x = np.random.default_rng(src * 100 + dst).standard_normal((2, src * src, 6)).astype(np.float32)
    ref = jax_once(lambda a: JM.resize_gram_teacher_patches(a, (src, src), (dst, dst), method), jnp.asarray(x))
    out = TM.resize_gram_teacher_patches(t(x), (src, src), (dst, dst), method)
    assert _rel(out, ref) <= TOL
    if src == dst:
        assert torch.equal(out, t(x))


def test_steps_refuse_a_process_group():
    opt = TS.SSLOptimizer({"a": 1.0}, {"a": 0.0})
    with pytest.raises(NotImplementedError, match="3.2b"):
        TM.make_ssl_train_step(opt, cfg=TM.SSLMetaConfig(), vit_cfg=DinoV3ViTConfig(), group=object())
    with pytest.raises(NotImplementedError, match="3.2b"):
        TM.make_distill_train_step(opt, cfg=TM.SSLMetaConfig(), vit_cfg=DinoV3ViTConfig(), group=object())
