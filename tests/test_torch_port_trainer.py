"""OMGSR-S training in the port against the JAX package: the optimizer
against optax, one and two ``TrainerS.train_step``s on bridged weights with
shared batch, noise and DiffAugment draws, and ``run_training`` with an
in-memory bundle (metrics file, checkpoint, resume). fp32 on the CPU.

The JAX step (``TrainerS._train_step``) is compiled once with XLA's
optimisation passes switched off: the fully optimised compile of the jitted
step takes minutes on the CPU, and running it op by op takes as long. Its
random numbers are replayed from its keys in its order and handed to the
port as ``StepNoise``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from omgsr_tpu.config import TrainConfig as JTrainConfig
from omgsr_tpu.losses.discriminator import init_discriminator as j_init_discriminator
from omgsr_tpu.losses.dists import init_dists as j_init_dists
from omgsr_tpu.models import convnext as JCN
from omgsr_tpu.models import unet_sd as JU
from omgsr_tpu.models import vae as JV
from omgsr_tpu.models.configs import ConvNeXtConfig as JConvNeXtConfig
from omgsr_tpu.models.configs import UNetConfig as JUNetConfig
from omgsr_tpu.training import optim as JOPT
from omgsr_tpu.training.trainer import TrainerS as JTrainerS
from omgsr_tpu_torch.cli import train_omgsr_s as TCLI
from omgsr_tpu_torch.config import TrainConfig, load_config, save_config
from omgsr_tpu_torch.convert.params import init_convnext, init_unet, init_vae, to_jax_tree
from omgsr_tpu_torch.losses.dists import init_dists
from omgsr_tpu_torch.models.configs import ConvNeXtConfig, UNetConfig
from omgsr_tpu_torch.ops import flash_attention as TFA
from omgsr_tpu_torch.training import checkpoint as TCKPT
from omgsr_tpu_torch.training import optim as TOPT
from omgsr_tpu_torch.training.trainer import StepNoise, TrainerS, draw_step_noise, l1_loss, mse_loss
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.torch_port_helpers import (
    J_TINY_VAE,
    T_TINY_VAE,
    assert_close,
    bridge,
    jax_diffaug_draws,
    jax_init,
    jax_lora_tree,
    t,
    to_numpy_tree,
)

# head dim 64 at every attention site, so the port's step goes through the
# flash-attention autograd function (plain versions on the CPU)
_UNET = dict(block_out_channels=(64, 64), num_attention_heads=(1, 1), cross_attention_dim=16,
             norm_num_groups=4, layers_per_block=1,
             down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
             up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
J_UNET, T_UNET = JUNetConfig(**_UNET), UNetConfig(**_UNET)
_CN = dict(depths=(1, 1, 1, 1), dims=(8, 16, 24, 32))
J_CN, T_CN = JConvNeXtConfig(**_CN), ConvNeXtConfig(**_CN)
HEADS = [([0.5], [1]), ([0.5], [1]), ([0.5], [1])]
RES, BATCH = 64, 2


# ----------------------------------------------------------------------------
# optimizer against optax
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("accum,warmup", [(1, 0), (1, 3), (2, 0), (2, 3)])
def test_optimizer_matches_optax(accum, warmup):
    """5 updates on a fixed gradient sequence, some clipped and some not:
    parameters to 1e-6 after every micro-step."""
    kw = dict(gradient_accumulation_steps=accum, lr_warmup_steps=warmup, learning_rate=1e-2)
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": rng.standard_normal(5).astype(np.float32)}
    jtx = JOPT.make_optimizer(JTrainConfig(**kw))
    jupdate = jax.jit(jtx.update)  # one compile for the 5 * accum updates (the same sums as op by op)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    ttx = TOPT.make_optimizer(TrainConfig(**kw))
    tp = {"a": {"w": t(params["a"]["w"])}, "b": t(params["b"])}
    tstate = ttx.init(tp)
    changed = []
    for i in range(5 * accum):
        scale = 5.0 if i % 3 == 0 else 0.05  # global norm above and below max_grad_norm
        g = {"a": {"w": (rng.standard_normal((3, 4)) * scale).astype(np.float32)},
             "b": (rng.standard_normal(5) * scale).astype(np.float32)}
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        before = tp["b"].clone()
        applied = ttx.update({"a": {"w": t(g["a"]["w"])}, "b": t(g["b"])}, tstate, tp)
        changed.append(not torch.equal(before, tp["b"]))
        assert applied == ((i + 1) % accum == 0)
        assert_close(tp["a"]["w"], jp["a"]["w"], 1e-6, f"micro-step {i}")
        assert_close(tp["b"], jp["b"], 1e-6, f"micro-step {i}")
    # nothing moves inside an accumulation window, nor on the first update of a warm-up (lr = 0)
    want = [(i + 1) % accum == 0 and not (warmup and i < accum) for i in range(5 * accum)]
    assert changed == want
    assert tstate["count"] == 5 and tstate["mini_step"] == 0


@pytest.mark.parametrize("name,warmup", [("constant", 0), ("constant", 4), ("cosine", 4), ("linear", 4)])
def test_lr_schedule_matches_optax(name, warmup):
    kw = dict(lr_scheduler=name, lr_warmup_steps=warmup, learning_rate=3e-4, max_train_steps=20)
    js, ts = JOPT.lr_schedule(JTrainConfig(**kw)), TOPT.lr_schedule(TrainConfig(**kw))
    for count in range(26):
        assert abs(ts(count) - float(js(count))) <= 1e-9, (name, count)
    with pytest.raises(ValueError):
        TOPT.lr_schedule(TrainConfig(lr_scheduler="polynomial"))


def test_losses_and_config_round_trip(tmp_path):
    a, b = np.random.default_rng(1).standard_normal((2, 3, 4, 5)).astype(np.float32)
    assert abs(l1_loss(t(a), t(b)).item() - np.abs(a - b).mean()) < 1e-6
    assert abs(mse_loss(t(a).bfloat16(), t(b)).item() - ((t(a).bfloat16().float().numpy() - b) ** 2).mean()) < 1e-6
    cfg = TrainConfig(learning_rate=1e-3, extra={"disc_channels": [8, 16, 24]})
    save_config(cfg, str(tmp_path / "cfg.yml"))
    back = load_config(str(tmp_path / "cfg.yml"), ["learning_rate=2e-4", "mesh_shape={data: 4}", "unknown_key=7"])
    assert back.learning_rate == 2e-4 and back.mesh_shape == {"data": 4}
    assert back.extra == {"disc_channels": [8, 16, 24], "unknown_key": 7}
    # the same fields and defaults as the JAX package's config
    import dataclasses

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


# ----------------------------------------------------------------------------
# the slice as a whole
# ----------------------------------------------------------------------------


def _jax_bundle():
    vp = jax_init(JV.init_vae, 0, J_TINY_VAE)
    up = jax_init(JU.init_unet, 1, J_UNET)
    bp = jax_init(lambda k, c: JCN.init_convnext(k, c), 2, J_CN)
    bp = jax.tree_util.tree_map_with_path(lambda p, v: v + 0.5 if p[-1].key == "gamma" else v, bp)
    rng = np.random.default_rng(3)
    prompt = jnp.asarray(rng.standard_normal((1, 7, 16)).astype(np.float32))
    frozen = {"vae": vp, "vae_cfg": J_TINY_VAE, "unet": up, "unet_cfg": J_UNET, "backbone": bp,
              "dists": j_init_dists(bp, J_CN.dims), "prompt_embeds": prompt}
    lora = {"vae_encoder": jax_lora_tree(vp["encoder"], 2, seed=4),
            "denoiser": jax_lora_tree(up, 2, seed=5)}
    shapes = jax.eval_shape(lambda k: j_init_discriminator(k, J_CN.dims[:3], configs=HEADS)[:2],
                            jax.random.key(0))
    dparams, dsn = jax.tree.map(
        lambda leaf: jnp.asarray((rng.standard_normal(leaf.shape) * 0.3).astype(np.float32)), shapes)
    meta = {str(i): list(HEADS[i][1]) for i in range(3)}
    return frozen, lora, (dparams, dsn, meta)


def _bridge_bundle(frozen, lora, disc):
    bp = bridge(frozen["backbone"])
    tfrozen = {"vae": bridge(frozen["vae"]), "vae_cfg": T_TINY_VAE, "unet": bridge(frozen["unet"]),
               "unet_cfg": T_UNET, "backbone": bp, "dists": init_dists(bp, T_CN.dims),
               "prompt_embeds": t(np.asarray(frozen["prompt_embeds"]))}
    tlora = {k: bridge(v) for k, v in lora.items()}
    return tfrozen, tlora, (bridge(disc[0]), bridge(disc[1]), disc[2])


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {k: np.tanh(rng.standard_normal((BATCH, RES, RES, 3))).astype(np.float32) for k in ("lq", "hq")}


def _replay_noise(rng_key, image_shape, latent_shape) -> StepNoise:
    """The random numbers of TrainerS._train_step(state, batch, rng_key, ...),
    drawn from its keys in its order (trainer.py:188-190, vae.py
    sample_diagonal_gaussian, diffaug.py:67-76); the normals as one jit per
    shape (the same bits as op by op)."""
    keys = jax.random.split(rng_key, 6)
    normals = jax.jit(_latent_normals, static_argnums=1)(keys[:3], tuple(latent_shape))
    return StepNoise(*(t(np.asarray(n)) for n in normals), *(jax_diffaug_draws(k, image_shape) for k in keys[3:]))


def _latent_normals(keys, latent_shape):
    return [jax.random.normal(k, latent_shape, jnp.float32) for k in keys]


def _assert_tree_close(port_tree, jax_tree, tol, what):
    got = flatten_dict(to_jax_tree(port_tree))
    want = flatten_dict(to_numpy_tree(jax_tree))
    assert set(got) == set(want), what
    for p in want:
        scale = max(np.abs(want[p]).max(), 1e-6)
        err = np.abs(got[p] - want[p]).max()
        assert err <= tol * scale, (what, ".".join(p), err, scale)


# metrics, pred and state against the JAX step: 1e-3 relative. The losses
# agree to about 1e-5; the bound is set by the Adam update, which divides the
# gradient by its own magnitude, so an entry's relative gradient error shows
# undamped in its update, and by the second step's inputs, which are the
# first step's outputs.
STEP_TOL = 1e-3
METRICS = ("loss_total_G", "loss_total_D", "loss_LRR", "loss_Dv3D", "loss_L1", "loss_G",
           "loss_D_fake", "loss_D_real", "grad_norm_G", "grad_norm_D")


def test_train_steps_match_jax():
    """Three micro-steps at accumulation 2: the first changes no parameter,
    the second applies the first update, the third runs on the updated
    leaves. After each: all ten metrics, pred, LoRA leaves, heads and u."""
    accum = 2
    kw = dict(mid_timestep=273, gradient_accumulation_steps=accum, lr_warmup_steps=0, learning_rate=1e-3)
    frozen, lora, disc = _jax_bundle()
    jtr = JTrainerS(JTrainConfig(**kw), frozen, lora, disc)
    tfrozen, tlora, tdisc = _bridge_bundle(frozen, lora, disc)
    ttr = TrainerS(TrainConfig(**kw), tfrozen, tlora, tdisc)
    frozen_before = {p: v.clone() for p, v in flatten_dict(tfrozen["unet"]).items()}
    latent_shape = (BATCH, RES // J_TINY_VAE.downscale, RES // J_TINY_VAE.downscale, 4)

    jstate = jtr.state
    jbatch0 = {k: jnp.asarray(v) for k, v in _batch(10).items()}
    jstep = jax.jit(jtr._train_step).lower(jstate, jbatch0, jax.random.key(0), jtr._frozen_arrays).compile(
        compiler_options={"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    del jbatch0
    bwd_calls = []
    real_bwd = TFA.flash_attention_bwd
    TFA.flash_attention_bwd = lambda *a: (bwd_calls.append(1), real_bwd(*a))[1]
    try:
        for step in range(3):
            batch = _batch(10 + step)
            key = jax.random.key(20 + step)
            lora_before = {p: v.detach().clone() for p, v in flatten_dict(ttr.state["gen"]["lora"]).items()}
            heads_before = {p: v.detach().clone() for p, v in flatten_dict(ttr.state["disc"]["params"]).items()}
            jstate, (jmetrics, jpred) = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jtr._frozen_arrays)
            noise = _replay_noise(key, batch["hq"].shape, latent_shape)
            metrics, pred = ttr.train_step({k: t(v) for k, v in batch.items()}, noise)

            assert set(metrics) == set(jmetrics) == set(METRICS)
            for name in METRICS:
                want = float(jmetrics[name])
                assert abs(float(metrics[name]) - want) <= STEP_TOL * max(abs(want), 1e-6), \
                    (step, name, float(metrics[name]), want)
            assert_close(pred, jpred, STEP_TOL, f"pred of step {step}")
            assert not pred.requires_grad
            for what, port_tree, jax_tree in (
                    ("lora", ttr.state["gen"]["lora"], jstate["gen"]["lora"]),
                    ("heads", ttr.state["disc"]["params"], jstate["disc"]["params"]),
                    ("u", ttr.state["disc"]["sn"], jstate["disc"]["sn"])):
                _assert_tree_close(port_tree, jax_tree, STEP_TOL, f"{what} after step {step}")
            assert ttr.state["step"] == int(jstate["step"]) == step + 1
            moved = any(not torch.equal(v, lora_before[p])
                        for p, v in flatten_dict(ttr.state["gen"]["lora"]).items())
            heads_moved = any(not torch.equal(v, heads_before[p])
                              for p, v in flatten_dict(ttr.state["disc"]["params"]).items())
            assert moved == heads_moved == ((step + 1) % accum == 0), (step, moved, heads_moved)
    finally:
        TFA.flash_attention_bwd = real_bwd
    # every UNet attention site went through the paired backward, once per step
    n_sites = 2 * (1 + 1 + 2)  # self + cross in one down, the mid and two up transformer blocks
    assert len(bwd_calls) == 3 * n_sites
    # frozen weights untouched and without gradient
    for p, v in flatten_dict(tfrozen["unet"]).items():
        assert torch.equal(v, frozen_before[p]) and v.grad is None and not v.requires_grad


def test_generator_and_discriminator_gradients_stay_apart():
    """The G step's loss reaches no head leaf, the D step's no LoRA leaf."""
    frozen, lora, disc = _jax_bundle()
    tfrozen, tlora, tdisc = _bridge_bundle(frozen, lora, disc)
    tr = TrainerS(TrainConfig(gradient_accumulation_steps=1, lr_warmup_steps=0), tfrozen, tlora, tdisc)
    batch = {k: t(v) for k, v in _batch(30).items()}
    gen = torch.Generator().manual_seed(0)
    noise = draw_step_noise(gen, batch["hq"].shape, (BATCH, 32, 32, 4), "cpu", torch.float32)
    heads = list(flatten_dict(tr.state["disc"]["params"]).values())
    loras = list(flatten_dict(tr.state["gen"]["lora"]).values())
    g_total, (_, pred) = tr._gen_loss(tr.state["gen"]["lora"], batch, noise, tfrozen,
                                      tr.state["disc"]["params"], tr.state["disc"]["sn"])
    assert all(g is None for g in torch.autograd.grad(g_total, heads, allow_unused=True, retain_graph=True))
    assert any(g is not None and g.abs().max() > 0 for g in torch.autograd.grad(g_total, loras, allow_unused=True))
    d_total, _ = tr._disc_loss(tr.state["disc"]["params"], tr.state["disc"]["sn"], pred.detach(),
                               batch["hq"], noise, tfrozen)
    assert all(g is None for g in torch.autograd.grad(d_total, loras, allow_unused=True, retain_graph=True))
    assert all(g is not None for g in torch.autograd.grad(d_total, heads, allow_unused=True))


def test_gradient_checkpointing_gives_the_same_step():
    """cfg.gradient_checkpointing recomputes activations and changes no number
    beyond summation order (1e-5)."""
    frozen, lora, disc = _jax_bundle()
    results = []
    for ckpt in (False, True):
        tfrozen, tlora, tdisc = _bridge_bundle(frozen, lora, disc)
        tr = TrainerS(TrainConfig(gradient_accumulation_steps=1, lr_warmup_steps=0,
                                  gradient_checkpointing=ckpt), tfrozen, tlora, tdisc)
        batch = {k: t(v)[:1] for k, v in _batch(31).items()}
        noise = draw_step_noise(torch.Generator().manual_seed(1), batch["hq"].shape, (1, 32, 32, 4),
                                "cpu", torch.float32)
        metrics, pred = tr.train_step(batch, noise)
        results.append((metrics, pred, flatten_dict(tr.state["gen"]["lora"])))
    (m0, p0, l0), (m1, p1, l1) = results
    for k in m0:
        assert abs(float(m0[k]) - float(m1[k])) <= 1e-5 * max(abs(float(m0[k])), 1.0), k
    assert_close(p1, p0.numpy(), 1e-5)
    for path in l0:
        assert_close(l1[path], l0[path].detach().numpy(), 1e-5, ".".join(path))


# ----------------------------------------------------------------------------
# run_training, checkpoint, resume
# ----------------------------------------------------------------------------


def _frozen_from_seed(dtype=torch.float32):
    bp = init_convnext(2, T_CN, dtype, "cpu")
    return {"vae": init_vae(0, T_TINY_VAE, dtype, "cpu"), "vae_cfg": T_TINY_VAE,
            "unet": init_unet(1, T_UNET, dtype, "cpu"), "unet_cfg": T_UNET, "backbone": bp,
            "dists": init_dists(bp, T_CN.dims),
            "prompt_embeds": torch.from_numpy(np.random.default_rng(3).standard_normal((1, 7, 16)).astype(np.float32))}


def _cfg(tmp_path, **kw):
    base = dict(output_dir=str(tmp_path / "run"), mixed_precision="no", resolution=64,
                gradient_accumulation_steps=2, lr_warmup_steps=0, learning_rate=1e-3,
                vae_lora_rank=2, unet_lora_rank=2, max_train_steps=2, checkpointing_steps=1,
                save_img_steps=1000, seed=7,
                extra={"disc_channels": list(T_CN.dims[:3]), "metrics_jsonl": str(tmp_path / "metrics.jsonl")})
    base.update(kw)
    return TrainConfig(**base)


def _state_leaves(state, prefix=()):
    for k, v in state.items():
        if isinstance(v, dict):
            yield from _state_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_run_training_writes_metrics_saves_and_resumes(tmp_path, monkeypatch):
    import omgsr_tpu_torch.convert.params as P

    # tiny discriminator heads for the 64-px images of this test
    real_init = P.init_discriminator
    monkeypatch.setattr(P, "init_discriminator",
                        lambda seed, ch, res, dtype, device, configs=None: real_init(
                            seed, ch, res, dtype, device, configs=HEADS))
    loader = [_batch(40 + i) for i in range(3)]
    cfg = _cfg(tmp_path)
    tr = TCLI.run_training(cfg, frozen=_frozen_from_seed(), loader=loader, device="cpu")
    assert tr.state["step"] == 4  # 2 optimizer steps at accumulation 2
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert [l["step"] for l in lines] == [1, 2]
    for l in lines:
        assert set(METRICS) <= set(l) and all(np.isfinite(l[k]) for k in METRICS)
    assert os.path.exists(tmp_path / "run" / "cfg.yml")
    assert TCKPT._checkpoint_steps(cfg.output_dir) == [1, 2]
    latest = TCKPT.latest_checkpoint(cfg.output_dir)
    assert latest.endswith("checkpoint-2.pt")
    saved = dict(_state_leaves(torch.load(latest, weights_only=True)))
    live = dict(_state_leaves(tr.state))
    assert set(saved) == set(live)
    for p, v in live.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(saved[p], v.detach()), p
        else:
            assert saved[p] == v, p
    assert saved[("gen", "opt", "count")] == 2 and saved[("gen", "opt", "mini_step")] == 0

    # resume: a fresh trainer restores bit-equal state and continues the micro-step count
    cfg2 = _cfg(tmp_path, max_train_steps=3, resume_from_checkpoint="latest")
    tr2 = TCLI.run_training(cfg2, frozen=_frozen_from_seed(), loader=loader, device="cpu")
    assert tr2.state["step"] == 6 and tr2.state["gen"]["opt"]["count"] == 3
    assert [json.loads(l)["step"] for l in open(tmp_path / "metrics.jsonl")] == [1, 2, 3]
    assert TCKPT._checkpoint_steps(cfg.output_dir) == [1, 2, 3]
    fresh = TrainerS(cfg2, _frozen_from_seed(), *_fresh_parts(cfg2))
    restored = TCKPT.restore_train_state(latest, fresh.state)
    for p, v in _state_leaves(restored):
        if isinstance(v, torch.Tensor):
            assert torch.equal(saved[p], v.detach()), p
    assert all(v.requires_grad for v in flatten_dict(restored["gen"]["lora"]).values())
    with pytest.raises(ValueError):
        TCKPT.restore_train_state(latest, {"step": 0})


def _fresh_parts(cfg):
    from omgsr_tpu_torch.convert.params import init_discriminator
    from omgsr_tpu_torch.lora import SD_TARGET_MODULES, init_lora_tree

    gen = torch.Generator().manual_seed(99)
    frozen = _frozen_from_seed()
    lora = {"vae_encoder": init_lora_tree(gen, frozen["vae"]["encoder"], SD_TARGET_MODULES, cfg.vae_lora_rank),
            "denoiser": init_lora_tree(gen, frozen["unet"], SD_TARGET_MODULES, cfg.unet_lora_rank)}
    return lora, init_discriminator(gen, cfg.extra["disc_channels"], 64, torch.float32, "cpu", configs=HEADS)


def test_run_training_is_deterministic_from_the_seed_and_saves_a_triptych(tmp_path, monkeypatch):
    import omgsr_tpu_torch.convert.params as P

    real_init = P.init_discriminator
    monkeypatch.setattr(P, "init_discriminator",
                        lambda seed, ch, res, dtype, device, configs=None: real_init(
                            seed, ch, res, dtype, device, configs=HEADS))
    loader = [{k: v[:1] for k, v in _batch(50).items()}]
    runs = []
    for name in ("a", "b"):
        cfg = _cfg(tmp_path / name, gradient_accumulation_steps=1, max_train_steps=1, save_img_steps=1)
        os.makedirs(tmp_path / name, exist_ok=True)
        tr = TCLI.run_training(cfg, frozen=_frozen_from_seed(), loader=loader, device="cpu")
        runs.append(flatten_dict(tr.state["gen"]["lora"]))
        assert os.path.getsize(tmp_path / name / "run" / "img-1.jpg") > 0
    assert all(torch.equal(runs[0][p], runs[1][p]) for p in runs[0])


def test_unported_training_inputs_raise_naming_their_slice(tmp_path):
    # the load path is ported: without a frozen bundle the checkpoint directory must be named
    with pytest.raises(ValueError, match="sd_path"):
        TCLI.run_training(_cfg(tmp_path), device="cpu")
    # the data path is ported: without images the dataset option is named
    with pytest.raises(ValueError, match="dataset_txt_or_dir_paths"):
        import omgsr_tpu_torch.convert.params as P

        TCLI.run_training(_cfg(tmp_path), frozen=_frozen_from_seed(), device="cpu",
                          disc_bundle=P.init_discriminator(0, T_CN.dims[:3], 64, torch.float32, "cpu",
                                                           configs=HEADS))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TCLI.run_training(_cfg(tmp_path), frozen=_frozen_from_seed(), loader=[])
