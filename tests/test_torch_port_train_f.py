"""OMGSR-F training in the port against the JAX package, fp32 on the CPU: three
``TrainerF.train_step``s at gradient accumulation 2 on bridged weights with
shared batch, noise and DiffAugment draws (the JAX step compiled once with
XLA's optimisation passes off, its random numbers replayed from its keys, as
in tests/test_torch_port_trainer.py); the per-block and per-resnet recompute
against the plain step; ``train_omgsr_f.run_training`` (metrics, checkpoint,
resume, and the -F adapters against the JAX export, byte for byte);
``train_omgsr_f.main`` from a tiny FLUX.1-dev directory with its text
encoders; and the refusal of a quantised base.

The tiny DiT has head dim 64, so both of its attention sites go through the
flash-attention autograd function (its plain versions on the CPU)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omgsr_tpu.config import TrainConfig as JTrainConfig
from omgsr_tpu.losses.discriminator import init_discriminator as j_init_discriminator
from omgsr_tpu.losses.dists import init_dists as j_init_dists
from omgsr_tpu.models import convnext as JCN
from omgsr_tpu.models import flux as JF
from omgsr_tpu.models import vae as JV
from omgsr_tpu.models.configs import FluxConfig as JFluxConfig
from omgsr_tpu.training.trainer import TrainerF as JTrainerF
from omgsr_tpu_torch.cli import train_omgsr_f as FCLI
from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.convert.params import init_convnext, init_flux, init_vae
from omgsr_tpu_torch.losses.dists import init_dists
from omgsr_tpu_torch.models.configs import FluxConfig
from omgsr_tpu_torch.ops import flash_attention as TFA
from omgsr_tpu_torch.training import checkpoint as TCKPT
from omgsr_tpu_torch.training.trainer import TrainerF, draw_step_noise
from omgsr_tpu_torch.utils.tree import flatten_dict
from tests.test_torch_port_trainer import (
    HEADS,
    J_CN,
    METRICS,
    STEP_TOL,
    T_CN,
    _assert_tree_close,
    _replay_noise,
)
from tests.torch_port_helpers import (
    assert_close,
    bridge,
    jax_init,
    jax_lora_tree,
    t,
    tiny_flux_configs,
    write_tiny_flux_checkpoint,
)

J_VAE, T_VAE, _, _ = tiny_flux_configs()
# one dual and one single block at head dim 64: two flash-attention sites a forward
_FLUX = dict(num_layers=1, num_single_layers=1, attention_head_dim=64, num_attention_heads=2,
             joint_attention_dim=16, pooled_projection_dim=8, axes_dims_rope=(8, 28, 28))
J_FLUX, T_FLUX = JFluxConfig(**_FLUX), FluxConfig(**_FLUX)
RES, BATCH = 64, 2
LATENT = (BATCH, RES // J_VAE.downscale, RES // J_VAE.downscale, J_VAE.latent_channels)
N_SITES = T_FLUX.num_layers + T_FLUX.num_single_layers
KW = dict(model="omgsr_f_1024", mid_timestep=244, gradient_accumulation_steps=2, lr_warmup_steps=0,
          learning_rate=1e-3)


def _batch(seed, b=BATCH):
    rng = np.random.default_rng(seed)
    return {k: np.tanh(rng.standard_normal((b, RES, RES, 3))).astype(np.float32) for k in ("lq", "hq")}


@pytest.fixture(scope="module")
def bundle():
    """The JAX-layout frozen bundle, LoRA and discriminator, from numpy draws."""
    vp = jax_init(JV.init_vae, 0, J_VAE)
    fp = jax_init(JF.init_flux, 1, J_FLUX)
    bp = jax_init(lambda k, c: JCN.init_convnext(k, c), 2, J_CN)
    bp = jax.tree_util.tree_map_with_path(lambda p, v: v + 0.5 if p[-1].key == "gamma" else v, bp)
    rng = np.random.default_rng(3)
    frozen = {"vae": vp, "vae_cfg": J_VAE, "flux": fp, "flux_cfg": J_FLUX, "backbone": bp,
              "dists": j_init_dists(bp, J_CN.dims),
              "prompt_embeds": jnp.asarray(rng.standard_normal((1, 5, 16)).astype(np.float32)),
              "pooled_prompt_embeds": jnp.asarray(rng.standard_normal((1, 8)).astype(np.float32))}
    from omgsr_tpu.lora import FLUX_TARGET_MODULES

    lora = {"vae_encoder": jax_lora_tree(vp["encoder"], 2, seed=4),
            "denoiser": jax_lora_tree(fp, 2, seed=5, targets=FLUX_TARGET_MODULES)}
    shapes = jax.eval_shape(lambda k: j_init_discriminator(k, J_CN.dims[:3], configs=HEADS)[:2],
                            jax.random.key(0))
    dparams, dsn = jax.tree.map(
        lambda leaf: jnp.asarray((rng.standard_normal(leaf.shape) * 0.3).astype(np.float32)), shapes)
    meta = {str(i): list(HEADS[i][1]) for i in range(3)}
    return frozen, lora, (dparams, dsn, meta)


def _port_bundle(bundle):
    frozen, lora, disc = bundle
    bp = bridge(frozen["backbone"])
    tfrozen = {"vae": bridge(frozen["vae"]), "vae_cfg": T_VAE, "flux": bridge(frozen["flux"]), "flux_cfg": T_FLUX,
               "backbone": bp, "dists": init_dists(bp, T_CN.dims),
               "prompt_embeds": t(np.asarray(frozen["prompt_embeds"])),
               "pooled_prompt_embeds": t(np.asarray(frozen["pooled_prompt_embeds"]))}
    return tfrozen, {k: bridge(v) for k, v in lora.items()}, (bridge(disc[0]), bridge(disc[1]), disc[2])


def test_train_f_steps_match_jax(bundle):
    """Three micro-steps at accumulation 2 (the first changes no parameter,
    the second applies the update, the third runs on the updated leaves).
    After each: all ten metrics, pred, LoRA leaves, heads and u. The flash
    backward runs once per attention site and micro-step."""
    frozen, lora, disc = bundle
    kw = dict(KW)
    jtr = JTrainerF(JTrainConfig(**kw), frozen, lora, disc)
    tfrozen, tlora, tdisc = _port_bundle(bundle)
    ttr = TrainerF(TrainConfig(**kw), tfrozen, tlora, tdisc)
    assert ttr.sigma_t == jtr.sigma_t
    frozen_before = {p: v.clone() for p, v in flatten_dict(tfrozen["flux"]).items()}

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
            jstate, (jmetrics, jpred) = jstep(
                jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key, jtr._frozen_arrays)
            metrics, pred = ttr.train_step({k: t(v) for k, v in batch.items()},
                                           _replay_noise(key, batch["hq"].shape, LATENT))
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
    finally:
        TFA.flash_attention_bwd = real_bwd
    assert len(bwd_calls) == 3 * N_SITES
    for p, v in flatten_dict(tfrozen["flux"]).items():
        assert torch.equal(v, frozen_before[p]) and v.grad is None and not v.requires_grad


def test_recompute_gives_the_same_step(bundle):
    """gradient_checkpointing (the DiT block by block, every resnet of the LoRA
    encode and the decode, and both stages whole) changes no number beyond
    summation order (1e-5); the flash forward runs once more per site in the
    recompute, the backward once per site either way."""
    results = []
    for ckpt in (False, True):
        tfrozen, tlora, tdisc = _port_bundle(bundle)
        tr = TrainerF(TrainConfig(**dict(KW, gradient_accumulation_steps=1, gradient_checkpointing=ckpt)),
                      tfrozen, tlora, tdisc)
        batch = {k: t(v)[:1] for k, v in _batch(31).items()}
        noise = draw_step_noise(torch.Generator().manual_seed(1), batch["hq"].shape, (1, *LATENT[1:]), "cpu",
                                torch.float32)
        calls = {"fwd": 0, "bwd": 0}
        real_fwd, real_bwd = TFA._forward, TFA.flash_attention_bwd

        def fwd(*a):
            calls["fwd"] += 1
            return real_fwd(*a)

        def bwd(*a):
            calls["bwd"] += 1
            return real_bwd(*a)

        TFA._forward, TFA.flash_attention_bwd = fwd, bwd
        try:
            metrics, pred = tr.train_step(batch, noise)
        finally:
            TFA._forward, TFA.flash_attention_bwd = real_fwd, real_bwd
        assert calls == {"fwd": N_SITES * (2 if ckpt else 1), "bwd": N_SITES}, (ckpt, calls)
        results.append((metrics, pred, flatten_dict(tr.state["gen"]["lora"])))
    (m0, p0, l0), (m1, p1, l1) = results
    for k in m0:
        assert abs(float(m0[k]) - float(m1[k])) <= 1e-5 * max(abs(float(m0[k])), 1.0), k
    assert_close(p1, p0.numpy(), 1e-5)
    for path in l0:
        assert_close(l1[path], l0[path].detach().numpy(), 1e-5, ".".join(path))


# ----------------------------------------------------------------------------
# run_training, checkpoint, resume, the adapters; main from a directory
# ----------------------------------------------------------------------------


def _frozen_from_seed():
    bp = init_convnext(2, T_CN, torch.float32, "cpu")
    rng = np.random.default_rng(3)
    return {"vae": init_vae(0, T_VAE, torch.float32, "cpu"), "vae_cfg": T_VAE,
            "flux": init_flux(1, T_FLUX, torch.float32, "cpu"), "flux_cfg": T_FLUX, "backbone": bp,
            "dists": init_dists(bp, T_CN.dims),
            "prompt_embeds": t(rng.standard_normal((1, 5, 16)).astype(np.float32)),
            "pooled_prompt_embeds": t(rng.standard_normal((1, 8)).astype(np.float32))}


def _small_heads(monkeypatch):
    import omgsr_tpu_torch.convert.params as P

    real_init = P.init_discriminator
    monkeypatch.setattr(P, "init_discriminator", lambda seed, ch, res, dtype, device, configs=None: real_init(
        seed, ch, res, dtype, device, configs=HEADS))


def _cfg(tmp_path, **kw):
    base = dict(model="omgsr_f_1024", output_dir=str(tmp_path / "run"), mixed_precision="no", resolution=RES,
                gradient_accumulation_steps=2, lr_warmup_steps=0, learning_rate=1e-3, vae_lora_rank=2,
                flux_transformer_lora_rank=2, max_train_steps=2, checkpointing_steps=1, save_img_steps=1000,
                seed=7, gradient_checkpointing=True,
                extra={"disc_channels": list(T_CN.dims[:3]), "metrics_jsonl": str(tmp_path / "metrics.jsonl")})
    base.update(kw)
    return TrainConfig(**base)


def test_run_training_saves_resumes_and_exports_the_jax_adapters(tmp_path, monkeypatch):
    from omgsr_tpu.training.checkpoint import export_adapters as j_export_adapters

    from omgsr_tpu_torch.convert.params import to_jax_tree

    _small_heads(monkeypatch)
    loader = [{k: v[:1] for k, v in _batch(40 + i).items()} for i in range(3)]
    cfg = _cfg(tmp_path)
    tr = FCLI.run_training(cfg, frozen=_frozen_from_seed(), loader=loader, device="cpu")
    assert tr.state["step"] == 4 and tr.state["gen"]["opt"]["count"] == 2
    lines = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [line["step"] for line in lines] == [1, 2]
    assert all(np.isfinite(line[k]) for line in lines for k in METRICS)
    assert TCKPT._checkpoint_steps(cfg.output_dir) == [1, 2]

    # the -F adapters: the reference's names, and the JAX export's bytes for the same LoRA tree
    names = {"vae_encoder": "vae_encoder_adapter", "denoiser": "flux_adapter"}
    jax_lora = {k: to_jax_tree(v) for k, v in tr.state["gen"]["lora"].items()}
    j_export_adapters(str(tmp_path / "jax"), 2, jax_lora, JTrainConfig(**{
        k: getattr(cfg, k) for k in ("model", "vae_lora_rank", "flux_transformer_lora_rank")}), names)
    for name in names.values():
        for f in ("adapter_config.json", "adapter_model.safetensors"):
            ours = (tmp_path / "run" / "weight-2" / name / f).read_bytes()
            assert ours == (tmp_path / "jax" / "weight-2" / name / f).read_bytes(), (name, f)

    # resume continues the micro-step count from the latest checkpoint
    cfg2 = _cfg(tmp_path, max_train_steps=3, resume_from_checkpoint="latest")
    tr2 = FCLI.run_training(cfg2, frozen=_frozen_from_seed(), loader=loader, device="cpu")
    assert tr2.state["step"] == 6 and tr2.state["gen"]["opt"]["count"] == 3
    assert [json.loads(line)["step"] for line in open(tmp_path / "metrics.jsonl")] == [1, 2, 3]
    assert os.path.isdir(tmp_path / "run" / "weight-3" / "flux_adapter")


def test_train_main_trains_from_a_flux_directory(tmp_path, monkeypatch):
    """train_omgsr_f.main --config from a tiny FLUX.1-dev directory: the
    frozen bundle ported from it and the fixed prompt "" encoded by its T5 and
    CLIP-L, the pairs from a folder of images through the Real-ESRGAN loader."""
    from PIL import Image

    from omgsr_tpu_torch.cli.prompts import encode_prompt_flux
    from omgsr_tpu_torch.config import save_config

    from omgsr_tpu_torch.models import configs as CFG

    _small_heads(monkeypatch)
    monkeypatch.setitem(CFG.CONVNEXT_SIZES, "micro", T_CN)
    root = tmp_path / "flux"
    write_tiny_flux_checkpoint(root)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (80, 72, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    cfg = TrainConfig(**{**vars(_cfg(tmp_path)), "flux_path": str(root), "fixed_prompt": "",
                         "dataset_txt_or_dir_paths": [str(imgs)], "train_batch_size": 1,
                         "dinov3_convnext_size": "micro", "extra": {"metrics_jsonl": str(tmp_path / "m.jsonl")}})
    save_config(cfg, str(tmp_path / "cfg.yml"))
    seen = {}
    real_trainer = FCLI.run_training

    def spy(c, **k):
        tr = real_trainer(c, **k)
        seen["trainer"] = tr
        return tr

    monkeypatch.setattr(FCLI, "run_training", spy)
    FCLI.main(["--config", str(tmp_path / "cfg.yml"), "--device", "cpu", "vae_lora_rank=2"])
    tr = seen["trainer"]
    assert tr.state["step"] == 4 and tr.frozen["flux_cfg"].attention_head_dim == 8
    embeds, pooled, _ = encode_prompt_flux(str(root), "", dtype=torch.float32, device="cpu")
    assert torch.equal(tr.frozen["prompt_embeds"], embeds) and torch.equal(tr.frozen["pooled_prompt_embeds"], pooled)
    assert tr.frozen["prompt_embeds"].shape == (1, 512, 16)
    assert [json.loads(line)["step"] for line in open(tmp_path / "m.jsonl")] == [1, 2]
    assert sorted(os.listdir(tmp_path / "run" / "weight-2")) == ["flux_adapter", "vae_encoder_adapter"]


def test_quantized_base_raises_naming_its_slice(tmp_path, monkeypatch):
    """The quantised base is ported: int8 / int4 build a frozen DiT of codes
    from a directory (tests/test_torch_port_quantize.py holds a step on it
    against the JAX package), and what is not a storage mode is refused. The
    tiny DiT's layers are below the default min_params, so it is lowered."""
    import functools

    from omgsr_tpu_torch.models import configs as CFG
    from omgsr_tpu_torch.utils import quantize as TQ

    monkeypatch.setitem(CFG.CONVNEXT_SIZES, "micro", T_CN)
    monkeypatch.setattr(TQ, "quantize_flux_for_serving", functools.partial(TQ.quantize_flux_for_serving,
                                                                           min_params=64))
    root = tmp_path / "flux"
    write_tiny_flux_checkpoint(root)
    for bits, key in (("int8", "weight_q"), ("int4", "weight_q4")):
        frozen, _ = FCLI.build_frozen_f(_cfg(tmp_path, quantize_base=bits, flux_path=str(root),
                                             dinov3_convnext_size="micro"), torch.float32, "cpu")
        to_q = frozen["flux"]["transformer_blocks"]["0"]["attn"]["to_q"]
        assert key in to_q and "weight" not in to_q, bits
    with pytest.raises(ValueError, match="w8a8 is inference-only"):
        FCLI.build_frozen_f(_cfg(tmp_path, quantize_base="int8_w8a8", flux_path=str(root)), torch.float32, "cpu")
    with pytest.raises(ValueError, match="flux_path"):
        FCLI.build_frozen_f(_cfg(tmp_path), torch.float32, "cpu")


def test_published_config_gives_numbers():
    """omgsr_f_1024.yml's learning_rate 5e-5 (and the Adam decay and epsilon)
    are strings to YAML 1.1: the port's loader gives the numbers, the JAX
    package's hands the strings on (its optimizer then fails on them)."""
    from omgsr_tpu.config import load_config as j_load_config
    from omgsr_tpu_torch.config import load_config

    cfg = load_config(FCLI.DEFAULT_CONFIG, ["max_train_steps=3"])
    import omgsr_tpu

    jcfg = j_load_config(os.path.join(os.path.dirname(omgsr_tpu.__file__), "configs", "omgsr_f_1024.yml"))
    assert (cfg.learning_rate, cfg.adam_weight_decay, cfg.adam_epsilon) == (5e-5, 1e-4, 1e-8)
    assert (jcfg.learning_rate, jcfg.adam_weight_decay, jcfg.adam_epsilon) == ("5e-5", "1e-4", "1e-08")
    assert cfg.is_flux and cfg.max_train_steps == 3 and cfg.gradient_checkpointing
    assert {k: v for k, v in vars(cfg).items() if k not in ("learning_rate", "adam_weight_decay", "adam_epsilon",
                                                             "max_train_steps")} == \
        {k: v for k, v in vars(jcfg).items() if k not in ("learning_rate", "adam_weight_decay", "adam_epsilon",
                                                           "max_train_steps")}
