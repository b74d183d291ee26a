"""LoRA-GAN trainers for OMGSR-S and OMGSR-F.

One train step re-implementing the reference's loop body
(train/train_omgsr_s.py:438-491, train/train_omgsr_f.py:528-591), as the JAX
package's trainers do:

  G step: hq -> frozen-VAE latent, noised to the mid-timestep; lq -> LoRA-VAE
  latent; LRR latent-MSE; one-step denoiser prediction -> decoded image;
  DISTS + L1 + GAN-G losses; AdamW on the LoRA params with global-norm clip.

  D step: multi-level discriminator BCE on detached prediction (fake) and hq
  (real); AdamW on the head params.

Deliberate divergences from the reference, kept from the JAX package: the
G-step's discriminator-head gradients do NOT leak into the D update (the
reference forgets to zero them, train_omgsr_s.py:465-491): each step takes
``torch.autograd.grad`` with respect to its own leaves only, and the heads
enter the G loss detached; spectral-norm u vectors update once per D forward
pair rather than on the G forward too.

Every random number of a step is explicit: ``StepNoise`` holds the two latent
sampling noises, the mid-timestep noise and the three sets of DiffAugment
draws; ``draw_step_noise`` makes them from a ``torch.Generator``. Frozen
parameters must not require grad.

On a world of processes (one per GPU, ``parallel.create_mesh``) each rank
runs its rows of the global batch (``parallel.sharding.data_rows``; the
batch is replicated over an "fsdp" axis) and of the global ``StepNoise``
(``step_noise_rows``); the G and D gradients are averaged over the mesh's
"data" group before the optimizers see them, so the global-norm clip and
the reported norms are the global gradient's, and the ten metrics are
averaged over "data" in one collective. The state starts as rank 0's on
every rank (``broadcast_tree``) and stays equal: every rank applies the same
averaged update, and the spectral-norm u vectors depend on the heads alone.
The frozen UNet or DiT may be placed by FSDP (``shard_params_fsdp``); its
apply gathers each block as it enters it, and again in its recompute. The
JAX package gets the same step from XLA's gradient psum over a "data" mesh
axis; here the collectives are written by hand because the gradients are
taken with ``torch.autograd.grad`` over trees that no
``DistributedDataParallel`` module sees.

Under ``cfg.gradient_checkpointing`` both trainers recompute the LoRA encode
and the decode. ``TrainerF`` also recomputes the DiT block by block
(``FluxConfig.remat_blocks``: one saved carry a block, the JAX package's
scan-stacked semantics; it wraps the whole apply only for an unstacked tree,
which here would hold every block's internals during the recomputed forward)
and every VAE resnet of the differentiated encode and decode
(``VAEConfig.remat_blocks``). ``TrainerS`` keeps the whole-stage recompute
without the per-resnet one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from omgsr_tpu_torch.config import TrainConfig
from omgsr_tpu_torch.diffusion.packing import latent_image_ids, pack_latents, unpack_latents
from omgsr_tpu_torch.diffusion.schedules import ddpm_alphas_cumprod, flux_sigma_at_mid_timestep
from omgsr_tpu_torch.lora import attach_lora
from omgsr_tpu_torch.losses.diffaug import DiffAugDraws, draw_diffaug
from omgsr_tpu_torch.losses.discriminator import discriminator_loss
from omgsr_tpu_torch.losses.dists import dists_loss
from omgsr_tpu_torch.models import flux as flux_mod
from omgsr_tpu_torch.models import unet_sd, vae
from omgsr_tpu_torch.parallel.distributed import all_reduce_mean_tree, broadcast_tree
from omgsr_tpu_torch.parallel.sharding import Sharding, uses_fsdp
from omgsr_tpu_torch.training.optim import global_norm, make_optimizer
from omgsr_tpu_torch.utils.tree import flatten_dict, unflatten_dict


def l1_loss(a, b):
    return (a.float() - b.float()).abs().mean()


def mse_loss(a, b):
    d = a.float() - b.float()
    return (d * d).mean()


def _vae_cfg_for_grad(cfg, vae_cfg):
    """The VAE config of TrainerF's differentiated path: per-resnet recompute
    under gradient checkpointing (the 1024-px decode's backward otherwise
    holds about 0.5 GB of intermediates per GroupNorm and conv)."""
    if not cfg.gradient_checkpointing:
        return vae_cfg
    return dataclasses.replace(vae_cfg, remat_blocks=True)


class StepNoise(NamedTuple):
    """The random numbers of one train step. hq, lq: standard normals of the
    latent's shape for the two VAE-encoder samples; noise: the standard
    normal mixed into the hq latent at the mid-timestep; disc_g, disc_fake,
    disc_real: DiffAugment draws of the three discriminator forwards."""

    hq: torch.Tensor
    noise: torch.Tensor
    lq: torch.Tensor
    disc_g: DiffAugDraws
    disc_fake: DiffAugDraws
    disc_real: DiffAugDraws


def draw_step_noise(generator: torch.Generator, image_shape, latent_shape, device, dtype) -> StepNoise:
    """A ``StepNoise`` for a batch of images (B,H,W,3) and latents (B,h,w,C)
    from ``generator``, which must live on ``device``."""
    def normal():
        z = torch.randn(latent_shape, generator=generator, device=device, dtype=torch.float32)
        return z.to(dtype)

    hq, noise, lq = normal(), normal(), normal()
    return StepNoise(hq, noise, lq, *(draw_diffaug(generator, image_shape, device, dtype)
                                      for _ in range(3)))


def step_noise_rows(noise: StepNoise, start: int, count: int) -> StepNoise:
    """Rows [start, start + count) of every field of a global ``StepNoise``
    (all of them lead with the batch)."""
    def rows(t):
        return t.narrow(0, start, count)

    return StepNoise(rows(noise.hq), rows(noise.noise), rows(noise.lq),
                     *(DiffAugDraws(*map(rows, d)) for d in (noise.disc_g, noise.disc_fake, noise.disc_real)))


def _tree_map(fn, tree):
    return unflatten_dict({p: fn(v) for p, v in flatten_dict(tree).items()})


def grads_of(loss, tree):
    """d loss / d leaf for every leaf of ``tree``, as a tree; a leaf the loss
    does not reach gets zeros (as jax.grad gives)."""
    flat = flatten_dict(tree)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return unflatten_dict({
        p: (torch.zeros_like(v) if g is None else g) for (p, v), g in zip(flat.items(), grads)
    })


class BaseTrainer:
    """Shared G/D optimization skeleton; subclasses provide encode/predict."""

    def __init__(self, cfg: TrainConfig, frozen, gen_lora, disc_bundle, mesh=None):
        """frozen: dict with model params/cfgs the step reads (tensors that
        do not require grad). gen_lora: {"vae_encoder": tree, "denoiser":
        tree}. disc_bundle: (disc_params, sn_state, strides_meta). The
        trainer owns gen_lora, disc_params and sn_state from here on and
        updates them in place. mesh: the ``parallel.sharding.Mesh`` of a
        world of processes (every rank then builds its trainer, and steps,
        in lockstep): the state is broadcast from rank 0, and the gradients
        and metrics are averaged over its "data" axis, if it has one; where
        it has "fsdp", the frozen UNet / DiT is one that
        ``shard_params_fsdp`` placed, and its apply gathers it."""
        self.cfg = cfg
        self.frozen = frozen
        self.mesh = mesh
        self.sharding = Sharding() if uses_fsdp(mesh) else None
        self.data_group = mesh.group("data") if mesh is not None and "data" in mesh.axis_names else None
        disc_params, sn_state, self.disc_meta = disc_bundle
        self.gen_tx = make_optimizer(cfg)
        self.disc_tx = make_optimizer(cfg)
        gen_lora = _tree_map(lambda v: v.detach().requires_grad_(True), gen_lora)
        disc_params = _tree_map(lambda v: v.detach().requires_grad_(True), disc_params)
        self.state = {
            "step": 0,
            "gen": {"lora": gen_lora, "opt": self.gen_tx.init(gen_lora)},
            "disc": {
                "params": disc_params,
                "sn": _tree_map(lambda v: v.detach(), sn_state),
                "opt": self.disc_tx.init(disc_params),
            },
        }
        if mesh is not None:
            broadcast_tree(self.state)

    # ---- model hooks -------------------------------------------------------
    def encode_fixed(self, frozen, img, noise):
        raise NotImplementedError

    def encode_lora(self, frozen, lora_vae_encoder, img, noise):
        raise NotImplementedError

    def noisy_latent(self, hq_latent, noise):
        raise NotImplementedError

    def one_step_pred(self, frozen, lora_denoiser, lq_latent):
        raise NotImplementedError

    def _checkpointed(self, fn):
        """``fn`` under activation recomputation when the config asks for it
        (the JAX package's jax.checkpoint at the same functions)."""
        if not self.cfg.gradient_checkpointing:
            return fn
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)

    # ---- train step --------------------------------------------------------
    def _gen_loss(self, lora, batch, noise: StepNoise, frozen, disc_params, disc_sn):
        cfg = self.cfg
        lq, hq = batch["lq"], batch["hq"]
        with torch.no_grad():
            hq_latent = self.encode_fixed(frozen, hq, noise.hq)
            noisy = self.noisy_latent(hq_latent, noise.noise.to(hq_latent.dtype))
        lq_latent = self.encode_lora(frozen, lora["vae_encoder"], lq, noise.lq)

        loss_lrr = mse_loss(noisy, lq_latent) * cfg.lambda_LRR
        pred = self.one_step_pred(frozen, lora["denoiser"], lq_latent)
        meta = self.disc_meta

        def disc_g(x):
            # the heads enter detached: no G-step gradient reaches them, and
            # the new u vectors of this forward are dropped
            heads = _tree_map(lambda v: v.detach(), disc_params)
            return discriminator_loss(heads, disc_sn, meta, frozen["backbone"], noise.disc_g, x,
                                      for_G=True)[0]

        def dists(x):
            return dists_loss(frozen["dists"], x, hq)

        loss_dv3d = self._checkpointed(dists)(pred) * cfg.lambda_Dv3D
        loss_l1 = l1_loss(pred, hq) * cfg.lambda_L1
        loss_g = self._checkpointed(disc_g)(pred) * cfg.lambda_GAN
        total = loss_lrr + loss_dv3d + loss_l1 + loss_g
        metrics = {
            "loss_LRR": loss_lrr,
            "loss_Dv3D": loss_dv3d,
            "loss_L1": loss_l1,
            "loss_G": loss_g,
        }
        return total, (metrics, pred)

    def _disc_loss(self, disc_params, sn, fake, real, noise: StepNoise, frozen):
        cfg = self.cfg
        l_fake, sn = discriminator_loss(
            disc_params, sn, self.disc_meta, frozen["backbone"], noise.disc_fake, fake,
            for_real=False,
        )
        l_real, sn = discriminator_loss(
            disc_params, sn, self.disc_meta, frozen["backbone"], noise.disc_real, real,
            for_real=True,
        )
        total = l_fake * cfg.lambda_GAN + l_real * cfg.lambda_GAN
        return total, (sn, {"loss_D_fake": l_fake * cfg.lambda_GAN, "loss_D_real": l_real * cfg.lambda_GAN})

    def data_mean(self, tree):
        """``tree``'s leaves averaged over the "data" group (one collective);
        ``tree`` itself without one."""
        return tree if self.data_group is None else all_reduce_mean_tree(tree, self.data_group)

    def train_step(self, batch, noise: StepNoise):
        """One micro-step. batch: {"lq": (B,H,W,3), "hq": (B,H,W,3)} in
        [-1,1], with ``noise`` this rank's rows of the global batch on a
        "data" axis. Returns (metrics, pred): ten scalar tensors (six
        losses, two totals, the pre-clip global norms of the two micro-step
        gradients), the global batch's on every rank, and this rank's
        detached prediction."""
        state, frozen = self.state, self.frozen
        lora, heads = state["gen"]["lora"], state["disc"]["params"]

        g_total, (g_metrics, pred) = self._gen_loss(
            lora, batch, noise, frozen, heads, state["disc"]["sn"])
        g_grads = self.data_mean(grads_of(g_total, lora))
        fake = pred.detach()
        del pred
        self.gen_tx.update(g_grads, state["gen"]["opt"], lora)

        d_total, (sn, d_metrics) = self._disc_loss(
            heads, state["disc"]["sn"], fake, batch["hq"], noise, frozen)
        d_grads = self.data_mean(grads_of(d_total, heads))
        self.disc_tx.update(d_grads, state["disc"]["opt"], heads)
        state["disc"]["sn"] = sn
        state["step"] += 1

        metrics = {"loss_total_G": g_total, "loss_total_D": d_total}
        metrics.update(g_metrics)
        metrics.update(d_metrics)
        metrics = self.data_mean({k: v.detach() for k, v in metrics.items()})
        # pre-clip global grad norms: the observability signal for GAN balance
        metrics["grad_norm_G"] = global_norm(g_grads)
        metrics["grad_norm_D"] = global_norm(d_grads)
        return {k: v.detach() for k, v in metrics.items()}, fake


class TrainerS(BaseTrainer):
    """OMGSR-S: SD2.1 UNet, DDPM mid-timestep 273 (train/train_omgsr_s.py)."""

    def __init__(self, cfg, frozen, gen_lora, disc_bundle, mesh=None):
        a = float(ddpm_alphas_cumprod()[cfg.mid_timestep])
        self.sqrt_a = math.sqrt(a)
        self.sqrt_1ma = math.sqrt(1 - a)
        super().__init__(cfg, frozen, gen_lora, disc_bundle, mesh)

    def encode_fixed(self, frozen, img, noise):
        return vae.vae_encode(frozen["vae"], frozen["vae_cfg"], img, noise=noise)

    def encode_lora(self, frozen, lora_enc, img, noise):
        params = dict(frozen["vae"])
        params["encoder"] = attach_lora(frozen["vae"]["encoder"], lora_enc)
        # lora_vae.enable_gradient_checkpointing parity (train/train_omgsr_s.py:256-258)
        encode = self._checkpointed(
            lambda x, z: vae.vae_encode(params, frozen["vae_cfg"], x, noise=z))
        return encode(img, noise)

    def noisy_latent(self, hq_latent, noise):
        return self.sqrt_a * hq_latent + self.sqrt_1ma * noise

    def one_step_pred(self, frozen, lora_unet, lq_latent):
        unet_params = attach_lora(frozen["unet"], lora_unet)
        ctx = frozen["prompt_embeds"].to(lq_latent.dtype)
        ctx = ctx.expand((lq_latent.shape[0],) + tuple(ctx.shape[-2:]))
        apply = self._checkpointed(
            lambda z: unet_sd.unet_apply(unet_params, frozen["unet_cfg"], z, self.cfg.mid_timestep, ctx,
                                         sharding=self.sharding))
        eps = apply(lq_latent)
        x0 = (lq_latent - self.sqrt_1ma * eps) / self.sqrt_a
        decode = self._checkpointed(lambda z: vae.vae_decode(frozen["vae"], frozen["vae_cfg"], z))
        return torch.clamp(decode(x0), -1.0, 1.0)


class TrainerF(BaseTrainer):
    """OMGSR-F: FLUX DiT, flow-matching sigma at mid-timestep 244
    (train/train_omgsr_f.py; the intended behaviour at :247 and :540, not the
    shipped NameError / missing argument)."""

    def __init__(self, cfg, frozen, gen_lora, disc_bundle, mesh=None):
        self.sigma_t = flux_sigma_at_mid_timestep(cfg.mid_timestep)
        super().__init__(cfg, frozen, gen_lora, disc_bundle, mesh)

    def encode_fixed(self, frozen, img, noise):
        return vae.vae_encode(frozen["vae"], frozen["vae_cfg"], img, noise=noise)

    def encode_lora(self, frozen, lora_enc, img, noise):
        params = dict(frozen["vae"])
        params["encoder"] = attach_lora(frozen["vae"]["encoder"], lora_enc)
        vae_cfg = _vae_cfg_for_grad(self.cfg, frozen["vae_cfg"])
        encode = self._checkpointed(lambda x, z: vae.vae_encode(params, vae_cfg, x, noise=z))
        return encode(img, noise)

    def noisy_latent(self, hq_latent, noise):
        return (1.0 - self.sigma_t) * hq_latent + self.sigma_t * noise

    def one_step_pred(self, frozen, lora_flux, lq_latent):
        flux_params = attach_lora(frozen["flux"], lora_flux)
        b, h, w, _ = lq_latent.shape
        packed = pack_latents(lq_latent)
        img_ids = latent_image_ids(h // 2, w // 2, device=lq_latent.device)
        ctx = frozen["prompt_embeds"].to(lq_latent.dtype)
        ctx = ctx.expand((b,) + tuple(ctx.shape[-2:]))
        pooled = frozen["pooled_prompt_embeds"].to(lq_latent.dtype)
        pooled = pooled.expand((b,) + tuple(pooled.shape[-1:]))
        txt_ids = torch.zeros((ctx.shape[1], 3), dtype=torch.float32, device=lq_latent.device)
        flux_cfg = frozen["flux_cfg"]
        if self.cfg.gradient_checkpointing:
            flux_cfg = dataclasses.replace(flux_cfg, remat_blocks=True)
        v = flux_mod.flux_apply(flux_params, flux_cfg, packed, self.sigma_t, 1.0, pooled, ctx, txt_ids, img_ids,
                                sharding=self.sharding)
        z0 = unpack_latents(packed - self.sigma_t * v, h, w)
        dec_cfg = _vae_cfg_for_grad(self.cfg, frozen["vae_cfg"])
        # the -F reference decodes without clamping (train/train_omgsr_f.py:525)
        return self._checkpointed(lambda z: vae.vae_decode(frozen["vae"], dec_cfg, z))(z0)
