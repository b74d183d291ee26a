"""DINOv3 SSL pretraining CLI: the end-to-end loop over the SSL stack.

    python -m omgsr_tpu_torch.cli.pretrain_dinov3 --config cfg.yml [key=value ...]

The port of ``omgsr_tpu/cli/pretrain_dinov3.py`` (dinov3/train/train.py:
get_args_parser:57-99, build_schedulers:102-152, apply_optim_scheduler
:227-236, do_train:382-560):

- One step function per iteration (``training/ssl_meta_arch``): teacher and
  student forwards, every loss, the gradients, the SSL optimizer, the EMA
  teacher and the center EMA. f32 master parameters; with
  ``mixed_precision: bf16`` the crops go to the card in bf16 and every layer
  casts its parameters to bf16 at the call.
- Schedules are precomputed numpy tables indexed by iteration; the last-layer
  lr freeze (train.py:142-147) drives the prototype layers.
- One process on one device (``device``, default "cuda"; "cpu" runs the
  plain versions of the kernels). A torchrun world of more than one process
  raises: the data-parallel SSL step is ROADMAP Queue 1 item 3.2b.
- Host multi-crop augmentation in one background thread per crop
  resolution, one batch ahead; randomness from one np.random.Generator
  seeded with (seed, iteration), so a resumed run replays the same crops.
  The time the loop waits for a batch is recorded per iteration.
- Full-state checkpoints (student, teacher, optimizer, centers, iteration)
  through ``training/checkpoint.py`` (one ``torch.save`` file per saved
  iteration), and a teacher-backbone export, a ``torch.save`` of the
  backbone tree that ``restore_train_state`` reads back into an
  ``init_dinov3_vit`` tree.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import math
import os
import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger("omgsr_tpu_torch.pretrain_dinov3")


@dataclasses.dataclass
class SSLPretrainConfig:
    """Flat-key mirror of ssl_default_config.yaml's train / optim / teacher /
    crops / ibot / gram sections (the knobs the stack reads), plus
    ``device``."""

    # train
    output_dir: str = "output_ssl"
    dataset_paths: Any = None  # dir | list of dirs | .txt list | dataset spec
    batch_size_per_device: int = 4
    official_epoch_length: int = 1250
    seed: int = 0
    saveckp_freq: int = 500  # iterations between checkpoints
    print_freq: int = 10
    resume: bool = True
    mixed_precision: str = "bf16"  # the crops' compute dtype; parameters stay f32
    sampler: str = "infinite"  # infinite | sharded_infinite | epoch
    device: str = "cuda"
    # student backbone
    arch: str = "vits16"  # key into models.configs.VIT_SIZES, or "custom" with a vit: override
    # hub .pth to initialise the student backbone from (student.resume_from_teacher_chkpt)
    student_init_checkpoint: str = ""
    # optim
    epochs: int = 100
    warmup_epochs: int = 10
    lr: float = 0.004
    min_lr: float = 1.0e-6
    scaling_rule: str = "sqrt_wrt_1024"  # sqrt_wrt_1024 | linear_wrt_256 | none
    weight_decay: float = 0.04
    weight_decay_end: float = 0.4
    freeze_last_layer_epochs: int = 1
    clip_grad: float = 3.0
    layerwise_decay: float = 0.9
    patch_embed_lr_mult: float = 0.2
    dino_head_wd_multiplier: float = 1.0
    adamw_beta1: float = 0.9
    adamw_beta2: float = 0.999
    # teacher
    momentum_teacher: float = 0.992
    final_momentum_teacher: float = 1.0
    warmup_teacher_temp: float = 0.04
    teacher_temp: float = 0.07
    warmup_teacher_temp_epochs: int = 30
    # crops; the three sizes take equal-length lists for multi-resolution pretraining (train.py:334-380)
    global_crops_size: Any = 224
    local_crops_size: Any = 96
    global_local_crop_pairs_ratios: Any = 1.0
    global_crops_scale: Any = (0.32, 1.0)
    local_crops_scale: Any = (0.05, 0.32)
    local_crops_number: int = 8
    gram_teacher_crops_size: Optional[int] = None
    gram_teacher_no_distortions: bool = False
    teacher_no_color_jitter: bool = False
    horizontal_flips: bool = True
    # ibot
    mask_probability: float = 0.5
    mask_ratio_min_max: Any = (0.1, 0.5)
    # heads / losses: SSLMetaConfig fields
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
    centering: str = "sinkhorn_knopp"
    # in-train k-NN eval on a dir-per-class ImageFolder pair (evaluation.eval_period_iterations)
    eval_period_iterations: int = 0
    eval_knn_train_dir: str = ""
    eval_knn_val_dir: str = ""
    eval_resize_size: int = 256
    eval_crop_size: int = 224
    # distillation: a frozen pretrained teacher (a hub backbone .pth; heads from the seed)
    distillation_enabled: bool = False
    distillation_arch: str = ""  # teacher arch; "" -> the student's
    distillation_checkpoint: str = ""
    # gram
    gram_use_loss: bool = False
    gram_loss_weight: float = 1.0
    gram_img_level: bool = False
    gram_remove_neg: bool = False
    gram_tokens_used: str = "all"
    gram_ema_teacher: bool = False
    gram_ckpt: str = ""  # hub .pth of the frozen gram teacher backbone
    gram_rep_update: bool = True
    gram_update_frequency: int = 50000
    gram_it_first_update: int = 0
    gram_it_load_ema_teacher: int = -1
    gram_max_updates: Optional[int] = None
    gram_resize_method: str = "bicubic"
    # {start, peak, end, warmup_epochs[, cosine_epochs]}: a tabulated gram weight (ssl_meta_arch:186-201)
    gram_loss_weight_schedule: Any = None
    # the same form: dino.reweight_dino_local_loss's local_loss_weight_schedule
    local_loss_weight_schedule: Any = None
    # the same form: schedules.lr in absolute values (scaling_rule not applied)
    lr_schedule: Any = None
    extra: dict = dataclasses.field(default_factory=dict)


def load_ssl_config(path: Optional[str], overrides=None) -> SSLPretrainConfig:
    import yaml

    from omgsr_tpu_torch.config import _coerce

    raw = {}
    if path:
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        raw[key.strip()] = _coerce(value)
    known = {f.name for f in dataclasses.fields(SSLPretrainConfig)}
    cfg = SSLPretrainConfig(**{k: v for k, v in raw.items() if k in known})
    cfg.extra = {k: v for k, v in raw.items() if k not in known}
    return cfg


def build_ssl_schedulers(cfg: SSLPretrainConfig, global_batch_size: int):
    """build_schedulers (train.py:102-152) and the lr scaling rule
    (config.py:40-55): tables of lr / wd / momentum / teacher_temp /
    last_layer_lr indexed by iteration, clamped past the end."""
    from omgsr_tpu_torch.training.ssl import TabulatedSchedule, cosine_schedule, linear_warmup_cosine_decay

    ep = cfg.official_epoch_length
    total = cfg.epochs * ep
    lr_peak, lr_end = cfg.lr, cfg.min_lr
    if cfg.scaling_rule == "sqrt_wrt_1024":
        s = 4 * math.sqrt(global_batch_size / 1024.0)
        lr_peak, lr_end = lr_peak * s, lr_end * s
    elif cfg.scaling_rule == "linear_wrt_256":
        s = global_batch_size / 256.0
        lr_peak, lr_end = lr_peak * s, lr_end * s

    def _tabulate(sc: dict) -> np.ndarray:
        """{start, peak, end, warmup_epochs[, cosine_epochs]} -> table, warmup
        and cosine clamped into the run."""
        warmup = min(int(sc.get("warmup_epochs", 0) * ep), total)
        cosine = min(int(sc["cosine_epochs"] * ep), total - warmup) if "cosine_epochs" in sc else None
        return linear_warmup_cosine_decay(start=sc.get("start", 0.0), peak=sc["peak"], end=sc["end"],
                                          warmup_iterations=warmup, total_iterations=total, cosine_iterations=cosine)

    lr_table = cosine_schedule(lr_peak, lr_end, total, min(cfg.warmup_epochs * ep, total))
    if cfg.lr_schedule:
        lr_table = _tabulate(dict(cfg.lr_schedule))
        lr_end = dict(cfg.lr_schedule)["end"]
    wd_table = cosine_schedule(cfg.weight_decay, cfg.weight_decay_end, total)
    mom_table = cosine_schedule(cfg.momentum_teacher, cfg.final_momentum_teacher, total)
    temp_warmup = cfg.warmup_teacher_temp_epochs * ep
    if temp_warmup <= 0:
        temp_table = np.full((1,), cfg.teacher_temp)
    else:
        temp_table = cosine_schedule(cfg.teacher_temp, cfg.teacher_temp, temp_warmup, warmup_iters=temp_warmup,
                                     start_warmup_value=cfg.warmup_teacher_temp)
    last_layer_table = lr_table.copy()
    last_layer_table[: cfg.freeze_last_layer_epochs * ep] = 0.0
    gram_sched = local_sched = None
    if cfg.gram_loss_weight_schedule:
        sc = dict(cfg.gram_loss_weight_schedule)
        gram_sched = TabulatedSchedule(_tabulate(sc), final_value=sc["end"])
    if cfg.local_loss_weight_schedule:
        sc = dict(cfg.local_loss_weight_schedule)
        local_sched = TabulatedSchedule(_tabulate(sc), final_value=sc["end"])
    return {
        "lr": TabulatedSchedule(lr_table, final_value=lr_end),
        "wd": TabulatedSchedule(wd_table, final_value=cfg.weight_decay_end),
        "momentum": TabulatedSchedule(mom_table, final_value=cfg.final_momentum_teacher),
        "teacher_temp": TabulatedSchedule(temp_table, final_value=cfg.teacher_temp),
        "last_layer_lr": TabulatedSchedule(last_layer_table, final_value=lr_end),
        "gram_weight": gram_sched,
        "local_loss_weight": local_sched,
    }


def list_ssl_images(paths):
    """The SSL loader's images: dirs / .txt lists of paths, or a dataset spec
    ("ImageNet22k:root=...:extra=...", data/datasets.py) whose items are
    lazily decoded PIL images."""
    from omgsr_tpu_torch.data.datasets import is_dataset_spec, make_dataset

    if is_dataset_spec(paths):
        return make_dataset(paths).images
    if isinstance(paths, str):
        paths = [paths]
    files: list[str] = []
    for p in paths or []:
        if os.path.isdir(p):
            for ext in ("png", "jpg", "jpeg", "JPEG", "webp"):
                files += glob.glob(os.path.join(p, f"*.{ext}"))
        elif p.endswith(".txt"):
            with open(p) as f:
                files += [ln.strip() for ln in f if ln.strip()]
        else:
            files.append(p)
    files = sorted(set(files))
    if not files:
        raise FileNotFoundError(f"no images found under {paths!r}")
    return files


def check_world():
    """One process only: a torchrun world of more than one raises."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = max(world, torch.distributed.get_world_size())
    if world > 1:
        raise NotImplementedError(
            f"pretrain_dinov3 on a world of {world} processes: the data-parallel SSL step (Sinkhorn sums, centers "
            "and loss means over 'data', KoLeo over the global batch, the gradient mean) is ROADMAP Queue 1 item "
            "3.2b; run one process")


class SSLLoader:
    """Sampler -> multi-crop augmentation -> static-shape collate, with one
    background thread one batch ahead (a queue of two). ``wait_s`` holds
    the seconds each ``next`` waited for its batch, ``batch_s`` the seconds
    the thread took to make each batch (beside whatever the caller runs)."""

    def __init__(self, cfg: SSLPretrainConfig, start_iter: int = 0):
        from omgsr_tpu_torch.data.ssl import (
            BlockMaskingGenerator,
            EpochSampler,
            InfiniteSampler,
            MultiCropAugmentation,
            MultiCropConfig,
            ShardedInfiniteSampler,
        )

        self.files = list_ssl_images(cfg.dataset_paths)
        self.batch = cfg.batch_size_per_device
        self.cfg = cfg
        self.aug = MultiCropAugmentation(MultiCropConfig(
            global_crops_scale=tuple(cfg.global_crops_scale),
            local_crops_scale=tuple(cfg.local_crops_scale),
            local_crops_number=cfg.local_crops_number,
            global_crops_size=cfg.global_crops_size,
            local_crops_size=cfg.local_crops_size,
            gram_teacher_crops_size=cfg.gram_teacher_crops_size,
            gram_teacher_no_distortions=cfg.gram_teacher_no_distortions,
            teacher_no_color_jitter=cfg.teacher_no_color_jitter,
            horizontal_flips=cfg.horizontal_flips,
        ))
        self.mask_gen = BlockMaskingGenerator(cfg.global_crops_size // vit_config(cfg).patch_size)
        n = len(self.files)
        advance = start_iter * self.batch
        if cfg.sampler == "epoch":

            def _epoch_stream():
                es = EpochSampler(size=n, sample_count=n, shuffle=True, seed=cfg.seed)
                epoch = 0
                while True:
                    es.set_epoch(epoch)
                    yield from iter(es)
                    epoch += 1

            self.sampler = _epoch_stream()
            for _ in range(advance):
                next(self.sampler)
        elif cfg.sampler == "sharded_infinite":
            self.sampler = iter(ShardedInfiniteSampler(sample_count=n, shuffle=True, seed=cfg.seed, advance=advance))
        else:
            self.sampler = iter(InfiniteSampler(sample_count=n, shuffle=True, seed=cfg.seed, advance=advance))
        self.wait_s: list[float] = []
        self.batch_s: list[float] = []
        self._iter = start_iter
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make_batch(self, it: int) -> dict:
        from PIL import Image

        from omgsr_tpu_torch.data.ssl import collate_ssl_batch

        # seeded per iteration: a resumed run replays the same stream
        rng = np.random.default_rng((self.cfg.seed, it))
        samples = []
        for _ in range(self.batch):
            item = self.files[next(self.sampler)]
            if isinstance(item, str):  # a path; datasets yield PIL images
                with Image.open(item) as im:
                    samples.append(self.aug(rng, im.convert("RGB")))
            else:
                samples.append(self.aug(rng, item.convert("RGB")))
        return collate_ssl_batch(samples, rng, self.mask_gen, mask_ratio_tuple=tuple(self.cfg.mask_ratio_min_max),
                                 mask_probability=self.cfg.mask_probability)

    def _worker(self):
        it = self._iter
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                batch = self._make_batch(it)
            except Exception as e:  # raised in the consumer
                self._put(e)
                return
            self.batch_s.append(time.perf_counter() - t0)
            if not self._put(batch):
                return
            it += 1

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __next__(self) -> dict:
        t0 = time.perf_counter()
        out = self._q.get()
        self.wait_s.append(time.perf_counter() - t0)
        if isinstance(out, Exception):
            raise out
        return out

    def close(self):
        self._stop.set()
        self._thread.join(timeout=60)


def _resolve_vit(arch: str, overrides):
    from omgsr_tpu_torch.models.configs import VIT_SIZES, DinoV3ViTConfig

    if arch in VIT_SIZES:
        base = VIT_SIZES[arch]
    elif arch == "custom":
        base = DinoV3ViTConfig()
    else:
        raise KeyError(f"unknown arch {arch!r} (choices: {sorted(VIT_SIZES)})")
    if overrides:  # field-level overrides, e.g. tiny test configs or remat_blocks
        base = dataclasses.replace(base, **overrides)
    return base


def vit_config(cfg: SSLPretrainConfig):
    """The student ViT's config: ``arch`` with the ``vit:`` overrides."""
    return _resolve_vit(cfg.arch, cfg.extra.get("vit"))


def _teacher_vit_cfg(cfg: SSLPretrainConfig):
    return _resolve_vit(cfg.distillation_arch or cfg.arch, cfg.extra.get("teacher_vit"))


def meta_cfg(cfg: SSLPretrainConfig):
    from omgsr_tpu_torch.training.ssl_meta_arch import SSLMetaConfig

    return SSLMetaConfig(
        n_global_crops=2, n_local_crops=cfg.local_crops_number,
        dino_out_dim=cfg.dino_out_dim, dino_hidden_dim=cfg.dino_hidden_dim,
        dino_bottleneck_dim=cfg.dino_bottleneck_dim, dino_nlayers=cfg.dino_nlayers,
        ibot_separate_head=cfg.ibot_separate_head, ibot_out_dim=cfg.ibot_out_dim,
        ibot_hidden_dim=cfg.ibot_hidden_dim, ibot_bottleneck_dim=cfg.ibot_bottleneck_dim,
        ibot_nlayers=cfg.ibot_nlayers, dino_loss_weight=cfg.dino_loss_weight,
        koleo_loss_weight=cfg.koleo_loss_weight, ibot_loss_weight=cfg.ibot_loss_weight, centering=cfg.centering,
        gram_loss_weight=cfg.gram_loss_weight if cfg.gram_use_loss else 0.0, gram_img_level=cfg.gram_img_level,
        gram_remove_neg=cfg.gram_remove_neg, gram_tokens_used=cfg.gram_tokens_used,
        gram_ema_teacher=cfg.gram_ema_teacher,
    )


def run_knn_eval(backbone, vit_cfg, train_dir: str, val_dir: str, *, ks=(10, 20), batch_size: int = 32,
                 resize_size: int = 256, crop_size: int = 224):
    """The in-train k-NN probe over dir-per-class ImageFolder splits: the
    teacher's class token (L2-normalised) in the backbone's dtype on its
    device, the temperature-weighted vote of ``eval/probes.knn_classify`` on
    that device too.
    Returns {f"knn_top1_k{k}": accuracy}."""
    from omgsr_tpu_torch.eval.probes import extract_features, knn_classify, list_imagefolder, make_eval_transform
    from omgsr_tpu_torch.models.dinov3_vit import dinov3_vit_apply

    tr_imgs, tr_labels, classes = list_imagefolder(train_dir)
    va_imgs, va_labels, _ = list_imagefolder(val_dir)
    weight = backbone["patch_embed"]["proj"]["weight"]

    def feat_fn(x):
        with torch.inference_mode():
            cls = dinov3_vit_apply(backbone, vit_cfg, torch.from_numpy(x).to(weight.device, weight.dtype))
            cls = cls["x_norm_clstoken"].float()
            return cls / torch.clamp(torch.linalg.vector_norm(cls, dim=-1, keepdim=True), min=1e-12)

    transform = make_eval_transform(resize_size, crop_size)
    tr_f = extract_features(feat_fn, tr_imgs, batch_size, transform)
    va_f = extract_features(feat_fn, va_imgs, batch_size, transform)
    usable_ks = [k for k in ks if k <= len(tr_labels)] or [len(tr_labels)]
    # the vote (test @ train^T, top-k, softmax) on the backbone's device; only the predictions come back
    dev = weight.device
    probs = knn_classify(torch.from_numpy(tr_f).to(dev), torch.from_numpy(tr_labels).to(dev),
                         torch.from_numpy(va_f).to(dev), ks=usable_ks, num_classes=len(classes))
    return {f"knn_top1_k{k}": float(np.mean(torch.argmax(p, -1).cpu().numpy() == va_labels))
            for k, p in probs.items()}


def export_teacher_backbone(output_dir: str, iteration: int, teacher):
    """The EMA teacher's backbone, the artifact the eval suite consumes (the
    reference's teacher_checkpoint): <output_dir>/eval/teacher-<it>/backbone.pt,
    which ``training.checkpoint.restore_train_state`` reads into an
    ``init_dinov3_vit`` tree."""
    from omgsr_tpu_torch.training.checkpoint import save_tree

    path = os.path.join(os.path.abspath(output_dir), "eval", f"teacher-{iteration}", "backbone.pt")
    return save_tree(path, teacher["backbone"])


def batch_to_device(batch_np: dict, device, dtype) -> dict:
    """A collated numpy batch on the device; float arrays in ``dtype``."""
    from omgsr_tpu_torch.utils.devices import host_to_device

    out = {}
    for k, v in batch_np.items():
        t = host_to_device(np.asarray(v), device)
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def build_ssl_optimizer(cfg: SSLPretrainConfig, vit_cfg, student):
    """The recipe's SSL optimizer over ``student``: layer-decayed lr and wd
    multipliers, the patch-embed lr factor, the head's wd multiplier, AdamW's
    betas, the clip norm and the last-layer mask."""
    from omgsr_tpu_torch.training.ssl import SSLOptimizer, last_layer_mask, ssl_param_groups

    lr_t, wd_t = ssl_param_groups(student, lr_decay_rate=cfg.layerwise_decay, num_layers=vit_cfg.depth,
                                  patch_embed_lr_mult=cfg.patch_embed_lr_mult,
                                  dino_head_wd_multiplier=cfg.dino_head_wd_multiplier)
    return SSLOptimizer(lr_t, wd_t, b1=cfg.adamw_beta1, b2=cfg.adamw_beta2, clip_norm=cfg.clip_grad,
                        last_layer_mask_tree=last_layer_mask(student))


def run_pretraining(cfg: SSLPretrainConfig):
    """The pretraining loop. Returns {"student", "teacher", "opt", "centers",
    "history"}: ``history`` lists, per iteration, its index ``it``, the
    loader's wait ``loader_wait_s``, the seconds its thread took to make the
    batch ``loader_batch_s`` and the host seconds ``iter_s`` from
    taking the batch to the iteration's end (a device sync where the
    metrics are logged, at ``print_freq``), with the logged metrics."""
    import yaml

    from omgsr_tpu_torch.convert.params import init_dinov3_vit
    from omgsr_tpu_torch.training.checkpoint import latest_checkpoint, restore_train_state, save_train_state
    from omgsr_tpu_torch.training.ssl_meta_arch import (
        copy_tree,
        init_center_state,
        init_distill_ema,
        init_ssl_student,
        make_distill_train_step,
        make_gram_ssl_train_step,
        make_ssl_train_step,
    )
    from omgsr_tpu_torch.utils.devices import resolve_device
    from omgsr_tpu_torch.utils.dtypes import resolve_dtype
    from omgsr_tpu_torch.utils.observability import MetricLogger

    check_world()
    device = resolve_device(cfg.device)
    os.makedirs(cfg.output_dir, exist_ok=True)
    with open(os.path.join(cfg.output_dir, "cfg.yml"), "w") as f:
        d = dataclasses.asdict(cfg)
        d.update(d.pop("extra", {}))
        yaml.safe_dump(d, f, sort_keys=False)

    vit_cfg = vit_config(cfg)
    mcfg = meta_cfg(cfg)
    global_batch = cfg.batch_size_per_device
    total_iters = cfg.epochs * cfg.official_epoch_length
    sched = build_ssl_schedulers(cfg, global_batch)
    dtype = resolve_dtype(cfg.mixed_precision)

    # init (SSLMetaArch.init_weights: the teacher starts as a student copy; under distillation a frozen
    # pretrained model gives the targets and the teacher slot holds the student EMA, ssl_meta_arch.py:131-141)
    student = init_ssl_student(cfg.seed, vit_cfg, mcfg, init_dinov3_vit, torch.float32, device)
    if cfg.student_init_checkpoint:
        from omgsr_tpu_torch.convert.porters import port_dinov3_vit

        student["backbone"] = port_dinov3_vit(cfg.student_init_checkpoint, cfg=vit_cfg, dtype=torch.float32,
                                              device=device)
        logger.info("student backbone initialised from %s", cfg.student_init_checkpoint)
    use_gram_teacher = cfg.gram_use_loss and not cfg.gram_ema_teacher
    if use_gram_teacher and cfg.distillation_enabled:
        raise NotImplementedError("a frozen gram teacher and distillation in one run are not wired; use "
                                  "gram_ema_teacher=true under distillation")
    frozen_teacher = None
    if cfg.distillation_enabled:
        t_vit_cfg = _teacher_vit_cfg(cfg)
        frozen_teacher = init_ssl_student(cfg.seed + 1000, t_vit_cfg, mcfg, init_dinov3_vit, torch.float32, device)
        if cfg.distillation_checkpoint:
            from omgsr_tpu_torch.convert.porters import port_dinov3_vit

            frozen_teacher["backbone"] = port_dinov3_vit(cfg.distillation_checkpoint, cfg=t_vit_cfg,
                                                         dtype=torch.float32, device=device)
        teacher = init_distill_ema(student)
    else:
        teacher = copy_tree(student)
    opt = build_ssl_optimizer(cfg, vit_cfg, student)
    opt_state = opt.init(student)
    centers = init_center_state(mcfg, device)

    # the frozen gram teacher (gram.ema_teacher=false): a ported hub backbone, or the initial EMA teacher's
    gram_backbone = None
    num_gram_updates = 0
    if use_gram_teacher:
        if cfg.gram_ckpt:
            from omgsr_tpu_torch.convert.porters import port_dinov3_vit

            gram_backbone = port_dinov3_vit(cfg.gram_ckpt, cfg=vit_cfg, dtype=torch.float32, device=device)
        else:
            logger.warning("gram teacher without gram_ckpt: anchoring on the randomly initialised backbone until "
                           "the first EMA update")
            gram_backbone = copy_tree(teacher["backbone"])

    start_iter = 0
    state = {"student": student, "teacher": teacher, "opt": opt_state, "centers": centers, "step": 0}
    if gram_backbone is not None:
        state["gram"] = gram_backbone
    if cfg.resume:
        path = latest_checkpoint(cfg.output_dir)
        if path:
            state = restore_train_state(path, state)
            start_iter = int(state["step"]) + 1
            logger.info("resumed from %s at iteration %d", path, start_iter)
    student, teacher, opt_state, centers = state["student"], state["teacher"], state["opt"], state["centers"]
    gram_backbone = state.get("gram", gram_backbone)
    if use_gram_teacher and cfg.gram_rep_update and start_iter > 0 and start_iter >= cfg.gram_it_first_update:
        # the replayed update count (train.py:441-452)
        num_gram_updates = math.ceil((start_iter + 1 - cfg.gram_it_first_update) / cfg.gram_update_frequency)

    if cfg.distillation_enabled:
        distill_step = make_distill_train_step(opt, cfg=mcfg, vit_cfg=vit_cfg, teacher_vit_cfg=_teacher_vit_cfg(cfg))

        def step(student, teacher, opt_state, centers, batch, **kw):
            return distill_step(student, frozen_teacher, teacher, opt_state, centers, batch, **kw)

    elif use_gram_teacher:
        gram_step = make_gram_ssl_train_step(opt, cfg=mcfg, vit_cfg=vit_cfg, resize_method=cfg.gram_resize_method)

        def step(student, teacher, opt_state, centers, batch, **kw):
            return gram_step(student, teacher, gram_backbone, opt_state, centers, batch, **kw)

    else:
        step = make_ssl_train_step(opt, cfg=mcfg, vit_cfg=vit_cfg)

    # multi-resolution loaders (train.py:334-380): one SSLLoader per crop resolution, the resolution of an
    # iteration drawn from (seed, 7919, it); a resumed run replays the draws and advances each loader
    sizes_g = list(cfg.global_crops_size) if isinstance(cfg.global_crops_size, (list, tuple)) \
        else [cfg.global_crops_size]
    sizes_l = list(cfg.local_crops_size) if isinstance(cfg.local_crops_size, (list, tuple)) \
        else [cfg.local_crops_size] * len(sizes_g)
    sizes_gt = list(cfg.gram_teacher_crops_size) if isinstance(cfg.gram_teacher_crops_size, (list, tuple)) \
        else [cfg.gram_teacher_crops_size] * len(sizes_g)
    ratios = cfg.global_local_crop_pairs_ratios
    ratios = list(ratios) if isinstance(ratios, (list, tuple)) else [ratios] * len(sizes_g)
    if not len(sizes_g) == len(sizes_l) == len(sizes_gt) == len(ratios):
        raise ValueError("crop size / ratio lists must have equal lengths")
    probs = np.asarray(ratios, np.float64)
    probs = probs / probs.sum()

    def _pick(i: int) -> int:
        if len(probs) == 1:
            return 0
        return int(np.random.default_rng((cfg.seed, 7919, i)).choice(len(probs), p=probs))

    consumed = [0] * len(probs)
    for i in range(start_iter):
        consumed[_pick(i)] += 1
    loaders = []
    history = []
    mlog = MetricLogger()
    t0 = time.time()
    it = start_iter - 1  # the loop is empty on a resume at the end
    try:
        for inc, (g, l, gt) in enumerate(zip(sizes_g, sizes_l, sizes_gt)):
            cfg_i = dataclasses.replace(cfg, global_crops_size=g, local_crops_size=l, gram_teacher_crops_size=gt,
                                        seed=cfg.seed + (inc + 1 if len(probs) > 1 else 0))
            loaders.append(SSLLoader(cfg_i, start_iter=consumed[inc]))
        for it in range(start_iter, total_iters):
            if use_gram_teacher and it == cfg.gram_it_load_ema_teacher:
                logger.info("loading the EMA teacher into the gram teacher at it %d", it)  # train.py:473-475
                gram_backbone = copy_tree(teacher["backbone"])
            t_it = time.perf_counter()
            loader = loaders[_pick(it)]
            batch = batch_to_device(next(loader), device, dtype)
            wait, made = loader.wait_s[-1], loader.batch_s[len(loader.wait_s) - 1]
            kw = {}
            if sched["gram_weight"] is not None:
                kw["gram_weight"] = sched["gram_weight"][it]
            if sched["local_loss_weight"] is not None:
                kw["local_loss_weight"] = sched["local_loss_weight"][it]
            student, teacher, opt_state, centers, metrics = step(
                student, teacher, opt_state, centers, batch, lr=sched["lr"][it], wd=sched["wd"][it],
                teacher_temp=sched["teacher_temp"][it], momentum=sched["momentum"][it],
                last_layer_lr=sched["last_layer_lr"][it], **kw)
            del batch
            if (use_gram_teacher and cfg.gram_rep_update and (it + 1) >= cfg.gram_it_first_update
                    and (it + 1) % cfg.gram_update_frequency == 0
                    and (cfg.gram_max_updates is None or num_gram_updates < cfg.gram_max_updates)):
                logger.info("updating the gram teacher from the EMA after it %d", it)  # train.py:534-545
                gram_backbone = copy_tree(teacher["backbone"])
                num_gram_updates += 1
            entry = {"it": it, "loader_wait_s": wait, "loader_batch_s": made}
            if (it + 1) % cfg.print_freq == 0 or it + 1 == total_iters:
                host = {k: float(v) for k, v in metrics.items()}
                if not math.isfinite(host["total_loss"]):
                    raise FloatingPointError(f"non-finite total_loss at iteration {it}: {host}")
                mlog.update(**host)
                entry.update(host)
                logger.info("it %d/%d | %s | lr=%.2e | %.3f s/it", it + 1, total_iters, mlog, sched["lr"][it],
                            (time.time() - t0) / max(it + 1 - start_iter, 1))
            entry["iter_s"] = time.perf_counter() - t_it
            history.append(entry)
            if (cfg.eval_period_iterations > 0 and cfg.eval_knn_train_dir
                    and ((it + 1) % cfg.eval_period_iterations == 0 or it + 1 == total_iters)):
                accs = run_knn_eval(teacher["backbone"], vit_cfg, cfg.eval_knn_train_dir,
                                    cfg.eval_knn_val_dir or cfg.eval_knn_train_dir, resize_size=cfg.eval_resize_size,
                                    crop_size=cfg.eval_crop_size)
                logger.info("eval it %d | %s", it + 1, " ".join(f"{k}={v:.4f}" for k, v in accs.items()))
                eval_dir = os.path.join(cfg.output_dir, "eval")
                os.makedirs(eval_dir, exist_ok=True)
                with open(os.path.join(eval_dir, f"knn-{it}.json"), "w") as f:
                    json.dump(accs, f)
            if (it + 1) % cfg.saveckp_freq == 0 or it + 1 == total_iters:
                state = {"student": student, "teacher": teacher, "opt": opt_state, "centers": centers, "step": it}
                if gram_backbone is not None:
                    state["gram"] = gram_backbone
                save_train_state(cfg.output_dir, state, it)
                export_teacher_backbone(cfg.output_dir, it, teacher)
    finally:
        for ld in loaders:
            ld.close()
    logger.info("pretraining done at iteration %d", it + 1)
    return {"student": student, "teacher": teacher, "opt": opt_state, "centers": centers, "history": history}


def main(argv=None):
    parser = argparse.ArgumentParser("DINOv3 SSL pretraining")
    parser.add_argument("--config", type=str, default=None, help="yaml config path")
    parser.add_argument("overrides", nargs="*", help="key=value config overrides (device=cpu runs on the host)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s")
    return run_pretraining(load_ssl_config(args.config, args.overrides))


if __name__ == "__main__":
    main()
