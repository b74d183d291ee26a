"""Typed training/inference configuration.

The reference loads a flat OmegaConf YAML with a single --config flag
(train/train_omgsr_s.py:117-131, configs/omgsr_s_512.yml). This framework
keeps the same YAML key set (so reference configs load unchanged) but parses
into a typed dataclass with validation and supports dotted CLI overrides
(``key=value``), which the reference lacks (SURVEY.md §5 config system).

The port's own copy of the JAX package's ``config.py``: same keys, same
defaults. Keys that only mean something on a TPU stay accepted and are not
read by the port. ``yaml`` is imported where a file is read or written.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class TrainConfig:
    # identity
    model: str = "omgsr_s_512"
    seed: int = 123

    # base checkpoints (HF-layout dirs on disk)
    sd_path: Optional[str] = None
    flux_path: Optional[str] = None

    # prompt conditioning (fixed prompt, pre-encoded once;
    # train/train_omgsr_s.py:172-201)
    fixed_prompt: str = ""
    fixed_prompt_path: Optional[str] = None

    dataset_txt_or_dir_paths: list = field(default_factory=list)

    # LoRA ranks (configs/omgsr_s_512.yml:8-9, omgsr_f_1024.yml:8-9)
    vae_lora_rank: int = 16
    unet_lora_rank: int = 32
    flux_transformer_lora_rank: int = 64

    # objective (configs/omgsr_s_512.yml:11-16)
    dinov3_convnext_size: str = "large"
    lambda_LRR: float = 5.0
    lambda_Dv3D: float = 5.0
    lambda_L1: float = 0.5
    lambda_GAN: float = 0.5
    mid_timestep: int = 273

    # run layout
    output_dir: str = "./omgsr_trainings/run"
    logging_dir: str = "logs"
    resolution: int = 512
    train_batch_size: int = 1
    max_train_steps: Optional[int] = 6000
    num_train_epochs: int = 1
    checkpointing_steps: int = 1000
    save_img_steps: int = 100
    resume_from_checkpoint: Optional[str] = None

    # optimization (configs/omgsr_s_512.yml:25-42)
    gradient_accumulation_steps: int = 4
    gradient_checkpointing: bool = False
    enable_xformers_memory_efficient_attention: bool = False  # accepted, no-op
    learning_rate: float = 5e-5
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    lr_num_cycles: int = 1
    lr_power: float = 1.0
    dataloader_num_workers: int = 8
    use_8bit_adam: bool = False  # accepted, no-op
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-4
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    allow_tf32: bool = False  # accepted, no-op
    mixed_precision: str = "bf16"

    # extensions of the JAX package (absent from the reference); accepted so
    # that its configs load unchanged. The port reads degradation_params
    # (default: the package's params_realesrgan.yml), quantize_base (-F), and
    # mesh_shape: the training CLIs' mesh over a torchrun world, the global
    # batch split over "data" and the frozen UNet / DiT placed by FSDP over
    # "fsdp" (None: every rank on "data"; one process without torchrun
    # trains unsharded)
    mesh_shape: Optional[dict] = None  # e.g. {"data": 4} or {"data": 2, "fsdp": 4}
    degradation_params: Optional[str] = None  # path to params_realesrgan.yml
    degrade_on_device: bool = True
    quantize_base: Optional[str] = None  # "int8" | "int4" storage of the frozen denoiser

    extra: dict = field(default_factory=dict)  # unknown keys preserved here

    @property
    def is_flux(self) -> bool:
        return "omgsr_f" in self.model


def _coerce(value: str) -> Any:
    """Parse a CLI override string with YAML semantics (plus scientific-notation
    floats like 1e-4, which YAML 1.1 treats as strings)."""
    import yaml

    parsed = yaml.safe_load(value)
    if isinstance(parsed, str):
        try:
            return int(parsed)
        except ValueError:
            pass
        try:
            return float(parsed)
        except ValueError:
            pass
    return parsed


def load_config(path: str, overrides: Optional[list[str]] = None) -> TrainConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        raw[key.strip()] = _coerce(value)
    known = {f.name: str(f.type) for f in dataclasses.fields(TrainConfig)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    # YAML 1.1 reads 5e-5 as a string (omgsr_f_1024.yml's learning_rate): a numeric field takes
    # the number, where the JAX package's loader hands the string to its optimizer
    for k, v in kwargs.items():
        if isinstance(v, str) and ("float" in known[k] or "int" in known[k]):
            kwargs[k] = _coerce(v)
    extra = {k: v for k, v in raw.items() if k not in known}
    cfg = TrainConfig(**kwargs)
    cfg.extra = extra
    return cfg


def save_config(cfg: TrainConfig, path: str) -> None:
    import yaml

    d = dataclasses.asdict(cfg)
    extra = d.pop("extra", {})
    d.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(d, f, sort_keys=False)
