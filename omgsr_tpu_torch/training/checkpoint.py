"""Checkpoint/resume.

The reference saves PEFT adapters every `checkpointing_steps`
(train/train_omgsr_s.py:507-518) but its resume branch is an unimplemented
TODO (:394-419) and optimizer state is never persisted. Here, as in the JAX
package, the full train state (LoRA + both optimizers + discriminator heads
+ spectral-norm state + micro-step count) is saved and restorable: real
resume. One ``torch.save`` file per step,
``<output_dir>/checkpoints/checkpoint-<step>.pt``, holding nested dicts of
CPU tensors and integers only. Adapters are ALSO exported per step in the
reference's directory layout (``weight-{step}/{adapter_name}``, through
``lora.adapter_io.save_adapter``) for inference.
"""

from __future__ import annotations

import os

import torch

_SUFFIX = ".pt"


def _ckpt_dir(output_dir: str) -> str:
    return os.path.join(os.path.abspath(output_dir), "checkpoints")


def _to_cpu(node):
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.detach().to("cpu", copy=True)
    return node


def save_tree(path: str, tree):
    """``torch.save`` of a nested dict of tensors and integers, moved to the
    CPU, through a temporary name: a reader never sees a half-written file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, path)
    return path


def save_train_state(output_dir: str, state, step: int):
    return save_tree(os.path.join(_ckpt_dir(output_dir), f"checkpoint-{step}{_SUFFIX}"), state)


def _checkpoint_steps(output_dir: str) -> list[int]:
    """Sorted step numbers of the checkpoint-* files under output_dir."""
    d = _ckpt_dir(output_dir)
    if not os.path.isdir(d):
        return []
    steps = []
    for name in os.listdir(d):
        if name.startswith("checkpoint-") and name.endswith(_SUFFIX):
            try:
                steps.append(int(name[len("checkpoint-"):-len(_SUFFIX)]))
            except ValueError:
                pass
    return sorted(steps)


def latest_checkpoint(output_dir: str):
    steps = _checkpoint_steps(output_dir)
    if not steps:
        return None
    return os.path.join(_ckpt_dir(output_dir), f"checkpoint-{steps[-1]}{_SUFFIX}")


def keep_last_n_checkpoints(output_dir: str, n):
    """Remove all but the n highest-step checkpoint files (the reference
    checkpointer's keep_last_n_checkpoints). n = None or 0 keeps everything."""
    if not n:
        return
    for step in _checkpoint_steps(output_dir)[:-n]:
        path = os.path.join(_ckpt_dir(output_dir), f"checkpoint-{step}{_SUFFIX}")
        if os.path.exists(path):
            os.remove(path)


def export_adapters(output_dir: str, step: int, gen_lora, cfg, adapter_names: dict):
    """Write reference-layout adapter directories: weight-{step}/<name>.

    adapter_names, for -S: {"vae_encoder": "vae_encoder_lora_adapter",
    "denoiser": "unet_lora_adapter"} (infer/omgsr_s_infer_model.py:16-21);
    for -F: {"vae_encoder": "vae_encoder_adapter", "denoiser": "flux_adapter"}
    (train/train_omgsr_f.py:150,176), with FLUX's targets and
    ``cfg.flux_transformer_lora_rank``. The port's DiT LoRA is already a dict
    per block, so the JAX package's ``unstack_lora_tree`` (for its
    scan-stacked layout) has nothing to do here and is not ported: the files
    hold the same per-block keys and bytes as the JAX export."""
    from omgsr_tpu_torch.lora import FLUX_TARGET_MODULES, SD_TARGET_MODULES
    from omgsr_tpu_torch.lora.adapter_io import save_adapter

    weight_path = os.path.join(output_dir, f"weight-{step}")
    targets = {"vae_encoder": SD_TARGET_MODULES,
               "denoiser": FLUX_TARGET_MODULES if cfg.is_flux else SD_TARGET_MODULES}
    ranks = {"vae_encoder": cfg.vae_lora_rank,
             "denoiser": cfg.flux_transformer_lora_rank if cfg.is_flux else cfg.unet_lora_rank}
    for part, name in adapter_names.items():
        save_adapter(gen_lora[part], os.path.join(weight_path, name), rank=ranks[part], targets=targets[part])
    return weight_path


def _restore_into(target, saved, path=()):
    if isinstance(target, dict):
        if not isinstance(saved, dict) or set(saved) != set(target):
            raise ValueError(f"checkpoint structure differs from the train state at {'.'.join(path) or '<root>'}")
        return {k: _restore_into(v, saved[k], path + (k,)) for k, v in target.items()}
    if isinstance(target, torch.Tensor):
        if tuple(saved.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} differs from {tuple(target.shape)} "
                             f"at {'.'.join(path)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    return saved


def restore_train_state(path: str, state):
    """Load a saved state into ``state`` (typically a freshly initialised
    trainer's): tensors are copied into the existing leaves, which keep their
    device, dtype and requires_grad; integers are replaced. Returns the
    restored state."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return _restore_into(state, saved)
