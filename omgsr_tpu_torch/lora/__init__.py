from omgsr_tpu_torch.lora.lora import (
    FLUX_TARGET_MODULES,
    SD_TARGET_MODULES,
    attach_lora,
    init_lora_tree,
    lora_param_count,
    merge_lora,
    path_matches_targets,
    split_lora,
)

__all__ = [
    "FLUX_TARGET_MODULES",
    "SD_TARGET_MODULES",
    "attach_lora",
    "init_lora_tree",
    "lora_param_count",
    "merge_lora",
    "path_matches_targets",
    "split_lora",
]
