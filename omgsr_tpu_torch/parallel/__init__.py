"""Multi-GPU serving and training: the process-group bootstrap, meshes, the
placement of frozen trees and the collectives of a data-parallel step (one
process per GPU; see ``distributed.py``)."""

from omgsr_tpu_torch.parallel.distributed import initialize, is_main_process, local_device
from omgsr_tpu_torch.parallel.sharding import Mesh, create_mesh, shard_flux_params, shard_params_fsdp

__all__ = ["Mesh", "create_mesh", "initialize", "is_main_process", "local_device", "shard_flux_params",
           "shard_params_fsdp"]
