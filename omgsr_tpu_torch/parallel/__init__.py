"""Multi-GPU serving: the process-group bootstrap, meshes and the placement
of the FLUX DiT (one process per GPU; see ``distributed.py``)."""

from omgsr_tpu_torch.parallel.distributed import initialize, is_main_process, local_device
from omgsr_tpu_torch.parallel.sharding import Mesh, create_mesh, shard_flux_params

__all__ = ["Mesh", "create_mesh", "initialize", "is_main_process", "local_device", "shard_flux_params"]
