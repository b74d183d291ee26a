from omgsr_tpu_torch.serving.server import ServeOptions, SRServer

__all__ = ["SRServer", "ServeOptions"]
