"""omgsr-tpu-torch: the PyTorch/CUDA port of omgsr-tpu for NVIDIA Hopper.

A second package beside ``omgsr_tpu`` (the JAX reference), with the same
sub-package names so each module's counterpart is easy to find. It imports
``torch``, never ``jax`` and nothing of ``omgsr_tpu``. Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas is a kernel written by
hand for sm_90a (sources under ``csrc/``, built at first use into
``build/``).

Ported so far: OMGSR-S one-step serving (SD2.1 VAE encode -> UNet epsilon at
the mid-timestep -> x0 -> VAE decode -> clamp -> colour fix) behind the
serving daemon. Entry points default to ``device="cuda"`` and raise when
there is no CUDA device; pass ``device="cpu"`` to run the plain versions.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy convenience export (keeps bare ``import omgsr_tpu_torch`` light)."""
    if name == "OMGSRSPipeline":
        from omgsr_tpu_torch.inference.pipeline_s import OMGSRSPipeline

        return OMGSRSPipeline
    raise AttributeError(f"module 'omgsr_tpu_torch' has no attribute {name!r}")
