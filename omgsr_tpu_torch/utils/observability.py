"""Tracing, metrics, and numerics guards.

The reference's observability is ad hoc (SURVEY.md §5): wall-clock prints
around cuda.synchronize (infer/omgsr_s_infer_model.py:170-183), a dormant
perfcount decorator (infer/vaehook.py:432-454), tqdm loss postfixes, NaN
checks (infer/devices.py:107-122). Here:

  * StepTimer: wall-clock timing fenced by a synchronisation of the CUDA
    devices that hold the tensors given to ``stop``;
  * trace(): a ``torch.profiler`` trace of the CPU and, where there is one,
    the CUDA device, exported as a Chrome trace (a timeline of every host
    op and device kernel) into ``log_dir``;
  * MetricLogger / SmoothedValue: windowed metric smoothing (the vendored
    dinov3/logging/helpers.py:19,136 capability);
  * check_finite / all_nan: NaN/Inf detection on parameter trees
    (devices.py test_for_nans parity);
  * guard_nans: PyTorch has no switch that traps the first NaN of every
    forward op as ``jax_debug_nans`` does; it turns on autograd's anomaly
    mode instead, which checks every backward function's output for NaN and
    names the forward op that made it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque

import numpy as np
import torch


def _cuda_devices(obj, out):
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    return out


class StepTimer:
    """Wall-clock timing with device fencing.

    with StepTimer() as t: out = step(...)
    t.seconds  # waits for `out` if you pass it to .stop(out)
    """

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.seconds = None
        return self

    def __exit__(self, *a):
        if self.seconds is None:
            self.seconds = time.perf_counter() - self.t0

    def stop(self, *arrays):
        """Wait for the work queued on the CUDA devices of ``arrays`` (tensors
        or nested dicts / lists of them), then read the clock."""
        for device in _cuda_devices(arrays, set()):
            torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - self.t0
        return self.seconds


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU activities, and CUDA ones
    where a CUDA device is present), exported as a Chrome trace
    (``trace_<pid>_<n>.json``, readable by chrome://tracing and Perfetto)
    into ``log_dir``. The profile object is yielded; its ``trace_path``
    names the file once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    n = sum(name.startswith(f"trace_{os.getpid()}_") for name in os.listdir(log_dir))
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json")
        prof.export_chrome_trace(prof.trace_path)


class SmoothedValue:
    def __init__(self, window: int = 20):
        self.values = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, v: float, n: int = 1):
        self.values.append(v)
        self.total += v * n
        self.count += n

    @property
    def median(self):
        return float(np.median(self.values)) if self.values else 0.0

    @property
    def avg(self):
        return float(np.mean(self.values)) if self.values else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, window: int = 20, delimiter: str = " | "):
        self.meters = defaultdict(lambda: SmoothedValue(window))
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}={m.median:.4f} ({m.global_avg:.4f})" for k, m in self.meters.items())


def _leaves(tree, out):
    """The leaves of a nested list / tuple / dict (dict keys sorted), in the
    order ``jax.tree.leaves`` gives them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def check_finite(tree, name: str = "tree") -> list[str]:
    """Return the paths of non-finite leaves (host-side; waits for them): a
    nested dict gives dotted paths, anything else the index of the leaf in
    ``jax.tree.leaves`` order."""
    from omgsr_tpu_torch.utils.tree import flatten_dict

    bad = []
    items = flatten_dict(tree).items() if isinstance(tree, dict) else enumerate(_leaves(tree, []))
    for path, leaf in items:
        if not bool(torch.isfinite(torch.as_tensor(leaf)).all()):
            p = ".".join(str(k) for k in path) if isinstance(path, tuple) else str(path)
            bad.append(f"{name}.{p}")
    return bad


def guard_nans(enable: bool = True):
    """Turn autograd's anomaly detection on or off
    (``torch.autograd.set_detect_anomaly``): a backward function that
    returns NaN raises, naming the forward op. Unlike ``jax_debug_nans`` in
    the JAX package, a NaN made in a forward op outside autograd is not
    trapped; ``check_finite`` / ``all_nan`` test outputs for that."""
    torch.autograd.set_detect_anomaly(enable)


def all_nan(x) -> bool:
    """devices.py test_for_nans parity: True when the tensor is entirely NaN
    (the reference treats all-NaN as the failure signal, :107-122)."""
    return bool(torch.isnan(torch.as_tensor(x)).all())
