"""Building and loading the hand-written CUDA kernels, and counting launches.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``omgsr_tpu_torch/build/``
(one ``nvcc`` process per source, all started together), then loaded with
``ctypes``. The build happens at first use, from the sources in the package
alone; a library is reused when its source has not changed. A failed build
raises.

Nothing here runs when the module is imported.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def kernel_sources() -> list[str]:
    """Names (without suffix) of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels of omgsr_tpu_torch are compiled on the machine with the card"
    )


def _library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names=None, verbose: bool = False) -> dict[str, Path]:
    """Compile the named sources (default: all) that have no up-to-date
    library yet, in parallel. Returns {name: library path}. With
    ``verbose`` the compiler also reports each kernel's registers and
    shared memory (``-Xptxas -v``) and the output is printed."""
    names = list(names) if names is not None else kernel_sources()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {n: _library_path(n) for n in names}
        todo = [n for n in names if not paths[n].exists()]
        if todo:
            nvcc = _find_nvcc()
            procs = []
            for n in todo:
                tmp = paths[n].with_suffix(f".tmp{os.getpid()}.so")
                cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                       "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
                procs.append((n, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
            failures = []
            for n, tmp, proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}")
                    continue
                if verbose and out:
                    print(out, flush=True)
                os.replace(tmp, paths[n])
            if failures:
                raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load_kernel_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built first if need be."""
    lib = _libraries.get(name)
    if lib is None:
        path = build_kernels([name])[name]
        with _lock:
            lib = _libraries.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _libraries[name] = lib
    return lib


class LaunchCounter:
    """Counts kernel launches of one wrapper. The wrapper adds one where it
    launches its kernel and nowhere else, so a run can show that it went
    through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


class _PlainRoute:
    """Process-wide switch read by the kernel wrappers (test-only)."""

    def __init__(self):
        self.active = False


_plain_route = _PlainRoute()


def plain_route_active() -> bool:
    return _plain_route.active


@contextlib.contextmanager
def route_kernels_to_plain():
    """TEST-ONLY: inside this context every kernel wrapper computes its plain
    PyTorch version instead of launching its kernel, whatever the device.
    Used to hold a whole pipeline run on the card against the same run
    without the kernels. Never entered by the package itself."""
    previous = _plain_route.active
    _plain_route.active = True
    try:
        yield
    finally:
        _plain_route.active = previous


def launch_kernel(fn, what: str, device, *args) -> None:
    """Call a kernel's C launcher with ``args`` plus PyTorch's current stream
    of ``device`` (made the current device for the call when it is not), and
    raise if it returns a CUDA error code: a refused launch never runs, and
    a later synchronize would not report it."""
    import torch

    if device.index == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{what}: kernel launch failed with code {code}")
