"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (git-ignored), named by a hash of its source and flags, so an
edited source rebuilds on first use and an unchanged one loads at once.
The library is loaded with ``ctypes``; pointers and the stream go in as
``c_void_p``. Nothing here runs at import: the CPU tests import every
module of the port, and there is no ``nvcc`` on a machine without CUDA.

``LAUNCHES`` counts kernel launches by name. Every wrapper launches through
:func:`launch`, which adds one there and nowhere else, so a run can show
that its main path went through the kernels (``chip_smoke.py`` clears it,
drives the path, and reads it).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

from distributed_pytorch_tpu_torch.utils.platform import is_hopper

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

#: Kernel library name -> its source file under ``csrc/``.
SOURCES = {
    "paged_attention": "paged_attention.cu",
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

#: Element types of the kernels' C interfaces, by the code they take.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Head dims the kernels are instantiated for.
HEAD_DIMS = (64, 128)

#: Launches per kernel name since the last ``LAUNCHES.clear()``.
LAUNCHES: "collections.Counter[str]" = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install location. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file():
            return str(path)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled at first use"
    )


def library_path(name: str) -> Path:
    """Where the library built from the current source of ``name`` lives."""
    source = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel (all of ``SOURCES`` by default) whose
    library is missing, one ``nvcc`` per source, all started together.
    Returns seconds per built kernel (0.0 for one already built). Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, target)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target) in jobs.items():
        output, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def launch(name: str, fn: Callable[..., int], device: torch.device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream, raise on a nonzero CUDA error code, and count one launch of
    kernel ``name``. Refuses a card other than Hopper, the only target the
    libraries are built for."""
    with torch.cuda.device(device):
        if not is_hopper():
            raise RuntimeError(
                f"the {name} kernel is built for sm_90a (Hopper); "
                f"{torch.cuda.get_device_name()} is sm_"
                f"{''.join(map(str, torch.cuda.get_device_capability()))}"
            )
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
