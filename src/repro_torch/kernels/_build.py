"""Build and load the port's CUDA kernels (nvcc -> .so with a C interface).

Each ``csrc/<name>.cu`` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC --split-compile=0

into ``build/repro_torch_kernels/`` at the repository root and loaded with
``ctypes``.  The library name carries a hash of the source, so an edited
source rebuilds.  Sources come only from this package; nothing is built
at import time.  :func:`build_all` runs one nvcc per source, all at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
#: ``--split-compile=0`` optimises the kernels of one source in parallel,
#: on every core (fpe_aggregate.cu took 104 s without it on the H100 host)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--split-compile=0")

#: seconds each build took in this process (source name -> seconds)
build_seconds: dict[str, float] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()  # guards _NAME_LOCKS
_NAME_LOCKS: dict[str, threading.Lock] = {}  # one build of a source at a time


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (cached per process)."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} (rc={proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _LIBS[name] = lib
        return lib


def build_all(names) -> None:
    """Build and load ``csrc/<name>.cu`` for every name, one nvcc each,
    all started together; re-raises the first failure.  The times are in
    :data:`build_seconds`."""
    errors: list[BaseException] = []

    def one(name):
        try:
            load_library(name)
        except BaseException as e:  # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]


def on_device(dev: torch.device):
    """Make ``dev`` the current device for a launch through the C
    interface (which launches on the current device); a no-op when it
    already is, which spares the per-launch cost of switching."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
