"""Build and load the hand-written CUDA kernels (ops/csrc/*.cu).

Each source is compiled at first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, and loaded with ``ctypes`` (no
PyTorch headers: a build takes seconds, not minutes). Libraries land in
``ops/build/`` (listed in .gitignore), named by a hash of the source
and the flags, so an edited source is rebuilt and an unchanged one is
reused. All missing libraries are built together, one ``nvcc`` process
per source started at once.

Every C entry point launches on the stream it is handed (the wrapper
passes ``torch.cuda.current_stream().cuda_stream``) and returns
``cudaGetLastError()``; ``check`` raises on anything but 0. No ``nvcc``,
a failed build or a failed launch raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0   # wall time of the last build_all() that compiled


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "ray_tpu_torch: nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
        "the CUDA kernels cannot be built")


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all at once;
    return {name: library path}. Raises with nvcc's output on failure."""
    global build_seconds
    srcs = sources()
    targets = {name: _target(src) for name, src in srcs.items()}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    if not todo:
        return targets
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, tgt in todo.items():
        # Write to a private name and rename: two processes building at
        # once never load a half-written library.
        tmp = tgt.with_name(f"{tgt.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        procs[name] = (tmp, tgt, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for name, (tmp, tgt, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- nvcc {srcs[name].name} (exit "
                          f"{proc.returncode}):\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, tgt)
    build_seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError("ray_tpu_torch: kernel build failed\n"
                           + "\n".join(errors))
    return targets


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def check(err: int, what: str, error_string) -> None:
    """Raise if a launcher returned a CUDA error; ``error_string`` is
    the library's ``*_error_string`` (cudaGetErrorString)."""
    if err != 0:
        msg = error_string(err).decode(errors="replace")
        raise RuntimeError(f"ray_tpu_torch: {what} failed to launch: "
                           f"CUDA error {err} ({msg})")
