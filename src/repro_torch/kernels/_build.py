"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``src/repro_torch/csrc/<name>.cu`` file with a plain
``extern "C"`` entry point.  At first use it is compiled by ``nvcc`` into a
shared library under ``<repo>/build/kernels/`` and loaded with ``ctypes``:
no PyTorch headers, so a build takes seconds.  The library file is named by
a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  A missing ``nvcc`` or a failed build raises; there
is no fallback.

Nothing here runs at import: the CPU tests import every module of the port
on hosts that have neither ``nvcc`` nor a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from repro_torch import spans

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")
# per kernel: flash_attention and rwkv6_scan look up the driver's
# tensor-map encoder with dlopen/dlsym
LINK_FLAGS = {"flash_attention": ("-ldl",), "rwkv6_scan": ("-ldl",)}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from source at "
            "first use and need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    """Where ``name``'s library lives once built (content-addressed)."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + LINK_FLAGS.get(name, ())
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The compiler's report (``-Xptxas=-v``: registers, spills) is kept in a
    ``.log`` file beside the library."""
    out = library_path(name)
    if out.is_file():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
           *LINK_FLAGS.get(name, ())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    spans.count("kernel.builds")
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``name``, loaded once per process."""
    return ctypes.CDLL(str(build(name)))
