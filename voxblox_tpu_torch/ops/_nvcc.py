"""nvcc builds of the port's CUDA sources (``voxblox_tpu_torch/csrc/``):
one shared library per source file with a plain C interface, bound with
ctypes by its wrapper module, compiled for sm_90a into
``voxblox_tpu_torch/_build/`` at first use and reused while the source
and flags hash the same."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def build(name: str, flags=(), info: dict | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>_<hash>.so``
    unless that file exists. ``flags`` go to nvcc after the common ones;
    ``info`` (when given) receives the command, its seconds and the ptxas
    report (registers, spills) of a build that ran."""
    src = CSRC / f"{name}.cu"
    flags = list(flags)
    tag = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()
                       ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", *flags, "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    if info is not None:
        info.update(cmd=" ".join(cmd), seconds=time.perf_counter() - t0,
                    ptxas=res.stderr.strip())
    return out
