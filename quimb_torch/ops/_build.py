"""Build the CUDA sources of ``quimb_torch/csrc`` with nvcc and load them
with ctypes.

The sources have a plain C interface and include no PyTorch header, so
one nvcc call takes seconds. The library goes into
``quimb_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags: an unchanged checkout builds once, an edited source rebuilds.
Nothing is built when a module is imported; the first kernel launch on a
CUDA tensor calls :func:`load_library`.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libquimb_torch_kernels.so"
# -Xptxas -v writes each kernel's registers, shared memory and spills to
# the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "no CUDA toolkit found: quimb_torch's kernels need nvcc"
        )
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_dir():
    """The build directory of the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build():
    """Compile the kernels unless this build exists; return the library
    path. The nvcc command and its output go to ``build.log`` beside
    it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build of the
    # same sources never sees a half-written library
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr
    )
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {res.returncode}:\n{res.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library():
    """Build (at most once per process) and load the kernel library."""
    return ctypes.CDLL(str(build()))
