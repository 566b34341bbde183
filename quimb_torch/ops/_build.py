"""Build the CUDA sources of ``quimb_torch/csrc`` with nvcc and load them
with ctypes.

The sources have a plain C interface and include no PyTorch header, so
an nvcc call takes seconds. Each ``.cu`` is compiled by its own nvcc,
all started together, and the objects are linked into one shared
library. The library goes into
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _run(cmds):
    """Run the commands together; return (command, process, stdout,
    stderr) for each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    return [(c, p, *p.communicate()) for c, p in zip(cmds, procs)]


def build():
    """Compile the kernels unless this build exists; return the library
    path. The nvcc commands and their output go to ``build.log`` beside
    it."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under private names, then rename: a concurrent build of the
    # same sources never sees a half-written library
    pid = os.getpid()
    nvcc = _nvcc()
    sources = [s for s in _sources() if s.suffix == ".cu"]
    # nvcc tells objects by their ".o" suffix
    objs = [out_dir / f"{s.stem}.{pid}.o" for s in sources]
    log = []
    results = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                    for s, o in zip(sources, objs)])
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    if all(p.returncode == 0 for _, p, _, _ in results):
        results += _run([[nvcc, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
    for cmd, p, out, err in results:
        log.append(" ".join(cmd) + "\n" + out + err)
    (out_dir / "build.log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(cmd, p, err) for cmd, p, _, err in results if p.returncode]
    if failed:
        cmd, p, err = failed[0]
        raise RuntimeError(
            f"nvcc failed with code {p.returncode}: {' '.join(cmd)}\n{err}"
        )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library():
    """Build (at most once per process) and load the kernel library."""
    return ctypes.CDLL(str(build()))
