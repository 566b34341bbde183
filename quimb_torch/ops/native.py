"""ctypes bindings to the native (C++) contraction path finder.

``cpp/pathfinder.cpp`` (a copy of quimb_tpu's) implements a multi-restart
randomized-greedy path search. At its first use the port builds it with
``g++`` into ``quimb_torch/_build/pathfinder-<hash>/``, keyed by a hash of
the source, never beside the source. Where the build or the load fails,
:func:`get_lib` returns ``None`` and :func:`.paths.path_random_greedy`
takes its Python route, as quimb_tpu's does: a route of the host's path
search, not of the device.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "cpp", "pathfinder.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path():
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_ROOT, f"pathfinder-{h.hexdigest()[:16]}",
                        "libpathfinder.so")


def _build(lib):
    """Compile the source into ``lib`` under a private name, then rename,
    so that a concurrent build never loads a half-written library."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, lib)


def get_lib():
    """Load (building if necessary) the native pathfinder, or return
    ``None`` if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib_file = lib_path()
            if not os.path.exists(lib_file):
                _build(lib_file)
            lib = ctypes.CDLL(lib_file)
            lib.find_path_rgreedy2.restype = ctypes.c_int64
            lib.find_path_rgreedy2.argtypes = [
                ctypes.c_int32,
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
                ctypes.c_uint64,
                ctypes.c_double,
                ctypes.c_int32,
                ctypes.c_double,
                ctypes.c_double,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.POINTER(ctypes.c_double),
            ]
            _lib = lib
        except Exception:
            _lib = None
    return _lib


def native_available():
    return get_lib() is not None


def path_rgreedy_native(
    inputs, output, sizes, repeats=32, temperature=1.0, seed=None,
    patience=16, max_seconds=2.0, stop_flops=0.0,
):
    """Run the native multi-restart randomized greedy search.

    Parameters mirror :func:`.paths.path_random_greedy`;
    returns an ssa path (list of index pairs) or ``None`` if the native
    library is unavailable. ``patience`` stops the search after that
    many consecutive non-improving noisy restarts; ``max_seconds``
    wall-clock-bounds it (either may be 0 to disable) — both exist so
    per-sample path searches on large circuit marginal networks stay a
    setup-time detail rather than the dominant cost. ``stop_flops``
    skips the noisy restarts entirely when the deterministic cost-mod
    sweep already found a path cheaper than it — search effort then
    scales with how expensive the contraction actually is.
    """
    lib = get_lib()
    if lib is None:
        return None

    n = len(inputs)
    if n < 2:
        return None

    # map index labels -> dense int ids
    ind_ids = {}
    flat = []
    offsets = np.zeros(n + 1, dtype=np.int32)
    for i, term in enumerate(inputs):
        for ix in term:
            flat.append(ind_ids.setdefault(ix, len(ind_ids)))
        offsets[i + 1] = len(flat)
    n_inds = len(ind_ids)
    term_inds = np.asarray(flat, dtype=np.int32)
    log2_sizes = np.zeros(n_inds, dtype=np.float64)
    for ix, k in ind_ids.items():
        log2_sizes[k] = np.log2(max(float(sizes[ix]), 1.0))
    is_output = np.zeros(n_inds, dtype=np.uint8)
    for ix in output:
        if ix in ind_ids:
            is_output[ind_ids[ix]] = 1

    out_path = np.zeros(2 * (n - 1), dtype=np.int32)
    out_flops = ctypes.c_double(0.0)
    if seed is None:
        seed = 42
    rc = lib.find_path_rgreedy2(
        np.int32(n),
        np.int32(n_inds),
        offsets,
        term_inds,
        log2_sizes,
        is_output,
        np.int32(repeats),
        np.uint64(int(seed) & (2**64 - 1)),
        float(temperature),
        np.int32(patience),
        float(max_seconds * 1000.0),
        float(stop_flops),
        out_path,
        ctypes.byref(out_flops),
    )
    if rc != 0:
        return None
    return [
        (int(out_path[2 * i]), int(out_path[2 * i + 1]))
        for i in range(n - 1)
    ]
