"""A world of gloo ranks on the CPU, for the tests of
``quimb_torch.parallel`` and of the sharded engines.

:func:`start` spawns ``nprocs`` processes that join one gloo world
(a file store in a temporary directory) and run every case of a list in
turn, each on every rank with the same inputs; :meth:`World.results`
waits for them and returns each rank's results, by case. The processes
import torch and quimb_torch only: the cases and their inputs come from
the test module's parent process, which computes quimb_tpu's values
meanwhile. quimb_tpu's networks cross as :func:`duck` copies (plain
attributes and numpy arrays) that ``quimb_torch.convert`` reads as it
reads quimb_tpu's own objects. An input that takes the parent long to
make can follow the start: :meth:`World.send` it, and a case reads it
with :func:`late`.
"""

import multiprocessing
import os
import pickle
import time
import traceback
import types

import numpy as np

#: the seconds a world may take before it is stopped
TIMEOUT = 240


def duck(tn, **attrs):
    """A picklable copy of a quimb_tpu network: each tensor's data (as a
    numpy array), indices and tags, and the network's ``attrs``."""
    tensors = {tid: types.SimpleNamespace(
        data=np.asarray(t.data), inds=tuple(t.inds), tags=tuple(t.tags))
        for tid, t in tn.tensor_map.items()}
    return types.SimpleNamespace(tensor_map=tensors, **attrs)


def late(inputs, key):
    """The input ``key`` that the parent sends after the start, once it is
    there."""
    path = os.path.join(inputs["_dir"], f"late-{key}.pkl")
    deadline = time.monotonic() + TIMEOUT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no input {key!r}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_main(rank, nprocs, store, out, cases, inputs):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=nprocs)
    results = {}

    def save():
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)

    for name, fn in cases:
        t0 = time.perf_counter()
        try:
            results[name] = fn(inputs)
        except Exception:
            # the other ranks may wait in a collective of this case: stop
            # the world (their collectives then fail too)
            results[name] = ("error", traceback.format_exc())
            save()
            os._exit(3)
        results[name + ":seconds"] = time.perf_counter() - t0
    dist.destroy_process_group()
    save()


class World:
    def __init__(self, procs, out):
        self.procs, self.out = procs, out
        self._results = None

    def send(self, key, value):
        """Make the input ``key`` readable by :func:`late`."""
        path = os.path.join(self.out, f"late-{key}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(value, f)
        os.replace(path + ".tmp", path)

    def results(self):
        """Each rank's results, by case: ``{case: [rank 0's, ...]}``."""
        if self._results is None:
            deadline = time.monotonic() + TIMEOUT
            for p in self.procs:
                p.join(max(deadline - time.monotonic(), 0))
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            codes = [p.exitcode for p in self.procs]
            ranks = []
            for r in range(len(self.procs)):
                path = os.path.join(self.out, f"rank{r}.pkl")
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        ranks.append(pickle.load(f))
            if codes != [0] * len(codes):
                errors = [v[1] for rk in ranks for v in rk.values()
                          if isinstance(v, tuple) and v[:1] == ("error",)]
                raise RuntimeError(f"the world's ranks exited {codes}\n"
                                   + "\n".join(errors[:1]))
            self._results = {k: [rk[k] for rk in ranks] for k in ranks[0]}
        return self._results


def start(cases, inputs, nprocs, tmpdir):
    """Spawn the world, ``nprocs`` ranks, on the cases ``[(name, fn)]``
    (module-level functions of ``inputs``); returns its :class:`World`."""
    ctx = multiprocessing.get_context("spawn")
    store, out = os.path.join(tmpdir, "store"), str(tmpdir)
    inputs = {**inputs, "_dir": out}
    # one BLAS thread in each rank: the ranks share the host with the
    # other test workers
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS")}
    os.environ.update({k: "1" for k in saved})
    try:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, nprocs, store, out, cases, inputs))
                 for r in range(nprocs)]
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return World(procs, out)


def same_on_every_rank(values):
    """Whether every rank's value equals rank 0's, bit for bit."""
    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(same, a, b))
        if isinstance(a, (np.ndarray, float, complex, np.number)):
            return np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=True)
        return a == b
    return all(same(values[0], v) for v in values[1:])
