"""Host-side contraction path optimization: quimb_tpu's ``ops/paths.py``,
copied as it is (numpy only), so that the port finds the same paths.

Path search is a setup-time, host-side computation; the result is run as
a chain of pairwise contractions on the device (:mod:`.contraction`).

Supports:

- hyper-indices (an index shared by any number of tensors, kept until its
  last holder is contracted — matches cotengra/einsum semantics),
- explicit output indices,
- ``optimal`` exact DP search (small n), ``greedy`` (large n) with
  deterministic tie-breaking, ``random-greedy`` (multi-restart with
  temperature noise, keep best by flops),
- cost/width estimation (``contract_cost``, ``contract_width``) used by
  ``contraction_info`` / ``rehearse`` style introspection,
- index slicing selection (``find_sliced_inds``) for memory-bounded /
  multi-chip execution.
"""

import functools
import heapq
import itertools
import math
import os
import random

# ---------------------------------------------------------------------------
# data model: inputs = list[tuple[str]], output = tuple[str], sizes = dict
# a "path" is a list of tuples of positions (ssa or linear, like opt_einsum)
# ---------------------------------------------------------------------------


def compute_size_by_dict(inds, sizes):
    p = 1
    for ix in inds:
        p *= sizes[ix]
    return p


def _result_inds(ia, ib, ind_counts, output):
    """Indices of the tensor resulting from contracting tensors with inds
    ``ia``/``ib``, given global remaining counts of each index."""
    out = []
    seen = set()
    both = set(ia) & set(ib)
    for ix in itertools.chain(ia, ib):
        if ix in seen:
            continue
        seen.add(ix)
        cnt = ind_counts[ix] - (2 if ix in both else 1)
        if cnt > 0 or ix in output:
            out.append(ix)
    return tuple(out)


def flops_pair(ia, ib, sizes):
    """Scalar-multiplication count for a pairwise contraction — product of
    the union of dimensions (standard einsum cost model)."""
    seen = {}
    for ix in itertools.chain(ia, ib):
        seen[ix] = None
    return compute_size_by_dict(seen, sizes)


# ---------------------------------------------------------------------------
# greedy
# ---------------------------------------------------------------------------


def path_greedy(inputs, output, sizes, temperature=0.0, rng=None, costmod=1.0):
    """Greedy pairwise contraction ordering.

    Repeatedly contracts the pair with the lowest score
    ``size(result) - costmod * (size(a) + size(b))`` (memory-removed
    heuristic), optionally perturbed by gumbel noise with ``temperature``
    for random-greedy restarts. Only *connected* pairs (sharing an index)
    are considered; disconnected remainders are contracted at the end by
    increasing size.

    Returns an ssa path: each step is a pair of ssa ids; the result of
    step k gets ssa id ``len(inputs) + k``.
    """
    n = len(inputs)
    if n == 1:
        return [(0,)]
    output = set(output)

    ind_counts = {}
    ind_to_ssa = {}
    for i, term in enumerate(inputs):
        for ix in set(term):
            ind_counts[ix] = ind_counts.get(ix, 0) + 1
            ind_to_ssa.setdefault(ix, set()).add(i)

    ssa_inds = {i: tuple(dict.fromkeys(term)) for i, term in enumerate(inputs)}
    ssa_sizes = {
        i: compute_size_by_dict(t, sizes) for i, t in ssa_inds.items()
    }
    alive = set(ssa_inds)
    next_ssa = n
    path = []

    def score(i, j):
        rout = _result_inds(ssa_inds[i], ssa_inds[j], ind_counts, output)
        rsize = compute_size_by_dict(rout, sizes)
        sc = rsize - costmod * (ssa_sizes[i] + ssa_sizes[j])
        if temperature and rng is not None:
            # gumbel perturbation on log-ish scale
            g = -math.log(-math.log(rng.random() + 1e-300) + 1e-300)
            sc = sc - temperature * g * max(abs(sc), 1.0)
        return sc

    # candidate heap of connected pairs
    heap = []
    seen_pairs = set()

    def push_candidates_for(i):
        neighbors = set()
        for ix in ssa_inds[i]:
            neighbors |= ind_to_ssa[ix]
        neighbors.discard(i)
        for j in neighbors:
            key = (min(i, j), max(i, j))
            if key not in seen_pairs:
                seen_pairs.add(key)
                heapq.heappush(heap, (score(*key), key))

    for i in range(n):
        push_candidates_for(i)

    while len(alive) > 1:
        while heap:
            sc, (i, j) = heapq.heappop(heap)
            if i in alive and j in alive:
                break
        else:
            # no connected pairs left: contract smallest two (outer product)
            i, j = sorted(alive, key=lambda k: ssa_sizes[k])[:2]

        rout = _result_inds(ssa_inds[i], ssa_inds[j], ind_counts, output)
        # update index bookkeeping
        both = set(ssa_inds[i]) & set(ssa_inds[j])
        for ix in set(ssa_inds[i]) | set(ssa_inds[j]):
            ind_counts[ix] -= 2 if ix in both else 1
            s = ind_to_ssa[ix]
            s.discard(i)
            s.discard(j)
        k = next_ssa
        next_ssa += 1
        ssa_inds[k] = rout
        ssa_sizes[k] = compute_size_by_dict(rout, sizes)
        for ix in rout:
            ind_counts[ix] += 1
            ind_to_ssa[ix].add(k)
        alive.discard(i)
        alive.discard(j)
        alive.add(k)
        path.append((i, j))
        push_candidates_for(k)

    return path


# ---------------------------------------------------------------------------
# optimal (bitmask DP over connected subgraphs, flops objective)
# ---------------------------------------------------------------------------


def path_optimal(inputs, output, sizes, flops_cap=None):
    """Exact dynamic program minimizing total flops. Exponential in n —
    use for n <= ~14 (the reference relies on opt_einsum/cotengra
    'optimal' similarly)."""
    n = len(inputs)
    if n == 1:
        return [(0,)]
    output = set(output)

    all_counts = {}
    for term in inputs:
        for ix in set(term):
            all_counts[ix] = all_counts.get(ix, 0) + 1

    def subset_result(mask_terms):
        """Indices of the tensor from contracting the subset fully."""
        cnt = {}
        for t in mask_terms:
            for ix in set(inputs[t]):
                cnt[ix] = cnt.get(ix, 0) + 1
        return tuple(
            ix for ix, c in cnt.items()
            if (all_counts[ix] - c) > 0 or ix in output
        )

    members = {1 << i: [i] for i in range(n)}
    # best[mask] = (flops, inds, path)
    best = {
        1 << i: (0, tuple(dict.fromkeys(inputs[i])), [])
        for i in range(n)
    }

    full = (1 << n) - 1
    # iterate subsets by popcount
    masks_by_size = {}
    for mask in range(1, full + 1):
        masks_by_size.setdefault(bin(mask).count("1"), []).append(mask)

    for sz in range(2, n + 1):
        for mask in masks_by_size[sz]:
            ms = [i for i in range(n) if mask & (1 << i)]
            members[mask] = ms
            best_entry = None
            sub = (mask - 1) & mask
            while sub:
                comp = mask ^ sub
                if sub < comp:  # visit each bipartition once
                    a, b = sub, comp
                    ea = best.get(a)
                    eb = best.get(b)
                    if ea is not None and eb is not None:
                        fl = ea[0] + eb[0] + flops_pair(ea[1], eb[1], sizes)
                        if (best_entry is None or fl < best_entry[0]) and (
                            flops_cap is None or fl <= flops_cap
                        ):
                            rind = subset_result(ms)
                            best_entry = (fl, rind, a, b)
                sub = (sub - 1) & mask
            if best_entry is not None:
                fl, rind, a, b = best_entry
                best[mask] = (fl, rind, best[a][2] + best[b][2] + [(a, b)])

    # convert mask-pairs to ssa path
    fl, rind, mask_path = best[full]
    ssa_of_mask = {1 << i: i for i in range(n)}
    next_ssa = n
    path = []
    for a, b in mask_path:
        path.append((ssa_of_mask[a], ssa_of_mask[b]))
        ssa_of_mask[a | b] = next_ssa
        next_ssa += 1
    return path


# ---------------------------------------------------------------------------
# random greedy
# ---------------------------------------------------------------------------


def path_random_greedy(
    inputs, output, sizes, repeats=32, temperature=1.0, seed=None
):
    """Multi-restart greedy with noise; keep the lowest-flops path.

    Uses the native (C++) search from :mod:`.native` when
    available — the analogue of the reference's cotengrust backend —
    falling back to the pure-python greedy below. Both paths are
    validated against each other (see tests/test_ops/test_native.py).
    """
    from .native import path_rgreedy_native

    # native search is ~30-50x faster per restart, so spend some of that
    # on extra restarts for better paths — but bounded: the native side
    # stops early after 16 non-improving restarts or the wall-clock
    # budget, whichever first (per-sample circuit marginals re-search on
    # every fresh geometry, so an unbounded search dominates sampling)
    # scale the wall-clock budget with network size: per-sample
    # circuit marginals (~50-150 terms) would otherwise spend the full
    # budget on every fresh value-simplified geometry
    budget = float(os.environ.get("QUIMB_TPU_PATH_SECONDS", 0.0)) or \
        max(0.04, min(0.5, len(inputs) / 500.0))
    npath = path_rgreedy_native(
        inputs, output, sizes,
        repeats=4 * repeats, temperature=temperature, seed=seed,
        patience=16,
        max_seconds=budget,
        stop_flops=float(os.environ.get("QUIMB_TPU_PATH_STOP_FLOPS", 1e9)),
    )
    if npath is not None:
        # guard: keep whichever of native / plain-greedy costs less
        gpath = path_greedy(inputs, output, sizes)
        if path_cost(inputs, output, sizes, npath) <= path_cost(
            inputs, output, sizes, gpath
        ):
            return npath
        return gpath

    rng = random.Random(seed)
    best_path = path_greedy(inputs, output, sizes)
    best_cost = path_cost(inputs, output, sizes, best_path)
    for _ in range(repeats):
        trial = path_greedy(
            inputs, output, sizes,
            temperature=temperature, rng=rng,
            costmod=rng.choice((0.5, 1.0, 2.0)),
        )
        c = path_cost(inputs, output, sizes, trial)
        if c < best_cost:
            best_cost, best_path = c, trial
    return best_path


# ---------------------------------------------------------------------------
# path introspection
# ---------------------------------------------------------------------------


def simulate_path(inputs, output, sizes, path):
    """Yield (ia, ib, result_inds) for each pairwise step of an ssa path."""
    output_set = set(output)
    ind_counts = {}
    for term in inputs:
        for ix in set(term):
            ind_counts[ix] = ind_counts.get(ix, 0) + 1
    ssa_inds = {i: tuple(dict.fromkeys(t)) for i, t in enumerate(inputs)}
    next_ssa = len(inputs)
    for step in path:
        if len(step) == 1:
            (i,) = step
            ia = ssa_inds[i]
            rout = tuple(
                ix for ix in dict.fromkeys(ia)
                if ind_counts[ix] - ia.count(ix) > 0 or ix in output_set
            )
            yield ia, None, rout
            ssa_inds[next_ssa] = rout
            next_ssa += 1
            continue
        i, j = step
        ia, ib = ssa_inds[i], ssa_inds[j]
        rout = _result_inds(ia, ib, ind_counts, output_set)
        both = set(ia) & set(ib)
        for ix in set(ia) | set(ib):
            ind_counts[ix] -= 2 if ix in both else 1
        for ix in rout:
            ind_counts[ix] += 1
        yield ia, ib, rout
        ssa_inds[next_ssa] = rout
        next_ssa += 1


def path_cost(inputs, output, sizes, path):
    """Total scalar-multiplication count of a path."""
    total = 0
    for ia, ib, rout in simulate_path(inputs, output, sizes, path):
        if ib is None:
            total += compute_size_by_dict(set(ia), sizes)
        else:
            total += flops_pair(ia, ib, sizes)
    return total


def path_width(inputs, output, sizes, path):
    """log2 of the largest intermediate tensor size."""
    w = max(
        (compute_size_by_dict(rout, sizes)
         for _, _, rout in simulate_path(inputs, output, sizes, path)),
        default=1,
    )
    w = max(w, max((compute_size_by_dict(t, sizes) for t in inputs), default=1))
    return math.log2(max(w, 1))


# ---------------------------------------------------------------------------
# slicing — choose indices to slice to fit a memory budget / spread across
# chips (reference: cotengra sliced inds; `cut_iter` tensor_core.py:9088)
# ---------------------------------------------------------------------------


def find_sliced_inds(
    inputs, output, sizes, path, target_size=None, target_slices=None
):
    """Greedily pick indices to slice (remove from every tensor holding
    them, looping over their values at execution time) until the largest
    intermediate is under ``target_size`` and/or the number of slices is
    at least ``target_slices``."""
    sizes = dict(sizes)
    sliced = []
    nslices = 1
    for _ in range(64):
        # current largest intermediates
        steps = list(simulate_path(inputs, output, sizes, path))
        wmax, rmax = 1, None
        for ia, ib, rout in steps:
            sz = compute_size_by_dict(rout, sizes)
            if sz > wmax:
                wmax, rmax = sz, rout
        ok_size = target_size is None or wmax <= target_size
        ok_slices = target_slices is None or nslices >= target_slices
        if (ok_size and ok_slices) or rmax is None:
            break
        # slice the largest dim of the biggest intermediate, preferring
        # indices not in the output
        cands = [ix for ix in rmax if ix not in output and sizes[ix] > 1]
        if not cands:
            cands = [ix for ix in rmax if sizes[ix] > 1]
        if not cands:
            break
        ix = max(cands, key=lambda k: sizes[k])
        sliced.append(ix)
        nslices *= sizes[ix]
        sizes[ix] = 1
    return tuple(sliced)


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------


def ssa_to_linear(path, n):
    """Convert ssa path to opt_einsum-style linear path (positions in the
    shrinking list)."""
    ids = list(range(n))
    out = []
    for step in path:
        pos = tuple(sorted(ids.index(s) for s in step))
        out.append(pos)
        for p in sorted(pos, reverse=True):
            ids.pop(p)
        ids.append(n)
        n += 1
    return out


def optimize_path(inputs, output, sizes, optimize="auto"):
    """Find a contraction path. ``optimize`` may be:

    - ``'auto'``: optimal for <= 8 terms else greedy
    - ``'optimal'``, ``'greedy'``, ``'random-greedy'``
    - an explicit path (list of tuples) — passed through.
    """
    if isinstance(optimize, (list, tuple)) and optimize and isinstance(
        optimize[0], (list, tuple)
    ):
        return list(map(tuple, optimize))
    n = len(inputs)
    if n == 0:
        return []
    if n == 1:
        return [(0,)]
    if optimize in ("auto", "auto-hq", None):
        if n <= 8:
            optimize = "optimal"
        else:
            # the native multi-restart search is fast enough to be the
            # default at any size; pure-python falls back to plain
            # greedy beyond 64 terms
            from .native import native_available

            optimize = (
                "random-greedy"
                if (native_available() or n <= 64) else "greedy"
            )
    if optimize == "optimal" and n <= 16:
        return path_optimal(inputs, output, sizes)
    if optimize == "random-greedy":
        return path_random_greedy(inputs, output, sizes)
    return path_greedy(inputs, output, sizes)
