// pathfinder.cpp — native contraction-path search.
//
// The TPU-native analogue of the reference's cotengrust (Rust) fast
// path-search backend (SURVEY §2: "cotengra (Py) + cotengrust (Rust) +
// kahypar (C++)"): multi-restart randomized greedy over the tensor
// hypergraph, entirely setup-time/host-side. Called from
// quimb_tpu.ops.paths via ctypes; the pure-python implementation remains
// as fallback and reference.
//
// Hot-path design: all index ids are known up front (contractions never
// create new indices), so membership tests use epoch-stamped mark arrays
// instead of hash sets — zero allocation per candidate scoring. Scores
// are long doubles (range 2^16384) so large-tensor comparisons never
// saturate.
//
// Build:  g++ -O3 -shared -fPIC -std=c++17 pathfinder.cpp -o libpathfinder.so
//
// Interface (C ABI):
//   int64_t find_path_rgreedy(
//       int32_t n_tensors, int32_t n_inds,
//       const int32_t* term_offsets,   // n_tensors+1 offsets into term_inds
//       const int32_t* term_inds,      // flattened index ids per tensor
//       const double*  log2_sizes,     // n_inds
//       const uint8_t* is_output,      // n_inds
//       int32_t repeats, uint64_t seed, double temperature,
//       int32_t* out_path,             // 2*(n_tensors-1) ssa pairs
//       double*  out_flops)            // best flops-sum found (clamped)
//   returns 0 on success.

#include <chrono>
#include <cstdint>
#include <cmath>
#include <vector>
#include <queue>
#include <random>
#include <algorithm>
#include <unordered_set>
#include <limits>

namespace {

struct Candidate {
    long double score;
    int32_t a, b;
    bool operator<(const Candidate& o) const {
        return score > o.score;  // min-heap via std::priority_queue
    }
};

// long double exp2 with clamping — range ~2^16384 covers any realistic
// log2-size without the saturation that breaks score comparisons
inline long double xexp2(double l2) {
    return std::exp2((long double)std::min(l2, 16000.0));
}

struct Graph {
    int32_t n_inds;
    const double* log2_sizes;
    const uint8_t* is_output;

    std::vector<std::vector<int32_t>> ssa_inds;  // inds of each ssa node
    std::vector<double> ssa_log_size;            // log2 size of node
    std::vector<int32_t> ind_count;              // remaining holders
    std::vector<std::vector<int32_t>> ind_to_ssa;  // append-only holder list
    std::vector<uint8_t> alive;

    // epoch-stamped scratch (no per-call allocation)
    std::vector<uint32_t> mark_a, mark_b;   // over ind ids
    std::vector<uint32_t> mark_node;        // over ssa ids
    uint32_t epoch = 0;
    std::vector<int32_t> scratch_out;       // result inds buffer

    void init(int32_t n_tensors, int32_t n_inds_,
              const double* l2s, const uint8_t* is_out,
              const int32_t* term_offsets, const int32_t* term_inds) {
        n_inds = n_inds_;
        log2_sizes = l2s;
        is_output = is_out;
        ssa_inds.clear();
        ssa_inds.reserve(2 * n_tensors);
        ssa_log_size.clear();
        ssa_log_size.reserve(2 * n_tensors);
        ind_count.assign(n_inds, 0);
        ind_to_ssa.assign(n_inds, {});
        alive.assign(n_tensors, 1);
        alive.reserve(2 * n_tensors);
        mark_a.assign(n_inds, 0);
        mark_b.assign(n_inds, 0);
        mark_node.assign(2 * n_tensors, 0);
        epoch = 0;
        scratch_out.reserve(n_inds);

        for (int32_t i = 0; i < n_tensors; ++i) {
            std::vector<int32_t> inds;
            ++epoch;
            for (int32_t k = term_offsets[i]; k < term_offsets[i + 1]; ++k) {
                int32_t ix = term_inds[k];
                if (mark_a[ix] != epoch) {
                    mark_a[ix] = epoch;
                    inds.push_back(ix);
                    ind_count[ix] += 1;
                    ind_to_ssa[ix].push_back(i);
                }
            }
            ssa_log_size.push_back(node_log_size(inds));
            ssa_inds.push_back(std::move(inds));
        }
    }

    double node_log_size(const std::vector<int32_t>& inds) const {
        double s = 0.0;
        for (int32_t ix : inds) s += log2_sizes[ix];
        return s;
    }

    // compute result inds of contracting a,b into scratch_out; also
    // returns (via out params) log2 result size and log2 pair flops
    void result_inds(int32_t a, int32_t b,
                     double* log2_rsize, double* log2_fl) {
        scratch_out.clear();
        ++epoch;
        for (int32_t ix : ssa_inds[a]) mark_a[ix] = epoch;
        for (int32_t ix : ssa_inds[b]) mark_b[ix] = epoch;
        double rs = 0.0, fl = 0.0;
        for (int pass = 0; pass < 2; ++pass) {
            const auto& src = pass == 0 ? ssa_inds[a] : ssa_inds[b];
            for (int32_t ix : src) {
                bool in_a = mark_a[ix] == epoch;
                bool in_b = mark_b[ix] == epoch;
                if (pass == 1 && in_a) continue;  // already handled
                fl += log2_sizes[ix];
                int both = (in_a && in_b) ? 2 : 1;
                if (ind_count[ix] - both > 0 || is_output[ix]) {
                    scratch_out.push_back(ix);
                    rs += log2_sizes[ix];
                }
            }
        }
        *log2_rsize = rs;
        *log2_fl = fl;
    }
};

// one randomized greedy run; returns total flops estimate and fills path
long double run_greedy(
    Graph& g, int32_t n_tensors,
    double temperature, double costmod, std::mt19937_64& rng,
    std::vector<int32_t>& path_out)
{
    std::uniform_real_distribution<double> unif(1e-12, 1.0);
    std::priority_queue<Candidate> heap;
    std::unordered_set<uint64_t> seen_pairs;
    seen_pairs.reserve(8 * n_tensors);

    auto score_pair = [&](int32_t a, int32_t b) {
        double rs, fl;
        g.result_inds(a, b, &rs, &fl);
        long double sc = xexp2(rs)
                  - (long double)costmod * (xexp2(g.ssa_log_size[a])
                                          + xexp2(g.ssa_log_size[b]));
        if (temperature > 0.0) {
            long double gmb = -std::log(-std::log(unif(rng)));
            sc -= temperature * gmb
                * std::max(std::abs(sc), (long double)1.0);
        }
        return sc;
    };

    // NOTE: score_pair advances g.epoch (via result_inds), so gather the
    // neighbor set fully BEFORE scoring — stale marks otherwise let
    // self-pairs and duplicates through.
    std::vector<int32_t> neigh;
    auto push_candidates = [&](int32_t i) {
        ++g.epoch;
        g.mark_node[i] = g.epoch;
        neigh.clear();
        for (int32_t ix : g.ssa_inds[i]) {
            for (int32_t j : g.ind_to_ssa[ix]) {
                if (j == i) continue;
                if ((size_t)j >= g.alive.size() || !g.alive[j]) continue;
                if (g.mark_node[j] == g.epoch) continue;
                g.mark_node[j] = g.epoch;
                neigh.push_back(j);
            }
        }
        for (int32_t j : neigh) {
            int32_t a = std::min(i, j), b = std::max(i, j);
            uint64_t key = ((uint64_t)a << 32) | (uint32_t)b;
            if (!seen_pairs.insert(key).second) continue;
            heap.push({score_pair(a, b), a, b});
        }
    };

    for (int32_t i = 0; i < n_tensors; ++i) push_candidates(i);

    int32_t n_alive = n_tensors;
    long double total_flops = 0.0;
    path_out.clear();

    std::vector<int32_t> alive_list;
    while (n_alive > 1) {
        int32_t a = -1, b = -1;
        while (!heap.empty()) {
            Candidate c = heap.top(); heap.pop();
            if (g.alive[c.a] && g.alive[c.b]) { a = c.a; b = c.b; break; }
        }
        if (a < 0) {
            // disconnected: contract the two smallest alive nodes
            alive_list.clear();
            for (size_t i = 0; i < g.alive.size(); ++i)
                if (g.alive[i]) alive_list.push_back((int32_t)i);
            std::partial_sort(
                alive_list.begin(), alive_list.begin() + 2,
                alive_list.end(),
                [&](int32_t x, int32_t y) {
                    return g.ssa_log_size[x] < g.ssa_log_size[y];
                });
            a = alive_list[0]; b = alive_list[1];
            if (a > b) std::swap(a, b);
        }

        double rs, fl;
        g.result_inds(a, b, &rs, &fl);
        total_flops += xexp2(fl);
        std::vector<int32_t> rout(g.scratch_out);

        // decrement holders of every ind of a and b (mark arrays are
        // still stamped from result_inds' epoch)
        for (int32_t ix : g.ssa_inds[a]) g.ind_count[ix] -= 1;
        for (int32_t ix : g.ssa_inds[b]) g.ind_count[ix] -= 1;

        int32_t k = (int32_t)g.ssa_inds.size();
        for (int32_t ix : rout) {
            g.ind_count[ix] += 1;
            g.ind_to_ssa[ix].push_back(k);
        }
        g.ssa_log_size.push_back(rs);
        g.ssa_inds.push_back(std::move(rout));
        g.alive[a] = 0;
        g.alive[b] = 0;
        g.alive.push_back(1);
        if (g.mark_node.size() < g.alive.size())
            g.mark_node.resize(2 * g.alive.size(), 0);
        n_alive -= 1;
        path_out.push_back(a);
        path_out.push_back(b);
        push_candidates(k);
    }
    return total_flops;
}

}  // namespace

// Core multi-restart driver. The first four restarts are a
// deterministic (temperature-0) sweep over cost modifiers — these are
// 10-30x cheaper than noisy restarts (noise produces worse greedy
// choices -> fatter intermediates -> more candidate scoring) and
// usually contain the best path. Noisy restarts then continue until
// `repeats` are done, `patience` consecutive restarts fail to improve,
// or `max_ms` of wall-clock has elapsed — bounding setup-time path
// search on large (500-5000 tensor) circuit-sampling networks where an
// unbounded 128-restart search used to cost ~20 s per marginal.
static int64_t rgreedy_driver(
    int32_t n_tensors, int32_t n_inds,
    const int32_t* term_offsets, const int32_t* term_inds,
    const double* log2_sizes, const uint8_t* is_output,
    int32_t repeats, uint64_t seed, double temperature,
    int32_t patience, double max_ms, double stop_flops,
    int32_t* out_path, double* out_flops)
{
    if (n_tensors < 2) return 1;
    std::mt19937_64 rng(seed);
    std::vector<int32_t> best, trial;
    long double best_fl = std::numeric_limits<long double>::infinity();
    const double det_costmods[4] = {1.0, 0.5, 2.0, 4.0};
    const double costmods[3] = {0.5, 1.0, 2.0};
    Graph g;
    auto t0 = std::chrono::steady_clock::now();
    int32_t since_improve = 0;
    for (int32_t r = 0; r < std::max(repeats, 1); ++r) {
        bool det = r < 4;
        double temp = det ? 0.0 : temperature;
        double cm = det ? det_costmods[r] : costmods[r % 3];
        g.init(n_tensors, n_inds, log2_sizes, is_output,
               term_offsets, term_inds);
        long double fl = run_greedy(g, n_tensors, temp, cm, rng, trial);
        if (fl < best_fl) {
            best_fl = fl;
            best = trial;
            since_improve = 0;
        } else if (!det) {
            ++since_improve;
        }
        if (r >= 3) {  // always finish the deterministic sweep
            // cheap contraction: more search would cost more than the
            // contraction itself (per-sample circuit marginals)
            if (stop_flops > 0.0 && best_fl < (long double)stop_flops)
                break;
            if (patience > 0 && since_improve >= patience) break;
            double ms = std::chrono::duration<double, std::milli>(
                std::chrono::steady_clock::now() - t0).count();
            if (max_ms > 0.0 && ms >= max_ms) break;
        }
    }
    for (size_t i = 0; i < best.size(); ++i) out_path[i] = best[i];
    *out_flops = (double)std::min(
        best_fl, (long double)std::numeric_limits<double>::max());
    return 0;
}

extern "C" int64_t find_path_rgreedy(
    int32_t n_tensors, int32_t n_inds,
    const int32_t* term_offsets, const int32_t* term_inds,
    const double* log2_sizes, const uint8_t* is_output,
    int32_t repeats, uint64_t seed, double temperature,
    int32_t* out_path, double* out_flops)
{
    return rgreedy_driver(
        n_tensors, n_inds, term_offsets, term_inds, log2_sizes,
        is_output, repeats, seed, temperature,
        /*patience=*/0, /*max_ms=*/0.0, /*stop_flops=*/0.0,
        out_path, out_flops);
}

extern "C" int64_t find_path_rgreedy2(
    int32_t n_tensors, int32_t n_inds,
    const int32_t* term_offsets, const int32_t* term_inds,
    const double* log2_sizes, const uint8_t* is_output,
    int32_t repeats, uint64_t seed, double temperature,
    int32_t patience, double max_ms, double stop_flops,
    int32_t* out_path, double* out_flops)
{
    return rgreedy_driver(
        n_tensors, n_inds, term_offsets, term_inds, log2_sizes,
        is_output, repeats, seed, temperature, patience, max_ms,
        stop_flops, out_path, out_flops);
}
