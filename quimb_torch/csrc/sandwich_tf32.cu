// The float32 DMRG effective-Hamiltonian "sandwich" matvec on Hopper
// (sm_90a), on the tensor cores in 3xTF32:
//
//     out (M, N) = sum_{x < w}  A[x] (M, K1) @ theta (K1, K2) @ B[x] (K2, N)
//
// It replaces the Pallas TPU kernel quimb_tpu/ops/pallas_kernels.py:
// _sandwich_kernel (launched by sandwich_matvec there) for float32; the
// float64 matvec runs on the FP64 tensor cores in sandwich_f64.cu.
//
// What bounded the first port (an FP32-FMA SIMT GEMM, 0.40 ms at
// w = 5, M = K1 = K2 = N = 512 on an H100, 6.75 TFLOP/s):
//   1. shared-memory traffic: 8 scalar shared loads per 16 FMAs;
//   2. synchronous scalar global loads with one stage, so load latency
//      was exposed twice per 16-deep step;
//   3. its second launch had 64 blocks for 132 SMs;
//   4. the FP32 pipes themselves cap at 67 TFLOP/s.
//
// What this design does about each:
//   * 3xTF32 on the tensor cores (wgmma). Every operand x is split into
//     big = tf32(x) and small = tf32(x - big) (rounded to nearest, ties
//     away, by "add 0x1000, mask 0xFFFFE000"); a product is
//     a_small b_big + a_big b_small + a_big b_big in FP32 accumulators,
//     which keeps float32 accuracy (a_small b_small, ~2^-22 relative, is
//     dropped). The stacks A and B, fixed over the matvecs of one local
//     solve, are padded, laid out and split once per solve by
//     prepare_sandwich (plain torch); theta is split per matvec by a small
//     transposing kernel here, and T is split by pass 1's epilogue.
//   * wgmma reads tf32 operands from shared memory K-major only, so the
//     roles are chosen so that no stack is transposed per matvec:
//       pass 1:  T_x^T (K2, M) = theta^T (K2, K1) . A[x]^T   (A[x] is K-major
//                as stored, (M, K1)); the epilogue writes the tile
//                transposed and split into T (2, M, w K2);
//       pass 2:  P[x] (M, N) = T_x (M, K2) . B[x]             (B prepared as
//                B[x]^T, (N, K2), K-major);
//       reduce:  out = sum_x P[x], in a fixed order.
//   * TMA (cp.async.bulk.tensor, 128-byte swizzle) fills a ring of
//     mbarrier-guarded stages; one producer warp starts the copies, one
//     consumer warpgroup runs the wgmmas.
//   * Each 32-deep stage is summed by the tensor cores alone and added
//     into the FP32 accumulators with round-to-nearest adds. Accumulated
//     across the whole depth (512) in the tensor cores, the matvec's error
//     at the shape above was 6.7e-6 relative to float64 on an H100; with
//     the per-stage adds it is 4.5e-7.
//   * What bounds it now is the chain of wgmmas, each stage waited for
//     before its sum is added, not the copies: at the shape above, with 4
//     stages, a pass took 26.9 us on an H100, 24.3 us without its copies
//     and 16.8 us without its wgmmas. So the ring has 2 stages (96 KB),
//     and two blocks share an SM, each filling the other's waits; all 160
//     blocks of a pass are then resident at once, and a pass took 22.4 us.
//   * Pass 2 is split over x (one block per output tile and x), so it
//     launches w times the output tiles: 160 blocks at the shape above.
//     The partial sums meet in a (w, M, N) scratch that a last kernel adds
//     in order of x: no atomics, so the result is bitwise repeatable.
//   * Ragged shapes: the prepared stacks and scratch are zero-padded to
//     whole tiles (M, N to 128; K1 to 32; K2 to 64), theta is padded by
//     its split kernel and the reduce writes only the (M, N) corner, so
//     every float32 bond is taken, down to 1 x 1.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBM = 64;        // rows of a block's D tile: one warpgroup
constexpr int kBN = 128;       // columns of a block's D tile: wgmma n128
constexpr int kBK = 32;        // depth of a stage: one 128-byte row
constexpr int kStages = 2;
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kATile = kBM * kBK * 4;      // bytes of one A half-tile
constexpr int kBTile = kBN * kBK * 4;      // bytes of one B half-tile
constexpr int kStageBytes = 2 * kATile + 2 * kBTile;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A stage arrives
// within microseconds; a wait that has not completed after 2^26 polls
// (well over 0.1 s) is a fault, and traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls > (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 2-D tensor map, {col, row} = {c0, c1}, into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows in
// the 128-byte swizzle that the TMA boxes are written in: 8-row groups
// are 1024 bytes apart (SBO); LBO is unused for swizzled K-major tiles.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define QT_ACC8(i)                                                      \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (64 x 128 per warpgroup) = A (64 x 8, tf32) . B (128 x 8, tf32)^T
// + (accumulate ? d : 0), both operands from shared memory.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : QT_ACC8(0), QT_ACC8(8), QT_ACC8(16), QT_ACC8(24), QT_ACC8(32),
        QT_ACC8(40), QT_ACC8(48), QT_ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef QT_ACC8

struct GemmArgs {
  int num_k_tiles;   // depth of the product in stages of kBK
  int a_lo_row;      // row of A's map where the small halves start
  int b_lo_row;      // row of B's map where the small halves start
  int a_col_z;       // column offset of A per z = blockIdx.z
  int b_row_z;       // row offset of B per z
  float* out;        // D's destination
  long long out_z;   // offset of D per z, in elements
  long long out_lo;  // offset of the small half (split epilogue only)
  long long ld;      // leading dimension of the destination
};

// D (kBM x kBN tile at blockIdx.y, blockIdx.x) = sum_k A[row, k] B[col, k]
// for z = blockIdx.z, in 3xTF32, A and B given as big and small halves
// through 2-D tensor maps of K-major (row-major, k contiguous) matrices.
// kSplitT: store D transposed and split (pass 1, into T); otherwise store
// D as it is (pass 2, into the partial sums).
template <bool kSplitT>
__global__ void __launch_bounds__(kThreads)
    gemm_3xtf32(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const GemmArgs args) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int z = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int nk = args.num_k_tiles;

  if (warp == kConsumers / 32) {
    // producer warp: one thread keeps the ring of stages filled
    if (threadIdx.x % 32 == 0) {
      const int a_row = blockIdx.y * kBM;
      const int a_col = z * args.a_col_z;
      const int b_row = z * args.b_row_z + blockIdx.x * kBN;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages;
        const uint32_t round = kt / kStages;
        mbar_wait(&empty[s], (round & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], kStageBytes);
        uint8_t* st = smem + s * kStageBytes;
        const int k = kt * kBK;
        tma_load_2d(st, &map_a, &full[s], a_col + k, a_row);
        tma_load_2d(st + kATile, &map_a, &full[s], a_col + k,
                    a_row + args.a_lo_row);
        tma_load_2d(st + 2 * kATile, &map_b, &full[s], k, b_row);
        tma_load_2d(st + 2 * kATile + kBTile, &map_b, &full[s], k,
                    b_row + args.b_lo_row);
      }
    }
    return;
  }

  // consumer warpgroup. The tensor cores' FP32 accumulation of tf32
  // products loses more than round-to-nearest does as the depth grows,
  // so each stage (depth kBK) is summed by wgmma into `part` alone and
  // then added into `acc` by FP32 adds.
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    const uint32_t round = kt / kStages;
    mbar_wait(&full[s], round & 1);
    const uint32_t st = smem_u32(smem + s * kStageBytes);
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      // k8 slice j of the stage starts 32 bytes into each 128-byte row
      const uint64_t a_hi = gmma_desc(st + 32 * j);
      const uint64_t a_lo = gmma_desc(st + kATile + 32 * j);
      const uint64_t b_hi = gmma_desc(st + 2 * kATile + 32 * j);
      const uint64_t b_lo = gmma_desc(st + 2 * kATile + kBTile + 32 * j);
      // the two small terms first, then big . big
      wgmma_m64n128k8(part, a_lo, b_hi, j > 0);
      wgmma_m64n128k8(part, a_hi, b_lo, 1);
      wgmma_m64n128k8(part, a_hi, b_hi, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(part);
    // the stage's reads are done: hand its slot back to the producer
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // accumulator i of thread (warp, g = lane / 4, t = lane % 4) holds
  // D[16 warp + g + 8 ((i / 2) % 2), 8 (i / 4) + 2 t + i % 2]
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* base = args.out + static_cast<long long>(z) * args.out_z;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = blockIdx.y * kBM + warp * 16 + g + 8 * ((i >> 1) & 1);
    const int c = blockIdx.x * kBN + 8 * (i >> 2) + 2 * t;
    if (kSplitT) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long o = static_cast<long long>(c + e) * args.ld + r;
        const float hi = tf32_round(acc[i + e]);
        base[o] = hi;
        base[o + args.out_lo] = tf32_round(acc[i + e] - hi);
      }
    } else {
      *reinterpret_cast<float2*>(base + static_cast<long long>(r) * args.ld +
                                 c) = make_float2(acc[i], acc[i + 1]);
    }
  }
}

// theta (K1, K2) -> theta_t (2, K2p, K1p): transposed, zero-padded, split
// into big [0] and small [1] halves. Grid (K1p / 32, K2p / 32), 32 x 8
// threads.
__global__ void __launch_bounds__(256)
    split_transpose(const float* __restrict__ theta, float* __restrict__ tt,
                    int K1, int K2, int K1p, int K2p) {
  __shared__ float tile[32][33];
  const int k1_0 = blockIdx.x * 32, k2_0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k1 = k1_0 + r, k2 = k2_0 + threadIdx.x;
    tile[r][threadIdx.x] =
        (k1 < K1 && k2 < K2) ? theta[static_cast<long long>(k1) * K2 + k2]
                             : 0.0f;
  }
  __syncthreads();
  const long long half = static_cast<long long>(K2p) * K1p;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const long long o =
        static_cast<long long>(k2_0 + r) * K1p + k1_0 + threadIdx.x;
    const float v = tile[threadIdx.x][r];
    const float hi = tf32_round(v);
    tt[o] = hi;
    tt[o + half] = tf32_round(v - hi);
  }
}

// out (M, N) = sum_{z < w} part[z] (Mp, Np)[:M, :N], z in order.
__global__ void __launch_bounds__(256)
    sum_partials(const float* __restrict__ part, float* __restrict__ out,
                 int w, int M, int N, int Mp, int Np) {
  const long long total = static_cast<long long>(M) * N;
  const long long plane = static_cast<long long>(Mp) * Np;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += 256LL * gridDim.x) {
    const long long m = i / N, n = i % N;
    const float* p = part + m * Np + n;
    float s = p[0];
    for (int z = 1; z < w; ++z) s += p[z * plane];
    out[i] = s;
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A (rows, cols) row-major float32 matrix as boxes of kBK columns by
// box_rows rows, 128-byte swizzled. Returns 0, a CUDA runtime error, or
// 10000 + the CUresult of cuTensorMapEncodeTiled.
int encode_2d(CUtensorMap* map, const void* ptr, unsigned long long rows,
              unsigned long long cols, unsigned box_rows) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult query;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &query);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (query != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(float)};
  const cuuint32_t box[2] = {kBK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : 10000 + static_cast<int>(res);
}

template <bool kSplitT>
cudaError_t launch_gemm(dim3 grid, const CUtensorMap& a, const CUtensorMap& b,
                        const GemmArgs& args, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_3xtf32<kSplitT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  gemm_3xtf32<kSplitT><<<grid, kThreads, kSmemBytes, stream>>>(a, b, args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Size in bytes of the four tensor maps that sandwich_tf32_encode writes.
int sandwich_tf32_maps_bytes() { return 4 * sizeof(CUtensorMap); }

// Encode, once per prepared operand set, the tensor maps of
//   theta_t (2, K2p, K1p), a (2, w, Mp, K1p), t (2, Mp, w K2p) and
//   b (2, w, Np, K2p)
// (big halves first, then small ones) into `maps`, a host buffer of
// sandwich_tf32_maps_bytes() bytes. The dims are padded as
// prepare_sandwich pads them: Mp, Np multiples of 128, K1p of 32, K2p of
// 64. Returns 0 on success.
int sandwich_tf32_encode(void* maps, const void* a, const void* b,
                         const void* theta_t, const void* t, int w, int Mp,
                         int K1p, int K2p, int Np) {
  CUtensorMap m[4];
  int err = encode_2d(&m[0], theta_t, 2ULL * K2p, K1p, kBM);
  if (!err) err = encode_2d(&m[1], a, 2ULL * w * Mp, K1p, kBN);
  if (!err) err = encode_2d(&m[2], t, 2ULL * Mp, 1ULL * w * K2p, kBM);
  if (!err) err = encode_2d(&m[3], b, 2ULL * w * Np, K2p, kBN);
  if (!err) std::memcpy(maps, m, sizeof(m));
  return err;
}

// One matvec on operands encoded by sandwich_tf32_encode: theta (K1, K2)
// contiguous; theta_t, t and part (w, Mp, Np) scratch; out (M, N). Four
// launches: the split of theta, pass 1, pass 2 and the sum over x.
// Returns the first launch error, or 0.
int sandwich_tf32_apply(const void* maps, const void* theta, void* theta_t,
                        void* t, void* part, void* out, int w, int M, int K1,
                        int K2, int N, int Mp, int K1p, int K2p, int Np,
                        void* stream_ptr) {
  CUtensorMap m[4];
  std::memcpy(m, maps, sizeof(m));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  split_transpose<<<dim3(K1p / 32, K2p / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(theta), static_cast<float*>(theta_t), K1, K2,
      K1p, K2p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    GemmArgs p1;
    p1.num_k_tiles = K1p / kBK;
    p1.a_lo_row = K2p;
    p1.b_lo_row = w * Mp;
    p1.a_col_z = 0;
    p1.b_row_z = Mp;
    p1.out = static_cast<float*>(t);
    p1.out_z = K2p;
    p1.out_lo = static_cast<long long>(Mp) * w * K2p;
    p1.ld = static_cast<long long>(w) * K2p;
    err = launch_gemm<true>(dim3(Mp / kBN, K2p / kBM, w), m[0], m[1], p1,
                            stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    GemmArgs p2;
    p2.num_k_tiles = K2p / kBK;
    p2.a_lo_row = Mp;
    p2.b_lo_row = w * Np;
    p2.a_col_z = K2p;
    p2.b_row_z = Np;
    p2.out = static_cast<float*>(part);
    p2.out_z = static_cast<long long>(Mp) * Np;
    p2.out_lo = 0;
    p2.ld = Np;
    err = launch_gemm<false>(dim3(Np / kBN, Mp / kBM, w), m[2], m[3], p2,
                             stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(M) * N;
  long long blocks = (total + 255) / 256;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM
  sum_partials<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), w, M, N, Mp,
      Np);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
