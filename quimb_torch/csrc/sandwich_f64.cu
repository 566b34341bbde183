// The float64 DMRG effective-Hamiltonian "sandwich" matvec on Hopper
// (sm_90a), on the FP64 tensor cores (DMMA):
//
//     out (M, N) = sum_{x < w}  A[x] (M, K1) @ theta (K1, K2) @ B[x] (K2, N)
//
// It replaces the Pallas TPU kernel quimb_tpu/ops/pallas_kernels.py:
// _sandwich_kernel (launched by sandwich_matvec there) for float64; the
// float32 matvec runs the 3xTF32 kernel of sandwich_tf32.cu. The TPU kernel
// sums in a float32 scratch; here products and sums are float64 throughout.
//
// At w = 5, M = K1 = K2 = N = 512 one matvec is 2 w (M K1 K2 + M K2 N) =
// 2.68 GFLOP against 10-20 MB of traffic: it is bound by the FP64 math.
// What bounded the first port (an FP64-FMA SIMT GEMM, 0.44 ms at that shape
// on an H100, 6.1 TFLOP/s):
//   1. the FMA pipes themselves (34 TFLOP/s; the FP64 tensor cores give 67);
//   2. 8 scalar shared loads per 16 FMAs;
//   3. synchronous scalar global loads with one stage;
//   4. its second launch had 64 blocks for 132 SMs.
//
// What this design does about each:
//   * The products run on the FP64 tensor cores: mma.sync m16n8k8 .f64
//     (wgmma has no f64 type), accumulated in FP64 registers. A block of
//     4 warps computes a 64 x 64 tile, each warp a 32 x 32 piece of it:
//     8 MMAs per 8-deep step, fed by 8 16-byte shared loads.
//   * There is no ldmatrix for 64-bit elements, so fragments come from
//     shared memory in plain loads. Within each 8-deep step, mma index k is
//     read from stored column 2 (k % 4) + k / 4, the same for both operands
//     (the sum over k does not care), so that a thread's two values of a
//     row are adjacent and arrive in one 16-byte load. The 16-byte chunks of
//     a stage's 128-byte rows are swizzled (chunk ^ 4 on odd rows), so the
//     8 loads of a quarter-warp, two rows of four chunks, hit distinct banks.
//   * cp.async.cg 16-byte copies fill a ring of 4 stages, 16 deep each;
//     cp.async.wait_group keeps 3 stages in flight during a stage's math.
//     cp.async rather than the TMA ring of sandwich_tf32.cu: the TMA's
//     128-byte swizzle (chunk ^ row % 8) puts the two rows of a
//     quarter-warp's fragment loads on the same banks, and cp.async lets the
//     kernel choose its own swizzle, with no tensor maps, mbarriers or
//     producer warp.
//   * The tile was measured, not derived: on an H100 at the shape above,
//     64 x 64 tiles of 32 x 32 warp pieces with 4 stages took 0.086 ms per
//     matvec; 128 x 64 tiles of 64 x 32 pieces took 0.110 ms (252
//     registers a thread, so 2 blocks to an SM and 160 blocks for 264
//     places), and 32 x 64 tiles, 3 or 5 stages, or 32-deep stages
//     0.090-0.101 ms. Three blocks (164 registers a thread, 64 KB of
//     stages each) share an SM.
//   * Both passes are one GEMM, C = A . B^T with both operands K-major:
//       pass 1:  T[x] (M, K2) = A[x] (M, K1) . theta_t^T, theta_t =
//                theta^T (K2, K1) padded by a small kernel per matvec;
//       pass 2:  P[x] (M, N) = T[x] (M, K2) . B[x], with B prepared as
//                B[x]^T (N, K2), once per local solve;
//       reduce:  out = sum_x P[x], in order of x.
//     Pass 1 is batched over x and pass 2 split over x (one block per
//     output tile and x): 320 blocks each at the shape above. No atomics,
//     so the result is bitwise repeatable.
//   * Ragged shapes: the prepare step zero-pads the stacks to whole tiles,
//     as for the float32 kernel (M and N to 128, K1 to 32, K2 to 64), the
//     theta kernel pads theta, and the reduce writes only the (M, N)
//     corner. The hot loop has no masks and every copy is aligned, and
//     every bond is taken, down to 1 x 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;                    // rows of a block's tile
constexpr int kBN = 64;                    // columns of a block's tile
constexpr int kBK = 16;                    // depth of a stage: 128-byte rows
constexpr int kStages = 4;
constexpr int kMinBlocks = 2;              // ptxas's register budget
constexpr int kWM = 32;                    // rows of a warp's piece
constexpr int kWN = 32;                    // columns of a warp's piece
constexpr int kWarpsM = kBM / kWM;
constexpr int kThreads = 32 * kWarpsM * (kBN / kWN);
constexpr int kMT = kWM / 16;              // m16 MMA tiles of a warp
constexpr int kNT = kWN / 8;               // n8 MMA tiles of a warp
constexpr int kChunks = kBK / 2;           // 16-byte chunks of a stage row
constexpr int kStageElems = (kBM + kBN) * kBK;
constexpr int kSmemBytes = kStages * kStageElems * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Offset, in doubles, of 16-byte chunk c of row r of a stage's tile. The
// swizzle flips bit 2 of the chunk on odd rows, within each 128 bytes.
static_assert(kBK % 16 == 0, "the swizzle needs rows of 128-byte multiples");
__device__ __forceinline__ int swz(int r, int c) {
  return r * kBK + 2 * (c ^ ((r & 1) << 2));
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ double2 lds2(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// d (16 x 8) += a (16 x 8) . b (8 x 8) on the FP64 tensor cores. Thread
// (g = lane / 4, t = lane % 4) holds a0 = a[g][t], a1 = a[g + 8][t],
// a2 = a[g][t + 4], a3 = a[g + 8][t + 4], b0 = b[t][g], b1 = b[t + 4][g],
// and d[g][2 t + i] in d0, d1, d[g + 8][2 t + i] in d2, d3.
__device__ __forceinline__ void mma_m16n8k8(double (&d)[4], double2 a_lo,
                                            double2 a_hi, double2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a_lo.x), "d"(a_hi.x), "d"(a_lo.y), "d"(a_hi.y), "d"(b.x),
        "d"(b.y));
}

struct GemmArgs {
  const double* a;  // A[z] (rows, k), row stride lda, batch stride a_z
  const double* b;  // B[z] (cols, k), row stride ldb, batch stride b_z
  double* c;        // C[z] (rows, cols), row stride ldc, batch stride c_z
  long long lda, ldb, ldc, a_z, b_z, c_z;
  int k;            // depth, a multiple of kBK
};

// Copy columns [k0, k0 + kBK) of the block's kBM rows of A and kBN rows of
// B into stage st.
__device__ __forceinline__ void load_stage(double* st, const double* a,
                                           const double* b, long long lda,
                                           long long ldb, int k0) {
#pragma unroll
  for (int i = 0; i < kBM * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    cp_async16(st + swz(r, c), a + r * lda + k0 + 2 * c);
  }
  double* bs = st + kBM * kBK;
#pragma unroll
  for (int i = 0; i < kBN * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = e % kChunks;
    cp_async16(bs + swz(r, c), b + r * ldb + k0 + 2 * c);
  }
}

// C[z] (kBM x kBN tile at blockIdx.y, blockIdx.x) = A[z] . B[z]^T for
// z = blockIdx.z. Every size is a whole number of tiles and stages.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gemm_dmma(const GemmArgs p) {
  extern __shared__ __align__(16) double smem[];
  const long long z = blockIdx.z;
  const double* a = p.a + z * p.a_z + blockIdx.y * kBM * p.lda;
  const double* b = p.b + z * p.b_z + blockIdx.x * kBN * p.ldb;
  const int nk = p.k / kBK;

  // stages 0 .. kStages - 2 in flight; one commit group per stage, empty
  // past the end, so that wait_group counts stages
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_stage(smem + s * kStageElems, a, b, p.lda, p.ldb, s * kBK);
    }
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp % kWarpsM) * kWM, wn = (warp / kWarpsM) * kWN;
  double acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the next copies overwrite
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < nk) {
      load_stage(smem + (next % kStages) * kStageElems, a, b, p.lda, p.ldb,
                 next * kBK);
    }
    cp_async_commit();

    const double* as = smem + (kt % kStages) * kStageElems;
    const double* bs = as + kBM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 8; ++ks) {
      const int c = 4 * ks + t;
      double2 af[kMT][2], bf[kNT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wm + 16 * i + g;
        af[i][0] = lds2(as + swz(r, c));
        af[i][1] = lds2(as + swz(r + 8, c));
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) bf[j] = lds2(bs + swz(wn + 8 * j + g, c));
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mma_m16n8k8(acc[i][j], af[i][0], af[i][1], bf[j]);
      }
    }
  }
  cp_async_wait<0>();

  double* out = p.c + z * p.c_z;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const long long r = blockIdx.y * kBM + wm + 16 * i + g;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = blockIdx.x * kBN + wn + 8 * j + 2 * t;
      *reinterpret_cast<double2*>(out + r * p.ldc + col) =
          make_double2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<double2*>(out + (r + 8) * p.ldc + col) =
          make_double2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// theta (K1, K2) -> theta_t (K2p, K1p): transposed and zero-padded. Grid
// (K1p / 32, K2p / 32), 32 x 8 threads.
__global__ void __launch_bounds__(256)
    pad_transpose_f64(const double* __restrict__ theta,
                      double* __restrict__ tt, int K1, int K2, int K1p) {
  __shared__ double tile[32][33];
  const int k1_0 = blockIdx.x * 32, k2_0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k1 = k1_0 + r, k2 = k2_0 + threadIdx.x;
    tile[r][threadIdx.x] =
        (k1 < K1 && k2 < K2) ? theta[static_cast<long long>(k1) * K2 + k2]
                             : 0.0;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    tt[static_cast<long long>(k2_0 + r) * K1p + k1_0 + threadIdx.x] =
        tile[threadIdx.x][r];
  }
}

// out (M, N) = sum_{z < w} part[z] (Mp, Np)[:M, :N], z in order.
__global__ void __launch_bounds__(256)
    sum_partials_f64(const double* __restrict__ part, double* __restrict__ out,
                     int w, int M, int N, int Mp, int Np) {
  const long long total = static_cast<long long>(M) * N;
  const long long plane = static_cast<long long>(Mp) * Np;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += 256LL * gridDim.x) {
    const long long m = i / N, n = i % N;
    const double* q = part + m * Np + n;
    double s = q[0];
    for (int z = 1; z < w; ++z) s += q[z * plane];
    out[i] = s;
  }
}

cudaError_t launch_gemm(dim3 grid, const GemmArgs& args,
                        cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_dmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          gemm_dmma, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return err;
    configured = true;
  }
  gemm_dmma<<<grid, kThreads, kSmemBytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// One float64 matvec on operands laid out as prepare_sandwich lays them
// out: a (w, Mp, K1p) and b (w, Np, K2p) zero-padded, b transposed;
// theta (K1, K2) contiguous; theta_t (K2p, K1p), t (w, Mp, K2p) and
// part (w, Mp, Np) scratch; out (M, N). Mp and Np are multiples of 128,
// K1p of 32, K2p of 64. Four launches: the padding of theta, pass 1,
// pass 2 and the sum over x. Returns the first launch error, or 0.
extern "C" int sandwich_f64_apply(const void* theta, void* theta_t,
                                  const void* a, const void* b, void* t,
                                  void* part, void* out, int w, int M, int K1,
                                  int K2, int N, int Mp, int K1p, int K2p,
                                  int Np, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  pad_transpose_f64<<<dim3(K1p / 32, K2p / 32), dim3(32, 8), 0, stream>>>(
      static_cast<const double*>(theta), static_cast<double*>(theta_t), K1,
      K2, K1p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    GemmArgs p1;
    p1.a = static_cast<const double*>(a);
    p1.b = static_cast<const double*>(theta_t);
    p1.c = static_cast<double*>(t);
    p1.lda = K1p;
    p1.ldb = K1p;
    p1.ldc = K2p;
    p1.a_z = static_cast<long long>(Mp) * K1p;
    p1.b_z = 0;
    p1.c_z = static_cast<long long>(Mp) * K2p;
    p1.k = K1p;
    err = launch_gemm(dim3(K2p / kBN, Mp / kBM, w), p1, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    GemmArgs p2;
    p2.a = static_cast<const double*>(t);
    p2.b = static_cast<const double*>(b);
    p2.c = static_cast<double*>(part);
    p2.lda = K2p;
    p2.ldb = K2p;
    p2.ldc = Np;
    p2.a_z = static_cast<long long>(Mp) * K2p;
    p2.b_z = static_cast<long long>(Np) * K2p;
    p2.c_z = static_cast<long long>(Mp) * Np;
    p2.k = K2p;
    err = launch_gemm(dim3(Np / kBN, Mp / kBM, w), p2, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = static_cast<long long>(M) * N;
  long long blocks = (total + 255) / 256;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM
  sum_partials_f64<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const double*>(part), static_cast<double*>(out), w, M, N,
      Mp, Np);
  return static_cast<int>(cudaGetLastError());
}
