// The float64 DMRG effective-Hamiltonian "sandwich" matvec on Hopper
// (sm_90a):
//
//     out (M, N) = sum_{x < w}  A[x] (M, K1) @ theta (K1, K2) @ B[x] (K2, N)
//
// It replaces the Pallas TPU kernel quimb_tpu/ops/pallas_kernels.py:
// _sandwich_kernel (launched by sandwich_matvec there) for float64; the
// float32 matvec, which the DMRG main path runs, is the 3xTF32 tensor-core
// kernel of sandwich_tf32.cu. At w = 5, M = K1 = K2 = N = 512 one matvec
// is 2 w (M K1 K2 + M K2 N) = 2.7 GFLOP against 10-20 MB of traffic, so it
// is bound by the FP64 pipes, not by memory. FP64 tensor cores (DMMA) are
// later work.
//
// The TPU kernel streams over x on a sequential grid and carries the sum in a
// VMEM accumulator, to keep the (w, M, K2) intermediate out of HBM. Blocks on
// Hopper run in parallel with no carried state, so here the work is two
// launches of one tiled, strided-batched GEMM:
//
//   pass 1:  T[:, x K2 : (x + 1) K2] = A[x] @ theta   for every x
//            (batched over x, theta at batch stride 0; T is (M, w K2))
//   pass 2:  out = T @ B.reshape(w K2, N)
//            (one GEMM of depth w K2: the sum over x is part of its K loop,
//            with no atomics and a fixed summation order)
//
// The GEMM is deliberately simple: 64 x 64 output tiles, 16-deep
// shared-memory stages, 4 x 4 register accumulators per thread, FP64 FMA
// only. Ragged tiles are masked in the loads and the stores, so every M,
// K1, K2, N is accepted, down to the 1 x 1 bonds at a chain's ends.

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;                // rows of C per block
constexpr int kBN = 64;                // columns of C per block
constexpr int kBK = 16;                // depth of one shared-memory stage
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kTM = kBM / 16;          // rows of C per thread
constexpr int kTN = kBN / 16;          // columns of C per thread

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// C[z] = A[z] @ B[z] for z = blockIdx.z. All three are row-major with row
// strides lda, ldb, ldc and batch strides strideA, strideB, strideC (in
// elements). A thread owns rows ty + 16 i and columns tx + 16 j of the
// block's tile, so that neighbouring threads read neighbouring shared-memory
// words and write neighbouring global addresses.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_batched(const T* __restrict__ A, const T* __restrict__ B,
             T* __restrict__ C, int M, int N, int K, long long lda,
             long long ldb, long long ldc, long long strideA,
             long long strideB, long long strideC) {
  // As is stored transposed (k-major) and padded by one word, so that the
  // transposing store hits distinct banks.
  __shared__ T As[kBK][kBM + 1];
  __shared__ T Bs[kBK][kBN];

  const long long z = blockIdx.z;
  A += z * strideA;
  B += z * strideB;
  C += z * strideC;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  T acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = T(0);
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[gm * lda + gk] : T(0);
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? B[gk * ldb + gn] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) C[gm * ldc + gn] = acc[i][j];
    }
  }
}

inline unsigned cdiv(long long a, int b) {
  return static_cast<unsigned>((a + b - 1) / b);
}

// a (w, M, K1), theta (K1, K2), b (w, K2, N), scratch t (M, w K2) and out
// (M, N): contiguous, row-major, on the device of the current context.
// Returns the first launch error (cudaSuccess = 0 when both launched).
template <typename T>
int sandwich(const T* a, const T* theta, const T* b, T* t, T* out, int w,
             int M, int K1, int K2, int N, cudaStream_t stream) {
  const long long wk2 = static_cast<long long>(w) * K2;

  const dim3 grid1(cdiv(K2, kBN), cdiv(M, kBM), w);
  gemm_batched<T><<<grid1, kThreads, 0, stream>>>(
      a, theta, t, M, K2, K1, /*lda=*/K1, /*ldb=*/K2, /*ldc=*/wk2,
      /*strideA=*/static_cast<long long>(M) * K1, /*strideB=*/0,
      /*strideC=*/K2);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid2(cdiv(N, kBN), cdiv(M, kBM), 1);
  gemm_batched<T><<<grid2, kThreads, 0, stream>>>(
      t, b, out, M, N, static_cast<int>(wk2), /*lda=*/wk2, /*ldb=*/N,
      /*ldc=*/N, 0, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sandwich_matvec_f64(const void* a, const void* theta,
                                   const void* b, void* t, void* out, int w,
                                   int M, int K1, int K2, int N,
                                   void* stream) {
  return sandwich(static_cast<const double*>(a),
                  static_cast<const double*>(theta),
                  static_cast<const double*>(b), static_cast<double*>(t),
                  static_cast<double*>(out), w, M, K1, K2, N,
                  static_cast<cudaStream_t>(stream));
}
