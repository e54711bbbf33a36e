// Batched Cholesky factorisation fused with forward substitution, and the
// matching backward substitution, for many small SPD systems (one per env).
//
// Replaces the Pallas TPU kernels of ase_tpu/ops/pallas_chol.py:
//   _chol_forward2_kernel / _chol_forward_kernel  -> chol_forward_kernel
//   _back_solve_kernel                             -> back_solve_kernel
//
// Contract (kept from the TPU kernels, so tests compare like with like):
// every operand is float32, batch-last and contiguous: M (n, n, B),
// rhs (n, m, B), rhs2 (n, m2, B), y (n, m, B). Element (i, j, b) sits at
// (i * cols + j) * B + b.
//
// What bounds it on an H100: at the engine's shapes (n = 37, m = 72, m2 = 1,
// B = 4096) the factor + solve reads the lower triangle of M (n(n+1)/2
// floats per env), rhs and rhs2, and writes the full L, Y and Y2 once:
// ~122 MB against ~0.5 GFLOP of float32 work -- memory-bound. At the H100
// SXM's data-sheet peaks (3.35 TB/s, 67 TFLOP/s float32, 700 W) that is a
// floor of ~37 us; the backward solve reads L's lower triangle and y and
// writes x, ~12.7 MB, a floor of ~3.8 us.
//
// chol_forward_kernel (the engine's call). A block owns 32 envs, one per
// lane, so every global load and store of a warp touches 32 consecutive
// floats (one 128-byte line) of the batch-last layout, and runs 32 warps:
// 32 of the SM's 64 warp slots at B = 4096, one block per SM (the register
// file caps a thread at 64 registers). Phases:
//   1. stage M's lower triangle in shared memory ([element][lane], no bank
//      conflicts) with cp.async, so all of a thread's copies are in flight
//      at once, and issue each thread's first right-hand-side column into
//      registers, so its device-memory latency hides behind phase 2;
//   2. factor column by column (left-looking, Crout): at column j each warp
//      takes one row i >= j and computes L[i, j] from the finished columns
//      k < j, recomputing the pivot itself, so a column costs one barrier
//      and every warp has work until the last few columns;
//   3. write L, then forward-substitute: each thread carries one env's
//      column, all of whose n rhs loads are issued before the first row is
//      solved, in registers (y[N], N = 37 compiled as its own fully unrolled
//      instance; other n take a generic instance with y in local memory).
// Every element still sees the TPU kernel's arithmetic in its order: the
// pivot's rsqrt, the column scaled by it, products subtracted k ascending
// (the left-looking form applies, element by element, the same updates as
// the right-looking loop, in the same order), so results agree to rounding.
// What holds it above the device-memory floor: phase 3 reads an env's
// n(n+1)/2 entries of L from shared memory once per column (shared-memory
// bandwidth), and phase 2 is a chain of n dependent columns with a barrier
// each (latency). PERF.md has the measured split between the two.
//
// back_solve_kernel: 32 envs x 8 warps per block; the 8 warps stage L's
// lower triangle in shared memory, then each thread solves one env's column
// with x in a local array. Not tuned yet.

#include <cuda_runtime.h>

namespace {

constexpr int kEnvs = 32;      // envs per block, one per lane
constexpr int kWarps = 8;      // warps per block of back_solve_kernel
constexpr int kFwdWarps = 32;  // warps per block of chol_forward_kernel
constexpr int kMaxN = 48;      // largest n the shared-memory staging takes
constexpr int kEngineN = 37;   // the engine's n (sword-shield humanoid nu)

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Stage the lower triangle of env block b0's (n, n, B) matrices into shared
// memory. Lanes past B get an identity so no lane divides by zero.
__device__ __forceinline__ void load_lower(const float* __restrict__ A,
                                           float* __restrict__ s, int n,
                                           int B, int b0) {
  const int lane = threadIdx.x;
  const int b = b0 + lane;
  const bool ok = b < B;
  for (int e = threadIdx.y; e < n * n; e += kWarps) {
    const int i = e / n;
    const int j = e - i * n;
    if (j > i) continue;
    s[tri(i, j) * kEnvs + lane] =
        ok ? A[static_cast<size_t>(e) * B + b] : (i == j ? 1.0f : 0.0f);
  }
}

// 4-byte asynchronous copy from device to shared memory (cp.async): the
// copies of one thread all go out at once and land without passing through
// registers. cp_async_wait_all() waits for this thread's copies.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loads right-hand-side column c (of [rhs | rhs2]) of env b into y[0, n).
template <int N, int K>
__device__ __forceinline__ void load_column(const float* __restrict__ R,
                                            const float* __restrict__ R2,
                                            int n, int m, int m2, int c,
                                            size_t B, int b, float (&y)[K]) {
  const bool first = c < m;
  const float* src = first ? R + c * B + b : R2 + (c - m) * B + b;
  const size_t ld = (first ? m : m2) * B;
#pragma unroll
  for (int i = 0; i < (N > 0 ? N : n); ++i) y[i] = src[i * ld];
}

// N > 0: an instance for n == N with every loop over n unrolled and y in
// registers; N == 0: any n <= kMaxN.
template <int N>
__global__ void __launch_bounds__(kEnvs * kFwdWarps, 1)
chol_forward_kernel(const float* __restrict__ M, const float* __restrict__ R,
                    const float* __restrict__ R2, float* __restrict__ L,
                    float* __restrict__ Y, float* __restrict__ Y2, int n_arg,
                    int m, int m2, int B) {
  const int n = N > 0 ? N : n_arg;
  extern __shared__ float smem[];
  float* s_l = smem;                                  // [tri][kEnvs]
  float* s_dinv = smem + (n * (n + 1) / 2) * kEnvs;   // [n][kEnvs], 1 / L[k, k]
  float* s_diag = s_dinv + n * kEnvs;                 // [n][kEnvs], L[k, k]
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int b = blockIdx.x * kEnvs + lane;
  const bool live = b < B;
  const size_t Bs = B;
  const int cols = m + m2;

  // 1. M's lower triangle to shared memory by cp.async (lanes past B: an
  //    identity), and this thread's first column into registers, all in
  //    flight together
  for (int i = 0; i < n; ++i) {
    for (int j = w; j <= i; j += kFwdWarps) {
      float* dst = s_l + tri(i, j) * kEnvs + lane;
      if (live) {
        cp_async4(dst, M + (i * n + j) * Bs + b);
      } else {
        *dst = i == j ? 1.0f : 0.0f;
      }
    }
  }
  float y[N > 0 ? N : kMaxN];
  if (live && w < cols) load_column<N>(R, R2, n, m, m2, w, Bs, b, y);
  cp_async_wait_all();
  __syncthreads();

  // 2. left-looking factorisation, one barrier per column
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const float* lj = s_l + tri(j, 0) * kEnvs + lane;
    for (int i = j + w; i < n; i += kFwdWarps) {
      const float* li = s_l + tri(i, 0) * kEnvs + lane;
      float d = lj[j * kEnvs];
      float v = li[j * kEnvs];
#pragma unroll 4
      for (int k = 0; k < j; ++k) {
        const float ljk = lj[k * kEnvs];
        d = fmaf(-ljk, ljk, d);
        v = fmaf(-li[k * kEnvs], ljk, v);
      }
      const float dinv = rsqrtf(d);
      if (i == j) {   // the diagonal lives apart: other warps still read A[j, j]
        s_diag[j * kEnvs + lane] = d * dinv;   // = sqrt(d)
        s_dinv[j * kEnvs + lane] = dinv;
      } else {
        s_l[tri(i, j) * kEnvs + lane] = v * dinv;
      }
    }
    __syncthreads();
  }
  if (!live) return;

  // 3. L out: lower triangle, zeros above (torch.linalg.cholesky's form)
  for (int e = w; e < n * n; e += kFwdWarps) {
    const int i = e / n;
    const int j = e - i * n;
    L[e * Bs + b] = j < i ? s_l[tri(i, j) * kEnvs + lane]
                          : (j == i ? s_diag[i * kEnvs + lane] : 0.0f);
  }

  //    forward substitution, one right-hand-side column per thread
  for (int c = w; c < cols; c += kFwdWarps) {
    // L's entries do not change from column to column: without this fence
    // the compiler hoists all n(n+1)/2 shared loads out of the loop, and
    // they spill. Read them again for each column instead.
    asm volatile("" ::: "memory");
    if (c != w) load_column<N>(R, R2, n, m, m2, c, Bs, b, y);
    const bool first = c < m;
    float* dst = first ? Y + c * Bs + b : Y2 + (c - m) * Bs + b;
    const size_t ld = (first ? m : m2) * Bs;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float* li = s_l + tri(i, 0) * kEnvs + lane;
      float acc = y[i];
#pragma unroll
      for (int j = 0; j < i; ++j) acc = fmaf(-li[j * kEnvs], y[j], acc);
      y[i] = acc * s_dinv[i * kEnvs + lane];
      dst[i * ld] = y[i];
    }
  }
}

__global__ void __launch_bounds__(kEnvs * kWarps)
back_solve_kernel(const float* __restrict__ Lg, const float* __restrict__ Yin,
                  float* __restrict__ X, int n, int m, int B) {
  extern __shared__ float smem[];                      // [tri][kEnvs]
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int b0 = blockIdx.x * kEnvs;
  const int b = b0 + lane;

  load_lower(Lg, smem, n, B, b0);
  __syncthreads();
  if (b >= B) return;

  for (int c = w; c < m; c += kWarps) {
    float x[kMaxN];
    for (int i = 0; i < n; ++i) {
      x[i] = Yin[(static_cast<size_t>(i) * m + c) * B + b];
    }
    for (int k = n - 1; k >= 0; --k) {
      const float lkk = smem[tri(k, k) * kEnvs + lane];
      const float xk = x[k] * rsqrtf(lkk * lkk);       // 1 / L[k, k]
      x[k] = xk;
      for (int j = 0; j < k; ++j) {
        x[j] -= smem[tri(k, j) * kEnvs + lane] * xk;
      }
    }
    for (int i = 0; i < n; ++i) {
      X[(static_cast<size_t>(i) * m + c) * B + b] = x[i];
    }
  }
}

// Dynamic shared memory of chol_forward_kernel at n: L's lower triangle,
// the pivots' inverses and L's diagonal, for kEnvs envs.
size_t forward_smem(int n) {
  return static_cast<size_t>(n * (n + 1) / 2 + 2 * n) * kEnvs * sizeof(float);
}

// The instance of chol_forward_kernel that serves n.
decltype(&chol_forward_kernel<0>) forward_kernel(int n) {
  return n == kEngineN ? chol_forward_kernel<kEngineN> : chol_forward_kernel<0>;
}

}  // namespace

extern "C" {

int ase_chol_max_n() { return kMaxN; }

// Once per device before the first launch: let the kernels take the shared
// memory of the largest n (above the 48 KB default). Returns the CUDA error.
int ase_chol_init() {
  const int fwd = static_cast<int>(forward_smem(kMaxN));
  cudaError_t e = cudaFuncSetAttribute(
      chol_forward_kernel<kEngineN>, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(chol_forward_kernel<0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, fwd);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaFuncSetAttribute(
      back_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxN * (kMaxN + 1) / 2 * kEnvs * sizeof(float))));
}

// The launch shape of ase_chol_forward at n: threads and dynamic shared
// memory per block, and blocks the device keeps resident per SM. Needs
// ase_chol_init() first. Returns the CUDA error.
int ase_chol_forward_layout(int n, int* threads, int* smem_bytes, int* blocks_per_sm) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kEnvs * kFwdWarps;
  *smem_bytes = static_cast<int>(forward_smem(n));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, forward_kernel(n), *threads, forward_smem(n)));
}

// L = chol(M), Y = L^-1 rhs, Y2 = L^-1 rhs2 (rhs2/Y2 may be null with m2 = 0).
// Needs ase_chol_init() on the device first. Returns cudaGetLastError()
// after the launch; 0 means launched.
int ase_chol_forward(const float* M, const float* rhs, const float* rhs2,
                     float* L, float* Y, float* Y2, int n, int m, int m2,
                     int B, void* stream) {
  if (n < 1 || n > kMaxN || m < 0 || m2 < 0 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kEnvs, kFwdWarps);
  const dim3 grid((B + kEnvs - 1) / kEnvs);
  const auto kernel = forward_kernel(n);
  kernel<<<grid, block, forward_smem(n), static_cast<cudaStream_t>(stream)>>>(
      M, rhs, rhs2, L, Y, Y2, n, m, m2, B);
  return static_cast<int>(cudaGetLastError());
}

// x = L^-T y. Needs ase_chol_init() on the device first. Returns
// cudaGetLastError() after the launch.
int ase_back_solve(const float* L, const float* y, float* x, int n, int m,
                   int B, void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(n * (n + 1) / 2) * kEnvs * sizeof(float);
  const dim3 block(kEnvs, kWarps);
  const dim3 grid((B + kEnvs - 1) / kEnvs);
  back_solve_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      L, y, x, n, m, B);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
