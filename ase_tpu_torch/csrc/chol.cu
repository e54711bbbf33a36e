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
// back_solve_kernel (the engine's call is m = 1: one column per env). It
// moves ~12.7 MB against ~5.6 MFLOP, so it is bound by device memory. A
// block owns 32 envs and runs 8 warps (at B = 4096 one block per SM on
// 128 SMs, whose share of L is ~90 KB each):
//   1. all 256 threads stage L's lower triangle in shared memory (even
//      elements, then odd ones: back_odd) with no loop over the upper
//      triangle, every copy in flight at once: each (row, column) segment
//      of the block's envs is 128 contiguous bytes, copied by 8 threads
//      with 16-byte cp.async when B % 4 == 0 and L is 16-byte aligned
//      (chosen at launch), else by 32 threads with 4-byte cp.async;
//   2. warps 2p and 2p + 1 take columns p, p + 4, ... of y, two lanes
//      per env (16 envs a warp): lane r keeps x[i] for i % 2 == r, the
//      lane that owns x[k] scales it and hands it to its partner by one
//      shuffle, and each lane updates its own half of x[0, k). The odd
//      elements sit 16 banks from the even ones, so the pair, which reads
//      neighbouring elements at once, hits different banks. The first
//      column's loads of y go out before the wait for L; x stays in
//      registers in the n = 37 instance (a generic instance with x in
//      local memory serves other n <= 48). Per element the TPU kernel's
//      updates apply in its order:
//      x[k] *= rsqrt(L[k,k] L[k,k]), then x[j] -= L[k,j] x[k] for j < k,
//      k descending.
// What holds it above the bound: the copies take most of the time, and
// the solve (37 dependent rows, each with a shuffle) runs after the last
// byte lands. Overlapping the two (row chunks on mbarriers or named
// barriers) measured slower: waits inside the unrolled row loop slow the
// solve, and a thread's cp.async issue stalls until the memory system
// takes it (PERF.md, section 6).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kEnvs = 32;      // envs per block, one per lane
constexpr int kWarps = 8;      // warps per block of back_solve_kernel
constexpr int kFwdWarps = 32;  // warps per block of chol_forward_kernel
constexpr int kMaxN = 48;      // largest n the shared-memory staging takes
constexpr int kEngineN = 37;   // the engine's n (sword-shield humanoid nu)

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

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

// 16-byte cp.async that skips L1 (both addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
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

// back_solve_kernel's shared layout: L's lower triangle for kEnvs envs,
// elements of even index first ([e / 2][env]), then, from back_odd(n) on,
// those of odd index. back_odd is 16 floats past a multiple of 32, so the
// two lanes of an env, which read neighbouring elements of a row at once,
// hit different banks; each element's 32 envs stay 128 contiguous bytes.
__host__ __device__ constexpr int back_odd(int n) {
  return (n * (n + 1) / 2 + 1) / 2 * kEnvs + kEnvs / 2;
}

// Row k of the backward substitution on the lane pair of one env: lane r
// (= lane & 1) keeps x[2u + r] in xl[u]. The lane that owns x[k] scales it
// by 1 / L[k, k] and hands it to its partner; then each lane applies
// x[i] -= L[k, i] x[k] to its own i < k. Element t0 + 2u + r of a row
// starting at element t0 is pa[(t0 / 2 + u) * kEnvs] for even t0 and
// pb[((t0 - 1) / 2 + u) * kEnvs] for odd t0; the diagonal element e is
// d0[e / 2 * kEnvs] for even e and d1[e / 2 * kEnvs] for odd e.
template <int M>
__device__ __forceinline__ void back_row(int k, float (&xl)[M], const float* pa,
                                         const float* pb, const float* d0,
                                         const float* d1, int lane, int r) {
  const int t0 = tri(k, 0);
  const int ed = t0 + k;
  const float lkk = ((ed & 1) ? d1 : d0)[ed / 2 * kEnvs];
  const float v = xl[k / 2] * rsqrtf(lkk * lkk);       // x[k] / L[k, k] on its owner
  const float xk = __shfl_sync(0xffffffffu, v, (lane & ~1) | (k & 1));
  if ((k & 1) == r) xl[k / 2] = xk;
  const float* p = (t0 & 1) ? pb + (t0 - 1) / 2 * kEnvs : pa + t0 / 2 * kEnvs;
#pragma unroll
  for (int u = 0; u < k / 2; ++u) xl[u] = fmaf(-p[u * kEnvs], xk, xl[u]);
  if ((k & 1) && r == 0) xl[k / 2] = fmaf(-p[k / 2 * kEnvs], xk, xl[k / 2]);
}

// Rows K, K - 1, ..., 0, each with its row index a constant.
template <int K, int M>
__device__ __forceinline__ void back_rows(float (&xl)[M], const float* pa, const float* pb,
                                          const float* d0, const float* d1, int lane, int r) {
  if constexpr (K >= 0) {
    back_row(K, xl, pa, pb, d0, d1, lane, r);
    back_rows<K - 1>(xl, pa, pb, d0, d1, lane, r);
  }
}

// N > 0: an instance for n == N with the solve unrolled and x in registers;
// N == 0: any n <= kMaxN. vec: L is 16-byte aligned and B % 4 == 0.
template <int N>
__global__ void __launch_bounds__(kEnvs * kWarps, 1)
back_solve_kernel(const float* __restrict__ Lg, const float* __restrict__ Yin,
                  float* __restrict__ X, int n_arg, int m, int B, bool vec) {
  const int n = N > 0 ? N : n_arg;
  extern __shared__ float4 smem4[];
  float* s_l = reinterpret_cast<float*>(smem4);        // see back_odd
  const int odd = back_odd(n);
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int b0 = blockIdx.x * kEnvs;
  const size_t Bs = B;

  // 1. every thread copies `width` floats at q * width of every
  //    `streams`-th segment of L's lower triangle, from segment t / per
  //    on (row by row); segments past B are not copied (their lanes store
  //    nothing)
  {
    const int t = w * kEnvs + lane;
    const int width = vec ? 4 : 1;
    const int per = kEnvs / width;                     // threads per segment
    const int streams = kEnvs * kWarps / per;
    const int q = t % per;
    const bool live = b0 + q * width < B;
    int k = 0, j = t / per;
    while (k < n && j > k) {   // to the segment's row
      j -= k + 1;
      ++k;
    }
    while (k < n) {
      if (live) {
        const int e = tri(k, j);
        float* dst = s_l + (e & 1) * odd + e / 2 * kEnvs + q * width;
        const float* src = Lg + (k * n + j) * Bs + b0 + q * width;
        if (vec) {
          cp_async16(dst, src);
        } else {
          cp_async4(dst, src);
        }
      }
      j += streams;
      while (k < n && j > k) {
        j -= k + 1;
        ++k;
      }
    }
  }

  // 2. backward substitution: warps 2p and 2p + 1 take columns p, p + 4,
  //    ... of y, two lanes per env (16 envs a warp). The first column's
  //    loads of y go out before the wait for L.
  constexpr int kHalf = (N > 0 ? N + 1 : kMaxN) / 2;
  const int env = (w & 1) * (kEnvs / 2) + lane / 2;
  const int r = lane & 1;
  const int b = b0 + env;
  const int bc = min(b, B - 1);                        // past B: load in range, store nothing
  const size_t ld = m * Bs;
  const int p0 = w / 2;
  float xl[kHalf];
  if (p0 < m) {
#pragma unroll
    for (int u = 0; u < kHalf; ++u) {
      if (2 * u + r < n) xl[u] = Yin[(2 * u + r) * ld + p0 * Bs + bc];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const float* pa = s_l + r * odd + env;
  const float* pb = s_l + (1 - r) * odd + r * kEnvs + env;
  const float* d0 = s_l + env;
  const float* d1 = s_l + odd + env;
  for (int c = p0; c < m; c += kWarps / 2) {
    // as in chol_forward_kernel: read L again for each column rather than
    // let the compiler hoist all n(n+1)/2 shared loads out of this loop
    asm volatile("" ::: "memory");
    if (c != p0) {
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        if (2 * u + r < n) xl[u] = Yin[(2 * u + r) * ld + c * Bs + bc];
      }
    }
    if constexpr (N > 0) {
      back_rows<N - 1>(xl, pa, pb, d0, d1, lane, r);
    } else {
      for (int k = n - 1; k >= 0; --k) back_row(k, xl, pa, pb, d0, d1, lane, r);
    }
    if (b < B) {
#pragma unroll
      for (int u = 0; u < kHalf; ++u) {
        if (2 * u + r < n) X[(2 * u + r) * ld + c * Bs + b] = xl[u];
      }
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

// Dynamic shared memory of back_solve_kernel at n: L's lower triangle for
// kEnvs envs, even elements, then odd ones from back_odd(n).
size_t back_smem(int n) {
  return static_cast<size_t>(back_odd(n) + n * (n + 1) / 2 / 2 * kEnvs) * sizeof(float);
}

// The instance of back_solve_kernel that serves n.
decltype(&back_solve_kernel<0>) back_kernel(int n) {
  return n == kEngineN ? back_solve_kernel<kEngineN> : back_solve_kernel<0>;
}

// back_solve_kernel's 16-byte copies need L 16-byte aligned and every
// segment of 4 envs whole.
bool back_vec(const float* L, int B) {
  return reinterpret_cast<uintptr_t>(L) % 16 == 0 && B % 4 == 0;
}

}  // namespace

extern "C" {

int ase_chol_max_n() { return kMaxN; }

// Once per device before the first launch: let the kernels take the shared
// memory of the largest n (above the 48 KB default). Returns the CUDA error.
int ase_chol_init() {
  const int fwd = static_cast<int>(forward_smem(kMaxN));
  const int back = static_cast<int>(back_smem(kMaxN));
  const struct {
    const void* kernel;
    int smem;
  } all[] = {{reinterpret_cast<const void*>(chol_forward_kernel<kEngineN>), fwd},
             {reinterpret_cast<const void*>(chol_forward_kernel<0>), fwd},
             {reinterpret_cast<const void*>(back_solve_kernel<kEngineN>), back},
             {reinterpret_cast<const void*>(back_solve_kernel<0>), back}};
  for (const auto& k : all) {
    const cudaError_t e =
        cudaFuncSetAttribute(k.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
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

// The launch shape of ase_back_solve at n: threads and dynamic shared
// memory per block, and blocks the device keeps resident per SM. Needs
// ase_chol_init() first. Returns the CUDA error.
int ase_back_solve_layout(int n, int* threads, int* smem_bytes, int* blocks_per_sm) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kEnvs * kWarps;
  *smem_bytes = static_cast<int>(back_smem(n));
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, back_kernel(n), *threads, back_smem(n)));
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

// x = L^-T y. L is staged by 16-byte copies when it is 16-byte aligned and
// B % 4 == 0, else by 4-byte copies. Needs ase_chol_init() on the device
// first. Returns cudaGetLastError() after the launch.
int ase_back_solve(const float* L, const float* y, float* x, int n, int m,
                   int B, void* stream) {
  if (n < 1 || n > kMaxN || m < 1 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kEnvs, kWarps);
  const dim3 grid((B + kEnvs - 1) / kEnvs);
  const auto kernel = back_kernel(n);
  kernel<<<grid, block, back_smem(n), static_cast<cudaStream_t>(stream)>>>(
      L, y, x, n, m, B, back_vec(L, B));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
