// Lockstep Jacobi-preconditioned conjugate gradient on M x = rhs for a
// (B, n) batch of right-hand sides against one shared SPD M, in f32 and
// f64, for Hopper (sm_90a). Replaces
// admm_library_tpu/ops/pallas_cg.py::pallas_cg_solve (math `_cg_math`).
//
// Per lane, with dinv = 1 / diag(M) and tol2 = tol^2 max(|rhs|^2, 1):
//
//   r = rhs - x0 M,  z = r dinv,  p = z,  rz = <r, z>,  rr = <r, r>
//   iters times:
//     Mp = p M;  active = rr > tol2
//     alpha = active ? rz / max(<p, Mp>, tiny) : 0
//     x += alpha p;  r -= alpha Mp;  z = r dinv
//     beta = active ? <r, z> / max(rz, tiny) : 0
//     p = z + beta p;  rz, rr advance where active
//
// A lane whose residual met the tolerance freezes (alpha = beta = 0).
//
// Design. Lanes never interact, so one thread block owns a tile of
// LT lanes and runs the whole `iters` loop in one launch (the Pallas
// grid over lane tiles). The lanes' x, r, z, p and Mp live in shared
// memory. The Pallas kernel keeps M resident in VMEM; at the flagship
// n = 450, M is 810 KB in f32 and 1.6 MB in f64, far above one SM's
// 227 KB, so here M stays in the 50 MB L2 and is streamed every step:
// thread c owns output column c and walks down column c of M with
// coalesced loads (neighbouring threads read neighbouring columns),
// and every element of M it loads feeds all LT lanes of the tile from
// registers. What bounds it is that stream: each block re-reads all of
// M from L2 every step, and a block with few lanes does little work
// per loaded byte (PERF.md §6 has the measured times).
//
// Numerics. The products and dot products accumulate with fma in
// ascending index order, and each per-lane sum is reduced across the
// block in a fixed order (warp shuffles, then the warps' partials in
// warp order): no atomics, so reruns are bitwise identical. The
// elementwise steps use _rn intrinsics (no FMA contraction) in the
// plain version's order. max(v, tiny) is written as a comparison that
// keeps a NaN v, as jnp.maximum / torch.clamp do, so a NaN in M or rhs
// reaches the solver's NaN tripwire. The block stops early once every
// lane of its tile is frozen: the frozen steps would leave x unchanged.
//
// Interface: plain C, loaded with ctypes (ops/pallas_cg.py). Each entry
// point launches on the given stream and returns cudaGetLastError().

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Per-lane scalars in shared memory, LT each.
enum Slot { RZ, RR, TOL2, PMP, RZ_NEW, RR_NEW, SLOTS };

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
};

template <> struct Num<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return ::fma(a, b, c); }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
};

// max(v, lo) that returns a NaN v unchanged.
template <typename T>
__device__ __forceinline__ T max_keep_nan(T v, T lo) {
  return v < lo ? lo : v;
}

// dst[q * LT + b] = sum over the block's threads of part[q][b], reduced
// in a fixed order. Ends with the block synchronised.
template <typename T, int LT, int Q>
__device__ __forceinline__ void block_sum(T (&part)[Q][LT], T* red, T* dst) {
  using N = Num<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int b = 0; b < LT; ++b) {
      T v = part[q][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = N::add(v, __shfl_down_sync(FULL_MASK, v, off));
      if (lane == 0) red[(warp * Q + q) * LT + b] = v;
    }
  __syncthreads();
  if (threadIdx.x < Q * LT) {
    const int q = threadIdx.x / LT, b = threadIdx.x % LT;
    T s = T(0);
    for (int w = 0; w < WARPS; ++w) s = N::add(s, red[(w * Q + q) * LT + b]);
    dst[q * LT + b] = s;
  }
  __syncthreads();
}

// Mp[b, c] = sum_k src[b, k] M[k, c] for the columns c this thread owns.
template <typename T, int LT>
__device__ __forceinline__ void matvec(const T* __restrict__ M, const T* src,
                                       T* Mp, int n) {
  using N = Num<T>;
  for (int c = threadIdx.x; c < n; c += THREADS) {
    T acc[LT];
#pragma unroll
    for (int b = 0; b < LT; ++b) acc[b] = T(0);
    const T* col = M + c;
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const T m = __ldg(col + static_cast<size_t>(k) * n);
#pragma unroll
      for (int b = 0; b < LT; ++b) acc[b] = N::fma(src[b * n + k], m, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < LT; ++b) Mp[b * n + c] = acc[b];
  }
}

template <typename T, int LT>
__global__ void __launch_bounds__(THREADS)
pcg_kernel(const T* __restrict__ M, const T* __restrict__ dinv,
           const T* __restrict__ rhs, const T* __restrict__ x0,
           T* __restrict__ out, int B, int n, int iters, T tol_sq) {
  using N = Num<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* p = reinterpret_cast<T*>(smem_raw);        // [LT][n] each
  T* Mp = p + LT * n;
  T* x = Mp + LT * n;
  T* r = x + LT * n;
  T* z = r + LT * n;
  T* red = z + LT * n;                           // [WARPS][3][LT]
  T* s = red + WARPS * 3 * LT;                   // [SLOTS][LT]

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * LT;
  const int nl = min(LT, B - b0);                // live lanes; the rest are 0

  for (int i = tid; i < LT * n; i += THREADS) {
    const int b = i / n;
    x[i] = b < nl ? x0[static_cast<size_t>(b0) * n + i] : T(0);
  }
  __syncthreads();

  // r = rhs - x0 M, z = r dinv, p = z; rz, rr and |rhs|^2.
  matvec<T, LT>(M, x, Mp, n);
  {
    T part[3][LT];
#pragma unroll
    for (int b = 0; b < LT; ++b) part[0][b] = part[1][b] = part[2][b] = T(0);
    for (int c = tid; c < n; c += THREADS) {
      const T d = dinv[c];
#pragma unroll
      for (int b = 0; b < LT; ++b) {
        const int i = b * n + c;
        const T rh = b < nl ? rhs[static_cast<size_t>(b0) * n + i] : T(0);
        const T rv = N::sub(rh, Mp[i]);
        const T zv = N::mul(rv, d);
        r[i] = rv;
        z[i] = zv;
        p[i] = zv;
        part[0][b] = N::fma(rv, zv, part[0][b]);
        part[1][b] = N::fma(rv, rv, part[1][b]);
        part[2][b] = N::fma(rh, rh, part[2][b]);
      }
    }
    block_sum<T, LT, 3>(part, red, s + RZ * LT);   // RZ, RR, TOL2 (= |rhs|^2)
  }
  if (tid < LT) {
    const T rhs2 = s[TOL2 * LT + tid];
    s[TOL2 * LT + tid] = N::mul(tol_sq, rhs2 < T(1) ? T(1) : rhs2);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    bool any_active = false;
#pragma unroll
    for (int b = 0; b < LT; ++b) any_active |= s[RR * LT + b] > s[TOL2 * LT + b];
    if (!any_active) break;                      // uniform across the block

    matvec<T, LT>(M, p, Mp, n);
    {
      T part[1][LT];
#pragma unroll
      for (int b = 0; b < LT; ++b) part[0][b] = T(0);
      for (int c = tid; c < n; c += THREADS)
#pragma unroll
        for (int b = 0; b < LT; ++b)
          part[0][b] = N::fma(p[b * n + c], Mp[b * n + c], part[0][b]);
      block_sum<T, LT, 1>(part, red, s + PMP * LT);
    }

    T alpha[LT];
#pragma unroll
    for (int b = 0; b < LT; ++b) {
      const bool active = s[RR * LT + b] > s[TOL2 * LT + b];
      alpha[b] = active ? N::div(s[RZ * LT + b],
                                 max_keep_nan(s[PMP * LT + b], N::tiny()))
                        : T(0);
    }
    {
      T part[2][LT];
#pragma unroll
      for (int b = 0; b < LT; ++b) part[0][b] = part[1][b] = T(0);
      for (int c = tid; c < n; c += THREADS) {
        const T d = dinv[c];
#pragma unroll
        for (int b = 0; b < LT; ++b) {
          const int i = b * n + c;
          x[i] = N::add(x[i], N::mul(alpha[b], p[i]));
          const T rv = N::sub(r[i], N::mul(alpha[b], Mp[i]));
          const T zv = N::mul(rv, d);
          r[i] = rv;
          z[i] = zv;
          part[0][b] = N::fma(rv, zv, part[0][b]);
          part[1][b] = N::fma(rv, rv, part[1][b]);
        }
      }
      block_sum<T, LT, 2>(part, red, s + RZ_NEW * LT);  // RZ_NEW, RR_NEW
    }

    T beta[LT];
#pragma unroll
    for (int b = 0; b < LT; ++b) {
      const bool active = s[RR * LT + b] > s[TOL2 * LT + b];
      beta[b] = active ? N::div(s[RZ_NEW * LT + b],
                                max_keep_nan(s[RZ * LT + b], N::tiny()))
                       : T(0);
    }
    for (int c = tid; c < n; c += THREADS)
#pragma unroll
      for (int b = 0; b < LT; ++b) {
        const int i = b * n + c;
        p[i] = N::add(z[i], N::mul(beta[b], p[i]));
      }
    __syncthreads();                             // rz, rr read by all
    if (tid < LT && s[RR * LT + tid] > s[TOL2 * LT + tid]) {
      s[RZ * LT + tid] = s[RZ_NEW * LT + tid];
      s[RR * LT + tid] = s[RR_NEW * LT + tid];
    }
    __syncthreads();
  }

  for (int i = tid; i < nl * n; i += THREADS)
    out[static_cast<size_t>(b0) * n + i] = x[i];
}

inline size_t smem_bytes(int lt, int n, size_t itemsize) {
  return (5 * static_cast<size_t>(lt) * n + WARPS * 3 * lt + SLOTS * lt) *
         itemsize;
}

template <typename T, int LT>
int launch(const T* M, const T* dinv, const T* rhs, const T* x0, T* out,
           int B, int n, int iters, double tol_sq, cudaStream_t stream) {
  const size_t bytes = smem_bytes(LT, n, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      pcg_kernel<T, LT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + LT - 1) / LT;
  pcg_kernel<T, LT><<<grid, THREADS, bytes, stream>>>(
      M, dinv, rhs, x0, out, B, n, iters, static_cast<T>(tol_sq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* M, const T* dinv, const T* rhs, const T* x0, T* out,
             int B, int n, int iters, double tol_sq, int lane_tile,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane_tile) {
    case 1: return launch<T, 1>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s);
    case 2: return launch<T, 2>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s);
    case 4: return launch<T, 4>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s);
    case 8: return launch<T, 8>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int admm_pcg_f32(const float* M, const float* dinv,
                            const float* rhs, const float* x0, float* out,
                            int B, int n, int iters, double tol_sq,
                            int lane_tile, void* stream) {
  return dispatch<float>(M, dinv, rhs, x0, out, B, n, iters, tol_sq,
                         lane_tile, stream);
}

extern "C" int admm_pcg_f64(const double* M, const double* dinv,
                            const double* rhs, const double* x0, double* out,
                            int B, int n, int iters, double tol_sq,
                            int lane_tile, void* stream) {
  return dispatch<double>(M, dinv, rhs, x0, out, B, n, iters, tol_sq,
                          lane_tile, stream);
}

// Dynamic shared memory one block of `lane_tile` lanes needs.
extern "C" long long admm_pcg_smem_bytes(int lane_tile, int n, int itemsize) {
  return static_cast<long long>(smem_bytes(lane_tile, n, itemsize));
}

extern "C" const char* admm_pcg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
