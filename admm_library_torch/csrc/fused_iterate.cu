// Fused ADMM iteration for the shared-matrix lane batch, f32, for Hopper
// (sm_90a). Replaces admm_library_tpu/ops/fused.py::fused_iterate_shared.
//
// One call runs k iterations of
//
//   rhs = sigma x - q + (rho.z - y) A            (B, n)
//   xt  = rhs Minv;  refine: r = rhs - xt M;  xt += r Minv
//   zt  = xt A^T                                 (B, m)
//   x+  = alpha xt + (1 - alpha) x
//   w   = alpha zt + (1 - alpha) z
//   z+  = Pi(w + y / rho),  y+ = y + rho (w - z+)
//
// with Pi the clip on box rows, clip(soft-threshold(lam/rho)) on L1
// rows and the second-order-cone projection on uniform SOC blocks.
//
// Design. The Pallas kernel keeps A, A^T, Minv and M (3.3 MB at the
// flagship n=450, m=456) resident in VMEM for the whole k-block. One SM
// holds 227 KB, so here the shared matrices live in the 50 MB L2 and
// every product is its own launch of one tiled FFMA GEMM kernel: each
// block owns a 32-lane x 32-column output tile and streams 32-deep
// slices of both operands through shared memory, so every L2 byte of a
// shared matrix feeds 32 lanes' FMAs. The elementwise work is fused
// into the GEMMs: rho.z - y is formed while the rhs product loads its
// left operand, sigma x - q is added in its epilogue, the refinement
// steps and the over-relaxation of x are epilogues of the Minv/M
// products, and the zt product's epilogue does the over-relaxation of
// z, the box/L1 prox and the dual update. SOC rows leave w in a scratch
// buffer for one small per-(lane, block) projection kernel. x, z and y
// are updated in place: every element is read and written by the same
// thread of the same launch. Measured on the H100 (PERF.md §5) the
// products run at ~1.8 TFLOP/s (batch 128, 60 blocks) and ~8.3 TFLOP/s
// (batch 1024): latency with few warps per SM bounds them, not the L2
// traffic (~0.24 TB/s at batch 128) nor the FMA units.
//
// Numerics. Plain f32 FMA, no TF32. Each output element is summed by
// one thread in ascending reduction order (no split-K, no atomics), so
// reruns are bitwise identical. The elementwise steps use _rn
// intrinsics so that nvcc does not contract them into FMAs, and follow
// the plain PyTorch version's operation order. Comparisons are written
// so that a NaN propagates (the solver's NaN tripwire relies on it).
//
// Interface: plain C, loaded with ctypes (ops/fused.py). The entry
// point issues every launch on the given stream and returns the first
// non-zero cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;                          // lanes per tile
constexpr int BN = 32;                          // output columns per tile
constexpr int BK = 32;                          // reduction slice
constexpr int TY = 16, TX = 16;                 // thread grid of a block
constexpr int TM = BM / TY, TN = BN / TX;       // outputs per thread
constexpr int THREADS = TY * TX;

enum Mode { RHS, SOLVE, RESID, CORRECT, ZT };

struct Args {
  const float* A;       // (m, n)
  const float* Minv;    // (n, n)
  const float* M;       // (n, n)
  const float* q;       // (n)
  const float* rho;     // (m)
  const float* lam_r;   // (ml) lam / rho on the L1 rows
  const float* l;       // (B, m)
  const float* u;       // (B, m)
  float* x;             // (B, n) in/out
  float* z;             // (B, m) in/out
  float* y;             // (B, m) in/out
  float* rhs;           // (B, n) scratch
  float* xt;            // (B, n) scratch
  float* r;             // (B, n) scratch
  float* w;             // (B, m) scratch, SOC rows only
  int B, n, m, mb, ml, n_soc, soc_dim;
  float sigma, alpha, one_minus_alpha;
  int last;             // this x-tilde update is the final one
};

__device__ __forceinline__ float relax(const Args& a, float t, float prev) {
  return __fadd_rn(__fmul_rn(a.alpha, t), __fmul_rn(a.one_minus_alpha, prev));
}

// clip(v, lo, hi) = min(max(v, lo), hi), NaN in -> NaN out.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

template <int MODE>
__device__ __forceinline__ float load_left(const Args& a, int b, int k) {
  if (MODE == RHS) {
    const int i = b * a.m + k;
    return __fsub_rn(__fmul_rn(a.rho[k], a.z[i]), a.y[i]);
  }
  if (MODE == SOLVE) return a.rhs[b * a.n + k];
  if (MODE == CORRECT) return a.r[b * a.n + k];
  return a.xt[b * a.n + k];                       // RESID, ZT
}

template <int MODE>
__device__ __forceinline__ float load_right(const Args& a, int k, int c) {
  if (MODE == RHS) return a.A[k * a.n + c];
  if (MODE == RESID) return a.M[k * a.n + c];
  if (MODE == ZT) return a.A[c * a.n + k];        // A^T
  return a.Minv[k * a.n + c];                     // SOLVE, CORRECT
}

template <int MODE>
__device__ __forceinline__ void epilogue(const Args& a, int b, int c,
                                         float acc) {
  if (MODE == RHS) {
    const int i = b * a.n + c;
    a.rhs[i] = __fadd_rn(__fsub_rn(__fmul_rn(a.sigma, a.x[i]), a.q[c]), acc);
  } else if (MODE == SOLVE || MODE == CORRECT) {
    const int i = b * a.n + c;
    const float v = MODE == SOLVE ? acc : __fadd_rn(a.xt[i], acc);
    a.xt[i] = v;
    if (a.last) a.x[i] = relax(a, v, a.x[i]);
  } else if (MODE == RESID) {
    const int i = b * a.n + c;
    a.r[i] = __fsub_rn(a.rhs[i], acc);
  } else {                                        // ZT: prox + dual update
    const int i = b * a.m + c;
    const float w = relax(a, acc, a.z[i]);
    if (c >= a.mb + a.ml) {                       // SOC row
      a.w[i] = w;
      return;
    }
    const float rho = a.rho[c];
    const float yv = a.y[i];
    const float v = __fadd_rn(w, __fdiv_rn(yv, rho));
    float p = v;
    if (c >= a.mb) {                              // L1 row: soft-threshold
      float s = __fsub_rn(fabsf(v), a.lam_r[c - a.mb]);
      s = s < 0.f ? 0.f : s;
      const float sgn = v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
      p = __fmul_rn(sgn, s);
    }
    const float zn = clip(p, a.l[i], a.u[i]);
    a.z[i] = zn;
    a.y[i] = __fadd_rn(yv, __fmul_rn(rho, __fsub_rn(w, zn)));
  }
}

// out[b, c] = sum_k left(b, k) * right(k, c) for b < B, c < N, k < K,
// then epilogue<MODE>(b, c, out). Ragged edges load zeros.
template <int MODE>
__global__ void __launch_bounds__(THREADS) gemm_step(Args a, int K, int N) {
  __shared__ float Ls[BK][BM + 1];
  __shared__ float Rs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int b0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int rr = e / BK, kk = e % BK;         // consecutive threads: k
      const int b = b0 + rr, k = k0 + kk;
      Ls[kk][rr] = (b < a.B && k < K) ? load_left<MODE>(a, b, k) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      // Coalesce along the operand's contiguous index.
      const int kk = MODE == ZT ? e % BK : e / BN;
      const int cc = MODE == ZT ? e / BK : e % BN;
      const int k = k0 + kk, c = c0 + cc;
      Rs[kk][cc] = (k < K && c < N) ? load_right<MODE>(a, k, c) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float lv[TM], rv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) lv[i] = Ls[kk][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) rv[j] = Rs[kk][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(lv[i], rv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int b = b0 + ty + TY * i, c = c0 + tx + TX * j;
      if (b < a.B && c < N) epilogue<MODE>(a, b, c, acc[i][j]);
    }
}

// One thread per (lane, SOC block): v = w + y/rho, project onto the
// cone, dual update.
__global__ void soc_step(Args a) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= a.B * a.n_soc) return;
  const int b = t / a.n_soc, blk = t % a.n_soc, d = a.soc_dim;
  const int c0 = a.mb + a.ml + blk * d;
  const int i0 = b * a.m + c0;
  float nu2 = 0.f;
  for (int j = 1; j < d; ++j) {
    const float v = __fadd_rn(a.w[i0 + j], __fdiv_rn(a.y[i0 + j], a.rho[c0 + j]));
    nu2 = __fadd_rn(nu2, __fmul_rn(v, v));
  }
  const float t0 = __fadd_rn(a.w[i0], __fdiv_rn(a.y[i0], a.rho[c0]));
  const float nu = __fsqrt_rn(nu2 < 0.f ? 0.f : nu2);
  const float safe = nu > 0.f ? nu : 1.f;
  const float cmid = __fmul_rn(0.5f, __fadd_rn(t0, nu));
  const bool in_cone = nu <= t0, in_polar = nu <= -t0;
  const float t_out = in_cone ? t0 : (in_polar ? 0.f : cmid);
  const float scal = in_cone ? 1.f : (in_polar ? 0.f : __fdiv_rn(cmid, safe));
  for (int j = 0; j < d; ++j) {
    const int i = i0 + j;
    const float rho = a.rho[c0 + j];
    const float w = a.w[i];
    const float yv = a.y[i];
    const float zn =
        j == 0 ? t_out : __fmul_rn(__fadd_rn(w, __fdiv_rn(yv, rho)), scal);
    a.z[i] = zn;
    a.y[i] = __fadd_rn(yv, __fmul_rn(rho, __fsub_rn(w, zn)));
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int admm_fused_iterate_f32(
    const float* A, const float* Minv, const float* M, const float* q,
    const float* rho, const float* lam_r, const float* l, const float* u,
    float* x, float* z, float* y, float* rhs, float* xt, float* r, float* w,
    int B, int n, int m, int mb, int ml, int n_soc, int soc_dim,
    float sigma, float alpha, float one_minus_alpha, int k,
    int refine_steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{A, Minv, M, q, rho, lam_r, l, u, x, z, y, rhs, xt, r, w,
         B, n, m, mb, ml, n_soc, soc_dim, sigma, alpha, one_minus_alpha, 0};
  const dim3 block(THREADS);
  const dim3 grid_n(cdiv(n, BN), cdiv(B, BM));
  const dim3 grid_m(cdiv(m, BN), cdiv(B, BM));
  cudaError_t err;
#define ADMM_CHECK_LAUNCH()                               \
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err)
  for (int it = 0; it < k; ++it) {
    gemm_step<RHS><<<grid_n, block, 0, s>>>(a, m, n);
    ADMM_CHECK_LAUNCH();
    a.last = refine_steps == 0;
    gemm_step<SOLVE><<<grid_n, block, 0, s>>>(a, n, n);
    ADMM_CHECK_LAUNCH();
    for (int st = 0; st < refine_steps; ++st) {
      gemm_step<RESID><<<grid_n, block, 0, s>>>(a, n, n);
      ADMM_CHECK_LAUNCH();
      a.last = st == refine_steps - 1;
      gemm_step<CORRECT><<<grid_n, block, 0, s>>>(a, n, n);
      ADMM_CHECK_LAUNCH();
    }
    gemm_step<ZT><<<grid_m, block, 0, s>>>(a, n, m);
    ADMM_CHECK_LAUNCH();
    if (n_soc > 0) {
      soc_step<<<cdiv(B * n_soc, 128), 128, 0, s>>>(a);
      ADMM_CHECK_LAUNCH();
    }
  }
#undef ADMM_CHECK_LAUNCH
  return 0;
}

extern "C" const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
