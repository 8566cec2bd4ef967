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
// Lanes never interact, so a tile of LT lanes runs the whole `iters`
// loop in one launch (the Pallas grid over lane tiles). The Pallas kernel
// keeps M resident in VMEM; one SM's 227 KB holds M only up to n ~ 240
// in f32. Two designs, chosen by ops/pallas_cg.plan (a CPU function of
// B, n, the item size and the card's SM count, shared memory and
// co-resident clusters, so the choice, and with it the summation order,
// depends on the card):
//
// "resident" (pcg_resident_kernel). A thread-block cluster of C blocks
// (C in 1, 2, 4, 8) owns a tile of LT lanes (1-6 or 8: odd tiles let a
// batch fill one wave of clusters, e.g. 128 lanes in 26 clusters of 4). Block rank j loads the
// column slice M[:, j w : (j + 1) w] (w = ceil(n / C), the last slice
// ragged) into its shared memory once and keeps it for all steps, so M
// is read from device memory once per launch, not once per step. Each
// block keeps a full copy of p for its lanes in shared memory
// (double-buffered); thread c of block j owns column j w + c and keeps
// that column's x, r, z and p of every lane in registers. The per-lane
// sums go through slots: each block stores its partial into slot [j]
// of every block of the cluster (distributed shared memory, through
// cluster.map_shared_rank), and after the barrier every thread adds the
// C slots in rank order, so every thread of every block holds bitwise
// the same scalars, alpha, beta and freeze mask. One step:
//   1. Mp_j = p M[:, slice j] from shared memory (k cut into groups of
//      threads where n > 128, the groups' sums added in group order);
//      the partial <p, Mp> over the slice into the slots.  barrier 1
//   2. alpha; x, r, z on the owned columns; the partial <r, z>, <r, r>
//      into the slots.                                     barrier 2
//   3. beta; p = z + beta p on the owned columns, stored into the next
//      p buffer of every block of the cluster.             barrier 3
// No step reads another block's shared memory: every remote access is
// a store made before a barrier, and the barrier (release / acquire)
// makes it visible. A cluster of one block stores into its own memory
// and passes block barriers instead. What bounds it: the product's shared-memory reads
// of the slice (n w elements per step and block, about one load per
// FMA at LT = 1) and the latency of the three cluster barriers and the
// two block reductions in front of them, not device memory.
//
// Hazards (block j stores into block q; step t reads p buffer P = p[t &
// 1] and writes P' = p[(t + 1) & 1]):
//   - slot_pmp[j] of q: stored by j before barrier 1 of step t, read by
//     q between barriers 1 and 2 of step t; j stores again in step t + 1,
//     after barrier 3 of step t.
//   - slot_rzrr[j] of q: stored before barrier 2, read by q between
//     barriers 2 and 3 of step t; stored again after barrier 1 of t + 1.
//   - P' of q, j's columns: stored by j between barriers 2 and 3 of step
//     t. q last read that buffer in step t - 1, before its barrier 3
//     (the product reads all of P before barrier 1; the owned columns
//     live in registers), and next reads it in step t + 1, after
//     barrier 3 of step t.
//   - The start: x0 goes into p[1] as the start product's operand (local
//     only), the start's p is stored into p[0] of every block, and its
//     sums into slot_start, which is never stored again; step 0 stores
//     only into p[1], after barrier 2 of step 0.
//   - A block leaves only after one more cluster barrier, so no peer
//     still stores into its shared memory (also at the early exit, which
//     is uniform: every thread holds the same scalars).
// The second p buffer is not what makes three barriers enough: by the
// same argument a single buffer would be safe (P' is stored only after
// barrier 2, when every read of P of that step is done). It costs LT n
// elements of shared memory.
//
// Up to n = 128 k stays whole, and a cluster of one block then computes
// bitwise what the stream design computes. Where a lane's residual
// hovers at its tolerance for several steps, the step at which it
// freezes, and so x, moves with the product's summation order (config
// 3's M in f64: freezing at step 49 instead of 47 moves x by 7e-8).
//
// "stream" (pcg_stream_kernel), for M too large to hold (n = 2000, for
// example): one thread block owns a tile of LT lanes, and its x, r, z,
// p and Mp live in shared memory, while M stays in the 50 MB L2 and is
// streamed every step: thread c owns output column c and walks down
// column c of M with coalesced loads, and every element of M it loads
// feeds all LT lanes of the tile from registers. What bounds it is that
// stream: each block re-reads all of M from L2 every step, and a block
// with few lanes does little work per loaded byte.
//
// Numerics. The products and dot products accumulate with fma in
// ascending index order, and each per-lane sum is reduced in a fixed
// order (warp shuffles, then the warps' partials in warp order, then the
// cluster's blocks in rank order): no atomics, so reruns are bitwise
// identical, and for a fixed design and C a lane's result does not
// depend on LT. Different C (or designs) sum in other orders and agree
// to rounding only. The elementwise steps use _rn intrinsics (no FMA
// contraction) in the plain version's order. max(v, tiny) is written as
// a comparison that keeps a NaN v, as jnp.maximum / torch.clamp do, so a
// NaN in M or rhs reaches the solver's NaN tripwire. A tile stops early
// once every lane is frozen: the frozen steps would leave x unchanged.
//
// Interface: plain C, loaded with ctypes (ops/pallas_cg.py). Each entry
// point launches on the given stream and returns a CUDA error code; a
// refused launch is returned, never replaced by another design.

#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// Per-lane scalars in shared memory (stream design), LT each.
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

// 16-byte vectors of p for the resident product.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const float4 v, float (&e)[4]) {
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  }
};
template <> struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
  static __device__ __forceinline__ void unpack(const double2 v, double (&e)[2]) {
    e[0] = v.x; e[1] = v.y;
  }
};

// max(v, lo) that returns a NaN v unchanged.
template <typename T>
__device__ __forceinline__ T max_keep_nan(T v, T lo) {
  return v < lo ? lo : v;
}

// Each warp's sum of part[q][b] (shuffles in a fixed order) into
// red[warp][q][b]. Ends with the block synchronised.
template <typename T, int LT, int Q>
__device__ __forceinline__ void warp_sums(T (&part)[Q][LT], T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int b = 0; b < LT; ++b) {
      T v = part[q][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = Num<T>::add(v, __shfl_down_sync(FULL_MASK, v, off));
      if (lane == 0) red[(warp * Q + q) * LT + b] = v;
    }
  __syncthreads();
}

// The block's sum of entry i = q * LT + b of red: the warps' sums added
// in warp order.
template <typename T, int LT, int Q>
__device__ __forceinline__ T warps_total(const T* red, int i) {
  T s = T(0);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s = Num<T>::add(s, red[w * Q * LT + i]);
  return s;
}

// dst[q * LT + b] = sum over the block's threads of part[q][b], reduced
// in a fixed order. Ends with the block synchronised.
template <typename T, int LT, int Q>
__device__ __forceinline__ void block_sum(T (&part)[Q][LT], T* red, T* dst) {
  warp_sums<T, LT, Q>(part, red);
  if (threadIdx.x < Q * LT)
    dst[threadIdx.x] = warps_total<T, LT, Q>(red, threadIdx.x);
  __syncthreads();
}

// ---- the resident design ----

// k stays whole (one thread sums a column's n products in ascending k,
// as the stream design does) up to this n; above it, k is cut into
// groups so that all threads work on a narrow slice.
constexpr int WHOLE_K = 128;
constexpr int MAX_CLUSTER = 8;

// The shared-memory layout of one block of a cluster of C, in elements.
// ops/pallas_cg.resident_smem_bytes repeats this arithmetic.
struct Layout {
  int n, w, np, kchunk, ks;
  int p, m, part, red, slot_pmp, slot_rzrr, slot_start;
  long long total;
};

__host__ __device__ inline Layout layout(int n, int C, int lt, int vw) {
  Layout L;
  L.n = n;
  L.w = (n + C - 1) / C;                        // slice width
  L.np = (n + vw - 1) / vw * vw;                // p row stride, 16-byte rows
  int ks = n <= WHOLE_K ? 1 : THREADS / L.w;    // k groups of the product
  if (ks < 1) ks = 1;
  L.kchunk = ((n + ks - 1) / ks + vw - 1) / vw * vw;
  L.ks = (n + L.kchunk - 1) / L.kchunk;
  long long o = 0;
  L.p = static_cast<int>(o); o += 2LL * lt * L.np;   // [2][LT][np], first: aligned
  L.m = static_cast<int>(o); o += static_cast<long long>(n) * L.w;  // [n][w]
  L.part = static_cast<int>(o); o += static_cast<long long>(L.ks) * lt * L.w;
  L.red = static_cast<int>(o); o += WARPS * 3 * lt;
  L.slot_pmp = static_cast<int>(o); o += static_cast<long long>(C) * lt;
  L.slot_rzrr = static_cast<int>(o); o += 2LL * C * lt;
  L.slot_start = static_cast<int>(o); o += 3LL * C * lt;
  L.total = o;
  return L;
}

inline size_t resident_bytes(int n, int C, int lt, size_t itemsize) {
  const int vw = static_cast<int>(16 / itemsize);
  return static_cast<size_t>(layout(n, C, lt, vw).total) * itemsize;
}

// The profiling build (-DPCG_PROFILE, scripts/pcg_phase_breakdown.py):
// thread 0 of block 0 adds the clock64() cycles of each phase into
// g_prof, and counts the steps it ran.
enum Phase { PH_START, PH_PRODUCT, PH_SUM1, PH_BAR1, PH_UPDATE, PH_BAR2,
             PH_P, PH_BAR3, PH_END, PH_STEPS, PHASES };
#ifdef PCG_PROFILE
__device__ long long g_prof[PHASES];
#define PROF_INIT                                                   \
  const bool prof_on = blockIdx.x == 0 && threadIdx.x == 0;        \
  long long prof_t = clock64()
#define PROF(ph)                                                    \
  do {                                                              \
    if (prof_on) {                                                  \
      const long long t_ = clock64();                               \
      g_prof[ph] += t_ - prof_t;                                    \
      prof_t = t_;                                                  \
    }                                                               \
  } while (0)
#define PROF_STEP() do { if (prof_on) ++g_prof[PH_STEPS]; } while (0)
#else
#define PROF_INIT
#define PROF(ph) do {} while (0)
#define PROF_STEP() do {} while (0)
#endif

// mp[b] = sum_k P[b, k] Ms[k, c] for this thread's column c = threadIdx.x
// of the slice (w <= THREADS). k is cut into L.ks groups of L.kchunk;
// thread (g, c) sums group g in ascending k, the column's owner adds the
// groups' sums in group order. Threads past the slice get 0.
template <typename T, int LT>
__device__ __forceinline__ void slice_product(const Layout& L, const T* Ms,
                                              const T* P, T* part,
                                              T (&mp)[LT]) {
  using N = Num<T>;
  using V = Vec<T>;
  constexpr int VW = V::N;
  const int w = L.w, n = L.n, np = L.np;
  for (int idx = threadIdx.x; idx < L.ks * w; idx += THREADS) {
    const int g = idx / w, c = idx - g * w;
    const int k1 = min(n, (g + 1) * L.kchunk);
    T acc[LT];
#pragma unroll
    for (int b = 0; b < LT; ++b) acc[b] = T(0);
    int k = g * L.kchunk;
#pragma unroll 4
    for (; k + VW <= k1; k += VW) {
      T m[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) m[j] = Ms[(k + j) * w + c];
#pragma unroll
      for (int b = 0; b < LT; ++b) {
        T e[VW];
        V::unpack(*reinterpret_cast<const typename V::type*>(P + b * np + k), e);
#pragma unroll
        for (int j = 0; j < VW; ++j) acc[b] = N::fma(e[j], m[j], acc[b]);
      }
    }
    for (; k < k1; ++k) {
      const T m = Ms[k * w + c];
#pragma unroll
      for (int b = 0; b < LT; ++b) acc[b] = N::fma(P[b * np + k], m, acc[b]);
    }
#pragma unroll
    for (int b = 0; b < LT; ++b) part[(g * LT + b) * w + c] = acc[b];
  }
  __syncthreads();
  const int c = threadIdx.x;
#pragma unroll
  for (int b = 0; b < LT; ++b) {
    T s = T(0);
    if (c < w) {
      s = part[b * w + c];
      for (int g = 1; g < L.ks; ++g) s = N::add(s, part[(g * LT + b) * w + c]);
    }
    mp[b] = s;
  }
}

// This block's shared-memory address p in cluster block q's memory; a
// cluster of one block uses the plain address.
template <typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cl, T* p, int q,
                                   int C) {
  return C == 1 ? p : cl.map_shared_rank(p, q);
}

// The cluster barrier; a cluster of one block needs only the block's.
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cl,
                                                int C) {
  if (C == 1)
    __syncthreads();
  else
    cl.sync();
}

// Reduces part[q][b] over the block as block_sum does and stores the
// sums into every cluster block's slot, at [rank][q][b] of a [C][Q][LT]
// array. Not synchronised at its end: a cluster barrier follows.
template <typename T, int LT, int Q>
__device__ __forceinline__ void block_push(cg::cluster_group& cl,
                                           T (&part)[Q][LT], T* red,
                                           T* slot, int rank, int C) {
  warp_sums<T, LT, Q>(part, red);
  if (threadIdx.x < Q * LT) {
    const T s = warps_total<T, LT, Q>(red, threadIdx.x);
    const int at = rank * Q * LT + threadIdx.x;
    for (int q = 0; q < C; ++q) peer(cl, slot, q, C)[at] = s;
  }
}

// The sum over the cluster's blocks, in rank order, of slot[.][q][b]
// (the C loads issued before the adds).
template <typename T, int LT, int Q>
__device__ __forceinline__ T rank_sum(const T* slot, int q, int b, int C) {
  T v[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    v[r] = r < C ? slot[(r * Q + q) * LT + b] : T(0);
  T s = T(0);
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    if (r < C) s = Num<T>::add(s, v[r]);
  return s;
}

template <typename T, int LT>
__global__ void __launch_bounds__(THREADS)
pcg_resident_kernel(const T* __restrict__ M, const T* __restrict__ dinv,
                    const T* __restrict__ rhs, const T* __restrict__ x0,
                    T* __restrict__ out, int B, int n, int iters, T tol_sq) {
  using N = Num<T>;
  PROF_INIT;
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const Layout L = layout(n, C, LT, Vec<T>::N);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Ms = sm + L.m;
  T* part = sm + L.part;
  T* red = sm + L.red;
  T* slot_pmp = sm + L.slot_pmp;
  T* slot_rzrr = sm + L.slot_rzrr;
  T* slot_start = sm + L.slot_start;

  const int tid = threadIdx.x;
  const int w = L.w, np = L.np;
  const int b0 = static_cast<int>(blockIdx.x) / C * LT;
  const int nl = min(LT, B - b0);                // live lanes; the rest are 0
  const int c0 = rank * w;                       // this block's columns
  const int wj = max(0, min(w, n - c0));
  const bool owner = tid < wj;                   // thread tid owns column
  const int col = c0 + tid;                      // c0 + tid of the slice

  // M's slice (columns past n are 0); x0 whole into p[1], the start's
  // product operand (step 0 reads p[0] and writes p[1]).
  for (int i = tid; i < n * w; i += THREADS) {
    const int k = i / w, c = i - k * w;
    Ms[i] = c < wj ? M[static_cast<size_t>(k) * n + c0 + c] : T(0);
  }
  T* P1 = sm + L.p + LT * np;
  for (int i = tid; i < LT * np; i += THREADS) {
    const int b = i / np, k = i - b * np;
    P1[i] = b < nl && k < n ? x0[static_cast<size_t>(b0 + b) * n + k] : T(0);
  }
  // The owned column's x, r, z and p live in registers for the launch.
  T x[LT], r[LT], z[LT], p[LT], mp[LT];
  const T d = owner ? dinv[col] : T(0);
#pragma unroll
  for (int b = 0; b < LT; ++b) {
    x[b] = owner && b < nl ? x0[static_cast<size_t>(b0 + b) * n + col] : T(0);
    r[b] = z[b] = p[b] = T(0);
  }
  __syncthreads();

  // r = rhs - x0 M, z = r dinv, p = z on the slice; rz, rr, |rhs|^2.
  slice_product<T, LT>(L, Ms, P1, part, mp);
  {
    T acc[3][LT];
#pragma unroll
    for (int b = 0; b < LT; ++b) {
      acc[0][b] = acc[1][b] = acc[2][b] = T(0);
      if (owner) {
        const T rh = b < nl ? rhs[static_cast<size_t>(b0 + b) * n + col]
                            : T(0);
        r[b] = N::sub(rh, mp[b]);
        z[b] = N::mul(r[b], d);
        p[b] = z[b];
        acc[0][b] = N::fma(r[b], z[b], T(0));
        acc[1][b] = N::fma(r[b], r[b], T(0));
        acc[2][b] = N::fma(rh, rh, T(0));
        for (int q = 0; q < C; ++q) peer(cl, sm + L.p, q, C)[b * np + col] = p[b];
      }
    }
    block_push<T, LT, 3>(cl, acc, red, slot_start, rank, C);
  }
  cluster_barrier(cl, C);
  // Every thread holds the lanes' scalars, bitwise the same in every
  // thread and block of the cluster.
  T rz[LT], rr[LT], tol2[LT];
#pragma unroll
  for (int b = 0; b < LT; ++b) {
    rz[b] = rank_sum<T, LT, 3>(slot_start, 0, b, C);
    rr[b] = rank_sum<T, LT, 3>(slot_start, 1, b, C);
    const T rhs2 = rank_sum<T, LT, 3>(slot_start, 2, b, C);
    tol2[b] = N::mul(tol_sq, rhs2 < T(1) ? T(1) : rhs2);
  }
  PROF(PH_START);

  for (int it = 0; it < iters; ++it) {
    bool any_active = false;
#pragma unroll
    for (int b = 0; b < LT; ++b) any_active |= rr[b] > tol2[b];
    if (!any_active) break;                      // uniform across the cluster
    PROF_STEP();
    const T* P = sm + L.p + (it & 1) * LT * np;
    T* Pn = sm + L.p + ((it + 1) & 1) * LT * np;

    slice_product<T, LT>(L, Ms, P, part, mp);
    PROF(PH_PRODUCT);
    {
      T acc[1][LT];
#pragma unroll
      for (int b = 0; b < LT; ++b)
        acc[0][b] = owner ? N::fma(p[b], mp[b], T(0)) : T(0);
      block_push<T, LT, 1>(cl, acc, red, slot_pmp, rank, C);
    }
    PROF(PH_SUM1);
    cluster_barrier(cl, C);                      // barrier 1
    PROF(PH_BAR1);

    bool active[LT];
    {
      T acc[2][LT];
#pragma unroll
      for (int b = 0; b < LT; ++b) {
        active[b] = rr[b] > tol2[b];
        const T pmp = rank_sum<T, LT, 1>(slot_pmp, 0, b, C);
        const T alpha = active[b] ? N::div(rz[b], max_keep_nan(pmp, N::tiny()))
                                  : T(0);
        acc[0][b] = acc[1][b] = T(0);
        if (owner) {
          x[b] = N::add(x[b], N::mul(alpha, p[b]));
          r[b] = N::sub(r[b], N::mul(alpha, mp[b]));
          z[b] = N::mul(r[b], d);
          acc[0][b] = N::fma(r[b], z[b], T(0));
          acc[1][b] = N::fma(r[b], r[b], T(0));
        }
      }
      block_push<T, LT, 2>(cl, acc, red, slot_rzrr, rank, C);
    }
    PROF(PH_UPDATE);
    cluster_barrier(cl, C);                      // barrier 2
    PROF(PH_BAR2);

#pragma unroll
    for (int b = 0; b < LT; ++b) {
      const T rz_new = rank_sum<T, LT, 2>(slot_rzrr, 0, b, C);
      const T rr_new = rank_sum<T, LT, 2>(slot_rzrr, 1, b, C);
      const T beta = active[b] ? N::div(rz_new, max_keep_nan(rz[b], N::tiny()))
                               : T(0);
      if (owner) {
        p[b] = N::add(z[b], N::mul(beta, p[b]));
        for (int q = 0; q < C; ++q) peer(cl, Pn, q, C)[b * np + col] = p[b];
      }
      if (active[b]) {
        rz[b] = rz_new;
        rr[b] = rr_new;
      }
    }
    PROF(PH_P);
    cluster_barrier(cl, C);                      // barrier 3
    PROF(PH_BAR3);
  }

  if (owner)
#pragma unroll
    for (int b = 0; b < LT; ++b)
      if (b < nl) out[static_cast<size_t>(b0 + b) * n + col] = x[b];
  cluster_barrier(cl, C);                        // outlive peers' stores
  PROF(PH_END);
}

template <typename T, int LT>
cudaError_t set_smem(size_t bytes) {
  return cudaFuncSetAttribute(pcg_resident_kernel<T, LT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline cudaLaunchConfig_t cluster_config(int grid, int C, size_t bytes,
                                         cudaStream_t s,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int LT>
cudaError_t launch_resident(const T* M, const T* dinv, const T* rhs,
                            const T* x0, T* out, int B, int n, int iters,
                            double tol_sq, int C, cudaStream_t s) {
  // A thread owns each column of a slice.
  if (layout(n, C, LT, Vec<T>::N).w > THREADS) return cudaErrorInvalidValue;
  const size_t bytes = resident_bytes(n, C, LT, sizeof(T));
  cudaError_t err = set_smem<T, LT>(bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config((B + LT - 1) / LT * C, C, bytes, s, attr);
  err = cudaLaunchKernelEx(&cfg, pcg_resident_kernel<T, LT>, M, dinv, rhs,
                           x0, out, B, n, iters, static_cast<T>(tol_sq));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int LT>
cudaError_t max_clusters(int C, int n, int* count) {
  const size_t bytes = resident_bytes(n, C, LT, sizeof(T));
  cudaError_t err = set_smem<T, LT>(bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(C, C, bytes, nullptr, attr);
  return cudaOccupancyMaxActiveClusters(
      count, reinterpret_cast<const void*>(pcg_resident_kernel<T, LT>), &cfg);
}

// ---- the stream design ----

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
pcg_stream_kernel(const T* __restrict__ M, const T* __restrict__ dinv,
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

inline size_t stream_bytes(int lt, int n, size_t itemsize) {
  return (5 * static_cast<size_t>(lt) * n + WARPS * 3 * lt + SLOTS * lt) *
         itemsize;
}

template <typename T, int LT>
cudaError_t launch_stream(const T* M, const T* dinv, const T* rhs,
                          const T* x0, T* out, int B, int n, int iters,
                          double tol_sq, cudaStream_t stream) {
  const size_t bytes = stream_bytes(LT, n, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      pcg_stream_kernel<T, LT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int grid = (B + LT - 1) / LT;
  pcg_stream_kernel<T, LT><<<grid, THREADS, bytes, stream>>>(
      M, dinv, rhs, x0, out, B, n, iters, static_cast<T>(tol_sq));
  return cudaGetLastError();
}

// ---- dispatch ----

// A refused call leaves its error as the runtime's last error; clear it,
// so that the next launch's cudaGetLastError() reports only its own.
inline int result(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T>
int dispatch(const T* M, const T* dinv, const T* rhs, const T* x0, T* out,
             int B, int n, int iters, double tol_sq, int lane_tile,
             int cluster, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 0) {
    switch (lane_tile) {
      case 1: return result(launch_stream<T, 1>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s));
      case 2: return result(launch_stream<T, 2>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s));
      case 4: return result(launch_stream<T, 4>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s));
      case 8: return result(launch_stream<T, 8>(M, dinv, rhs, x0, out, B, n, iters, tol_sq, s));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (lane_tile) {
#define PCG_RESIDENT(LT)                                                    \
    case LT: return result(launch_resident<T, LT>(M, dinv, rhs, x0, out, B, \
                                                  n, iters, tol_sq, cluster, s));
    PCG_RESIDENT(1) PCG_RESIDENT(2) PCG_RESIDENT(3) PCG_RESIDENT(4)
    PCG_RESIDENT(5) PCG_RESIDENT(6) PCG_RESIDENT(8)
#undef PCG_RESIDENT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int query_clusters(int cluster, int lane_tile, int n, int* count) {
  switch (lane_tile) {
#define PCG_QUERY(LT) \
    case LT: return result(max_clusters<T, LT>(cluster, n, count));
    PCG_QUERY(1) PCG_QUERY(2) PCG_QUERY(3) PCG_QUERY(4) PCG_QUERY(5)
    PCG_QUERY(6) PCG_QUERY(8)
#undef PCG_QUERY
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cluster 0: the stream design; 1, 2, 4 or 8: the resident design with
// clusters of that many blocks.
extern "C" int admm_pcg_f32(const float* M, const float* dinv,
                            const float* rhs, const float* x0, float* out,
                            int B, int n, int iters, double tol_sq,
                            int lane_tile, int cluster, void* stream) {
  return dispatch<float>(M, dinv, rhs, x0, out, B, n, iters, tol_sq,
                         lane_tile, cluster, stream);
}

extern "C" int admm_pcg_f64(const double* M, const double* dinv,
                            const double* rhs, const double* x0, double* out,
                            int B, int n, int iters, double tol_sq,
                            int lane_tile, int cluster, void* stream) {
  return dispatch<double>(M, dinv, rhs, x0, out, B, n, iters, tol_sq,
                          lane_tile, cluster, stream);
}

// Dynamic shared memory one block needs: the stream design's for
// cluster 0, else the resident design's with clusters of `cluster`.
extern "C" long long admm_pcg_smem_bytes(int cluster, int lane_tile, int n,
                                         int itemsize) {
  if (cluster == 0)
    return static_cast<long long>(stream_bytes(lane_tile, n, itemsize));
  return static_cast<long long>(resident_bytes(n, cluster, lane_tile,
                                               itemsize));
}

// Clusters of the resident design the current card can hold at once,
// into *count; returns a CUDA error code.
extern "C" int admm_pcg_max_clusters(int cluster, int lane_tile, int n,
                                     int itemsize, int* count) {
  *count = 0;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return itemsize == 4 ? query_clusters<float>(cluster, lane_tile, n, count)
                       : query_clusters<double>(cluster, lane_tile, n, count);
}

#ifdef PCG_PROFILE
// The profiling build's cycles per phase (Phase order) and step count
// into out[PHASES]; reset zeroes them afterwards.
extern "C" int admm_pcg_profile(long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));
  if (err == cudaSuccess && reset) {
    const long long zero[PHASES] = {};
    err = cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
  }
  return result(err);
}
#endif

extern "C" const char* admm_pcg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
