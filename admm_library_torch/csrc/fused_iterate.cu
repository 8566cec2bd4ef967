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
// What bounds it. A k-block must read A, Minv and M once and do
// 2 B k (2 m n + (1 + 2 refine) n^2) flops: at B=1, n=2000, k=25 about
// 15 us of HBM and as much of FFMA; at B=128, n=450 about 97 us of
// FFMA; at B=1024, n=450 0.78 ms of FFMA, with each product moving the
// lanes' left operand and the matrix through L2 to every block that
// needs them. What
// held the first design (one launch of a tiled GEMM per product,
// 125-150 dependent launches per k-block, at B=1 one busy tile row of
// 32) far from that was latency, and latency still sets the pace up to
// B=256: grid barriers and round trips to L2 (PERF.md section 6).
//
// Two designs, chosen by ops/fused.plan from B. Up to B=256 the split
// design below, which spreads each product over the whole grid. Above
// it the cluster design (namespace big, further down), where the FFMA
// rate and the L2 set the pace: clusters own their lanes, so the grid
// needs no barrier and no partial sums, and each block runs its
// products as a Hopper SGEMM, register-blocked and fed by TMA.
//
// The split design. One persistent cooperative launch runs all k
// iterations with one block per SM. ops/fused.plan cuts A into (lane
// group x row chunk x column chunk) tiles, one per block, and M^-1 and
// M likewise; a block keeps its tiles in shared memory for the whole
// launch where they fit (the Pallas kernel's VMEM residency, spread
// over the grid) and streams them from L2 in every product where they
// do not. Each product
// is a phase in which every block multiplies its lanes' slice of the
// left operand (staged in shared memory) by its tile, the reduction
// axis split over the threads as well, and writes its partial sums; a
// grid barrier; then a phase that adds each output's partial sums in
// chunk order and applies that product's elementwise step: the rhs
// assembly, the refinement, the relaxation of x after the last M^-1
// product, and after the z-tilde product the relaxation of z, the prox
// and the dual update. One thread owns one box or L1 row or one whole
// SOC block of a lane there, so the cone projection needs no scratch
// and no second kernel. The rhs and z-tilde products use the same A
// tile (A^T is never stored), so A is read once per iteration per
// product that needs it. With refine_steps = 1 an iteration is 10
// phases and 10 grid barriers. A thread owns TL lanes x 4 outputs:
// TL = 1 up to B=8 (512 threads, GEMV-shaped, split-K over the grid),
// TL = 4 above (256 threads).
//
// Grid barrier: a counter in device memory, one release add per block
// and an acquire spin by one thread (no relocatable device code needed
// for cooperative_groups::this_grid().sync()). The cooperative launch
// guarantees every block is resident; it is refused, and the entry
// point returns the error, when the grid is larger than that. Every
// block reaches every barrier: there is no early return. Data written
// inside the launch is read with ld.global.cg (L2), never through the
// SM's L1.
//
// Alignment. A row of an n=450 matrix is 1,800 bytes, not a multiple of
// 16. Tiles in shared memory are copied with zero padding to rows of a
// multiple of 4 floats, so every shared-memory read is a float4.
// Streamed tiles use float4 loads only where the matrix row stride is a
// multiple of 4 floats and the base is 16-byte aligned, else scalar
// loads; nothing is padded in device memory.
//
// Numerics. Products of f32 operands, no TF32; the accumulator is f64
// (each product then rounded to f32 once, whatever the partition). An
// output's partial sums are formed in a fixed order inside a block and
// added across blocks in chunk order by one thread (no atomics), so reruns are bitwise identical. The
// elementwise steps use _rn intrinsics so that nvcc does not contract
// them into FMAs, and follow the plain PyTorch version's operation
// order. Comparisons are written so that a NaN propagates (the
// solver's NaN tripwire relies on it).
//
// Interface: plain C, loaded with ctypes (ops/fused.py). The entry
// point launches once on the given stream, the design its plan's
// length names, and returns the first non-zero CUDA error. It may be
// called while that stream is being captured into a CUDA graph: the
// split design's barrier counter is then zeroed by a node of the same
// graph before the kernel's node, so every replay starts it from 0.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Threads per block: 512 in the GEMV-shaped regime, where loads in
// flight set the pace; 256 above it, so that a thread holds its 4 x 4
// register tile and its operands in registers (ops/fused.threads).
__host__ __device__ constexpr int threads_of(int tl) {
  return tl == 1 ? 512 : 256;
}
constexpr int PLAN_INTS = 28;

struct Tiling {
  int groups, lanes, rsplits, rchunk, csplits, cchunk;
};

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
  void* part_n;         // (splits, B, n) partial sums of the n-wide products
  void* part_m;         // (splits, B, m) partial sums of the z-tilde product
  unsigned* bar;        // grid barrier counter, 0 at launch
  int B, n, m, mb, ml, n_soc, soc_dim;
  float sigma, alpha, one_minus_alpha;
  int k, refine_steps;
  int lane_chunk, a_res, minv_res, m_res, ld_a, ld_nn, ld_left;
  int off_a, off_minv, off_m, off_left, off_red;
  Tiling ta, tn;
};

// One block's tile of a Tiling: lanes [b0, b0+nb), rows [r0, r0+nr),
// columns [c0, c0+nc); i and j are its row and column chunk.
struct Tile {
  int b0, nb, r0, nr, c0, nc, i, j;
  bool valid;
};

__device__ Tile tile_of(const Tiling& t, int g, int B, int rows, int cols) {
  Tile T;
  const int per_group = t.rsplits * t.csplits;
  T.valid = g < t.groups * per_group;
  const int gi = g / per_group, rest = g % per_group;
  T.i = rest / t.csplits;
  T.j = rest % t.csplits;
  T.b0 = gi * t.lanes;
  T.nb = min(B, T.b0 + t.lanes) - T.b0;
  T.r0 = T.i * t.rchunk;
  T.nr = min(rows, T.r0 + t.rchunk) - T.r0;
  T.c0 = T.j * t.cchunk;
  T.nc = min(cols, T.c0 + t.cchunk) - T.c0;
  return T;
}

__device__ __forceinline__ float relax(const Args& a, float t, float prev) {
  return __fadd_rn(__fmul_rn(a.alpha, t), __fmul_rn(a.one_minus_alpha, prev));
}

// clip(v, lo, hi) = min(max(v, lo), hi), NaN in -> NaN out.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  v = v < lo ? lo : v;
  return v > hi ? hi : v;
}

__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(v)
                   : "l"(bar)
                   : "memory");
    } while (static_cast<int>(v - target) < 0);
  }
  __syncthreads();
}

// dst (rows_alloc x ld, shared) = src[r0:r0+nr, c0:c0+nc], zero padded;
// BATCH loads in flight per thread.
__device__ void load_tile(float* dst, int ld, int rows_alloc, const float* src,
                          int ldsrc, int r0, int nr, int c0, int nc) {
  constexpr int BATCH = 8;
  const int total = rows_alloc * ld, nth = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += BATCH * nth) {
    float v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int e = e0 + u * nth, rr = e / ld, cc = e % ld;
      v[u] = (e < total && rr < nr && cc < nc)
                 ? __ldg(src + (size_t)(r0 + rr) * ldsrc + c0 + cc)
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * nth < total) dst[e0 + u * nth] = v[u];
  }
}

// Four consecutive values of a streamed matrix row: p[0..3], those at
// or past `left` zero.
__device__ __forceinline__ float4 load4_global(const float* p, int left,
                                               bool vec) {
  if (vec && left >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = left > 0 ? __ldg(p) : 0.f;
  v.y = left > 1 ? __ldg(p + 1) : 0.f;
  v.z = left > 2 ? __ldg(p + 2) : 0.f;
  v.w = left > 3 ? __ldg(p + 3) : 0.f;
  return v;
}

// The accumulator AccT of the products (ops/fused.ACC_BYTES): f64, as
// latency and barriers set the pace here and the FMA units idle, so
// that a product of f32 operands is rounded once, whatever the
// partition.

__device__ __forceinline__ float mac(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double mac(float a, float b, double c) {
  return fma(static_cast<double>(a), static_cast<double>(b), c);
}

template <typename T>
__device__ __forceinline__ void mac4(T (&acc)[4], float s, float4 v) {
  acc[0] = mac(s, v.x, acc[0]);
  acc[1] = mac(s, v.y, acc[1]);
  acc[2] = mac(s, v.z, acc[2]);
  acc[3] = mac(s, v.w, acc[3]);
}

template <typename T>
__device__ __forceinline__ T dot4(float4 p, float4 v, T acc) {
  acc = mac(p.x, v.x, acc);
  acc = mac(p.y, v.y, acc);
  acc = mac(p.z, v.z, acc);
  return mac(p.w, v.w, acc);
}

// Element kk of lane b of a product's left operand.
__device__ __forceinline__ float left_of(const Args& a, bool left_rhs,
                                         const float* lsrc, int b, int kg) {
  if (left_rhs) {
    const size_t i = (size_t)b * a.m + kg;
    return __fsub_rn(__fmul_rn(__ldg(a.rho + kg), __ldcg(a.z + i)),
                     __ldcg(a.y + i));
  }
  return __ldcg(lsrc + (size_t)b * a.n + kg);
}

// One block's share of a product, written as partial sums to part
// (B, n_out) for the tile's lanes and outputs.
//
// NT = false: out[b, c] = sum_k left[b, k] R[k, c], with k the tile's
//   rows and c its columns; R row-major (K, N).
// NT = true:  out[b, r] = sum_k left[b, k] R[r, k], with r the tile's
//   rows and k its columns (the z-tilde product on A itself).
// With RES the tile is Rs in shared memory (ld ldRs), else Rg (row
// stride ldRg) is read from L2. The left operand is rho.z - y when
// left_rhs, else lsrc (B, n).
//
// A thread owns TL lanes x 4 outputs and a strided share of the tile's
// reduction axis; the shares are added in order through shared memory.
template <int TL, typename AccT, bool NT, bool RES>
__device__ void tile_product(const Args& a, float* sm, const Tile& T,
                             bool left_rhs, const float* lsrc, const float* Rs,
                             int ldRs, const float* Rg, int ldRg,
                             AccT* part, int n_out) {
  using acc_t = AccT;
  constexpr int BATCH = 8;                 // staged loads in flight per thread
  float* Ls = sm + a.off_left;
  acc_t* red = reinterpret_cast<acc_t*>(sm + a.off_red);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int k0 = NT ? T.c0 : T.r0, kt = NT ? T.nc : T.nr;
  const int o0 = NT ? T.r0 : T.c0, ot = NT ? T.nr : T.nc;
  const int kt4 = (kt + 3) & ~3;
  const int nq = (ot + 3) / 4;
  const int steps = NT ? kt4 / 4 : kt;
  const bool vec = !RES && (ldRg & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(Rg) & 15) == 0;
  for (int lb = 0; lb < T.nb; lb += a.lane_chunk) {
    const int nl = min(a.lane_chunk, T.nb - lb);
    const int nlt = (nl + TL - 1) / TL;
    const int staged = nlt * TL * kt4;
    for (int e0 = tid; e0 < staged; e0 += BATCH * nth) {
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * nth;
        const int li = e / kt4, kk = e % kt4;
        v[u] = (e < staged && li < nl && kk < kt)
                   ? left_of(a, left_rhs, lsrc, T.b0 + lb + li, k0 + kk)
                   : 0.f;
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * nth;
        if (e < staged)
          Ls[NT ? (e / kt4) * a.ld_left + e % kt4
                : (e % kt4) * a.lane_chunk + e / kt4] = v[u];
      }
    }
    __syncthreads();
    const int base = nlt * nq;
    const int ks_n = max(1, min(nth / base, steps));
    for (int task = tid; task < base * ks_n; task += nth) {
      int ks, lt, q;
      if (NT) {                   // neighbouring threads: neighbouring k
        ks = task % ks_n;
        q = (task / ks_n) % nq;
        lt = task / ks_n / nq;
      } else {                    // neighbouring threads: neighbouring c
        q = task % nq;
        lt = (task / nq) % nlt;
        ks = task / nq / nlt;
      }
      acc_t acc[TL][4];
#pragma unroll
      for (int i = 0; i < TL; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0;
      const int ol = 4 * q;
      if (NT) {
#pragma unroll 2
        for (int s = ks; s < steps; s += ks_n) {
          const int kk = 4 * s;
          float4 rv[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (RES) {
              rv[j] = *reinterpret_cast<const float4*>(Rs + (ol + j) * ldRs + kk);
            } else {
              const bool in = ol + j < ot;
              rv[j] = load4_global(
                  Rg + (size_t)(o0 + (in ? ol + j : 0)) * ldRg + k0 + kk,
                  in ? kt - kk : 0, vec);
            }
          }
#pragma unroll
          for (int i = 0; i < TL; ++i) {
            const float4 lv = *reinterpret_cast<const float4*>(
                Ls + (lt * TL + i) * a.ld_left + kk);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = dot4(lv, rv[j], acc[i][j]);
          }
        }
      } else {
#pragma unroll 4
        for (int kk = ks; kk < kt; kk += ks_n) {
          const float4 rv =
              RES ? *reinterpret_cast<const float4*>(Rs + kk * ldRs + ol)
                 : load4_global(Rg + (size_t)(k0 + kk) * ldRg + o0 + ol,
                                ot - ol, vec);
          const float* L = Ls + kk * a.lane_chunk + lt * TL;
          if (TL == 1) {
            mac4(acc[0], L[0], rv);
          } else {
#pragma unroll
            for (int i = 0; i < TL; i += 4) {
              const float4 lv = *reinterpret_cast<const float4*>(L + i);
              mac4(acc[i], lv.x, rv);
              mac4(acc[i + 1], lv.y, rv);
              mac4(acc[i + 2], lv.z, rv);
              mac4(acc[i + 3], lv.w, rv);
            }
          }
        }
      }
      if (ks_n == 1) {
#pragma unroll
        for (int i = 0; i < TL; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int li = lt * TL + i, o = ol + j;
            if (li < nl && o < ot)
              part[(size_t)(T.b0 + lb + li) * n_out + o0 + o] = acc[i][j];
          }
      } else {
        acc_t* dst = red + (ks * base + lt * nq + q) * TL * 4;
#pragma unroll
        for (int i = 0; i < TL; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dst[i * 4 + j] = acc[i][j];
      }
    }
    if (ks_n > 1) {
      __syncthreads();
      const int outs = base * TL * 4;
      for (int e = tid; e < outs; e += nth) {
        acc_t s = red[e];
        for (int ks = 1; ks < ks_n; ++ks) s = s + red[ks * outs + e];
        const int bt = e / (TL * 4), ii = e % (TL * 4);
        const int li = (bt / nq) * TL + ii / 4, o = (bt % nq) * 4 + ii % 4;
        if (li < nl && o < ot)
          part[(size_t)(T.b0 + lb + li) * n_out + o0 + o] = s;
      }
    }
    __syncthreads();
  }
}

// tile_product with the tile resident when Rs is not null.
template <int TL, typename AccT, bool NT>
__device__ __forceinline__ void product(const Args& a, float* sm,
                                        const Tile& T, bool left_rhs,
                                        const float* lsrc, const float* Rs,
                                        int ldRs, const float* Rg, int ldRg,
                                        AccT* part, int n_out) {
  if (Rs)
    tile_product<TL, AccT, NT, true>(a, sm, T, left_rhs, lsrc, Rs, ldRs, Rg, ldRg,
                               part, n_out);
  else
    tile_product<TL, AccT, NT, false>(a, sm, T, left_rhs, lsrc, Rs, ldRs, Rg, ldRg,
                                part, n_out);
}

// Sum of the `splits` partial sums of output i, in chunk order, rounded
// once to f32.
template <typename T>
__device__ __forceinline__ float sum_parts(const T* part, int splits,
                                           size_t stride, size_t i) {
  constexpr int BATCH = 4;
  T s = __ldcg(part + i);
  for (int p0 = 1; p0 < splits; p0 += BATCH) {
    T v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      v[u] = p0 + u < splits ? __ldcg(part + (p0 + u) * stride + i) : T(0);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (p0 + u < splits) s = s + v[u];
  }
  return static_cast<float>(s);
}

enum Step { RHS, SOLVE, RESID, CORRECT };

// The elementwise step after an n-wide product, over all (lane, column).
template <int STEP, typename T>
__device__ void finish_n(const Args& a, const T* part, int splits, bool last) {
  const size_t total = (size_t)a.B * a.n;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const float s = sum_parts(part, splits, total, i);
    if (STEP == RHS) {
      const int c = i % a.n;
      a.rhs[i] = __fadd_rn(__fsub_rn(__fmul_rn(a.sigma, __ldcg(a.x + i)),
                                     __ldg(a.q + c)),
                           s);
    } else if (STEP == RESID) {
      a.r[i] = __fsub_rn(__ldcg(a.rhs + i), s);
    } else {
      const float v = STEP == SOLVE ? s : __fadd_rn(__ldcg(a.xt + i), s);
      a.xt[i] = v;
      if (last) a.x[i] = relax(a, v, __ldcg(a.x + i));
    }
  }
}

// After the z-tilde product: relaxation of z, prox and dual update. One
// thread per (lane, unit), a unit being one box or L1 row or one SOC
// block.
template <typename T>
__device__ void finish_zt(const Args& a, const T* part) {
  const int rows = a.mb + a.ml, units = rows + a.n_soc;
  const size_t stride = (size_t)a.B * a.m;
  const int splits = a.ta.csplits;
  const size_t total = (size_t)a.B * units;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int b = e / units, un = e % units;
    if (un < rows) {
      const int c = un;
      const size_t i = (size_t)b * a.m + c;
      const float w = relax(a, sum_parts(part, splits, stride, i),
                            __ldcg(a.z + i));
      const float rho = __ldg(a.rho + c);
      const float yv = __ldcg(a.y + i);
      const float v = __fadd_rn(w, __fdiv_rn(yv, rho));
      float p = v;
      if (c >= a.mb) {                            // L1 row: soft-threshold
        float s = __fsub_rn(fabsf(v), __ldg(a.lam_r + c - a.mb));
        s = s < 0.f ? 0.f : s;
        const float sgn = v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
        p = __fmul_rn(sgn, s);
      }
      const float zn = clip(p, __ldg(a.l + i), __ldg(a.u + i));
      a.z[i] = zn;
      a.y[i] = __fadd_rn(yv, __fmul_rn(rho, __fsub_rn(w, zn)));
      continue;
    }
    const int d = a.soc_dim, c0 = rows + (un - rows) * d;
    const size_t i0 = (size_t)b * a.m + c0;
    // v_j = w_j + y_j / rho_j, with w_j recomputed the same way twice.
    float nu2 = 0.f, t0 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float w = relax(a, sum_parts(part, splits, stride, i0 + j),
                            __ldcg(a.z + i0 + j));
      const float v = __fadd_rn(w, __fdiv_rn(__ldcg(a.y + i0 + j),
                                             __ldg(a.rho + c0 + j)));
      if (j == 0) t0 = v;
      else nu2 = __fadd_rn(nu2, __fmul_rn(v, v));
    }
    const float nu = __fsqrt_rn(nu2 < 0.f ? 0.f : nu2);
    const float safe = nu > 0.f ? nu : 1.f;
    const float cmid = __fmul_rn(0.5f, __fadd_rn(t0, nu));
    const bool in_cone = nu <= t0, in_polar = nu <= -t0;
    const float t_out = in_cone ? t0 : (in_polar ? 0.f : cmid);
    const float scal = in_cone ? 1.f : (in_polar ? 0.f : __fdiv_rn(cmid, safe));
    for (int j = 0; j < d; ++j) {
      const size_t i = i0 + j;
      const float rho = __ldg(a.rho + c0 + j);
      const float w = relax(a, sum_parts(part, splits, stride, i),
                            __ldcg(a.z + i));
      const float yv = __ldcg(a.y + i);
      const float zn =
          j == 0 ? t_out : __fmul_rn(__fadd_rn(w, __fdiv_rn(yv, rho)), scal);
      a.z[i] = zn;
      a.y[i] = __fadd_rn(yv, __fmul_rn(rho, __fsub_rn(w, zn)));
    }
  }
}

template <int TL, typename AccT>
__global__ void __launch_bounds__(threads_of(TL), 1) fused_iterate(Args a) {
  using acc_t = AccT;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  acc_t* part_n = static_cast<acc_t*>(a.part_n);
  acc_t* part_m = static_cast<acc_t*>(a.part_m);
  const Tile TA = tile_of(a.ta, blockIdx.x, a.B, a.m, a.n);
  const Tile TN = tile_of(a.tn, blockIdx.x, a.B, a.n, a.n);
  const float* As = a.a_res ? sm + a.off_a : nullptr;
  const float* Minvs = a.minv_res ? sm + a.off_minv : nullptr;
  const float* Ms = a.m_res ? sm + a.off_m : nullptr;
  if (TA.valid && a.a_res)
    load_tile(sm + a.off_a, a.ld_a, a.ta.rchunk, a.A, a.n, TA.r0, TA.nr,
              TA.c0, TA.nc);
  if (TN.valid && a.minv_res)
    load_tile(sm + a.off_minv, a.ld_nn, a.tn.rchunk, a.Minv, a.n, TN.r0,
              TN.nr, TN.c0, TN.nc);
  if (TN.valid && a.m_res)
    load_tile(sm + a.off_m, a.ld_nn, a.tn.rchunk, a.M, a.n, TN.r0, TN.nr,
              TN.c0, TN.nc);
  __syncthreads();
  const size_t Bn = (size_t)a.B * a.n, Bm = (size_t)a.B * a.m;
  unsigned target = 0;
  for (int it = 0; it < a.k; ++it) {
    if (TA.valid)
      product<TL, AccT, false>(a, sm, TA, true, nullptr, As, a.ld_a, a.A, a.n,
                         part_n + TA.i * Bn, a.n);
    grid_sync(a.bar, target);
    finish_n<RHS>(a, part_n, a.ta.rsplits, false);
    grid_sync(a.bar, target);
    if (TN.valid)
      product<TL, AccT, false>(a, sm, TN, false, a.rhs, Minvs, a.ld_nn, a.Minv,
                         a.n, part_n + TN.i * Bn, a.n);
    grid_sync(a.bar, target);
    finish_n<SOLVE>(a, part_n, a.tn.rsplits, a.refine_steps == 0);
    grid_sync(a.bar, target);
    for (int st = 0; st < a.refine_steps; ++st) {
      if (TN.valid)
        product<TL, AccT, false>(a, sm, TN, false, a.xt, Ms, a.ld_nn, a.M, a.n,
                           part_n + TN.i * Bn, a.n);
      grid_sync(a.bar, target);
      finish_n<RESID>(a, part_n, a.tn.rsplits, false);
      grid_sync(a.bar, target);
      if (TN.valid)
        product<TL, AccT, false>(a, sm, TN, false, a.r, Minvs, a.ld_nn, a.Minv,
                           a.n, part_n + TN.i * Bn, a.n);
      grid_sync(a.bar, target);
      finish_n<CORRECT>(a, part_n, a.tn.rsplits,
                        st == a.refine_steps - 1);
      grid_sync(a.bar, target);
    }
    if (TA.valid)
      product<TL, AccT, true>(a, sm, TA, false, a.xt, As, a.ld_a, a.A, a.n,
                        part_m + TA.j * Bm, a.m);
    grid_sync(a.bar, target);
    finish_zt(a, part_m);
    if (it + 1 < a.k) grid_sync(a.bar, target);
  }
}

// The shared memory attribute of one template on one device is set at
// its first launch there and at each launch that asks for more; the
// occupancy check runs at every launch, so a grid too large for the
// card is refused before any launch is made. Neither puts work on a
// stream, so both may run while the stream is being captured.
constexpr int MAX_DEVICES = 64;

template <int TL, typename AccT>
cudaError_t prepare(int grid, int smem) {
  static int smem_set[MAX_DEVICES];
  const void* fn = reinterpret_cast<const void*>(&fused_iterate<TL, AccT>);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  int per_sm = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, threads_of(TL), smem)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

// A cooperative launch through cudaLaunchKernelEx: a stream capture
// records it as a kernel node with the cooperative attribute, so the
// launch may sit inside a CUDA graph (core/graph.py captures the
// batch's residual check with it).
template <int TL, typename AccT>
cudaError_t launch(Args& a, int grid, int smem, cudaStream_t s) {
  cudaError_t err = prepare<TL, AccT>(grid, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads_of(TL));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_iterate<TL, AccT>, a);
  // cudaGetLastError also clears a refused launch's error, which would
  // otherwise be reported by the next launch.
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}


// ---- The large-batch design (B > F64_BATCH, ops/fused.ClusterPlan) ----
//
// Lanes are independent, so a thread-block cluster owns its lanes
// outright: cluster g takes lanes [g L, (g+1) L), and its block of rank
// j computes columns [j w, (j+1) w) of every n-wide product's output
// (w = cols_n) and rows [j w', (j+1) w') of A in the z-tilde product
// (w' = cols_m), over the whole reduction axis. No output is split over
// blocks, so there are no partial sums in L2 and no summing phases, and
// the only barriers are the cluster's own (barrier.cluster, release and
// acquire), not the grid's: 5 an iteration with refine_steps = 1, 6
// where the cone has SOC blocks. Each product's elementwise step runs in
// the epilogue of the product that feeds it; the z-tilde product's
// epilogue writes rho.z - y, the next rhs product's left operand.
//
// A product is a tiled SGEMM on the FFMA units, f32 throughout (no
// TF32). A tile is LT = 72 lanes x CT = 64 columns. Eight consumer
// warps compute it: four groups of 8 x 8 threads, a thread holding 9
// lanes x 8 columns in registers (17 float4 shared-memory loads per 288
// FFMA, over 4 FFMAs per word loaded), each group taking every fourth
// run of 4 reduction steps of a stage; the groups' sums are added in
// group order through shared memory. A ninth, producer warp streams the
// stages of KC = 32 reduction steps into a ring of STAGES with bulk
// tensor copies (TMA: one box of the left operand and one of the
// matrix a stage, zero past the tensors' ends) that complete on an
// mbarrier per stage; the consumers release a stage on a second one. So
// the next stages arrive while the FFMAs of this one run, and no
// consumer starts a copy. The copies need rows of 16 bytes: the scratch
// has them, and the entry point copies A, M^-1 and M into such rows
// (cudaMemcpy2DAsync) where n is not a multiple of 4. The boxes of 32
// steps come swizzled (128B): the four thread rows of a warp and the
// eight columns of a quarter warp read distinct banks. The z-tilde
// product takes A's rows k-contiguous, as the left operand is; a quarter
// warp of the n-wide products reads 32 neighbouring columns.
//
// What bounds it at the flagship shape (B=1024, n=450, m=456, k=25):
// 52.1 GFLOP of FFMA, 0.78 ms at 67 TFLOP/s over the whole card, and
// the L2: each block reads its 72 lanes' left operand and its 64
// columns of the matrix once per product, 17 KB a stage of 32 steps,
// about 3.9 GB a k-block over the card's 120 blocks (15 clusters of 8).
//
// The launch puts every cluster on the card at once (checked against
// cudaOccupancyMaxActiveClusters, and refused otherwise, as the
// cooperative launch is). The sums run in a fixed order for a given
// plan, with no atomics: reruns are bitwise identical.

#define FUSED_CLUSTER_SYNC() \
  asm volatile(                                                        \
      "barrier.cluster.arrive.release.aligned;\n"                      \
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory")

namespace big {

constexpr int CT = 64;                  // output columns of a tile
constexpr int RL = 9;                   // lanes of a thread
constexpr int LT = 8 * RL;              // lanes of a tile
constexpr int KC = 32;                  // reduction steps of a stage
constexpr int STAGE = LT * KC + KC * CT;  // floats of a stage: Ls, then Rs
constexpr int STAGES = 4;
constexpr int GROUPS = 4;               // consumer groups of 64 threads
constexpr int CONSUMERS = 64 * GROUPS;
constexpr int THREADS = CONSUMERS + 32; // and the producer warp
constexpr int MAX_CLUSTER = 8;
constexpr int PLAN_INTS = 9;
// Shared memory, in floats from a 1024-byte aligned base: the ring, the
// groups' sums, the mbarriers (full, then empty, 8 bytes each); 1024
// bytes more for the alignment.
constexpr int RED = STAGES * STAGE;
constexpr int BARS = RED + GROUPS * LT * CT;
constexpr int SMEM_BYTES = 4 * BARS + 16 * STAGES + 1024;
static_assert((4 * LT * KC) % 1024 == 0 && (4 * STAGE) % 1024 == 0,
              "stages and their parts start on 1024 bytes (128-byte swizzle)");

// The tensor maps of the bulk tensor copies: the left operands v, rhs,
// xt and r (boxes of LT lanes x KC steps), A, M^-1 and M as R[k][c]
// (KC rows x CT columns) and A as R[c][k] (CT rows x KC steps). Boxes
// of 128-byte rows are swizzled (128B); all read zero out of bounds.
struct Maps {
  CUtensorMap v, rhs, xt, r, a_nn, a_nt, minv, m;
};

struct Args {
  const float* A;       // (m, ld_n)
  const float* Minv;    // (n, ld_n)
  const float* M;       // (n, ld_n)
  const float* q;       // (n)
  const float* rho;     // (m)
  const float* lam_r;   // (ml)
  const float* l;       // (B, m)
  const float* u;       // (B, m)
  float* x;             // (B, n) in/out
  float* z;             // (B, m) in/out
  float* y;             // (B, m) in/out
  float* rhs;           // (B, ld_n) scratch
  float* xt;            // (B, ld_n) scratch
  float* r;             // (B, ld_n) scratch
  float* v;             // (B, ld_m) scratch: rho.z - y
  float* w;             // (B, ld_m) scratch: relaxed z-tilde on SOC rows
  int B, n, m, mb, ml, n_soc, soc_dim;
  float sigma, alpha, one_minus_alpha;
  int k, refine_steps;
  int cluster, lanes, ld_n, ld_m, cols_n, cols_m;
};

enum Epi { E_RHS, E_SOLVE, E_RESID, E_CORRECT, E_ZT };

__device__ __forceinline__ float relax(const Args& a, float t, float prev) {
  return __fadd_rn(__fmul_rn(a.alpha, t), __fmul_rn(a.one_minus_alpha, prev));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                          int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of `map` at (c0 innermost, c1) into shared dst (1024-byte
// aligned), completing on bar.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int c0, int c1,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// The operands of a tile: lanes [lb, lt1) of the left operand (map L,
// K steps long, zero past them) and the matrix R (map R), for columns
// [ct, ct + CT) of the output.
struct Operands {
  const CUtensorMap* L;
  const CUtensorMap* R;
  int K, lb, lt1, ct;
};

// The producer (one thread): stage q's boxes for reduction steps [k0, k0
// + KC): Ls (LT x KC) of the left operand, and Rs, (KC x CT) of R[k][c]
// for NT = false, (CT x KC) of A's rows for NT = true.
template <bool NT>
__device__ __forceinline__ void produce(const Operands& o, float* Ls,
                                        float* Rs, int k0,
                                        unsigned long long* full) {
  bar_expect(full, 4 * STAGE);
  tma_load(Ls, o.L, k0, o.lb, full);
  if (!NT)
    tma_load(Rs, o.R, o.ct, k0, full);
  else
    tma_load(Rs, o.R, k0, o.ct, full);
}

// A consumer thread's 9 x 8 register tile over its group's runs of a
// stage (steps of 4 below `steps`): lanes ty + 8 i; NT = false: columns
// 4 tx .. 4 tx + 3 and 32 + 4 tx .. 32 + 4 tx + 3; NT = true: columns
// tx + 8 j. Ls and the NT Rs hold 128-byte rows whose 16-byte pieces p
// sit at p ^ (row % 8): the four thread rows of a warp (ty) and the
// eight columns of a quarter warp (tx) read distinct banks.
template <bool NT>
__device__ __forceinline__ void consume(const float* Ls, const float* Rs,
                                        float (&acc)[RL][8], int kg, int ty,
                                        int tx, int steps) {
#pragma unroll
  for (int run = 0; run < KC / 4 / GROUPS; ++run) {
    const int s = kg + GROUPS * run;
    if (s >= steps) break;
    float4 lv[RL];
#pragma unroll
    for (int i = 0; i < RL; ++i)
      lv[i] = *reinterpret_cast<const float4*>(Ls + (ty + 8 * i) * KC +
                                               4 * (s ^ ty));
    if (!NT) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* Rr = Rs + (4 * s + kk) * CT;
        const float4 r0 = *reinterpret_cast<const float4*>(Rr + 4 * tx);
        const float4 r1 = *reinterpret_cast<const float4*>(Rr + 32 + 4 * tx);
#pragma unroll
        for (int i = 0; i < RL; ++i) {
          const float lk = lane_of(lv[i], kk);
          acc[i][0] = fmaf(lk, r0.x, acc[i][0]);
          acc[i][1] = fmaf(lk, r0.y, acc[i][1]);
          acc[i][2] = fmaf(lk, r0.z, acc[i][2]);
          acc[i][3] = fmaf(lk, r0.w, acc[i][3]);
          acc[i][4] = fmaf(lk, r1.x, acc[i][4]);
          acc[i][5] = fmaf(lk, r1.y, acc[i][5]);
          acc[i][6] = fmaf(lk, r1.z, acc[i][6]);
          acc[i][7] = fmaf(lk, r1.w, acc[i][7]);
        }
      }
    } else {
      float4 rv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        rv[j] = *reinterpret_cast<const float4*>(Rs + (tx + 8 * j) * KC +
                                                 4 * (s ^ tx));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(lane_of(lv[i], kk), lane_of(rv[j], kk), acc[i][j]);
    }
  }
}

// The elementwise steps of EU outputs (b[u], c[u]) whose products are
// s[u], where ok[u]: the same operations in the same order as finish_n
// and finish_zt. Every load of the batch is made before the first
// store, so that the batch costs one round trip to L2, not EU.
constexpr int EU = 8;

template <int EPI>
__device__ __forceinline__ void epilogue(const Args& a, const int (&b)[EU],
                                         const int (&c)[EU],
                                         const float (&s)[EU],
                                         const bool (&ok)[EU], bool last) {
  if (EPI == E_RHS) {
    float xv[EU], qv[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      xv[u] = ok[u] ? __ldcg(a.x + (size_t)b[u] * a.n + c[u]) : 0.f;
      qv[u] = ok[u] ? __ldg(a.q + c[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < EU; ++u)
      if (ok[u])
        a.rhs[(size_t)b[u] * a.ld_n + c[u]] = __fadd_rn(
            __fsub_rn(__fmul_rn(a.sigma, xv[u]), qv[u]), s[u]);
  } else if (EPI == E_RESID) {
    float rv[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u)
      rv[u] = ok[u] ? __ldcg(a.rhs + (size_t)b[u] * a.ld_n + c[u]) : 0.f;
#pragma unroll
    for (int u = 0; u < EU; ++u)
      if (ok[u]) a.r[(size_t)b[u] * a.ld_n + c[u]] = __fsub_rn(rv[u], s[u]);
  } else if (EPI == E_SOLVE || EPI == E_CORRECT) {
    float tv[EU], xv[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      tv[u] = ok[u] && EPI == E_CORRECT
                  ? __ldcg(a.xt + (size_t)b[u] * a.ld_n + c[u])
                  : 0.f;
      xv[u] = ok[u] && last ? __ldcg(a.x + (size_t)b[u] * a.n + c[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      if (!ok[u]) continue;
      const float v = EPI == E_SOLVE ? s[u] : __fadd_rn(tv[u], s[u]);
      a.xt[(size_t)b[u] * a.ld_n + c[u]] = v;
      if (last) a.x[(size_t)b[u] * a.n + c[u]] = relax(a, v, xv[u]);
    }
  } else {
    const int rows = a.mb + a.ml;
    float zv[EU], yv[EU], rv[EU], lv[EU], uv[EU], lam[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const size_t i = (size_t)b[u] * a.m + c[u];
      const bool row = ok[u] && c[u] < rows;
      zv[u] = ok[u] ? __ldcg(a.z + i) : 0.f;
      yv[u] = row ? __ldcg(a.y + i) : 0.f;
      rv[u] = row ? __ldg(a.rho + c[u]) : 1.f;
      lv[u] = row ? __ldg(a.l + i) : 0.f;
      uv[u] = row ? __ldg(a.u + i) : 0.f;
      lam[u] = row && c[u] >= a.mb ? __ldg(a.lam_r + c[u] - a.mb) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      if (!ok[u]) continue;
      const size_t i = (size_t)b[u] * a.m + c[u];
      const size_t iv = (size_t)b[u] * a.ld_m + c[u];
      const float w = relax(a, s[u], zv[u]);
      if (c[u] >= rows) {                       // SOC row: after a barrier
        a.w[iv] = w;
        continue;
      }
      const float rho = rv[u];
      const float v = __fadd_rn(w, __fdiv_rn(yv[u], rho));
      float p = v;
      if (c[u] >= a.mb) {                       // L1 row: soft-threshold
        float t = __fsub_rn(fabsf(v), lam[u]);
        t = t < 0.f ? 0.f : t;
        const float sgn = v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
        p = __fmul_rn(sgn, t);
      }
      const float zn = clip(p, lv[u], uv[u]);
      const float yn = __fadd_rn(yv[u], __fmul_rn(rho, __fsub_rn(w, zn)));
      a.z[i] = zn;
      a.y[i] = yn;
      a.v[iv] = __fsub_rn(__fmul_rn(rho, zn), yn);
    }
  }
}

// out[b, c] = sum_k left[b, k] R(k, c) for lanes [lb, lt1) and columns
// [ct, ct1) (at most LT and CT of them), then its epilogue. q counts the
// block's stages so far, the same in every warp.
template <bool NT, int EPI>
__device__ void tile(const Args& a, float* sm, const Operands& o, int ct1,
                     bool last, int& q) {
  const int tid = threadIdx.x;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm + BARS);
  unsigned long long* empty = full + STAGES;
  float* red = sm + RED;
  const int chunks = (o.K + KC - 1) / KC;
  const int kg = tid / 64, ty = (tid % 64) / 8, tx = tid % 8;
  float acc[RL][8];
#pragma unroll
  for (int i = 0; i < RL; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (tid >= CONSUMERS) {
    for (int c = 0; c < chunks; ++c, ++q) {
      const int st = q % STAGES;
      if (tid > CONSUMERS) continue;
      if (q >= STAGES) bar_wait(empty + st, ((q / STAGES) & 1) ^ 1);
      float* Ls = sm + st * STAGE;
      produce<NT>(o, Ls, Ls + LT * KC, c * KC, full + st);
    }
  } else {
    for (int c = 0; c < chunks; ++c, ++q) {
      const int st = q % STAGES;
      bar_wait(full + st, (q / STAGES) & 1);
      const float* Ls = sm + st * STAGE;
      consume<NT>(Ls, Ls + LT * KC, acc, kg, ty, tx,
                  (min(KC, o.K - c * KC) + 3) / 4);
      __syncwarp();
      if (tid % 32 == 0) bar_arrive(empty + st);
    }
  }
  if (tid < CONSUMERS) {
    float* mine = red + kg * LT * CT;
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      float* row = mine + (ty + 8 * i) * CT;
      if (!NT) {
        *reinterpret_cast<float4*>(row + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) row[tx + 8 * j] = acc[i][j];
      }
    }
  }
  __syncthreads();
  for (int e0 = tid; e0 < LT * CT; e0 += EU * THREADS) {
    int b[EU], c[EU];
    float s[EU];
    bool ok[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int e = e0 + u * THREADS;
      b[u] = o.lb + e / CT;
      c[u] = o.ct + e % CT;
      ok[u] = e < LT * CT && b[u] < o.lt1 && c[u] < ct1;
      float v = 0.f;
      if (ok[u]) {
        v = red[e];
#pragma unroll
        for (int g = 1; g < GROUPS; ++g) v = __fadd_rn(v, red[g * LT * CT + e]);
      }
      s[u] = v;
    }
    epilogue<EPI>(a, b, c, s, ok, last);
  }
  // The next tile's consumers write red only after its stages, which
  // the producer fills after this barrier.
  __syncthreads();
}

// A block's share of one product: every tile of its lanes [b0, b1) and
// output columns [c0, c1), the reduction K steps long.
template <bool NT, int EPI>
__device__ __forceinline__ void product(const Args& a, float* sm,
                                        const CUtensorMap* L,
                                        const CUtensorMap* R, int K, int b0,
                                        int b1, int c0, int c1, bool last,
                                        int& q) {
  for (int lb = b0; lb < b1; lb += LT)
    for (int ct = c0; ct < c1; ct += CT) {
      const Operands o{L, R, K, lb, min(b1, lb + LT), ct};
      tile<NT, EPI>(a, sm, o, min(c1, ct + CT), last, q);
    }
}

// After the z-tilde product, the SOC blocks of the cluster's lanes: one
// thread per (lane, block), spread over the cluster's blocks; the same
// operations as finish_zt's, from the relaxed w the epilogue stored.
__device__ void soc_phase(const Args& a, int b0, int b1, int rank) {
  const int rows = a.mb + a.ml, d = a.soc_dim;
  const int total = (b1 - b0) * a.n_soc;
  for (int e = rank * blockDim.x + threadIdx.x; e < total;
       e += a.cluster * blockDim.x) {
    const int b = b0 + e / a.n_soc, c0 = rows + (e % a.n_soc) * d;
    const size_t i0 = (size_t)b * a.m + c0, v0 = (size_t)b * a.ld_m + c0;
    float nu2 = 0.f, t0 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float w = __ldcg(a.w + v0 + j);
      const float v = __fadd_rn(w, __fdiv_rn(__ldcg(a.y + i0 + j),
                                             __ldg(a.rho + c0 + j)));
      if (j == 0) t0 = v;
      else nu2 = __fadd_rn(nu2, __fmul_rn(v, v));
    }
    const float nu = __fsqrt_rn(nu2 < 0.f ? 0.f : nu2);
    const float safe = nu > 0.f ? nu : 1.f;
    const float cmid = __fmul_rn(0.5f, __fadd_rn(t0, nu));
    const bool in_cone = nu <= t0, in_polar = nu <= -t0;
    const float t_out = in_cone ? t0 : (in_polar ? 0.f : cmid);
    const float scal = in_cone ? 1.f : (in_polar ? 0.f : __fdiv_rn(cmid, safe));
    for (int j = 0; j < d; ++j) {
      const size_t i = i0 + j;
      const float rho = __ldg(a.rho + c0 + j);
      const float w = __ldcg(a.w + v0 + j);
      const float yv = __ldcg(a.y + i);
      const float zn =
          j == 0 ? t_out : __fmul_rn(__fadd_rn(w, __fdiv_rn(yv, rho)), scal);
      const float yn = __fadd_rn(yv, __fmul_rn(rho, __fsub_rn(w, zn)));
      a.z[i] = zn;
      a.y[i] = yn;
      a.v[v0 + j] = __fsub_rn(__fmul_rn(rho, zn), yn);
    }
  }
}

// The cluster barrier between phases: the phase's stores are made
// visible to the cluster, and to the bulk copies (the async proxy) that
// read them next.
__device__ __forceinline__ void phase_barrier() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  FUSED_CLUSTER_SYNC();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_iterate_clusters(Args a, const __grid_constant__ Maps maps) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  const int rank = blockIdx.x % a.cluster, g = blockIdx.x / a.cluster;
  const int b0 = g * a.lanes, b1 = min(a.B, b0 + a.lanes);
  const int n0 = min(a.n, rank * a.cols_n), n1 = min(a.n, n0 + a.cols_n);
  const int m0 = min(a.m, rank * a.cols_m), m1 = min(a.m, m0 + a.cols_m);
  const int tid = threadIdx.x;
  // The mbarriers: full completes on the producer's arrival and the
  // stage's bytes, empty on one arrival per consumer warp.
  if (tid == 0) {
    unsigned long long* full = reinterpret_cast<unsigned long long*>(sm + BARS);
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(full + STAGES + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The first left operand, rho.z - y, for this block's rows of A.
  const int wm = m1 - m0;
  for (int e = tid; e < (b1 - b0) * wm; e += THREADS) {
    const int b = b0 + e / wm, c = m0 + e % wm;
    const size_t i = (size_t)b * a.m + c;
    a.v[(size_t)b * a.ld_m + c] =
        __fsub_rn(__fmul_rn(__ldg(a.rho + c), __ldcg(a.z + i)), __ldcg(a.y + i));
  }
  __syncthreads();
  phase_barrier();
  int q = 0;
  for (int it = 0; it < a.k; ++it) {
    product<false, E_RHS>(a, sm, &maps.v, &maps.a_nn, a.m, b0, b1, n0, n1,
                          false, q);
    phase_barrier();
    product<false, E_SOLVE>(a, sm, &maps.rhs, &maps.minv, a.n, b0, b1, n0,
                            n1, a.refine_steps == 0, q);
    phase_barrier();
    for (int st = 0; st < a.refine_steps; ++st) {
      product<false, E_RESID>(a, sm, &maps.xt, &maps.m, a.n, b0, b1, n0, n1,
                              false, q);
      phase_barrier();
      product<false, E_CORRECT>(a, sm, &maps.r, &maps.minv, a.n, b0, b1, n0,
                                n1, st == a.refine_steps - 1, q);
      phase_barrier();
    }
    product<true, E_ZT>(a, sm, &maps.xt, &maps.a_nt, a.n, b0, b1, m0, m1,
                        false, q);
    if (a.n_soc) {
      phase_barrier();
      soc_phase(a, b0, b1, rank);
    }
    phase_barrier();
  }
}

// Clusters of the design the card holds at once, asked once per device
// and cluster size (the first launch is eager, so no capture meets the
// query), after the block's shared memory attribute is set.
cudaError_t max_clusters(int C, int* count) {
  static bool smem_set[MAX_DEVICES];
  static int seen[MAX_DEVICES][MAX_CLUSTER + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (C < 1 || C > MAX_CLUSTER) return cudaErrorInvalidValue;
  const void* fn = reinterpret_cast<const void*>(&fused_iterate_clusters);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  if (seen[dev][C] > 0) {
    *count = seen[dev][C];
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(count, fn, &cfg);
  if (err == cudaSuccess && *count > 0) seen[dev][C] = *count;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found once through cudaGetDriverEntryPoint
// (the library links no libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of the (rows x cols) f32 matrix at p with rows of ld floats, in
// boxes of box_rows x box_cols; swizzled where a box row is 128 bytes.
bool encode(EncodeTiled fn, CUtensorMap* map, const float* p, int rows,
            int cols, int ld, int box_rows, int box_cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            4 * box_cols == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(Args& a, int grid, cudaStream_t s) {
  int count = 0;
  cudaError_t err = max_clusters(a.cluster, &count);
  if (err != cudaSuccess) return err;
  if (count * a.cluster < grid) return cudaErrorCooperativeLaunchTooLarge;
  const EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  Maps maps;
  const bool ok =
      encode(fn, &maps.v, a.v, a.B, a.m, a.ld_m, LT, KC) &&
      encode(fn, &maps.rhs, a.rhs, a.B, a.n, a.ld_n, LT, KC) &&
      encode(fn, &maps.xt, a.xt, a.B, a.n, a.ld_n, LT, KC) &&
      encode(fn, &maps.r, a.r, a.B, a.n, a.ld_n, LT, KC) &&
      encode(fn, &maps.a_nn, a.A, a.m, a.n, a.ld_n, KC, CT) &&
      encode(fn, &maps.a_nt, a.A, a.m, a.n, a.ld_n, CT, KC) &&
      encode(fn, &maps.minv, a.Minv, a.n, a.n, a.ld_n, KC, CT) &&
      encode(fn, &maps.m, a.M, a.n, a.n, a.ld_n, KC, CT);
  if (!ok) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_iterate_clusters, a, maps);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The plan's ints (ops/fused.ClusterPlan.as_ints): grid, cluster,
// threads, shared memory bytes, lanes a cluster, ld_n, ld_m, cols_n,
// cols_m. Tile columns start on 16 bytes.
bool valid_plan(const int* p, int B, int n, int m) {
  const int grid = p[0], C = p[1], lanes = p[4];
  return C >= 1 && C <= MAX_CLUSTER && grid >= C && grid % C == 0 &&
         p[2] == THREADS && p[3] == SMEM_BYTES && lanes >= 1 &&
         (grid / C) * lanes >= B && p[5] >= n && p[5] % 4 == 0 &&
         p[6] >= m && p[6] % 4 == 0 && p[7] % 4 == 0 && p[8] % 4 == 0 &&
         p[7] * C >= n && p[8] * C >= m;
}

}  // namespace big

}  // namespace

extern "C" int admm_fused_iterate_f32(
    const float* A, const float* Minv, const float* M, const float* q,
    const float* rho, const float* lam_r, const float* l, const float* u,
    float* x, float* z, float* y, float* rhs, float* xt, float* r,
    void* part_n, void* part_m, void* bar, int B, int n, int m, int mb,
    int ml, int n_soc, int soc_dim, float sigma, float alpha,
    float one_minus_alpha, int k, int refine_steps, const int* plan,
    int plan_len, void* stream) {
  if (plan_len == big::PLAN_INTS) {
    if (!big::valid_plan(plan, B, n, m))
      return static_cast<int>(cudaErrorInvalidValue);
    // Where ld_n is not n, A, M^-1 and M are copied into part_n with
    // rows of ld_n floats (the bulk copies read rows of 16 bytes);
    // part_m holds the (B, ld_m) scratch v, then w; bar is not used.
    const int ld_n = plan[5];
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* mats[3] = {A, Minv, M};
    if (ld_n != n) {
      float* dst = static_cast<float*>(part_n);
      const int rows[3] = {m, n, n};
      for (int i = 0; i < 3; ++i) {
        const cudaError_t err = cudaMemcpy2DAsync(
            dst, 4 * (size_t)ld_n, mats[i], 4 * (size_t)n, 4 * (size_t)n,
            rows[i], cudaMemcpyDeviceToDevice, s);
        if (err != cudaSuccess) return static_cast<int>(err);
        mats[i] = dst;
        dst += (size_t)rows[i] * ld_n;
      }
    }
    float* vw = static_cast<float*>(part_m);
    big::Args b{mats[0], mats[1], mats[2], q, rho, lam_r, l, u, x, z, y, rhs,
                xt, r, vw, vw + (size_t)B * plan[6], B, n, m, mb, ml, n_soc,
                soc_dim, sigma, alpha, one_minus_alpha, k, refine_steps,
                plan[1], plan[4], ld_n, plan[6], plan[7], plan[8]};
    return static_cast<int>(big::launch(b, plan[0], s));
  }
  if (plan_len != PLAN_INTS || plan[3] != threads_of(plan[1]))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{A, Minv, M, q, rho, lam_r, l, u, x, z, y, rhs, xt, r, part_n, part_m,
         static_cast<unsigned*>(bar), B, n, m, mb, ml, n_soc, soc_dim, sigma,
         alpha, one_minus_alpha, k, refine_steps};
  const int grid = plan[0], tl = plan[1], smem = plan[4];
  a.lane_chunk = plan[2];
  a.a_res = plan[5];
  a.minv_res = plan[6];
  a.m_res = plan[7];
  a.ld_a = plan[8];
  a.ld_nn = plan[9];
  a.ld_left = plan[10];
  a.off_a = plan[11];
  a.off_minv = plan[12];
  a.off_m = plan[13];
  a.off_left = plan[14];
  a.off_red = plan[15];
  a.ta = Tiling{plan[16], plan[17], plan[18], plan[19], plan[20], plan[21]};
  a.tn = Tiling{plan[22], plan[23], plan[24], plan[25], plan[26], plan[27]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tl == 1)
    err = launch<1, double>(a, grid, smem, s);
  else if (tl == 4)
    err = launch<4, double>(a, grid, smem, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Clusters of `cluster` blocks of the large-batch design the current
// card holds at once.
extern "C" int admm_fused_max_clusters(int cluster, int* count) {
  return static_cast<int>(big::max_clusters(cluster, count));
}

extern "C" int admm_fused_device_limits(int device, int* sms, int* smem) {
  cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  return static_cast<int>(err);
}

extern "C" const char* admm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
