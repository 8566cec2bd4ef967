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
// FFMA. What
// held the first design (one launch of a tiled GEMM per product,
// 125-150 dependent launches per k-block, at B=1 one busy tile row of
// 32) far from that was latency, and latency still sets the pace here:
// grid barriers and round trips to L2 (PERF.md section 6).
//
// Design. One persistent cooperative launch runs all k iterations with
// one block per SM. ops/fused.plan cuts A into (lane group x row chunk
// x column chunk) tiles, one per block, and M^-1 and M likewise; a block
// keeps its tiles in shared memory for the whole launch where they fit
// (the Pallas kernel's VMEM residency, spread over the grid) and
// streams them from L2 in every product where they do not. Each product
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
// up to B=256 (each product then rounded to f32 once, whatever the
// partition) and f32 above. An output's partial sums are formed in a
// fixed order inside a block and added across blocks in chunk order by
// one thread (no atomics), so reruns are bitwise identical. The
// elementwise steps use _rn intrinsics so that nvcc does not contract
// them into FMAs, and follow the plain PyTorch version's operation
// order. Comparisons are written so that a NaN propagates (the
// solver's NaN tripwire relies on it).
//
// Interface: plain C, loaded with ctypes (ops/fused.py). The entry
// point launches once on the given stream and returns the first
// non-zero CUDA error. It may be called while that stream is being
// captured into a CUDA graph: the barrier counter is then zeroed by a
// node of the same graph before the kernel's node, so every replay
// starts it from 0.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Threads per block: 512 in the GEMV-shaped regime, where loads in
// flight set the pace; 256 above it, so that a thread holds its 4 x 4
// register tile and its operands in registers (ops/fused.threads).
__host__ __device__ constexpr int threads_of(int tl) {
  return tl == 1 ? 512 : 256;
}
constexpr int PLAN_INTS = 29;

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

// The accumulator AccT of the products (ops/fused.acc_bytes): f64 up to
// B=256, where latency and barriers set the pace and the FMA units idle,
// so that a product of f32 operands is rounded once, whatever the
// partition; f32 at larger B, where the FMA rate starts to matter.

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

}  // namespace

extern "C" int admm_fused_iterate_f32(
    const float* A, const float* Minv, const float* M, const float* q,
    const float* rho, const float* lam_r, const float* l, const float* u,
    float* x, float* z, float* y, float* rhs, float* xt, float* r,
    void* part_n, void* part_m, void* bar, int B, int n, int m, int mb,
    int ml, int n_soc, int soc_dim, float sigma, float alpha,
    float one_minus_alpha, int k, int refine_steps, const int* plan,
    int plan_len, void* stream) {
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
  const int acc = plan[28];
  if (tl == 1 && acc == 8)
    err = launch<1, double>(a, grid, smem, s);
  else if (tl == 1 && acc == 4)
    err = launch<1, float>(a, grid, smem, s);
  else if (tl == 4 && acc == 8)
    err = launch<4, double>(a, grid, smem, s);
  else if (tl == 4 && acc == 4)
    err = launch<4, float>(a, grid, smem, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
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
