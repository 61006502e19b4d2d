// The block backward's LayerNorm backward and its bias column sums, for
// sm_90a: the row-wise and the column-wise reductions that every backward
// entry of block_bwd.cu runs beside its GEMMs, and entries that run each
// alone.
//
// Replaces the LayerNorm backward and the `colsum` bias sums inside
// dense2sparse_vit_tpu/ops/pallas/block.py::fused_transformer_block_backward
// (`_block_bwd_kernel`, block.py:663-672 and :679-709; the same code in
// mlp.py::fused_mlp_residual_backward and attention.py's half-block
// backwards):
//   ln_bwd       for y = LN(x) gamma + beta and the fp32 cotangent dy of y,
//                z = (x - mu) rstd, dz = dy gamma,
//                dx = rstd (dz - mean(dz) - z mean(dz z)) + residual,
//                written as fp32 and/or bf16, with dgamma = sum dy z and
//                dbeta = sum dy over the rows;
//   column_sums  out[n] = sum_m a[m, n] in fp32, for bf16 or fp32 a (the
//                block backward's dbproj over its fp32 cotangent; its bf16
//                bias sums ride on the weight gradients' GEMM, ln_gemm.cuh).
//
// What bounds them on the H100: bytes. The LayerNorm backward reads dy
// (fp32), x and the residual and writes dx once per element, ~12-14 bytes
// per element against a few operations; the column sums read each element
// once. At B=128, N=197, C=384 (25,216 rows) a block backward's two
// LayerNorm backwards move ~0.25 GB, ~76 us at 3.35 TB/s.
//
// Design. ln_bwd: a kernel templated on the row width, V 16-byte chunks a
// lane (dy as float4, x, the residual and dx as 4 x bf16 or float4) over
// LANES lanes a row (32, or 16 for 64, 192 and 320: two rows per warp; a
// width that is no multiple of 128 otherwise has its last chunk only on
// the lanes it covers); each warp keeps two rows in flight (loads of both
// issued before either's two row reductions); the grid is a fixed number of
// CTAs (a multiple of the H100's 132 SMs, fixed so that the bits depend on
// the shapes alone) each walking a contiguous run of rows, keeping dgamma's
// and dbeta's per-lane sums in registers and adding its warps' sums in
// order into one partial row each. That layout keeps V chunks of dgamma's,
// dbeta's and gamma's columns on every lane, which past 768 columns (V = 6)
// outgrows the registers; wider rows (every multiple of 8 up to
// LN_BWD_MAX_C, and the multiples of 8 below 768 that are no multiple of
// 32) take ln_bwd_row_kernel: a row spread over the whole CTA, V <= 2
// chunks a thread, so each column has one owner thread for the CTA's whole
// run and dgamma's and dbeta's partial rows need no combining; 4 / V rows
// in flight (their dy, x and residual loaded before either's reductions),
// each row's two sums reduced by shuffles in a warp and the eight warps'
// values added in order through shared memory (one barrier a group of
// rows, double-buffered). Same grid, same partial rows, same reduce.
// column_sums: a CTA owns 32 16-byte
// column chunks (one warp's lanes) and a run of rows, its 8 warps striding
// over the rows with 16-byte loads, added in order through shared memory
// into one partial row. Both then add their partial rows in one launch of
// ln_gemm.cuh's reduce_partials, the weight gradient's reduce. No atomics:
// the same bits on every run.
#include "ln_gemm.cuh"

namespace d2s {

// launches where each kernel is launched (the block backward's own included),
// read by d2s_norm_launches
// [0] ln_bwd, [1] column_sums, [2] the ln_bwd launches on ln_bwd_row_kernel
static long long norm_launches[3];

// The partial rows' plan is fixed at this many CTAs, a multiple of the
// H100 SXM's SMs, for bits that depend on the shapes alone.
constexpr int NORM_MAX_CTAS = 2 * GEMM_PLAN_SMS;

// ---- LayerNorm backward ---------------------------------------------------

constexpr int LNB_WARPS = 8;
constexpr int LNB_STEP = 16;  // rows a CTA's warps take at once: 8 warps x 2

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// element k of a float4 (k a constant after unrolling)
__device__ __forceinline__ float f4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}
__device__ __forceinline__ float& f4ref(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A row of C columns is LANES lanes' V chunks, chunk j of lane l holding
// columns 4 (l + LANES j) .. + 3: C = 4 V LANES where FULL, else C (the
// runtime `width`, a multiple of 4) ends inside the last chunk, which the
// lanes past it skip. Rows [m0, m1) of this CTA; a warp takes SUBS x PAIR
// rows at a time (the half-warps' rows side by side, a lane's PAIR rows one
// after the other), its loads of dy and x for all of them issued before
// their row reductions. part: dgamma's partial rows (gridDim.x x C), then
// dbeta's.
template <int V, int LANES, bool FULL>
static __global__ void __launch_bounds__(32 * LNB_WARPS)
    ln_bwd_kernel(const float* __restrict__ dy, const bf16* __restrict__ x,
                  const float2* __restrict__ stats, const float* __restrict__ gamma,
                  const bf16* __restrict__ res_b, const float* __restrict__ res_f,
                  float* __restrict__ dx_f, bf16* __restrict__ dx_b, float* __restrict__ part,
                  int M, int width, int n, int rows_per_cta) {
  const int C = FULL ? 4 * V * LANES : width;
  constexpr int SUBS = 32 / LANES;                       // rows side by side in a warp
  constexpr int PAIR = (SUBS == 1 && V <= 3) ? 2 : 1;    // and one after the other
  constexpr int STEP = LNB_WARPS * SUBS * PAIR;          // divides LNB_STEP
  extern __shared__ float4 sh4[];                        // [LNB_WARPS][2C / 4]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / LANES, l = lane % LANES;
  // chunk j on this lane: every chunk but a partial width's last
  auto has = [&](int j) { return FULL || j < V - 1 || 4 * (l + LANES * j) < C; };
  float4 gm[V], pg[V], pb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gm[j] = has(j) ? __ldg(reinterpret_cast<const float4*>(gamma) + l + LANES * j)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    pg[j] = pb[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int m0 = blockIdx.x * rows_per_cta;
  const int m1 = min(M, m0 + rows_per_cta);
  // the loop is uniform across the warp (its shuffles need every lane)
  for (int wbase = m0 + warp * SUBS * PAIR; wbase < m1; wbase += STEP) {
    float4 d[PAIR][V];
    uint2 xr[PAIR][V];
    float2 st[PAIR];
    // rows past m1 and chunks past C read as zeros and add nothing
#pragma unroll
    for (int p = 0; p < PAIR; ++p) {
      const int m = wbase + sub * PAIR + p;
      const bool ok = m < m1;
      const long long r = (long long)m * C;
      st[p] = ok ? stats[m] : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = 4 * (l + LANES * j);
        const bool in = ok && has(j);
        d[p][j] = in ? *reinterpret_cast<const float4*>(dy + r + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        xr[p][j] = in ? *reinterpret_cast<const uint2*>(x + r + c) : make_uint2(0u, 0u);
      }
    }
    float s1[PAIR], s2[PAIR];
#pragma unroll
    for (int p = 0; p < PAIR; ++p) {
      s1[p] = s2[p] = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 xv = bf16x4_to_float4(xr[p][j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float dd = f4(d[p][j], k);
          const float z = (f4(xv, k) - st[p].x) * st[p].y;
          const float dz = dd * f4(gm[j], k);
          s1[p] += dz;
          s2[p] += dz * z;
          f4ref(pg[j], k) += dd * z;
          f4ref(pb[j], k) += dd;
        }
      }
    }
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int p = 0; p < PAIR; ++p) {
        s1[p] += __shfl_xor_sync(0xffffffffu, s1[p], o);
        s2[p] += __shfl_xor_sync(0xffffffffu, s2[p], o);
      }
    }
#pragma unroll
    for (int p = 0; p < PAIR; ++p) {
      const int m = wbase + sub * PAIR + p;
      if (m >= m1) continue;
      const long long r = (long long)m * C;
      const float rs = st[p].y, mdz = s1[p] / n, mdzz = s2[p] / n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (!has(j)) continue;
        const int c = 4 * (l + LANES * j);
        const float4 xv = bf16x4_to_float4(xr[p][j]);
        const float4 res = res_b   ? bf16x4_to_float4(*reinterpret_cast<const uint2*>(res_b + r + c))
                           : res_f ? *reinterpret_cast<const float4*>(res_f + r + c)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
        float4 out;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float dz = f4(d[p][j], k) * f4(gm[j], k);
          const float z = (f4(xv, k) - st[p].x) * rs;
          f4ref(out, k) = rs * (dz - mdz - z * mdzz) + f4(res, k);
        }
        if (dx_f) *reinterpret_cast<float4*>(dx_f + r + c) = out;
        if (dx_b)
          *reinterpret_cast<uint2*>(dx_b + r + c) =
              make_uint2(pack_bf16(out.x, out.y), pack_bf16(out.z, out.w));
      }
    }
  }
  // the two half-warps' sums (16 lanes a row), then the warps' in order
  if (SUBS == 2) {
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        f4ref(pg[j], k) += __shfl_xor_sync(0xffffffffu, f4(pg[j], k), 16);
        f4ref(pb[j], k) += __shfl_xor_sync(0xffffffffu, f4(pb[j], k), 16);
      }
  }
  if (sub == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!has(j)) continue;
      sh4[warp * (C / 2) + l + LANES * j] = pg[j];
      sh4[warp * (C / 2) + C / 4 + l + LANES * j] = pb[j];
    }
  }
  __syncthreads();
  const float* sh = reinterpret_cast<const float*>(sh4);
  for (int e = threadIdx.x; e < 2 * C; e += blockDim.x) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < LNB_WARPS; ++w) t += sh[w * 2 * C + e];
    const int half = e < C ? 0 : 1;
    part[((long long)half * gridDim.x + blockIdx.x) * C + e - half * C] = t;
  }
}

// A row over the whole CTA, for the widths ln_bwd_kernel does not lay out:
// chunk j of thread t holds columns 4 (t + LNW_THREADS j) .. + 3 (a chunk
// past C is skipped), 4 / V rows in flight (for the registers). Rows [m0,
// m1) of this CTA; part as ln_bwd_kernel's.
constexpr int LNW_THREADS = 32 * LNB_WARPS;
constexpr int LNW_ROWS = 4;  // the most rows in flight; divides LNB_STEP
constexpr int LN_BWD_MAX_C = 2 * 4 * LNW_THREADS;  // V = 2: 2,048 columns

template <int V>
static __global__ void __launch_bounds__(LNW_THREADS, 2)
    ln_bwd_row_kernel(const float* __restrict__ dy, const bf16* __restrict__ x,
                      const float2* __restrict__ stats, const float* __restrict__ gamma,
                      const bf16* __restrict__ res_b, const float* __restrict__ res_f,
                      float* __restrict__ dx_f, bf16* __restrict__ dx_b,
                      float* __restrict__ part, int M, int C, int n, int rows_per_cta) {
  constexpr int R = LNW_ROWS / V;
  __shared__ float2 red[2][LNB_WARPS][R];  // (sum dz, sum dz z) per warp and row
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  auto has = [&](int j) { return 4 * (t + LNW_THREADS * j) < C; };
  float4 gm[V], pg[V], pb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gm[j] = has(j) ? __ldg(reinterpret_cast<const float4*>(gamma) + t + LNW_THREADS * j)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    pg[j] = pb[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int m0 = blockIdx.x * rows_per_cta;
  const int m1 = min(M, m0 + rows_per_cta);
  int buf = 0;
  // the loop is uniform across the CTA (its barriers need every thread)
  for (int base = m0; base < m1; base += R, buf ^= 1) {
    float4 d[R][V], rr[R][V];
    uint2 xr[R][V];
    float2 st[R];
    // rows past m1 and chunks past C read as zeros and add nothing
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const int m = base + p;
      const bool ok = m < m1;
      const long long r = (long long)m * C;
      st[p] = ok ? stats[m] : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = 4 * (t + LNW_THREADS * j);
        const bool in = ok && has(j);
        d[p][j] = in ? *reinterpret_cast<const float4*>(dy + r + c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        xr[p][j] = in ? *reinterpret_cast<const uint2*>(x + r + c) : make_uint2(0u, 0u);
        rr[p][j] = !in    ? make_float4(0.f, 0.f, 0.f, 0.f)
                   : res_b ? bf16x4_to_float4(*reinterpret_cast<const uint2*>(res_b + r + c))
                   : res_f ? *reinterpret_cast<const float4*>(res_f + r + c)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int p = 0; p < R; ++p) {
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 xv = bf16x4_to_float4(xr[p][j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float dd = f4(d[p][j], k);
          const float z = (f4(xv, k) - st[p].x) * st[p].y;
          const float dz = dd * f4(gm[j], k);
          s1 += dz;
          s2 += dz * z;
          f4ref(pg[j], k) += dd * z;
          f4ref(pb[j], k) += dd;
        }
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) red[buf][warp][p] = make_float2(s1, s2);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < R; ++p) {
      const int m = base + p;
      if (m >= m1) continue;
      float2 tot = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < LNB_WARPS; ++w) {
        tot.x += red[buf][w][p].x;
        tot.y += red[buf][w][p].y;
      }
      const long long r = (long long)m * C;
      const float rs = st[p].y, mdz = tot.x / n, mdzz = tot.y / n;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (!has(j)) continue;
        const int c = 4 * (t + LNW_THREADS * j);
        const float4 xv = bf16x4_to_float4(xr[p][j]);
        float4 out;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float dz = f4(d[p][j], k) * f4(gm[j], k);
          const float z = (f4(xv, k) - st[p].x) * rs;
          f4ref(out, k) = rs * ((dz - mdz) - z * mdzz) + f4(rr[p][j], k);
        }
        if (dx_f) *reinterpret_cast<float4*>(dx_f + r + c) = out;
        if (dx_b)
          *reinterpret_cast<uint2*>(dx_b + r + c) =
              make_uint2(pack_bf16(out.x, out.y), pack_bf16(out.z, out.w));
      }
    }
  }
  // each column's sums are its owner thread's: the CTA's partial rows as they are
  float4* part4 = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (!has(j)) continue;
    const int c4 = t + LNW_THREADS * j;
    part4[(long long)blockIdx.x * (C / 4) + c4] = pg[j];
    part4[((long long)gridDim.x + blockIdx.x) * (C / 4) + c4] = pb[j];
  }
}

// How the kernels lay out a row of C values: ln_bwd_kernel with 32 lanes a
// row where C is a multiple of 128 (FULL), 16 where C is 64, 192 or 320
// (FULL), else 32 lanes with a partial last chunk, V = the chunks a lane, at
// most 6 (C a multiple of 32 up to 768); every other multiple of 8 up to
// LN_BWD_MAX_C ln_bwd_row_kernel (lanes = LNW_THREADS, V chunks a thread).
// lanes 0: not taken.
struct LnBwdShape {
  int lanes, v;
  bool full;
};

static inline LnBwdShape ln_bwd_shape(int C) {
  if (C <= 0 || C % 8 != 0 || C > LN_BWD_MAX_C) return {0, 0, false};
  if (C % 32 != 0 || C > 768)
    return {LNW_THREADS, (C + 4 * LNW_THREADS - 1) / (4 * LNW_THREADS), false};
  if (C % 128 == 0) return {32, C / 128, true};
  if (C % 64 == 0 && (C / 64) % 2 == 1 && C <= 320) return {16, C / 64, true};
  return {32, (C + 127) / 128, false};
}

bool ln_bwd_takes(int C) { return ln_bwd_shape(C).lanes != 0; }

// (CTAs, rows each) of a LayerNorm backward over M rows
static inline void ln_bwd_plan(int M, int* ctas, int* rows) {
  int r = (M + NORM_MAX_CTAS - 1) / NORM_MAX_CTAS;
  r = (r + LNB_STEP - 1) / LNB_STEP * LNB_STEP;
  *rows = r;
  *ctas = (M + r - 1) / r;
}

long long ln_bwd_workspace_floats(int M, int C) {
  int ctas, rows;
  ln_bwd_plan(M, &ctas, &rows);
  return 2LL * ctas * C;
}

template <int V, int LANES, bool FULL>
static cudaError_t run_ln_bwd(int ctas, int rows, const float* dy, const bf16* x,
                              const float2* stats, const float* gamma, const bf16* res_b,
                              const float* res_f, float* dx_f, bf16* dx_b, float* part, int M,
                              int C, int n, cudaStream_t stream) {
  const int smem = LNB_WARPS * 2 * C * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<V, LANES, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<V, LANES, FULL><<<ctas, 32 * LNB_WARPS, smem, stream>>>(
      dy, x, stats, gamma, res_b, res_f, dx_f, dx_b, part, M, C, n, rows);
  return cudaGetLastError();
}

// dy (M, C) fp32; x (M, C) bf16 with its rows' (mean, 1/std) in stats;
// gamma (C) fp32; the residual res_b (bf16) or res_f (fp32) or neither;
// dx into dx_f (fp32) and/or dx_b (bf16); dgamma, dbeta (C) fp32; work:
// ln_bwd_workspace_floats(M, C) floats. Two launches, the kernel and the
// reduce of its partial rows.
cudaError_t launch_ln_bwd(const float* dy, const bf16* x, const float2* stats,
                          const float* gamma, const bf16* res_b, const float* res_f,
                          float* dx_f, bf16* dx_b, float* dgamma, float* dbeta, float* work,
                          int M, int C, cudaStream_t stream) {
  const LnBwdShape sh = ln_bwd_shape(C);
  if (M <= 0 || sh.lanes == 0 || (!dx_f && !dx_b)) return cudaErrorInvalidValue;
  const int n = ln_width(C);  // the means' width: the rows' zero columns past it left out
  int ctas, rows;
  ln_bwd_plan(M, &ctas, &rows);
  cudaError_t err = cudaErrorInvalidValue;
#define D2S_LN_BWD(V, L, F)                                                                  \
  if (sh.v == V && sh.lanes == L && sh.full == F)                                            \
    err = run_ln_bwd<V, L, F>(ctas, rows, dy, x, stats, gamma, res_b, res_f, dx_f, dx_b, work, \
                              M, C, n, stream);
  D2S_LN_BWD(1, 32, true) D2S_LN_BWD(2, 32, true) D2S_LN_BWD(3, 32, true)
  D2S_LN_BWD(4, 32, true) D2S_LN_BWD(5, 32, true) D2S_LN_BWD(6, 32, true)
  D2S_LN_BWD(1, 16, true) D2S_LN_BWD(3, 16, true) D2S_LN_BWD(5, 16, true)
  D2S_LN_BWD(1, 32, false) D2S_LN_BWD(2, 32, false) D2S_LN_BWD(3, 32, false)
  D2S_LN_BWD(4, 32, false) D2S_LN_BWD(5, 32, false) D2S_LN_BWD(6, 32, false)
#undef D2S_LN_BWD
  if (sh.lanes == LNW_THREADS) {
    const auto kernel = sh.v == 1 ? ln_bwd_row_kernel<1> : ln_bwd_row_kernel<2>;
    kernel<<<ctas, LNW_THREADS, 0, stream>>>(dy, x, stats, gamma, res_b, res_f, dx_f, dx_b,
                                             work, M, C, n, rows);
    err = cudaGetLastError();
    if (err == cudaSuccess) ++norm_launches[2];
  }
  if (err != cudaSuccess) return err;
  ++norm_launches[0];
  return launch_reduce(work, ctas, C, dgamma, stream, work + (long long)ctas * C, ctas, C, dbeta);
}

// ---- column sums ------------------------------------------------------------

constexpr int CS_CHUNKS = 32;  // 16-byte column chunks a CTA: one warp's lanes
constexpr int CS_WARPS = 8;    // each every 8th row
constexpr int CS_MAX_CTAS = 4 * GEMM_PLAN_SMS;

// Partial row blockIdx.y of a's column sums over rows [m0, m1), for the
// CS_CHUNKS chunks from blockIdx.x * CS_CHUNKS on.
template <typename T>
static __global__ void __launch_bounds__(32 * CS_WARPS)
    column_sums_kernel(const T* __restrict__ a, int M, int N, int rows,
                       float* __restrict__ part) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float sh[CS_WARPS][CS_CHUNKS * VEC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * CS_CHUNKS + lane) * VEC;
  const int m0 = blockIdx.y * rows;
  const int m1 = min(M, m0 + rows);
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  if (n0 < N) {
#pragma unroll 4
    for (int m = m0 + warp; m < m1; m += CS_WARPS) {
      const uint4 v = *reinterpret_cast<const uint4*>(a + (long long)m * N + n0);
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if constexpr (sizeof(T) == 2)
          acc[i] += __bfloat162float(e[i]);
        else
          acc[i] += e[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) sh[warp][lane * VEC + i] = acc[i];
  __syncthreads();
  for (int c = threadIdx.x; c < CS_CHUNKS * VEC; c += blockDim.x) {
    const int n = blockIdx.x * CS_CHUNKS * VEC + c;
    if (n >= N) continue;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < CS_WARPS; ++w) t += sh[w][c];
    part[(long long)blockIdx.y * N + n] = t;
  }
}

// (column CTAs, row splits, rows each) of the column sums of an (M, N) matrix
// of elements `elem` bytes wide
static inline void column_sums_plan(int M, int N, int elem, int* cols, int* splits, int* rows) {
  const int chunks = N * elem / 16;
  *cols = (chunks + CS_CHUNKS - 1) / CS_CHUNKS;
  int s = std::max(1, std::min((M + 63) / 64, CS_MAX_CTAS / *cols));
  int r = (M + s - 1) / s;
  r = (r + CS_WARPS - 1) / CS_WARPS * CS_WARPS;
  *rows = r;
  *splits = (M + r - 1) / r;
}

long long column_sums_workspace_floats(int M, int N, int elem) {
  int cols, splits, rows;
  column_sums_plan(M, N, elem, &cols, &splits, &rows);
  return (long long)splits * N;
}

// out (N) fp32 = the column sums of a (M, N), bf16 or fp32, N a multiple of
// 8; work: column_sums_workspace_floats(M, N, sizeof(T)) floats. Two
// launches, the partial rows and their reduce.
template <typename T>
static cudaError_t column_sums(const T* a, float* out, float* work, int M, int N,
                               cudaStream_t stream) {
  if (M <= 0 || N <= 0 || N % 8 != 0) return cudaErrorInvalidValue;
  int cols, splits, rows;
  column_sums_plan(M, N, sizeof(T), &cols, &splits, &rows);
  column_sums_kernel<T><<<dim3(cols, splits), 32 * CS_WARPS, 0, stream>>>(a, M, N, rows, work);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++norm_launches[1];
  return launch_reduce(work, splits, N, out, stream);
}

cudaError_t launch_column_sums(const float* a, float* out, float* work, int M, int N,
                               cudaStream_t stream) {
  return column_sums(a, out, work, M, N, stream);
}

cudaError_t launch_column_sums(const bf16* a, float* out, float* work, int M, int N,
                               cudaStream_t stream) {
  return column_sums(a, out, work, M, N, stream);
}

}  // namespace d2s

using d2s::bf16;

// The launches of ln_bwd (which = 0), column_sums (1), and of ln_bwd's
// those on ln_bwd_row_kernel (2) since the last reset, counted where each is
// launched, inside the backward entries too; set resets the count to
// `value` when it is 0 or more.
extern "C" long long d2s_norm_launches(int which, long long value) {
  if (which < 0 || which > 2) return -1;
  if (value >= 0) d2s::norm_launches[which] = value;
  return d2s::norm_launches[which];
}

// Bytes of workspace d2s_ln_backward needs for M rows of C; 0 for a width
// the kernel does not take.
extern "C" long long d2s_ln_backward_workspace_bytes(int M, int C) {
  if (M <= 0 || !d2s::ln_bwd_takes(C)) return 0;
  return d2s::ln_bwd_workspace_floats(M, C) * (long long)sizeof(float);
}

// The LayerNorm backward alone (launch_ln_bwd): dy (M, C) fp32, x (M, C)
// bf16, stats (M) float2 (mean, 1/std), gamma (C) fp32, res_b (bf16) or
// res_f (fp32) or neither, dx_f (fp32) and/or dx_b (bf16) out, dgamma and
// dbeta (C) fp32 out; work: d2s_ln_backward_workspace_bytes(M, C) bytes;
// ln_c: the LayerNorm's width, C or less where the rows end in zero columns
// (with zero gamma there; d2s::LnWidth). Requires C a multiple of 8 up to
// d2s_ln_backward_max_width(), 16-byte aligned pointers.
extern "C" int d2s_ln_backward(const void* dy, const void* x, const void* stats,
                               const void* gamma, const void* res_b, const void* res_f,
                               void* dx_f, void* dx_b, void* dgamma, void* dbeta, void* work,
                               int M, int C, int ln_c, void* stream) {
  const d2s::LnWidth scope(ln_c);
  return (int)d2s::launch_ln_bwd(
      static_cast<const float*>(dy), static_cast<const bf16*>(x),
      static_cast<const float2*>(stats), static_cast<const float*>(gamma),
      static_cast<const bf16*>(res_b), static_cast<const float*>(res_f),
      static_cast<float*>(dx_f), static_cast<bf16*>(dx_b), static_cast<float*>(dgamma),
      static_cast<float*>(dbeta), static_cast<float*>(work), M, C,
      static_cast<cudaStream_t>(stream));
}

// The widest row the LayerNorm backward takes (LN_BWD_MAX_C).
extern "C" int d2s_ln_backward_max_width() { return d2s::LN_BWD_MAX_C; }

// Bytes of workspace d2s_column_sums needs for an (M, N) matrix (fp32: 1
// for fp32 elements, 0 for bf16).
extern "C" long long d2s_column_sums_workspace_bytes(int M, int N, int fp32) {
  if (M <= 0 || N <= 0) return 0;
  return d2s::column_sums_workspace_floats(M, N, fp32 ? 4 : 2) * (long long)sizeof(float);
}

// out (N) fp32 = sum over the rows of a (M, N), bf16 (fp32 = 0) or fp32;
// work: d2s_column_sums_workspace_bytes(M, N, fp32) bytes. Requires N a
// multiple of 8, 16-byte aligned pointers.
extern "C" int d2s_column_sums(const void* a, int fp32, void* out, void* work, int M, int N,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(work);
  return fp32 ? (int)d2s::launch_column_sums(static_cast<const float*>(a), o, w, M, N, st)
              : (int)d2s::launch_column_sums(static_cast<const bf16*>(a), o, w, M, N, st);
}
