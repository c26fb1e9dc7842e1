// Jet LayerNorm: LayerNorm of a forward-Laplacian jet in one pass, for sm_90a.
//
// Replaces deephall_tpu/ops/jet_layernorm.py:_kernel (the Pallas TPU kernel
// launched by _fused_rows).  A jet row holds P = C + E + 2 planes of D features:
// the primal x, C tangents j, the Laplacian l and E extra second derivatives d.
// Optionally a residual jet is added first, LN(t + r).
//
// What bounds it on the H100: bytes.  Each element is read once (twice with
// the residual) and written once, against a few dozen flops, far below the
// card's ratio of flops to bytes.  Both kernels here therefore do what the TPU
// kernel does with VMEM, one pass with the row kept on chip, and differ in how
// they keep the memory system busy.
//
// jet_layernorm_streamed_kernel, for the shapes of the production network
// (D = 256, (C, E) = (15, 3) or (13, 1), with a residual): a template on the
// shapes, so every loop unrolls and the extra tangents j[lap + q] are named at
// compile time.  One warp owns a row from load to store: a lane holds eight
// features of every plane in registers (two 16-byte pieces per plane, the
// residual added as it arrives) and the row's P sums are folded across the
// lanes by shuffles that halve the values as they halve the lanes, then
// handed round through a few words of shared memory behind a warp barrier.
// Nothing on a row's path waits for another warp, so the warps of an SM drift
// into different phases and some always have loads in flight.  A block's
// warps take consecutive rows: each plane's share of a block is one
// contiguous piece of several KB.  A row count that is no multiple of the
// block's rows leaves the last block's spare warps idle.
//
// jet_layernorm_kernel, for every other shape: one thread block per row and
// one thread per feature, run-time C and E within a register capacity (16,
// 32 or 64 tangents: C <= 64 is N <= 30 with L^2), the row's reductions by
// warp shuffles plus a shared-memory exchange across the block.
//
// Algebra (as the TPU kernel, with xc, jc, lc, dc the centred planes and
// lap = C - E Laplacian tangents; means first, then centred products):
//   var.x = E[xc^2]           var.j = 2 E[xc jc]
//   var.l = 2 E[xc lc] + 2 sum_k E[jlap_k^2]
//   var.d = 2 E[xc dc] + 2 E[jext^2]
//   rs = rsqrt(var.x + eps), f1 = -rs^3 / 2, f2 = 3 rs^5 / 4
// and the output is the bilinear product xc * rs, times scale, plus bias.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 32;

// Sums each of the N per-thread values over the block; every thread gets the totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* smem, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) smem[i * kWarps + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += smem[i * kWarps + w];
    v[i] = s;
  }
  __syncthreads();
}

// MAXC / MAXE: register capacity for the tangents and extras (c <= MAXC, e <= MAXE).
// Register arrays are indexed only by unrolled loop counters so they stay in registers.
template <int MAXC, int MAXE, int THREADS>
__global__ void __launch_bounds__(THREADS) jet_layernorm_kernel(
    const float* __restrict__ x, const float* __restrict__ j,
    const float* __restrict__ l, const float* __restrict__ d,
    const float* __restrict__ rx, const float* __restrict__ rj,
    const float* __restrict__ rl, const float* __restrict__ rd,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ ox, float* __restrict__ oj, float* __restrict__ ol,
    float* __restrict__ od, int64_t rows, int feat, int c, int e, float eps) {
  constexpr int N = MAXC + MAXE + 2;  // quantities reduced per row
  __shared__ float smem[N * kWarps];
  const int nwarps = feat >> 5;
  const int64_t plane = rows * feat;
  const int64_t off = static_cast<int64_t>(blockIdx.x) * feat + threadIdx.x;
  const int lap = c - e;
  const bool res = rx != nullptr;
  const float inv = 1.f / static_cast<float>(feat);

  float vx = x[off] + (res ? rx[off] : 0.f);
  float vl = l[off] + (res ? rl[off] : 0.f);
  float vj[MAXC], vd[MAXE];
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    vj[k] = 0.f;
    if (k < c) vj[k] = j[k * plane + off] + (res ? rj[k * plane + off] : 0.f);
  }
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    vd[q] = 0.f;
    if (q < e) vd[q] = d[q * plane + off] + (res ? rd[q * plane + off] : 0.f);
  }

  // Plane means, then centre every plane.
  float s[N];
  s[0] = vx;
  s[1] = vl;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) s[2 + k] = vj[k];
#pragma unroll
  for (int q = 0; q < MAXE; ++q) s[2 + MAXC + q] = vd[q];
  block_sum<N>(s, smem, nwarps);
  vx -= s[0] * inv;
  vl -= s[1] * inv;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) vj[k] = k < c ? vj[k] - s[2 + k] * inv : 0.f;
#pragma unroll
  for (int q = 0; q < MAXE; ++q) vd[q] = q < e ? vd[q] - s[2 + MAXC + q] * inv : 0.f;

  // The extra tangents j[lap + q], picked with compile-time indices.
  float vje[MAXE];
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < MAXC; ++k) v = (k == lap + q) ? vj[k] : v;
    vje[q] = q < e ? v : 0.f;
  }

  // Variance jet.
  float jsq = 0.f;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) jsq += k < lap ? vj[k] * vj[k] : 0.f;
  s[0] = vx * vx;
  s[1] = 2.f * (vx * vl + jsq);
#pragma unroll
  for (int k = 0; k < MAXC; ++k) s[2 + k] = 2.f * vx * vj[k];
#pragma unroll
  for (int q = 0; q < MAXE; ++q) s[2 + MAXC + q] = 2.f * (vx * vd[q] + vje[q] * vje[q]);
  block_sum<N>(s, smem, nwarps);

  // rsqrt jet.
  const float rs = rsqrtf(s[0] * inv + eps);
  const float f1 = -0.5f * rs * rs * rs;
  const float f2 = 0.75f * rs * rs * rs * rs * rs;
  float rsj[MAXC];
  float varj_sq = 0.f;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    const float vj_k = s[2 + k] * inv;
    rsj[k] = f1 * vj_k;
    varj_sq += k < lap ? vj_k * vj_k : 0.f;
  }
  const float rsl = f1 * s[1] * inv + f2 * varj_sq;

  const int f = threadIdx.x;
  const float sc = scale[f];
  ox[off] = vx * rs * sc + bias[f];
  float cross = 0.f;
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    if (k < c) oj[k * plane + off] = (vj[k] * rs + vx * rsj[k]) * sc;
    cross += k < lap ? vj[k] * rsj[k] : 0.f;
  }
  ol[off] = (vl * rs + vx * rsl + 2.f * cross) * sc;
#pragma unroll
  for (int q = 0; q < MAXE; ++q) {
    if (q < e) {
      float varje = 0.f, rsje = 0.f;
#pragma unroll
      for (int k = 0; k < MAXC; ++k) {
        varje = (k == lap + q) ? s[2 + k] * inv : varje;
        rsje = (k == lap + q) ? rsj[k] : rsje;
      }
      const float rsd = f1 * s[2 + MAXC + q] * inv + f2 * varje * varje;
      od[q * plane + off] = (vd[q] * rs + vx * rsd + 2.f * vje[q] * rsje) * sc;
    }
  }
}

template <int MAXC, int MAXE, int THREADS>
void launch(const float* x, const float* j, const float* l, const float* d,
            const float* rx, const float* rj, const float* rl, const float* rd,
            const float* scale, const float* bias, float* ox, float* oj, float* ol,
            float* od, int64_t rows, int feat, int c, int e, float eps,
            cudaStream_t stream) {
  jet_layernorm_kernel<MAXC, MAXE, THREADS><<<static_cast<unsigned>(rows), feat, 0, stream>>>(
      x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps);
}

}  // namespace

namespace streamed {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// What a probe build leaves out; kWhole is the kernel.
enum Probe { kWhole = 0, kNoStore = 1, kNoMath = 2 };

__device__ __forceinline__ float4 load16(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store16(float* p, float a, float b, float c, float d) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a, b, c, d));
}

// One level of the fold: M values on lanes O apart become (M + 1) / 2 values,
// each summed over both lanes.  The lane with bit O set keeps the odd values.
template <int M, int O>
struct Fold {
  template <int N>
  static __device__ __forceinline__ void run(float (&v)[N], int lane) {
    constexpr int H = (M + 1) / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float a = v[2 * i];
      const float b = (2 * i + 1 < M) ? v[(2 * i + 1 < M) ? 2 * i + 1 : 0] : 0.f;
      const float keep = up ? b : a;
      const float send = up ? a : b;
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    if constexpr (O > 1) Fold<H, O / 2>::run(v, lane);
  }
};

// Sums each of the N per-lane values over the lanes of the row's WPR warps;
// every lane gets the totals.  After the fold a lane holds the warp's total of
// value number bitreverse5(lane), which goes to `scratch` ([WPR][NPAD] floats of
// shared memory owned by this row); a pair of warps meets at named barrier `bar`.
template <int N, int NPAD, int WPR>
__device__ __forceinline__ void row_sum(float (&s)[N], float* scratch, int part, int lane,
                                        int bar) {
  Fold<N, 16>::run(s, lane);
  const int idx = static_cast<int>(__brev(static_cast<unsigned>(lane)) >> 27);
  if (idx < N) scratch[part * NPAD + idx] = s[0];
  if constexpr (WPR == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(32 * WPR) : "memory");
  }
  const float4* all = reinterpret_cast<const float4*>(scratch);
#pragma unroll
  for (int q = 0; q < NPAD / 4; ++q) {
    float4 t = all[q];
    if constexpr (WPR == 2) {
      const float4 u = all[NPAD / 4 + q];
      t.x += u.x, t.y += u.y, t.z += u.z, t.w += u.w;
    }
    if (4 * q + 0 < N) s[(4 * q + 0 < N) ? 4 * q + 0 : 0] = t.x;
    if (4 * q + 1 < N) s[(4 * q + 1 < N) ? 4 * q + 1 : 0] = t.y;
    if (4 * q + 2 < N) s[(4 * q + 2 < N) ? 4 * q + 2 : 0] = t.z;
    if (4 * q + 3 < N) s[(4 * q + 3 < N) ? 4 * q + 3 : 0] = t.w;
  }
}

// A lane's V features of one plane, jet plus residual; STEP floats between its pieces.
template <int V, int STEP>
__device__ __forceinline__ void load_sum(float (&v)[V], const float* t, const float* r) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 a = load16(t + i * STEP);
    const float4 b = load16(r + i * STEP);
    v[4 * i + 0] = a.x + b.x;
    v[4 * i + 1] = a.y + b.y;
    v[4 * i + 2] = a.z + b.z;
    v[4 * i + 3] = a.w + b.w;
  }
}

template <int V>
__device__ __forceinline__ float lane_sum(const float (&v)[V]) {
  float s = v[0];
#pragma unroll
  for (int i = 1; i < V; ++i) s += v[i];
  return s;
}

// WPR warps own a row (1 or 2); MINB is the number of resident blocks per SM
// that the register budget is cut for.
template <int D, int C, int E, int WPR, int MINB, int PROBE>
__global__ void __launch_bounds__(kThreads, MINB) jet_layernorm_streamed_kernel(
    const float* __restrict__ x, const float* __restrict__ j,
    const float* __restrict__ l, const float* __restrict__ d,
    const float* __restrict__ rx, const float* __restrict__ rj,
    const float* __restrict__ rl, const float* __restrict__ rd,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ ox, float* __restrict__ oj, float* __restrict__ ol,
    float* __restrict__ od, int64_t rows, float eps) {
  constexpr int P = C + E + 2;           // planes, and quantities reduced per row
  constexpr int LAP = C - E;
  constexpr int STEP = 128 * WPR;        // floats between a lane's 16-byte pieces
  constexpr int V = D / (32 * WPR);      // features a lane holds of each plane
  constexpr int RPB = kThreads / (32 * WPR);  // rows per block
  constexpr int NPAD = (P + 3) / 4 * 4;
  static_assert(D % STEP == 0 && P <= 32, "a lane holds whole 16-byte pieces; the fold takes 32 values");
  __shared__ float4 scratch[2][RPB][WPR * NPAD / 4];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = warp / WPR;           // which of the block's rows
  const int part = warp % WPR;           // which part of that row
  const int64_t plane = rows * D;
  const int64_t units = (rows + RPB - 1) / RPB;
  const int col = (part * 32 + lane) * 4;
  constexpr float inv = 1.f / static_cast<float>(D);

  for (int64_t unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int64_t row = unit * RPB + slot;
    if (row >= rows) break;  // the same for all warps of a row
    const int64_t off = row * D + col;

    float vx[V], vl[V], vj[C][V], vd[E][V];
    load_sum<V, STEP>(vx, x + off, rx + off);
#pragma unroll
    for (int k = 0; k < C; ++k) load_sum<V, STEP>(vj[k], j + k * plane + off, rj + k * plane + off);
    load_sum<V, STEP>(vl, l + off, rl + off);
#pragma unroll
    for (int q = 0; q < E; ++q) load_sum<V, STEP>(vd[q], d + q * plane + off, rd + q * plane + off);

    if constexpr (PROBE != kNoMath) {
      // Plane means, then centre every plane.
      float s[P];
      s[0] = lane_sum(vx);
      s[1] = lane_sum(vl);
#pragma unroll
      for (int k = 0; k < C; ++k) s[2 + k] = lane_sum(vj[k]);
#pragma unroll
      for (int q = 0; q < E; ++q) s[2 + C + q] = lane_sum(vd[q]);
      row_sum<P, NPAD, WPR>(s, reinterpret_cast<float*>(scratch[0][slot]), part, lane, 1 + slot);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        vx[i] -= s[0] * inv;
        vl[i] -= s[1] * inv;
#pragma unroll
        for (int k = 0; k < C; ++k) vj[k][i] -= s[2 + k] * inv;
#pragma unroll
        for (int q = 0; q < E; ++q) vd[q][i] -= s[2 + C + q] * inv;
      }

      // Variance jet, from the centred planes.
#pragma unroll
      for (int n = 0; n < P; ++n) s[n] = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[0] += vx[i] * vx[i];
        float jsq = vx[i] * vl[i];
#pragma unroll
        for (int k = 0; k < LAP; ++k) jsq += vj[k][i] * vj[k][i];
        s[1] += 2.f * jsq;
#pragma unroll
        for (int k = 0; k < C; ++k) s[2 + k] += 2.f * vx[i] * vj[k][i];
#pragma unroll
        for (int q = 0; q < E; ++q)
          s[2 + C + q] += 2.f * (vx[i] * vd[q][i] + vj[LAP + q][i] * vj[LAP + q][i]);
      }
      row_sum<P, NPAD, WPR>(s, reinterpret_cast<float*>(scratch[1][slot]), part, lane, 1 + slot);

      // rsqrt jet: s becomes rs (0), rs.l (1), rs.j (2 + k), rs.d (2 + C + q).
      const float rs = rsqrtf(s[0] * inv + eps);
      const float f1 = -0.5f * rs * rs * rs;
      const float f2 = 0.75f * rs * rs * rs * rs * rs;
      float varj_sq = 0.f;
#pragma unroll
      for (int k = 0; k < LAP; ++k) varj_sq += (s[2 + k] * inv) * (s[2 + k] * inv);
      s[1] = f1 * s[1] * inv + f2 * varj_sq;
#pragma unroll
      for (int q = 0; q < E; ++q) {
        const float varje = s[2 + LAP + q] * inv;
        s[2 + C + q] = f1 * s[2 + C + q] * inv + f2 * varje * varje;
      }
#pragma unroll
      for (int k = 0; k < C; ++k) s[2 + k] *= f1 * inv;

      // The bilinear product xc * rs, in place: x last, the others read it.
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float sc = __ldg(scale + col + (i / 4) * STEP + (i % 4));
        float cross = 0.f;
#pragma unroll
        for (int k = 0; k < LAP; ++k) cross += vj[k][i] * s[2 + k];
        vl[i] = (vl[i] * rs + vx[i] * s[1] + 2.f * cross) * sc;
#pragma unroll
        for (int q = 0; q < E; ++q)
          vd[q][i] = (vd[q][i] * rs + vx[i] * s[2 + C + q] + 2.f * vj[LAP + q][i] * s[2 + LAP + q]) * sc;
#pragma unroll
        for (int k = 0; k < C; ++k) vj[k][i] = (vj[k][i] * rs + vx[i] * s[2 + k]) * sc;
        vx[i] = vx[i] * rs * sc + __ldg(bias + col + (i / 4) * STEP + (i % 4));
      }
    }

    // A probe without stores still computes: eps is never negative.
    if (PROBE != kNoStore || eps < 0.f) {
#pragma unroll
      for (int i = 0; i < V / 4; ++i) {
        const int64_t o = off + i * STEP;
        store16(ox + o, vx[4 * i], vx[4 * i + 1], vx[4 * i + 2], vx[4 * i + 3]);
#pragma unroll
        for (int k = 0; k < C; ++k)
          store16(oj + k * plane + o, vj[k][4 * i], vj[k][4 * i + 1], vj[k][4 * i + 2], vj[k][4 * i + 3]);
        store16(ol + o, vl[4 * i], vl[4 * i + 1], vl[4 * i + 2], vl[4 * i + 3]);
#pragma unroll
        for (int q = 0; q < E; ++q)
          store16(od + q * plane + o, vd[q][4 * i], vd[q][4 * i + 1], vd[q][4 * i + 2], vd[q][4 * i + 3]);
      }
    }
  }
}

struct Args {
  const float *x, *j, *l, *d, *rx, *rj, *rl, *rd, *scale, *bias;
  float *ox, *oj, *ol, *od;
  int64_t rows;
  float eps;
};

template <int D, int C, int E, int WPR, int MINB, int PROBE>
int launch(const Args& a, int blocks, cudaStream_t stream) {
  constexpr int RPB = kThreads / (32 * WPR);
  const int64_t units = (a.rows + RPB - 1) / RPB;
  const int64_t grid = blocks > 0 && blocks < units ? blocks : units;
  jet_layernorm_streamed_kernel<D, C, E, WPR, MINB, PROBE><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      a.x, a.j, a.l, a.d, a.rx, a.rj, a.rl, a.rd, a.scale, a.bias, a.ox, a.oj, a.ol, a.od,
      a.rows, a.eps);
  return static_cast<int>(cudaGetLastError());
}

// shape: 0 for one warp a row (two resident blocks per SM, every register a
// thread can have), 1 for a pair of warps a row (three resident blocks).
template <int D, int C, int E>
int launch_variant(const Args& a, int probe, int shape, int blocks, cudaStream_t stream) {
  if (shape == 0 && probe == kWhole) return launch<D, C, E, 1, 2, kWhole>(a, blocks, stream);
  if (shape == 0 && probe == kNoStore) return launch<D, C, E, 1, 2, kNoStore>(a, blocks, stream);
  if (shape == 0 && probe == kNoMath) return launch<D, C, E, 1, 2, kNoMath>(a, blocks, stream);
  if (shape == 1 && probe == kWhole) return launch<D, C, E, 2, 3, kWhole>(a, blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int run(const Args& a, int feat, int c, int e, int probe, int shape, int blocks, void* stream) {
  const void* ptrs[] = {a.x, a.j, a.l, a.d, a.rx, a.rj, a.rl, a.rd, a.scale, a.bias,
                        a.ox, a.oj, a.ol, a.od};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.rows <= 0 || a.rows > 0x7fffffff || feat != 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 15 && e == 3) return launch_variant<256, 15, 3>(a, probe, shape, blocks, s);
  if (c == 13 && e == 1) return launch_variant<256, 13, 1>(a, probe, shape, blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace streamed

// Plain C entry point.  Planes are contiguous [rows, feat] float32 blocks:
// j and d (and rj, rd) hold c and e planes back to back.  rx..rd are null for
// no residual.  Returns the CUDA error of the launch (0 on success).
extern "C" int jet_layernorm_f32(const float* x, const float* j, const float* l,
                                 const float* d, const float* rx, const float* rj,
                                 const float* rl, const float* rd, const float* scale,
                                 const float* bias, float* ox, float* oj, float* ol,
                                 float* od, int64_t rows, int feat, int c, int e,
                                 float eps, void* stream) {
  if (feat <= 0 || feat % 32 != 0 || feat > 1024 || e < 1 || e > 4 || c < e ||
      c > 64 || rows <= 0 || rows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Register capacity 16, 32 or 64 tangents: the smallest that holds c.
  if (feat <= 256) {
    if (c <= 16) {
      launch<16, 4, 256>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    } else if (c <= 32) {
      launch<32, 4, 256>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    } else {
      launch<64, 4, 256>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    }
  } else {
    if (c <= 16) {
      launch<16, 4, 1024>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    } else if (c <= 32) {
      launch<32, 4, 1024>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    } else {
      launch<64, 4, 1024>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The streamed kernel: feat = 256, (c, e) = (15, 3) or (13, 1), a residual, and
// every pointer a multiple of 16 bytes; any row count.  Same arguments and
// return value as above; cudaErrorInvalidValue for what it does not take.
extern "C" int jet_layernorm_streamed_f32(const float* x, const float* j, const float* l,
                                          const float* d, const float* rx, const float* rj,
                                          const float* rl, const float* rd, const float* scale,
                                          const float* bias, float* ox, float* oj, float* ol,
                                          float* od, int64_t rows, int feat, int c, int e,
                                          float eps, void* stream) {
  const streamed::Args a{x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, eps};
  return streamed::run(a, feat, c, e, streamed::kWhole, 0, 0, stream);
}

// The streamed kernel cut down, for timing only (scripts/torch_layernorm_diagnostics.py).
// probe: 0 the kernel, 1 without its stores, 2 without its arithmetic (load,
// add, store).  shape: 0 one warp a row, 1 a pair of warps a row (whole only).
// blocks: the grid, or 0 for one block per group of rows.
extern "C" int jet_layernorm_streamed_probe_f32(const float* x, const float* j, const float* l,
                                                const float* d, const float* rx, const float* rj,
                                                const float* rl, const float* rd,
                                                const float* scale, const float* bias, float* ox,
                                                float* oj, float* ol, float* od, int64_t rows,
                                                int feat, int c, int e, float eps, int probe,
                                                int shape, int blocks, void* stream) {
  const streamed::Args a{x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, eps};
  return streamed::run(a, feat, c, e, probe, shape, blocks, stream);
}
