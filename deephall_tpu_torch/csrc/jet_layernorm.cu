// Jet LayerNorm: LayerNorm of a forward-Laplacian jet in one pass, for sm_90a.
//
// Replaces deephall_tpu/ops/jet_layernorm.py:_kernel (the Pallas TPU kernel
// launched by _fused_rows).  A jet row holds P = C + E + 2 planes of D features:
// the primal x, C tangents j, the Laplacian l and E extra second derivatives d.
// Optionally a residual jet is added first, LN(t + r).
//
// What bounds it on the H100: bytes.  Each element is read once (twice with
// the residual) and written once, against a few dozen flops, far below the
// card's ratio of flops to bytes.  The kernels here therefore do what the TPU
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
// jet_layernorm_staged_kernel, for every other jet with D <= 512 whose row
// fits one stage of shared memory (every D = 256 jet up to C = 64, with or
// without a residual), at run-time C and E: one persistent block an SM walks over the
// rows with a ring of S stages in dynamic shared memory, one row a stage (S is
// one or even: staged::ring says why).
// Each of the row's planes, and of the residual's, is one contiguous piece of
// D floats, and arrives by a 1-D bulk asynchronous copy (the Tensor Memory
// Accelerator) that completes on the stage's "full" mbarrier.  A producer
// warp issues the copies and refills a stage as soon as its "empty" mbarrier
// says the row in it is done, so the next rows' bytes are in flight while a
// row is reduced.  Two groups of 8 warps take alternate rows, so that one
// group's reductions, shuffle chains and barriers overlap the other's.  In a
// group the reductions go by plane, not by thread: warp w takes planes w,
// w + 8, ..., each lane eight features of a plane, and per plane leaves its
// mean, its centred product with the centred primal and its centred square
// (which fold the extra variance terms into the same pass) as one float4;
// every warp centres the primal itself, so the pass needs no barrier inside.
// Then one thread a feature forms the rsqrt jet from those P float4s and
// writes every output plane of its feature with coalesced streaming stores;
// the Laplacian's cross sum over the tangents is the thread's own loop.
// Registers hold a few scalars a thread and the primal's eight features, not
// a plane array.

// jet_layernorm_kernel, for what neither takes (D > 512, a row past one stage,
// or a pointer off the 16-byte grid that a bulk copy needs): one
// thread block per row and one thread per feature, run-time C and E within a
// register capacity (16, 32 or 64 tangents), the row's reductions by warp
// shuffles plus a shared-memory exchange across the block.
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

namespace staged {

constexpr int kGroupThreads = 256;               // a group of warps takes one row at a time
constexpr int kWarps = kGroupThreads / 32;        // warps of a group
constexpr int kGroups = 2;                        // groups of a block, on alternate rows
constexpr int kThreads = kGroups * kGroupThreads + 32;  // and one producer warp
constexpr int kMaxStages = 8;
constexpr int kMaxFeat = 512;  // D; a lane holds D / 32 floats of the primal
constexpr int kMaxPieces = 5;  // pieces a producer lane copies per row: 2 (C + E + 2) <= 160
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

// What a probe build leaves out; kWhole is the kernel.
enum Probe { kWhole = 0, kNoStore = 1, kNoMath = 2 };

struct Args {
  const float *x, *j, *l, *d, *rx, *rj, *rl, *rd, *scale, *bias;
  float *ox, *oj, *ol, *od;
  int64_t rows;
  int feat, c, e;
  float eps;
};

// Floats of one stage: the row's planes, then the residual's.
__host__ __device__ inline size_t stage_floats(int planes, int feat, bool res) {
  return static_cast<size_t>(res ? 2 : 1) * planes * feat;
}

// Dynamic shared memory: the stages; each group's per-plane sums of a row (a
// float4 a plane), two rows' worth; two mbarriers a stage (full, empty).
inline size_t smem_bytes(int planes, int feat, bool res, int stages) {
  return static_cast<size_t>(stages) * (stage_floats(planes, feat, res) * 4 + 16) +
         static_cast<size_t>(kGroups) * 2 * planes * 16;
}

// Whether the kernel takes a jet of this shape at all.
inline bool takes(int feat, int c, int e) {
  return feat > 0 && feat % 32 == 0 && feat <= kMaxFeat && e >= 1 && c >= e &&
         2 * (c + e + 2) <= 32 * kMaxPieces;
}

// The most stages that fit `limit` bytes of dynamic shared memory, at most
// kMaxStages (0: not one).
inline int most_stages(int planes, int feat, bool res, int limit) {
  const int64_t stage = static_cast<int64_t>(stage_floats(planes, feat, res)) * 4 + 16;
  const int64_t fit = (static_cast<int64_t>(limit) - kGroups * 2 * planes * 16) / stage;
  return static_cast<int>(fit < 0 ? 0 : fit < kMaxStages ? fit : kMaxStages);
}

// The ring the kernel runs with at most `stages` stages: an even number past
// one.  Rows i and i + S share a stage; with S even they also share a group,
// which has itself waited out the stage's round r before it waits on round
// r + 1 by its parity.  With S odd past one, row i + S would go to the other
// group, which could wait while round r is still open, and round r + 1's
// parity is that of round r - 1, long complete: it would read the stage
// before its bytes arrive.
inline int ring(int stages) { return stages > 1 ? stages & ~1 : stages; }

// The device's opt-in limit of dynamic shared memory a block (0 on an error).
inline int smem_limit(int device) {
  int limit = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
    return 0;
  }
  return limit;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// The one arrival of a phase, with the bytes its copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` from global `src` to shared `dst`, completing on `bar`; both 16-byte aligned.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Plane p of a jet in the order x, j[0..c), l, d[0..e); `plane` floats apart in j and d.
template <typename T>
__device__ __forceinline__ T* plane_of(T* x, T* j, T* l, T* d, int p, int c, int64_t plane) {
  if (p == 0) return x;
  if (p <= c) return j + (p - 1) * plane;
  if (p == c + 1) return l;
  return d + (p - c - 2) * plane;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// A lane's features of one staged plane, jet plus residual (r null for none):
// 16-byte pieces at lane * 4 + 128 m, zeros past feat.
template <int V4>
__device__ __forceinline__ void load_plane(float (&v)[4 * V4], const float* t, const float* r,
                                           int feat, int lane) {
#pragma unroll
  for (int m = 0; m < V4; ++m) {
    const int col = lane * 4 + 128 * m;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col < feat) {
      a = *reinterpret_cast<const float4*>(t + col);
      if (r != nullptr) {
        const float4 b = *reinterpret_cast<const float4*>(r + col);
        a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
      }
    }
    v[4 * m + 0] = a.x, v[4 * m + 1] = a.y, v[4 * m + 2] = a.z, v[4 * m + 3] = a.w;
  }
}

// The named barrier of one group's 256 threads.
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "n"(kGroupThreads) : "memory");
}

// V4: 16-byte pieces a lane holds of a plane (D <= 128 V4).  One block an SM:
// a producer warp that keeps the ring full, and kGroups groups of warps that
// take alternate rows, so that one group's reductions and barriers overlap
// the other's.
template <int V4, int PROBE>
__global__ void __launch_bounds__(kThreads, 1) jet_layernorm_staged_kernel(const Args a, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int c = a.c, e = a.e, feat = a.feat;
  const int planes = c + e + 2;
  const int lap = c - e;
  const bool res = a.rx != nullptr;
  const int64_t plane = a.rows * feat;
  const size_t sfloats = stage_floats(planes, feat, res);
  float4* stats = reinterpret_cast<float4*>(smem + stages * sfloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + kGroups * 2 * planes);
  uint64_t* empty = full + stages;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv = 1.f / static_cast<float>(feat);
  const float eps = a.eps;
  // This block's rows: first, first + step, ...
  const int64_t first = blockIdx.x, step = gridDim.x;
  const int64_t count = (a.rows - first + step - 1) / step;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kGroups * kWarps) {
    // The producer: row i's pieces go to stage i % stages once the group that
    // had the stage before has left it.  Each lane copies up to kMaxPieces.
    const uint32_t piece = static_cast<uint32_t>(feat) * 4;
    const int pieces = (res ? 2 : 1) * planes;
    const float* src[kMaxPieces];
#pragma unroll
    for (int m = 0; m < kMaxPieces; ++m) {
      const int k = lane + 32 * m;
      src[m] = k >= pieces  ? nullptr
               : k < planes ? plane_of(a.x, a.j, a.l, a.d, k, c, plane)
                            : plane_of(a.rx, a.rj, a.rl, a.rd, k - planes, c, plane);
    }
    for (int64_t i = 0; i < count; ++i) {
      const int s = static_cast<int>(i % stages);
      if (i >= stages) {
        bar_wait(empty + s, static_cast<uint32_t>((i / stages - 1) & 1));
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      }
      if (lane == 0) bar_expect(full + s, pieces * piece);
      __syncwarp();
      const int64_t off = (first + i * step) * feat;
      float* dst = smem + s * sfloats;
#pragma unroll
      for (int m = 0; m < kMaxPieces; ++m) {
        if (src[m] != nullptr) bulk_load(dst + (lane + 32 * m) * feat, src[m] + off, piece, full + s);
      }
    }
    return;
  }

  // A group waits on a stage's full barrier by the parity of the row's round
  // in the ring, which is right only if the row a round before in that stage
  // has arrived: the group that waits took that row itself, since the ring
  // has one stage and one group takes every row, or an even number of stages
  // (ring) and rows i and i + stages go to the same group.
  const int groups = stages < kGroups ? stages : kGroups;
  const int group = warp / kWarps;
  const int gw = warp % kWarps;                     // warp within the group
  const int gt = threadIdx.x % kGroupThreads;       // thread within the group
  for (int64_t i = group, turn = 0; i < count && group < groups; i += groups, ++turn) {
    const int s = static_cast<int>(i % stages);
    const int64_t row = first + i * step;
    const float* tin = smem + s * sfloats;
    const float* rin = res ? tin + planes * feat : nullptr;
    // The group's sums of this row; the other half holds its previous row's.
    float4* stat = stats + (2 * group + (turn & 1)) * planes;
    bar_wait(full + s, static_cast<uint32_t>((i / stages) & 1));

    if constexpr (PROBE != kNoMath) {
      // By plane: each warp centres the primal, then per plane of its own
      // leaves (mean, sum xc * pc, sum pc^2) of the centred plane pc.
      float xc[4 * V4];
      load_plane<V4>(xc, tin, rin, feat, lane);
      float sx = 0.f;
#pragma unroll
      for (int n = 0; n < 4 * V4; ++n) sx += xc[n];
      const float mx = warp_sum(sx) * inv;
#pragma unroll
      for (int n = 0; n < 4 * V4; ++n) xc[n] = lane * 4 + 128 * (n / 4) < feat ? xc[n] - mx : 0.f;
#pragma unroll 2
      for (int p = gw; p < planes; p += kWarps) {
        float v[4 * V4];
        load_plane<V4>(v, tin + p * feat, rin ? rin + p * feat : nullptr, feat, lane);
        float sv = 0.f;
#pragma unroll
        for (int n = 0; n < 4 * V4; ++n) sv += v[n];
        const float mean = warp_sum(sv) * inv;
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int n = 0; n < 4 * V4; ++n) {
          const float pc = lane * 4 + 128 * (n / 4) < feat ? v[n] - mean : 0.f;
          sa += xc[n] * pc;
          sb += pc * pc;
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        if (lane == 0) stat[p] = make_float4(mean, sa, sb, 0.f);
      }
    }
    group_sync(group);

    // By feature: the rsqrt jet from the P sums, then every output plane.
    const auto in = [&](int p, int f) {
      float v = tin[p * feat + f];
      if (res) v += rin[p * feat + f];
      return v;
    };
    // A probe without stores still computes: eps is never negative.
    const auto put = [&](float* out, int64_t o, float v) {
      if (PROBE != kNoStore || eps < 0.f) __stcs(out + o, v);
    };
    if constexpr (PROBE == kNoMath) {
      for (int f = gt; f < feat; f += kGroupThreads) {
        const int64_t o = row * feat + f;
        for (int p = 0; p < planes; ++p) put(plane_of(a.ox, a.oj, a.ol, a.od, p, c, plane), o, in(p, f));
      }
    } else {
      const float4 st0 = stat[0];
      const float rs = rsqrtf(st0.y * inv + eps);
      const float f1 = -0.5f * rs * rs * rs;
      const float f2 = 0.75f * rs * rs * rs * rs * rs;
      for (int f = gt; f < feat; f += kGroupThreads) {
        const int64_t o = row * feat + f;
        const float sc = __ldg(a.scale + f);
        const float xc = in(0, f) - st0.x;
        put(a.ox, o, xc * rs * sc + __ldg(a.bias + f));
        // The Laplacian's tangents: their cross sum and the variance terms they add.
        float cross = 0.f, jsq = 0.f, varj_sq = 0.f;
#pragma unroll 4
        for (int k = 0; k < lap; ++k) {
          const float4 sj = stat[1 + k];
          const float jc = in(1 + k, f) - sj.x;
          const float varj = 2.f * sj.y * inv;
          const float rsj = f1 * varj;
          put(a.oj + k * plane, o, (jc * rs + xc * rsj) * sc);
          cross += jc * rsj;
          jsq += sj.z;
          varj_sq += varj * varj;
        }
        // The extra tangents j[lap + q] and their second derivatives d[q].
        for (int q = 0; q < e; ++q) {
          const float4 sj = stat[1 + lap + q];
          const float4 sd = stat[c + 2 + q];
          const float jc = in(1 + lap + q, f) - sj.x;
          const float dc = in(c + 2 + q, f) - sd.x;
          const float varj = 2.f * sj.y * inv;
          const float rsj = f1 * varj;
          const float rsd = f1 * 2.f * (sd.y + sj.z) * inv + f2 * varj * varj;
          put(a.oj + (lap + q) * plane, o, (jc * rs + xc * rsj) * sc);
          put(a.od + q * plane, o, (dc * rs + xc * rsd + 2.f * jc * rsj) * sc);
        }
        const float4 sl = stat[c + 1];
        const float lc = in(c + 1, f) - sl.x;
        const float rsl = f1 * 2.f * (sl.y + jsq) * inv + f2 * varj_sq;
        put(a.ol, o, (lc * rs + xc * rsl + 2.f * cross) * sc);
      }
    }
    // This warp is done with the stage: once the group's 8 warps are, the
    // producer refills it.
    __syncwarp();
    if (lane == 0) bar_arrive(empty + s);
  }
}

// Each instantiation may use all of `limit` bytes of dynamic shared memory on
// a device once the attribute is set there, which happens once.
template <int V4, int PROBE>
int launch(const Args& a, int stages, int device, int limit, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = jet_layernorm_staged_kernel<V4, PROBE>;
  if (allowed[device] != limit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = limit;
  }
  const size_t smem = smem_bytes(a.c + a.e + 2, a.feat, a.rx != nullptr, stages);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t grid = sms < a.rows ? sms : a.rows;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(a, stages);
  return static_cast<int>(cudaGetLastError());
}

template <int V4>
int launch_probe(const Args& a, int probe, int stages, int device, int limit,
                 cudaStream_t stream) {
  if (probe == kWhole) return launch<V4, kWhole>(a, stages, device, limit, stream);
  if (probe == kNoStore) return launch<V4, kNoStore>(a, stages, device, limit, stream);
  if (probe == kNoMath) return launch<V4, kNoMath>(a, stages, device, limit, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// stages: the most the ring may hold, or 0 for as many as fit (at most
// kMaxStages); it runs with ring(stages).
int run(const Args& a, int probe, int stages, void* stream) {
  const void* ptrs[] = {a.x, a.j, a.l, a.d, a.scale, a.bias, a.ox, a.oj, a.ol, a.od};
  for (const void* p : ptrs) {
    if (p == nullptr || !aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* residual[] = {a.rx, a.rj, a.rl, a.rd};
  const bool res = a.rx != nullptr;
  for (const void* p : residual) {
    if ((p != nullptr) != res || !aligned16(p)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!takes(a.feat, a.c, a.e) || a.rows <= 0 || a.rows > 0x7fffffff || stages < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int limit = smem_limit(device);
  const int most = most_stages(a.c + a.e + 2, a.feat, res, limit);
  if (most < 1 || stages > most) return static_cast<int>(cudaErrorInvalidValue);
  stages = ring(stages == 0 ? most : stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.feat <= 256) return launch_probe<2>(a, probe, stages, device, limit, s);
  return launch_probe<4>(a, probe, stages, device, limit, s);
}

}  // namespace staged


// The generic kernel.  Planes are contiguous [rows, feat] float32 blocks:
// j and d (and rj, rd) hold c and e planes back to back.  rx..rd are null for
// no residual.  Returns the CUDA error of the launch (0 on success).
extern "C" int jet_layernorm_generic_f32(const float* x, const float* j, const float* l,
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

// The staged kernel: any jet with feat <= 512 whose row fits one stage
// (ops/jet_layernorm.py:takes_staged), with or without a residual, every
// pointer a multiple of 16 bytes; any row count.  Same arguments and return value as above;
// cudaErrorInvalidValue for what it does not take.
extern "C" int jet_layernorm_staged_f32(const float* x, const float* j, const float* l,
                                        const float* d, const float* rx, const float* rj,
                                        const float* rl, const float* rd, const float* scale,
                                        const float* bias, float* ox, float* oj, float* ol,
                                        float* od, int64_t rows, int feat, int c, int e,
                                        float eps, void* stream) {
  const staged::Args a{x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps};
  return staged::run(a, staged::kWhole, 0, stream);
}

// The stages of the staged kernel's ring for a jet of this shape on `device`,
// 0 where the kernel does not take it: the routing rule
// (ops/jet_layernorm.py:takes_staged) asks here, so that it and the launch
// agree on the budget.
extern "C" int jet_layernorm_staged_stages(int device, int feat, int c, int e, int residual) {
  if (!staged::takes(feat, c, e) || device < 0 || device >= staged::kMaxDevices) return 0;
  const int limit = staged::smem_limit(device);
  return staged::ring(staged::most_stages(c + e + 2, feat, residual != 0, limit));
}

// The staged kernel cut down or with a shorter ring, for timing only
// (scripts/torch_layernorm_diagnostics.py).  probe: 0 the kernel, 1 without its
// stores, 2 without its arithmetic (load, add, store).  stages: at most this
// many in the ring (an odd number past one runs one fewer), 0 for as many as fit.
extern "C" int jet_layernorm_staged_probe_f32(const float* x, const float* j, const float* l,
                                              const float* d, const float* rx, const float* rj,
                                              const float* rl, const float* rd,
                                              const float* scale, const float* bias, float* ox,
                                              float* oj, float* ol, float* od, int64_t rows,
                                              int feat, int c, int e, float eps, int probe,
                                              int stages, void* stream) {
  const staged::Args a{x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps};
  return staged::run(a, probe, stages, stream);
}
