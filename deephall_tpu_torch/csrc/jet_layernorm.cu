// Jet LayerNorm: LayerNorm of a forward-Laplacian jet in one pass, for sm_90a.
//
// Replaces deephall_tpu/ops/jet_layernorm.py:_kernel (the Pallas TPU kernel
// launched by _fused_rows).  A jet row holds P = C + E + 2 planes of D features:
// the primal x, C tangents j, the Laplacian l and E extra second derivatives d.
// Optionally a residual jet is added first, LN(t + r).
//
// What bounds it on the H100: bytes.  Each element is read once (twice with
// the residual) and written once, against a few dozen flops, far below the
// card's ratio of flops to bytes.  The design therefore does what the TPU
// kernel does with VMEM: one pass.  One thread block per row and one thread
// per feature; each thread keeps its feature of every plane in registers (the
// residual is added on load), the row's reductions run by warp shuffles plus
// one shared-memory exchange across the warps, and every output plane is
// written once.  Loads and stores are coalesced along the feature axis.
//
// Algebra (as the TPU kernel, with xc, jc, lc, dc the centred planes and
// lap = C - E Laplacian tangents):
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
      c > 32 || rows <= 0 || rows > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (feat <= 256) {
    if (c <= 16) {
      launch<16, 4, 256>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    } else {
      launch<32, 4, 256>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    }
  } else {
    if (c <= 16) {
      launch<16, 4, 1024>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    } else {
      launch<32, 4, 1024>(x, j, l, d, rx, rj, rl, rd, scale, bias, ox, oj, ol, od, rows, feat, c, e, eps, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
