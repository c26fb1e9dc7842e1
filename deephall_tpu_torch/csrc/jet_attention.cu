// Jet attention: multi-head self-attention of a forward-Laplacian jet, for sm_90a.
//
// Replaces deephall_tpu/ops/jet_attention.py:_kernel (the Pallas TPU kernel
// launched by _fused_attention).  The TPU kernel keeps a 16-walker block of
// every plane, q/k/v included, in up to 100 MB of VMEM.  A Hopper block has
// 227 KB of shared memory: one walker's input planes alone are 123 KB at
// production shapes and each projection weight 256 KB.  So the work is split
// into three launches of two kernels:
//
//   1. jet_gemm: rows[P*B*T, D] @ Wqkv[D, 3D], bias on the primal rows only
//      (1/sqrt(dh) folded into wq and bq by the caller);
//   2. jet_softmax_values: one block per (walker, head); the head's q, k, v
//      slices of every plane sit in shared memory, and the logits jet, the
//      softmax jet and the value-contraction jet are computed there;
//   3. jet_gemm: attn[P*B*T, D] @ Wo[D, D], bias on the primal rows only.
//
// What bounds it on the H100: operations.  The four projections are
// 8 * P*B*T * D * D flops in full float32 (no TF32: the TPU kernel runs its
// products at Precision.HIGHEST), on the CUDA cores at 67 TFLOP/s; the bytes
// moved take a tenth of that time.  jet_gemm is a plain tiled SIMT GEMM
// (64x64x16 shared-memory tiles, 4x4 outputs per thread, float4 shared loads).
// A single fused pass with TMA-fed weight tiles and error-compensated TF32
// on the tensor cores is later work.
//
// Plane order everywhere: 0 = x, 1..C = j, C+1 = l, C+2..C+1+E = d; the first
// lap = C - E tangents are the Laplacian directions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, GEMM_THREADS = 256;

// C[m, n] = sum_k A[m, k] B[k, n] + (m < bias_rows ? bias[n] : 0); row-major float32.
__global__ void __launch_bounds__(GEMM_THREADS) jet_gemm_kernel(
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ bias, float* __restrict__ C, int64_t M, int N, int K,
    int64_t bias_rows) {
  __shared__ __align__(16) float As[BK][BM + 4];  // transposed: As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int ar = tid / 4, ac = (tid % 4) * 4;    // A tile: 64 rows x 16 cols
  const int br = tid / 16, bc = (tid % 16) * 4;  // B tile: 16 rows x 64 cols

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int64_t gm = m0 + ar;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + ac + i;
      As[ac + i][ar] = (gm < M && gk < K) ? A[gm * K + gk] : 0.f;
    }
    const int gk = k0 + br;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gn = n0 + bc + i;
      Bs[br][bc + i] = (gk < K && gn < N) ? B[static_cast<int64_t>(gk) * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < TN; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      const int gn = n0 + tx * TN + jj;
      if (gn < N) C[gm * N + gn] = acc[i][jj] + (gm < bias_rows ? bias[gn] : 0.f);
    }
  }
}

constexpr int SV_THREADS = 256;

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int f = 0; f < n; ++f) s = fmaf(a[f], b[f], s);
  return s;
}

// One block per (walker, head).  qkv: [P, B, T, 3D] (q | k | v along the last
// axis); attn: [P, B, T, D].  Shared memory: q, k, v as [P][T][dh + 1] (the
// padding keeps rows in distinct banks), then the logits jet G, the
// exponential jet X, the weights jet W as [P][T][T], and the sum S and
// reciprocal R jets as [P][T].
__global__ void __launch_bounds__(SV_THREADS) jet_softmax_values_kernel(
    const float* __restrict__ qkv, float* __restrict__ attn, int P, int64_t batch,
    int T, int D, int H, int C, int E) {
  extern __shared__ float smem[];
  const int dh = D / H;
  const int ld = dh + 1;
  const int lap = C - E;
  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  float* qs = smem;
  float* ks = qs + P * T * ld;
  float* vs = ks + P * T * ld;
  float* G = vs + P * T * ld;
  float* X = G + P * T * T;
  float* W = X + P * T * T;
  float* S = W + P * T * T;
  float* R = S + P * T;
  const int tid = threadIdx.x;

  for (int i = tid; i < P * T * dh; i += SV_THREADS) {
    const int p = i / (T * dh), t = (i / dh) % T, f = i % dh;
    const int64_t row = (static_cast<int64_t>(p) * batch + b) * T + t;
    const float* src = qkv + row * 3 * D + h * dh + f;
    const int o = (p * T + t) * ld + f;
    qs[o] = src[0];
    ks[o] = src[D];
    vs[o] = src[2 * D];
  }
  __syncthreads();

#define QROW(p, t) (qs + ((p) * T + (t)) * ld)
#define KROW(p, s) (ks + ((p) * T + (s)) * ld)
#define VROW(p, s) (vs + ((p) * T + (s)) * ld)
#define AT(A, p, t, s) A[((p) * T + (t)) * T + (s)]

  // Logits jet: product rule, plus the cross term over the Laplacian tangents
  // (l plane) or over the matching extra tangent (d planes).
  for (int i = tid; i < P * T * T; i += SV_THREADS) {
    const int p = i / (T * T), t = (i / T) % T, s = i % T;
    float g = dot(QROW(p, t), KROW(0, s), dh);
    if (p > 0) g += dot(QROW(0, t), KROW(p, s), dh);
    if (p == C + 1) {
      float cross = 0.f;
      for (int k = 0; k < lap; ++k) cross += dot(QROW(1 + k, t), KROW(1 + k, s), dh);
      g += 2.f * cross;
    } else if (p > C + 1) {
      const int k = 1 + lap + (p - C - 2);
      g += 2.f * dot(QROW(k, t), KROW(k, s), dh);
    }
    AT(G, p, t, s) = g;
  }
  __syncthreads();

  // exp jet of the max-shifted logits (the shift is a constant and cancels).
  for (int i = tid; i < T * T; i += SV_THREADS) {
    const int t = i / T, s = i % T;
    float c0 = AT(G, 0, t, 0);
    for (int s2 = 1; s2 < T; ++s2) c0 = fmaxf(c0, AT(G, 0, t, s2));
    const float ex = expf(AT(G, 0, t, s) - c0);
    AT(X, 0, t, s) = ex;
    float jsq = 0.f;
    for (int k = 0; k < C; ++k) {
      const float gj = AT(G, 1 + k, t, s);
      AT(X, 1 + k, t, s) = ex * gj;
      if (k < lap) jsq += gj * gj;
    }
    AT(X, C + 1, t, s) = ex * (AT(G, C + 1, t, s) + jsq);
    for (int q = 0; q < E; ++q) {
      const float gj = AT(G, 1 + lap + q, t, s);
      AT(X, C + 2 + q, t, s) = ex * (AT(G, C + 2 + q, t, s) + gj * gj);
    }
  }
  __syncthreads();

  // Sum over the sources.
  for (int i = tid; i < P * T; i += SV_THREADS) {
    const int p = i / T, t = i % T;
    float acc = 0.f;
    for (int s = 0; s < T; ++s) acc += AT(X, p, t, s);
    S[p * T + t] = acc;
  }
  __syncthreads();

  // Reciprocal jet: f1 = -1/s^2, f2 = 2/s^3.
  for (int i = tid; i < P * T; i += SV_THREADS) {
    const int p = i / T, t = i % T;
    const float rx = 1.f / S[t];
    const float rx2 = rx * rx, rx3 = rx2 * rx;
    float r;
    if (p == 0) {
      r = rx;
    } else if (p <= C) {
      r = -S[p * T + t] * rx2;
    } else if (p == C + 1) {
      float sq = 0.f;
      for (int k = 0; k < lap; ++k) sq += S[(1 + k) * T + t] * S[(1 + k) * T + t];
      r = -S[p * T + t] * rx2 + 2.f * rx3 * sq;
    } else {
      const float sj = S[(1 + lap + p - C - 2) * T + t];
      r = -S[p * T + t] * rx2 + 2.f * rx3 * sj * sj;
    }
    R[p * T + t] = r;
  }
  __syncthreads();

  // Weights jet w = e * r (product rule with the cross term).
  for (int i = tid; i < P * T * T; i += SV_THREADS) {
    const int p = i / (T * T), t = (i / T) % T, s = i % T;
    const float ex = AT(X, 0, t, s), rx = R[t];
    float w = AT(X, p, t, s) * rx;
    if (p > 0) w += ex * R[p * T + t];
    if (p == C + 1) {
      float cross = 0.f;
      for (int k = 0; k < lap; ++k) cross += AT(X, 1 + k, t, s) * R[(1 + k) * T + t];
      w += 2.f * cross;
    } else if (p > C + 1) {
      const int k = 1 + lap + (p - C - 2);
      w += 2.f * AT(X, k, t, s) * R[k * T + t];
    }
    AT(W, p, t, s) = w;
  }
  __syncthreads();

  // Value contraction jet, written to attn[p, b, t, h*dh + f].
  for (int i = tid; i < P * T * dh; i += SV_THREADS) {
    const int p = i / (T * dh), t = (i / dh) % T, f = i % dh;
    float a = 0.f;
    for (int s = 0; s < T; ++s) a = fmaf(AT(W, p, t, s), VROW(0, s)[f], a);
    if (p > 0) {
      for (int s = 0; s < T; ++s) a = fmaf(AT(W, 0, t, s), VROW(p, s)[f], a);
    }
    if (p == C + 1) {
      float cross = 0.f;
      for (int k = 0; k < lap; ++k)
        for (int s = 0; s < T; ++s) cross = fmaf(AT(W, 1 + k, t, s), VROW(1 + k, s)[f], cross);
      a += 2.f * cross;
    } else if (p > C + 1) {
      const int k = 1 + lap + (p - C - 2);
      float cross = 0.f;
      for (int s = 0; s < T; ++s) cross = fmaf(AT(W, k, t, s), VROW(k, s)[f], cross);
      a += 2.f * cross;
    }
    const int64_t row = (static_cast<int64_t>(p) * batch + b) * T + t;
    attn[row * D + h * dh + f] = a;
  }
#undef QROW
#undef KROW
#undef VROW
#undef AT
}

size_t softmax_values_smem(int P, int T, int dh) {
  return sizeof(float) * (3 * static_cast<size_t>(P) * T * (dh + 1) +
                          3 * static_cast<size_t>(P) * T * T + 2 * static_cast<size_t>(P) * T);
}

}  // namespace

// C = A @ B + bias on the first bias_rows rows.  A: [m, k], B: [k, n], C: [m, n],
// bias: [n], all contiguous float32.  Returns the CUDA error of the launch.
extern "C" int jet_gemm_f32(const float* a, const float* b, const float* bias, float* c,
                            int64_t m, int n, int k, int64_t bias_rows, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + BM - 1) / BM > 0x7fffffff ||
      (n + BN - 1) / BN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid(static_cast<unsigned>((m + BM - 1) / BM), static_cast<unsigned>((n + BN - 1) / BN));
  jet_gemm_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, bias, c, m, n, k, bias_rows);
  return static_cast<int>(cudaGetLastError());
}

// Logits, softmax and value-contraction jets of every (walker, head).
// qkv: [planes, batch, tokens, 3 * feat]; attn: [planes, batch, tokens, feat].
extern "C" int jet_softmax_values_f32(const float* qkv, float* attn, int planes,
                                      int64_t batch, int tokens, int feat, int heads,
                                      int c, int e, void* stream) {
  if (heads <= 0 || feat % heads != 0 || e < 1 || c < e || planes != c + e + 2 ||
      batch <= 0 || tokens <= 0 || batch * heads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = softmax_values_smem(planes, tokens, feat / heads);
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      jet_softmax_values_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  jet_softmax_values_kernel<<<static_cast<unsigned>(batch * heads), SV_THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      qkv, attn, planes, batch, tokens, feat, heads, c, e);
  return static_cast<int>(cudaGetLastError());
}
