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
//   2. jet_softmax_values: one block per (walker, head) computes the logits
//      jet, the softmax jet and the value-contraction jet of that head's
//      q, k, v slices in shared memory;
//   3. jet_gemm: attn[P*B*T, D] @ Wo[D, D], bias on the primal rows only.
//
// Each of the two has a kernel designed for the production shapes and one
// that takes the others; the caller picks by shape before the launch.
//
// jet_gemm on the tensor cores (jet_gemm_tf32x3_kernel).  The local energy
// needs float32 products (the TPU kernel runs them at Precision.HIGHEST), and
// the tensor cores multiply TF32.  So each operand is split into
// hi = tf32(x) and lo = tf32(x - hi), and lo*hi + hi*lo + hi*hi is summed in
// float32: three TF32 products, the dropped lo*lo term is about 2^-22 of the
// product.  What bounds it: operations, 3 * 2MNK at the TF32 rate (bytes take
// half of that time at N = 3D).  The weight arrives already split and
// transposed to [N, K] (it is constant during inference); A is split in
// registers.  A persistent block of two warpgroups walks over 256x128 output
// tiles, n fastest so that a row block of A stays in L2 for all its column
// tiles (at 128x128 the kernel was bound by the L2 traffic of re-read weight
// tiles).  A ring of three 64 KB stages (A 256 x 32 floats, W hi and W lo
// 128 x 32 each, 128-byte rows XOR-swizzled by 16-byte chunk) is filled with
// 16-byte cp.async two steps ahead, across tile boundaries.  Each warpgroup
// owns 128 rows as two 64-row halves.  Accuracy: the tensor cores align the
// addends of one wgmma to the largest and truncate, a biased loss per
// accumulate step.  One accumulator for all 96 products of K = 256 (the
// kernel's first design) lost more than a float32 FMA chain wherever a row
// cancels.  So a step's twelve wgmma.m64n128k8 per half (A from registers, W
// from shared memory) go into an accumulator that starts from zero, the eight
// small terms before the four large ones, and that partial sum is added into
// the half's float32 accumulator on the CUDA cores, rounding to nearest.  The two
// warpgroups' wgmma streams fill each other's waits.  The bias goes on in the
// epilogue, which pairs lanes to store 16 bytes a thread.  It takes
// K % 32 == 0, N % 128 == 0 and 16-byte aligned rows; anything else goes to
// jet_gemm_kernel, a tiled SIMT GEMM in plain float32 on the CUDA cores.
//
// jet_softmax_values at the production shapes (jet_softmax_values_tiled_kernel,
// a template on T, dh, C, E).  What bounds it: bytes (q, k, v read once, the
// output written once; the arithmetic is a fifth of that time).  Persistent
// blocks, one per SM, walk over the (walker, head) items; the next item's
// q, k, v slices (256-byte segments of qkv) arrive by 16-byte cp.async in the
// other half of a two-stage ring while the current item computes, so the
// loads never stop.  Rows are not padded: the 16-byte chunk index is XORed
// with the plane index, which keeps the 16-byte shared-memory reads of both
// access patterns off each other's banks.  The channel-diagonal products
// (q_k.k_k, e_k*r_k, w_k.v_k) are work items of their own, so no thread
// waits on the l plane: the logits are 6x6 blocks per (plane pair, quarter
// of dh) held in registers, the value contraction 6 x 4 blocks per (plane,
// 16-byte feature chunk).  Its double-buffered stage of every plane needs
// 368 KB at N = 10 (T = 10, P = 28), so it is compiled for T = 6 alone.
//
// jet_softmax_values at every other shape (jet_softmax_values_planes_kernel).
// Keeping q, k, v of every plane resident (3 P T (dh + 1) floats) would pass
// the card's 227 KB at N = 10 with L^2 (254 KB) and at every N = 12.  Each
// tangent and extra plane needs only its own q, k, v and the primal's, so the
// planes are streamed through a buffer of four, and shared memory holds the
// primal, that buffer and the [P][T][T] jets: 92 KB at N = 16 with L^2.
// Bound by bytes as the tiled kernel; the products are read from shared
// memory by scalar loads.
//
// Plane order everywhere: 0 = x, 1..C = j, C+1 = l, C+2..C+1+E = d; the first
// lap = C - E tangents are the Laplacian directions.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- jet_gemm on the tensor cores: 3xTF32 with wgmma --------------------------

namespace tc {

constexpr int BM = 256, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_BYTES = BM * BK * 4, W_BYTES = BN * BK * 4;
constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;       // A | W hi | W lo
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // room to align to 1024

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows and the
// 128-byte swizzle: 8-row groups 1024 bytes apart, base aligned to 1024.
__device__ __forceinline__ uint64_t matrix_descriptor(uint32_t address) {
  return static_cast<uint64_t>((address & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

#define JET_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= a[64 x 8] * b[8 x 128]: a from registers, b from shared memory.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : JET_D8(0), JET_D8(8), JET_D8(16), JET_D8(24), JET_D8(32), JET_D8(40), JET_D8(48),
        JET_D8(56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
}
#undef JET_D8

// C[m, n] = sum_k A[m, k] W[k, n] + (m < bias_rows ? bias[n] : 0) with
// whi + wlo = W^T as [N, K], both rounded to TF32.  K % BK == 0, N % BN == 0.
// Each of the two warpgroups owns 128 rows of the tile as two 64-row halves.
// A half's twelve products of one step go into the wgmma accumulator `part`,
// which starts from zero: first the eight small terms (lo*hi, hi*lo of the
// four k8 blocks), then the four large ones (hi*hi).  `part` is then added
// into the half's float32 accumulator by the CUDA cores, rounding to nearest.
// The tensor cores align an instruction's addends to the largest and do not
// round to nearest, a loss that is biased and grows with the accumulate
// steps; here it spans twelve instructions, not 96, and the small terms meet
// the large ones once per step, as one partial sum, instead of at every k8
// block.  255 registers, no spill (ptxas -v on sm_90a); a promotion every two
// k8 blocks gained no accuracy and cost time.
__global__ void __launch_bounds__(THREADS, 1) jet_gemm_tf32x3_kernel(
    const float* __restrict__ A, const float* __restrict__ whi, const float* __restrict__ wlo,
    const float* __restrict__ bias, float* __restrict__ C, int64_t M, int N, int K,
    int64_t bias_rows, int n_tiles, int total_tiles) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t smem_base = smem_address(smem);
  const int tid = threadIdx.x, lane = tid & 31, group = lane >> 2, quad = lane & 3;
  // This thread's first row of half 0; half 1 is 64 further, the second row 8 further.
  const int row_in_tile = (tid >> 7) * 128 + ((tid >> 5) & 3) * 16 + group;
  const int steps_per_tile = K / BK;
  const int my_tiles = (total_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int steps = my_tiles * steps_per_tile;

  // Starts the copies of step f's tiles into ring slot f % STAGES; one group each call.
  auto load_stage = [&](int f) {
    if (f < steps) {
      const int tile = blockIdx.x + (f / steps_per_tile) * gridDim.x;
      const int k0 = (f % steps_per_tile) * BK;
      const int64_t m0 = static_cast<int64_t>(tile / n_tiles) * BM;
      const int n0 = (tile % n_tiles) * BN;
      const uint32_t slot = smem_base + (f % STAGES) * STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int row = idx >> 3, chunk = idx & 7;
        const int64_t gm = m0 + row < M ? m0 + row : M - 1;
        cp_async16(slot + row * 128 + ((chunk ^ (row & 7)) << 4), A + gm * K + k0 + chunk * 4);
      }
#pragma unroll
      for (int i = 0; i < BN * 8 / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int row = idx >> 3, chunk = idx & 7;
        const uint32_t off = row * 128 + ((chunk ^ (row & 7)) << 4);
        const int64_t wrow = static_cast<int64_t>(n0 + row) * K + k0 + chunk * 4;
        cp_async16(slot + A_BYTES + off, whi + wrow);
        cp_async16(slot + A_BYTES + W_BYTES + off, wlo + wrow);
      }
    }
    cp_async_commit();
  };

  // This thread's part of the A operand of step f, half r, split into hi and lo:
  // for each k8 block, (row, k), (row + 8, k), (row, k + 4), (row + 8, k + 4).
  auto load_a = [&](int f, int r, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
    const float* a = reinterpret_cast<const float*>(smem + (f % STAGES) * STAGE_BYTES) +
                     (row_in_tile + 64 * r) * BK + quad;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x = a[8 * i * BK + ((c ^ group) << 2)];
        const uint32_t h = to_tf32(x);
        hi[c * 2 + i] = h;
        lo[c * 2 + i] = to_tf32(x - __uint_as_float(h));
      }
    }
  };

  // The twelve products of one step and half into d, from zero: the small terms
  // of every k8 block first, then the large ones; waited for.
  auto products = [&](int f, float (&d)[64], const uint32_t (&hi)[16], const uint32_t (&lo)[16]) {
    const uint32_t slot = smem_base + (f % STAGES) * STAGE_BYTES;
    const uint64_t dhi = matrix_descriptor(slot + A_BYTES);
    const uint64_t dlo = matrix_descriptor(slot + A_BYTES + W_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // 32 bytes further along K inside the swizzled row: +2 in the address field.
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_m64n128k8(d, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
                      dhi + 2 * kk, kk != 0);
      wgmma_m64n128k8(d, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
                      dlo + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_m64n128k8(d, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
                      dhi + 2 * kk, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  };

  auto store_half = [&](int tile, int r, const float (&d)[64]) {
    const int64_t m0 = static_cast<int64_t>(tile / n_tiles) * BM;
    const int n0 = (tile % n_tiles) * BN;
    // A lane holds (row, c), (row, c+1), (row+8, c), (row+8, c+1) of each 8-column
    // block; lane pairs swap halves so that each stores four adjacent columns.
    const bool even = (quad & 1) == 0;
    const int64_t row = m0 + row_in_tile + 64 * r + (even ? 0 : 8);
    const int col0 = n0 + 2 * (quad & 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float sx = even ? d[4 * j + 2] : d[4 * j];
      const float sy = even ? d[4 * j + 3] : d[4 * j + 1];
      const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
      const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
      float4 out = even ? make_float4(d[4 * j], d[4 * j + 1], rx, ry)
                        : make_float4(rx, ry, d[4 * j + 2], d[4 * j + 3]);
      const int col = col0 + 8 * j;
      if (row < bias_rows) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
        out.x += b.x, out.y += b.y, out.z += b.z, out.w += b.w;
      }
      if (row < M) *reinterpret_cast<float4*>(C + row * N + col) = out;
    }
  };

  float acc[2][64] = {}, part[64] = {};
  uint32_t hi[16], lo[16];

  load_stage(0);
  load_stage(1);
  cp_async_wait<1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  int step_in_tile = 0, tiles_done = 0;
  for (int f = 0; f < steps; ++f) {
    // Step f + 2 goes into the slot of step f - 1, which every thread has
    // finished with before the barrier at the end of that step.
    load_stage(f + 2);
    const bool first = step_in_tile == 0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      load_a(f, r, hi, lo);
      products(f, part, hi, lo);
      // The operand registers and the accumulator are the wgmma's until the
      // wait; the compiler sees the results only from here on.
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(hi[i]), "+r"(lo[i])::"memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        asm volatile("" : "+f"(part[i])::"memory");
        acc[r][i] = (first ? 0.f : acc[r][i]) + part[i];
      }
    }
    // Step f + 1 has landed (f + 2 may still be in flight).
    cp_async_wait<1>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (step_in_tile == steps_per_tile - 1) {
      step_in_tile = 0;
      store_half(blockIdx.x + tiles_done * gridDim.x, 0, acc[0]);
      store_half(blockIdx.x + tiles_done * gridDim.x, 1, acc[1]);
      ++tiles_done;
    } else {
      ++step_in_tile;
    }
  }
  cp_async_wait<0>();
}

int launch(const float* a, const float* whi, const float* wlo, const float* bias, float* c,
           int64_t m, int n, int k, int64_t bias_rows, cudaStream_t stream) {
  const int64_t m_tiles = (m + BM - 1) / BM;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (m <= 0 || n <= 0 || k <= 0 || k % BK || n % BN || m_tiles * (n / BN) > 0x7fffffff ||
      misaligned(a) || misaligned(whi) || misaligned(wlo) || misaligned(bias) ||
      misaligned(c)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(jet_gemm_tf32x3_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n_tiles = n / BN;
  const int total = static_cast<int>(m_tiles * n_tiles);
  jet_gemm_tf32x3_kernel<<<total < sms ? total : sms, THREADS, SMEM_BYTES, stream>>>(
      a, whi, wlo, bias, c, m, n, k, bias_rows, n_tiles, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- jet_gemm, generic: plain float32 on the CUDA cores ------------------------

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

// ---- jet_softmax_values at any shape: planes streamed through shared memory --------

namespace sv_planes {

constexpr int THREADS = 256;
constexpr int CHUNK = 4;  // planes of q and k (or of v) a block holds at once

// Offsets in floats of the shared-memory layout of one (walker, head).
struct Layout {
  int ld, q0, k0, v0, qc, kc, m, s, r, cmax, total;
};

// The primal q, k, v as [T][dh + 1] (the padding keeps rows in distinct
// banks); a chunk of CHUNK planes of q and of k, [CHUNK][T][dh + 1] each (the
// value pass holds CHUNK planes of v in the first and its cross sums,
// [1 + E][T][dh], in the second); the logits / exponential / weights jet M as
// [P][T][T]; the sum and reciprocal jets S, R as [P][T]; the row maxima [T].
// ops/jet_attention.py:softmax_values_smem mirrors this sum.
__host__ __device__ inline Layout layout(int P, int T, int dh, int E) {
  Layout a;
  a.ld = dh + 1;
  const int row = T * a.ld;
  const int chunk = CHUNK * row;
  const int sums = (1 + E) * T * dh;
  a.q0 = 0;
  a.k0 = row;
  a.v0 = 2 * row;
  a.qc = 3 * row;
  a.kc = a.qc + chunk;
  a.m = a.kc + (chunk > sums ? chunk : sums);
  a.s = a.m + P * T * T;
  a.r = a.s + P * T;
  a.cmax = a.r + P * T;
  a.total = a.cmax + T;
  return a;
}

// One block per (walker, head).  qkv: [P, B, T, 3D] (q | k | v along the last
// axis); attn: [P, B, T, D].  Two passes over the planes, CHUNK at a time in
// plane order: the logits pass reads each plane's q and k once, the value
// pass each plane's v once, and only the primal's q, k, v and the [P][T][T]
// jets stay resident, so shared memory grows with P T^2 + T dh.  In the
// logits pass a thread owns a (query, source) pair for every plane and keeps
// the l and d planes' cross sums q_k.k_k in M until their own plane arrives;
// in the value pass it owns a (query, feature) pair and keeps w_k.v_k in the
// cross sums.  Each sum is taken by one thread in plane order.
__global__ void __launch_bounds__(THREADS) jet_softmax_values_planes_kernel(
    const float* __restrict__ qkv, float* __restrict__ attn, int P, int64_t batch, int T,
    int D, int H, int C, int E) {
  extern __shared__ float smem[];
  const int dh = D / H;
  const Layout L = layout(P, T, dh, E);
  const int ld = L.ld;
  const int lap = C - E;
  const int TT = T * T;
  const int64_t b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  float* q0 = smem + L.q0;
  float* k0 = smem + L.k0;
  float* v0 = smem + L.v0;
  float* qc = smem + L.qc;
  float* kc = smem + L.kc;
  float* M = smem + L.m;
  float* S = smem + L.s;
  float* R = smem + L.r;
  float* cmax = smem + L.cmax;
  // Row t of plane p's q slice; k and v follow at +D and +2D.
  auto row = [&](int p, int t) {
    return qkv + ((static_cast<int64_t>(p) * batch + b) * T + t) * 3 * D + h * dh;
  };

  for (int i = tid; i < T * dh; i += THREADS) {
    const int t = i / dh, f = i % dh;
    const float* src = row(0, t) + f;
    q0[t * ld + f] = src[0];
    k0[t * ld + f] = src[D];
    v0[t * ld + f] = src[2 * D];
  }
  for (int i = tid; i < (1 + E) * TT; i += THREADS) M[(C + 1) * TT + i] = 0.f;

  // Logits jet: G_p = q_p.k_0 + q_0.k_p, plus twice the cross term over the
  // Laplacian tangents (l plane) or over the matching extra tangent (d planes).
  for (int p0 = 0; p0 < P; p0 += CHUNK) {
    const int np = P - p0 < CHUNK ? P - p0 : CHUNK;
    __syncthreads();
    for (int i = tid; i < np * T * dh; i += THREADS) {
      const int j = i / (T * dh), t = (i / dh) % T, f = i % dh;
      const float* src = row(p0 + j, t) + f;
      qc[(j * T + t) * ld + f] = src[0];
      kc[(j * T + t) * ld + f] = src[D];
    }
    __syncthreads();
    for (int i = tid; i < TT; i += THREADS) {
      const int t = i / T, s = i % T;
      const float* qx = q0 + t * ld;
      const float* kx = k0 + s * ld;
      float a[CHUNK], g[CHUNK], cross[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) a[j] = g[j] = cross[j] = 0.f;
      for (int f = 0; f < dh; ++f) {
        const float q = qx[f], k = kx[f];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float qp = qc[(j * T + t) * ld + f], kp = kc[(j * T + s) * ld + f];
          a[j] = fmaf(qp, k, a[j]);
          g[j] = fmaf(q, kp, g[j]);
          cross[j] = fmaf(qp, kp, cross[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int p = p0 + j;
        if (p >= P) break;
        float* m = M + p * TT + i;
        if (p == 0) {
          *m = a[j];
        } else if (p <= C) {
          *m = a[j] + g[j];
          const int k = p - 1;
          if (k < lap) {
            M[(C + 1) * TT + i] += cross[j];
          } else {
            M[(C + 2 + k - lap) * TT + i] = cross[j];
          }
        } else {
          *m = a[j] + g[j] + 2.f * *m;
        }
      }
    }
  }
  __syncthreads();

  // exp jet of the max-shifted logits (the shift is a constant and cancels),
  // in place: a thread reads every plane of its (query, source) pair first.
  for (int t = tid; t < T; t += THREADS) {
    float c0 = M[t * T];
    for (int s = 1; s < T; ++s) c0 = fmaxf(c0, M[t * T + s]);
    cmax[t] = c0;
  }
  __syncthreads();
  for (int i = tid; i < TT; i += THREADS) {
    float* m = M + i;
    const float ex = expf(m[0] - cmax[i / T]);
    for (int q = 0; q < E; ++q) {
      const float gj = m[(1 + lap + q) * TT];
      m[(C + 2 + q) * TT] = ex * (m[(C + 2 + q) * TT] + gj * gj);
    }
    float jsq = 0.f;
    for (int k = 0; k < C; ++k) {
      const float gj = m[(1 + k) * TT];
      m[(1 + k) * TT] = ex * gj;
      if (k < lap) jsq += gj * gj;
    }
    m[(C + 1) * TT] = ex * (m[(C + 1) * TT] + jsq);
    m[0] = ex;
  }
  __syncthreads();

  // Sum over the sources.
  for (int i = tid; i < P * T; i += THREADS) {
    float acc = 0.f;
    for (int s = 0; s < T; ++s) acc += M[i * T + s];
    S[i] = acc;
  }
  __syncthreads();

  // Reciprocal jet: f1 = -1/s^2, f2 = 2/s^3.
  for (int i = tid; i < P * T; i += THREADS) {
    const int p = i / T, t = i % T;
    const float rx = 1.f / S[t];
    const float rx2 = rx * rx, rx3 = rx2 * rx;
    float r;
    if (p == 0) {
      r = rx;
    } else if (p <= C) {
      r = -S[i] * rx2;
    } else if (p == C + 1) {
      float sq = 0.f;
      for (int k = 0; k < lap; ++k) sq += S[(1 + k) * T + t] * S[(1 + k) * T + t];
      r = -S[i] * rx2 + 2.f * rx3 * sq;
    } else {
      const float sj = S[(1 + lap + p - C - 2) * T + t];
      r = -S[i] * rx2 + 2.f * rx3 * sj * sj;
    }
    R[i] = r;
  }
  __syncthreads();

  // Weights jet w = e * r (product rule with the cross term), in place: the
  // l and d planes first, while the tangents still hold e.
  for (int i = tid; i < TT; i += THREADS) {
    const int t = i / T;
    float* m = M + i;
    const float ex = m[0], rx = R[t];
    float cross = 0.f;
    for (int k = 1; k <= lap; ++k) cross += m[k * TT] * R[k * T + t];
    m[(C + 1) * TT] = m[(C + 1) * TT] * rx + ex * R[(C + 1) * T + t] + 2.f * cross;
    for (int q = 0; q < E; ++q) {
      const int k = 1 + lap + q;
      m[(C + 2 + q) * TT] =
          m[(C + 2 + q) * TT] * rx + ex * R[(C + 2 + q) * T + t] + 2.f * m[k * TT] * R[k * T + t];
    }
    for (int k = 1; k <= C; ++k) m[k * TT] = m[k * TT] * rx + ex * R[k * T + t];
    m[0] = ex * rx;
  }

  // Value contraction jet W_p v_0 + W_0 v_p, plus twice the cross sums
  // w_k.v_k, written to attn[p, b, t, h*dh + f].  The cross sums live where
  // the k chunk was; each (query, feature) pair's belong to one thread.
  float* vc = qc;
  float* sums = kc;
  const int items = T * dh;
  for (int i = tid; i < items; i += THREADS) sums[i] = 0.f;
  for (int p0 = 0; p0 < P; p0 += CHUNK) {
    const int np = P - p0 < CHUNK ? P - p0 : CHUNK;
    __syncthreads();
    for (int i = tid; i < np * items; i += THREADS) {
      const int j = i / items, t = (i / dh) % T, f = i % dh;
      vc[(j * T + t) * ld + f] = row(p0 + j, t)[2 * D + f];
    }
    __syncthreads();
    for (int i = tid; i < items; i += THREADS) {
      const int t = i / dh, f = i % dh;
      const float* w0 = M + t * T;
      const float* wp[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) wp[j] = M + ((p0 + j < P ? p0 + j : P - 1) * T + t) * T;
      float a[CHUNK], g[CHUNK], cross[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) a[j] = g[j] = cross[j] = 0.f;
      for (int s = 0; s < T; ++s) {
        const float v = v0[s * ld + f], w = w0[s];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float wj = wp[j][s], vj = vc[(j * T + s) * ld + f];
          a[j] = fmaf(wj, v, a[j]);
          g[j] = fmaf(w, vj, g[j]);
          cross[j] = fmaf(wj, vj, cross[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int p = p0 + j;
        if (p >= P) break;
        float out = a[j];
        if (p >= 1 && p <= C) {
          out += g[j];
          const int k = p - 1;
          if (k < lap) {
            sums[i] += cross[j];
          } else {
            sums[(1 + k - lap) * items + i] = cross[j];
          }
        } else if (p > C) {
          out += g[j] + 2.f * sums[(p == C + 1 ? 0 : p - C - 1) * items + i];
        }
        attn[((static_cast<int64_t>(p) * batch + b) * T + t) * D + h * dh + f] = out;
      }
    }
  }
}

}  // namespace sv_planes

// ---- jet_softmax_values at compile-time shapes ---------------------------------

namespace sv {

constexpr int THREADS = 320;

template <int T, int DH, int C, int E>
struct Shape {
  static constexpr int P = C + E + 2, LAP = C - E;
  static constexpr int PAIRS = P + (P - 1) + C;  // q_p.k_0, q_0.k_p, q_k.k_k
  static constexpr int SLICES = 4, CHUNKS = DH / 4, TT = T * T;
  static constexpr int GROUPS = 4 + E;  // value cross terms: 4 sums of LAP / 4, E singles
  static constexpr int MAT = P * T * DH, STAGE = 3 * MAT;
  static constexpr int PARTIAL = PAIRS * SLICES * TT, JET = P * TT;
  static constexpr int SMEM_FLOATS = 2 * STAGE + PARTIAL + 3 * JET + 2 * P * T;
  static_assert(DH == 64 && TT % 4 == 0 && LAP % 4 == 0 && E >= 1, "unsupported shape");
  static_assert(PAIRS * SLICES <= THREADS && P * CHUNKS <= THREADS, "too few threads");
  static_assert(GROUPS * T * DH <= MAT, "the cross sums take the place of q");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x), acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z), acc.w = fmaf(w, v.w, acc.w);
}

// Row (p, t) of q, k or v in a stage: 16 chunks of 16 bytes, chunk c at c ^ ((p & 3) << 2).
template <int T, int DH>
__device__ __forceinline__ int row_chunk(int p, int t, int c) {
  return (p * T + t) * DH + ((c ^ ((p & 3) << 2)) << 2);
}

// Same function and layouts as jet_softmax_values_planes_kernel.  Persistent: block b
// takes items b, b + gridDim.x, ... of the batch * H (walker, head) pairs.
template <int T, int DH, int C, int E>
__global__ void __launch_bounds__(THREADS, 1) jet_softmax_values_tiled_kernel(
    const float* __restrict__ qkv, float* __restrict__ attn, int64_t batch, int H) {
  using S_ = Shape<T, DH, C, E>;
  constexpr int P = S_::P, LAP = S_::LAP, TT = S_::TT, CHUNKS = S_::CHUNKS;
  extern __shared__ __align__(16) float tiled_smem[];
  float* partial = tiled_smem + 2 * S_::STAGE;  // [PAIRS][SLICES][T][T]
  float* G = partial + S_::PARTIAL;             // logits jet      [P][T][T]
  float* X = G + S_::JET;                       // exponential jet [P][T][T]
  float* W = X + S_::JET;                       // weights jet     [P][T][T]
  float* S = W + S_::JET;                       // sum jet         [P][T]
  float* R = S + P * T;                         // reciprocal jet  [P][T]
  const int tid = threadIdx.x;
  const int D = H * DH;
  const int64_t items = batch * H;

  auto load = [&](int64_t item, float* stage) {
    if (item < items) {
      const int64_t b = item / H;
      const int h = static_cast<int>(item % H);
      const uint32_t dst0 = smem_address(stage);
      for (int i = tid; i < 3 * P * T * CHUNKS; i += THREADS) {
        const int c = i % CHUNKS, r = (i / CHUNKS) % (P * T), m = i / (CHUNKS * P * T);
        const int p = r / T, t = r % T;
        const float* src =
            qkv + ((static_cast<int64_t>(p) * batch + b) * T + t) * 3 * D + m * D + h * DH + c * 4;
        cp_async16(dst0 + 4 * (m * S_::MAT + row_chunk<T, DH>(p, t, c)), src);
      }
    }
    cp_async_commit();
  };

  // The l plane's cross terms are the longest items of the small phases; it is
  // taken last, in the round that only part of the block works in.
  auto plane_of = [](int order) {
    return order == S_::P - 1 ? C + 1 : (order > C ? order + 1 : order);
  };

  int buf = 0;
  load(blockIdx.x, tiled_smem);
  for (int64_t item = blockIdx.x; item < items; item += gridDim.x, buf ^= 1) {
    float* qs = tiled_smem + buf * S_::STAGE;
    float* ks = qs + S_::MAT;
    float* vs = ks + S_::MAT;
    load(item + gridDim.x, tiled_smem + (buf ^ 1) * S_::STAGE);
    cp_async_wait<1>();
    __syncthreads();

    // Partial logits: the T x T block of one plane pair over a quarter of dh,
    // chunks slice, slice + 4, slice + 8, slice + 12.
    if (tid < S_::PAIRS * S_::SLICES) {
      const int pair = tid >> 2, slice = tid & 3;
      int pq, pk;
      if (pair < P) {
        pq = pair, pk = 0;
      } else if (pair < 2 * P - 1) {
        pq = 0, pk = pair - P + 1;
      } else {
        pq = pk = pair - (2 * P - 1) + 1;
      }
      float acc[T][T];
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int s = 0; s < T; ++s) acc[t][s] = 0.f;
#pragma unroll
      for (int j = 0; j < CHUNKS / S_::SLICES; ++j) {
        const int c = j * S_::SLICES + slice;
        float4 q[T];
#pragma unroll
        for (int t = 0; t < T; ++t) q[t] = ld4(qs + row_chunk<T, DH>(pq, t, c));
#pragma unroll
        for (int s = 0; s < T; ++s) {
          const float4 k = ld4(ks + row_chunk<T, DH>(pk, s, c));
#pragma unroll
          for (int t = 0; t < T; ++t) {
            acc[t][s] = fmaf(q[t].x, k.x, acc[t][s]);
            acc[t][s] = fmaf(q[t].y, k.y, acc[t][s]);
            acc[t][s] = fmaf(q[t].z, k.z, acc[t][s]);
            acc[t][s] = fmaf(q[t].w, k.w, acc[t][s]);
          }
        }
      }
      float* out = partial + tid * TT;
#pragma unroll
      for (int i = 0; i < TT; i += 4) {
        *reinterpret_cast<float4*>(out + i) =
            make_float4(acc[i / T][i % T], acc[(i + 1) / T][(i + 1) % T],
                        acc[(i + 2) / T][(i + 2) % T], acc[(i + 3) / T][(i + 3) % T]);
      }
    }
    __syncthreads();

    // Logits jet: product rule plus the cross term, from the partial blocks.
    auto pair_sum = [&](int pair, int ts) {
      const float* src = partial + pair * S_::SLICES * TT + ts;
      return (src[0] + src[TT]) + (src[2 * TT] + src[3 * TT]);
    };
    for (int i = tid; i < P * TT; i += THREADS) {
      const int p = plane_of(i / TT), ts = i % TT;
      float g = pair_sum(p, ts);
      if (p > 0) g += pair_sum(P + p - 1, ts);
      if (p == C + 1) {
        float cross = 0.f;
#pragma unroll
        for (int k = 0; k < LAP; ++k) cross += pair_sum(2 * P - 1 + k, ts);
        g += 2.f * cross;
      } else if (p > C + 1) {
        g += 2.f * pair_sum(2 * P - 1 + LAP + (p - C - 2), ts);
      }
      G[p * TT + ts] = g;
    }
    __syncthreads();

    // exp jet of the max-shifted logits (the shift is a constant and cancels).
    for (int i = tid; i < P * TT; i += THREADS) {
      const int p = plane_of(i / TT), ts = i % TT, t = ts / T;
      float c0 = G[t * T];
#pragma unroll
      for (int s = 1; s < T; ++s) c0 = fmaxf(c0, G[t * T + s]);
      const float ex = expf(G[ts] - c0);
      float x;
      if (p == 0) {
        x = ex;
      } else if (p <= C) {
        x = ex * G[p * TT + ts];
      } else if (p == C + 1) {
        float jsq = 0.f;
#pragma unroll
        for (int k = 0; k < LAP; ++k) jsq += G[(1 + k) * TT + ts] * G[(1 + k) * TT + ts];
        x = ex * (G[p * TT + ts] + jsq);
      } else {
        const float gj = G[(1 + LAP + p - C - 2) * TT + ts];
        x = ex * (G[p * TT + ts] + gj * gj);
      }
      X[p * TT + ts] = x;
    }
    __syncthreads();

    // Sum over the sources.
    for (int i = tid; i < P * T; i += THREADS) {
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < T; ++s) acc += X[i * T + s];
      S[i] = acc;
    }
    __syncthreads();

    // Reciprocal jet: f1 = -1/s^2, f2 = 2/s^3.
    for (int i = tid; i < P * T; i += THREADS) {
      const int p = i / T, t = i % T;
      const float rx = 1.f / S[t];
      const float rx2 = rx * rx, rx3 = rx2 * rx;
      float r;
      if (p == 0) {
        r = rx;
      } else if (p <= C) {
        r = -S[i] * rx2;
      } else if (p == C + 1) {
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < LAP; ++k) sq += S[(1 + k) * T + t] * S[(1 + k) * T + t];
        r = -S[i] * rx2 + 2.f * rx3 * sq;
      } else {
        const float sj = S[(1 + LAP + p - C - 2) * T + t];
        r = -S[i] * rx2 + 2.f * rx3 * sj * sj;
      }
      R[i] = r;
    }
    __syncthreads();

    // Weights jet w = e * r (product rule with the cross term).
    for (int i = tid; i < P * TT; i += THREADS) {
      const int p = plane_of(i / TT), ts = i % TT, t = ts / T;
      float w = X[p * TT + ts] * R[t];
      if (p > 0) w += X[ts] * R[p * T + t];
      if (p == C + 1) {
        float cross = 0.f;
#pragma unroll
        for (int k = 0; k < LAP; ++k) cross += X[(1 + k) * TT + ts] * R[(1 + k) * T + t];
        w += 2.f * cross;
      } else if (p > C + 1) {
        const int k = 1 + LAP + (p - C - 2);
        w += 2.f * X[k * TT + ts] * R[k * T + t];
      }
      W[p * TT + ts] = w;
    }
    __syncthreads();

    // Channel-diagonal value products sum_s w_k[t, s] v_k[s, :], summed over a
    // quarter of the Laplacian tangents (groups 0..3) or for one extra tangent.
    // q is no longer read: the sums take its place, [GROUPS][T][DH].
    float* cross_sums = qs;
    if (tid < S_::GROUPS * CHUNKS) {
      const int g = tid / CHUNKS, c = tid % CHUNKS;
      const int first = g < 4 ? 1 + g * (LAP / 4) : 1 + LAP + (g - 4);
      const int count = g < 4 ? LAP / 4 : 1;
      float4 acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int n = 0; n < count; ++n) {
        const int p = first + n;
#pragma unroll
        for (int s = 0; s < T; ++s) {
          const float4 v = ld4(vs + row_chunk<T, DH>(p, s, c));
#pragma unroll
          for (int t = 0; t < T; ++t) fma4(acc[t], W[p * TT + t * T + s], v);
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t)
        *reinterpret_cast<float4*>(cross_sums + (g * T + t) * DH + c * 4) = acc[t];
    }
    __syncthreads();

    // Value contraction jet, written to attn[p, b, t, h*dh + 4c .. 4c+3].
    if (tid < P * CHUNKS) {
      const int p = tid / CHUNKS, c = tid % CHUNKS;
      float4 acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < T; ++s) {
        const float4 v0 = ld4(vs + row_chunk<T, DH>(0, s, c));
#pragma unroll
        for (int t = 0; t < T; ++t) fma4(acc[t], W[p * TT + t * T + s], v0);
      }
      if (p > 0) {
#pragma unroll
        for (int s = 0; s < T; ++s) {
          const float4 vp = ld4(vs + row_chunk<T, DH>(p, s, c));
#pragma unroll
          for (int t = 0; t < T; ++t) fma4(acc[t], W[t * T + s], vp);
        }
      }
      if (p == C + 1) {
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int t = 0; t < T; ++t) fma4(acc[t], 2.f, ld4(cross_sums + (g * T + t) * DH + c * 4));
      } else if (p > C + 1) {
        const int g = 4 + (p - C - 2);
#pragma unroll
        for (int t = 0; t < T; ++t) fma4(acc[t], 2.f, ld4(cross_sums + (g * T + t) * DH + c * 4));
      }
      const int64_t b = item / H;
      const int h = static_cast<int>(item % H);
      float* dst = attn + (static_cast<int64_t>(p) * batch + b) * T * D + h * DH + c * 4;
#pragma unroll
      for (int t = 0; t < T; ++t) *reinterpret_cast<float4*>(dst + t * D) = acc[t];
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

template <int T, int DH, int C, int E>
cudaError_t launch_tiled(const float* qkv, float* attn, int64_t batch, int heads,
                         cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * Shape<T, DH, C, E>::SMEM_FLOATS;
  auto kernel = jet_softmax_values_tiled_kernel<T, DH, C, E>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t items = batch * heads;
  kernel<<<static_cast<unsigned>(items < sms ? items : sms), THREADS, smem, stream>>>(
      qkv, attn, batch, heads);
  return cudaGetLastError();
}

}  // namespace sv

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

// The same product on the tensor cores (three TF32 products per term).  whi, wlo:
// [n, k], the TF32-rounded halves of B^T.  Takes k % 32 == 0, n % 128 == 0 and
// 16-byte aligned a, whi, wlo, bias, c; refuses anything else.
extern "C" int jet_gemm_tf32x3(const float* a, const float* whi, const float* wlo,
                               const float* bias, float* c, int64_t m, int n, int k,
                               int64_t bias_rows, void* stream) {
  return tc::launch(a, whi, wlo, bias, c, m, n, k, bias_rows, static_cast<cudaStream_t>(stream));
}

// Logits, softmax and value-contraction jets of every (walker, head), at any
// shape whose planes layout fits the card's shared memory (the caller checks
// first: ops/jet_attention.py:check_softmax_values_shape).
// qkv: [planes, batch, tokens, 3 * feat]; attn: [planes, batch, tokens, feat].
extern "C" int jet_softmax_values_f32(const float* qkv, float* attn, int planes,
                                      int64_t batch, int tokens, int feat, int heads,
                                      int c, int e, void* stream) {
  if (heads <= 0 || feat % heads != 0 || e < 1 || c < e || planes != c + e + 2 ||
      batch <= 0 || tokens <= 0 || tokens > 1024 || planes > 1024 ||
      batch * heads > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * sv_planes::layout(planes, tokens, feat / heads, e).total;
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sv_planes::jet_softmax_values_planes_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sv_planes::jet_softmax_values_planes_kernel<<<static_cast<unsigned>(batch * heads),
                                             sv_planes::THREADS, smem,
                                             static_cast<cudaStream_t>(stream)>>>(
      qkv, attn, planes, batch, tokens, feat, heads, c, e);
  return static_cast<int>(cudaGetLastError());
}

// The same function at the shapes compiled in: tokens 6, head width 64 and
// (c, e) = (15, 3) or (13, 1), 16-byte aligned qkv and attn; refuses anything else.
extern "C" int jet_softmax_values_tiled_f32(const float* qkv, float* attn, int planes,
                                            int64_t batch, int tokens, int feat, int heads,
                                            int c, int e, void* stream) {
  if (heads <= 0 || feat != heads * 64 || tokens != 6 || planes != c + e + 2 || batch <= 0 ||
      batch * heads > 0x7fffffff || reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(attn) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 15 && e == 3) return static_cast<int>(sv::launch_tiled<6, 64, 15, 3>(qkv, attn, batch, heads, s));
  if (c == 13 && e == 1) return static_cast<int>(sv::launch_tiled<6, 64, 13, 1>(qkv, attn, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
