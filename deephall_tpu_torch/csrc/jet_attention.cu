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
//   2. jet_softmax_values: the logits jet, the softmax jet and the
//      value-contraction jet of each (walker, head) from that head's q, k, v
//      slices, staged in shared memory;
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
// jet_softmax_values at every other shape (jet_softmax_values_streamed_kernel,
// run-time T, dh, C and E).  Keeping q, k, v of every plane resident (3 P T dh
// floats) passes the card's 227 KB at N = 10 with L^2, and the tiled kernel's
// two stages of them at N = 8.  But a tangent plane p needs only its own q,
// k, v and the primal's: G_p = q_p k0^T + q0 k_p^T, X_p = X0 G_p, S_p, R_p =
// -S_p R0^2, W_p = X_p R0 + X0 R_p, out_p = W_p v0 + W0 v_p; the Laplacian
// and extra planes need besides only sums over their tangents of q_k k_k^T,
// G_k^2, S_k^2, X_k R_k and W_k v_k, which each tangent adds as it passes.
// So the planes are streamed once, the primal first, then the Laplacian
// tangents, the Laplacian, and each extra tangent followed by its second
// derivative (two slots then hold every cross term), and q, k, v of each
// are read exactly once.  What bounds it: in principle bytes (3 reads and a
// write of each plane element; the arithmetic is 6 T dh FMAs a tangent row,
// 35% of the byte time at N = 10, 57% at N = 16), in practice the
// instruction throughput of the products and of their 16-byte shared-memory
// loads (a warp's costs 4 shared-memory cycles whatever the lanes read), so
// the design raises the FMAs a load feeds and the work between barriers.
//   Items are (walker, group of heads), every head where two stages fit
// (then one plane of an item is T contiguous rows of 3D floats).  One
// persistent block an SM takes a run of consecutive items: a producer warp
// copies each plane's rows by 1-D bulk asynchronous copies (the Tensor Memory
// Accelerator) into a ring of up to 4 stages with a "full" and an "empty"
// mbarrier each, while 256 or 320 computing threads (the fewest that
// give each a unit of the value contraction) take every plane in order, so a
// wait by parity is right at any ring length.  The primal's stage is copied
// aside at the item's start.  A plane takes three phases between two
// barriers: the logits (a thread owns a 4x2 tile, 4x4 where T is a multiple
// of 4 from 12, of (query, source) over a quarter of dh; the four lanes add
// their parts by a reduce-scatter), the softmax (four or eight lanes a
// query row) and the value contraction (two or four query rows of one
// 16-byte feature chunk).  With three stages or more the Laplacian tangents
// go two a step: a thread computes the same tile of both planes, which share
// the primal's loads, and adds both into slot 0 in plane order; every cross
// sum has one owner.  Units are decoded by multiply-high divisions whose
// constants are kernel parameters.  Rows are padded to 4 banks apart, so
// eight lanes' 16-byte reads of eight rows do not collide.  No tensor cores: the products
// are T x T x dh with T = 8-25, far below a wgmma tile, and float32 products
// would need the GEMM's three TF32 products.  Fields off the 16-byte grid, or
// dh % 4 != 0, are copied float by float by the producer warp and stored
// float by float.
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

// ---- jet_softmax_values at any shape: planes streamed through a ring ------------

namespace sv_streamed {

constexpr int kMaxStages = 4;
constexpr int kSlices = 4;  // lanes a tile of logits splits dh over
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
// The computing threads a block may have (besides its producer warp); the
// plan takes the fewest that give each a unit of the value contraction.
constexpr int kWidths[2] = {256, 320};

// The block's dynamic shared memory, addressed by offsets (32-bit shared addresses).
extern __shared__ __align__(16) float sv_smem[];

// What a probe build leaves out; kWhole is the kernel.
enum Probe { kWhole = 0, kNoStore = 1, kNoMath = 2 };

// Division of 0 <= x < 2^31 by a run-time d >= 1 as (umulhi(x, m) + x) >> s,
// s = ceil(log2 d), m = floor(2^32 (2^s - d) / d) + 1: two instructions
// instead of a division's twenty.  The kernel reads these from its parameters.
struct FastDiv {
  uint32_t m, s;
};

inline FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  return {static_cast<uint32_t>((1ull << 32) * ((1ull << s) - d) / d + 1), s};
}

__device__ __forceinline__ int fdiv(int x, const FastDiv& f) {
  return static_cast<int>((__umulhi(static_cast<uint32_t>(x), f.m) + static_cast<uint32_t>(x)) >> f.s);
}

struct Args {
  const float* qkv;
  float* attn;
  int64_t batch;
  int tokens, feat, heads, c, e;
  int group;      // heads of one item
  int stages;     // planes in the ring
  int row_lanes;  // lanes of one softmax row: 4 or 8
  int wide;       // 4x4 logits tiles and four-row value units (else 4x2 and two rows)
  // Divisors of the units' decoding: T, tile rows, tile columns (4x2, 4x4),
  // 16-byte chunks of dh, value row blocks (two, four rows), stages.
  FastDiv by_tokens, by_rows, by_cols2, by_cols4, by_chunks, by_blocks2, by_blocks4, by_stages;
};

// Offsets in floats of a block's shared memory.  A stage holds one plane of
// one item: T rows (rounded up to tp, a multiple of 4) of the group's q, k
// and v, [q | k | v] of group * dhp floats each (dhp: dh rounded up to 4), at
// a row stride ldr = 4 (mod 8) floats, so that eight lanes' 16-byte loads of
// eight rows fall on distinct banks.  Rows past T and columns past dh stay
// zero.  The primal's stage is copied once an item, and the ring follows.
// Per head of the group: the logits G and the weights W of two planes
// [2][tp][tp] (a pair of Laplacian tangents; one plane uses the first), the
// primal's exponential X0 and weights W0 [tp][tp], its reciprocal R0 [tp].
// Two slots of cross terms (0: summed over the Laplacian tangents, 1: the
// extra tangent whose second derivative comes next), per head: sum q_k k_k,
// sum G_k^2 and sum X_k R_k [tp][tp], sum S_k^2 [tp], sum W_k v_k [tp][dhp].
// Then a full and an empty mbarrier for each stage.
// ops/jet_attention.py:softmax_values_smem mirrors this sum.
struct Layout {
  int64_t tp, dhp, gw, ldr, stage;
  int64_t ring, g, w, x0, w0, r0, cg, sg, cxr, ss, cwv, floats, bytes;
};

__host__ __device__ inline Layout layout(int64_t T, int64_t dh, int64_t group, int64_t stages) {
  Layout a;
  a.tp = (T + 3) / 4 * 4;
  a.dhp = (dh + 3) / 4 * 4;
  a.gw = group * a.dhp;
  a.ldr = 3 * a.gw % 8 == 0 ? 3 * a.gw + 4 : 3 * a.gw;
  a.stage = a.tp * a.ldr;
  const int64_t tt = a.tp * a.tp;
  a.ring = a.stage;
  a.g = a.ring + stages * a.stage;
  a.w = a.g + 2 * group * tt;
  a.x0 = a.w + 2 * group * tt;
  a.w0 = a.x0 + group * tt;
  a.r0 = a.w0 + group * tt;
  a.cg = a.r0 + group * a.tp;
  a.sg = a.cg + 2 * group * tt;
  a.cxr = a.sg + 2 * group * tt;
  a.ss = a.cxr + 2 * group * tt;
  a.cwv = a.ss + 2 * group * a.tp;
  a.floats = a.cwv + 2 * group * a.tp * a.dhp;
  a.bytes = 4 * a.floats + 16 * stages;
  return a;
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_address(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_address(bar)) : "memory");
}

// The one arrival of a phase, with the bytes its copies will bring.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_address(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_address(bar)), "r"(parity) : "memory");
}

// `bytes` from global `src` to shared `dst`, completing on `bar`; both 16-byte aligned.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(smem_address(bar)) : "memory");
}

// The barrier of the NC computing threads (the producer warp does not take part).
template <int NC>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NC) : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void put4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x), acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z), acc.w = fmaf(w, v.w, acc.w);
}

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Features f .. f + 3 of an output row: one 16-byte store, or those below dh.
template <bool VEC>
__device__ __forceinline__ void store4(float* row, int f, int dh, const float4& v) {
  if constexpr (VEC) {
    __stcs(reinterpret_cast<float4*>(row + f), v);
  } else {
    if (f < dh) row[f] = v.x;
    if (f + 1 < dh) row[f + 1] = v.y;
    if (f + 2 < dh) row[f + 2] = v.z;
    if (f + 3 < dh) row[f + 3] = v.w;
  }
}

// The planes of one item as NC computing threads see them.  KIND 0 is the
// primal, 1 a tangent j_k, 2 the Laplacian or an extra second derivative;
// `cs` is the slot of cross terms a tangent sets (`assign`) or adds to, or a
// second-order plane reads.  [tp][tp] arrays of head j start at j * tp^2.
template <int NC>
struct Planes {
  // Offsets in sv_smem: the primal's stage (copied at the item's start), the
  // logits G and weights W of the step's planes, X0, W0, R0 and the slots.
  int prim_, g_, w_, x0_, w0_, r0_, cg_, sg_, cxr_, ss_, cwv_;
  int T, tp, ldr, gw, dhp, dh, group, row_lanes;
  const Args* args;  // the kernel's parameters (its divisors)

  // G = q_p k0^T + q0 k_p^T (the primal: q0 k0^T; a second-order plane adds
  // 2 sum q_k k_k), and for a tangent q_p k_p^T and G^2 into its slot, of NP
  // planes at once (NP = 2: two Laplacian tangents, which share the primal's
  // loads and add into slot 0 in plane order).  A unit is a 4 x TC tile of
  // (query, source) of one head; its four lanes take the 16-byte chunks r,
  // r + 4, ... of dh and add their parts by a reduce-scatter, after which each
  // writes a quarter of the tile's sums: for a tangent, lanes 0 and 1 rows
  // 0-1 and 2-3 of G, lanes 2 and 3 those of q_p k_p^T, of every plane, so
  // that one lane owns each element of the slot.
  template <int KIND, int TC, int NP>
  __device__ __forceinline__ void logits(const float* st0, const float* st1, int cs, bool assign,
                                         int tid) const {
    const float* prim = sv_smem + prim_;
    float *G = sv_smem + g_, *W = sv_smem + w_, *X0 = sv_smem + x0_, *W0 = sv_smem + w0_;
    float *R0 = sv_smem + r0_, *CG = sv_smem + cg_, *SG = sv_smem + sg_, *CXR = sv_smem + cxr_;
    float *SS = sv_smem + ss_, *CWV = sv_smem + cwv_;
    static_assert(NP == 1 || KIND == 1, "two planes at once are tangents");
    const int tt = tp * tp, rows = (T + 3) / 4, cols = (T + TC - 1) / TC;
    const int units = group * rows * cols * kSlices;
    constexpr int M = 4 * TC;                     // sums of G in the tile, a plane
    constexpr int N = (KIND == 1 ? 2 : 1) * M * NP;  // and of q_p k_p^T
    constexpr int Q = N / 4;                      // sums a lane keeps
    // Where (plane, row i, column c) of G (or of q_p k_p^T, + N / 2) sits in val.
    const auto at = [](int pl, int i, int c) {
      return KIND == 1 ? i / 2 * Q + pl * 2 * TC + i % 2 * TC + c : i * TC + c;
    };
#pragma unroll 1
    for (int u0 = 0; u0 < units; u0 += NC) {
      const int u = u0 + tid;
      const int v = u < units ? u : 0;
      const int r = v % kSlices, tile = v / kSlices;
      const int q1 = fdiv(tile, TC == 4 ? args->by_cols4 : args->by_cols2);
      const int j = fdiv(q1, args->by_rows);
      const int s0 = TC * (tile - q1 * cols), t0 = 4 * (q1 - j * rows);
      const int qo = t0 * ldr + j * dhp, ko = gw + s0 * ldr + j * dhp;
      const float* q0 = (KIND == 0 ? st0 : prim) + qo;
      const float* k0 = (KIND == 0 ? st0 : prim) + ko;
      float val[N] = {};
      for (int f = 4 * r; f < dhp; f += 4 * kSlices) {
        float4 qp[NP][4], kx[TC];
#pragma unroll
        for (int c = 0; c < TC; ++c) kx[c] = load4(k0 + c * ldr + f);
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
          for (int i = 0; i < 4; ++i) qp[pl][i] = load4((pl ? st1 : st0) + qo + i * ldr + f);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < TC; ++c) val[at(pl, i, c)] = dot4(qp[pl][i], kx[c], val[at(pl, i, c)]);
        }
        if constexpr (KIND != 0) {
          float4 qx[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) qx[i] = load4(q0 + i * ldr + f);
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
#pragma unroll
            for (int c = 0; c < TC; ++c) kx[c] = load4((pl ? st1 : st0) + ko + c * ldr + f);  // k_p
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int c = 0; c < TC; ++c) {
                val[at(pl, i, c)] = dot4(qx[i], kx[c], val[at(pl, i, c)]);
                if constexpr (KIND == 1) val[N / 2 + at(pl, i, c)] = dot4(qp[pl][i], kx[c], val[N / 2 + at(pl, i, c)]);
              }
          }
        }
      }
      // Reduce-scatter over lanes r ^ 2, then r ^ 1: lane r keeps sums [r Q, (r + 1) Q).
      float half[N / 2], quarter[Q];
      const bool up = (r & 2) != 0, right = (r & 1) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? val[i] : val[i + N / 2];
        half[i] = (up ? val[i + N / 2] : val[i]) + __shfl_xor_sync(kFull, send, 2);
      }
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const float send = right ? half[i] : half[i + Q];
        quarter[i] = (right ? half[i + Q] : half[i]) + __shfl_xor_sync(kFull, send, 1);
      }
      if (u >= units) continue;
      float* cg = CG + (cs * group + j) * tt;
      float* sg = SG + (cs * group + j) * tt;
#pragma unroll
      for (int k = 0; k < Q; ++k) {
        // Sum k of lane r: its plane, row and column in the tile.
        const int pl = KIND == 1 ? k / (2 * TC) : 0;
        const int i = KIND == 1 ? 2 * (r % 2) + k % (2 * TC) / TC : r;
        const int e = (t0 + i) * tp + s0 + k % TC;
        float* g = G + pl * group * tt + j * tt;
        const float x = quarter[k];
        if constexpr (KIND == 0) {
          g[e] = x;
          cg[e] = sg[e] = 0.f;
        } else if constexpr (KIND == 1) {
          if (r < 2) {
            g[e] = x;
            sg[e] = assign ? x * x : fmaf(x, x, sg[e]);
          } else {
            cg[e] = assign ? x : cg[e] + x;
          }
        } else {
          g[e] = fmaf(2.f, cg[e], x);
        }
      }
    }
  }

  // The exponential, sum, reciprocal and weights jets of one query row of one
  // head, of NP planes in turn; `row_lanes` lanes share a row, lane r taking
  // sources r, r + row_lanes, ...  The primal shifts by its row maximum (a
  // constant that cancels).
  //   tangent:  X = X0 G, S = sum X, R = -S R0^2, W = X R0 + X0 R; X R and
  //             S^2 into its slot;
  //   second:   X = X0 (G + sum G_k^2), R = -S R0^2 + 2 R0^3 sum S_k^2,
  //             W = X R0 + X0 R + 2 sum X_k R_k.
  template <int KIND, int NP>
  __device__ __forceinline__ void softmax(int cs, bool assign, int tid, int lane) const {
    const float* prim = sv_smem + prim_;
    float *G = sv_smem + g_, *W = sv_smem + w_, *X0 = sv_smem + x0_, *W0 = sv_smem + w0_;
    float *R0 = sv_smem + r0_, *CG = sv_smem + cg_, *SG = sv_smem + sg_, *CXR = sv_smem + cxr_;
    float *SS = sv_smem + ss_, *CWV = sv_smem + cwv_;
    const int tt = tp * tp, rl = row_lanes;
    const unsigned mask = ((1u << rl) - 1) << (lane & ~(rl - 1));
    for (int u = tid; u < group * T * rl; u += NC) {
      const int row = u >> (rl == 8 ? 3 : 2), r = u & (rl - 1);
      const int j = fdiv(row, args->by_tokens), t = row - j * T;
      const int o = j * tt + t * tp;
      float* cxr = CXR + cs * group * tt + o;
      float* ss = SS + (cs * group + j) * tp + t;
      if constexpr (KIND == 0) {
        float m = -__int_as_float(0x7f800000);
        for (int s = r; s < T; s += rl) m = fmaxf(m, G[o + s]);
        for (int d = 1; d < rl; d <<= 1) m = fmaxf(m, __shfl_xor_sync(mask, m, d));
        float sum = 0.f;
        for (int s = r; s < T; s += rl) {
          const float ex = expf(G[o + s] - m);
          X0[o + s] = ex;
          sum += ex;
        }
        for (int d = 1; d < rl; d <<= 1) sum += __shfl_xor_sync(mask, sum, d);
        const float rx = 1.f / sum;
        for (int s = r; s < T; s += rl) {
          W0[o + s] = X0[o + s] * rx;
          cxr[s] = 0.f;
        }
        if (r == 0) R0[j * tp + t] = rx, *ss = 0.f;
      } else {
        // The NP planes in lockstep, each cross sum taking them in plane order.
        const float rx = R0[j * tp + t], rx2 = rx * rx;
        const float* sg = SG + cs * group * tt + o;
        const auto expo = [&](int pl, int s) {
          const float g = G[pl * group * tt + o + s];
          return X0[o + s] * (KIND == 2 ? g + sg[s] : g);
        };
        float sum[NP], rp[NP];
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) sum[pl] = 0.f;
        for (int s = r; s < T; s += rl) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) sum[pl] += expo(pl, s);
        }
        for (int d = 1; d < rl; d <<= 1) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) sum[pl] += __shfl_xor_sync(mask, sum[pl], d);
        }
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) {
          rp[pl] = -sum[pl] * rx2;
          if constexpr (KIND == 2) rp[pl] = fmaf(2.f * rx2 * rx, *ss, rp[pl]);
        }
        for (int s = r; s < T; s += rl) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
            const float x = expo(pl, s);
            float wv = fmaf(x, rx, X0[o + s] * rp[pl]);
            if constexpr (KIND == 1) {
              cxr[s] = assign ? x * rp[pl] : fmaf(x, rp[pl], cxr[s]);
            } else {
              wv = fmaf(2.f, cxr[s], wv);
            }
            W[pl * group * tt + o + s] = wv;
          }
        }
        if (KIND == 1 && r == 0) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) *ss = assign ? sum[pl] * sum[pl] : fmaf(sum[pl], sum[pl], *ss);
        }
      }
    }
  }

  // O = W v0 + W0 v_p (the primal: W0 v0), plus 2 sum W_k v_k for a
  // second-order plane; a tangent's W v_p into its slot, of NP planes at
  // once (sharing the loads of v0 and W0).  A unit is RV query rows of one
  // head and one 16-byte chunk of its features; W is read as float4 along the
  // sources (zero past T, as are the rows of v).
  template <int KIND, bool VEC, int RV, int NP>
  __device__ __forceinline__ void values(const float* st0, const float* st1, int cs, bool assign,
                                         float* out0, float* out1, int64_t D, bool store,
                                         int tid) const {
    const float* prim = sv_smem + prim_;
    float *G = sv_smem + g_, *W = sv_smem + w_, *X0 = sv_smem + x0_, *W0 = sv_smem + w0_;
    float *R0 = sv_smem + r0_, *CG = sv_smem + cg_, *SG = sv_smem + sg_, *CXR = sv_smem + cxr_;
    float *SS = sv_smem + ss_, *CWV = sv_smem + cwv_;
    const int tt = tp * tp, nch = dhp / 4, blocks = (T + RV - 1) / RV;
    const int units = group * blocks * nch;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
    for (int u = tid; u < units; u += NC) {
      const int q1 = fdiv(u, args->by_chunks);
      const int j = fdiv(q1, RV == 4 ? args->by_blocks4 : args->by_blocks2);
      const int f = 4 * (u - q1 * nch), t0 = RV * (q1 - j * blocks);
      const int wo = j * tt + t0 * tp, vo = 2 * gw + j * dhp + f;
      const float* v0 = (KIND == 0 ? st0 : prim) + vo;
      float4 o[NP][RV], x[RV];
#pragma unroll
      for (int i = 0; i < RV; ++i) {
        x[i] = zero;
#pragma unroll
        for (int pl = 0; pl < NP; ++pl) o[pl][i] = zero;
      }
      for (int s4 = 0; s4 < tp; s4 += 4) {
        float4 w0[RV], wp[NP][RV];
#pragma unroll
        for (int i = 0; i < RV; ++i) {
          w0[i] = load4(W0 + wo + i * tp + s4);
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) {
            if constexpr (KIND != 0) wp[pl][i] = load4(W + pl * group * tt + wo + i * tp + s4);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = s4 + k;
          const float4 vx = load4(v0 + s * ldr);
          if constexpr (KIND == 0) {
#pragma unroll
            for (int i = 0; i < RV; ++i) axpy4(o[0][i], part(w0[i], k), vx);
          } else {
#pragma unroll
            for (int pl = 0; pl < NP; ++pl) {
              const float4 vy = load4((pl ? st1 : st0) + vo + s * ldr);
#pragma unroll
              for (int i = 0; i < RV; ++i) {
                axpy4(o[pl][i], part(wp[pl][i], k), vx);
                axpy4(o[pl][i], part(w0[i], k), vy);
                if constexpr (KIND == 1) axpy4(x[i], part(wp[pl][i], k), vy);
              }
            }
          }
        }
      }
      float* cw = CWV + ((cs * group + j) * tp + t0) * dhp + f;
#pragma unroll
      for (int i = 0; i < RV; ++i) {
        float* c = cw + i * dhp;
        if constexpr (KIND == 0) {
          put4(c, zero);
        } else if constexpr (KIND == 1) {
          if (!assign) {
            const float4 c0 = load4(c);
            x[i].x += c0.x, x[i].y += c0.y, x[i].z += c0.z, x[i].w += c0.w;
          }
          put4(c, x[i]);
        } else {
          axpy4(o[0][i], 2.f, load4(c));
        }
        if (store && t0 + i < T) {
#pragma unroll
          for (int pl = 0; pl < NP; ++pl) store4<VEC>((pl ? out1 : out0) + (t0 + i) * D + j * dh, f, dh, o[pl][i]);
        }
      }
    }
  }
};

// Persistent: block b takes a run of consecutive items of the batch * heads /
// group (walker, group of heads) pairs and streams each item's planes through
// the ring: the primal, the Laplacian tangents, the Laplacian, then each extra
// tangent followed by its second derivative, so that two slots hold every
// cross term.  qkv: [P, B, T, 3D] (q | k | v along the last axis); attn:
// [P, B, T, D].  VEC: 16-byte aligned qkv and attn with dh % 4 == 0, whose
// rows arrive by bulk copies (one of 3D floats a row where the group is every
// head); otherwise the producer warp copies them float by float and the
// outputs go out as floats.
template <bool VEC, int PROBE, int NC>
__global__ void __launch_bounds__(NC + 32, 1)
    jet_softmax_values_streamed_kernel(const __grid_constant__ Args a) {
  float* const smem = sv_smem;
  const int T = a.tokens, D = a.feat, H = a.heads, C = a.c, E = a.e;
  const int NG = a.group, S = a.stages;
  const int dh = D / H, P = C + E + 2, lap = C - E;
  const Layout L = layout(T, dh, NG, S);
  const int ldr = static_cast<int>(L.ldr), gw = static_cast<int>(L.gw), dhp = static_cast<int>(L.dhp);
  const int64_t batch = a.batch, groups = H / NG, items = batch * groups;
  const int64_t row3 = 3 * static_cast<int64_t>(D);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.floats);  // [S]
  uint64_t* empty = full + S;                                     // [S]
  const int tid = threadIdx.x, lane = tid & 31;
  // This block's items: a run of consecutive ones.
  const int64_t per = items / gridDim.x, spare = items % gridDim.x;
  const int64_t first = blockIdx.x * per + (blockIdx.x < spare ? blockIdx.x : spare);
  const int64_t last = first + per + (blockIdx.x < spare);
  // The plane of the o-th place in an item's order.
  const auto plane_at = [&](int o) {
    if (o <= lap) return o;
    if (o == lap + 1) return C + 1;
    const int q = (o - lap - 2) / 2;
    return (o - lap - 2) % 2 == 0 ? 1 + lap + q : C + 2 + q;
  };

  for (int64_t i = tid; i < L.floats; i += NC + 32) smem[i] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The zeros land before any bulk copy writes the same stages.
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  if (tid >= NC) {
    // The producer: the n-th plane of this block goes to stage n % S once the
    // computing warps have left the stage's previous round.
    int64_t n = 0;
    for (int64_t item = first; item < last; ++item) {
      const int64_t b = item / groups;
      const int h0 = static_cast<int>(item % groups) * NG;
      for (int o = 0; o < P; ++o, ++n) {
        const int slot = static_cast<int>(n % S);
        const int64_t round = n / S;
        if (round > 0) {
          bar_wait(empty + slot, static_cast<uint32_t>((round - 1) & 1));
          if constexpr (VEC) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        float* dst = smem + L.ring + slot * L.stage;
        const float* src = a.qkv + (static_cast<int64_t>(plane_at(o)) * batch + b) * T * row3 + h0 * dh;
        if constexpr (VEC) {
          if (lane == 0) bar_expect(full + slot, static_cast<uint32_t>(3 * T * NG * dh * 4));
          __syncwarp();
          if (NG == H) {  // q, k and v of every head: one piece a row
            for (int t = lane; t < T; t += 32) bulk_load(dst + t * ldr, src + t * row3, 12 * D, full + slot);
          } else {
            for (int i = lane; i < 3 * T; i += 32) {
              const int m = i / T, t = i % T;
              bulk_load(dst + t * ldr + m * gw, src + t * row3 + m * D, 4 * NG * dh, full + slot);
            }
          }
        } else {
          for (int i = lane; i < 3 * T * NG * dh; i += 32) {
            const int f = i % dh, j = i / dh % NG, t = i / (dh * NG) % T, m = i / (dh * NG * T);
            dst[t * ldr + m * gw + j * dhp + f] = src[t * row3 + m * D + j * dh + f];
          }
          __threadfence_block();
          __syncwarp();
          if (lane == 0) bar_arrive(full + slot);
        }
      }
    }
    return;
  }

  float* prim = smem;
  Planes<NC> w;
  w.prim_ = 0;
  w.g_ = static_cast<int>(L.g), w.w_ = static_cast<int>(L.w), w.x0_ = static_cast<int>(L.x0);
  w.w0_ = static_cast<int>(L.w0), w.r0_ = static_cast<int>(L.r0), w.cg_ = static_cast<int>(L.cg);
  w.sg_ = static_cast<int>(L.sg), w.cxr_ = static_cast<int>(L.cxr), w.ss_ = static_cast<int>(L.ss);
  w.cwv_ = static_cast<int>(L.cwv);
  w.T = T, w.tp = static_cast<int>(L.tp), w.ldr = ldr, w.gw = gw, w.dhp = dhp;
  w.dh = dh, w.group = NG, w.row_lanes = a.row_lanes, w.args = &a;
  // A probe without stores still computes: the batch is never negative.
  const bool store = PROBE != kNoStore || batch < 0;
  const bool wide = a.wide != 0;
  // Two Laplacian tangents a step (there are 2N of them) where the ring holds
  // them and a plane more; every other plane alone.
  const bool pairs = S >= 3;
  int64_t n = 0;
  for (int64_t item = first; item < last; ++item) {
    const int64_t b = item / groups;
    const int h0 = static_cast<int>(item % groups) * NG;
    // Every warp has left the previous item's primal and its softmax.
    consumers_sync<NC>();
    for (int o = 0; o < P;) {
      const int p = plane_at(o);
      const int np = pairs && p >= 1 && p < lap ? 2 : 1;
      // The step's planes: p and, for a pair, p + 1 in the next stage.
      const int round0 = fdiv(static_cast<int>(n), a.by_stages);
      const int round1 = fdiv(static_cast<int>(n) + 1, a.by_stages);
      const int slot0 = static_cast<int>(n) - round0 * S, slot1 = static_cast<int>(n) + 1 - round1 * S;
      bar_wait(full + slot0, static_cast<uint32_t>(round0 & 1));
      if (np == 2) bar_wait(full + slot1, static_cast<uint32_t>(round1 & 1));
      const float* const st0 = smem + L.ring + slot0 * L.stage;
      const float* const st1 = smem + L.ring + slot1 * L.stage;
      float* const out0 = a.attn + (static_cast<int64_t>(p) * batch + b) * T * D + h0 * dh;
      float* const out1 = out0 + batch * T * D;
      if constexpr (PROBE == kNoMath) {
        const int nch = dhp / 4;
        for (int u = tid; u < np * T * NG * nch; u += NC) {
          const int f = 4 * (u % nch), j = u / nch % NG, t = u / nch / NG % T, k = u / (nch * NG * T);
          store4<VEC>((k ? out1 : out0) + t * static_cast<int64_t>(D) + j * dh, f, dh,
                      load4((k ? st1 : st0) + t * ldr + 2 * gw + j * dhp + f));
        }
      } else if (np == 2) {
        // A pair takes the 4x2 tiles and two-row value units at every T: the
        // 4x4 tiles of two planes would not fit the registers.
        w.template logits<1, 2, 2>(st0, st1, 0, false, tid);
        consumers_sync<NC>();
        w.template softmax<1, 2>(0, false, tid, lane);
        consumers_sync<NC>();
        w.template values<1, VEC, 2, 2>(st0, st1, 0, false, out0, out1, D, store, tid);
      } else {
        const int kind = p == 0 ? 0 : p <= C ? 1 : 2;
        // A tangent's slot (0 Laplacian, 1 extra, set by an extra); a second-order plane's.
        const int cs = kind == 1 ? p - 1 >= lap : p != C + 1;
        const bool assign = kind == 1 && cs == 1;
        if (kind == 0) {
          for (int i = 4 * tid; i < L.stage; i += 4 * NC) put4(prim + i, load4(st0 + i));
          if (wide) {
            w.template logits<0, 4, 1>(st0, st0, 0, false, tid);
          } else {
            w.template logits<0, 2, 1>(st0, st0, 0, false, tid);
          }
          consumers_sync<NC>();
          w.template softmax<0, 1>(0, false, tid, lane);
          consumers_sync<NC>();
          if (wide) {
            w.template values<0, VEC, 4, 1>(st0, st0, 0, false, out0, out0, D, store, tid);
          } else {
            w.template values<0, VEC, 2, 1>(st0, st0, 0, false, out0, out0, D, store, tid);
          }
        } else if (kind == 1) {
          if (wide) {
            w.template logits<1, 4, 1>(st0, st0, cs, assign, tid);
          } else {
            w.template logits<1, 2, 1>(st0, st0, cs, assign, tid);
          }
          consumers_sync<NC>();
          w.template softmax<1, 1>(cs, assign, tid, lane);
          consumers_sync<NC>();
          if (wide) {
            w.template values<1, VEC, 4, 1>(st0, st0, cs, assign, out0, out0, D, store, tid);
          } else {
            w.template values<1, VEC, 2, 1>(st0, st0, cs, assign, out0, out0, D, store, tid);
          }
        } else {
          if (wide) {
            w.template logits<2, 4, 1>(st0, st0, cs, false, tid);
          } else {
            w.template logits<2, 2, 1>(st0, st0, cs, false, tid);
          }
          consumers_sync<NC>();
          w.template softmax<2, 1>(cs, false, tid, lane);
          consumers_sync<NC>();
          if (wide) {
            w.template values<2, VEC, 4, 1>(st0, st0, cs, false, out0, out0, D, store, tid);
          } else {
            w.template values<2, VEC, 2, 1>(st0, st0, cs, false, out0, out0, D, store, tid);
          }
        }
      }
      // This warp is done with the step's stages.
      __syncwarp();
      if (lane == 0) {
        bar_arrive(empty + slot0);
        if (np == 2) bar_arrive(empty + slot1);
      }
      n += np;
      o += np;
    }
  }
}

inline int device_attribute(cudaDeviceAttr what, int device) {
  int value = 0;
  return cudaDeviceGetAttribute(&value, what, device) == cudaSuccess ? value : 0;
}

// The most stages, at most kMaxStages, whose layout fits `budget` bytes (0: not one).
inline int most_stages(int T, int dh, int group, int64_t budget) {
  for (int s = kMaxStages; s >= 1; --s) {
    if (layout(T, dh, group, s).bytes <= budget) return s;
  }
  return 0;
}

// Whether a plane's tiles are 4x4 and its value units four query rows (else
// 4x2 and two): where T is a multiple of 4 from 12, so that no tile is padded
// and a plane still has enough units for the block's threads.
inline bool wide(int T) { return T % 4 == 0 && T >= 12; }

// Units of the value contraction of one plane: four or two query rows of one
// head and one 16-byte chunk of its features.
inline int value_units(int T, int dh, int group) {
  const int rows = wide(T) ? 4 : 2;
  return group * ((T + rows - 1) / rows) * ((dh + 3) / 4);
}

// The computing threads for items of `group` heads: the fewest of kWidths
// that take a plane's value units in one round, else the most.
inline int width(int T, int dh, int group) {
  for (const int w : kWidths) {
    if (value_units(T, dh, group) <= w) return w;
  }
  return kWidths[1];
}

struct Plan {
  int group, stages, threads;
};

// The heads of an item: the most (a divisor of `heads`) whose layout fits
// two stages in `limit` bytes and whose value units one round of the widest
// block takes, else the most that fit two stages, else one head; then as many
// stages as fit (three or more put the Laplacian tangents in pairs) and the
// threads for that group ({0, 0, 0}: not one stage fits).  `group` > 0 fixes
// the heads.
inline Plan plan(int T, int dh, int heads, int64_t limit, int group = 0) {
  for (int pass = 0; pass < 2 && group == 0; ++pass) {
    for (int g = heads; g > 1 && group == 0; --g) {
      if (heads % g == 0 && most_stages(T, dh, g, limit) >= 2 &&
          (pass == 1 || value_units(T, dh, g) <= kWidths[1])) {
        group = g;
      }
    }
  }
  if (group == 0) group = 1;
  const int stages = most_stages(T, dh, group, limit);
  if (stages < 1) return {0, 0, 0};
  return {group, stages, width(T, dh, group)};
}

// Each instantiation may use all of `limit` bytes of dynamic shared memory on
// a device once the attribute is set there, which happens once.
template <bool VEC, int PROBE, int NC>
int launch(const Args& a, int device, int limit, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  const auto kernel = jet_softmax_values_streamed_kernel<VEC, PROBE, NC>;
  if (allowed[device] != limit) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[device] = limit;
  }
  const size_t smem = static_cast<size_t>(layout(a.tokens, a.feat / a.heads, a.group, a.stages).bytes);
  int fit = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, NC + 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = static_cast<int64_t>(fit) * device_attribute(cudaDevAttrMultiProcessorCount, device);
  const int64_t items = a.batch * (a.heads / a.group);
  kernel<<<static_cast<unsigned>(items < blocks ? items : blocks), NC + 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NC>
int launch_probe(const Args& a, bool vec, int probe, int device, int limit, cudaStream_t stream) {
  if (vec && probe == kWhole) return launch<true, kWhole, NC>(a, device, limit, stream);
  if (vec && probe == kNoStore) return launch<true, kNoStore, NC>(a, device, limit, stream);
  if (vec && probe == kNoMath) return launch<true, kNoMath, NC>(a, device, limit, stream);
  if (probe == kWhole) return launch<false, kWhole, NC>(a, device, limit, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// group: heads of an item (a divisor of heads), 0 for the plan's; stages: the
// ring's planes (1 to the most that fit), 0 for the most.  Probes other than
// kWhole take only 16-byte aligned fields with dh % 4 == 0.
int run(Args a, int planes, int probe, int group, int stages, void* stream) {
  if (a.heads <= 0 || a.feat % a.heads != 0 || a.e < 1 || a.c < a.e || planes != a.c + a.e + 2 ||
      a.batch <= 0 || a.tokens <= 0 || a.tokens > 1024 || planes > 4096 ||
      a.batch * a.heads > 0x7fffffffll || group < 0 || stages < 0 ||
      (group > 0 && a.heads % group != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const int dh = a.feat / a.heads;
  const int limit = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const Plan chosen = plan(a.tokens, dh, a.heads, limit, group);
  if (chosen.stages < 1 || stages > chosen.stages) return static_cast<int>(cudaErrorInvalidValue);
  a.group = chosen.group;
  a.stages = stages > 0 ? stages : chosen.stages;
  a.row_lanes = chosen.group * a.tokens * 8 <= chosen.threads ? 8 : 4;
  a.wide = wide(a.tokens);
  const int nch = (dh + 3) / 4;
  a.by_tokens = fast_div(a.tokens);
  a.by_rows = fast_div((a.tokens + 3) / 4);
  a.by_cols2 = fast_div((a.tokens + 1) / 2);
  a.by_cols4 = fast_div((a.tokens + 3) / 4);
  a.by_chunks = fast_div(nch);
  a.by_blocks2 = fast_div((a.tokens + 1) / 2);
  a.by_blocks4 = fast_div((a.tokens + 3) / 4);
  a.by_stages = fast_div(a.stages);
  const bool vec = dh % 4 == 0 && aligned16(a.qkv) && aligned16(a.attn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chosen.threads == kWidths[0]) return launch_probe<kWidths[0]>(a, vec, probe, device, limit, s);
  return launch_probe<kWidths[1]>(a, vec, probe, device, limit, s);
}

}  // namespace sv_streamed

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

// Same function and layouts as jet_softmax_values_streamed_kernel.  Persistent: block b
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
// shape whose streamed layout fits the card's shared memory with one stage
// (the caller checks first: ops/jet_attention.py:check_softmax_values_shape).
// qkv: [planes, batch, tokens, 3 * feat]; attn: [planes, batch, tokens, feat].
extern "C" int jet_softmax_values_f32(const float* qkv, float* attn, int planes,
                                      int64_t batch, int tokens, int feat, int heads,
                                      int c, int e, void* stream) {
  const sv_streamed::Args a{qkv, attn, batch, tokens, feat, heads, c, e, 0, 0, 0, 0, {}, {}, {}, {}, {}, {}, {}, {}};
  return sv_streamed::run(a, planes, sv_streamed::kWhole, 0, 0, stream);
}

// The streamed kernel cut down, or with another ring or head group, for
// timing and tests only (scripts/torch_softmax_values_timing.py).  probe: 0
// the kernel, 1 without its stores, 2 without its arithmetic (each plane's v
// copied out); 1 and 2 take only 16-byte aligned fields with head width
// % 4 == 0.  group: heads of an item (a divisor of heads), 0 for the
// default; stages: the ring's planes (1 to the most that fit), 0 for the most.
extern "C" int jet_softmax_values_streamed_probe_f32(const float* qkv, float* attn, int planes,
                                                     int64_t batch, int tokens, int feat,
                                                     int heads, int c, int e, int probe,
                                                     int group, int stages, void* stream) {
  const sv_streamed::Args a{qkv, attn, batch, tokens, feat, heads, c, e, 0, 0, 0, 0, {}, {}, {}, {}, {}, {}, {}, {}};
  return sv_streamed::run(a, planes, probe, group, stages, stream);
}

// The streamed kernel's plan on `device` for this shape: what = 0 the heads
// of an item, 1 the stages of its ring, 2 its computing threads; 0 where not
// one stage fits.
extern "C" int jet_softmax_values_streamed_plan(int device, int tokens, int feat, int heads,
                                                int what) {
  if (device < 0 || device >= sv_streamed::kMaxDevices || tokens <= 0 || heads <= 0 ||
      feat % heads != 0) {
    return 0;
  }
  const sv_streamed::Plan chosen = sv_streamed::plan(
      tokens, feat / heads, heads,
      sv_streamed::device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
  return what == 0 ? chosen.group : what == 1 ? chosen.stages : chosen.threads;
}

// Bytes of the streamed kernel's shared memory with `group` heads an item and
// `stages` planes in the ring (ops/jet_attention.py:softmax_values_smem
// computes the same), at most 2^31 - 1.
extern "C" int jet_softmax_values_streamed_smem(int tokens, int head_dim, int group, int stages) {
  const int64_t bytes = sv_streamed::layout(tokens, head_dim, group, stages).bytes;
  return bytes < 0x7fffffffll ? static_cast<int>(bytes) : 0x7fffffff;
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
