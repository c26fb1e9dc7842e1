// KFAC's Kronecker factors x^T x / rows as symmetric Gram products, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves a factor's product to XLA
// (deephall_tpu/optimizers/kfac.py:171-172, a.T @ a and g.T @ g).  The port's
// factors run from 4 to 4,480 columns over 20,160 to 33,600 rows; the
// 16-determinant head's two G factors of 4,480^2 are 2.70 TFLOP an iteration,
// which the library's float32 GEMM runs on the CUDA cores.
//
// What bounds it: operations.  KFAC's factors are float32, so the products run
// on the tensor cores as three TF32 products, hi*hi + hi*lo + lo*hi of
// hi = tf32(x), lo = tf32(x - hi), with csrc/jet_attention.cu's split and
// accumulation: each 32-row step's twelve wgmma go into an accumulator that
// starts from zero, the small terms first, and that partial sum is added into
// a float32 accumulator on the CUDA cores, rounding to nearest (the tensor
// cores' own accumulation truncates, a loss that grows with the rows).  The
// bound is 2 x rows x n(n+1)/2 x 3 products at the TF32 rate.  What the
// design does for it:
//
//   - Only the 128 x 128 tiles on and above the diagonal are computed.  Each
//     value is written at (i, j) and at (j, i) from the same register, so the
//     result is exactly symmetric; in a diagonal tile only i <= j is taken (the
//     tensor cores sum (i, j) and (j, i) in different orders).
//   - tf32 wgmma takes its B operand K-major only, and both operands here are
//     column blocks of the row-major x, which are MN-major.  Each step's 32
//     rows of the tile's two column blocks arrive raw (16-byte cp.async, zeros
//     past the edges) in a ring of four stages, four steps ahead, rows padded
//     by 8 floats.  The block then splits the B slab into its TF32 halves and
//     writes them K-major with the 128-byte swizzle, the next step's while
//     this step's products run; A is read from the raw slab into registers and
//     split there (wgmma takes A from registers in any order).  The padding
//     keeps both the transposing reads and the fragment reads on 32 banks.  No
//     split copy of x reaches device memory.
//   - Two warpgroups own 64 rows of the tile each and issue their products
//     asynchronously; the next step's B split runs under them.  The next
//     step's A operand is loaded only after the wait: the compiler may give
//     the operand registers of products in flight to other values (loading it
//     earlier gave wrong sums).  Issuing a wgmma waits for room on the tensor
//     cores, so the copies, the split and the additions run beside the
//     products only in part; a producer warpgroup doing them for products
//     from shared memory only was slower (PERF.md, section 6).
//   - Persistent blocks take the tiles column block by column block, so that
//     the tiles in flight read the same rows of few column blocks and x is
//     re-read from L2 rather than from device memory.  A diagonal tile copies
//     its one column block once.
//   - Where the triangle has fewer tiles than the card has SMs (every factor
//     of one determinant), the rows are split into chunks, one work item a
//     (chunk, tile), and each chunk's sums go to its own plane of a scratch
//     buffer; kfac_gram_finish_kernel adds the chunks in a fixed order, in
//     float64, divides and mirrors.  Results repeat bit for bit.
//
// A layer's bias is a ones column appended to its inputs.  With `ones` it is
// never a column of the product: its row and column are the column sums of x,
// which the diagonal tiles add from the A operand they already hold, and the
// corner is 1; no copy of x with the column is made.  The division is a
// float32 division by rows, as (x^T x) / rows rounds it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;                         // output tile, rows and columns
constexpr int BK = 32;                            // rows of x a step
constexpr int THREADS = 256;                      // two warpgroups
constexpr int PITCH = TILE + 8;                   // floats a raw slab row, padded
constexpr int SLAB_BYTES = BK * PITCH * 4;        // one column block's raw rows
constexpr int RAW_STAGES = 4;                     // raw ring: B slab, then A slab
constexpr int OP_BYTES = TILE * BK * 4;           // one TF32 half of B, K-major
constexpr int OP_OFFSET = 0;                      // two stages of B hi | B lo
constexpr int RAW_OFFSET = 2 * 2 * OP_BYTES;
constexpr int SMEM_BYTES = RAW_OFFSET + RAW_STAGES * 2 * SLAB_BYTES + 1024;

struct Params {
  const float* x;   // [rows, n_in] at row stride ld and column stride cs
  float* out;       // [n, n]
  float* scratch;   // [chunks, n, n] where chunks > 1
  int64_t ld, cs;
  int rows, n_in, n, ones;
  int tiles, chunks, chunk_steps, steps, items;
};

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` of 16 from global `src` to shared `dst`, zeros for the rest.
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// `bytes` of 4 from global `src` to shared `dst`, zeros for the rest.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

#define GRAM_D8(i)                                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] (+)= a[64 x 8] * b[8 x 128]: a from registers, b from shared memory.
__device__ __forceinline__ void mma(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint64_t desc, int accumulate) {
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
      : GRAM_D8(0), GRAM_D8(8), GRAM_D8(16), GRAM_D8(24), GRAM_D8(32), GRAM_D8(40), GRAM_D8(48),
        GRAM_D8(56)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
}

#undef GRAM_D8

// Walks a block's work items step by step: item `it` is the tile (I, J),
// I <= J, over the rows of one chunk.  Items run chunk by chunk and, inside a
// chunk, column block by column block (tile t of block J has I = t - J(J+1)/2).
struct Cursor {
  int it, step, I, J, first, steps;  // the chunk's first step and its steps

  __device__ __forceinline__ void load(const Params& prm) {
    const int chunk = it / prm.tiles;
    int t = it - chunk * prm.tiles, j = 0;
    while (t > j) t -= ++j;
    I = t, J = j;
    first = chunk * prm.chunk_steps;
    steps = min(prm.chunk_steps, prm.steps - first);
  }
  __device__ __forceinline__ void start(const Params& prm) {
    it = blockIdx.x, step = 0;
    if (it < prm.items) load(prm);
  }
  __device__ __forceinline__ bool valid(const Params& prm) const { return it < prm.items; }
  __device__ __forceinline__ void advance(const Params& prm) {
    if (++step == steps) {
      step = 0;
      it += gridDim.x;
      if (it < prm.items) load(prm);
    }
  }
  __device__ __forceinline__ bool diagonal() const { return I == J; }
};

// Starts the copies of a step's raw rows into a ring stage: the B slab
// (column block J), then the A slab (block I) unless the tile is diagonal.
// Zeros past the rows and columns of x.  VEC: 16-byte copies (x 16-byte
// aligned, ld and n_in multiples of 4, unit column stride); else float by float.
template <bool VEC>
__device__ __forceinline__ void copy_step(const Params& prm, const Cursor& c, uint32_t stage,
                                          int tid) {
  const int r0 = (c.first + c.step) * BK;
  const int slabs = c.diagonal() ? 1 : 2;
  for (int s = 0; s < slabs; ++s) {
    const int col0 = (s == 0 ? c.J : c.I) * TILE;
    const uint32_t slab = stage + s * SLAB_BYTES;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < BK * TILE / 4 / THREADS; ++i) {
        const int idx = tid + i * THREADS, row = idx >> 5, chunk = idx & 31;
        const int r = r0 + row, col = col0 + 4 * chunk;
        const bool in = r < prm.rows && col < prm.n_in;
        cp_async16(slab + (row * PITCH + 4 * chunk) * 4,
                   in ? prm.x + static_cast<int64_t>(r) * prm.ld + col : prm.x, in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * TILE / THREADS; ++i) {
        const int idx = tid + i * THREADS, row = idx >> 7, j = idx & (TILE - 1);
        const int r = r0 + row, col = col0 + j;
        const bool in = r < prm.rows && col < prm.n_in;
        cp_async4(slab + (row * PITCH + j) * 4,
                  in ? prm.x + static_cast<int64_t>(r) * prm.ld + col * prm.cs : prm.x,
                  in ? 4 : 0);
      }
    }
  }
}

// The B slab of a raw stage split into TF32 halves, K-major with the 128-byte
// swizzle: thread (h, n) takes column n's rows 16h..16h+15, four rows a
// 16-byte store.
__device__ __forceinline__ void split_b(const float* raw, uint8_t* hi, uint8_t* lo, int tid) {
  const int n = tid & (TILE - 1), h = tid >> 7;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = 4 * h + a;
    const float* v = raw + 4 * c * PITCH + n;
    uint4 H, L;
    H.x = to_tf32(v[0]), L.x = to_tf32(v[0] - __uint_as_float(H.x));
    H.y = to_tf32(v[PITCH]), L.y = to_tf32(v[PITCH] - __uint_as_float(H.y));
    H.z = to_tf32(v[2 * PITCH]), L.z = to_tf32(v[2 * PITCH] - __uint_as_float(H.z));
    H.w = to_tf32(v[3 * PITCH]), L.w = to_tf32(v[3 * PITCH] - __uint_as_float(H.w));
    const int off = n * 128 + ((c ^ (n & 7)) << 4);
    *reinterpret_cast<uint4*>(hi + off) = H;
    *reinterpret_cast<uint4*>(lo + off) = L;
  }
}

// A thread's A operand of a step from the raw A slab, split into TF32 halves:
// for each k8 block, (m, k), (m + 8, k), (m, k + 4), (m + 8, k + 4).
__device__ __forceinline__ void load_a(const float* raw, int m, int quad, uint32_t (&hi)[16],
                                       uint32_t (&lo)[16]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float x = raw[(8 * kk + quad + 4 * (u >> 1)) * PITCH + m + 8 * (u & 1)];
      hi[4 * kk + u] = to_tf32(x);
      lo[4 * kk + u] = to_tf32(x - __uint_as_float(hi[4 * kk + u]));
    }
  }
}

// The twelve products of one step into `part`, from zero: the small terms of
// every k8 block first, then the large ones.  Committed, not waited for.
__device__ __forceinline__ void products(float (&part)[64], const uint32_t (&hi)[16],
                                         const uint32_t (&lo)[16], uint32_t op) {
  const uint64_t dhi = matrix_descriptor(op), dlo = matrix_descriptor(op + OP_BYTES);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  // 32 bytes further along K inside the swizzled row: +2 in the address field.
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    mma(part, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3], dhi + 2 * kk, kk != 0);
    mma(part, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], dlo + 2 * kk, 1);
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    mma(part, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3], dhi + 2 * kk, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// A warp's epilogue of one work item: rows m and m + 8 of its 16, all 128
// columns.  Without chunks each value divided by rows goes to (i, j) and
// (j, i); with chunks the raw sum goes to the chunk's scratch plane at (i, j)
// only.  In a diagonal tile with the ones column, the column sums of rows m
// and m + 8 (summed over the quad's lanes) go to column n_in.
__device__ __forceinline__ void epilogue(const Params& prm, const Cursor& c, const float (&acc)[64],
                                         float sum0, float sum1, int m, int quad) {
  const int i0 = c.I * TILE + m, j0 = c.J * TILE + 2 * quad;
  const bool diag = c.diagonal();
  const float rows = static_cast<float>(prm.rows);
  const int64_t n = prm.n;
  float* plane = prm.chunks > 1 ? prm.scratch + (c.it / prm.tiles) * n * n : nullptr;
#pragma unroll
  for (int jj = 0; jj < TILE / 8; ++jj) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + 8 * (e >> 1), j = j0 + 8 * jj + (e & 1);
      if (i >= prm.n_in || j >= prm.n_in || (diag && i > j)) continue;
      const float v = acc[4 * jj + e];
      if (plane != nullptr) {
        plane[i * n + j] = v;
      } else {
        const float w = __fdiv_rn(v, rows);
        prm.out[i * n + j] = w;
        if (i != j) prm.out[j * n + i] = w;
      }
    }
  }
  if (prm.ones && diag) {
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, d);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, d);
    }
    if (quad == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + 8 * u;
        const float v = u ? sum1 : sum0;
        if (i >= prm.n_in) continue;
        if (plane != nullptr) {
          plane[i * n + prm.n_in] = v;
        } else {
          const float w = __fdiv_rn(v, rows);
          prm.out[i * n + prm.n_in] = w;
          prm.out[prm.n_in * n + i] = w;
        }
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1) kfac_gram_kernel(const Params prm) {
  extern __shared__ uint8_t raw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_address(smem);
  const int tid = threadIdx.x, lane = tid & 31, quad = lane & 3;
  // This thread's rows m and m + 8 of the tile (the A operand's and the output's).
  const int m = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  auto raw = [&](int f) { return RAW_OFFSET + (f % RAW_STAGES) * 2 * SLAB_BYTES; };
  auto op = [&](int f) { return OP_OFFSET + (f & 1) * 2 * OP_BYTES; };

  if (prm.ones && prm.chunks == 1 && blockIdx.x == 0 && tid == 0) {
    prm.out[static_cast<int64_t>(prm.n_in) * prm.n + prm.n_in] = 1.f;  // rows / rows
  }

  // Three cursors over the same steps: the copies run RAW_STAGES steps
  // ahead, the split one step ahead of the products.
  Cursor copy, split, cur;
  copy.start(prm);
  split = copy, cur = copy;
#pragma unroll
  for (int s = 0; s < RAW_STAGES; ++s) {
    if (copy.valid(prm)) {
      copy_step<VEC>(prm, copy, base + raw(s), tid);
      copy.advance(prm);
    }
    cp_async_commit();
  }

  float acc[64], part[64], sum0 = 0.f, sum1 = 0.f;
  uint32_t hi[16], lo[16];

  cp_async_wait<RAW_STAGES - 1>();
  __syncthreads();
  {
    const float* b = reinterpret_cast<const float*>(smem + raw(0));
    split_b(b, smem + op(0), smem + op(0) + OP_BYTES, tid);
    load_a(split.diagonal() ? b : b + SLAB_BYTES / 4, m, quad, hi, lo);
    split.advance(prm);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int f = 0; cur.valid(prm); ++f) {
    // Step f + RAW_STAGES goes into the stage of step f, which every thread
    // has read before the barrier that ended step f - 1.
    if (copy.valid(prm)) {
      copy_step<VEC>(prm, copy, base + raw(f), tid);
      copy.advance(prm);
    }
    cp_async_commit();
    products(part, hi, lo, base + op(f));
    const bool first = cur.step == 0, next = split.valid(prm);
    const float* next_a = nullptr;
    if (next) {
      // Step f + 1's B operand, under this step's products: its copies have
      // landed (the newer groups may be in flight), in every thread once past
      // the barrier; its stage was last read by step f - 1's products, waited
      // for.
      cp_async_wait<RAW_STAGES - 1>();
      __syncthreads();
      const float* b = reinterpret_cast<const float*>(smem + raw(f + 1));
      split_b(b, smem + op(f + 1), smem + op(f + 1) + OP_BYTES, tid);
      next_a = split.diagonal() ? b : b + SLAB_BYTES / 4;
      split.advance(prm);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // The accumulator is the wgmma's until the wait; the compiler sees the
    // results only from here on.
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] = (first ? 0.f : acc[i]) + part[i];
    }
    if (prm.ones && cur.diagonal()) {
      // The column sums of rows m and m + 8 over this quad's k, as hi + lo.
      if (first) sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        sum0 += __uint_as_float(hi[4 * kk]) + __uint_as_float(lo[4 * kk]);
        sum0 += __uint_as_float(hi[4 * kk + 2]) + __uint_as_float(lo[4 * kk + 2]);
        sum1 += __uint_as_float(hi[4 * kk + 1]) + __uint_as_float(lo[4 * kk + 1]);
        sum1 += __uint_as_float(hi[4 * kk + 3]) + __uint_as_float(lo[4 * kk + 3]);
      }
    }
    // The next step's A operand only now: the products read the operand
    // registers until the wait, and the compiler does not keep them from
    // being given to other values before it.
    if (next) load_a(next_a, m, quad, hi, lo);
    if (cur.step == cur.steps - 1) epilogue(prm, cur, acc, sum0, sum1, m, quad);
    cur.advance(prm);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
  cp_async_wait<0>();
}

// out[r, c] = (sum over the chunks, in order, of scratch[k, min, max]) / rows;
// the ones column's corner 1.
__global__ void kfac_gram_finish_kernel(const Params prm) {
  const int64_t n = prm.n, count = n * n;
  const double rows = prm.rows;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; idx < count;
       idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = idx / n, c = idx - r * n;
    if (prm.ones && r == prm.n_in && c == prm.n_in) {
      prm.out[idx] = 1.f;
      continue;
    }
    const int64_t at = r <= c ? r * n + c : c * n + r;
    double sum = 0.0;
    for (int k = 0; k < prm.chunks; ++k) sum += prm.scratch[k * count + at];
    prm.out[idx] = static_cast<float>(sum / rows);
  }
}

template <bool VEC>
cudaError_t launch(const Params& prm, int grid, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kfac_gram_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kfac_gram_kernel<VEC><<<grid, THREADS, SMEM_BYTES, s>>>(prm);
  return cudaGetLastError();
}

}  // namespace

// out [n, n] = [x 1]^T [x 1] / rows of x [rows, n_in] at row stride ld and
// column stride cs, the ones column where `ones` (n = n_in + ones).  The
// `tiles` tiles of the upper triangle of n_in columns in `chunks` chunks of
// `chunk_steps` steps of 32 rows; scratch [chunks, n, n] where chunks > 1,
// then kfac_gram_finish_kernel (ops/kfac_gram.py:plan picks them).  A
// 16-byte aligned x with ld and n_in multiples of 4 and unit column stride is
// copied 16 bytes at a time, any other float by float.
extern "C" int kfac_gram_f32(const float* x, int64_t ld, int64_t cs, int rows, int n_in,
                             int ones, int tiles, int chunks, int chunk_steps, int sms,
                             float* out, float* scratch, void* stream) {
  Params prm;
  prm.x = x, prm.out = out, prm.scratch = scratch, prm.ld = ld, prm.cs = cs;
  prm.rows = rows, prm.n_in = n_in, prm.ones = ones ? 1 : 0, prm.n = n_in + prm.ones;
  prm.tiles = tiles, prm.chunks = chunks, prm.chunk_steps = chunk_steps;
  prm.steps = (rows + BK - 1) / BK;
  const int blocks = (n_in + TILE - 1) / TILE;
  if (rows <= 0 || n_in <= 0 || ld < 0 || cs < 0 ||
      tiles != blocks * (blocks + 1) / 2 || chunks <= 0 || chunk_steps <= 0 ||
      static_cast<int64_t>(chunks - 1) * chunk_steps >= prm.steps ||
      static_cast<int64_t>(chunks) * chunk_steps < prm.steps ||
      static_cast<int64_t>(tiles) * chunks > 0x7fffffff || (chunks > 1 && scratch == nullptr) ||
      sms <= 0 || reinterpret_cast<uintptr_t>(x) % 4 || reinterpret_cast<uintptr_t>(out) % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.items = tiles * chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && ld % 4 == 0 && n_in % 4 == 0 &&
                   cs == 1;
  const int grid = prm.items < sms ? prm.items : sms;
  cudaError_t err = vec ? launch<true>(prm, grid, s) : launch<false>(prm, grid, s);
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const int64_t want = (static_cast<int64_t>(prm.n) * prm.n + 255) / 256;
  kfac_gram_finish_kernel<<<static_cast<int>(want < 4 * sms ? want : 4 * sms), 256, 0, s>>>(prm);
  return static_cast<int>(cudaGetLastError());
}
