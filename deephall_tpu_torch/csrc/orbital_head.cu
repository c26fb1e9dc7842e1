// The orbital head's jet: projection, envelope contraction, one kernel, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package leaves the orbital head to XLA
// (deephall_tpu/networks/fwdlap.py:psiformer_logpsi_jet: the complex
// projection, then bm_bilinear with the envelope), which writes a feature jet
// of P (2Q+1) N^2 K complex numbers a walker, 28.9 GB at N = 10, 2Q = 27,
// 16 determinants and batch 3360.  This kernel computes the orbital matrices'
// jet directly, each matrix transposed ([P, B, K, N, N] with the electron last,
// so that the lanes of consecutive rows store consecutive values), and the
// feature jet never reaches device memory.
//
// Rows are the planes of the tower jet [P, B, N, D] (float32): row m =
// (p B + b) nsec + (n - lo) for the electrons [lo, lo + nsec) of one spin
// sector.  Columns are the head kernel as one real [D, 2F] matrix a
// (orbital, determinant) pair: pair g = d N + e holds harmonic f's real part
// in column 2f and its imaginary part in 2f + 1, padded to a stride S (a
// multiple of 8), and a column tile of `width` columns holds `per_tile` whole
// pairs (ops/orbital_head.py:column_plan picks them from the shape).  The
// products run on the tensor cores as three TF32 products, with the split,
// the ring and the accumulation of csrc/jet_attention.cu:jet_gemm_tf32x3_kernel
// (float32 accuracy: each step's twelve wgmma into a zeroed accumulator, the
// small terms first, added into the float32 sum on the CUDA cores).
//
// The epilogue contracts each row's harmonics with the envelope.  With the
// interleaved columns a lane of the wgmma accumulator holds whole complex
// features (harmonic f = 4 i + lane % 4 of each pair); it multiplies them by
// env.x[b, n, f], sums, and the four lanes of the row add their parts by two
// shuffles.  Only [..., N, N] complex values are written.  fwdlap.bilinear's
// other terms pair features with the envelope's own derivatives.  Direction
// 2i or 2i + 1 moves electron i alone (ops/fwdlap.py:electron_seeds), so of
// the envelope's Laplacian tangents only the row's own two are nonzero; the
// extra directions rotate every electron and are never skipped.  So:
//   - a primal row (bias added first) is also contracted with env.j[2n],
//     env.j[2n + 1], each env.j[2N + e], env.l and each env.d[e]: 3 + 2E side
//     planes;
//   - a tangent row of direction 2n + s, and of extra direction e, also with
//     its own env.j, doubled (the Laplacian's and the extras' cross terms):
//     2 + E side planes.
// Each side value is written once, to a side buffer [5 + 3E, B, K, N, N];
// orbital_head_jet_finish_kernel then adds them to their planes in a fixed
// order, with no atomics.
//
// What bounds it: operations, 3 x 2 M D (2F N K) at the TF32 rate; the tower
// jet is read once from device memory and the output written once (the
// envelope's values come from L2).  Tiles are 256 rows by `width` columns,
// n fastest, so a row block of the tower jet stays in L2 for all its column
// tiles.  The accumulator of a 64-row half is width / 2 floats a thread, and
// with the step's partial sum the width is held to 128 (255 registers at 128
// in jet_gemm_tf32x3_kernel; here the 112- and 128-column instantiations spill
// 164-380 bytes, the 64- and 96-column ones none, ptxas -v on sm_90a).  The
// epilogue is not overlapped with products: both warpgroups run it between
// a tile's last step and the next tile's first.  So its loads of the
// envelope are all in flight at once where the stride is known at compile time
// (contract<BN, SPP>): with one load a block, each waited for in turn, the
// kernel took 93 ms at N = 10, 16 determinants and batch 3360 on an H100,
// of which the products alone about 55; with them in flight together, 67.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 256, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_BYTES = BM * BK * 4;

template <int BN>
struct Tile {
  static constexpr int W_BYTES = BN * BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * W_BYTES;       // A | W hi | W lo
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // room to align to 1024
};

struct Params {
  const float* a;                    // [P, B, N, D] planes of the tower jet
  const float* whi;                  // [tiles * width, D], TF32
  const float* wlo;                  // [tiles * width, D], TF32
  const float2* bias;                // [tiles * width / 2] complex, the columns' layout
  const float2* ex;                  // [B, N, F] envelope
  const float2* ej;                  // [C, B, N, F]
  const float2* el;                  // [B, N, F]
  const float2* ed;                  // [E, B, N, F]
  float2* out;                       // [P, B, K, N, N] orbital matrices, transposed
  float2* side;                      // [5 + 3E, B, K, N, N], the same layout
  int64_t rows;                      // P B nsec
  int batch, nelec, lo, nsec, depth, harmonics, stride, per_tile, pairs, ndet, c, e;
  int n_tiles, total_tiles;
};

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

#define ORB_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x BN] (+)= a[64 x 8] * b[8 x BN]: a from registers, b from shared memory.
template <int BN>
struct Mma;

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : ORB_D8(0), ORB_D8(8), ORB_D8(16), ORB_D8(24)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<96> {
  static __device__ __forceinline__ void run(float (&d)[48], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47"
        "}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1;\n"
        "}\n"
        : ORB_D8(0), ORB_D8(8), ORB_D8(16), ORB_D8(24), ORB_D8(32), ORB_D8(40)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<112> {
  static __device__ __forceinline__ void run(float (&d)[56], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55"
        "}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1;\n"
        "}\n"
        : ORB_D8(0), ORB_D8(8), ORB_D8(16), ORB_D8(24), ORB_D8(32), ORB_D8(40), ORB_D8(48)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
        "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : ORB_D8(0), ORB_D8(8), ORB_D8(16), ORB_D8(24), ORB_D8(32), ORB_D8(40), ORB_D8(48), ORB_D8(56)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(accumulate));
  }
};

#undef ORB_D8

// One row's features contracted with two envelope vectors at once: va[f]
// (the bias added to the features first where given) into dsta, and vb[f]
// into dstb times `scale_b` where vb is given (its loads and stores are
// predicated off elsewhere, so that every quad of a warp runs the same code).
// `row` holds this lane's (real, imaginary) pairs of the row, one from each
// 8-column block: block j holds harmonic 4i + quad of the tile's pair q,
// j = q blocks + i.  Pair g = pair0 + q = det N + e goes to dst[g N], the
// transposed matrix's element (e, n) (the lanes of consecutive rows store
// consecutive values), by the lane whose index in its quad is q % 4.  `mask`
// names the row's quad.
template <int BN, int SPP>
__device__ __forceinline__ void contract(const float (&row)[BN / 4], const Params& prm,
                                         const float2* __restrict__ va,
                                         const float2* __restrict__ vb,
                                         const float2* __restrict__ bias,
                                         float2* __restrict__ dsta, float2* __restrict__ dstb,
                                         float scale_b, int pair0, int quad, unsigned mask) {
  constexpr int J = BN / 8;  // 8-column blocks a tile
  const bool two = vb != nullptr;
  float ar_ = 0.f, ai_ = 0.f, br = 0.f, bi = 0.f;
  // Pair q's sums over the quad, stored; the sums start again from zero.
  auto store = [&](int q) {
#pragma unroll
    for (int lane_bit = 1; lane_bit < 4; lane_bit <<= 1) {
      ar_ += __shfl_xor_sync(mask, ar_, lane_bit);
      ai_ += __shfl_xor_sync(mask, ai_, lane_bit);
      br += __shfl_xor_sync(mask, br, lane_bit);
      bi += __shfl_xor_sync(mask, bi, lane_bit);
    }
    const int g = pair0 + q;
    if (quad == (q & 3) && q < prm.per_tile && g < prm.pairs) {
      dsta[g * prm.nelec] = make_float2(ar_, ai_);
      if (two) dstb[g * prm.nelec] = make_float2(scale_b * br, scale_b * bi);
    }
    ar_ = ai_ = br = bi = 0.f;
  };
  if constexpr (SPP > 0) {
    // A stride of SPP blocks known at compile time: the envelope's values are
    // loaded first, once a harmonic, all in flight together, and the pairs'
    // sums follow without a branch.
    float2 wa[SPP], wb[SPP];
#pragma unroll
    for (int i = 0; i < SPP; ++i) {
      const int f = 4 * i + quad;
      const bool in = f < prm.harmonics;
      wa[i] = in ? __ldg(va + f) : make_float2(0.f, 0.f);
      wb[i] = in && two ? __ldg(vb + f) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int q = 0; q < J / SPP; ++q) {
#pragma unroll
      for (int i = 0; i < SPP; ++i) {
        const int j = q * SPP + i;
        float xr = row[2 * j], xi = row[2 * j + 1];
        if (bias != nullptr) {
          const float2 b = __ldg(bias + 4 * j + quad);
          xr += b.x;
          xi += b.y;
        }
        ar_ = fmaf(xr, wa[i].x, fmaf(-xi, wa[i].y, ar_));
        ai_ = fmaf(xr, wa[i].y, fmaf(xi, wa[i].x, ai_));
        br = fmaf(xr, wb[i].x, fmaf(-xi, wb[i].y, br));
        bi = fmaf(xr, wb[i].y, fmaf(xi, wb[i].x, bi));
      }
      store(q);
    }
  } else {
    const int blocks = prm.stride >> 3;  // 8-column blocks a pair
    int i = 0, q = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int f = 4 * i + quad;
      const bool in = f < prm.harmonics;
      const float2 wa = in ? __ldg(va + f) : make_float2(0.f, 0.f);
      const float2 wb = in && two ? __ldg(vb + f) : make_float2(0.f, 0.f);
      float xr = row[2 * j], xi = row[2 * j + 1];
      if (bias != nullptr) {
        const float2 b = __ldg(bias + 4 * j + quad);
        xr += b.x;
        xi += b.y;
      }
      ar_ = fmaf(xr, wa.x, fmaf(-xi, wa.y, ar_));
      ai_ = fmaf(xr, wa.y, fmaf(xi, wa.x, ai_));
      br = fmaf(xr, wb.x, fmaf(-xi, wb.y, br));
      bi = fmaf(xr, wb.y, fmaf(xi, wb.x, bi));
      if (++i == blocks) {
        store(q);
        i = 0;
        ++q;
      }
    }
  }
}

// Row `sub` of this thread's four in a 256-row tile (half sub / 2, sub-row
// sub % 2: the row of lane / 4, or 8 below it) out of the accumulators.
template <int BN>
__device__ __forceinline__ void take_row(const float (&acc)[2][BN / 2], int sub,
                                         float (&row)[BN / 4]) {
  switch (sub) {
#define ORB_TAKE(R, S)                                                       \
  case 2 * R + S:                                                            \
    _Pragma("unroll") for (int j = 0; j < BN / 8; ++j) {                     \
      row[2 * j] = acc[R][4 * j + 2 * S];                                    \
      row[2 * j + 1] = acc[R][4 * j + 2 * S + 1];                            \
    }                                                                        \
    break;
    ORB_TAKE(0, 0)
    ORB_TAKE(0, 1)
    ORB_TAKE(1, 0)
    ORB_TAKE(1, 1)
#undef ORB_TAKE
  }
}

// The epilogue of one 256-row tile: each of the thread's four rows m, its
// plane p, walker b and electron n, contracted with env.x into the output,
// then with the envelope's tangents where they are structurally nonzero into
// the side planes.  One loop over (row, contraction), so that the contraction's
// code is emitted once.
template <int BN, int SPP>
__device__ __forceinline__ void tile_epilogue(const float (&acc)[2][BN / 2], const Params& prm,
                                              int tile, int row_in_tile, int quad,
                                              unsigned mask) {
  const int64_t m0 = static_cast<int64_t>(tile / prm.n_tiles) * BM + row_in_tile;
  const int col_tile = tile % prm.n_tiles;
  const int pair0 = col_tile * prm.per_tile;
  const float2* bias = prm.bias + col_tile * (BN / 2);
  const int64_t points = static_cast<int64_t>(prm.batch) * prm.nelec;  // (b, n) a plane
  const int64_t plane = points * prm.ndet * prm.nelec;  // complex values a plane of the output
  const int F = prm.harmonics, e = prm.e, lap = prm.c - prm.e;
#pragma unroll 1
  for (int sub = 0; sub < 4; ++sub) {
    const int64_t m = m0 + 64 * (sub >> 1) + 8 * (sub & 1);
    if (m >= prm.rows) continue;
    float row[BN / 4];
    take_row<BN>(acc, sub, row);
    // 32-bit divisions: the launch takes fewer than 2^31 rows.
    const unsigned r32 = static_cast<unsigned>(m), pb = r32 / prm.nsec, p = pb / prm.batch;
    const int n = prm.lo + static_cast<int>(r32 - pb * prm.nsec);
    const int b = static_cast<int>(pb - p * prm.batch);
    const int64_t bn = static_cast<int64_t>(b) * prm.nelec + n;
    const int64_t at = static_cast<int64_t>(b) * prm.ndet * prm.nelec * prm.nelec + n;
    auto tangent = [&](int k) { return prm.ej + (k * points + bn) * F; };  // env.j[k, b, n]
    const int k = static_cast<int>(p) - 1;  // a tangent row's direction
    // Contraction 0 is with env.x into the output.  Then, a primal row's side
    // planes u = 0..2+2E (against env.j[2n], env.j[2n+1], env.j[2N+e], env.l,
    // env.d[e]); a tangent row of electron n's own direction its side plane
    // 3 + 2E + (k & 1), an extra's tangent row 5 + 2E + k - 2N, doubled (the
    // cross terms).  Two contractions a pass.
    const int count = p == 0                    ? 4 + 2 * e
                      : k < lap                 ? 1 + ((k >> 1) == n)
                      : k < prm.c               ? 2
                                                : 1;
    auto job = [&](int t, const float2*& v, float2*& dst) {
      if (t == 0) {
        v = prm.ex + bn * F;
        dst = prm.out + p * plane + at;
      } else if (p == 0) {
        const int u = t - 1;
        v = u < 2           ? tangent(2 * n + u)
            : u < 2 + e     ? tangent(lap + u - 2)
            : u == 2 + e    ? prm.el + bn * F
                            : prm.ed + ((u - 3 - e) * points + bn) * F;
        dst = prm.side + u * plane + at;
      } else {
        v = tangent(k);
        dst = prm.side + (k < lap ? 3 + 2 * e + (k & 1) : 5 + 2 * e + k - lap) * plane + at;
      }
    };
#pragma unroll 1
    for (int t = 0; t < count; t += 2) {
      const float2 *va, *vb = nullptr;
      float2 *dsta, *dstb = nullptr;
      job(t, va, dsta);
      if (t + 1 < count) job(t + 1, vb, dstb);
      contract<BN, SPP>(row, prm, va, vb, p == 0 ? bias : nullptr, dsta, dstb, p == 0 ? 1.f : 2.f,
                   pair0, quad, mask);
    }
  }
}

// The orbital matrices' jet of one spin sector's rows: see the file's head.
// Each of the two warpgroups owns 128 rows of the 256-row tile as two 64-row
// halves; the main loop is jet_gemm_tf32x3_kernel's, with `BN` columns.
template <int BN, int SPP>
__global__ void __launch_bounds__(THREADS, 1) orbital_head_jet_kernel(const Params prm) {
  using T = Tile<BN>;
  constexpr int HALF = BN / 2;
  extern __shared__ uint8_t raw_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t smem_base = smem_address(smem);
  const int tid = threadIdx.x, lane = tid & 31, group = lane >> 2, quad = lane & 3;
  // This thread's first row of half 0; half 1 is 64 further, the second row 8 further.
  const int row_in_tile = (tid >> 7) * 128 + ((tid >> 5) & 3) * 16 + group;
  const int K = prm.depth;
  const int steps_per_tile = K / BK;
  const int my_tiles =
      (prm.total_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int steps = my_tiles * steps_per_tile;
  const bool whole = prm.nsec == prm.nelec;

  // The tower jet's row of sector row m: (p B + b) N + lo + (m mod nsec).
  auto a_row = [&](int64_t m) {
    if (!whole) m += (m / prm.nsec) * (prm.nelec - prm.nsec) + prm.lo;
    return prm.a + m * K;
  };

  // Starts the copies of step f's tiles into ring slot f % STAGES; one group each call.
  auto load_stage = [&](int f) {
    if (f < steps) {
      const int tile = blockIdx.x + (f / steps_per_tile) * gridDim.x;
      const int k0 = (f % steps_per_tile) * BK;
      const int64_t m0 = static_cast<int64_t>(tile / prm.n_tiles) * BM;
      const int n0 = (tile % prm.n_tiles) * BN;
      const uint32_t slot = smem_base + (f % STAGES) * T::STAGE_BYTES;
#pragma unroll
      for (int i = 0; i < BM * 8 / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        const int row = idx >> 3, chunk = idx & 7;
        const int64_t gm = m0 + row < prm.rows ? m0 + row : prm.rows - 1;
        cp_async16(slot + row * 128 + ((chunk ^ (row & 7)) << 4), a_row(gm) + k0 + chunk * 4);
      }
#pragma unroll
      for (int i = 0; i < (BN * 8 + THREADS - 1) / THREADS; ++i) {
        const int idx = tid + i * THREADS;
        if (idx < BN * 8) {
          const int row = idx >> 3, chunk = idx & 7;
          const uint32_t off = row * 128 + ((chunk ^ (row & 7)) << 4);
          const int64_t wrow = static_cast<int64_t>(n0 + row) * K + k0 + chunk * 4;
          cp_async16(slot + A_BYTES + off, prm.whi + wrow);
          cp_async16(slot + A_BYTES + T::W_BYTES + off, prm.wlo + wrow);
        }
      }
    }
    cp_async_commit();
  };

  // This thread's part of the A operand of step f, half r, split into hi and lo:
  // for each k8 block, (row, k), (row + 8, k), (row, k + 4), (row + 8, k + 4).
  auto load_a = [&](int f, int r, uint32_t (&hi)[16], uint32_t (&lo)[16]) {
    const float* a = reinterpret_cast<const float*>(smem + (f % STAGES) * T::STAGE_BYTES) +
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
  auto products = [&](int f, float (&d)[HALF], const uint32_t (&hi)[16],
                      const uint32_t (&lo)[16]) {
    const uint32_t slot = smem_base + (f % STAGES) * T::STAGE_BYTES;
    const uint64_t dhi = matrix_descriptor(slot + A_BYTES);
    const uint64_t dlo = matrix_descriptor(slot + A_BYTES + T::W_BYTES);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // 32 bytes further along K inside the swizzled row: +2 in the address field.
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      Mma<BN>::run(d, lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2], lo[4 * kk + 3],
                   dhi + 2 * kk, kk != 0);
      Mma<BN>::run(d, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
                   dlo + 2 * kk, 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      Mma<BN>::run(d, hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2], hi[4 * kk + 3],
                   dhi + 2 * kk, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  };

  float acc[2][HALF] = {}, part[HALF] = {};
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
      // The products start from zero: part holds nothing across the epilogue.
#pragma unroll
      for (int i = 0; i < HALF; ++i) part[i] = 0.f;
      products(f, part, hi, lo);
      // The operand registers and the accumulator are the wgmma's until the
      // wait; the compiler sees the results only from here on.
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(hi[i]), "+r"(lo[i])::"memory");
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
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
      tile_epilogue<BN, SPP>(acc, prm, blockIdx.x + tiles_done * gridDim.x, row_in_tile, quad,
                        0xFu << (lane & ~3));
      ++tiles_done;
    } else {
      ++step_in_tile;
    }
  }
  cp_async_wait<0>();
}

// Adds the side planes to the output planes they belong to, in a fixed order:
// j[2n + s] += side[s]; j[2N + e] += side[2 + e]; l = ((l + side[2 + E]) +
// side[3 + 2E]) + side[4 + 2E]; d[e] = (d[e] + side[3 + E + e]) + side[5 + 2E + e].
__global__ void orbital_head_jet_finish_kernel(float2* __restrict__ out,
                                               const float2* __restrict__ side, int64_t plane,
                                               int nelec, int c, int e) {
  const int lap = c - e;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < plane;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(i % nelec);
    auto at = [&](int t) { return side[t * plane + i]; };
    auto add = [&](int to, float2 v) {
      float2 x = out[to * plane + i];
      x.x += v.x;
      x.y += v.y;
      out[to * plane + i] = x;
    };
    add(1 + 2 * n, at(0));
    add(2 + 2 * n, at(1));
    for (int k = 0; k < e; ++k) add(1 + lap + k, at(2 + k));
    add(1 + c, at(2 + e));
    add(1 + c, at(3 + 2 * e));
    add(1 + c, at(4 + 2 * e));
    for (int k = 0; k < e; ++k) {
      add(2 + c + k, at(3 + e + k));
      add(2 + c + k, at(5 + 2 * e + k));
    }
  }
}

template <int BN, int SPP>
int launch(const Params& prm, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(orbital_head_jet_kernel<BN, SPP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Tile<BN>::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int grid = prm.total_tiles < sms ? prm.total_tiles : sms;
  orbital_head_jet_kernel<BN, SPP><<<grid, THREADS, Tile<BN>::SMEM_BYTES, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

}  // namespace

// The orbital matrices' jet of the electrons [lo, lo + nsec) (one spin
// sector): out[p, b, det, e, n] for those n, and their side terms (see the
// file's head).  `width` is the column tile (64, 96, 112 or 128), `per_tile`
// pairs of `stride` columns each, whi / wlo [ceil(pairs / per_tile) width, D].
extern "C" int orbital_head_jet_f32(const float* a, const float* whi, const float* wlo,
                                    const void* bias, const void* ex, const void* ej,
                                    const void* el, const void* ed, void* out, void* side,
                                    int batch, int nelec, int lo, int nsec, int depth,
                                    int harmonics, int stride, int per_tile, int width, int ndet,
                                    int c, int e, void* stream) {
  Params prm;
  prm.a = a, prm.whi = whi, prm.wlo = wlo;
  prm.bias = static_cast<const float2*>(bias);
  prm.ex = static_cast<const float2*>(ex), prm.ej = static_cast<const float2*>(ej);
  prm.el = static_cast<const float2*>(el), prm.ed = static_cast<const float2*>(ed);
  prm.out = static_cast<float2*>(out), prm.side = static_cast<float2*>(side);
  prm.batch = batch, prm.nelec = nelec, prm.lo = lo, prm.nsec = nsec, prm.depth = depth;
  prm.harmonics = harmonics, prm.stride = stride, prm.per_tile = per_tile;
  prm.pairs = ndet * nelec, prm.ndet = ndet, prm.c = c, prm.e = e;
  const int planes = c + e + 2;
  prm.rows = static_cast<int64_t>(planes) * batch * nsec;
  const int64_t m_tiles = (prm.rows + BM - 1) / BM;
  const int n_tiles = per_tile > 0 ? (prm.pairs + per_tile - 1) / per_tile : 0;
  if (batch <= 0 || nelec <= 0 || nsec <= 0 || lo < 0 || lo + nsec > nelec || depth <= 0 ||
      depth % BK || harmonics <= 0 || stride % 8 || stride < 2 * harmonics || per_tile <= 0 ||
      per_tile * stride > width || ndet <= 0 || e < 1 || c - e != 2 * nelec ||
      prm.rows > 0x7fffffff || m_tiles * n_tiles > 0x7fffffff || misaligned(a, 16) || misaligned(whi, 16) ||
      misaligned(wlo, 16) || misaligned(bias, 8) || misaligned(ex, 8) || misaligned(ej, 8) ||
      misaligned(el, 8) || misaligned(ed, 8) || misaligned(out, 8) || misaligned(side, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  prm.n_tiles = n_tiles;
  prm.total_tiles = static_cast<int>(m_tiles * n_tiles);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    // The epilogue is compiled for the strides of 2Q+1 = 16 and 28 harmonics
    // (3 pairs of 32 columns, 2 of 56); every other stride takes its loop.
    case 64: return launch<64, 0>(prm, s);
    case 96: return stride == 32 ? launch<96, 4>(prm, s) : launch<96, 0>(prm, s);
    case 112: return stride == 56 ? launch<112, 7>(prm, s) : launch<112, 0>(prm, s);
    case 128: return launch<128, 0>(prm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Adds the side planes into the output (orbital_head_jet_finish_kernel); `plane`
// is B K N^2, the complex values of one plane.
extern "C" int orbital_head_jet_finish_f32(void* out, const void* side, int64_t plane, int nelec,
                                           int c, int e, void* stream) {
  if (plane <= 0 || nelec <= 0 || e < 1 || c - e != 2 * nelec || misaligned(out, 8) ||
      misaligned(side, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks = (plane + 255) / 256;
  const int grid = static_cast<int>(blocks < 8 * sms ? blocks : 8 * sms);
  orbital_head_jet_finish_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(out), static_cast<const float2*>(side), plane, nelec, c, e);
  return static_cast<int>(cudaGetLastError());
}
