// Matrix-free Hamiltonian matvec for the LLL exact-diagonalization oracle.
//
// The pure-NumPy path in ed.py builds dense Lz blocks, which caps it at a few
// thousand states; the N=10 (2Q=27) and N=12 (2Q=23) production anchors need
// blocks of ~10^5 states where only a matrix-free Lanczos is practical and
// the per-matvec inner loop (dim x pairs x orbitals candidate scatterings,
// ~10^8-10^9 per call) is far beyond Python. This kernel applies
//
//   y += sum_{i<j occupied} sum_{k<l, m_k+m_l = m_i+m_j} <kl|V|ij>_A
//          * sign(c+_k c+_l c_j c_i) * x[row]
//
// over occupation bitmasks, with the same sign convention as
// ed._apply_interaction (annihilation parity = popcount below the orbital;
// creation parity = popcount of the remainder below the target) — pinned
// against the Python path by tests/test_ed_native.py.
//
// Basis lookup is an open-addressing hash table (power-of-2, multiply-shift,
// linear probing) built once per context; masks fit in 32 bits (n_orb <= 32).
//
// Built on demand by ed_native.py with the system g++ (no pip/pybind11 in
// this image); exposed via a C ABI for ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

struct Context {
  int n_orb;
  int64_t dim;
  const uint32_t* masks;   // borrowed from the caller (kept alive in Python)
  const double* v4;        // [n^4], <a'b'|V|ab> at ((a'*n + b')*n + a)*n + b
  // open-addressing mask -> row table
  uint32_t* keys;          // EMPTY = 0xFFFFFFFF
  int64_t* vals;
  uint64_t table_mask;     // size - 1 (size = power of two)
};

constexpr uint32_t kEmpty = 0xFFFFFFFFu;

inline uint64_t hash_mask(uint32_t m, uint64_t table_mask) {
  uint64_t h = m * 0x9E3779B97F4A7C15ull;
  return (h >> 32) & table_mask;
}

inline int64_t lookup(const Context* ctx, uint32_t mask) {
  uint64_t slot = hash_mask(mask, ctx->table_mask);
  while (true) {
    uint32_t k = ctx->keys[slot];
    if (k == mask) return ctx->vals[slot];
    if (k == kEmpty) return -1;
    slot = (slot + 1) & ctx->table_mask;
  }
}

}  // namespace

extern "C" {

void* ed_ctx_create(int n_orb, int64_t dim, const uint32_t* masks,
                    const double* v4) {
  auto* ctx = new Context;
  ctx->n_orb = n_orb;
  ctx->dim = dim;
  ctx->masks = masks;
  ctx->v4 = v4;
  uint64_t size = 1;
  while (size < static_cast<uint64_t>(dim) * 2 + 1) size <<= 1;
  ctx->table_mask = size - 1;
  ctx->keys = static_cast<uint32_t*>(std::malloc(size * sizeof(uint32_t)));
  ctx->vals = static_cast<int64_t*>(std::malloc(size * sizeof(int64_t)));
  std::memset(ctx->keys, 0xFF, size * sizeof(uint32_t));
  for (int64_t r = 0; r < dim; ++r) {
    uint64_t slot = hash_mask(masks[r], ctx->table_mask);
    while (ctx->keys[slot] != kEmpty) slot = (slot + 1) & ctx->table_mask;
    ctx->keys[slot] = masks[r];
    ctx->vals[slot] = r;
  }
  return ctx;
}

void ed_ctx_free(void* p) {
  auto* ctx = static_cast<Context*>(p);
  std::free(ctx->keys);
  std::free(ctx->vals);
  delete ctx;
}

// y = H x  (y must be zero-initialised by the caller)
void ed_matvec(const void* p, const double* x, double* y) {
  const auto* ctx = static_cast<const Context*>(p);
  const int n = ctx->n_orb;
  const double* v4 = ctx->v4;
  const int64_t n3 = static_cast<int64_t>(n) * n * n;
  const int64_t n2 = static_cast<int64_t>(n) * n;

  for (int64_t row = 0; row < ctx->dim; ++row) {
    const double amp = x[row];
    if (amp == 0.0) continue;
    const uint32_t mask = ctx->masks[row];
    // enumerate occupied orbital pairs i < j
    uint32_t mi_bits = mask;
    while (mi_bits) {
      const int i = __builtin_ctz(mi_bits);
      mi_bits &= mi_bits - 1;
      uint32_t mj_bits = mi_bits;  // j > i
      while (mj_bits) {
        const int j = __builtin_ctz(mj_bits);
        mj_bits &= mj_bits - 1;
        const uint32_t below_i = (1u << i) - 1u;
        const uint32_t below_j = (1u << j) - 1u;
        const int par0 = __builtin_popcount(mask & below_i) +
                         __builtin_popcount(mask & below_j) + 1;
        const uint32_t rest = mask & ~(1u << i) & ~(1u << j);
        const int sum_ij = i + j;  // Lz conservation on orbital indices
        const int k_lo = sum_ij - (n - 1) > 0 ? sum_ij - (n - 1) : 0;
        // k < l = sum_ij - k  =>  k < sum_ij / 2
        for (int k = k_lo; 2 * k < sum_ij; ++k) {
          const int l = sum_ij - k;
          if (l >= n) continue;
          const uint32_t bk = 1u << k, bl = 1u << l;
          if ((rest & bk) || (rest & bl)) continue;
          const double el = v4[k * n3 + l * n2 + i * n + j] -
                            v4[l * n3 + k * n2 + i * n + j];
          if (el == 0.0) continue;
          const int par1 = __builtin_popcount(rest & (bk - 1u)) +
                           __builtin_popcount(rest & (bl - 1u));
          const int64_t col = lookup(ctx, rest | bk | bl);
          if (col < 0) continue;  // outside this Lz block (cannot happen)
          const double sgn = ((par0 + par1) & 1) ? -1.0 : 1.0;
          y[col] += sgn * el * amp;
        }
      }
    }
  }
}

}  // extern "C"
