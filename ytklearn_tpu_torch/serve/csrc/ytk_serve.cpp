// Native serve-side binned GBDT kernels for the host (serve/kernels.py
// bindings): a copy of the JAX package's native/ytk_serve.cpp.
//
// Two entry families:
//
// ytk_serve_bin_{u8,u16}: raw f64 request rows -> bin indices against
// per-feature sorted edge tables, one batch at a time. mode 0
// ("thresholds"): bin = #edges < value (lower_bound). mode 1 ("edges"):
// the training nearest-representative rule of gbdt/binning.bin_matrix —
// first edge >= value, pulled down when the value sits below the midpoint
// of the surrounding pair, values past the last edge clamp to it. All
// comparisons in f64, bit-matching the numpy version
// (serve/kernels.bin_rows_plain). NaN = missing -> sentinel. Every
// binned-rung batch is binned here before K7 launches on the card.
//
// ytk_serve_score_{u8,u16}: the CPU binned rung. Traverse every tree for
// every row on the bin indices. Trees are perfect heaps
// (Tree.heap_arrays): slot p's children are 2p+1/2p+2, nodes packed one
// int32 per slot (feat 12b | rank+1 16b | default_left 1b —
// serve/kernels.pack_heap_nodes), and the step is BRANCHLESS:
//
//     go_left = (v < rank1) | ((v == sentinel) & default_left)
//     slot    = 2*slot + 2 - go_left
//
// (real-node rank1 is always < sentinel and pad-chain slots carry the
// all-ones rank, so the single unsigned compare covers missing routing —
// a data-dependent 50/50 ternary here cost 3x in branch mispredicts).
// Rows walk in LOCKSTEP blocks of 32: the depth loop iterates 32
// independent slot chains so the out-of-order window overlaps their
// L1 loads instead of serializing one row's 6-deep dependency chain.
// Per-row tree accumulation is an f64 left fold in ascending tree order —
// the exact operation order of GBDTPredictor.batch_scores, the stacked
// rung and K7, so binned scores stay bit-identical end to end. OpenMP
// splits row blocks across threads (rows are independent; the per-row
// fold order is untouched).

#include <algorithm>
#include <cstdint>

namespace {

constexpr int64_t kBlock = 32;

inline int64_t lower_bound_f64(const double* v, int64_t n, double x) {
  // branchless (cmov) halving: a data-dependent branchy bisection costs
  // ~1 mispredict per level, which dominated the whole binning pass
  int64_t lo = 0;
  while (n > 1) {
    const int64_t half = n >> 1;
    lo += (v[lo + half - 1] < x) ? half : 0;
    n -= half;
  }
  lo += (v[lo] < x) ? 1 : 0;
  return lo;  // first index with v[i] >= x == #elements < x
}

template <typename BinT>
void bin_rows(const double* X, int64_t n_rows, int64_t n_feat,
              const double* edges, const int64_t* offsets,
              const int64_t* counts, int32_t mode, int32_t sentinel,
              BinT* out, int32_t n_threads) {
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t b = 0; b < n_rows; ++b) {
    const double* row = X + b * n_feat;
    BinT* orow = out + b * n_feat;
    for (int64_t f = 0; f < n_feat; ++f) {
      const double x = row[f];
      if (x != x) {  // NaN = missing
        orow[f] = static_cast<BinT>(sentinel);
        continue;
      }
      const double* v = edges + offsets[f];
      const int64_t cnt = counts[f];
      int64_t i = lower_bound_f64(v, cnt, x);
      if (mode == 0) {  // thresholds: #edges < x
        orow[f] = static_cast<BinT>(i);
        continue;
      }
      // edges: nearest representative, ties to the upper one
      const bool over = x > v[cnt - 1];
      i = std::min(i, cnt - 1);
      if (i >= 1 && !over && x < 0.5 * (v[i - 1] + v[i])) {
        i -= 1;
      }
      orow[f] = static_cast<BinT>(over ? cnt - 1 : i);
    }
  }
}

template <typename BinT>
void score_rows(const BinT* bins, int64_t n_rows, int64_t n_feat,
                const int32_t* packed, const double* leaf, int64_t n_trees,
                int64_t heap, int64_t last, int32_t depth, int32_t sentinel,
                double* out, int32_t n_threads) {
  const int64_t n_blocks = (n_rows + kBlock - 1) / kBlock;
#pragma omp parallel for num_threads(n_threads) schedule(static)
  for (int64_t blk = 0; blk < n_blocks; ++blk) {
    const int64_t b0 = blk * kBlock;
    const int64_t nb = std::min(n_rows, b0 + kBlock) - b0;
    double acc[kBlock];
    int32_t slot[kBlock];
    for (int64_t i = 0; i < nb; ++i) acc[i] = 0.0;
    for (int64_t t = 0; t < n_trees; ++t) {
      const int32_t* pk = packed + t * heap;
      const double* lv = leaf + t * last;
      for (int64_t i = 0; i < nb; ++i) slot[i] = 0;
      for (int32_t d = 0; d < depth; ++d) {
        for (int64_t i = 0; i < nb; ++i) {
          const int32_t p = pk[slot[i]];
          const int32_t v =
              static_cast<int32_t>(bins[(b0 + i) * n_feat + (p & 0xFFF)]);
          const int32_t rank1 = (p >> 12) & 0xFFFF;
          const int32_t go_left =
              (v < rank1) | ((v == sentinel) & (p >> 28));
          slot[i] = 2 * slot[i] + 2 - go_left;
        }
      }
      for (int64_t i = 0; i < nb; ++i) {
        acc[i] += lv[slot[i] - (heap - last)];
      }
    }
    for (int64_t i = 0; i < nb; ++i) out[b0 + i] = acc[i];
  }
}

}  // namespace

extern "C" {

void ytk_serve_bin_u8(const double* X, int64_t n_rows, int64_t n_feat,
                      const double* edges, const int64_t* offsets,
                      const int64_t* counts, int32_t mode, int32_t sentinel,
                      uint8_t* out, int32_t n_threads) {
  bin_rows<uint8_t>(X, n_rows, n_feat, edges, offsets, counts, mode,
                    sentinel, out, n_threads);
}

void ytk_serve_bin_u16(const double* X, int64_t n_rows, int64_t n_feat,
                       const double* edges, const int64_t* offsets,
                       const int64_t* counts, int32_t mode,
                       int32_t sentinel, uint16_t* out, int32_t n_threads) {
  bin_rows<uint16_t>(X, n_rows, n_feat, edges, offsets, counts, mode,
                     sentinel, out, n_threads);
}

void ytk_serve_score_u8(const uint8_t* bins, int64_t n_rows, int64_t n_feat,
                        const int32_t* packed, const double* leaf,
                        int64_t n_trees, int64_t heap, int64_t last,
                        int32_t depth, int32_t sentinel, double* out,
                        int32_t n_threads) {
  score_rows<uint8_t>(bins, n_rows, n_feat, packed, leaf, n_trees, heap,
                      last, depth, sentinel, out, n_threads);
}

void ytk_serve_score_u16(const uint16_t* bins, int64_t n_rows,
                         int64_t n_feat, const int32_t* packed,
                         const double* leaf, int64_t n_trees, int64_t heap,
                         int64_t last, int32_t depth, int32_t sentinel,
                         double* out, int32_t n_threads) {
  score_rows<uint16_t>(bins, n_rows, n_feat, packed, leaf, n_trees, heap,
                       last, depth, sentinel, out, n_threads);
}

}  // extern "C"
