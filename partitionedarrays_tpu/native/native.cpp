// Native host-side setup kernels.
//
// The reference reaches native code only through libmpi (src/mpi_array.jl);
// in this framework the per-iteration native path is the compiled XLA
// program, and THIS library accelerates the remaining host-side setup hot
// loops (problem assembly, coarsening) that would otherwise run as
// numpy/scipy passes: COO->CSR compression with duplicate summation
// (reference counterpart: compresscoo, src/sparse_utils.jl:286-350), greedy
// graph coloring (multicolor Gauss-Seidel setup), and Vanek aggregation
// (PartitionedSolvers/src/amg.jl:13-134).
//
// Plain C ABI + ctypes on the Python side; build with:
//   g++ -O3 -march=native -shared -fPIC native.cpp -o libpatnative.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// COO (i64 rows/cols, f64 vals) -> CSR with duplicates summed.
// indices/data must have capacity nnz; indptr capacity m+1.
// Returns the compacted nnz (entries with negative row/col are dropped).
int64_t coo_to_csr(
    const int64_t* I, const int64_t* J, const double* V, int64_t nnz,
    int64_t m, int64_t* indptr, int64_t* indices, double* data) {
  std::vector<int64_t> count(m + 1, 0);
  for (int64_t k = 0; k < nnz; ++k) {
    if (I[k] >= 0 && J[k] >= 0) count[I[k] + 1]++;
  }
  for (int64_t r = 0; r < m; ++r) count[r + 1] += count[r];
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  std::vector<int64_t> cols(count[m]);
  std::vector<double> vals(count[m]);
  for (int64_t k = 0; k < nnz; ++k) {
    if (I[k] < 0 || J[k] < 0) continue;
    int64_t p = cursor[I[k]]++;
    cols[p] = J[k];
    vals[p] = V[k];
  }
  // per-row: sort by column, merge duplicates, write compacted
  int64_t w = 0;
  indptr[0] = 0;
  std::vector<int64_t> order;
  for (int64_t r = 0; r < m; ++r) {
    int64_t lo = count[r], hi = count[r + 1];
    int64_t len = hi - lo;
    order.resize(len);
    for (int64_t t = 0; t < len; ++t) order[t] = lo + t;
    std::sort(order.begin(), order.end(),
              [&](int64_t a, int64_t b) { return cols[a] < cols[b]; });
    int64_t t = 0;
    while (t < len) {
      int64_t c = cols[order[t]];
      double s = 0.0;
      while (t < len && cols[order[t]] == c) {
        s += vals[order[t]];
        ++t;
      }
      indices[w] = c;
      data[w] = s;
      ++w;
    }
    indptr[r + 1] = w;
  }
  return w;
}

// Greedy graph coloring over a symmetrized CSR adjacency.
// colors must have capacity n; returns number of colors.
int64_t greedy_coloring(
    const int64_t* indptr, const int64_t* indices, int64_t n,
    int32_t* colors) {
  std::fill(colors, colors + n, -1);
  std::vector<int32_t> mark(64, -1);
  int64_t n_colors = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t j = indices[p];
      if (j < n && colors[j] >= 0) {
        if (colors[j] < (int64_t)mark.size()) mark[colors[j]] = (int32_t)i;
      }
    }
    int32_t c = 0;
    while (c < (int32_t)mark.size() && mark[c] == (int32_t)i) ++c;
    if (c >= (int32_t)mark.size()) mark.resize(mark.size() * 2, -1);
    colors[i] = c;
    if (c + 1 > n_colors) n_colors = c + 1;
  }
  return n_colors;
}

// Vanek et al. alg 5.1 aggregation (3 passes) over a local CSR matrix.
// strength: |a_ij| > eps*sqrt(|a_ii*a_jj|).  agg must have capacity n.
// Returns the number of aggregates.
int64_t vanek_aggregate(
    const int64_t* indptr, const int64_t* indices, const double* data,
    int64_t n, double eps, int64_t* agg) {
  std::vector<double> diag(n, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (indices[p] == i) diag[i] = std::fabs(data[p]);
    }
  }
  auto strong = [&](int64_t i, int64_t p) {
    int64_t j = indices[p];
    if (j == i) return true;
    double thr = eps * std::sqrt(diag[i] * diag[j]);
    return std::fabs(data[p]) > thr;
  };
  std::fill(agg, agg + n, (int64_t)-1);
  int64_t next_agg = 0;
  // pass 1
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool all_free = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1] && all_free; ++p) {
      if (strong(i, p) && agg[indices[p]] != -1) all_free = false;
    }
    if (!all_free) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong(i, p)) agg[indices[p]] = next_agg;
    }
    agg[i] = next_agg;
    ++next_agg;
  }
  // pass 2: attach to a neighboring aggregate (based on pass-1 state)
  std::vector<int64_t> attach(agg, agg + n);
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (strong(i, p) && agg[indices[p]] != -1) {
        attach[i] = agg[indices[p]];
        break;
      }
    }
  }
  std::memcpy(agg, attach.data(), n * sizeof(int64_t));
  // pass 3: leftovers become singletons
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] == -1) agg[i] = next_agg++;
  }
  return next_agg;
}

// ILU(0): incomplete LU with zero fill, in place on a CANONICAL CSR
// (sorted indices, diagonal present in every row).  On return, strict
// lower entries hold L (unit diagonal implicit) and diagonal+upper hold
// U — the combined storage of the classic IKJ algorithm.  Zero/tiny
// pivots are perturbed to keep the factorization finite.  Returns the
// number of perturbed pivots.
int64_t ilu0(
    const int64_t* indptr, const int64_t* indices, double* data, int64_t n) {
  std::vector<int64_t> pos(n, -1);      // column -> position in row i
  std::vector<int64_t> diagpos(n, -1);  // per-row diagonal position
  int64_t perturbed = 0;
  double scale = 0.0;
  for (int64_t p = 0; p < indptr[n]; ++p) scale += std::fabs(data[p]);
  scale = scale > 0 ? scale / indptr[n] : 1.0;
  const double tiny = 1e-12 * scale;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    for (int64_t p = lo; p < hi; ++p) {
      pos[indices[p]] = p;
      if (indices[p] == i) diagpos[i] = p;
    }
    for (int64_t p = lo; p < hi; ++p) {
      const int64_t k = indices[p];
      if (k >= i) break;  // sorted: strict-lower prefix
      const int64_t dk = diagpos[k];
      data[p] /= data[dk];
      const double lik = data[p];
      for (int64_t q = dk + 1; q < indptr[k + 1]; ++q) {
        const int64_t pp = pos[indices[q]];
        if (pp >= 0) data[pp] -= lik * data[q];
      }
    }
    if (diagpos[i] < 0) return -1;  // structurally missing diagonal
    if (std::fabs(data[diagpos[i]]) < tiny) {
      data[diagpos[i]] = data[diagpos[i]] >= 0 ? tiny : -tiny;
      ++perturbed;
    }
    for (int64_t p = lo; p < hi; ++p) pos[indices[p]] = -1;
  }
  return perturbed;
}

}  // extern "C"
