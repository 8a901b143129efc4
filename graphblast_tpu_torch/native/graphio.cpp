// graphio.cpp — native graph-ingest runtime of graphblast_tpu_torch.
//
// The host-side C++ ingest stack of the reference (graphblas/mmio.hpp MTX
// parser, graphblas/util.hpp:263-329 removeSelfloop dedup, :170-195
// customSort, :501-572 coo2csr/csc), the package's own copy of the JAX
// package's graphblast_tpu/native/graphio.cpp. The NumPy path of
// io/mmio.py is the semantic ground truth; this library runs the same
// pipeline for large .mtx files and COO arrays. Exposed via ctypes.
//
// Build (native/__init__.py does it at the first call):
//   g++ -O3 -std=c++17 -shared -fPIC graphio.cpp -o libgraphio-<hash>.so

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Coo {
  std::vector<int64_t> rows, cols;
  std::vector<double> vals;
};

// One stable counting-sort pass of the COO by `keys` (O(m + range)).
void counting_pass(Coo& c, const std::vector<int64_t>& keys, int64_t range) {
  const size_t n = c.rows.size();
  std::vector<int64_t> cnt(static_cast<size_t>(range) + 1, 0);
  for (size_t i = 0; i < n; ++i) cnt[keys[i] + 1]++;
  for (int64_t k = 0; k < range; ++k) cnt[k + 1] += cnt[k];
  Coo out;
  out.rows.resize(n); out.cols.resize(n); out.vals.resize(n);
  for (size_t i = 0; i < n; ++i) {
    int64_t p = cnt[keys[i]]++;
    out.rows[p] = c.rows[i];
    out.cols[p] = c.cols[i];
    out.vals[p] = c.vals[i];
  }
  c = std::move(out);
}

// column-major order: primary key col, secondary row (reference customSort),
// as a two-pass stable radix — O(m + n) instead of comparison sort
void sort_col_major(Coo& c) {
  int64_t maxid = 0;
  for (size_t i = 0; i < c.rows.size(); ++i)
    maxid = std::max(maxid, std::max(c.rows[i], c.cols[i]));
  std::vector<int64_t> keys = c.rows;
  counting_pass(c, keys, maxid + 1);      // secondary: row
  counting_pass(c, c.cols, maxid + 1);    // primary: col (stable)
}

// symmetric doubling + self-loop removal + dedup (reference semantics:
// util.hpp:263-329 — doubling first, then col-major sort, keep first)
void canonicalize(Coo& c, bool undirected, bool remove_self_loops) {
  if (undirected) {
    const size_t n = c.rows.size();
    for (size_t i = 0; i < n; ++i) {
      if (c.rows[i] != c.cols[i]) {
        c.rows.push_back(c.cols[i]);
        c.cols.push_back(c.rows[i]);
        c.vals.push_back(c.vals[i]);
      }
    }
  }
  sort_col_major(c);
  Coo out;
  out.rows.reserve(c.rows.size());
  out.cols.reserve(c.rows.size());
  out.vals.reserve(c.rows.size());
  for (size_t i = 0; i < c.rows.size(); ++i) {
    if (remove_self_loops && c.rows[i] == c.cols[i]) continue;
    if (!out.rows.empty() && out.rows.back() == c.rows[i] &&
        out.cols.back() == c.cols[i])
      continue;  // duplicate: keep first in (col,row) order
    out.rows.push_back(c.rows[i]);
    out.cols.push_back(c.cols[i]);
    out.vals.push_back(c.vals[i]);
  }
  c = std::move(out);
}

}  // namespace

extern "C" {

// COO -> CSR in O(m + n) via two counting-sort passes (stable radix on
// (row, col)) — reference: util.hpp:501-559 coo2csr, replacing the NumPy
// lexsort (O(m log m) comparison sort) for large builds.
// Caller allocates row_ptr_out (nrows+1), cols_out (m), vals_out (m).
int gb_coo_to_csr(int64_t m, int64_t nrows, int64_t ncols,
                  const int64_t* rows, const int64_t* cols,
                  const double* vals,
                  int64_t* row_ptr_out, int64_t* cols_out, double* vals_out) {
  if (m < 0 || nrows < 0 || ncols < 0) return 1;
  // pass 1: stable counting sort by col
  std::vector<int64_t> cnt(static_cast<size_t>(ncols) + 1, 0);
  for (int64_t e = 0; e < m; ++e) {
    if (cols[e] < 0 || cols[e] >= ncols || rows[e] < 0 || rows[e] >= nrows)
      return 2;
    cnt[cols[e] + 1]++;
  }
  for (int64_t c = 0; c < ncols; ++c) cnt[c + 1] += cnt[c];
  std::vector<int64_t> r1(m), c1(m);
  std::vector<double> v1(m);
  for (int64_t e = 0; e < m; ++e) {
    int64_t p = cnt[cols[e]]++;
    r1[p] = rows[e];
    c1[p] = cols[e];
    v1[p] = vals[e];
  }
  // pass 2: stable counting sort by row (preserves col order within rows)
  std::memset(row_ptr_out, 0, sizeof(int64_t) * (nrows + 1));
  for (int64_t e = 0; e < m; ++e) row_ptr_out[r1[e] + 1]++;
  for (int64_t r = 0; r < nrows; ++r) row_ptr_out[r + 1] += row_ptr_out[r];
  std::vector<int64_t> pos(row_ptr_out, row_ptr_out + nrows);
  for (int64_t e = 0; e < m; ++e) {
    int64_t p = pos[r1[e]]++;
    cols_out[p] = c1[e];
    vals_out[p] = v1[e];
  }
  return 0;
}

// Parse + canonicalize a MatrixMarket coordinate file.
// directed: 0 honor banner, 1 force directed, 2 force undirected
// Returns 0 on success. Output arrays are malloc'd; free with gb_free.
int gb_read_mtx(const char* path, int directed, int remove_self_loops,
                int64_t* nrows_out, int64_t* ncols_out, int64_t* nvals_out,
                int64_t** rows_out, int64_t** cols_out, double** vals_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;

  char line[2048];
  if (!fgets(line, sizeof line, f)) { fclose(f); return 2; }
  // banner: %%MatrixMarket matrix coordinate <field> <symmetry>
  char obj[64], fmt[64], field[64], sym[64];
  if (sscanf(line, "%%%%MatrixMarket %63s %63s %63s %63s",
             obj, fmt, field, sym) != 4) { fclose(f); return 3; }
  for (char* p = field; *p; ++p) *p = (char)tolower(*p);
  for (char* p = sym; *p; ++p) *p = (char)tolower(*p);
  const bool pattern = strcmp(field, "pattern") == 0;
  bool undirected = strcmp(sym, "symmetric") == 0 || directed == 2;
  if (directed == 1) undirected = false;

  // skip comments
  do {
    if (!fgets(line, sizeof line, f)) { fclose(f); return 4; }
  } while (line[0] == '%');

  long long nr, nc, nv;
  if (sscanf(line, "%lld %lld %lld", &nr, &nc, &nv) != 3) {
    fclose(f);
    return 5;
  }

  Coo c;
  c.rows.reserve(nv); c.cols.reserve(nv); c.vals.reserve(nv);
  for (long long i = 0; i < nv; ++i) {
    long long r, cc;
    double v = 1.0;
    if (pattern) {
      if (fscanf(f, "%lld %lld", &r, &cc) != 2) { fclose(f); return 6; }
    } else {
      if (fscanf(f, "%lld %lld %lf", &r, &cc, &v) != 3) { fclose(f); return 6; }
    }
    c.rows.push_back(r - 1);  // 1-based -> 0-based
    c.cols.push_back(cc - 1);
    c.vals.push_back(v);
  }
  fclose(f);

  canonicalize(c, undirected, remove_self_loops != 0);

  const size_t n = c.rows.size();
  auto* ro = static_cast<int64_t*>(malloc(n * sizeof(int64_t)));
  auto* co = static_cast<int64_t*>(malloc(n * sizeof(int64_t)));
  auto* vo = static_cast<double*>(malloc(n * sizeof(double)));
  if (!ro || !co || !vo) { free(ro); free(co); free(vo); return 7; }
  memcpy(ro, c.rows.data(), n * sizeof(int64_t));
  memcpy(co, c.cols.data(), n * sizeof(int64_t));
  memcpy(vo, c.vals.data(), n * sizeof(double));

  *nrows_out = nr;
  *ncols_out = nc;
  *nvals_out = (int64_t)n;
  *rows_out = ro;
  *cols_out = co;
  *vals_out = vo;
  return 0;
}

// COO -> CSR (reference: util.hpp:501-559). Inputs need not be sorted.
// row_ptr: caller-allocated (nrows+1); col_ind/val: caller-allocated (nvals).
void gb_coo2csr(const int64_t* rows, const int64_t* cols, const double* vals,
                int64_t nvals, int64_t nrows,
                int64_t* row_ptr, int32_t* col_ind, float* val) {
  memset(row_ptr, 0, (nrows + 1) * sizeof(int64_t));
  for (int64_t i = 0; i < nvals; ++i) row_ptr[rows[i] + 1]++;
  for (int64_t i = 0; i < nrows; ++i) row_ptr[i + 1] += row_ptr[i];
  std::vector<int64_t> cursor(row_ptr, row_ptr + nrows);
  // stable fill; then sort each row's slice by column
  for (int64_t i = 0; i < nvals; ++i) {
    int64_t p = cursor[rows[i]]++;
    col_ind[p] = (int32_t)cols[i];
    val[p] = (float)vals[i];
  }
  for (int64_t r = 0; r < nrows; ++r) {
    int64_t lo = row_ptr[r], hi = row_ptr[r + 1];
    std::vector<std::pair<int32_t, float>> tmp;
    tmp.reserve(hi - lo);
    for (int64_t p = lo; p < hi; ++p) tmp.emplace_back(col_ind[p], val[p]);
    std::sort(tmp.begin(), tmp.end());
    for (int64_t p = lo; p < hi; ++p) {
      col_ind[p] = tmp[p - lo].first;
      val[p] = tmp[p - lo].second;
    }
  }
}

// Canonicalize raw COO triplets (e.g. generator output). Outputs malloc'd.
int64_t gb_canonicalize(const int64_t* rows, const int64_t* cols,
                        const double* vals, int64_t nvals, int undirected,
                        int remove_self_loops, int64_t** rows_out,
                        int64_t** cols_out, double** vals_out) {
  Coo c;
  c.rows.assign(rows, rows + nvals);
  c.cols.assign(cols, cols + nvals);
  c.vals.assign(vals, vals + nvals);
  canonicalize(c, undirected != 0, remove_self_loops != 0);
  const size_t n = c.rows.size();
  auto* ro = static_cast<int64_t*>(malloc(n * sizeof(int64_t)));
  auto* co = static_cast<int64_t*>(malloc(n * sizeof(int64_t)));
  auto* vo = static_cast<double*>(malloc(n * sizeof(double)));
  memcpy(ro, c.rows.data(), n * sizeof(int64_t));
  memcpy(co, c.cols.data(), n * sizeof(int64_t));
  memcpy(vo, c.vals.data(), n * sizeof(double));
  *rows_out = ro;
  *cols_out = co;
  *vals_out = vo;
  return (int64_t)n;
}

void gb_free(void* p) { free(p); }

}  // extern "C"
