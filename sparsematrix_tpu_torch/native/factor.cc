// ILU(0) and IC(0) factorizations in place on CSR, the host half of
// ops/ilu.py and ops/ichol.py.
//
// A copy of smtpu_ilu0 and smtpu_ic0 from the JAX package's host codec
// (sparsematrix_tpu/native/codec.cc), kept here so that the port builds
// them from its own sources: the factors must come out bit for bit equal
// to the JAX package's, so the walks are the same line for line.
//
// Built with g++ -O3 -shared -fPIC at first use (kernels/_build.py) and
// loaded with ctypes.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// ILU(0) factorization in place on CSR (sorted indices, fp64 values).
// IKJ restricted to the pattern; the inner update is a two-pointer merge
// of the sorted k-row/i-row tails (no hash lookups).
// Returns 0 on success, -1-i for a missing diagonal at row i,
// and -(n+1+k) for a zero pivot at row k.
long smtpu_ilu0(const int64_t* indptr, const int32_t* indices, double* a,
                long n) {
  std::vector<long> dpos(n);
  for (long i = 0; i < n; ++i) {
    const int32_t* lo = indices + indptr[i];
    const int32_t* hi = indices + indptr[i + 1];
    const int32_t* it = std::lower_bound(lo, hi, static_cast<int32_t>(i));
    if (it == hi || *it != i) return -1 - i;
    dpos[i] = indptr[i] + (it - lo);
  }
  for (long i = 1; i < n; ++i) {
    for (long s = indptr[i]; s < indptr[i + 1]; ++s) {
      const long k = indices[s];
      if (k >= i) break;
      const double piv = a[dpos[k]];
      if (piv == 0.0) return -(n + 1 + k);
      const double lik = a[s] / piv;
      a[s] = lik;
      long t = dpos[k] + 1;  // first j > k in row k
      long p = s + 1;        // row i tail (all j > k)
      const long tend = indptr[k + 1], pend = indptr[i + 1];
      while (t < tend && p < pend) {
        if (indices[t] < indices[p]) ++t;
        else if (indices[t] > indices[p]) ++p;
        else a[p++] -= lik * a[t++];
      }
    }
  }
  return 0;
}

// IC(0): incomplete Cholesky on the fixed pattern of tril(A).  CSR must
// have sorted indices with the diagonal present (last entry of each row).
// a[] holds tril(A) values on entry and L values on exit (row-wise
// up-looking walk; the row-i/row-j dot over columns < j is a two-pointer
// merge, as in smtpu_ilu0's update loop).
// Returns 0 on success, -1-i for a missing diagonal at row i, and
// -(n+1+i) for a non-positive pivot at row i.
long smtpu_ic0(const int64_t* indptr, const int32_t* indices, double* a,
               long n) {
  for (long i = 0; i < n; ++i) {
    const long end = indptr[i + 1];
    if (end == indptr[i] || indices[end - 1] != i) return -1 - i;
    for (long s = indptr[i]; s < end; ++s) {
      const long j = indices[s];
      // dot of rows i and j over columns < j; both diagonals are the
      // final entries of their rows, so the merge bounds exclude them
      double sum = 0.0;
      long p = indptr[i];
      long t = indptr[j];
      const long tend = indptr[j + 1] - 1;
      while (p < s && t < tend) {
        if (indices[p] < indices[t]) ++p;
        else if (indices[p] > indices[t]) ++t;
        else sum += a[p++] * a[t++];
      }
      if (j < i) {
        const double piv = a[tend];  // L[j][j]
        if (piv <= 0.0) return -(n + 1 + j);
        a[s] = (a[s] - sum) / piv;
      } else {  // j == i: the diagonal closes the row
        const double d = a[s] - sum;
        if (d <= 0.0) return -(n + 1 + i);
        a[s] = std::sqrt(d);
      }
    }
  }
  return 0;
}

}  // extern "C"
