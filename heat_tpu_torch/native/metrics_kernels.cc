// Native metric hit-matrix computation.
//
// The reference computes per-user metric hits with Python set operations
// per user (cf/metrics.py:44-47 etc.) — the host-side hot loop of
// evaluation. This OpenMP kernel computes the (U, k) hit matrix (is ranked
// item i in the user's truth set?) with binary search over sorted truth
// lists; the Python metric formulas then run vectorized on the result.
//
// C ABI for ctypes:
//   hits_matrix(top (U*k) i32, U, k,
//               truth (total) i32 sorted per user, offsets (U+1) i64,
//               out (U*k) f64)

#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

inline bool contains(const int32_t* begin, const int32_t* end, int32_t x) {
  // branchless-ish binary search over a sorted range
  while (begin < end) {
    const int32_t* mid = begin + (end - begin) / 2;
    if (*mid == x) return true;
    if (*mid < x) {
      begin = mid + 1;
    } else {
      end = mid;
    }
  }
  return false;
}

}  // namespace

extern "C" {

void hits_matrix(const int32_t* top, int64_t num_users, int64_t k,
                 const int32_t* truth, const int64_t* offsets, double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t u = 0; u < num_users; ++u) {
    const int32_t* begin = truth + offsets[u];
    const int32_t* end = truth + offsets[u + 1];
    for (int64_t i = 0; i < k; ++i) {
      out[u * k + i] = contains(begin, end, top[u * k + i]) ? 1.0 : 0.0;
    }
  }
}

}  // extern "C"
