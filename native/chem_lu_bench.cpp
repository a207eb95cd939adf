// Serial sparse-LU chemistry stage benchmark — the reference's
// execution model (KPP-generated KppDecomp/KppSolve, one cell at a
// time on one core; /root/reference/src/tot.f:39468, gas.f:6142-6236)
// reproduced from the same static symbolic structure the JAX solver
// uses, compiled -O3 on this machine.  This anchors the "reference
// serial CPU" side of the chemistry cell-steps/s comparison, since no
// Fortran compiler exists in this image (g++ on the same flat
// index-array loops is the closest stand-in for the KPP Fortran).
//
// Input (binary, little-endian int32/float32), written by
// benchmarks/bench_chem_native.py:
//   header  [6]  n, nnz, n_div, n_sub, n_solve_l, n_solve_u
//   div ops   [n_div * 2]    (target, pivot) slot indices
//   sub ops   [n_sub * 3]    (target, left, right) slot indices
//   solveL    [n_solve_l * 3] (row i, row j, slot(i,j)), rows ascending
//   solveU    [n_solve_u * 3] (row i, row j, slot(i,j)), rows
//             descending, with (i, diag_slot, -1) sentinel entries that
//             divide x[i] by U[i,i] once the row is complete
//   diag      [n]            slot(i,i)
//   vals0     [nnz]          representative matrix values (float32)
//
// One "step" = 1 decompose + 3 forward/backward solves (the Ros3 stage
// pattern).  Usage: chem_lu_bench <schedule.bin> <cells> <reps>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char **argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s bin cells reps\n", argv[0]);
    return 1;
  }
  FILE *f = std::fopen(argv[1], "rb");
  if (!f) { std::perror("open"); return 1; }
  int32_t hdr[6];
  if (std::fread(hdr, 4, 6, f) != 6) return 1;
  const int n = hdr[0], nnz = hdr[1], ndiv = hdr[2], nsub = hdr[3],
            nsl = hdr[4], nsu = hdr[5];
  std::vector<int32_t> div(2 * (size_t)ndiv), sub(3 * (size_t)nsub),
      sl(3 * (size_t)nsl), su(3 * (size_t)nsu), diag(n);
  std::vector<float> vals0(nnz);
  auto rd = [&](void *p, size_t cnt) {
    return std::fread(p, 4, cnt, f) == cnt;
  };
  if (!rd(div.data(), div.size()) || !rd(sub.data(), sub.size()) ||
      !rd(sl.data(), sl.size()) || !rd(su.data(), su.size()) ||
      !rd(diag.data(), diag.size()) || !rd(vals0.data(), nnz)) {
    std::fprintf(stderr, "short read\n");
    return 1;
  }
  std::fclose(f);

  const long cells = std::atol(argv[2]);
  const int reps = std::atoi(argv[3]);

  std::vector<double> a(nnz), x(n), b(n);
  for (int i = 0; i < n; ++i) b[i] = 1.0 + 0.001 * i;

  double sink = 0.0;
  auto t0 = std::chrono::steady_clock::now();
  for (int r = 0; r < reps; ++r) {
    for (long c = 0; c < cells; ++c) {
      // fresh numeric values per cell (the Jacobian differs per cell)
      for (int i = 0; i < nnz; ++i) a[i] = vals0[i] + 1e-6 * (c & 7);
      // KppDecomp: pivot-free elimination over the static schedule
      for (int i = 0; i < ndiv; ++i)
        a[div[2 * i]] /= a[div[2 * i + 1]];
      for (int i = 0; i < nsub; ++i)
        a[sub[3 * i]] -= a[sub[3 * i + 1]] * a[sub[3 * i + 2]];
      // 3 stage solves (KppSolve substitutions)
      for (int s = 0; s < 3; ++s) {
        for (int i = 0; i < n; ++i) x[i] = b[i] + 0.01 * s;
        for (int i = 0; i < nsl; ++i)
          x[sl[3 * i]] -= a[sl[3 * i + 2]] * x[sl[3 * i + 1]];
        for (int i = 0; i < nsu; ++i) {
          const int32_t t = su[3 * i], j = su[3 * i + 1],
                        sl_ = su[3 * i + 2];
          if (sl_ < 0) x[t] /= a[j];
          else x[t] -= a[sl_] * x[j];
        }
        sink += x[n - 1];
      }
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  double steps = (double)cells * reps;
  std::printf("{\"cell_steps_per_s\": %.1f, \"secs\": %.3f, "
              "\"sink\": %g}\n", steps / secs, secs, sink);
  return 0;
}
