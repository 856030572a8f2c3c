// Periodic k-nearest-neighbor search with distance-shell edge features.
//
// Native C++ core of the offline featurizer (the reference's `prepare` hot
// loop, reference CGAT/prepare_data.py:146-169, which leans on pymatgen's
// get_all_neighbors). Exact same algorithm and candidate enumeration order as
// the numpy oracle in cgat_tpu_torch/data/featurizer.py (periodic_neighbors
// with use_native=False): growing search radius, stable distance sort, shell
// index increments when the distance gap exceeds 1e-8.
//
// C ABI for ctypes. Build: cgat_tpu_torch/native/build.py (g++ -O3 -shared
// -fPIC), at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// invert a 3x3 row-major matrix
bool invert3(const double* a, double* g) {
  const double det =
      a[0] * (a[4] * a[8] - a[5] * a[7]) -
      a[1] * (a[3] * a[8] - a[5] * a[6]) +
      a[2] * (a[3] * a[7] - a[4] * a[6]);
  if (std::fabs(det) < 1e-300) return false;
  const double id = 1.0 / det;
  g[0] = (a[4] * a[8] - a[5] * a[7]) * id;
  g[1] = (a[2] * a[7] - a[1] * a[8]) * id;
  g[2] = (a[1] * a[5] - a[2] * a[4]) * id;
  g[3] = (a[5] * a[6] - a[3] * a[8]) * id;
  g[4] = (a[0] * a[8] - a[2] * a[6]) * id;
  g[5] = (a[2] * a[3] - a[0] * a[5]) * id;
  g[6] = (a[3] * a[7] - a[4] * a[6]) * id;
  g[7] = (a[1] * a[6] - a[0] * a[7]) * id;
  g[8] = (a[0] * a[4] - a[1] * a[3]) * id;
  return true;
}

struct Cand {
  double d;
  int64_t order;
  int32_t j;
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 if some atom has fewer than max_nbr neighbors
// within `radius`, 2 on a degenerate lattice.
// Outputs (row-major, n x max_nbr): nbr_idx, shell, dist.
int cgat_periodic_knn(const double* lattice, const double* frac_in, int n,
                      double radius, int max_nbr, int32_t* nbr_idx,
                      int32_t* shell, double* dist_out) {
  double G[9];
  if (!invert3(lattice, G)) return 2;

  std::vector<double> cart(3 * n);
  for (int i = 0; i < n; ++i) {
    double f[3];
    for (int k = 0; k < 3; ++k) {
      double v = std::fmod(frac_in[3 * i + k], 1.0);
      if (v < 0) v += 1.0;
      f[k] = v;
    }
    for (int k = 0; k < 3; ++k)
      cart[3 * i + k] = f[0] * lattice[0 + k] + f[1] * lattice[3 + k] +
                        f[2] * lattice[6 + k];
  }

  const double vol = std::fabs(
      lattice[0] * (lattice[4] * lattice[8] - lattice[5] * lattice[7]) -
      lattice[1] * (lattice[3] * lattice[8] - lattice[5] * lattice[6]) +
      lattice[2] * (lattice[3] * lattice[7] - lattice[4] * lattice[6]));
  double r = std::min(
      radius, 1.5 * std::cbrt(3.0 * (max_nbr + 1) * vol /
                              (4.0 * M_PI * std::max(n, 1))));
  r = std::max(r, 1.0);

  std::vector<Cand> cands;
  while (true) {
    // image bounds: ceil(r * ||G[:, k]||) + 1
    int b[3];
    for (int k = 0; k < 3; ++k) {
      const double norm = std::sqrt(G[0 + k] * G[0 + k] +
                                    G[3 + k] * G[3 + k] +
                                    G[6 + k] * G[6 + k]);
      b[k] = static_cast<int>(std::ceil(r * norm)) + 1;
    }

    bool ok = true;
    const double r2 = r * r;
    for (int i = 0; i < n && ok; ++i) {
      cands.clear();
      int64_t order = 0;
      // candidate order matches the numpy oracle: images in meshgrid 'ij'
      // order, atoms innermost
      for (int i1 = -b[0]; i1 <= b[0]; ++i1)
        for (int i2 = -b[1]; i2 <= b[1]; ++i2)
          for (int i3 = -b[2]; i3 <= b[2]; ++i3) {
            double off[3];
            for (int k = 0; k < 3; ++k)
              off[k] = i1 * lattice[0 + k] + i2 * lattice[3 + k] +
                       i3 * lattice[6 + k];
            for (int j = 0; j < n; ++j, ++order) {
              const double dx = cart[3 * j + 0] + off[0] - cart[3 * i + 0];
              const double dy = cart[3 * j + 1] + off[1] - cart[3 * i + 1];
              const double dz = cart[3 * j + 2] + off[2] - cart[3 * i + 2];
              const double d2 = dx * dx + dy * dy + dz * dz;
              if (d2 <= r2 && d2 > 1e-16)
                cands.push_back({std::sqrt(d2), order, (int32_t)j});
            }
          }
      if ((int)cands.size() < max_nbr) {
        ok = false;
        break;
      }
      std::stable_sort(cands.begin(), cands.end(),
                       [](const Cand& a, const Cand& c) { return a.d < c.d; });
      int32_t index = 1;
      double prev = cands[0].d;
      for (int k = 0; k < max_nbr; ++k) {
        if (cands[k].d > prev + 1e-8) {
          prev = cands[k].d;
          ++index;
        }
        nbr_idx[i * max_nbr + k] = cands[k].j;
        shell[i * max_nbr + k] = index;
        dist_out[i * max_nbr + k] = cands[k].d;
      }
    }
    if (ok) return 0;
    if (r >= radius) return 1;
    r = std::min(radius, r * 1.6);
  }
}

}  // extern "C"
