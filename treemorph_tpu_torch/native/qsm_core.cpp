// Native host-side kernels for the QSM fitting stage.
//
// The stage-3 sphere-following loop is CPU-bound (reference profile,
// SURVEY.md §3.3): every popped sphere runs a DBSCAN over the pairwise
// angular distances of its shell points (QSMFittingDepthFirst.py:115-148)
// thousands of times per tree with small matrices, where sklearn's
// per-call overhead dominates. This file provides a plain C ABI consumed
// through ctypes (no pybind11 / Python headers needed).
//
// Build:  g++ -O3 -march=native -shared -fPIC qsm_core.cpp -o libqsm_core.so
// (done automatically at first use by treemorph_tpu_torch.native)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Union-find with path halving, union by attaching to the smaller index
// root so cluster ids follow first-core order deterministically.
struct UnionFind {
    std::vector<int32_t> parent;
    explicit UnionFind(int32_t n) : parent(n) {
        for (int32_t i = 0; i < n; ++i) parent[i] = i;
    }
    int32_t find(int32_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    }
    void unite(int32_t a, int32_t b) {
        a = find(a);
        b = find(b);
        if (a == b) return;
        if (a < b) parent[b] = a; else parent[a] = b;
    }
};

}  // namespace

extern "C" {

// DBSCAN over a precomputed (n x n) distance matrix, sklearn semantics:
// core point = >= min_samples neighbors within eps (including itself);
// clusters grow through core points only; border points adopt the label
// of the first core point that reaches them; noise = -1.
void dbscan_precomputed(const float* dist, int32_t n, float eps,
                        int32_t min_samples, int32_t* labels) {
    std::vector<int32_t> neighbor_count(n, 0);
    for (int32_t i = 0; i < n; ++i) {
        const float* row = dist + (int64_t)i * n;
        int32_t c = 0;
        for (int32_t j = 0; j < n; ++j) c += (row[j] <= eps);
        neighbor_count[i] = c;
    }

    for (int32_t i = 0; i < n; ++i) labels[i] = -1;
    std::vector<uint8_t> in_queue(n, 0);
    std::vector<int32_t> queue;
    queue.reserve(n);

    int32_t cluster = 0;
    for (int32_t i = 0; i < n; ++i) {
        if (labels[i] != -1 || neighbor_count[i] < min_samples) continue;
        // start a new cluster from core point i
        queue.clear();
        std::fill(in_queue.begin(), in_queue.end(), 0);
        labels[i] = cluster;
        queue.push_back(i);
        in_queue[i] = 1;
        for (size_t qi = 0; qi < queue.size(); ++qi) {
            int32_t p = queue[qi];
            if (neighbor_count[p] < min_samples) continue;  // border
            const float* row = dist + (int64_t)p * n;
            for (int32_t j = 0; j < n; ++j) {
                if (row[j] <= eps && labels[j] == -1) {
                    labels[j] = cluster;
                    if (!in_queue[j]) {
                        queue.push_back(j);
                        in_queue[j] = 1;
                    }
                }
            }
        }
        ++cluster;
    }
}

// Pairwise angular distances between unit vectors (n x 3, row-major):
// out[i, j] = acos(clip(dot(u_i, u_j), -1, 1)).
void angular_distance_matrix(const float* unit, int32_t n, float* out) {
    for (int32_t i = 0; i < n; ++i) {
        const float* a = unit + (int64_t)i * 3;
        float* row = out + (int64_t)i * n;
        for (int32_t j = 0; j < n; ++j) {
            const float* b = unit + (int64_t)j * 3;
            float d = a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
            if (d > 1.0f) d = 1.0f;
            if (d < -1.0f) d = -1.0f;
            row[j] = acosf(d);
        }
    }
}

// Euclidean flood-fill clustering (reference cluster_labels_euclidian,
// QSMFittingDepthFirst.py:859-886) over raw 3D points, brute force —
// shell point sets are small (tens to hundreds).
void euclidean_cluster(const float* pts, int32_t n, float eps,
                       int32_t min_cluster_size, int32_t* labels) {
    const float eps2 = eps * eps;
    for (int32_t i = 0; i < n; ++i) labels[i] = -1;
    std::vector<int32_t> queue;
    queue.reserve(n);
    int32_t cluster = 0;
    for (int32_t i = 0; i < n; ++i) {
        if (labels[i] != -1) continue;
        // count neighborhood
        int32_t cnt = 0;
        for (int32_t j = 0; j < n; ++j) {
            float dx = pts[3 * i] - pts[3 * j];
            float dy = pts[3 * i + 1] - pts[3 * j + 1];
            float dz = pts[3 * i + 2] - pts[3 * j + 2];
            cnt += (dx * dx + dy * dy + dz * dz <= eps2);
        }
        if (cnt < min_cluster_size) continue;
        queue.clear();
        labels[i] = cluster;
        queue.push_back(i);
        for (size_t qi = 0; qi < queue.size(); ++qi) {
            int32_t p = queue[qi];
            for (int32_t j = 0; j < n; ++j) {
                if (labels[j] != -1) continue;
                float dx = pts[3 * p] - pts[3 * j];
                float dy = pts[3 * p + 1] - pts[3 * j + 1];
                float dz = pts[3 * p + 2] - pts[3 * j + 2];
                if (dx * dx + dy * dy + dz * dz <= eps2) {
                    labels[j] = cluster;
                    queue.push_back(j);
                }
            }
        }
        ++cluster;
    }
}

// Grid-accelerated EXACT angular DBSCAN over unit vectors (n x 3).
//
// Semantics match sklearn DBSCAN on the chord metric (angular distance
// a <= eps  <=>  euclidean chord <= 2 sin(eps/2), exact on unit vectors):
// core = >= min_samples neighbors within eps incl. self; cores within eps
// chain into one cluster; border points take the smallest reaching
// cluster id (sklearn expands clusters sequentially in first-core order,
// so the earliest cluster claims shared borders); cluster ids ascend in
// first-core-point order. Replaces the O(n * neighbor-materialization)
// KD-tree path for the 100k-point shells of plot-scale (1M-pt) QSM fits:
// grid cells of side chord/sqrt(3) make every same-cell pair a neighbor,
// so dense cells are wholesale-core / wholesale-countable and the work
// concentrates on genuinely sparse boundaries.
void angular_dbscan_grid(const float* unit, int32_t n, float eps,
                         int32_t min_samples, int32_t* labels) {
    if (n <= 0) return;
    const float ang = eps < 3.14159265f ? eps : 3.14159265f;
    const float chord = 2.0f * sinf(0.5f * ang);
    const float c2 = chord * chord;
    const float h = chord / 1.7320508f;  // same-cell diameter == chord

    // ---- bucket points into grid cells (hashless: sort by packed key)
    auto cell_of = [&](int32_t i, int axis) {
        return (int64_t)floorf((unit[3 * i + axis] + 4.0f) / h);
    };
    std::vector<uint64_t> key(n);
    for (int32_t i = 0; i < n; ++i) {
        key[i] = ((uint64_t)cell_of(i, 0) << 42) |
                 ((uint64_t)cell_of(i, 1) << 21) |
                 (uint64_t)cell_of(i, 2);
    }
    std::vector<int32_t> order(n);
    for (int32_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
        return key[a] != key[b] ? key[a] < key[b] : a < b;
    });
    std::vector<uint64_t> cell_key;
    std::vector<int32_t> cell_start;  // into `order`
    for (int32_t s = 0; s < n;) {
        cell_key.push_back(key[order[s]]);
        cell_start.push_back(s);
        int32_t e = s;
        while (e < n && key[order[e]] == key[order[s]]) ++e;
        s = e;
    }
    cell_start.push_back(n);
    const int32_t m = (int32_t)cell_key.size();

    auto find_cell = [&](uint64_t k) -> int32_t {
        auto it = std::lower_bound(cell_key.begin(), cell_key.end(), k);
        if (it == cell_key.end() || *it != k) return -1;
        return (int32_t)(it - cell_key.begin());
    };

    // neighbor cell offsets within reach (gap bound: (|d|-1)+ cells)
    struct Off { int32_t dx, dy, dz; };
    std::vector<Off> offs;
    for (int32_t dx = -2; dx <= 2; ++dx)
        for (int32_t dy = -2; dy <= 2; ++dy)
            for (int32_t dz = -2; dz <= 2; ++dz) {
                float gx = h * (float)(dx > 0 ? dx - 1 : (dx < 0 ? -dx - 1 : 0));
                float gy = h * (float)(dy > 0 ? dy - 1 : (dy < 0 ? -dy - 1 : 0));
                float gz = h * (float)(dz > 0 ? dz - 1 : (dz < 0 ? -dz - 1 : 0));
                if (gx * gx + gy * gy + gz * gz <= c2 * 1.000001f)
                    offs.push_back({dx, dy, dz});
            }
    auto neighbor_key = [&](uint64_t k, const Off& o) -> uint64_t {
        int64_t cx = (int64_t)(k >> 42) + o.dx;
        int64_t cy = (int64_t)((k >> 21) & 0x1FFFFF) + o.dy;
        int64_t cz = (int64_t)(k & 0x1FFFFF) + o.dz;
        return ((uint64_t)cx << 42) | ((uint64_t)cy << 21) | (uint64_t)cz;
    };
    // point-to-cell distance bounds via the cell AABB
    auto cell_lo = [&](uint64_t k, int axis) -> float {
        int64_t c = axis == 0 ? (int64_t)(k >> 42)
                  : axis == 1 ? (int64_t)((k >> 21) & 0x1FFFFF)
                              : (int64_t)(k & 0x1FFFFF);
        return (float)c * h - 4.0f;
    };
    auto point_cell_bounds = [&](const float* p, uint64_t k, float* mind2,
                                 float* maxd2) {
        float mn = 0.0f, mx = 0.0f;
        for (int a = 0; a < 3; ++a) {
            float lo = cell_lo(k, a), hi = lo + h;
            float below = lo - p[a], above = p[a] - hi;
            float g = below > 0.0f ? below : (above > 0.0f ? above : 0.0f);
            mn += g * g;
            float far1 = p[a] - lo, far2 = hi - p[a];
            float f = far1 > far2 ? far1 : far2;
            mx += f * f;
        }
        *mind2 = mn;
        *maxd2 = mx;
    };
    auto d2 = [&](int32_t a, int32_t b) {
        float dx = unit[3 * a] - unit[3 * b];
        float dy = unit[3 * a + 1] - unit[3 * b + 1];
        float dz = unit[3 * a + 2] - unit[3 * b + 2];
        return dx * dx + dy * dy + dz * dz;
    };

    // ---- core flags (early exit at min_samples; dense cells wholesale)
    std::vector<uint8_t> core(n, 0);
    std::vector<int32_t> first_core(m, -1);
    for (int32_t c = 0; c < m; ++c) {
        int32_t s = cell_start[c], e = cell_start[c + 1];
        if (e - s >= min_samples) {
            for (int32_t q = s; q < e; ++q) core[order[q]] = 1;
            first_core[c] = order[s];
            continue;
        }
        for (int32_t q = s; q < e; ++q) {
            int32_t i = order[q];
            const float* p = unit + 3 * i;
            int32_t cnt = 0;
            for (const Off& o : offs) {
                uint64_t nk = neighbor_key(cell_key[c], o);
                int32_t nb = find_cell(nk);
                if (nb < 0) continue;
                float mind2v, maxd2v;
                point_cell_bounds(p, nk, &mind2v, &maxd2v);
                if (mind2v > c2) continue;
                if (maxd2v <= c2) {
                    cnt += cell_start[nb + 1] - cell_start[nb];
                } else {
                    for (int32_t r = cell_start[nb];
                         r < cell_start[nb + 1]; ++r)
                        cnt += (d2(i, order[r]) <= c2);
                }
                if (cnt >= min_samples) break;
            }
            if (cnt >= min_samples) {
                core[i] = 1;
                if (first_core[c] < 0 || i < first_core[c])
                    first_core[c] = i;
            }
        }
        // first_core must be the smallest core index in the cell
        if (first_core[c] >= 0) {
            for (int32_t q = s; q < e; ++q)
                if (core[order[q]] && order[q] < first_core[c])
                    first_core[c] = order[q];
        }
    }

    // ---- chain cores: same cell wholesale; cell pairs by max-bound or
    // early-exit pair scan
    UnionFind uf(n);
    for (int32_t c = 0; c < m; ++c) {
        if (first_core[c] < 0) continue;
        for (int32_t q = cell_start[c]; q < cell_start[c + 1]; ++q)
            if (core[order[q]]) uf.unite(first_core[c], order[q]);
    }
    auto cells_maxd2 = [&](uint64_t ka, uint64_t kb) {
        float mx = 0.0f;
        for (int a = 0; a < 3; ++a) {
            float loA = cell_lo(ka, a), loB = cell_lo(kb, a);
            float f1 = fabsf(loA - (loB + h)), f2 = fabsf((loA + h) - loB);
            float f = f1 > f2 ? f1 : f2;
            mx += f * f;
        }
        return mx;
    };
    for (int32_t c = 0; c < m; ++c) {
        if (first_core[c] < 0) continue;
        for (const Off& o : offs) {
            uint64_t nk = neighbor_key(cell_key[c], o);
            if (nk <= cell_key[c]) continue;  // each unordered pair once
            int32_t nb = find_cell(nk);
            if (nb < 0 || first_core[nb] < 0) continue;
            if (cells_maxd2(cell_key[c], nk) <= c2) {
                uf.unite(first_core[c], first_core[nb]);
                continue;
            }
            bool linked = false;
            for (int32_t qa = cell_start[c];
                 qa < cell_start[c + 1] && !linked; ++qa) {
                int32_t ia = order[qa];
                if (!core[ia]) continue;
                for (int32_t qb = cell_start[nb];
                     qb < cell_start[nb + 1]; ++qb) {
                    int32_t ib = order[qb];
                    if (!core[ib]) continue;
                    if (d2(ia, ib) <= c2) {
                        uf.unite(ia, ib);
                        linked = true;
                        break;
                    }
                }
            }
        }
    }

    // ---- cluster ids ascend in first-core order (sklearn convention)
    std::vector<int32_t> root_id(n, -1);
    int32_t next_id = 0;
    for (int32_t i = 0; i < n; ++i) labels[i] = -1;
    for (int32_t i = 0; i < n; ++i) {
        if (!core[i]) continue;
        int32_t r = uf.find(i);
        if (root_id[r] < 0) root_id[r] = next_id++;
        labels[i] = root_id[r];
    }
    std::vector<int32_t> cell_cluster(m, -1);  // all cell cores share it
    for (int32_t c = 0; c < m; ++c)
        if (first_core[c] >= 0)
            cell_cluster[c] = labels[first_core[c]];

    // ---- border points: smallest reaching cluster id (== sklearn's
    // sequential-expansion winner)
    for (int32_t c = 0; c < m; ++c) {
        for (int32_t q = cell_start[c]; q < cell_start[c + 1]; ++q) {
            int32_t i = order[q];
            if (core[i]) continue;
            const float* p = unit + 3 * i;
            int32_t best = INT32_MAX;
            for (const Off& o : offs) {
                uint64_t nk = neighbor_key(cell_key[c], o);
                int32_t nb = find_cell(nk);
                if (nb < 0 || cell_cluster[nb] < 0) continue;
                if (cell_cluster[nb] >= best) continue;
                float mind2v, maxd2v;
                point_cell_bounds(p, nk, &mind2v, &maxd2v);
                if (mind2v > c2) continue;
                if (maxd2v <= c2) {
                    best = cell_cluster[nb];
                    continue;
                }
                for (int32_t r = cell_start[nb];
                     r < cell_start[nb + 1]; ++r) {
                    int32_t j = order[r];
                    if (core[j] && d2(i, j) <= c2) {
                        best = cell_cluster[nb];
                        break;
                    }
                }
            }
            if (best != INT32_MAX) labels[i] = best;
        }
    }
}

}  // extern "C"
