// Grid subsampling: barycenter pooling of points/features/labels over a
// regular voxel grid (hash map over voxel ids, per-voxel barycenter of
// points, mean of features, majority label; cells in first-seen order).
// Host C++ with a plain C ABI, bound with ctypes by
// rift_tpu_torch/data/grid_subsample.py, which builds it at first use:
//   g++ -O3 -shared -fPIC -std=c++17 -o <_build>/libgrid_subsample-<hash>.so grid_subsample.cpp
// A copy of cpp/grid_subsample.cpp. It lives outside csrc/*.cu, so the CUDA
// kernels' build and hash do not see it.
#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Cell {
    double px = 0, py = 0, pz = 0;
    std::vector<double> feat;
    std::unordered_map<int32_t, int32_t> label_counts;
    int32_t count = 0;
};

inline int64_t cell_key(int64_t x, int64_t y, int64_t z) {
    // pack 21-bit signed coordinates into one 64-bit key
    const int64_t mask = (1LL << 21) - 1;
    return ((x & mask) << 42) | ((y & mask) << 21) | (z & mask);
}

}  // namespace

extern "C" {

// First pass: returns the number of occupied voxels so the caller can size
// the output buffers.
int64_t grid_subsample_count(const float* points, int64_t n, float sample_dl) {
    std::unordered_map<int64_t, int32_t> seen;
    seen.reserve(static_cast<size_t>(n));
    const double inv = 1.0 / sample_dl;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t x = static_cast<int64_t>(std::floor(points[3 * i + 0] * inv));
        const int64_t y = static_cast<int64_t>(std::floor(points[3 * i + 1] * inv));
        const int64_t z = static_cast<int64_t>(std::floor(points[3 * i + 2] * inv));
        seen.emplace(cell_key(x, y, z), 1);
    }
    return static_cast<int64_t>(seen.size());
}

// Second pass: fills out_points [m,3]; optionally out_features [m,fdim]
// (mean) and out_labels [m] (majority). features/labels may be null.
// Returns m (number of voxels written), or -1 on error.
int64_t grid_subsample(
    const float* points, int64_t n,
    const float* features, int64_t fdim,
    const int32_t* labels,
    float sample_dl,
    float* out_points, float* out_features, int32_t* out_labels,
    int64_t capacity) {
    if (n <= 0 || sample_dl <= 0.f) return -1;
    std::unordered_map<int64_t, Cell> cells;
    cells.reserve(static_cast<size_t>(n));
    std::vector<int64_t> order;  // first-seen order for determinism
    order.reserve(static_cast<size_t>(n));
    const double inv = 1.0 / sample_dl;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t x = static_cast<int64_t>(std::floor(points[3 * i + 0] * inv));
        const int64_t y = static_cast<int64_t>(std::floor(points[3 * i + 1] * inv));
        const int64_t z = static_cast<int64_t>(std::floor(points[3 * i + 2] * inv));
        const int64_t key = cell_key(x, y, z);
        auto it = cells.find(key);
        if (it == cells.end()) {
            it = cells.emplace(key, Cell{}).first;
            if (features) it->second.feat.assign(static_cast<size_t>(fdim), 0.0);
            order.push_back(key);
        }
        Cell& c = it->second;
        c.px += points[3 * i + 0];
        c.py += points[3 * i + 1];
        c.pz += points[3 * i + 2];
        if (features) {
            for (int64_t f = 0; f < fdim; ++f)
                c.feat[static_cast<size_t>(f)] += features[fdim * i + f];
        }
        if (labels) c.label_counts[labels[i]]++;
        c.count++;
    }
    const int64_t m = static_cast<int64_t>(order.size());
    if (m > capacity) return -1;
    for (int64_t j = 0; j < m; ++j) {
        const Cell& c = cells[order[static_cast<size_t>(j)]];
        const double invc = 1.0 / c.count;
        out_points[3 * j + 0] = static_cast<float>(c.px * invc);
        out_points[3 * j + 1] = static_cast<float>(c.py * invc);
        out_points[3 * j + 2] = static_cast<float>(c.pz * invc);
        if (features && out_features) {
            for (int64_t f = 0; f < fdim; ++f)
                out_features[fdim * j + f] =
                    static_cast<float>(c.feat[static_cast<size_t>(f)] * invc);
        }
        if (labels && out_labels) {
            int32_t best_label = 0, best_count = -1;
            for (const auto& kv : c.label_counts) {
                if (kv.second > best_count ||
                    (kv.second == best_count && kv.first < best_label)) {
                    best_label = kv.first;
                    best_count = kv.second;
                }
            }
            out_labels[j] = best_label;
        }
    }
    return m;
}

}  // extern "C"
