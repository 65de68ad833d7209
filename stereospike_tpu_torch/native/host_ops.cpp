// Host-side native ops for the data pipeline.
//
// area_closing_f32: grayscale area closing (fill dark structures with area
// < threshold), the GT hole-filling step of the MVSEC pipeline (reference
// uses skimage.morphology.area_closing(depth, area_threshold=24),
// mvsec_dataset.py:139-141). Implemented as the dual area opening on the
// negated image with the Meijster–Wilkinson union-find algorithm
// (max-tree flooding in decreasing gray order), 4-connectivity
// (skimage connectivity=1). O(N log N) in the sort.
//
// rectify_bin_events_f32: fused per-event rectification + 2-channel count
// binning — the host replacement for the reference's two per-event Python
// hot loops (utils.py:31-56, 215-281). Used by the data pipeline when
// events are voxelized on the host side; the device path lives in
// data/voxelizer.py.
//
// Build: stereospike_tpu_torch/native/__init__.py compiles this file with
// g++ at first use into build/stereospike_tpu_torch/ and loads it with
// ctypes; a failed build raises.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

// Union-find root with path compression. parent >= 0: pointer to parent;
// parent < 0: active root holding -area.
inline int64_t find_root(std::vector<int64_t>& parent, int64_t p) {
    int64_t r = p;
    while (parent[r] >= 0) r = parent[r];
    while (parent[p] >= 0) {  // path compression
        int64_t next = parent[p];
        parent[p] = r;
        p = next;
    }
    return r;
}

}  // namespace

extern "C" {

// Grayscale area closing, float32, 4-connectivity.
// img, out: h*w row-major. Structures darker than their surroundings with
// area < area_threshold are filled to the level of the darkest enclosing
// ring.
void area_closing_f32(const float* img, float* out, int64_t h, int64_t w,
                      int64_t area_threshold) {
    const int64_t n = h * w;
    // Dual: area opening of the negated image. g = -img, process brightest
    // (i.e. darkest original) last.
    std::vector<float> g(n);
    for (int64_t i = 0; i < n; ++i) g[i] = -img[i];

    // Sort indices by decreasing g (stable for deterministic tie handling).
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return g[a] > g[b]; });

    std::vector<int64_t> rank(n);  // processing position of each pixel
    for (int64_t i = 0; i < n; ++i) rank[order[i]] = i;

    // NOTE: roots store -area in parent, so "unprocessed" must be detected
    // via rank (a -k sentinel would collide with an area-k root).
    std::vector<int64_t> parent(n, -1);

    const int64_t lambda = area_threshold;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t p = order[i];
        parent[p] = -1;  // active root, area 1
        const int64_t y = p / w, x = p % w;
        const int64_t neigh[4] = {
            y > 0 ? p - w : -1,
            y + 1 < h ? p + w : -1,
            x > 0 ? p - 1 : -1,
            x + 1 < w ? p + 1 : -1,
        };
        for (int64_t q : neigh) {
            if (q < 0 || rank[q] > i) continue;  // not yet processed
            const int64_t r = find_root(parent, q);
            if (r == p) continue;
            if (g[r] == g[p] || -parent[r] < lambda) {
                parent[p] += parent[r];  // accumulate (negative) area
                parent[r] = p;
            } else {
                parent[p] = -lambda;  // finished: clamp so p never merges up
            }
        }
    }

    // Resolve in increasing-g order: children inherit the root's level.
    for (int64_t i = n - 1; i >= 0; --i) {
        const int64_t p = order[i];
        out[p] = parent[p] >= 0 ? out[parent[p]] : img[p];
    }
}

// Fused rectification + event binning (host path).
// events: [n, 4] (x, y, t, p); x_map/y_map: [h, w] or nullptr; frames:
// [n_frames, h, w, 2] float32, pre-zeroed by caller. Window f covers
// (t0 + f*dt, t0 + (f+1)*dt); polarity: mode 0 = binary (ON p==1, OFF
// otherwise), mode 1 = signed (ON p==1, OFF p==-1, else drop).
void rectify_bin_events_f32(const float* events, int64_t n,
                            const float* x_map, const float* y_map,
                            float* frames, int64_t n_frames,
                            int64_t h, int64_t w,
                            double t0, double dt, int32_t polarity_mode) {
    for (int64_t i = 0; i < n; ++i) {
        const float* e = events + 4 * i;
        double xf = e[0], yf = e[1];
        const double t = e[2], p = e[3];
        int64_t x = (int64_t)xf, y = (int64_t)yf;
        if (x < 0 || x >= w || y < 0 || y >= h) continue;
        if (x_map != nullptr) {
            xf = x_map[y * w + x];
            yf = y_map[y * w + x];
            if (xf < 0 || xf >= w || yf < 0 || yf >= h) continue;
            x = (int64_t)xf;
            y = (int64_t)yf;
        }
        const int64_t f = (int64_t)std::floor((t - t0) / dt);
        if (f < 0 || f >= n_frames) continue;
        int64_t pol;
        if (polarity_mode == 0) {
            pol = (p == 1.0) ? 0 : 1;
        } else {
            if (p == 1.0) pol = 0;
            else if (p == -1.0) pol = 1;
            else continue;
        }
        frames[((f * h + y) * w + x) * 2 + pol] += 1.0f;
    }
}

}  // extern "C"
