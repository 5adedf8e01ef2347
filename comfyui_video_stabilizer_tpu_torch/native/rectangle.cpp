// Greedy min-distance corner selection, the host stage of GFTT.
//
// A copy of greedy_min_distance from the JAX package's
// native/rectangle.cpp (the same code; tests/test_torch_host_copies.py
// holds the two equal).  The largest-rectangle helper of that file serves
// crop framing, which the port does not have yet, so it is not copied.
//
// Exposed as a tiny C ABI consumed through ctypes.

#include <cstdint>
#include <vector>

extern "C" {

// Batched greedy min-distance suppression for GFTT corner selection:
// candidates arrive score-descending; accept while farther than
// min_distance from every accepted point (grid-hashed).  Mirrors the
// ordering semantics of cv2.goodFeaturesToTrack's final stage.
int64_t greedy_min_distance(const int64_t* ys, const int64_t* xs,
                            int64_t n_candidates, int64_t height, int64_t width,
                            double min_distance, int64_t max_corners,
                            int64_t* out_xy /* max_corners*2 */) {
    const int64_t cell = min_distance > 1.0 ? (int64_t)min_distance : 1;
    const int64_t gw = width / cell + 1;
    const int64_t gh = height / cell + 1;
    const double min_d2 = min_distance * min_distance;
    std::vector<std::vector<int64_t>> grid(gw * gh);  // packed y*width+x

    int64_t accepted = 0;
    for (int64_t i = 0; i < n_candidates && accepted < max_corners; ++i) {
        const int64_t y = ys[i];
        const int64_t x = xs[i];
        const int64_t cy = y / cell;
        const int64_t cx = x / cell;
        bool ok = true;
        for (int64_t gy = cy > 0 ? cy - 1 : 0; ok && gy <= cy + 1 && gy < gh; ++gy) {
            for (int64_t gx = cx > 0 ? cx - 1 : 0; ok && gx <= cx + 1 && gx < gw; ++gx) {
                for (int64_t packed : grid[gy * gw + gx]) {
                    const int64_t py = packed / width;
                    const int64_t px = packed % width;
                    const double dy = (double)(py - y);
                    const double dx = (double)(px - x);
                    if (dy * dy + dx * dx < min_d2) { ok = false; break; }
                }
            }
        }
        if (!ok) continue;
        grid[cy * gw + cx].push_back(y * width + x);
        out_xy[accepted * 2] = x;
        out_xy[accepted * 2 + 1] = y;
        ++accepted;
    }
    return accepted;
}

}  // extern "C"
