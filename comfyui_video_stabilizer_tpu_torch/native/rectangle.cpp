// The host helpers of crop framing and GFTT: the largest all-ones
// rectangle and the greedy min-distance corner selection.
//
// A copy of the JAX package's native/rectangle.cpp (the same two
// functions; tests/test_torch_host_copies.py holds them equal).  The
// rectangle is ops/morphology.py::largest_axis_aligned_rectangle's
// native half; the greedy is the oracle of the corner greedy kernel.
//
// Exposed as a tiny C ABI consumed through ctypes.

#include <cstdint>
#include <vector>

extern "C" {

// mask: row-major H*W uint8 (nonzero = valid).  out: int64[4] = x0,y0,w,h.
void largest_rectangle(const uint8_t* mask, int64_t height, int64_t width,
                       int64_t* out) {
    std::vector<int64_t> heights(width + 1, 0);
    std::vector<int64_t> stack;
    stack.reserve(width + 1);

    int64_t best_area = 0;
    out[0] = 0; out[1] = 0; out[2] = width; out[3] = height;

    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* row = mask + y * width;
        for (int64_t x = 0; x < width; ++x) {
            heights[x] = row[x] ? heights[x] + 1 : 0;
        }
        stack.clear();
        for (int64_t x = 0; x <= width; ++x) {
            const int64_t curr = heights[x];
            while (!stack.empty() && heights[stack.back()] > curr) {
                const int64_t top = stack.back();
                stack.pop_back();
                const int64_t h = heights[top];
                const int64_t left = stack.empty() ? 0 : stack.back() + 1;
                const int64_t area = h * (x - left);
                if (area > best_area) {
                    best_area = area;
                    out[0] = left;
                    out[1] = y - h + 1;
                    out[2] = x - left;
                    out[3] = h;
                }
            }
            stack.push_back(x);
        }
    }
}

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
