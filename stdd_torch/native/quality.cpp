// Native host-plane kernels for the streaming engine's per-frame work.
//
// The reference leans on OpenCV's C++ for this layer (cv2.resize +
// cv2.Laplacian per crop, TEST2.py:287); our numpy twin costs ~3 ms per face
// per frame — at 30 fps with several faces that is a large slice of a host
// core. This translation unit fuses the whole quality metric into one pass:
// RGB crop -> 2x2 area downsample (rounded, uint8) -> BT.601 gray (rounded)
// -> 3x3 Laplacian (reflect-101 border) -> population variance.
// Semantics bit-match stdd_torch.ops.quality.crop_quality's numpy path.
//
// Built with g++ (-O3 -shared -fPIC) at first use into stdd_torch/_build/ and
// loaded via ctypes, with a numpy fallback (stdd_torch/native/__init__.py).

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <vector>

extern "C" {

// Fused blur metric on a half-res grayscale view of an RGB crop.
// rgb: H x W x 3 contiguous uint8. Returns the Laplacian variance.
double crop_lapvar_halfres(const uint8_t* rgb, int h, int w) {
    const int hr = h / 2 > 0 ? h / 2 : 1;
    const int wr = w / 2 > 0 ? w / 2 : 1;
    std::vector<double> gray((size_t)hr * wr);

    if (h >= 2 && w >= 2) {
        for (int i = 0; i < hr; ++i) {
            const uint8_t* r0 = rgb + (size_t)(2 * i) * w * 3;
            const uint8_t* r1 = r0 + (size_t)w * 3;
            for (int j = 0; j < wr; ++j) {
                const uint8_t* p00 = r0 + (size_t)(2 * j) * 3;
                const uint8_t* p01 = p00 + 3;
                const uint8_t* p10 = r1 + (size_t)(2 * j) * 3;
                const uint8_t* p11 = p10 + 3;
                // 2x2 area mean, rounded to uint8 per channel: (sum+2)>>2
                const int rch = (p00[0] + p01[0] + p10[0] + p11[0] + 2) >> 2;
                const int gch = (p00[1] + p01[1] + p10[1] + p11[1] + 2) >> 2;
                const int bch = (p00[2] + p01[2] + p10[2] + p11[2] + 2) >> 2;
                // BT.601 gray, floor(x + 0.5)
                gray[(size_t)i * wr + j] =
                    std::floor(rch * 0.299 + gch * 0.587 + bch * 0.114 + 0.5);
            }
        }
    } else {
        // degenerate crop: gray of the raw pixels
        for (int i = 0; i < hr; ++i)
            for (int j = 0; j < wr; ++j) {
                const uint8_t* p = rgb + ((size_t)i * w + j) * 3;
                gray[(size_t)i * wr + j] =
                    std::floor(p[0] * 0.299 + p[1] * 0.587 + p[2] * 0.114 + 0.5);
            }
    }

    // 3x3 Laplacian [[0,1,0],[1,-4,1],[0,1,0]] with reflect-101 border
    auto at = [&](int i, int j) -> double {
        if (i < 0) i = -i;
        if (i >= hr) i = 2 * hr - 2 - i;
        if (j < 0) j = -j;
        if (j >= wr) j = 2 * wr - 2 - j;
        if (i < 0) i = 0;
        if (j < 0) j = 0;
        return gray[(size_t)i * wr + j];
    };
    double sum = 0.0, sum2 = 0.0;
    const size_t n = (size_t)hr * wr;
    for (int i = 0; i < hr; ++i) {
        for (int j = 0; j < wr; ++j) {
            const double v = at(i - 1, j) + at(i + 1, j) + at(i, j - 1) +
                             at(i, j + 1) - 4.0 * gray[(size_t)i * wr + j];
            sum += v;
            sum2 += v * v;
        }
    }
    const double mean = sum / (double)n;
    return sum2 / (double)n - mean * mean;
}

// Area-downscale an RGB crop by an arbitrary factor and paste it into the
// top-left corner of a zeroed S x S x 3 slot of a batch buffer — the
// engine's _dispatch packing step, fused (no intermediate allocations).
// src: h x w x 3; dst: s x s x 3 (already zeroed); scale <= 1.
void resize_area_pack(const uint8_t* src, int h, int w,
                      uint8_t* dst, int s, double scale) {
    const int oh = (int)(h * scale) > 0 ? (int)(h * scale) : 1;
    const int ow = (int)(w * scale) > 0 ? (int)(w * scale) : 1;
    const double sy = (double)h / oh;
    const double sx = (double)w / ow;
    for (int i = 0; i < oh && i < s; ++i) {
        const double y0 = i * sy, y1 = (i + 1) * sy;
        const int iy0 = (int)y0, iy1 = (int)std::ceil(y1);
        for (int j = 0; j < ow && j < s; ++j) {
            const double x0 = j * sx, x1 = (j + 1) * sx;
            const int ix0 = (int)x0, ix1 = (int)std::ceil(x1);
            double acc[3] = {0, 0, 0};
            double area = 0.0;
            for (int y = iy0; y < iy1 && y < h; ++y) {
                const double wy = std::fmin((double)y + 1, y1) - std::fmax((double)y, y0);
                for (int x = ix0; x < ix1 && x < w; ++x) {
                    const double wx = std::fmin((double)x + 1, x1) - std::fmax((double)x, x0);
                    const double ww = wy * wx;
                    const uint8_t* p = src + ((size_t)y * w + x) * 3;
                    acc[0] += ww * p[0];
                    acc[1] += ww * p[1];
                    acc[2] += ww * p[2];
                    area += ww;
                }
            }
            uint8_t* q = dst + ((size_t)i * s + j) * 3;
            for (int c = 0; c < 3; ++c)
                q[c] = (uint8_t)(acc[c] / (area > 0 ? area : 1.0) + 0.5);
        }
    }
}

}  // extern "C"
