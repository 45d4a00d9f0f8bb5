// Host image code of the port's data loader: the PNG row filters undone
// into BGR, and a Pillow-exact uint8 bilinear resize. Plain C interface,
// loaded with ctypes (which releases the GIL for the call), no dependencies.
//
// Counterpart of dd3d_tpu/data/native/imageio.cpp, which decodes with
// libpng and libjpeg. The port builds without either library, so it
// splits the PNG decode: Python's zlib inflates the IDAT stream
// (dd3d_tpu_torch/data/imageio.py) and `png_unfilter_bgr` here undoes the
// five row filters of 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA
// images and writes BGR, dropping alpha, as cv2.imread(path, IMREAD_COLOR)
// returns them. The resize is the JAX package's reimplementation of
// Pillow's ImagingResample for the bilinear filter
// (dd3d_tpu/data/native/imageio.cpp:214-336), copied as it is: the port's
// ResizeTransform must equal PIL's Image.resize(..., BILINEAR) byte for
// byte (tests/test_torch_imageio.py).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// `raw` is the inflated IDAT stream: h rows of one filter-type byte then
// w * channels sample bytes. Writes h*w*3 BGR bytes to `out`. Returns 0, or
// -1 on a size mismatch, -2 on an unknown filter type, -3 on a channel count
// other than 1-4.
int32_t png_unfilter_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t channels,
                         uint8_t* out);

// PIL-exact bilinear resize of interleaved uint8, any channel count.
int32_t resize_bilinear_u8(const uint8_t* src, int32_t sh, int32_t sw, int32_t c,
                           uint8_t* dst, int32_t dh, int32_t dw);

// png_unfilter_bgr then resize_bilinear_u8 to (dh, dw), through one
// temporary buffer.
int32_t unfilter_resize_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t channels,
                            uint8_t* out, int32_t dh, int32_t dw);
}

// ---------------------------------------------------------------------------
// PNG row filters (PNG specification, section 9)
// ---------------------------------------------------------------------------

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

extern "C" int32_t png_unfilter_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t channels,
                                    uint8_t* out) {
    if (channels < 1 || channels > 4) return -3;
    if (h <= 0 || w <= 0) return -1;
    const int64_t stride = (int64_t)w * channels;
    if (n != (int64_t)h * (stride + 1)) return -1;
    const int bpp = channels;  // bytes per pixel at 8 bits a sample
    std::vector<uint8_t> rows((size_t)stride * 2, 0);
    uint8_t* prev = rows.data();
    uint8_t* cur = rows.data() + stride;
    for (int32_t y = 0; y < h; y++) {
        const uint8_t* src = raw + (int64_t)y * (stride + 1);
        const uint8_t filter = src[0];
        src += 1;
        switch (filter) {
            case 0:
                memcpy(cur, src, (size_t)stride);
                break;
            case 1:
                for (int64_t i = 0; i < stride; i++)
                    cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
                break;
            case 2:
                for (int64_t i = 0; i < stride; i++) cur[i] = (uint8_t)(src[i] + prev[i]);
                break;
            case 3:
                for (int64_t i = 0; i < stride; i++) {
                    int left = i >= bpp ? cur[i - bpp] : 0;
                    cur[i] = (uint8_t)(src[i] + ((left + prev[i]) >> 1));
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; i++) {
                    int left = i >= bpp ? cur[i - bpp] : 0;
                    int upleft = i >= bpp ? prev[i - bpp] : 0;
                    cur[i] = (uint8_t)(src[i] + paeth(left, prev[i], upleft));
                }
                break;
            default:
                return -2;
        }
        uint8_t* dst = out + (int64_t)y * w * 3;
        if (channels <= 2) {  // gray (+ alpha): B = G = R = gray
            for (int32_t x = 0; x < w; x++) {
                uint8_t g = cur[(int64_t)x * channels];
                dst[x * 3 + 0] = g;
                dst[x * 3 + 1] = g;
                dst[x * 3 + 2] = g;
            }
        } else {  // RGB (+ alpha) -> BGR
            for (int32_t x = 0; x < w; x++) {
                const uint8_t* p = cur + (int64_t)x * channels;
                dst[x * 3 + 0] = p[2];
                dst[x * 3 + 1] = p[1];
                dst[x * 3 + 2] = p[0];
            }
        }
        uint8_t* t = prev;
        prev = cur;
        cur = t;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// PIL-exact bilinear resize (uint8), copied from
// dd3d_tpu/data/native/imageio.cpp:214-336.
//
// Reimplements Pillow's ImagingResample for the bilinear (triangle) filter:
// separable horizontal-then-vertical passes, per-axis coefficient windows in
// 22-bit fixed point with half-up rounding, intermediate re-quantized to
// uint8 between the passes — exactly the arithmetic PIL performs, so outputs
// are byte-identical to Image.resize(..., Image.BILINEAR) (Pillow >= 9,
// antialiased on downscale because the filter support scales with the
// downscale factor).
// ---------------------------------------------------------------------------

static const int PRECISION_BITS = 32 - 8 - 2;  // 22, as in Pillow

static inline uint8_t clip8(int v) {
    v >>= PRECISION_BITS;  // arithmetic shift, as in Pillow's lookup
    if (v < 0) return 0;
    if (v > 255) return 255;
    return (uint8_t)v;
}

static inline double tri_filter(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

// Pillow precompute_coeffs + normalize_coeffs_8bpc for one axis.
static int precompute_coeffs(int in_size, int out_size, std::vector<int>& bounds,
                             std::vector<int>& kk) {
    double scale = (double)in_size / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // bilinear support = 1.0
    int ksize = (int)ceil(support) * 2 + 1;
    bounds.resize((size_t)out_size * 2);
    std::vector<double> kw((size_t)out_size * ksize);
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &kw[(size_t)xx * ksize];
        int x = 0;
        for (; x < xmax; x++) {
            double w = tri_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (int i = 0; i < xmax; i++)
            if (ww != 0.0) k[i] /= ww;
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[(size_t)xx * 2] = xmin;
        bounds[(size_t)xx * 2 + 1] = xmax;
    }
    kk.resize((size_t)out_size * ksize);
    for (size_t i = 0; i < kw.size(); i++) {
        double v = kw[i] * (1 << PRECISION_BITS);
        kk[i] = (int)(v < 0 ? v - 0.5 : v + 0.5);
    }
    return ksize;
}

extern "C" int32_t resize_bilinear_u8(const uint8_t* src, int32_t sh, int32_t sw, int32_t c,
                                      uint8_t* dst, int32_t dh, int32_t dw) {
    if (sh <= 0 || sw <= 0 || dh <= 0 || dw <= 0 || c <= 0) return -1;
    const uint8_t* cur = src;
    int cur_h = sh, cur_w = sw;
    std::vector<uint8_t> tmp;

    if (dw != sw) {  // horizontal pass
        std::vector<int> bounds, kk;
        int ksize = precompute_coeffs(sw, dw, bounds, kk);
        tmp.resize((size_t)cur_h * dw * c);
        for (int yy = 0; yy < cur_h; yy++) {
            const uint8_t* srow = cur + (size_t)yy * cur_w * c;
            uint8_t* drow = tmp.data() + (size_t)yy * dw * c;
            for (int xx = 0; xx < dw; xx++) {
                int xmin = bounds[(size_t)xx * 2];
                int xmax = bounds[(size_t)xx * 2 + 1];
                const int* k = &kk[(size_t)xx * ksize];
                for (int ch = 0; ch < c; ch++) {
                    int ss = 1 << (PRECISION_BITS - 1);
                    for (int x = 0; x < xmax; x++)
                        ss += srow[(size_t)(x + xmin) * c + ch] * k[x];
                    drow[(size_t)xx * c + ch] = clip8(ss);
                }
            }
        }
        cur = tmp.data();
        cur_w = dw;
    }

    if (dh != cur_h) {  // vertical pass
        std::vector<int> bounds, kk;
        int ksize = precompute_coeffs(cur_h, dh, bounds, kk);
        std::vector<uint8_t> vtmp;
        uint8_t* out = dst;
        bool in_place_hazard = (cur == dst);
        if (in_place_hazard) {
            vtmp.resize((size_t)dh * cur_w * c);
            out = vtmp.data();
        }
        for (int yy = 0; yy < dh; yy++) {
            int ymin = bounds[(size_t)yy * 2];
            int ymax = bounds[(size_t)yy * 2 + 1];
            const int* k = &kk[(size_t)yy * ksize];
            uint8_t* drow = out + (size_t)yy * cur_w * c;
            for (int xc = 0; xc < cur_w * c; xc++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int y = 0; y < ymax; y++)
                    ss += cur[(size_t)(y + ymin) * cur_w * c + xc] * k[y];
                drow[xc] = clip8(ss);
            }
        }
        if (in_place_hazard) memcpy(dst, out, vtmp.size());
    } else if (cur != dst) {
        memcpy(dst, cur, (size_t)cur_h * cur_w * c);
    }
    return 0;
}

extern "C" int32_t unfilter_resize_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t channels,
                                       uint8_t* out, int32_t dh, int32_t dw) {
    if (h == dh && w == dw) return png_unfilter_bgr(raw, n, h, w, channels, out);
    if (h <= 0 || w <= 0) return -1;
    std::vector<uint8_t> full((size_t)h * w * 3);
    int32_t rc = png_unfilter_bgr(raw, n, h, w, channels, full.data());
    if (rc != 0) return rc;
    return resize_bilinear_u8(full.data(), h, w, 3, out, dh, dw);
}
