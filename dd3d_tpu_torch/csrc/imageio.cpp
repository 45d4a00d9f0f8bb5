// Host image code of the port's data loader: a PNG row decoder (filters,
// Adam7, sample formats, palette and gamma table) into BGR, a JPEG decoder,
// and a Pillow-exact uint8 bilinear resize. Plain C interface, loaded with
// ctypes (which releases the GIL for the call), no dependencies.
//
// Counterpart of dd3d_tpu/data/native/imageio.cpp, which decodes with
// libpng and libjpeg (and of the cv2.imread the JAX package falls back to
// for the files that reader refuses). The port builds without either
// library, so it splits the PNG decode: Python walks the chunks, follows
// the colour chunks to libpng's gamma table and inflates the IDAT stream
// (dd3d_tpu_torch/data/imageio.py), and `png_decode_bgr` here undoes the
// five row filters of every colour type and bit depth, non-interlaced or
// Adam7, expands palette indices and low-bit gray, takes a 16-bit sample's
// high byte, maps 8-bit samples through the table and writes BGR, dropping
// alpha, as the JAX reader returns them. `jpeg_decode_resize_bgr` decodes a
// JPEG as libjpeg-turbo 2.1.5 does with every default but out_color_space =
// JCS_EXT_BGR (the JAX package's settings), byte for byte, and a CMYK/YCCK
// one as cv2.imread does; see the JPEG section. The resize is the JAX
// package's reimplementation of Pillow's ImagingResample for the bilinear
// filter (dd3d_tpu/data/native/imageio.cpp:214-336), copied as it is: the
// port's ResizeTransform must equal PIL's Image.resize(..., BILINEAR) byte
// for byte (tests/test_torch_imageio.py).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

extern "C" {

// Decodes the inflated IDAT stream `raw` (n bytes) of an h x w PNG of bit
// depth `depth`, colour type `color` and interlace method `interlace` to BGR
// (png_decode_bgr below) and resizes it to (dh, dw) as resize_bilinear_u8
// does (not at all when equal), into `out` (dh*dw*3 bytes). `palette` holds
// 256 RGB entries for a palette image, `gamma` 256 entries or is null.
// Returns 0, or -1 when `raw` holds too little data, -2 on an unknown filter
// type, -3 on a bad header.
int32_t png_decode_resize_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t depth, int32_t color,
                              int32_t interlace, const uint8_t* palette, const uint8_t* gamma, uint8_t* out,
                              int32_t dh, int32_t dw);

// PIL-exact bilinear resize of interleaved uint8, any channel count.
int32_t resize_bilinear_u8(const uint8_t* src, int32_t sh, int32_t sw, int32_t c,
                           uint8_t* dst, int32_t dh, int32_t dw);

// Decodes the JPEG `buf` of n bytes, whose header says h x w, to BGR and
// resizes it to (dh, dw) as resize_bilinear_u8 does (not at all when equal),
// into `out` (dh*dw*3 bytes). Returns 0; -1 for a malformed file, -2 for a
// kind of JPEG the decoder does not read, -3 when the header's size is not
// (h, w); for -1 and -2 a message is written to `msg` (msg_len bytes).
int32_t jpeg_decode_resize_bgr(const uint8_t* buf, int64_t n, int32_t h, int32_t w, uint8_t* out,
                               int32_t dh, int32_t dw, char* msg, int32_t msg_len);
}

// ---------------------------------------------------------------------------
// PNG: the row filters (PNG specification, section 9), Adam7, the sample
// formats
// ---------------------------------------------------------------------------

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// Undoes the filter of one row of `len` bytes in place against the row
// above (`prev`, zeros for the first row of an image or pass); `bpp` is the
// filter's byte distance (bytes a pixel, at least 1).
static bool unfilter_row(int filter, uint8_t* cur, const uint8_t* prev, int64_t len, int bpp) {
    switch (filter) {
        case 0:
            return true;
        case 1:
            for (int64_t i = bpp; i < len; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
            return true;
        case 2:
            for (int64_t i = 0; i < len; i++) cur[i] = (uint8_t)(cur[i] + prev[i]);
            return true;
        case 3:
            for (int64_t i = 0; i < len; i++) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                cur[i] = (uint8_t)(cur[i] + ((left + prev[i]) >> 1));
            }
            return true;
        case 4:
            for (int64_t i = 0; i < len; i++) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                int upleft = i >= bpp ? prev[i - bpp] : 0;
                cur[i] = (uint8_t)(cur[i] + paeth(left, prev[i], upleft));
            }
            return true;
        default:
            return false;
    }
}

// `raw` is the inflated IDAT stream: rows of one filter-type byte then the
// packed samples, one image or the seven Adam7 passes. Writes h*w*3 BGR
// bytes to `out`: gray expanded to 8 bits and repeated, palette indices
// looked up in `palette`, a 16-bit sample's high byte, alpha dropped; 8-bit
// samples (and the expanded gray) mapped through `gamma` when it is not
// null.
static int32_t png_decode_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t depth, int32_t color,
                              int32_t interlace, const uint8_t* palette, const uint8_t* gamma, uint8_t* out) {
    int channels;
    switch (color) {
        case 0: case 3: channels = 1; break;
        case 4: channels = 2; break;
        case 2: channels = 3; break;
        case 6: channels = 4; break;
        default: return -3;
    }
    if (h <= 0 || w <= 0 || (depth != 1 && depth != 2 && depth != 4 && depth != 8 && depth != 16)) return -3;
    if ((depth < 8 && channels != 1) || (color == 3 && (depth > 8 || palette == nullptr))) return -3;
    const int bits = depth * channels;      // bits a pixel
    const int bpp = std::max(1, bits / 8);  // the filters' byte distance
    // Adam7 (PNG specification, section 8.2): the passes' first column and
    // row and their steps; a non-interlaced image is one pass.
    static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                     {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const int (*passes)[4] = interlace ? kAdam7 : kWhole;
    const int n_passes = interlace ? 7 : 1;
    const int scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;  // png_do_expand: 1 bit x255, 2 x85, 4 x17
    std::vector<uint8_t> rows;
    int64_t pos = 0;
    for (int p = 0; p < n_passes; p++) {
        const int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
        const int64_t pw = w > x0 ? (w - x0 + dx - 1) / dx : 0, ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
        if (pw == 0 || ph == 0) continue;  // an empty pass has no rows at all
        const int64_t len = (pw * bits + 7) / 8;
        if (n - pos < ph * (len + 1)) return -1;
        rows.assign((size_t)len * 2, 0);
        uint8_t* prev = rows.data();
        uint8_t* cur = rows.data() + len;
        for (int64_t j = 0; j < ph; j++, pos += len + 1) {
            memcpy(cur, raw + pos + 1, (size_t)len);
            if (!unfilter_row(raw[pos], cur, prev, len, bpp)) return -2;
            uint8_t* dst = out + ((int64_t)(y0 + j * dy) * w + x0) * 3;
            for (int64_t i = 0; i < pw; i++, dst += 3 * dx) {
                int r, g, b;
                if (depth < 8) {
                    const int64_t bit = i * depth;
                    const int v = (cur[bit >> 3] >> (8 - depth - (int)(bit & 7))) & ((1 << depth) - 1);
                    if (color == 3) {
                        r = palette[v * 3], g = palette[v * 3 + 1], b = palette[v * 3 + 2];
                    } else {
                        r = g = b = gamma ? gamma[v * scale] : v * scale;
                    }
                } else {
                    const uint8_t* px = cur + i * (bits / 8);
                    const int step = depth / 8;  // a 16-bit sample's high byte comes first
                    if (color == 3) {
                        r = palette[px[0] * 3], g = palette[px[0] * 3 + 1], b = palette[px[0] * 3 + 2];
                    } else if (channels <= 2) {
                        r = g = b = gamma ? gamma[px[0]] : px[0];
                    } else {
                        r = px[0], g = px[step], b = px[2 * step];
                        if (gamma) r = gamma[r], g = gamma[g], b = gamma[b];
                    }
                }
                dst[0] = (uint8_t)b;
                dst[1] = (uint8_t)g;
                dst[2] = (uint8_t)r;
            }
            std::swap(prev, cur);
        }
    }
    return 0;
}

extern "C" int32_t png_decode_resize_bgr(const uint8_t* raw, int64_t n, int32_t h, int32_t w, int32_t depth,
                                         int32_t color, int32_t interlace, const uint8_t* palette,
                                         const uint8_t* gamma, uint8_t* out, int32_t dh, int32_t dw) {
    if (h == dh && w == dw) return png_decode_bgr(raw, n, h, w, depth, color, interlace, palette, gamma, out);
    if (h <= 0 || w <= 0) return -3;
    std::vector<uint8_t> full((size_t)h * w * 3);
    int32_t rc = png_decode_bgr(raw, n, h, w, depth, color, interlace, palette, gamma, full.data());
    if (rc != 0) return rc;
    return resize_bilinear_u8(full.data(), h, w, 3, out, dh, dw);
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

// ---------------------------------------------------------------------------
// JPEG, as libjpeg-turbo 2.1.5 decodes it with jpeg_read_header,
// out_color_space = JCS_EXT_BGR and jpeg_read_scanlines (dd3d_tpu/data/
// native/imageio.cpp:148-185), every other setting at its default: ISLOW
// IDCT, fancy upsampling, block smoothing. Each step follows the
// libjpeg-turbo file named beside it, down to its rounding:
//   data source                  jdatasrc.c (jpeg_mem_src: past the last byte
//                                a fake EOI marker, FF D9, as often as asked)
//   markers                      jdmarker.c (read_markers and its get_*
//                                readers, next_marker, resync_to_restart)
//   colour space of the file     jdapimin.c (default_decompress_parms)
//   Huffman tables and decode    jdhuff.c (jpeg_make_d_derived_tbl,
//                                jpeg_fill_bit_buffer, decode_mcu_slow,
//                                process_restart), jstdhuff.c
//   progressive Huffman scans    jdphuff.c (decode_mcu_{DC,AC}_{first,refine})
//   arithmetic decoding          jdarith.c (arith_decode, decode_mcu, the
//                                progressive decode_mcu_*, process_restart),
//                                jaricom.c (the probability estimation table)
//   block smoothing              jdcoefct.c (smoothing_ok and
//                                decompress_smooth_data: 2.1's 5x5 window and
//                                its coefficient-bit latches)
//   IDCT                         jidctint.c (jpeg_idct_islow) in the form
//                                of its x86-64 SIMD (jidctint-avx2.asm)
//   upsampling                   jdsample.c (jinit_upsampler, h2v1/h2v2/h1v2
//                                fancy, int_upsample), with jdmainct.c's
//                                context rows: the first and the last real
//                                row of a component repeat past its edges
//   colour conversion            jdcolor.c (ycc_rgb_convert, gray_rgb_convert,
//                                rgb_rgb_convert, ycck_cmyk_convert)
// Data that ends early (a truncated file) reads as libjpeg reads it from
// jpeg_mem_src: marker segments and entropy-coded data go on into the fake
// EOI bytes; the Huffman bit reader pads with zero bits and every MCU that
// starts after a padding bit was taken keeps what earlier scans gave it;
// the arithmetic decoder reads zero data past a marker.
//
// A 4-component (CMYK or YCCK) file, which the JAX package's native reader
// refuses (libjpeg converts no CMYK to BGR) and so reads with cv2.imread,
// decodes as cv2 5.0 decodes it: libjpeg to JCS_CMYK (ycck_cmyk_convert for
// YCCK), then cv2's own icvCvt_CMYK2BGR_8u_C4C3R
// (modules/imgcodecs/src/utils.cpp), which reads the samples as inverted
// (Adobe) CMYK whatever the markers say. cv2 bundles libjpeg-turbo 3.1.2,
// whose block smoothing takes other blocks around a block near the image's
// edges than 2.1.5's (smooth_idct's `v312`); cv2.imread applies an EXIF
// orientation to such a file (data/imageio.py turns the result).
//
// Read: SOF0/SOF1 (sequential Huffman), SOF2 (progressive Huffman), SOF9
// (sequential arithmetic) and SOF10 (progressive arithmetic); 8-bit
// samples; 1 component (gray), 3 (YCbCr, or RGB as the file's markers say)
// or 4 (CMYK, or YCCK as the Adobe marker says); any integral sampling
// factors; restart intervals; DAC conditioning; APPn/COM skipped (an EXIF
// orientation is not applied here, as libjpeg does not apply it). Not read,
// with a message naming the kind: lossless and hierarchical frames, 12- and
// 16-bit samples, fractional sampling ratios (libjpeg refuses them), and 2
// or more than 4 components (which neither libjpeg's BGR output nor cv2
// reads).
// ---------------------------------------------------------------------------

namespace {

struct JpegError {
    int32_t code;  // -1 malformed, -2 not read by this decoder
    std::string msg;
};

[[noreturn]] void malformed(const std::string& m) { throw JpegError{-1, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw JpegError{-2, m}; }

// jpeg_natural_order (jutils.c): the zigzag index -> the natural index, with
// the 16 guard entries that keep a corrupt run inside the block.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jpeg_aritab (jaricom.c, ITU-T T.81 table D.2): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS, and the dummy entry 113.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719, 0x006f081c, 0x0036091e,
    0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34,
    0x01b11c36, 0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49,
    0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0,
    0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266, 0x41cf6367,
    0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// The tables of section K.3 (jstdhuff.c), which libjpeg-turbo installs in
// any of slots 0 and 1 that the file leaves empty (Motion-JPEG frames).
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},             // DC luminance
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},          // AC luminance
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},             // DC chrominance
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};         // AC chrominance
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
    0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffSpec {  // a DHT table as the file gives it
    bool defined = false;
    uint8_t bits[17] = {};
    uint8_t vals[256] = {};
};

struct Huffman {  // jpeg_make_d_derived_tbl
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t lookup[256];  // (code length << 8) | symbol for codes of <= 8 bits; 0: longer

    void derive(const HuffSpec& spec, bool is_dc) {
        if (!spec.defined) malformed("a scan uses a Huffman table the file does not define");
        char size[257];
        uint32_t code[257];
        int p = 0;
        for (int l = 1; l <= 16; l++) {
            int count = spec.bits[l];
            if (p + count > 256) malformed("bad Huffman table");
            while (count--) size[p++] = (char)l;
        }
        size[p] = 0;
        const int nsym = p;
        uint32_t c = 0;
        int si = size[0];
        p = 0;
        while (size[p]) {
            while (size[p] == si) code[p++] = c++;
            if (c >= (1u << si)) malformed("bad Huffman table");
            c <<= 1;
            si++;
        }
        p = 0;
        for (int l = 1; l <= 16; l++) {
            if (spec.bits[l]) {
                valoffset[l] = p - (int32_t)code[p];
                p += spec.bits[l];
                maxcode[l] = (int32_t)code[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        valoffset[17] = 0;
        maxcode[17] = 0xFFFFF;
        memcpy(vals, spec.vals, sizeof vals);
        memset(lookup, 0, sizeof lookup);
        p = 0;
        for (int l = 1; l <= 8; l++) {
            for (int i = 1; i <= spec.bits[l]; i++, p++) {
                int look = (int)(code[p] << (8 - l));
                for (int ctr = 1 << (8 - l); ctr > 0; ctr--) lookup[look++] = (uint16_t)((l << 8) | spec.vals[p]);
            }
        }
        if (is_dc)
            for (int i = 0; i < nsym; i++)
                if (spec.vals[i] > 15) malformed("bad Huffman table");
    }
};

// jpeg_mem_src, with the marker a reader stopped at (cinfo->unread_marker).
struct Stream {
    const uint8_t* d;
    size_t n;
    size_t pos = 0;
    size_t fake = 0;  // bytes read past the end: FF D9 FF D9 ...
    int unread_marker = 0;

    int byte() {
        if (pos < n) return d[pos++];
        return (fake++ & 1) ? 0xD9 : 0xFF;
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    // skip_input_data: past the end it takes the fake EOI bytes, two a refill.
    void skip(int64_t k) {
        if (k <= 0) return;
        const size_t real = std::min((size_t)k, n - pos);
        pos += real;
        fake += (size_t)k - real;
    }
    // next_marker: skip to the next FF xx with xx neither 00 nor FF.
    void next_marker() {
        int c = byte();
        for (;;) {
            while (c != 0xFF) c = byte();
            do c = byte();
            while (c == 0xFF);
            if (c != 0) break;
            c = byte();
        }
        unread_marker = c;
    }
};

// jpeg_fill_bit_buffer and friends.
struct BitReader {
    Stream* s;
    uint64_t buf = 0;
    int bits = 0;  // valid bits, the low ones of `buf`
    bool insufficient = false;

    void fill() {
        while (bits < 57 && s->unread_marker == 0) {
            int c = s->byte();
            if (c == 0xFF) {
                do c = s->byte();
                while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;
                } else {
                    s->unread_marker = c;
                    break;
                }
            }
            buf = (buf << 8) | (uint64_t)c;
            bits += 8;
        }
    }

    uint32_t get(int nb) {
        if (bits < nb) {
            fill();
            if (bits < nb) {  // at a marker: zero bits, and the data is short
                insufficient = true;
                buf <<= 57 - bits;
                bits = 57;
            }
        }
        bits -= nb;
        return (uint32_t)(buf >> bits) & ((1u << nb) - 1u);
    }

    int decode(const Huffman& t) {
        int l;
        uint32_t code;
        if (bits < 8) fill();
        if (bits >= 8) {
            const uint16_t e = t.lookup[(buf >> (bits - 8)) & 0xFF];
            if (e >> 8) {
                bits -= e >> 8;
                return e & 0xFF;
            }
            l = 9;
        } else {
            l = 1;
        }
        code = get(l);
        while ((int32_t)code > t.maxcode[l]) {
            code = (code << 1) | get(1);
            l++;
        }
        if (l > 16) return 0;  // a code no table holds: libjpeg's zero
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
};

// arith_decode (jdarith.c): sections D.2.4-D.2.6 of T.81.
struct ArithDecoder {
    Stream* s;
    int64_t c = 0, a = 0;
    int ct = -16;  // -1: a code error, decoding stops until the next restart

    int decode(uint8_t* st) {
        while (a < 0x8000) {  // renormalization and data input
            if (--ct < 0) {
                int data = 0;
                if (s->unread_marker == 0) {
                    data = s->byte();
                    if (data == 0xFF) {
                        do data = s->byte();
                        while (data == 0xFF);
                        if (data == 0) {
                            data = 0xFF;
                        } else {
                            s->unread_marker = data;
                            data = 0;
                        }
                    }
                }
                c = (c << 8) | data;
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;  // two initial bytes read
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAritab[sv & 0x7F];
        const int nl = (int)(qe & 0xFF);
        qe >>= 8;
        const int nm = (int)(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = (uint8_t)((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = (uint8_t)((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

struct Component {
    int id, h, v, tq;
    int width_in_blocks, height_in_blocks;
    int downsampled_width, downsampled_height;
    int bw, bh;  // blocks held, padded to whole MCUs
    bool qt_latched = false;
    int32_t qt[64];
    std::vector<int16_t> coef;  // bh * bw blocks of 64, natural order
    // cinfo->coef_bits of jdphuff.c/jdarith.c: the point transform Al each
    // coefficient has been sent to (-1: not at all), and (2.1's second half
    // of the table) its value before the latest scan that covered it.
    int coef_bits[64], prev_coef_bits[64];
    int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * bw + bx) * 64; }
};

// The plain [-256, 511] -> [0, 255] clamp of prepare_range_limit_table, and
// the colour tables.
struct Tables {
    uint8_t clamp_[768];
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    Tables() {
        for (int i = 0; i < 768; i++) clamp_[i] = i < 256 ? 0 : i < 512 ? (uint8_t)(i - 256) : 255;
        // build_ycc_rgb_table, SCALEBITS 16; the shifts are arithmetic.
        const int64_t half = (int64_t)1 << 15;
        auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
            cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
            cr_g[i] = (int)(-fix(0.71414) * x);
            cb_g[i] = (int)(-fix(0.34414) * x + half);
        }
    }
    uint8_t clamp(int x) const { return clamp_[x + 256]; }
};

const Tables& tables() {
    static const Tables t;
    return t;
}

// jpeg_idct_islow (jidctint.c: CONST_BITS 13, PASS1_BITS 2) as
// libjpeg-turbo runs it on x86-64, in its SIMD form (jidctint-avx2.asm,
// jidctint-sse2.asm): 16-bit lanes, so the dequantized coefficient, in0 +-
// in4 and the odd part's z3 and z4 wrap to 16 bits, the rotations are
// pmaddwd pairs summed in 32 bits, the first pass saturates to 16 bits and
// the second to 8 (then + 128), and when rows 1-7 of the whole block are
// zero the first pass is the DC << 2, wrapped. On valid data this is
// jidctint.c's C bit for bit; on corrupt data whose dequantized values
// pass 16 bits it gives what the SIMD gives.
inline int16_t wrap16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
inline int16_t sat16(int32_t x) { return x > 32767 ? 32767 : x < -32768 ? -32768 : (int16_t)x; }

// One 1-D pass over in[0..7]: the 32-bit sums before the descale.
void idct_pass(const int16_t* in, int32_t* out) {
    const int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    const int32_t z2 = in[2], z3 = in[6];  // even part
    const int32_t tmp3 = z2 * (F0_541 + F0_765) + z3 * F0_541;
    const int32_t tmp2 = z2 * F0_541 + z3 * (F0_541 - F1_847);
    const int32_t tmp0 = (int32_t)((uint32_t)wrap16(in[0] + in[4]) << 13);
    const int32_t tmp1 = (int32_t)((uint32_t)wrap16(in[0] - in[4]) << 13);
    const int32_t t10 = add32(tmp0, tmp3), t13 = sub32(tmp0, tmp3), t11 = add32(tmp1, tmp2), t12 = sub32(tmp1, tmp2);
    const int32_t a0 = in[7], a1 = in[5], a2 = in[3], a3 = in[1];  // odd part
    const int32_t s3 = wrap16(a0 + a2), s4 = wrap16(a1 + a3);
    const int32_t z3r = s3 * (F1_175 - F1_961) + s4 * F1_175, z4r = s3 * F1_175 + s4 * (F1_175 - F0_390);
    const int32_t o0 = add32(a0 * (F0_298 - F0_899) + a3 * -F0_899, z3r);
    const int32_t o1 = add32(a1 * (F2_053 - F2_562) + a2 * -F2_562, z4r);
    const int32_t o2 = add32(a1 * -F2_562 + a2 * (F3_072 - F2_562), z3r);
    const int32_t o3 = add32(a0 * -F0_899 + a3 * (F1_501 - F0_899), z4r);
    out[0] = add32(t10, o3);
    out[7] = sub32(t10, o3);
    out[1] = add32(t11, o2);
    out[6] = sub32(t11, o2);
    out[2] = add32(t12, o1);
    out[5] = sub32(t12, o1);
    out[3] = add32(t13, o0);
    out[4] = sub32(t13, o0);
}

// `q` is the component's quantization table; ISLOW_MULT_TYPE is 16 bits.
void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
    int16_t ws[64];
    bool ac_zero = true;  // rows 1-7, every column
    for (int i = 8; i < 64 && ac_zero; i++) ac_zero = in[i] == 0;
    for (int c = 0; c < 8; c++) {  // pass 1: columns
        int16_t col[8];
        for (int k = 0; k < 8; k++) col[k] = wrap16((int32_t)in[k * 8 + c] * (int16_t)q[k * 8 + c]);
        if (ac_zero) {
            for (int k = 0; k < 8; k++) ws[k * 8 + c] = wrap16((int32_t)col[0] * 4);
            continue;
        }
        if (!in[8 + c] && !in[16 + c] && !in[24 + c] && !in[32 + c] && !in[40 + c] && !in[48 + c] && !in[56 + c]) {
            // what the lanes give for a column whose AC is zero, cheaply
            for (int k = 0; k < 8; k++) ws[k * 8 + c] = sat16((int32_t)col[0] * 4);
            continue;
        }
        int32_t sums[8];
        idct_pass(col, sums);
        for (int k = 0; k < 8; k++) ws[k * 8 + c] = sat16(add32(sums[k], 1 << 10) >> 11);
    }
    for (int r = 0; r < 8; r++) {  // pass 2: rows
        const int16_t* wp = ws + r * 8;
        uint8_t* op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {  // the same, for a row
            const int v = (wp[0] + 16) >> 5;
            memset(op, (v > 127 ? 127 : v < -128 ? -128 : v) + 128, 8);
            continue;
        }
        int32_t sums[8];
        idct_pass(wp, sums);
        for (int k = 0; k < 8; k++) {
            const int v = sat16(add32(sums[k], 1 << 17) >> 18);
            op[k] = (uint8_t)((v > 127 ? 127 : v < -128 ? -128 : v) + 128);
        }
    }
}

enum Upsample { FULLSIZE, H2V1_FANCY, H2V1_BOX, H1V2_FANCY, H2V2_FANCY, H2V2_BOX, INTEGRAL };
enum ColorSpace { GRAY, RGB, YCC, CMYK, YCCK };

constexpr int kSavedCoefs = 10;  // SAVED_COEFS of jdcoefct.c: the DC and the first 9 AC in zigzag order

class JpegDecoder {
  public:
    JpegDecoder(const uint8_t* d, size_t n) : s_{d, n} {
        for (int i = 0; i < 16; i++) {  // get_soi: the conditioning's defaults
            arith_dc_l_[i] = 0;
            arith_dc_u_[i] = 1;
            arith_ac_k_[i] = 5;
        }
    }

    void decode(int32_t want_h, int32_t want_w, uint8_t* out, bool* size_mismatch) {
        if (s_.n < 3 || s_.d[0] != 0xFF || s_.d[1] != 0xD8) malformed("not a JPEG file (no SOI marker)");
        s_.pos = 2;
        if (read_markers() != 0xDA) {  // jpeg_read_header to the first SOS
            if (have_sof_) malformed("JPEG with a frame header but no scan (SOF without SOS)");
            malformed("JPEG without an image (no SOS before EOI)");
        }
        if ((int32_t)height_ != want_h || (int32_t)width_ != want_w) {
            *size_mismatch = true;
            return;
        }
        start_frame();
        const bool multiscan = progressive_ || (int)scan_.size() < (int)comps_.size();
        start_scan();
        decode_scan();
        if (multiscan) {  // jpeg_start_decompress consumes every scan up to EOI
            while (read_markers() == 0xDA) {
                start_scan();
                decode_scan();
            }
        } else if (read_markers() == 0xDA) {  // jpeg_finish_decompress reads on to EOI
            malformed("JPEG with a second scan after its only scan (EOI expected)");
        }
        output(out);
    }

  private:
    Stream s_;
    bool have_sof_ = false, progressive_ = false, arith_ = false;
    int precision_ = 8, height_ = 0, width_ = 0;
    int restart_interval_ = 0;
    bool saw_jfif_ = false, saw_adobe_ = false;
    int adobe_transform_ = 0;
    bool qt_defined_[4] = {};
    int32_t qt_[4][64];
    HuffSpec dc_spec_[4], ac_spec_[4];
    uint8_t arith_dc_l_[16], arith_dc_u_[16], arith_ac_k_[16];
    std::vector<Component> comps_;
    int max_h_ = 1, max_v_ = 1, total_imcu_rows_ = 0;
    ColorSpace color_ = GRAY;
    int input_scan_number_ = 0;
    int last_good_imcu_row_ = 0;  // cinfo->master->last_good_iMCU_row
    // the current scan
    std::vector<int> scan_;  // component indices
    int scan_dc_[4], scan_ac_[4];
    int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
    Huffman dc_tbl_[4], ac_tbl_[4];  // derived for the scan's components
    // arithmetic decoding (jdarith.c's arith_entropy_decoder)
    uint8_t dc_stats_[16][64], ac_stats_[16][256];
    uint8_t fixed_bin_[4] = {113, 0, 0, 0};
    int dc_context_[4] = {};

    // read_markers (jdmarker.c): tables, restart interval and frame up to
    // SOS (its header read) or EOI; returns that marker.
    int read_markers() {
        for (;;) {
            if (s_.unread_marker == 0) s_.next_marker();
            const int m = s_.unread_marker;
            s_.unread_marker = 0;
            switch (m) {
                case 0xC0: case 0xC1:
                    get_sof(false, false);
                    break;
                case 0xC2:
                    get_sof(true, false);
                    break;
                case 0xC9:
                    get_sof(false, true);
                    break;
                case 0xCA:
                    get_sof(true, true);
                    break;
                case 0xC3: case 0xCB:
                    unsupported("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
                case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
                    unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
                case 0xDA:
                    get_sos();
                    return m;
                case 0xD9:
                    return m;
                case 0xCC:
                    get_dac();
                    break;
                case 0xC4:
                    get_dht();
                    break;
                case 0xDB:
                    get_dqt();
                    break;
                case 0xDD: {
                    if (s_.u16() != 4) malformed("bad DRI length");
                    restart_interval_ = s_.u16();
                    break;
                }
                case 0xD8:
                    malformed("JPEG with a second SOI marker");
                case 0xE0: case 0xEE:
                    get_interesting_appn(m);
                    break;
                case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
                case 0x01:
                    break;  // parameterless; ignored as libjpeg ignores them here
                default:
                    if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {  // APPn, COM, DNL: skip_variable
                        s_.skip(s_.u16() - 2);
                        break;
                    }
                    char name[8];
                    snprintf(name, sizeof name, "0x%02X", m);
                    malformed(std::string("unknown JPEG marker ") + name);
            }
        }
    }

    // get_interesting_appn with examine_app0 / examine_app14.
    void get_interesting_appn(int m) {
        int len = s_.u16() - 2;
        uint8_t b[14];
        const int numtoread = len >= 14 ? 14 : len > 0 ? len : 0;
        for (int i = 0; i < numtoread; i++) b[i] = (uint8_t)s_.byte();
        if (m == 0xE0 && numtoread >= 14 && !memcmp(b, "JFIF\0", 5)) saw_jfif_ = true;
        if (m == 0xEE && numtoread >= 12 && !memcmp(b, "Adobe", 5)) {
            saw_adobe_ = true;
            adobe_transform_ = b[11];
        }
        s_.skip(len - numtoread);
    }

    void get_sof(bool progressive, bool arith) {
        if (have_sof_) malformed("JPEG with two frame headers (SOF)");
        int len = s_.u16();
        precision_ = s_.byte();
        height_ = s_.u16();
        width_ = s_.u16();
        const int nc = s_.byte();
        len -= 8;
        if (height_ <= 0 || width_ <= 0 || nc <= 0)
            malformed("JPEG of height, width or components 0 (a DNL height is not read)");
        if (len != nc * 3) malformed("bad SOF length");
        comps_.resize(nc);
        for (Component& c : comps_) {
            c.id = s_.byte();
            const int hv = s_.byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = s_.byte();
        }
        progressive_ = progressive;
        arith_ = arith;
        have_sof_ = true;
    }

    void get_dht() {
        int len = s_.u16() - 2;
        while (len > 16) {
            int index = s_.byte();
            HuffSpec spec;
            int count = 0;
            for (int i = 1; i <= 16; i++) count += spec.bits[i] = (uint8_t)s_.byte();
            len -= 17;
            if (count > 256 || count > len) malformed("bad Huffman table");
            for (int i = 0; i < count; i++) spec.vals[i] = (uint8_t)s_.byte();
            len -= count;
            spec.defined = true;
            const bool ac = index & 0x10;
            if (ac) index -= 0x10;
            if (index < 0 || index > 3) malformed("bad Huffman table index");
            (ac ? ac_spec_ : dc_spec_)[index] = spec;
        }
        if (len != 0) malformed("bad DHT length");
    }

    void get_dqt() {
        int len = s_.u16() - 2;
        while (len > 0) {
            len--;
            int n = s_.byte();
            const int prec = n >> 4;
            n &= 15;
            if (n > 3) malformed("bad quantization table index");
            for (int i = 0; i < 64; i++) qt_[n][kNatural[i]] = prec ? s_.u16() : s_.byte();
            len -= 64 * (prec ? 2 : 1);
            qt_defined_[n] = true;
        }
        if (len != 0) malformed("bad DQT length");
    }

    void get_dac() {
        int len = s_.u16() - 2;
        while (len > 0) {
            const int index = s_.byte(), val = s_.byte();
            len -= 2;
            if (index >= 32) malformed("bad DAC table index");
            if (index >= 16) {
                arith_ac_k_[index - 16] = (uint8_t)val;
            } else {
                arith_dc_l_[index] = (uint8_t)(val & 15);
                arith_dc_u_[index] = (uint8_t)(val >> 4);
                if (arith_dc_l_[index] > arith_dc_u_[index]) malformed("bad DAC value");
            }
        }
        if (len != 0) malformed("bad DAC length");
    }

    void get_sos() {
        if (!have_sof_) malformed("JPEG scan before its frame header (SOS before SOF)");
        const int len = s_.u16();
        const int n = s_.byte();
        if (len != n * 2 + 6 || n < 1 || n > 4) malformed("bad SOS length");
        scan_.clear();
        for (int i = 0; i < n; i++) {
            const int id = s_.byte(), tables = s_.byte();
            int ci = -1;
            for (int j = 0; j < (int)comps_.size() && j < 4; j++)
                if (comps_[j].id == id && std::find(scan_.begin(), scan_.end(), j) == scan_.end()) {
                    ci = j;
                    break;
                }
            if (ci < 0) malformed("JPEG scan names an unknown component");
            scan_.push_back(ci);
            scan_dc_[i] = tables >> 4;
            scan_ac_[i] = tables & 15;
        }
        ss_ = s_.byte();
        se_ = s_.byte();
        const int a = s_.byte();
        ah_ = a >> 4;
        al_ = a & 15;
        input_scan_number_++;
    }

    // initial_setup (jdinput.c), default_decompress_parms (jdapimin.c), and
    // what jpeg_start_decompress refuses.
    void start_frame() {
        if (precision_ != 8)
            unsupported(std::to_string(precision_) + "-bit JPEG (the decoder reads 8-bit samples)");
        const int nc = (int)comps_.size();
        if (nc > 10) malformed("JPEG of more than 10 components");
        for (const Component& c : comps_)
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) malformed("bad JPEG sampling factors");
        if (nc == 1) {
            color_ = GRAY;
        } else if (nc == 3) {
            if (saw_jfif_)
                color_ = YCC;
            else if (saw_adobe_)
                color_ = adobe_transform_ == 0 ? RGB : YCC;
            else
                color_ = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B' ? RGB : YCC;
        } else if (nc == 4) {
            color_ = saw_adobe_ && adobe_transform_ != 0 ? YCCK : CMYK;
        } else {
            unsupported(std::to_string(nc) + "-component JPEG (libjpeg converts no such colour space to BGR, "
                                             "and cv2 reads 1, 3 and 4 components)");
        }
        for (const Component& c : comps_) {
            max_h_ = std::max(max_h_, c.h);
            max_v_ = std::max(max_v_, c.v);
        }
        for (const Component& c : comps_)
            if (max_h_ % c.h || max_v_ % c.v)
                unsupported("JPEG with fractional sampling ratios (libjpeg does not upsample them)");
        const int mcus_per_row = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
        total_imcu_rows_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
        for (Component& c : comps_) {
            c.width_in_blocks = (int)(((int64_t)width_ * c.h + 8 * max_h_ - 1) / (8 * max_h_));
            c.height_in_blocks = (int)(((int64_t)height_ * c.v + 8 * max_v_ - 1) / (8 * max_v_));
            c.downsampled_width = (int)(((int64_t)width_ * c.h + max_h_ - 1) / max_h_);
            c.downsampled_height = (int)(((int64_t)height_ * c.v + max_v_ - 1) / max_v_);
            c.bw = mcus_per_row * c.h;
            c.bh = total_imcu_rows_ * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_coef_bits[k] = -1;
        }
        if (!arith_) {  // jstdhuff.c: the standard tables fill slots 0 and 1 left empty
            const uint8_t* std_vals[4] = {kStdDcVals, kStdAcLumVals, kStdDcVals, kStdAcChromVals};
            for (int t = 0; t < 4; t++) {
                HuffSpec& spec = (t & 1 ? ac_spec_ : dc_spec_)[t >> 1];
                if (spec.defined) continue;
                memcpy(spec.bits, kStdBits[t], 17);
                int count = 0;
                for (int i = 1; i <= 16; i++) count += kStdBits[t][i];
                memcpy(spec.vals, std_vals[t], count);
                spec.defined = true;
            }
        }
    }

    // start_input_pass (jdinput.c): per_scan_setup's limits,
    // latch_quant_tables, and the entropy decoder's start_pass.
    void start_scan() {
        const int n = (int)scan_.size();
        if (n > 1) {
            int blocks = 0;
            for (int ci : scan_) blocks += comps_[ci].h * comps_[ci].v;
            if (blocks > 10) malformed("JPEG MCU of more than 10 blocks");
        }
        for (int ci : scan_) {
            Component& c = comps_[ci];
            if (c.qt_latched) continue;
            if (c.tq > 3 || !qt_defined_[c.tq]) malformed("JPEG component without a quantization table");
            memcpy(c.qt, qt_[c.tq], sizeof c.qt);
            c.qt_latched = true;
        }
        if (progressive_) {  // start_pass_phuff_decoder / jdarith.c start_pass
            const bool dc = ss_ == 0;
            bool bad = dc ? se_ != 0 : (se_ < ss_ || se_ > 63 || n != 1);
            if (ah_ != 0 && al_ != ah_ - 1) bad = true;
            if (al_ > 13) bad = true;
            if (bad) malformed("bad progressive JPEG scan parameters");
            for (int ci : scan_) {
                Component& c = comps_[ci];
                for (int k = std::min(ss_, 1); k <= std::max(se_, 9); k++)
                    c.prev_coef_bits[k] = input_scan_number_ > 1 ? c.coef_bits[k] : 0;
                for (int k = ss_; k <= se_; k++) c.coef_bits[k] = al_;
            }
        }
        for (int i = 0; i < n; i++) {
            const bool needs_dc = !progressive_ || (ss_ == 0 && ah_ == 0);
            const bool needs_ac = !progressive_ || ss_ != 0;
            if (arith_) {
                if (needs_dc) memset(dc_stats_[scan_dc_[i]], 0, sizeof dc_stats_[0]);
                if (needs_ac) memset(ac_stats_[scan_ac_[i]], 0, sizeof ac_stats_[0]);
                dc_context_[i] = 0;
            } else {
                if (needs_dc) dc_tbl_[i].derive(table(dc_spec_, scan_dc_[i]), true);
                if (needs_ac) ac_tbl_[i].derive(table(ac_spec_, scan_ac_[i]), false);
            }
        }
    }

    static const HuffSpec& table(const HuffSpec* specs, int no) {
        if (no > 3) malformed("a scan uses a Huffman table the file does not define");
        return specs[no];
    }

    // read_restart_marker (jdmarker.c) with jpeg_resync_to_restart.
    void read_restart_marker(int& next_restart_num) {
        if (s_.unread_marker == 0) s_.next_marker();
        if (s_.unread_marker == 0xD0 + next_restart_num) {
            s_.unread_marker = 0;
        } else {
            const int desired = next_restart_num;
            for (;;) {
                const int m = s_.unread_marker;
                int action;
                if (m < 0xC0)
                    action = 2;
                else if (m < 0xD0 || m > 0xD7)
                    action = 3;
                else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7))
                    action = 3;
                else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7))
                    action = 2;
                else
                    action = 1;
                if (action == 1) {
                    s_.unread_marker = 0;
                    break;
                }
                if (action == 3) break;
                s_.next_marker();
            }
        }
        next_restart_num = (next_restart_num + 1) & 7;
    }

    // consume_data (jdcoefct.c) over one scan: its MCUs in order, an iMCU
    // row at a time, with the entropy decoder's restart processing.
    void decode_scan() {
        BitReader br{&s_};
        ArithDecoder ad{&s_};
        const int ns = (int)scan_.size();
        int mcus_per_row, mcu_rows, rows_per_imcu;
        struct Blk { int ci, slot, dy, dx; };
        std::vector<Blk> blocks;
        if (ns == 1) {
            const Component& c = comps_[scan_[0]];
            mcus_per_row = c.width_in_blocks;
            mcu_rows = c.height_in_blocks;
            rows_per_imcu = c.v;
            blocks.push_back({scan_[0], 0, 0, 0});
        } else {
            mcus_per_row = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
            mcu_rows = total_imcu_rows_;
            rows_per_imcu = 1;
            for (int i = 0; i < ns; i++) {
                const Component& c = comps_[scan_[i]];
                for (int y = 0; y < c.v; y++)
                    for (int x = 0; x < c.h; x++) blocks.push_back({scan_[i], i, y, x});
            }
        }
        int last_dc[4] = {0, 0, 0, 0};
        int eobrun = 0, next_restart_num = 0;
        int restarts_to_go = restart_interval_;
        const bool dc_refine = progressive_ && ss_ == 0 && ah_ != 0;
        for (int my = 0; my < mcu_rows; my++) {
            // the start of an iMCU row: jdcoefct.c notes the last one begun
            // before the data ran out (its smoothing reads the rows after it
            // with the coefficient bits the scan found)
            if (my % rows_per_imcu == 0 && !br.insufficient) last_good_imcu_row_ = my / rows_per_imcu;
            for (int mx = 0; mx < mcus_per_row; mx++) {
                if (restart_interval_) {
                    if (restarts_to_go == 0) {
                        if (arith_) {
                            read_restart_marker(next_restart_num);
                            restart_arith(ns, last_dc, ad);
                        } else {
                            br.bits = 0;
                            read_restart_marker(next_restart_num);
                            for (int i = 0; i < 4; i++) last_dc[i] = 0;
                            eobrun = 0;
                            if (s_.unread_marker == 0) br.insufficient = false;
                        }
                        restarts_to_go = restart_interval_;
                    }
                    restarts_to_go--;
                }
                if (arith_) {
                    decode_mcu_arith(my, mx, blocks, ns, last_dc, ad);
                    continue;
                }
                if (br.insufficient && !dc_refine) continue;  // the MCU stays as it is
                for (const Blk& b : blocks) {
                    int16_t* blk = block_of(b, my, mx, ns);
                    if (!progressive_)
                        decode_sequential(br, blk, dc_tbl_[b.slot], ac_tbl_[b.slot], last_dc[b.slot]);
                    else if (ss_ == 0 && ah_ == 0)
                        decode_dc_first(br, blk, dc_tbl_[b.slot], last_dc[b.slot]);
                    else if (ss_ == 0)
                        decode_dc_refine(br, blk);
                    else if (ah_ == 0)
                        decode_ac_first(br, blk, ac_tbl_[b.slot], eobrun);
                    else
                        decode_ac_refine(br, blk, ac_tbl_[b.slot], eobrun);
                }
            }
        }
    }

    template <class B>
    int16_t* block_of(const B& b, int my, int mx, int ns) {
        Component& c = comps_[b.ci];
        return ns == 1 ? c.block(my, mx) : c.block(my * c.v + b.dy, mx * c.h + b.dx);
    }

    void decode_sequential(BitReader& br, int16_t* blk, const Huffman& dct, const Huffman& act, int& last_dc) {
        int s = br.decode(dct);
        if (s) s = extend((int)br.get(s), s);
        s = (int)((unsigned)s + (unsigned)last_dc);
        last_dc = s;
        blk[0] = (int16_t)s;
        for (int k = 1; k < 64; k++) {
            s = br.decode(act);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend((int)br.get(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void decode_dc_first(BitReader& br, int16_t* blk, const Huffman& dct, int& last_dc) {
        int s = br.decode(dct);
        if (s) s = extend((int)br.get(s), s);
        s += last_dc;
        last_dc = s;
        blk[0] = (int16_t)((unsigned)s << al_);
    }

    void decode_dc_refine(BitReader& br, int16_t* blk) {
        if (br.get(1)) blk[0] |= (int16_t)(1 << al_);
    }

    void decode_ac_first(BitReader& br, int16_t* blk, const Huffman& act, int& eobrun) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        for (int k = ss_; k <= se_; k++) {
            int s = br.decode(act);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                s = extend((int)br.get(s), s);
                blk[kNatural[k]] = (int16_t)((unsigned)s << al_);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += (int)br.get(r);
                eobrun--;
                break;
            }
        }
    }

    void decode_ac_refine(BitReader& br, int16_t* blk, const Huffman& act, int& eobrun) {
        const int p1 = 1 << al_, m1 = -1 * (1 << al_);
        int k = ss_;
        auto refine = [&](int16_t& coef) {
            if (br.get(1) && (coef & p1) == 0) coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
        };
        if (eobrun == 0) {
            for (; k <= se_; k++) {
                int s = br.decode(act);
                int r = s >> 4;
                s &= 15;
                if (s) {
                    s = br.get(1) ? p1 : m1;  // a newly nonzero coefficient (size 1)
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += (int)br.get(r);
                    break;
                }
                do {
                    int16_t& coef = blk[kNatural[k]];
                    if (coef != 0) {
                        refine(coef);
                    } else if (--r < 0) {
                        break;
                    }
                    k++;
                } while (k <= se_);
                if (s) blk[kNatural[k]] = (int16_t)s;
            }
        }
        if (eobrun > 0) {
            for (; k <= se_; k++) {
                int16_t& coef = blk[kNatural[k]];
                if (coef != 0) refine(coef);
            }
            eobrun--;
        }
    }

    // process_restart of jdarith.c (after read_restart_marker).
    void restart_arith(int ns, int* last_dc, ArithDecoder& ad) {
        for (int i = 0; i < ns; i++) {
            if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
                memset(dc_stats_[scan_dc_[i]], 0, sizeof dc_stats_[0]);
                last_dc[i] = 0;
                dc_context_[i] = 0;
            }
            if (!progressive_ || ss_) memset(ac_stats_[scan_ac_[i]], 0, sizeof ac_stats_[0]);
        }
        ad.c = 0;
        ad.a = 0;
        ad.ct = -16;
    }

    template <class Blocks>
    void decode_mcu_arith(int my, int mx, const Blocks& blocks, int ns, int* last_dc, ArithDecoder& ad) {
        if (progressive_ && ss_ == 0 && ah_ != 0) {  // decode_mcu_DC_refine: no error check
            for (const auto& b : blocks)
                if (ad.decode(fixed_bin_)) block_of(b, my, mx, ns)[0] |= (int16_t)(1 << al_);
            return;
        }
        if (ad.ct == -1) return;  // after a code error, nothing until the next restart
        if (progressive_ && ss_ != 0) {
            int16_t* blk = block_of(blocks[0], my, mx, ns);
            if (ah_ == 0)
                arith_ac_first(blk, scan_ac_[0], ad);
            else
                arith_ac_refine(blk, scan_ac_[0], ad);
            return;
        }
        for (const auto& b : blocks) {
            int16_t* blk = block_of(b, my, mx, ns);
            if (!arith_dc(b.slot, last_dc, ad)) return;
            if (!progressive_) {
                blk[0] = (int16_t)last_dc[b.slot];
                if (!arith_ac_sequential(blk, scan_ac_[b.slot], ad)) return;
            } else {
                blk[0] = (int16_t)((unsigned)last_dc[b.slot] << al_);
            }
        }
    }

    // Figures F.19-F.24: a DC difference into last_dc (mod 2^16). False on a
    // magnitude overflow (ct = -1).
    bool arith_dc(int slot, int* last_dc, ArithDecoder& ad) {
        const int tbl = scan_dc_[slot];
        uint8_t* st = dc_stats_[tbl] + dc_context_[slot];
        if (ad.decode(st) == 0) {
            dc_context_[slot] = 0;
            return true;
        }
        const int sign = ad.decode(st + 1);
        st += 2 + sign;
        int m = ad.decode(st);
        if (m != 0) {
            st = dc_stats_[tbl] + 20;
            while (ad.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ad.ct = -1;
                    return false;
                }
                st += 1;
            }
        }
        if (m < (int)((1L << arith_dc_l_[tbl]) >> 1))
            dc_context_[slot] = 0;
        else if (m > (int)((1L << arith_dc_u_[tbl]) >> 1))
            dc_context_[slot] = 12 + sign * 4;
        else
            dc_context_[slot] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ad.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        last_dc[slot] = (last_dc[slot] + v) & 0xFFFF;
        return true;
    }

    // The magnitude of a nonzero AC coefficient at zigzag index k, st at its
    // bin S0 + 2; -1 on an overflow.
    int arith_ac_value(int k, uint8_t* st, int tbl, ArithDecoder& ad) {
        const int sign = ad.decode(fixed_bin_);
        st += 2;
        int m = ad.decode(st);
        if (m != 0) {
            if (ad.decode(st)) {
                m <<= 1;
                st = ac_stats_[tbl] + (k <= arith_ac_k_[tbl] ? 189 : 217);
                while (ad.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        ad.ct = -1;
                        return -1;
                    }
                    st += 1;
                }
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (ad.decode(st)) v |= m;
        v += 1;
        return sign ? -v : v;
    }

    bool arith_ac_sequential(int16_t* blk, int tbl, ArithDecoder& ad) {
        for (int k = 1; k <= 63; k++) {
            uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
            if (ad.decode(st)) break;  // EOB
            while (ad.decode(st + 1) == 0) {
                st += 3;
                if (++k > 63) {
                    ad.ct = -1;
                    return false;
                }
            }
            const int v = arith_ac_value(k, st, tbl, ad);
            if (ad.ct == -1) return false;
            blk[kNatural[k]] = (int16_t)v;
        }
        return true;
    }

    void arith_ac_first(int16_t* blk, int tbl, ArithDecoder& ad) {
        for (int k = ss_; k <= se_; k++) {
            uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
            if (ad.decode(st)) break;
            while (ad.decode(st + 1) == 0) {
                st += 3;
                if (++k > se_) {
                    ad.ct = -1;
                    return;
                }
            }
            const int v = arith_ac_value(k, st, tbl, ad);
            if (ad.ct == -1) return;
            blk[kNatural[k]] = (int16_t)((unsigned)v << al_);
        }
    }

    void arith_ac_refine(int16_t* blk, int tbl, ArithDecoder& ad) {
        const int p1 = 1 << al_, m1 = (int)((unsigned)-1 << al_);
        int kex = se_;
        for (; kex > 0; kex--)
            if (blk[kNatural[kex]]) break;
        for (int k = ss_; k <= se_; k++) {
            uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
            if (k > kex)
                if (ad.decode(st)) break;
            for (;;) {
                int16_t& coef = blk[kNatural[k]];
                if (coef) {
                    if (ad.decode(st + 2)) coef = (int16_t)(coef < 0 ? coef + m1 : coef + p1);
                    break;
                }
                if (ad.decode(st + 1)) {
                    coef = (int16_t)(ad.decode(fixed_bin_) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se_) {
                    ad.ct = -1;
                    return;
                }
            }
        }
    }

    // smoothing_ok (jdcoefct.c): whether block smoothing applies, with the
    // coefficient-bit latches of each component (coef_bits, and for the
    // iMCU rows past the last one decoded from data, prev_coef_bits).
    bool smoothing_ok(std::vector<std::array<int, 2 * kSavedCoefs>>& latch) {
        if (!progressive_) return false;
        bool useful = false;
        latch.assign(comps_.size(), {});
        for (size_t ci = 0; ci < comps_.size(); ci++) {
            const Component& c = comps_[ci];
            if (!c.qt_latched) return false;
            for (int k = 0; k < kSavedCoefs; k++)
                if (c.qt[kNatural[k]] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            latch[ci][0] = c.coef_bits[0];
            for (int k = 1; k < kSavedCoefs; k++) {
                latch[ci][kSavedCoefs + k] = input_scan_number_ > 1 ? c.prev_coef_bits[k] : -1;
                latch[ci][k] = c.coef_bits[k];
                if (c.coef_bits[k] != 0) useful = true;
            }
        }
        return useful;
    }

    // decompress_smooth_data (jdcoefct.c, libjpeg-turbo 2.1): the first 9 AC
    // coefficients of a block that are still zero and not known to full
    // precision are estimated from the DC values of the 5x5 blocks around
    // it (and the DC itself too, when no AC data was sent at all), then the
    // block goes through the IDCT. Writes component ci's plane. `v312`
    // takes the blocks around a block as libjpeg-turbo 3.1.2 takes them
    // (found against cv2 5.0, which bundles it): whole-buffer rows but in a
    // partial last iMCU row, and the last column repeated on the right.
    void smooth_idct(int ci, const std::array<int, 2 * kSavedCoefs>& latch, uint8_t* plane, int stride,
                     bool v312) {
        Component& c = comps_[ci];
        const int last_imcu_row = total_imcu_rows_ - 1;
        const int last_block_column = c.width_in_blocks - 1;
        const int64_t Q00 = c.qt[0], Q01 = c.qt[1], Q10 = c.qt[8], Q20 = c.qt[16], Q11 = c.qt[9], Q02 = c.qt[2],
                      Q03 = c.qt[3], Q12 = c.qt[10], Q21 = c.qt[17], Q30 = c.qt[24];
        int16_t ws[64];
        auto estimate = [](int64_t num, int64_t q, int al) {
            int pred;
            if (num >= 0) {
                pred = (int)(((q << 7) + num) / (q << 8));
                if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
                pred = (int)(((q << 7) - num) / (q << 8));
                if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
                pred = -pred;
            }
            return (int16_t)pred;
        };
        for (int imcu = 0; imcu <= last_imcu_row; imcu++) {
            int block_rows = c.v;
            if (imcu == last_imcu_row) {
                block_rows = c.height_in_blocks % c.v;
                if (block_rows == 0) block_rows = c.v;
            }
            const int* bits = latch.data() + (imcu > last_good_imcu_row_ ? kSavedCoefs : 0);
            const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                                   bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                                   bits[9] == -1;
            for (int br = 0; br < block_rows; br++) {
                const int r = imcu * c.v + br;
                int prev = (br > 0 || imcu > 0) ? r - 1 : r;
                int prev_prev = (br > 1 || imcu > 1) ? r - 2 : prev;
                int next = (br < block_rows - 1 || imcu < last_imcu_row) ? r + 1 : r;
                int next_next = (br < block_rows - 2 || imcu + 1 < last_imcu_row) ? r + 2 : next;
                if (v312 && (imcu < last_imcu_row || block_rows == c.v)) {
                    // libjpeg-turbo 3.1.2 reads the rows around a block in the
                    // whole (MCU-padded) buffer, but in a last iMCU row that
                    // holds fewer block rows than its sampling factor
                    prev = r > 0 ? r - 1 : r;
                    prev_prev = r > 1 ? r - 2 : prev;
                    next = r + 1 < c.bh ? r + 1 : r;
                    next_next = r + 2 < c.bh ? r + 2 : next;
                }
                auto dc = [&](int row, int col) { return (int)c.block(row, col)[0]; };
                int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14, DC15, DC16,
                    DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
                DC01 = DC02 = DC03 = DC04 = DC05 = dc(prev_prev, 0);
                DC06 = DC07 = DC08 = DC09 = DC10 = dc(prev, 0);
                DC11 = DC12 = DC13 = DC14 = DC15 = dc(r, 0);
                DC16 = DC17 = DC18 = DC19 = DC20 = dc(next, 0);
                DC21 = DC22 = DC23 = DC24 = DC25 = dc(next_next, 0);
                for (int col = 0; col <= last_block_column; col++) {
                    memcpy(ws, c.block(r, col), sizeof ws);
                    if (col == 0 && col < last_block_column) {
                        DC04 = dc(prev_prev, col + 1);
                        DC09 = dc(prev, col + 1);
                        DC14 = dc(r, col + 1);
                        DC19 = dc(next, col + 1);
                        DC24 = dc(next_next, col + 1);
                    }
                    if (col + 1 < last_block_column) {
                        DC05 = dc(prev_prev, col + 2);
                        DC10 = dc(prev, col + 2);
                        DC15 = dc(r, col + 2);
                        DC20 = dc(next, col + 2);
                        DC25 = dc(next_next, col + 2);
                    } else if (v312) {  // 3.1.2: the columns past the last repeat it
                        DC05 = DC04;
                        DC10 = DC09;
                        DC15 = DC14;
                        DC20 = DC19;
                        DC25 = DC24;
                    }
                    int al;
                    if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
                        const int64_t num = Q00 * (change_dc ?
                            (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                             38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 -
                             DC22 + DC24 + DC25) :
                            (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                        ws[1] = estimate(num, Q01, al);
                    }
                    if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
                        const int64_t num = Q00 * (change_dc ?
                            (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
                             13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 +
                             3 * DC23 + 3 * DC24 + DC25) :
                            (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                        ws[8] = estimate(num, Q10, al);
                    }
                    if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
                        const int64_t num = Q00 * (change_dc ?
                            (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                             7 * DC18 + 2 * DC19 + DC23) :
                            (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                        ws[16] = estimate(num, Q20, al);
                    }
                    if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
                        const int64_t num = Q00 * (change_dc ?
                            (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
                            (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
                             10 * DC07 - 10 * DC09));
                        ws[9] = estimate(num, Q11, al);
                    }
                    if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
                        const int64_t num = Q00 * (change_dc ?
                            (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                             2 * DC17 - 5 * DC18 + 2 * DC19) :
                            (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                        ws[2] = estimate(num, Q02, al);
                    }
                    if (change_dc) {
                        if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
                            ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
                        if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
                            ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
                        if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
                            ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
                        if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
                            ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
                        const int64_t num = Q00 *
                            (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                             6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                             6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 -
                             6 * DC24 - 2 * DC25);
                        ws[0] = estimate(num, Q00, 0);
                    }
                    idct_islow(ws, c.qt, plane + (size_t)r * 8 * stride + col * 8, stride);
                    DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                    DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                    DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                    DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                    DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
                }
            }
        }
    }

    static Upsample method(const Component& c, int max_h, int max_v) {  // jinit_upsampler
        if (c.h == max_h && c.v == max_v) return FULLSIZE;
        if (c.h * 2 == max_h && c.v == max_v) return c.downsampled_width > 2 ? H2V1_FANCY : H2V1_BOX;
        if (c.h == max_h && c.v * 2 == max_v) return H1V2_FANCY;
        if (c.h * 2 == max_h && c.v * 2 == max_v) return c.downsampled_width > 2 ? H2V2_FANCY : H2V2_BOX;
        return INTEGRAL;
    }

    void output(uint8_t* out) {
        const Tables& t = tables();
        const int nc = (int)comps_.size();
        std::vector<std::vector<uint8_t>> planes(nc);
        std::vector<int> stride(nc);
        std::vector<std::array<int, 2 * kSavedCoefs>> latch;
        const bool smooth = smoothing_ok(latch);
        for (int ci = 0; ci < nc; ci++) {  // IDCT of every block the image shows
            Component& c = comps_[ci];
            stride[ci] = c.width_in_blocks * 8;
            planes[ci].resize((size_t)stride[ci] * c.height_in_blocks * 8);
            if (smooth) {
                // a 4-component file is read by cv2, which smooths with
                // libjpeg-turbo 3.1.2's neighbourhood
                smooth_idct(ci, latch[ci], planes[ci].data(), stride[ci], nc == 4);
                continue;
            }
            for (int by = 0; by < c.height_in_blocks; by++)
                for (int bx = 0; bx < c.width_in_blocks; bx++)
                    idct_islow(c.block(by, bx), c.qt, planes[ci].data() + (size_t)by * 8 * stride[ci] + bx * 8,
                               stride[ci]);
        }
        std::vector<std::vector<uint8_t>> rows(nc, std::vector<uint8_t>((size_t)width_ + 16));
        std::vector<int> colsum((size_t)width_ + 2);
        const uint8_t* row[4];
        for (int y = 0; y < height_; y++) {
            for (int ci = 0; ci < nc; ci++) {
                const Component& c = comps_[ci];
                const uint8_t* plane = planes[ci].data();
                const int s = stride[ci], dw = c.downsampled_width, dh = c.downsampled_height;
                uint8_t* o = rows[ci].data();
                switch (method(c, max_h_, max_v_)) {
                    case FULLSIZE:
                        row[ci] = plane + (size_t)y * s;
                        continue;
                    case H2V1_FANCY: {
                        const uint8_t* in = plane + (size_t)y * s;
                        for (int j = 0; j < dw; j++) {
                            int a = in[j] * 3;
                            o[2 * j] = (uint8_t)((a + in[j > 0 ? j - 1 : 0] + 1) >> 2);
                            o[2 * j + 1] = (uint8_t)((a + in[j < dw - 1 ? j + 1 : dw - 1] + 2) >> 2);
                        }
                        break;
                    }
                    case H1V2_FANCY: {
                        const int r = y >> 1;
                        const int nb = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
                        const int bias = (y & 1) ? 2 : 1;
                        const uint8_t* in0 = plane + (size_t)r * s;
                        const uint8_t* in1 = plane + (size_t)nb * s;
                        for (int j = 0; j < dw; j++) o[j] = (uint8_t)((in0[j] * 3 + in1[j] + bias) >> 2);
                        break;
                    }
                    case H2V2_FANCY: {
                        const int r = y >> 1;
                        const int nb = (y & 1) ? std::min(r + 1, dh - 1) : std::max(r - 1, 0);
                        const uint8_t* in0 = plane + (size_t)r * s;
                        const uint8_t* in1 = plane + (size_t)nb * s;
                        for (int j = 0; j < dw; j++) colsum[j] = in0[j] * 3 + in1[j];
                        for (int j = 0; j < dw; j++) {
                            int a = colsum[j] * 3;
                            o[2 * j] = (uint8_t)((a + colsum[j > 0 ? j - 1 : 0] + 8) >> 4);
                            o[2 * j + 1] = (uint8_t)((a + colsum[j < dw - 1 ? j + 1 : dw - 1] + 7) >> 4);
                        }
                        break;
                    }
                    case H2V1_BOX:
                    case H2V2_BOX:
                    case INTEGRAL: {
                        const int he = max_h_ / c.h, ve = max_v_ / c.v;
                        const uint8_t* in = plane + (size_t)(y / ve) * s;
                        for (int x = 0; x < width_; x++) o[x] = in[x / he];
                        break;
                    }
                }
                row[ci] = o;
            }
            uint8_t* dst = out + (size_t)y * width_ * 3;
            switch (color_) {
                case GRAY:
                    for (int x = 0; x < width_; x++) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[0][x];
                    break;
                case RGB:
                    for (int x = 0; x < width_; x++) {
                        dst[3 * x] = row[2][x];
                        dst[3 * x + 1] = row[1][x];
                        dst[3 * x + 2] = row[0][x];
                    }
                    break;
                case YCC:
                    for (int x = 0; x < width_; x++) {
                        const int yy = row[0][x], cb = row[1][x], cr = row[2][x];
                        dst[3 * x] = t.clamp(yy + t.cb_b[cb]);
                        dst[3 * x + 1] = t.clamp(yy + (int)(((int64_t)t.cb_g[cb] + t.cr_g[cr]) >> 16));
                        dst[3 * x + 2] = t.clamp(yy + t.cr_r[cr]);
                    }
                    break;
                case CMYK:
                case YCCK:
                    for (int x = 0; x < width_; x++) {
                        int cc = row[0][x], mm = row[1][x], yy = row[2][x];
                        const int k = row[3][x];
                        if (color_ == YCCK) {  // ycck_cmyk_convert
                            const int luma = row[0][x], cb = row[1][x], cr = row[2][x];
                            cc = t.clamp(255 - (luma + t.cr_r[cr]));
                            mm = t.clamp(255 - (luma + (int)(((int64_t)t.cb_g[cb] + t.cr_g[cr]) >> 16)));
                            yy = t.clamp(255 - (luma + t.cb_b[cb]));
                        }
                        // icvCvt_CMYK2BGR_8u_C4C3R
                        dst[3 * x] = (uint8_t)(k - ((255 - yy) * k >> 8));
                        dst[3 * x + 1] = (uint8_t)(k - ((255 - mm) * k >> 8));
                        dst[3 * x + 2] = (uint8_t)(k - ((255 - cc) * k >> 8));
                    }
                    break;
            }
        }
    }
};

}  // namespace

extern "C" int32_t jpeg_decode_resize_bgr(const uint8_t* buf, int64_t n, int32_t h, int32_t w, uint8_t* out,
                                          int32_t dh, int32_t dw, char* msg, int32_t msg_len) {
    try {
        if (h <= 0 || w <= 0 || dh <= 0 || dw <= 0) malformed("bad image size");
        JpegDecoder dec(buf, (size_t)n);
        bool mismatch = false;
        if (h == dh && w == dw) {
            dec.decode(h, w, out, &mismatch);
            return mismatch ? -3 : 0;
        }
        std::vector<uint8_t> full((size_t)h * w * 3);
        dec.decode(h, w, full.data(), &mismatch);
        if (mismatch) return -3;
        return resize_bilinear_u8(full.data(), h, w, 3, out, dh, dw);
    } catch (const JpegError& e) {
        if (msg_len > 0) {
            strncpy(msg, e.msg.c_str(), (size_t)msg_len - 1);
            msg[msg_len - 1] = 0;
        }
        return e.code;
    } catch (const std::bad_alloc&) {
        if (msg_len > 0) strncpy(msg, "out of memory", (size_t)msg_len);
        return -1;
    }
}
