// Host image code of the port's data loader: the PNG row filters undone
// into BGR, a baseline/progressive JPEG decoder, and a Pillow-exact uint8
// bilinear resize. Plain C interface, loaded with ctypes (which releases the
// GIL for the call), no dependencies.
//
// Counterpart of dd3d_tpu/data/native/imageio.cpp, which decodes with
// libpng and libjpeg. The port builds without either library, so it
// splits the PNG decode: Python's zlib inflates the IDAT stream
// (dd3d_tpu_torch/data/imageio.py) and `png_unfilter_bgr` here undoes the
// five row filters of 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA
// images and writes BGR, dropping alpha, as cv2.imread(path, IMREAD_COLOR)
// returns them. `jpeg_decode_resize_bgr` decodes a JPEG as libjpeg-turbo
// does with every default but out_color_space = JCS_EXT_BGR (the JAX
// package's settings), byte for byte; see the JPEG section. The resize is
// the JAX package's reimplementation of Pillow's ImagingResample for the
// bilinear filter (dd3d_tpu/data/native/imageio.cpp:214-336), copied as it
// is: the port's ResizeTransform must equal PIL's Image.resize(...,
// BILINEAR) byte for byte (tests/test_torch_imageio.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
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

// Decodes the JPEG `buf` of n bytes, whose header says h x w, to BGR and
// resizes it to (dh, dw) as resize_bilinear_u8 does (not at all when equal),
// into `out` (dh*dw*3 bytes). Returns 0; -1 for a malformed file, -2 for a
// kind of JPEG the decoder does not read, -3 when the header's size is not
// (h, w); for -1 and -2 a message is written to `msg` (msg_len bytes).
int32_t jpeg_decode_resize_bgr(const uint8_t* buf, int64_t n, int32_t h, int32_t w, uint8_t* out,
                               int32_t dh, int32_t dw, char* msg, int32_t msg_len);
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

// ---------------------------------------------------------------------------
// JPEG, as libjpeg-turbo decodes it with jpeg_read_header, out_color_space =
// JCS_EXT_BGR and jpeg_read_scanlines (dd3d_tpu/data/native/imageio.cpp:
// 148-185), every other setting at its default: ISLOW IDCT, fancy
// upsampling, no block smoothing needed. Each step follows the libjpeg-turbo
// file named beside it, down to its rounding:
//   markers                      jdmarker.c (next_marker, resync_to_restart)
//   colour space of the file     jdapimin.c (default_decompress_parms)
//   Huffman tables and decode    jdhuff.c (jpeg_make_d_derived_tbl,
//                                jpeg_fill_bit_buffer, decode_mcu_slow,
//                                process_restart), jstdhuff.c
//   progressive scans            jdphuff.c (decode_mcu_{DC,AC}_{first,refine})
//   IDCT                         jidctint.c (jpeg_idct_islow), the range
//                                limit of jdmaster.c (prepare_range_limit_table)
//   upsampling                   jdsample.c (jinit_upsampler, h2v1/h2v2/h1v2
//                                fancy, int_upsample), with jdmainct.c's
//                                context rows: the first and the last real
//                                row of a component repeat past its edges
//   colour conversion            jdcolor.c (ycc_rgb_convert, gray_rgb_convert,
//                                rgb_rgb_convert)
// Entropy data that ends early (a truncated file) reads as libjpeg reads it
// from jpeg_mem_src: a fake EOI marker follows the last byte, the bit
// reader pads with zero bits, and every MCU that starts after a padding bit
// was taken decodes to zero coefficients (mid-gray).
//
// Read: SOF0/SOF1 (sequential Huffman, one scan or several) and SOF2
// (progressive Huffman), 8-bit samples, 1 component (gray) or 3 (YCbCr, or
// RGB as the file's markers say), any integral sampling factors,
// restart intervals, APPn/COM skipped (an EXIF orientation is not applied,
// as libjpeg does not apply it). Not read, with a message naming the kind:
// arithmetic coding, lossless and hierarchical frames, 12- and 16-bit
// samples, 2 or 4 components (CMYK/YCCK), fractional sampling ratios, and a
// progressive file whose scans leave some coefficient bits unsent (libjpeg
// would smooth its blocks, jdcoefct.c decompress_smooth_data).
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

// jpeg_fill_bit_buffer and friends over a jpeg_mem_src stream.
struct BitReader {
    const uint8_t* d;
    size_t n;
    size_t pos;
    uint64_t buf = 0;
    int bits = 0;            // valid bits, the low ones of `buf`
    int marker = 0;          // a marker the reader stopped at (cinfo->unread_marker)
    bool insufficient = false;
    int fake = 0;

    // jpeg_mem_src: past the end, a fake EOI marker, as often as asked.
    int byte() {
        if (pos < n) return d[pos++];
        return (fake++ & 1) ? 0xD9 : 0xFF;
    }

    void fill() {
        while (bits < 57 && marker == 0) {
            int c = byte();
            if (c == 0xFF) {
                do c = byte();
                while (c == 0xFF);
                if (c == 0) {
                    c = 0xFF;
                } else {
                    marker = c;
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
        marker = c;
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
    int coef_bits[64];
    int16_t* block(int by, int bx) { return coef.data() + ((size_t)by * bw + bx) * 64; }
};

// The post-IDCT range limit of prepare_range_limit_table, indexed by the
// centred sample & 1023, and the plain [-256, 511] -> [0, 255] clamp.
struct Tables {
    uint8_t idct_limit[1024];
    uint8_t clamp_[768];
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    Tables() {
        for (int i = 0; i < 1024; i++)
            idct_limit[i] = i < 128 ? (uint8_t)(i + 128) : i < 512 ? 255 : i < 896 ? 0 : (uint8_t)(i - 896);
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

// jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, DESCALE rounding.
void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride, const uint8_t* limit) {
    const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373, F1_175 = 9633,
                  F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819, F2_562 = 20995,
                  F3_072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; c++) {  // pass 1: columns
        const int16_t* ip = in + c;
        const int32_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
            int dc = (int)((uint32_t)(ip[0] * qp[0]) << 2);
            for (int r = 0; r < 8; r++) wp[r * 8] = dc;
            continue;
        }
        int64_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
        int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = ip[56] * qp[56];
        tmp1 = ip[40] * qp[40];
        tmp2 = ip[24] * qp[24];
        tmp3 = ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175;
        tmp0 *= F0_298;
        tmp1 *= F2_053;
        tmp2 *= F3_072;
        tmp3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int64_t r1 = (int64_t)1 << 10;  // DESCALE by CONST_BITS - PASS1_BITS = 11
        wp[0] = (int)((t10 + tmp3 + r1) >> 11);
        wp[56] = (int)((t10 - tmp3 + r1) >> 11);
        wp[8] = (int)((t11 + tmp2 + r1) >> 11);
        wp[48] = (int)((t11 - tmp2 + r1) >> 11);
        wp[16] = (int)((t12 + tmp1 + r1) >> 11);
        wp[40] = (int)((t12 - tmp1 + r1) >> 11);
        wp[24] = (int)((t13 + tmp0 + r1) >> 11);
        wp[32] = (int)((t13 - tmp0 + r1) >> 11);
    }
    for (int r = 0; r < 8; r++) {  // pass 2: rows
        const int* wp = ws + r * 8;
        uint8_t* op = out + (size_t)r * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
            uint8_t dc = limit[(int)(((int64_t)wp[0] + 16) >> 5) & 1023];
            for (int c = 0; c < 8; c++) op[c] = dc;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * F0_541;
        int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
        int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * 8192, tmp1 = ((int64_t)wp[0] - wp[4]) * 8192;
        int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175;
        tmp0 *= F0_298;
        tmp1 *= F2_053;
        tmp2 *= F3_072;
        tmp3 *= F1_501;
        z1 *= -F0_899;
        z2 *= -F2_562;
        z3 *= -F1_961;
        z4 *= -F0_390;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int64_t r2 = (int64_t)1 << 17;  // DESCALE by CONST_BITS + PASS1_BITS + 3 = 18
        op[0] = limit[(int)((t10 + tmp3 + r2) >> 18) & 1023];
        op[7] = limit[(int)((t10 - tmp3 + r2) >> 18) & 1023];
        op[1] = limit[(int)((t11 + tmp2 + r2) >> 18) & 1023];
        op[6] = limit[(int)((t11 - tmp2 + r2) >> 18) & 1023];
        op[2] = limit[(int)((t12 + tmp1 + r2) >> 18) & 1023];
        op[5] = limit[(int)((t12 - tmp1 + r2) >> 18) & 1023];
        op[3] = limit[(int)((t13 + tmp0 + r2) >> 18) & 1023];
        op[4] = limit[(int)((t13 - tmp0 + r2) >> 18) & 1023];
    }
}

enum Upsample { FULLSIZE, H2V1_FANCY, H2V1_BOX, H1V2_FANCY, H2V2_FANCY, H2V2_BOX, INTEGRAL };

class JpegDecoder {
  public:
    JpegDecoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

    void decode(int32_t want_h, int32_t want_w, uint8_t* out, bool* size_mismatch) {
        if (n_ < 3 || d_[0] != 0xFF || d_[1] != 0xD8) malformed("not a JPEG file (no SOI marker)");
        pos_ = 2;
        int m = read_markers();  // to the first SOS
        if (m != 0xDA) malformed("JPEG without a scan (no SOS before EOI)");
        if ((int32_t)height_ != want_h || (int32_t)width_ != want_w) {
            *size_mismatch = true;
            return;
        }
        start_frame();
        read_scan_header();
        const bool multiscan = progressive_ || (int)scan_.size() < (int)comps_.size();
        decode_scan();
        while (multiscan) {  // the whole-image buffer: every scan up to EOI
            pos_ = br_.pos;
            m = br_.marker;
            if (m == 0) {
                br_.next_marker();
                m = br_.marker;
                pos_ = br_.pos;
            }
            fake_ = br_.fake;
            m = read_markers(m);
            if (m != 0xDA) break;  // EOI
            read_scan_header();
            decode_scan();
        }
        if (progressive_)
            for (const Component& c : comps_)
                for (int k = 0; k < 64; k++)
                    if (c.coef_bits[k] != 0)
                        unsupported("progressive JPEG whose scans leave coefficient bits unsent (libjpeg smooths "
                                    "such blocks)");
        output(out);
    }

  private:
    const uint8_t* d_;
    size_t n_;
    size_t pos_ = 0;
    int fake_ = 0;
    bool have_sof_ = false, progressive_ = false;
    int height_ = 0, width_ = 0;
    int restart_interval_ = 0;
    bool saw_jfif_ = false, saw_adobe_ = false;
    int adobe_transform_ = 0;
    bool qt_defined_[4] = {};
    int32_t qt_[4][64];
    HuffSpec dc_spec_[4], ac_spec_[4];
    std::vector<Component> comps_;
    int max_h_ = 1, max_v_ = 1;
    bool rgb_ = false;
    // the current scan
    std::vector<int> scan_;  // component indices
    int scan_dc_[4], scan_ac_[4];
    int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
    BitReader br_{nullptr, 0, 0};

    int byte() {
        if (pos_ < n_) return d_[pos_++];
        return (fake_++ & 1) ? 0xD9 : 0xFF;  // jpeg_mem_src's fake EOI
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }
    // A marker segment's length, checked to lie in the file.
    int segment_length() {
        int len = u16();
        if (len < 2 || pos_ + (size_t)(len - 2) > n_) malformed("truncated JPEG marker segment");
        return len - 2;
    }
    int next_marker() {
        int c = byte();
        for (;;) {
            while (c != 0xFF) c = byte();
            do c = byte();
            while (c == 0xFF);
            if (c != 0) return c;
            c = byte();
        }
    }

    // read_markers: tables, restart interval and frame up to SOS or EOI;
    // returns that marker with pos_ just after it.
    int read_markers(int first = 0) {
        for (int m = first;; m = 0) {
            if (m == 0) m = next_marker();
            switch (m) {
                case 0xC0: case 0xC1: case 0xC2:
                    read_sof(m == 0xC2);
                    break;
                case 0xC3: case 0xCB:
                    unsupported("lossless JPEG (SOF" + std::to_string(m - 0xC0) + ")");
                case 0xC9: case 0xCA:
                    unsupported("arithmetic-coded JPEG (SOF" + std::to_string(m - 0xC0) + ")");
                case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
                    unsupported("hierarchical JPEG (SOF" + std::to_string(m - 0xC0) + ")");
                case 0xC4:
                    read_dht();
                    break;
                case 0xCC:
                    unsupported("arithmetic-coded JPEG (DAC marker)");
                case 0xDB:
                    read_dqt();
                    break;
                case 0xDD: {
                    int len = segment_length();
                    if (len != 2) malformed("bad DRI length");
                    restart_interval_ = u16();
                    break;
                }
                case 0xDA:
                    if (!have_sof_) malformed("JPEG scan before its frame header (SOS before SOF)");
                    return m;
                case 0xD9:
                    return m;
                case 0xD8:
                    malformed("JPEG with a second SOI marker");
                case 0xE0: case 0xEE:
                    read_app(m);
                    break;
                case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7:
                case 0x01:
                    break;  // parameterless; ignored as libjpeg ignores them here
                default:
                    if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {  // APPn, COM, DNL
                        pos_ += segment_length();
                        break;
                    }
                    char name[8];
                    snprintf(name, sizeof name, "0x%02X", m);
                    malformed(std::string("unknown JPEG marker ") + name);
            }
        }
    }

    void read_app(int m) {
        int len = segment_length();
        const uint8_t* p = d_ + pos_;
        if (m == 0xE0 && len >= 14 && !memcmp(p, "JFIF\0", 5)) saw_jfif_ = true;
        if (m == 0xEE && len >= 12 && !memcmp(p, "Adobe", 5)) {
            saw_adobe_ = true;
            adobe_transform_ = p[11];
        }
        pos_ += len;
    }

    void read_sof(bool progressive) {
        if (have_sof_) malformed("JPEG with two frame headers (SOF)");
        int len = segment_length();
        int precision = byte();
        height_ = u16();
        width_ = u16();
        int nc = byte();
        if (len != 6 + 3 * nc) malformed("bad SOF length");
        if (precision != 8)
            unsupported(std::to_string(precision) + "-bit JPEG (the decoder reads 8-bit samples)");
        if (height_ <= 0 || width_ <= 0) malformed("JPEG of height or width 0 (a DNL height is not read)");
        if (nc != 1 && nc != 3)
            unsupported(std::to_string(nc) + "-component JPEG" + (nc == 4 ? " (CMYK/YCCK)" : "") +
                        "; the decoder reads gray and 3-component files");
        comps_.resize(nc);
        for (Component& c : comps_) {
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) malformed("bad JPEG sampling factors");
        }
        progressive_ = progressive;
        have_sof_ = true;
    }

    void read_dht() {
        int len = segment_length();
        while (len > 16) {
            int index = byte();
            HuffSpec spec;
            int count = 0;
            for (int i = 1; i <= 16; i++) count += spec.bits[i] = (uint8_t)byte();
            len -= 17;
            if (count > 256 || count > len) malformed("bad Huffman table");
            for (int i = 0; i < count; i++) spec.vals[i] = (uint8_t)byte();
            len -= count;
            spec.defined = true;
            int slot = index & 15;
            if (slot > 3 || (index & ~0x1F)) malformed("bad Huffman table index");
            (index & 0x10 ? ac_spec_ : dc_spec_)[slot] = spec;
        }
        if (len != 0) malformed("bad DHT length");
    }

    void read_dqt() {
        int len = segment_length();
        while (len > 0) {
            len--;
            int n = byte();
            int prec = n >> 4;
            n &= 15;
            if (n > 3) malformed("bad quantization table index");
            int count = 64;
            if (len < 64 * (prec + 1)) count = len / (prec + 1);
            for (int i = 0; i < 64; i++) qt_[n][i] = 1;
            for (int i = 0; i < count; i++) qt_[n][kNatural[i]] = prec ? u16() : byte();
            len -= count * (prec + 1);
            qt_defined_[n] = true;
        }
    }

    // initial_setup (jdinput.c) and the colour space of default_decompress_parms.
    void start_frame() {
        for (const Component& c : comps_) {
            max_h_ = std::max(max_h_, c.h);
            max_v_ = std::max(max_v_, c.v);
        }
        const int mcus_per_row = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
        const int mcu_rows = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
        for (Component& c : comps_) {
            if (max_h_ % c.h || max_v_ % c.v)
                unsupported("JPEG with fractional sampling ratios (libjpeg does not upsample them)");
            c.width_in_blocks = (int)(((int64_t)width_ * c.h + 8 * max_h_ - 1) / (8 * max_h_));
            c.height_in_blocks = (int)(((int64_t)height_ * c.v + 8 * max_v_ - 1) / (8 * max_v_));
            c.downsampled_width = (int)(((int64_t)width_ * c.h + max_h_ - 1) / max_h_);
            c.downsampled_height = (int)(((int64_t)height_ * c.v + max_v_ - 1) / max_v_);
            c.bw = mcus_per_row * c.h;
            c.bh = mcu_rows * c.v;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
        }
        if (comps_.size() == 3) {
            if (saw_jfif_)
                rgb_ = false;
            else if (saw_adobe_)
                rgb_ = adobe_transform_ == 0;
            else
                rgb_ = comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B';
        }
        // jstdhuff.c: the standard tables fill slots 0 and 1 left empty.
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

    void read_scan_header() {
        int len = segment_length();
        int n = byte();
        if (len != 4 + 2 * n || n < 1 || n > 4 || n > (int)comps_.size()) malformed("bad SOS");
        scan_.clear();
        for (int i = 0; i < n; i++) {
            int id = byte(), tables = byte();
            int ci = -1;
            for (int j = 0; j < (int)comps_.size(); j++)
                if (comps_[j].id == id) ci = j;
            if (ci < 0) malformed("JPEG scan names an unknown component");
            for (int j : scan_)
                if (j == ci) malformed("JPEG scan names a component twice");
            scan_.push_back(ci);
            scan_dc_[i] = tables >> 4;
            scan_ac_[i] = tables & 15;
            if (scan_dc_[i] > 3 || scan_ac_[i] > 3) malformed("bad Huffman table index in SOS");
        }
        ss_ = byte();
        se_ = byte();
        int a = byte();
        ah_ = a >> 4;
        al_ = a & 15;
        if (progressive_) {  // start_pass_phuff_decoder
            bool dc = ss_ == 0;
            bool bad = dc ? se_ != 0 : (ss_ > se_ || se_ > 63 || n != 1);
            if (ah_ != 0 && al_ != ah_ - 1) bad = true;
            if (al_ > 13) bad = true;
            if (bad) malformed("bad progressive JPEG scan parameters");
            for (int ci : scan_)
                for (int k = ss_; k <= se_; k++) comps_[ci].coef_bits[k] = al_;
        }
        for (int ci : scan_) {  // latch_quant_tables: at a component's first scan
            Component& c = comps_[ci];
            if (c.qt_latched) continue;
            if (!qt_defined_[c.tq]) malformed("JPEG component without a quantization table");
            memcpy(c.qt, qt_[c.tq], sizeof c.qt);
            c.qt_latched = true;
        }
    }

    // process_restart of jdhuff.c / jdphuff.c, with read_restart_marker and
    // jpeg_resync_to_restart.
    void restart(int& next_restart_num, int* last_dc, int& eobrun) {
        br_.bits = 0;
        if (br_.marker == 0) br_.next_marker();
        if (br_.marker == 0xD0 + next_restart_num) {
            br_.marker = 0;
        } else {
            const int desired = next_restart_num;
            for (;;) {
                const int m = br_.marker;
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
                    br_.marker = 0;
                    break;
                }
                if (action == 3) break;
                br_.next_marker();
            }
        }
        next_restart_num = (next_restart_num + 1) & 7;
        for (int i = 0; i < 4; i++) last_dc[i] = 0;
        eobrun = 0;
        if (br_.marker == 0) br_.insufficient = false;
    }

    void decode_scan() {
        br_ = BitReader{d_, n_, pos_};
        br_.fake = fake_;
        Huffman dc[4], ac[4];
        const int ns = (int)scan_.size();
        for (int i = 0; i < ns; i++) {
            const bool needs_dc = !progressive_ || (ss_ == 0 && ah_ == 0);
            const bool needs_ac = !progressive_ || ss_ != 0;
            if (needs_dc) dc[i].derive(dc_spec_[scan_dc_[i]], true);
            if (needs_ac) ac[i].derive(ac_spec_[scan_ac_[i]], false);
        }
        // per_scan_setup (jdinput.c): MCU geometry and block order.
        int mcus_per_row, mcu_rows;
        struct Blk { int ci, slot, dy, dx; };
        std::vector<Blk> blocks;
        if (ns == 1) {
            const Component& c = comps_[scan_[0]];
            mcus_per_row = c.width_in_blocks;
            mcu_rows = c.height_in_blocks;
            blocks.push_back({scan_[0], 0, 0, 0});
        } else {
            mcus_per_row = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
            mcu_rows = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
            for (int i = 0; i < ns; i++) {
                const Component& c = comps_[scan_[i]];
                for (int y = 0; y < c.v; y++)
                    for (int x = 0; x < c.h; x++) blocks.push_back({scan_[i], i, y, x});
            }
            if (blocks.size() > 10) malformed("JPEG MCU of more than 10 blocks");
        }
        int last_dc[4] = {0, 0, 0, 0};
        int eobrun = 0, next_restart_num = 0;
        int restarts_to_go = restart_interval_;
        const bool dc_refine = progressive_ && ss_ == 0 && ah_ != 0;
        for (int my = 0; my < mcu_rows; my++) {
            for (int mx = 0; mx < mcus_per_row; mx++) {
                if (restart_interval_) {
                    if (restarts_to_go == 0) {
                        restart(next_restart_num, last_dc, eobrun);
                        restarts_to_go = restart_interval_;
                    }
                    restarts_to_go--;
                }
                if (br_.insufficient && !dc_refine) continue;  // the MCU stays as it is
                for (const Blk& b : blocks) {
                    Component& c = comps_[b.ci];
                    int16_t* blk = ns == 1 ? c.block(my, mx) : c.block(my * c.v + b.dy, mx * c.h + b.dx);
                    if (!progressive_)
                        decode_sequential(blk, dc[b.slot], ac[b.slot], last_dc[b.slot]);
                    else if (ss_ == 0 && ah_ == 0)
                        decode_dc_first(blk, dc[b.slot], last_dc[b.slot]);
                    else if (ss_ == 0)
                        decode_dc_refine(blk);
                    else if (ah_ == 0)
                        decode_ac_first(blk, ac[b.slot], eobrun);
                    else
                        decode_ac_refine(blk, ac[b.slot], eobrun);
                }
            }
        }
    }

    void decode_sequential(int16_t* blk, const Huffman& dct, const Huffman& act, int& last_dc) {
        int s = br_.decode(dct);
        if (s) s = extend((int)br_.get(s), s);
        s = (int)((unsigned)s + (unsigned)last_dc);
        last_dc = s;
        blk[0] = (int16_t)s;
        for (int k = 1; k < 64; k++) {
            s = br_.decode(act);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend((int)br_.get(s), s);
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void decode_dc_first(int16_t* blk, const Huffman& dct, int& last_dc) {
        int s = br_.decode(dct);
        if (s) s = extend((int)br_.get(s), s);
        s += last_dc;
        last_dc = s;
        blk[0] = (int16_t)((unsigned)s << al_);
    }

    void decode_dc_refine(int16_t* blk) {
        if (br_.get(1)) blk[0] |= (int16_t)(1 << al_);
    }

    void decode_ac_first(int16_t* blk, const Huffman& act, int& eobrun) {
        if (eobrun > 0) {
            eobrun--;
            return;
        }
        for (int k = ss_; k <= se_; k++) {
            int s = br_.decode(act);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                s = extend((int)br_.get(s), s);
                blk[kNatural[k]] = (int16_t)((unsigned)s << al_);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += (int)br_.get(r);
                eobrun--;
                break;
            }
        }
    }

    void decode_ac_refine(int16_t* blk, const Huffman& act, int& eobrun) {
        const int p1 = 1 << al_, m1 = -1 * (1 << al_);
        int k = ss_;
        auto refine = [&](int16_t& coef) {
            if (br_.get(1) && (coef & p1) == 0) coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
        };
        if (eobrun == 0) {
            for (; k <= se_; k++) {
                int s = br_.decode(act);
                int r = s >> 4;
                s &= 15;
                if (s) {
                    s = br_.get(1) ? p1 : m1;  // a newly nonzero coefficient (size 1)
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += (int)br_.get(r);
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
        for (int ci = 0; ci < nc; ci++) {  // IDCT of every block the image shows
            Component& c = comps_[ci];
            stride[ci] = c.width_in_blocks * 8;
            planes[ci].resize((size_t)stride[ci] * c.height_in_blocks * 8);
            for (int by = 0; by < c.height_in_blocks; by++)
                for (int bx = 0; bx < c.width_in_blocks; bx++)
                    idct_islow(c.block(by, bx), c.qt, planes[ci].data() + (size_t)by * 8 * stride[ci] + bx * 8,
                               stride[ci], t.idct_limit);
        }
        std::vector<std::vector<uint8_t>> rows(nc, std::vector<uint8_t>((size_t)width_ + 16));
        std::vector<int> colsum((size_t)width_ + 2);
        const uint8_t* row[3];
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
            if (nc == 1) {
                for (int x = 0; x < width_; x++) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = row[0][x];
            } else if (rgb_) {
                for (int x = 0; x < width_; x++) {
                    dst[3 * x] = row[2][x];
                    dst[3 * x + 1] = row[1][x];
                    dst[3 * x + 2] = row[0][x];
                }
            } else {
                for (int x = 0; x < width_; x++) {
                    const int yy = row[0][x], cb = row[1][x], cr = row[2][x];
                    dst[3 * x] = t.clamp(yy + t.cb_b[cb]);
                    dst[3 * x + 1] = t.clamp(yy + (int)(((int64_t)t.cb_g[cb] + t.cr_g[cr]) >> 16));
                    dst[3 * x + 2] = t.clamp(yy + t.cr_r[cr]);
                }
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
