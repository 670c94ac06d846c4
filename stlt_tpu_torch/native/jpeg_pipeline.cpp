// Native JPEG decode + resize stage for the appearance host pipeline.
//
// The reference decodes HDF5-archived JPEG frames with PIL per DataLoader
// worker (src/modelling/datasets.py:158-177). On this framework's target
// hosts the Python decode path is the CACNF-train bottleneck, so the hot
// stage — JPEG entropy decode (libjpeg, optionally DCT-scaled like PIL's
// draft mode) followed by shorter-side-to-target resize — runs natively.
//
// The resampler reimplements Pillow's fixed-point convolution resampler
// (triangle/bilinear filter, horizontal-then-vertical uint8 passes) so the
// resize step is BIT-IDENTICAL to `PIL.Image.resize(..., BILINEAR)` — the
// pixels the released reference checkpoints were trained on
// (tests/test_native_jpeg.py asserts equality). The decode step uses the
// system libjpeg(-turbo); byte equality with PIL's bundled decoder is
// version-dependent, so the Python side treats native decode as opt-in
// (DataConfig.native_decode).
//
// C ABI (ctypes bridge: stlt_tpu/data/native_jpeg.py):
//   jp_probe(data, len, target_short, use_draft, &w, &h)   -> 0 | <0
//   jp_decode_resize(data, len, target_short, use_draft, out, w, h) -> 0 | <0
//   jp_resize_rgb(in, in_w, in_h, out, out_w, out_h)       -> 0 | <0

#include <csetjmp>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

// ---------------------------------------------------------------------------
// Pillow-compatible fixed-point resampler (bilinear / triangle filter).
// Mirrors Pillow's Resample.c 8bpc path: coefficient windows computed in
// double, quantized to 2^22 fixed point, accumulated per channel with a
// rounding bias, arithmetic-shifted back and clamped — in that exact order,
// horizontal pass first, both passes rounding to uint8.
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;  // Pillow PRECISION_BITS

inline double bilinear_filter(double x) {
    if (x < 0.0) x = -x;
    return x < 1.0 ? 1.0 - x : 0.0;
}

inline uint8_t clip8(int in) {
    int v = in >> kPrecisionBits;  // arithmetic shift, like Pillow's lookup
    if (v < 0) return 0;
    if (v > 255) return 255;
    return static_cast<uint8_t>(v);
}

struct Coeffs {
    int ksize = 0;
    std::vector<int> bounds;   // [out_size * 2]: xmin, window count
    std::vector<int32_t> kk;   // [out_size * ksize] fixed-point weights
};

Coeffs precompute_coeffs(int in_size, int out_size) {
    Coeffs c;
    double scale = static_cast<double>(in_size) / out_size;
    double filterscale = scale < 1.0 ? 1.0 : scale;
    double support = 1.0 * filterscale;  // bilinear filter support = 1.0
    c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
    c.bounds.resize(static_cast<size_t>(out_size) * 2);
    std::vector<double> prekk(static_cast<size_t>(out_size) * c.ksize, 0.0);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        double ss = 1.0 / filterscale;
        int xmin = static_cast<int>(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = static_cast<int>(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &prekk[static_cast<size_t>(xx) * c.ksize];
        int x = 0;
        for (; x < xmax; ++x) {
            double w = bilinear_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; ++x) {
            if (ww != 0.0) k[x] /= ww;
        }
        c.bounds[static_cast<size_t>(xx) * 2] = xmin;
        c.bounds[static_cast<size_t>(xx) * 2 + 1] = xmax;
    }
    c.kk.resize(prekk.size());
    for (size_t i = 0; i < prekk.size(); ++i) {
        double v = prekk[i] * (1 << kPrecisionBits);
        c.kk[i] = static_cast<int32_t>(v < 0 ? v - 0.5 : v + 0.5);
    }
    return c;
}

// in: [in_h][in_w][3] -> out: [in_h][out_w][3]
void resample_horizontal(const uint8_t* in, int in_w, int in_h,
                         uint8_t* out, int out_w, const Coeffs& c) {
    for (int y = 0; y < in_h; ++y) {
        const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
        uint8_t* orow = out + static_cast<size_t>(y) * out_w * 3;
        for (int xx = 0; xx < out_w; ++xx) {
            int xmin = c.bounds[static_cast<size_t>(xx) * 2];
            int count = c.bounds[static_cast<size_t>(xx) * 2 + 1];
            const int32_t* k = &c.kk[static_cast<size_t>(xx) * c.ksize];
            int s0 = 1 << (kPrecisionBits - 1);
            int s1 = s0, s2 = s0;
            const uint8_t* p = row + static_cast<size_t>(xmin) * 3;
            for (int x = 0; x < count; ++x, p += 3) {
                s0 += p[0] * k[x];
                s1 += p[1] * k[x];
                s2 += p[2] * k[x];
            }
            orow[xx * 3] = clip8(s0);
            orow[xx * 3 + 1] = clip8(s1);
            orow[xx * 3 + 2] = clip8(s2);
        }
    }
}

// in: [in_h][w][3] -> out: [out_h][w][3]
void resample_vertical(const uint8_t* in, int w, int in_h,
                       uint8_t* out, int out_h, const Coeffs& c) {
    for (int yy = 0; yy < out_h; ++yy) {
        int ymin = c.bounds[static_cast<size_t>(yy) * 2];
        int count = c.bounds[static_cast<size_t>(yy) * 2 + 1];
        const int32_t* k = &c.kk[static_cast<size_t>(yy) * c.ksize];
        uint8_t* orow = out + static_cast<size_t>(yy) * w * 3;
        for (int xc = 0; xc < w * 3; ++xc) {
            int s = 1 << (kPrecisionBits - 1);
            const uint8_t* p = in + static_cast<size_t>(ymin) * w * 3 + xc;
            for (int y = 0; y < count; ++y, p += static_cast<size_t>(w) * 3) {
                s += *p * k[y];
            }
            orow[xc] = clip8(s);
        }
    }
}

int resize_rgb(const uint8_t* in, int in_w, int in_h,
               uint8_t* out, int out_w, int out_h) {
    if (in_w <= 0 || in_h <= 0 || out_w <= 0 || out_h <= 0) return -1;
    if (in_w == out_w && in_h == out_h) {
        std::memcpy(out, in, static_cast<size_t>(in_w) * in_h * 3);
        return 0;
    }
    if (in_w == out_w) {
        Coeffs cv = precompute_coeffs(in_h, out_h);
        resample_vertical(in, in_w, in_h, out, out_h, cv);
        return 0;
    }
    Coeffs ch = precompute_coeffs(in_w, out_w);
    std::vector<uint8_t> tmp(static_cast<size_t>(in_h) * out_w * 3);
    resample_horizontal(in, in_w, in_h, tmp.data(), out_w, ch);
    if (in_h == out_h) {
        std::memcpy(out, tmp.data(), tmp.size());
        return 0;
    }
    Coeffs cv = precompute_coeffs(in_h, out_h);
    resample_vertical(tmp.data(), out_w, in_h, out, out_h, cv);
    return 0;
}

// ---------------------------------------------------------------------------
// libjpeg decode (setjmp error recovery, optional PIL-draft DCT scaling).
// ---------------------------------------------------------------------------

struct ErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
    ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

void silent_output(j_common_ptr) {}

// PIL JpegImageFile.draft: scale = min(W // tw, H // th), clamped to the
// largest of {8, 4, 2, 1} it reaches; output dims are ceil-divided.
int draft_denominator(int w, int h, int target) {
    int scale_w = w / target;
    int scale_h = h / target;
    int scale = scale_w < scale_h ? scale_w : scale_h;
    for (int s : {8, 4, 2, 1}) {
        if (scale >= s) return s;
    }
    return 1;
}

struct Decoded {
    std::vector<uint8_t> rgb;  // [h][w][3]
    int w = 0;
    int h = 0;
};

// Returns 0 on success, <0 on decode failure.
int decode_rgb(const uint8_t* data, size_t len, int target_short, int use_draft,
               Decoded* out) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.output_message = silent_output;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    cinfo.out_color_space = JCS_RGB;
    cinfo.scale_num = 1;
    cinfo.scale_denom =
        use_draft ? draft_denominator(static_cast<int>(cinfo.image_width),
                                      static_cast<int>(cinfo.image_height),
                                      target_short)
                  : 1;
    jpeg_start_decompress(&cinfo);
    out->w = static_cast<int>(cinfo.output_width);
    out->h = static_cast<int>(cinfo.output_height);
    if (cinfo.output_components != 3) {
        // JCS_RGB output always has 3 components; anything else means the
        // source color space could not be converted.
        jpeg_destroy_decompress(&cinfo);
        return -3;
    }
    out->rgb.resize(static_cast<size_t>(out->w) * out->h * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        JSAMPROW row =
            out->rgb.data() + static_cast<size_t>(cinfo.output_scanline) * out->w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// transforms.resize_shorter_side: shorter side -> target, longer side
// TRUNCATES (torchvision Resize(int) semantics the checkpoints saw).
void resized_dims(int w, int h, int target, int* out_w, int* out_h) {
    if (w <= h) {
        *out_w = target;
        int nh = static_cast<int>(static_cast<double>(target) * h / w);
        *out_h = nh > 1 ? nh : 1;
    } else {
        int nw = static_cast<int>(static_cast<double>(target) * w / h);
        *out_w = nw > 1 ? nw : 1;
        *out_h = target;
    }
}

// ---------------------------------------------------------------------------
// Pillow-compatible color jitter (VideoColorJitter, transforms.py — the
// reference's per-clip-constant augmentation, src/utils/data_utils.py:110-137).
// Each op replicates the exact integer/float semantics of PIL's ImageEnhance
// blend, L conversion (ITU-R 601-2 fixed point) and HSV round-trip — pinned
// empirically and asserted bit-identical in tests/test_native_jpeg.py.
// ---------------------------------------------------------------------------

// ITU-R 601-2 luma, Pillow's L24 macro: trunc((r*19595 + g*38470 + b*7471
// + 0x8000) >> 16).
inline uint8_t luma(const uint8_t* p) {
    return static_cast<uint8_t>(
        (p[0] * 19595u + p[1] * 38470u + p[2] * 7471u + 0x8000u) >> 16);
}

// PIL Image.blend / ImagingBlend: float interpolation, clip, trunc.
inline uint8_t blend1(int in1, int in2, float alpha) {
    float temp = static_cast<float>(in1 + alpha * (in2 - in1));
    if (temp <= 0.0f) return 0;
    if (temp >= 255.0f) return 255;
    return static_cast<uint8_t>(temp);
}

void jitter_brightness(uint8_t* buf, size_t n3, float f) {
    for (size_t i = 0; i < n3; ++i) buf[i] = blend1(0, buf[i], f);
}

void jitter_contrast(uint8_t* buf, size_t n, float f) {
    // degenerate = solid gray at int(mean(L) + 0.5), PIL ImageEnhance.Contrast.
    uint64_t sum = 0;
    for (size_t i = 0; i < n; ++i) sum += luma(buf + i * 3);
    int mean = static_cast<int>(static_cast<double>(sum) / n + 0.5);
    for (size_t i = 0; i < n * 3; ++i) buf[i] = blend1(mean, buf[i], f);
}

void jitter_saturation(uint8_t* buf, size_t n, float f) {
    // degenerate = L(img) replicated across channels, PIL ImageEnhance.Color.
    for (size_t i = 0; i < n; ++i) {
        uint8_t* p = buf + i * 3;
        int l = luma(p);
        p[0] = blend1(l, p[0], f);
        p[1] = blend1(l, p[1], f);
        p[2] = blend1(l, p[2], f);
    }
}

// rgb2hsv tables. ratio[n][d] = (float)n / (float)d — every division Pillow's
// rgb2hsv_row performs has both operands in 0..255, so the exact float
// quotients fit a 256 KB table; sbyte[cr][maxc] likewise caches the final
// trunc((cr/maxc) * 255.0) S byte.
struct RgbLuts {
    float ratio[256][256];
    uint8_t sbyte[256][256];
    RgbLuts() {
        for (int n = 0; n < 256; ++n) {
            ratio[n][0] = 0.0f;  // unused (d = cr or maxc is >= 1 when hit)
            for (int d = 1; d < 256; ++d) {
                float q = static_cast<float>(n) / static_cast<float>(d);
                ratio[n][d] = q;
                sbyte[n][d] = static_cast<uint8_t>(q * 255.0);
            }
        }
    }
};
const RgbLuts kRgb;

// Pillow rgb2hsv_row — branch-exact float/double promotions matter for the
// trailing trunc-to-uint8.
inline void rgb2hsv(const uint8_t* in, uint8_t* out) {
    uint8_t r = in[0], g = in[1], b = in[2];
    uint8_t maxc = r > g ? (r > b ? r : b) : (g > b ? g : b);
    uint8_t minc = r < g ? (r < b ? r : b) : (g < b ? g : b);
    out[2] = maxc;
    if (minc == maxc) {
        out[0] = 0;
        out[1] = 0;
        return;
    }
    int cr = maxc - minc;
    float h;
    if (r == maxc) {
        // float arithmetic (Pillow: bc - gc with float operands)
        h = kRgb.ratio[maxc - b][cr] - kRgb.ratio[maxc - g][cr];
    } else if (g == maxc) {
        // double arithmetic, narrowed (as in Pillow)
        h = 2.0 + kRgb.ratio[maxc - r][cr] - kRgb.ratio[maxc - b][cr];
    } else {
        h = 4.0 + kRgb.ratio[maxc - g][cr] - kRgb.ratio[maxc - r][cr];
    }
    // Pillow: h = fmod(h/6.0 + 1.0, 1.0). Here h/6+1 ∈ (0.833, 1.833), where
    // fmod reduces to a conditional exact subtract-1 — same bits, no libm.
    double hd = h / 6.0 + 1.0;
    if (hd >= 1.0) hd -= 1.0;
    h = static_cast<float>(hd);
    out[0] = static_cast<uint8_t>(h * 255.0);
    out[1] = kRgb.sbyte[cr][maxc];
}

// Hue tables: parameter-free per-byte precomputations for hsv2rgb. The mixed
// float/double promotions mirror Pillow's hsv2rgb_row exactly — `h * 6.0 /
// 255.0` is DOUBLE math narrowed to a float fraction, `s / 255.0` likewise;
// getting these widths wrong flips round-boundary pixels by one.
struct HueLuts {
    int sector[256];       // floor(h * 6.0 / 255.0), double math
    float frac[256];       // float(h*6.0/255.0 - sector)
    float sat[256];        // float(s / 255.0)
    uint8_t pbyte[256][256];  // round(v * (1.0 - s/255)) — hsv2rgb's p term
    HueLuts() {
        for (int h = 0; h < 256; ++h) {
            double hf = static_cast<double>(h) * 6.0 / 255.0;
            sector[h] = static_cast<int>(std::floor(hf));
            frac[h] = static_cast<float>(hf - sector[h]);
        }
        for (int s = 0; s < 256; ++s) {
            sat[s] = static_cast<float>(static_cast<double>(s) / 255.0);
            for (int v = 0; v < 256; ++v) {
                int p = static_cast<int>(
                    v * (1.0 - static_cast<double>(sat[s])) + 0.5);
                pbyte[v][s] = p < 0 ? 0 : (p > 255 ? 255 : p);
            }
        }
    }
};
const HueLuts kHue;

// Pillow hsv2rgb_row (colorsys semantics). p/q/t round half-away-from-zero;
// values are non-negative so trunc(x + 0.5) matches round(). Note q's fs*f
// is a FLOAT product while t's fs*(1.0-f) is double — as in the original.
inline void hsv2rgb(const uint8_t* in, uint8_t* out) {
    uint8_t h = in[0], s = in[1], v = in[2];
    if (s == 0) {
        out[0] = out[1] = out[2] = v;
        return;
    }
    int i = kHue.sector[h];
    float f = kHue.frac[h];
    float fs = kHue.sat[s];
    double vd = v;
    auto clip = [](int x) -> uint8_t {
        return x < 0 ? 0 : (x > 255 ? 255 : static_cast<uint8_t>(x));
    };
    uint8_t p = kHue.pbyte[v][s];
    uint8_t q = clip(static_cast<int>(vd * (1.0 - static_cast<double>(fs * f)) + 0.5));
    uint8_t t = clip(static_cast<int>(
        vd * (1.0 - static_cast<double>(fs) * (1.0 - static_cast<double>(f))) + 0.5));
    // Branchless sector dispatch (random hues defeat the predictor): index
    // into {v, q, t, p} per channel instead of a 6-way switch.
    static const uint8_t kPerm[6][3] = {
        {0, 2, 3}, {1, 0, 3}, {3, 0, 2}, {3, 1, 0}, {2, 3, 0}, {0, 3, 1}};
    const uint8_t vals[4] = {v, q, t, p};
    const uint8_t* pm = kPerm[i % 6];
    out[0] = vals[pm[0]];
    out[1] = vals[pm[1]];
    out[2] = vals[pm[2]];
}

// transforms.adjust_hue: HSV round-trip with uint8-wrapping H shift.
void jitter_hue(uint8_t* buf, size_t n, int shift) {
    uint8_t hsv[3];
    for (size_t i = 0; i < n; ++i) {
        uint8_t* p = buf + i * 3;
        rgb2hsv(p, hsv);
        hsv[0] = static_cast<uint8_t>(hsv[0] + shift);  // wraps mod 256
        hsv2rgb(hsv, p);
    }
}

}  // namespace

extern "C" {

// In-place VideoColorJitter on a uint8 RGB HWC buffer. `order` holds the
// four op ids (0=brightness, 1=contrast, 2=saturation, 3=hue) in apply
// order; `hue_shift` is the precomputed int(round(hue * 255)) (Python
// rounding semantics), applied only when apply_hue != 0.
int jp_jitter_rgb(uint8_t* buf, int w, int h, const int* order,
                  float brightness, float contrast, float saturation,
                  int hue_shift, int apply_hue) {
    if (w <= 0 || h <= 0) return -1;
    size_t n = static_cast<size_t>(w) * h;
    for (int k = 0; k < 4; ++k) {
        switch (order[k]) {
            case 0: jitter_brightness(buf, n * 3, brightness); break;
            case 1: jitter_contrast(buf, n, contrast); break;
            case 2: jitter_saturation(buf, n, saturation); break;
            case 3:
                if (apply_hue) jitter_hue(buf, n, hue_shift);
                break;
            default: return -2;
        }
    }
    return 0;
}

// Header-only parse: reports the post-resize dims for this JPEG so the
// caller can allocate the exact output buffer.
int jp_probe(const uint8_t* data, size_t len, int target_short, int use_draft,
             int* out_w, int* out_h) {
    jpeg_decompress_struct cinfo;
    ErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = error_exit;
    jerr.pub.output_message = silent_output;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
                 static_cast<unsigned long>(len));
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -2;
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom =
        use_draft ? draft_denominator(static_cast<int>(cinfo.image_width),
                                      static_cast<int>(cinfo.image_height),
                                      target_short)
                  : 1;
    jpeg_calc_output_dimensions(&cinfo);
    resized_dims(static_cast<int>(cinfo.output_width),
                 static_cast<int>(cinfo.output_height), target_short, out_w, out_h);
    jpeg_destroy_decompress(&cinfo);
    return 0;
}

// Decode (optionally DCT-scaled) and resize shorter-side-to-target into
// `out`, which must hold exactly out_w * out_h * 3 bytes as reported by
// jp_probe with the same arguments.
int jp_decode_resize(const uint8_t* data, size_t len, int target_short,
                     int use_draft, uint8_t* out, int out_w, int out_h) {
    Decoded dec;
    int rc = decode_rgb(data, len, target_short, use_draft, &dec);
    if (rc != 0) return rc;
    int want_w = 0, want_h = 0;
    resized_dims(dec.w, dec.h, target_short, &want_w, &want_h);
    if (want_w != out_w || want_h != out_h) return -4;  // probe/decode skew
    return resize_rgb(dec.rgb.data(), dec.w, dec.h, out, out_w, out_h);
}

// Pillow-bit-identical bilinear resample of a raw RGB8 HWC buffer
// (exposed for the parity test and reusable by other host stages).
int jp_resize_rgb(const uint8_t* in, int in_w, int in_h, uint8_t* out,
                  int out_w, int out_h) {
    return resize_rgb(in, in_w, in_h, out, out_w, out_h);
}

}  // extern "C"
