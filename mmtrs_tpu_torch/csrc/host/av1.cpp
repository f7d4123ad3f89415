// The port's own AV1 decoder for AVIF still pictures: one intra frame,
// 8-bit, to its Y, U and V planes, as the AV1 specification decodes it (the
// decoding is exact, so the planes equal dav1d's). C++ with the standard
// library alone; it links nothing.
//
// What it decodes:
// - OBUs: temporal delimiter, sequence header (reduced and full
//   still-picture forms), frame header, OBU_FRAME and tile groups; padding
//   and metadata skipped;
// - tiles of uniform or explicit spacing, tile-size bytes, 64² and 128²
//   superblocks;
// - the symbol decoder with CDF adaptation and disable_cdf_update;
// - the intra block syntax: partitions, intra segmentation with its
//   spatial prediction, delta q and delta lf (multi as well), skip, y and uv
//   modes with angle deltas, CfL alphas, filter intra, tx depth, the intra
//   tx sets (reduced too), the coefficients of every tx size with the
//   zero-out past 32;
// - palette: the colour cache of the above (same 64-row superblock row)
//   and left blocks, the delta-coded colours, the colour map in wavefront
//   order with its colour-order contexts, extended past the frame's edge;
// - intraBC: the DV stack of an intra frame (find_mv_stack's spatial scan,
//   sorting and clamping, the default DV), read_mv at whole samples, dav1d's
//   clip of a DV into the tile's decoded region, the copy with the BILINEAR
//   filter, the var-tx tree (txfm_split) and the inter tx sets;
// - dequantisation with per-plane deltas, and lossless (WHT);
// - the inverse transforms (DCT 4-64, ADST and FLIPADST 4/8/16, identity)
//   in the specification's integer steps, with its clamps;
// - intra prediction: DC, V, H, directional with the edge filter and
//   upsampling, smooth, Paeth, CfL, filter intra and palette, availability
//   stopping at tile edges;
// - the deblocking filter (levels by segment, mode delta and delta lf; the
//   4-, 6-, 8- and 14-tap filters);
// - CDEF: the per-8×8 direction search and variance, primary and secondary
//   taps with their damping, the 4:2:2 direction map, skipped 8×8s and
//   64×64s, from a copy of the deblocked frame;
// - loop restoration: Wiener (7 and 5 taps) and self-guided (the r = 1 and
//   r = 2 box filters and the projection) units, switchable, over stripes
//   of 64 rows offset by 8 that read the deblocked rows at their edges;
// - quantiser matrices (libaom's iwt_matrix_ref, in its column-by-column
//   coefficient order; the 64-point sizes take the 32-point ones; the
//   identity and 1D types and lossless segments none);
// - film grain, as dav1d applies it to its output picture (the LFSR and
//   Gaussian_Sequence, the luma and chroma auto-regression, the scaling
//   LUTs, 32×32 blocks of random offsets with the overlap blend, the clip
//   to restricted range);
// - 4:2:0, 4:2:2, 4:4:4 and 4:0:0.
//
// Refused by name: superres, 10/12 bits, inter frames (nothing here
// writes them in a still picture or a sequence's first sample).
//
// Besides, libavif's avifImageScale (libyuv's ScalePlane with kFilterBox,
// its x86 rows) for a frame of another size than its item's ispe.
//
// Entry points (ctypes, see mmtrs_tpu_torch/utils/avif.py):
//   int mmtrs_av1_decode(const void* buf, long long n, long long max_pixels,
//                        void* out, void* dims, void* msg);
//     buf: the OBUs of one AV1 image item (its av1C configOBUs first, if
//     any). out <- a malloc'd buffer: the Y plane, then U and V (each at its
//     subsampled size, rows packed). dims: int[16] <- width, height, subx,
//     suby, planes, bit depth, colour primaries, transfer, matrix, range,
//     the tools mask's low and high 32 bits, the film grain parameters'
//     kinds (bits: grain, luma points, chroma points, chroma scaling from
//     luma, overlap, restricted range, the AR lag at 6-7, a grain scale
//     shift at 8), the frame header's length in bits. Returns 0, or a
//     status with msg
//     (char[256]): 2 broken, 3 truncated, 5 over max_pixels, 6 refused.
//   int mmtrs_av1_free(void* p);
//   int mmtrs_avif_scale_plane(const void* src, int sw, int sh, void* dst,
//                              int dw, int dh);
//     One plane (rows packed, one readable row past its end) scaled to
//     dw × dh; 2 where libavif refuses the scale.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared av1.cpp (mmtrs_tpu_torch/_build.py)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "av1_tables.h"

namespace {

constexpr int ST_BROKEN = 2, ST_TRUNCATED = 3, ST_BOMB = 5, ST_REFUSED = 6;

struct Fail {
    int status;
    std::string what;
};

[[noreturn]] void fail(int status, const std::string& what) { throw Fail{status, what}; }
[[noreturn]] void broken(const std::string& what) { fail(ST_BROKEN, "corrupt AV1: " + what); }
[[noreturn]] void refuse(const std::string& tool) {
    fail(ST_REFUSED, "AVIF whose AV1 uses " + tool + " is not decoded by the port's codec");
}

// the tools a decode used, for the tests' coverage (dims[10] the low 32
// bits, dims[11] the high)
enum : uint64_t {
    TOOL_DC = 1u << 0, TOOL_VH = 1u << 1, TOOL_DIRECTIONAL = 1u << 2, TOOL_SMOOTH = 1u << 3, TOOL_PAETH = 1u << 4,
    TOOL_CFL = 1u << 5, TOOL_FILTER_INTRA = 1u << 6, TOOL_ANGLE_DELTA = 1u << 7, TOOL_EDGE_UPSAMPLE = 1u << 8,
    TOOL_TX4 = 1u << 9, TOOL_TX8 = 1u << 10, TOOL_TX16 = 1u << 11, TOOL_TX32 = 1u << 12, TOOL_TX64 = 1u << 13,
    TOOL_TX_RECT = 1u << 14, TOOL_DCT = 1u << 15, TOOL_ADST = 1u << 16, TOOL_IDTX = 1u << 17, TOOL_TX_1D = 1u << 18,
    TOOL_LOSSLESS = 1u << 19, TOOL_TILES = 1u << 20, TOOL_SEGMENTATION = 1u << 21, TOOL_DELTA_Q = 1u << 22,
    TOOL_DELTA_LF = 1u << 23, TOOL_SB128 = 1u << 24, TOOL_DEBLOCK = 1u << 25, TOOL_420 = 1u << 26,
    TOOL_422 = 1u << 27, TOOL_444 = 1u << 28, TOOL_400 = 1u << 29, TOOL_EDGE_FILTER = 1u << 30,
    TOOL_DELTA_LF_MULTI = 1u << 31, TOOL_PALETTE_Y = 1ull << 32, TOOL_PALETTE_UV = 1ull << 33,
    TOOL_PALETTE_CACHE = 1ull << 34, TOOL_INTRABC = 1ull << 35, TOOL_CDEF_Y = 1ull << 36, TOOL_CDEF_UV = 1ull << 37,
    TOOL_WIENER = 1ull << 38, TOOL_SGRPROJ = 1ull << 39, TOOL_SWITCHABLE_LR = 1ull << 40, TOOL_QM = 1ull << 41,
    TOOL_FILM_GRAIN = 1ull << 42,
};

inline int clip3(int lo, int hi, int x) { return x < lo ? lo : (x > hi ? hi : x); }
inline int round2(int64_t x, int n) { return n ? static_cast<int>((x + (int64_t(1) << (n - 1))) >> n) : static_cast<int>(x); }
inline int round2signed(int x, int n) { return x >= 0 ? round2(x, n) : -round2(-x, n); }
inline int floor_log2(uint32_t x) { int s = 0; while (x > 1) { x >>= 1; ++s; } return s; }

// ---------------------------------------------------------------------------
// Block and transform sizes (the specification's enumerations)
// ---------------------------------------------------------------------------

enum { BLOCK_4X4, BLOCK_4X8, BLOCK_8X4, BLOCK_8X8, BLOCK_8X16, BLOCK_16X8, BLOCK_16X16, BLOCK_16X32, BLOCK_32X16,
       BLOCK_32X32, BLOCK_32X64, BLOCK_64X32, BLOCK_64X64, BLOCK_64X128, BLOCK_128X64, BLOCK_128X128, BLOCK_4X16,
       BLOCK_16X4, BLOCK_8X32, BLOCK_32X8, BLOCK_16X64, BLOCK_64X16, BLOCK_INVALID };
const int kBlockW[22] = {4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64, 128, 128, 4, 16, 8, 32, 16, 64};
const int kBlockH[22] = {4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 64, 32, 64, 128, 64, 128, 16, 4, 32, 8, 64, 16};

int block_of(int w, int h) {
    for (int b = 0; b < 22; ++b)
        if (kBlockW[b] == w && kBlockH[b] == h) return b;
    return BLOCK_INVALID;
}

enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16,
       TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
const int kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
const int kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
const int kTxSplit[19] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16,
                          TX_16X16, TX_32X32, TX_32X32, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16};
const int kTxRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};

int tx_of(int w, int h) {
    for (int t = 0; t < 19; ++t)
        if (kTxW[t] == w && kTxH[t] == h) return t;
    return -1;
}
int tx_sqr(int t) { return tx_of(std::min(kTxW[t], kTxH[t]), std::min(kTxW[t], kTxH[t])); }
int tx_sqr_up(int t) { return tx_of(std::max(kTxW[t], kTxH[t]), std::max(kTxW[t], kTxH[t])); }
int max_tx_rect(int bsize) { return tx_of(std::min(kBlockW[bsize], 64), std::min(kBlockH[bsize], 64)); }
int log2i(int v) { return floor_log2(static_cast<uint32_t>(v)); }

// intra modes
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
       SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };
const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
bool directional(int m) { return m >= V_PRED && m <= D67_PRED; }

// transform types
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST,
       FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
enum { T1_DCT, T1_ADST, T1_FLIPADST, T1_IDTX };
// the 1D transforms of each 2D type: vertical (columns), horizontal (rows)
const int kVtx[16] = {T1_DCT, T1_ADST, T1_DCT, T1_ADST, T1_FLIPADST, T1_DCT, T1_FLIPADST, T1_ADST, T1_FLIPADST,
                      T1_IDTX, T1_DCT, T1_IDTX, T1_ADST, T1_IDTX, T1_FLIPADST, T1_IDTX};
const int kHtx[16] = {T1_DCT, T1_DCT, T1_ADST, T1_ADST, T1_DCT, T1_FLIPADST, T1_FLIPADST, T1_FLIPADST, T1_ADST,
                      T1_IDTX, T1_IDTX, T1_DCT, T1_IDTX, T1_ADST, T1_IDTX, T1_FLIPADST};
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
int tx_class(int t) {
    if (t == V_DCT || t == V_ADST || t == V_FLIPADST) return TX_CLASS_VERT;
    if (t == H_DCT || t == H_ADST || t == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
}
const int kTxIntraInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int kTxIntraInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
const int kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST, DCT_ADST,
                             ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2 };
enum { TX_SET_INTER_1 = 1, TX_SET_INTER_2, TX_SET_INTER_3 };
bool in_inter_set(int set, int t) {
    if (set == TX_SET_DCTONLY) return t == DCT_DCT;
    if (set == TX_SET_INTER_3) return t == IDTX || t == DCT_DCT;
    if (set == TX_SET_INTER_2) return t != V_ADST && t != H_ADST && t != V_FLIPADST && t != H_FLIPADST;
    return true;
}
bool in_intra_set(int set, int t) {
    if (set == TX_SET_DCTONLY) return t == DCT_DCT;
    if (set == TX_SET_INTRA_2) return t == IDTX || t == DCT_DCT || t == ADST_ADST || t == ADST_DCT || t == DCT_ADST;
    return t == IDTX || t == DCT_DCT || t == V_DCT || t == H_DCT || t == ADST_ADST || t == ADST_DCT || t == DCT_ADST;
}

// ---------------------------------------------------------------------------
// Bit reader for the OBU headers (the specification's f(n), uvlc, leb128...)
// ---------------------------------------------------------------------------

struct Bits {
    const uint8_t* d;
    size_t n;
    size_t pos = 0;  // in bits
    Bits(const uint8_t* data, size_t size) : d(data), n(size) {}
    uint32_t f(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            if (pos >= n * 8) fail(ST_TRUNCATED, "truncated AV1: a header ends early");
            v = (v << 1) | ((d[pos >> 3] >> (7 - (pos & 7))) & 1);
            ++pos;
        }
        return v;
    }
    int su(int k) {
        int v = static_cast<int>(f(k));
        const int sign = 1 << (k - 1);
        return (v & sign) ? v - 2 * sign : v;
    }
    uint32_t uvlc() {
        int zeros = 0;
        while (!f(1)) {
            if (++zeros >= 32) return UINT32_MAX;
        }
        return zeros ? f(zeros) + ((1u << zeros) - 1) : 0;
    }
    uint32_t ns(uint32_t nv) {
        int w = 0;
        for (uint32_t x = nv; x; x >>= 1) ++w;
        const uint32_t m = (1u << w) - nv;
        const uint32_t v = f(w - 1);
        if (v < m) return v;
        return (v << 1) - m + f(1);
    }
    void byte_align() { pos = (pos + 7) & ~size_t(7); }
};

uint64_t leb128(const uint8_t* d, size_t n, size_t* at) {
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
        if (*at >= n) fail(ST_TRUNCATED, "truncated AV1: an OBU size ends early");
        const uint8_t b = d[(*at)++];
        v |= static_cast<uint64_t>(b & 0x7f) << (i * 7);
        if (!(b & 0x80)) return v;
    }
    broken("an OBU size of more than 8 bytes");
}

// ---------------------------------------------------------------------------
// Sequence and frame headers
// ---------------------------------------------------------------------------

struct Sequence {
    bool seen = false;
    int profile = 0, still = 0, reduced = 0;
    int timing_info = 0, decoder_model_info = 0, equal_picture_interval = 0;
    int buffer_delay_length = 0, buffer_removal_time_length = 0, frame_presentation_time_length = 0;
    int op_count = 1;
    int op_idc[32] = {};
    int decoder_model_present[32] = {};
    int frame_width_bits = 0, frame_height_bits = 0, max_w = 0, max_h = 0;
    int frame_id_numbers = 0, delta_frame_id_length = 0, additional_frame_id_length = 0;
    int sb128 = 0, enable_filter_intra = 0, enable_intra_edge_filter = 0;
    int force_screen_content_tools = 2, force_integer_mv = 2, order_hint_bits = 0, enable_order_hint = 0;
    int enable_superres = 0, enable_cdef = 0, enable_restoration = 0;
    int bit_depth = 8, mono = 0, subx = 1, suby = 1, cp = 2, tc = 2, mc = 2, range = 0, sep_uv_dq = 0;
    int film_grain = 0;
};

void read_sequence(Bits& b, Sequence& s) {
    s.profile = b.f(3);
    if (s.profile > 2) broken("a sequence header of an unknown profile");
    s.still = b.f(1);
    s.reduced = b.f(1);
    if (s.reduced && !s.still) broken("a reduced sequence header of a moving picture");
    if (s.reduced) {
        b.f(5);  // seq_level_idx
        s.op_count = 1;
    } else {
        s.timing_info = b.f(1);
        if (s.timing_info) {
            b.f(32);
            b.f(32);
            s.equal_picture_interval = b.f(1);
            if (s.equal_picture_interval) b.uvlc();
            s.decoder_model_info = b.f(1);
            if (s.decoder_model_info) {
                s.buffer_delay_length = b.f(5) + 1;
                b.f(32);
                s.buffer_removal_time_length = b.f(5) + 1;
                s.frame_presentation_time_length = b.f(5) + 1;
            }
        }
        const int initial_display_delay = b.f(1);
        s.op_count = b.f(5) + 1;
        for (int i = 0; i < s.op_count; ++i) {
            s.op_idc[i] = b.f(12);
            // dav1d: an operating point names both its temporal and spatial layers
            if (s.op_idc[i] && (!(s.op_idc[i] & 0xff) || !(s.op_idc[i] & 0xf00)))
                broken("an operating point of no temporal or spatial layer");
            const int level = b.f(5);
            if (level > 7) b.f(1);
            if (s.decoder_model_info) {
                s.decoder_model_present[i] = b.f(1);
                if (s.decoder_model_present[i]) {
                    b.f(s.buffer_delay_length);
                    b.f(s.buffer_delay_length);
                    b.f(1);
                }
            }
            if (initial_display_delay && b.f(1)) b.f(4);
        }
    }
    s.frame_width_bits = b.f(4) + 1;
    s.frame_height_bits = b.f(4) + 1;
    s.max_w = b.f(s.frame_width_bits) + 1;
    s.max_h = b.f(s.frame_height_bits) + 1;
    if (!s.reduced) s.frame_id_numbers = b.f(1);
    if (s.frame_id_numbers) {
        s.delta_frame_id_length = b.f(4) + 2;
        s.additional_frame_id_length = b.f(3) + 1;
    }
    s.sb128 = b.f(1);
    s.enable_filter_intra = b.f(1);
    s.enable_intra_edge_filter = b.f(1);
    if (s.reduced) {
        s.force_screen_content_tools = 2;
        s.force_integer_mv = 2;
        s.order_hint_bits = 0;
    } else {
        b.f(1);  // enable_interintra_compound
        b.f(1);  // enable_masked_compound
        b.f(1);  // enable_warped_motion
        b.f(1);  // enable_dual_filter
        s.enable_order_hint = b.f(1);
        if (s.enable_order_hint) {
            b.f(1);  // enable_jnt_comp
            b.f(1);  // enable_ref_frame_mvs
        }
        if (b.f(1)) s.force_screen_content_tools = 2;
        else s.force_screen_content_tools = b.f(1);
        if (s.force_screen_content_tools > 0) {
            if (b.f(1)) s.force_integer_mv = 2;
            else s.force_integer_mv = b.f(1);
        } else {
            s.force_integer_mv = 2;
        }
        if (s.enable_order_hint) s.order_hint_bits = b.f(3) + 1;
    }
    s.enable_superres = b.f(1);
    s.enable_cdef = b.f(1);
    s.enable_restoration = b.f(1);
    // color_config
    const int high_bitdepth = b.f(1);
    if (s.profile == 2 && high_bitdepth) s.bit_depth = b.f(1) ? 12 : 10;
    else s.bit_depth = high_bitdepth ? 10 : 8;
    s.mono = s.profile == 1 ? 0 : b.f(1);
    if (b.f(1)) {
        s.cp = b.f(8);
        s.tc = b.f(8);
        s.mc = b.f(8);
    } else {
        s.cp = s.tc = s.mc = 2;
    }
    if (s.mono) {
        s.range = b.f(1);
        s.subx = s.suby = 1;
        s.sep_uv_dq = 0;
    } else {
        if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
            s.range = 1;
            s.subx = s.suby = 0;
        } else {
            s.range = b.f(1);
            if (s.profile == 0) {
                s.subx = s.suby = 1;
            } else if (s.profile == 1) {
                s.subx = s.suby = 0;
            } else if (s.bit_depth == 12) {
                s.subx = b.f(1);
                s.suby = s.subx ? b.f(1) : 0;
            } else {
                s.subx = 1;
                s.suby = 0;
            }
            if (s.subx && s.suby) b.f(2);  // chroma_sample_position
        }
        s.sep_uv_dq = b.f(1);
    }
    s.film_grain = b.f(1);
    s.seen = true;
}

enum { RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ, RESTORE_SWITCHABLE };

constexpr int MAX_SEGMENTS = 8, SEG_LVL_MAX = 8, SEG_LVL_ALT_Q = 0, SEG_LVL_ALT_LF_Y_V = 1, SEG_LVL_REF_FRAME = 5,
              SEG_LVL_SKIP = 6;
const int kSegBits[8] = {8, 6, 6, 6, 6, 3, 0, 0};
const int kSegSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
const int kSegMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};

struct Frame {
    int width = 0, height = 0, mi_cols = 0, mi_rows = 0;
    int show_frame = 1, showable = 0, error_resilient = 0, disable_cdf_update = 0;
    int allow_screen_content = 0, allow_intrabc = 0;
    int tile_cols = 1, tile_rows = 1, tile_cols_log2 = 0, tile_rows_log2 = 0, tile_size_bytes = 4;
    std::vector<int> col_starts, row_starts;
    int base_q = 0, dq_ydc = 0, dq_udc = 0, dq_uac = 0, dq_vdc = 0, dq_vac = 0, using_qm = 0;
    int qm_level[3] = {15, 15, 15};  // qm_y, qm_u, qm_v
    int seg_enabled = 0, seg_pre_skip = 0, last_active_seg = 0;
    int feature_enabled[8][8] = {}, feature_data[8][8] = {};
    int delta_q_present = 0, delta_q_res = 0, delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;
    bool lossless[8] = {};
    bool coded_lossless = false;
    int lf_level[4] = {}, lf_sharpness = 0, lf_delta_enabled = 0;
    int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
    int lf_mode_deltas[2] = {0, 0};
    int cdef_bits = 0, cdef_damping = 3;
    int cdef_y_pri[8] = {}, cdef_y_sec[8] = {}, cdef_uv_pri[8] = {}, cdef_uv_sec[8] = {};
    int lr_type[3] = {}, lr_size[3] = {};  // FrameRestorationType (RESTORE_*), LoopRestorationSize
    int tx_mode_select = 0, reduced_tx_set = 0;
    // film_grain_params (5.9.30), in dav1d's Dav1dFilmGrainData form
    struct Grain {
        int apply = 0, seed = 0, num_y = 0, csfl = 0, num_uv[2] = {0, 0};
        int y_points[14][2] = {}, uv_points[2][10][2] = {};
        int scaling_shift = 8, lag = 0, ar_y[24] = {}, ar_uv[2][25] = {}, ar_shift = 6, grain_scale_shift = 0;
        int uv_mult[2] = {}, uv_luma_mult[2] = {}, uv_offset[2] = {}, overlap = 0, restricted = 0;
    } grain;
};

int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) ++k;
    return k;
}

bool seg_active(const Frame& f, int seg, int feature) { return f.seg_enabled && f.feature_enabled[seg][feature]; }

int qindex_of(const Frame& f, int seg, int current, bool ignore_delta) {
    if (seg_active(f, seg, SEG_LVL_ALT_Q)) {
        const int data = f.feature_data[seg][SEG_LVL_ALT_Q];
        int q = f.base_q + data;
        if (!ignore_delta && f.delta_q_present) q = current + data;
        return clip3(0, 255, q);
    }
    if (!ignore_delta && f.delta_q_present) return current;
    return f.base_q;
}

int read_delta_q(Bits& b) { return b.f(1) ? b.su(7) : 0; }

void read_frame_header(Bits& b, const Sequence& s, Frame& f, uint64_t* tools, int temporal_id, int spatial_id) {
    int frame_type = 0;
    if (s.reduced) {
        f.show_frame = 1;
        f.showable = 0;
    } else {
        if (b.f(1)) refuse("a frame shown from another (show_existing_frame)");
        frame_type = b.f(2);
        if (frame_type != 0) refuse("an inter or intra-only frame (not a key frame)");
        f.show_frame = b.f(1);
        if (f.show_frame && s.decoder_model_info && !s.equal_picture_interval) b.f(s.frame_presentation_time_length);
        f.showable = f.show_frame ? 0 : b.f(1);
        f.error_resilient = f.show_frame ? 1 : b.f(1);
    }
    f.disable_cdf_update = b.f(1);
    if (s.force_screen_content_tools == 2) f.allow_screen_content = b.f(1);
    else f.allow_screen_content = s.force_screen_content_tools;
    if (f.allow_screen_content && s.force_integer_mv == 2) b.f(1);  // force_integer_mv
    if (s.frame_id_numbers) b.f(s.delta_frame_id_length + s.additional_frame_id_length);
    const int size_override = s.reduced ? 0 : b.f(1);
    b.f(s.order_hint_bits);  // order_hint
    // primary_ref_frame is none for an intra frame
    if (s.decoder_model_info) {
        if (b.f(1)) {
            for (int op = 0; op < s.op_count; ++op) {
                if (!s.decoder_model_present[op]) continue;
                const int idc = s.op_idc[op];
                const int in_t = (idc >> temporal_id) & 1, in_s = (idc >> (spatial_id + 8)) & 1;
                if (idc == 0 || (in_t && in_s)) b.f(s.buffer_removal_time_length);
            }
        }
    }
    if (!f.show_frame) {  // a key frame not shown: refresh_frame_flags, and maybe the reference order hints
        if (b.f(8) != 0xFF && f.error_resilient && s.enable_order_hint)
            for (int i = 0; i < 8; ++i) b.f(s.order_hint_bits);
    }
    // frame_size
    if (size_override) {
        f.width = b.f(s.frame_width_bits) + 1;
        f.height = b.f(s.frame_height_bits) + 1;
    } else {
        f.width = s.max_w;
        f.height = s.max_h;
    }
    if (s.enable_superres && b.f(1)) refuse("superres");
    f.mi_cols = 2 * ((f.width + 7) >> 3);
    f.mi_rows = 2 * ((f.height + 7) >> 3);
    if (b.f(1)) {  // render_and_frame_size_different
        b.f(16);
        b.f(16);
    }
    if (f.allow_screen_content) f.allow_intrabc = b.f(1);
    if (!(s.reduced || f.disable_cdf_update)) b.f(1);  // disable_frame_end_update_cdf: one frame, no update
    // tile_info
    const int sb_cols = s.sb128 ? (f.mi_cols + 31) >> 5 : (f.mi_cols + 15) >> 4;
    const int sb_rows = s.sb128 ? (f.mi_rows + 31) >> 5 : (f.mi_rows + 15) >> 4;
    const int sb_shift = s.sb128 ? 5 : 4;
    const int sb_size = sb_shift + 2;
    const int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    const int min_log2_tile_cols = tile_log2(max_tile_width_sb, sb_cols);
    const int max_log2_tile_cols = tile_log2(1, std::min(sb_cols, 64));
    const int max_log2_tile_rows = tile_log2(1, std::min(sb_rows, 64));
    const int min_log2_tiles = std::max(min_log2_tile_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    f.col_starts.clear();
    f.row_starts.clear();
    if (b.f(1)) {  // uniform_tile_spacing_flag
        f.tile_cols_log2 = min_log2_tile_cols;
        while (f.tile_cols_log2 < max_log2_tile_cols && b.f(1)) ++f.tile_cols_log2;
        const int tile_w = (sb_cols + (1 << f.tile_cols_log2) - 1) >> f.tile_cols_log2;
        for (int start = 0; start < sb_cols; start += tile_w) f.col_starts.push_back(start << sb_shift);
        f.col_starts.push_back(f.mi_cols);
        const int min_log2_tile_rows = std::max(min_log2_tiles - f.tile_cols_log2, 0);
        f.tile_rows_log2 = min_log2_tile_rows;
        while (f.tile_rows_log2 < max_log2_tile_rows && b.f(1)) ++f.tile_rows_log2;
        const int tile_h = (sb_rows + (1 << f.tile_rows_log2) - 1) >> f.tile_rows_log2;
        for (int start = 0; start < sb_rows; start += tile_h) f.row_starts.push_back(start << sb_shift);
        f.row_starts.push_back(f.mi_rows);
    } else {
        int widest = 0, start = 0;
        while (start < sb_cols) {
            f.col_starts.push_back(start << sb_shift);
            const int size = static_cast<int>(b.ns(std::min(sb_cols - start, max_tile_width_sb))) + 1;
            widest = std::max(widest, size);
            start += size;
        }
        f.col_starts.push_back(f.mi_cols);
        f.tile_cols_log2 = tile_log2(1, static_cast<int>(f.col_starts.size()) - 1);
        if (min_log2_tiles > 0) max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1);
        else max_tile_area_sb = sb_rows * sb_cols;
        const int max_tile_height_sb = std::max(max_tile_area_sb / widest, 1);
        start = 0;
        while (start < sb_rows) {
            f.row_starts.push_back(start << sb_shift);
            start += static_cast<int>(b.ns(std::min(sb_rows - start, max_tile_height_sb))) + 1;
        }
        f.row_starts.push_back(f.mi_rows);
        f.tile_rows_log2 = tile_log2(1, static_cast<int>(f.row_starts.size()) - 1);
    }
    f.tile_cols = static_cast<int>(f.col_starts.size()) - 1;
    f.tile_rows = static_cast<int>(f.row_starts.size()) - 1;
    if (f.tile_cols_log2 > 0 || f.tile_rows_log2 > 0) {
        b.f(f.tile_rows_log2 + f.tile_cols_log2);  // context_update_tile_id
        f.tile_size_bytes = b.f(2) + 1;
    }
    if (f.tile_cols * f.tile_rows > 1) *tools |= TOOL_TILES;
    // quantization_params
    f.base_q = b.f(8);
    f.dq_ydc = read_delta_q(b);
    if (!s.mono) {
        const int diff_uv = s.sep_uv_dq ? b.f(1) : 0;
        f.dq_udc = read_delta_q(b);
        f.dq_uac = read_delta_q(b);
        if (diff_uv) {
            f.dq_vdc = read_delta_q(b);
            f.dq_vac = read_delta_q(b);
        } else {
            f.dq_vdc = f.dq_udc;
            f.dq_vac = f.dq_uac;
        }
    }
    f.using_qm = b.f(1);
    if (f.using_qm) {
        f.qm_level[0] = b.f(4);
        f.qm_level[1] = b.f(4);
        f.qm_level[2] = s.sep_uv_dq ? b.f(4) : f.qm_level[1];
    }
    // segmentation_params
    f.seg_enabled = b.f(1);
    if (f.seg_enabled) {
        *tools |= TOOL_SEGMENTATION;
        for (int i = 0; i < MAX_SEGMENTS; ++i)
            for (int j = 0; j < SEG_LVL_MAX; ++j) {
                f.feature_enabled[i][j] = b.f(1);
                int v = 0;
                if (f.feature_enabled[i][j]) {
                    if (kSegSigned[j]) v = clip3(-kSegMax[j], kSegMax[j], b.su(1 + kSegBits[j]));
                    else v = clip3(0, kSegMax[j], static_cast<int>(b.f(kSegBits[j])));
                }
                f.feature_data[i][j] = v;
            }
    }
    for (int i = 0; i < MAX_SEGMENTS; ++i)
        for (int j = 0; j < SEG_LVL_MAX; ++j)
            if (f.seg_enabled && f.feature_enabled[i][j]) {
                f.last_active_seg = i;
                if (j >= SEG_LVL_REF_FRAME) f.seg_pre_skip = 1;
            }
    // delta_q_params, delta_lf_params
    if (f.base_q > 0) f.delta_q_present = b.f(1);
    if (f.delta_q_present) {
        f.delta_q_res = b.f(2);
        if (!f.allow_intrabc) f.delta_lf_present = b.f(1);
        if (f.delta_lf_present) {
            f.delta_lf_res = b.f(2);
            f.delta_lf_multi = b.f(1);
        }
    }
    f.coded_lossless = true;
    for (int seg = 0; seg < MAX_SEGMENTS; ++seg) {
        const int q = qindex_of(f, seg, f.base_q, true);
        f.lossless[seg] = q == 0 && !f.dq_ydc && !f.dq_uac && !f.dq_udc && !f.dq_vac && !f.dq_vdc;
        if (!f.lossless[seg]) f.coded_lossless = false;
    }
    // loop_filter_params
    if (!(f.coded_lossless || f.allow_intrabc)) {
        f.lf_level[0] = b.f(6);
        f.lf_level[1] = b.f(6);
        if (!s.mono && (f.lf_level[0] || f.lf_level[1])) {
            f.lf_level[2] = b.f(6);
            f.lf_level[3] = b.f(6);
        }
        f.lf_sharpness = b.f(3);
        f.lf_delta_enabled = b.f(1);
        if (f.lf_delta_enabled && b.f(1)) {
            for (int i = 0; i < 8; ++i)
                if (b.f(1)) f.lf_ref_deltas[i] = b.su(7);
            for (int i = 0; i < 2; ++i)
                if (b.f(1)) f.lf_mode_deltas[i] = b.su(7);
        }
    }
    // cdef_params
    if (!(f.coded_lossless || f.allow_intrabc || !s.enable_cdef)) {
        f.cdef_damping = b.f(2) + 3;
        f.cdef_bits = b.f(2);
        for (int i = 0; i < (1 << f.cdef_bits); ++i) {
            f.cdef_y_pri[i] = b.f(4);
            f.cdef_y_sec[i] = b.f(2);
            if (f.cdef_y_sec[i] == 3) f.cdef_y_sec[i] = 4;
            if (!s.mono) {
                f.cdef_uv_pri[i] = b.f(4);
                f.cdef_uv_sec[i] = b.f(2);
                if (f.cdef_uv_sec[i] == 3) f.cdef_uv_sec[i] = 4;
            }
        }
    }
    // lr_params
    const bool all_lossless = f.coded_lossless;  // no superres
    if (!(all_lossless || f.allow_intrabc || !s.enable_restoration)) {
        static const int kRemap[4] = {RESTORE_NONE, RESTORE_SWITCHABLE, RESTORE_WIENER, RESTORE_SGRPROJ};
        bool uses = false, chroma = false;
        for (int i = 0; i < (s.mono ? 1 : 3); ++i) {
            f.lr_type[i] = kRemap[b.f(2)];
            if (f.lr_type[i] != RESTORE_NONE) {
                uses = true;
                chroma |= i > 0;
            }
        }
        if (uses) {
            int shift = b.f(1);
            if (s.sb128) ++shift;
            else if (shift) shift += b.f(1);
            f.lr_size[0] = 256 >> (2 - shift);
            const int uv_shift = s.subx && s.suby && chroma ? b.f(1) : 0;
            f.lr_size[1] = f.lr_size[2] = f.lr_size[0] >> uv_shift;
        }
    }
    // read_tx_mode
    f.tx_mode_select = f.coded_lossless ? 0 : b.f(1);
    f.reduced_tx_set = b.f(1);
    // film_grain_params: a key frame's update_grain is 1; dav1d's checks
    if (s.film_grain && (f.show_frame || f.showable) && b.f(1)) {
        auto& g = f.grain;
        g.apply = 1;
        g.seed = b.f(16);
        g.num_y = b.f(4);
        if (g.num_y > 14) broken("film grain of more than 14 luma points");
        for (int i = 0; i < g.num_y; ++i) {
            g.y_points[i][0] = b.f(8);
            if (i && g.y_points[i - 1][0] >= g.y_points[i][0]) broken("film grain luma points out of order");
            g.y_points[i][1] = b.f(8);
        }
        g.csfl = s.mono ? 0 : b.f(1);
        if (!(s.mono || g.csfl || (s.subx && s.suby && !g.num_y))) {
            for (int pl = 0; pl < 2; ++pl) {
                g.num_uv[pl] = b.f(4);
                if (g.num_uv[pl] > 10) broken("film grain of more than 10 chroma points");
                for (int i = 0; i < g.num_uv[pl]; ++i) {
                    g.uv_points[pl][i][0] = b.f(8);
                    if (i && g.uv_points[pl][i - 1][0] >= g.uv_points[pl][i][0])
                        broken("film grain chroma points out of order");
                    g.uv_points[pl][i][1] = b.f(8);
                }
            }
        }
        if (s.subx && s.suby && !g.num_uv[0] != !g.num_uv[1]) broken("film grain on one 4:2:0 chroma plane");
        g.scaling_shift = b.f(2) + 8;
        g.lag = b.f(2);
        const int num_pos = 2 * g.lag * (g.lag + 1);
        if (g.num_y)
            for (int i = 0; i < num_pos; ++i) g.ar_y[i] = b.f(8) - 128;
        for (int pl = 0; pl < 2; ++pl)
            if (g.num_uv[pl] || g.csfl)
                for (int i = 0; i < num_pos + (g.num_y ? 1 : 0); ++i) g.ar_uv[pl][i] = b.f(8) - 128;
        g.ar_shift = b.f(2) + 6;
        g.grain_scale_shift = b.f(2);
        for (int pl = 0; pl < 2; ++pl)
            if (g.num_uv[pl]) {
                g.uv_mult[pl] = b.f(8) - 128;
                g.uv_luma_mult[pl] = b.f(8) - 128;
                g.uv_offset[pl] = b.f(9) - 256;
            }
        g.overlap = b.f(1);
        g.restricted = b.f(1);
    }
}

// ---------------------------------------------------------------------------
// Film grain synthesis (7.18.3) as dav1d applies it to its output picture
// (fg_apply_tmpl.c, filmgrain_tmpl.c): the grain templates from the LFSR
// and Gaussian_Sequence with their auto-regression, the scaling LUTs, and
// 32×32 blocks of random offsets blended where they overlap
// ---------------------------------------------------------------------------

constexpr int GRAIN_W = 82, GRAIN_H = 73;

int grain_random(int bits, unsigned& state) {
    const unsigned r = state;
    const unsigned bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    state = (r >> 1) | (bit << 15);
    return static_cast<int>((state >> (16 - bits)) & ((1u << bits) - 1));
}
inline int grain_round2(int x, int shift) { return (x + ((1 << shift) >> 1)) >> shift; }

// a grain template: GRAIN_H + 1 rows of GRAIN_W (dav1d's extra row)
struct GrainLut {
    std::vector<int> v;
    int* operator[](int y) { return v.data() + static_cast<size_t>(y) * GRAIN_W; }
    const int* operator[](int y) const { return v.data() + static_cast<size_t>(y) * GRAIN_W; }
};

void generate_grain(const Frame::Grain& g, int pl, int subx, int suby, const GrainLut& luma, GrainLut& buf) {
    unsigned seed = static_cast<unsigned>(g.seed) ^ (pl == 0 ? 0 : (pl == 2 ? 0x49d8 : 0xb524));
    const int shift = 4 + g.grain_scale_shift;
    const int w = pl && subx ? 44 : GRAIN_W, h = pl && suby ? 38 : GRAIN_H;
    buf.v.assign(static_cast<size_t>(GRAIN_H + 1) * GRAIN_W, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) buf[y][x] = grain_round2(kGaussianSequence[grain_random(11, seed)], shift);
    const int lag = g.lag;
    for (int y = 3; y < h; ++y)
        for (int x = 3; x < w - 3; ++x) {
            const int* coeff = pl ? g.ar_uv[pl - 1] : g.ar_y;
            int sum = 0;
            for (int dy = -lag; dy <= 0; ++dy)
                for (int dx = -lag; dx <= lag; ++dx) {
                    if (!dx && !dy) {
                        if (pl && g.num_y) {  // the luma grain's contribution
                            const int lx = ((x - 3) << subx) + 3, ly = ((y - 3) << suby) + 3;
                            int l = 0;
                            for (int i = 0; i <= suby; ++i)
                                for (int j = 0; j <= subx; ++j) l += luma[ly + i][lx + j];
                            sum += grain_round2(l, subx + suby) * *coeff;
                        }
                        goto done;
                    }
                    sum += *coeff++ * buf[y + dy][x + dx];
                }
        done:
            buf[y][x] = clip3(-128, 127, buf[y][x] + grain_round2(sum, g.ar_shift));
        }
}

void grain_scaling(const int (*points)[2], int num, uint8_t* scaling) {
    if (num == 0) {
        std::memset(scaling, 0, 256);
        return;
    }
    std::memset(scaling, points[0][1], points[0][0]);
    for (int i = 0; i < num - 1; ++i) {
        const int bx = points[i][0], by = points[i][1], dx = points[i + 1][0] - bx, dy = points[i + 1][1] - by;
        const int delta = dy * ((0x10000 + (dx >> 1)) / dx);
        for (int x = 0, d = 0x8000; x < dx; ++x, d += delta) scaling[bx + x] = static_cast<uint8_t>(by + (d >> 16));
    }
    const int n = points[num - 1][0];
    std::memset(scaling + n, points[num - 1][1], 256 - n);
}

// planes: Y, U, V (cropped, rows packed) of a frame w × h; the grain is
// added in place, read from copies of the planes as decoded
void apply_grain(const Frame::Grain& g, int mono, int subx, int suby, int is_id, int w, int h,
                 std::vector<uint8_t*> planes) {
    const int cw = (w + subx) >> subx, ch = (h + suby) >> suby;
    std::vector<uint8_t> src_y(planes[0], planes[0] + static_cast<size_t>(w) * h);
    GrainLut lut[3];
    generate_grain(g, 0, 0, 0, lut[0], lut[0]);
    uint8_t scaling[3][256];
    const bool chroma = !mono && (g.num_uv[0] || g.num_uv[1] || g.csfl);
    for (int pl = 0; pl < 2 && !mono; ++pl)
        if (g.num_uv[pl] || g.csfl) generate_grain(g, pl + 1, subx, suby, lut[0], lut[pl + 1]);
    grain_scaling(g.y_points, g.num_y, scaling[0]);
    for (int pl = 0; pl < 2; ++pl) grain_scaling(g.uv_points[pl], g.num_uv[pl], scaling[pl + 1]);
    static const int kW[2][2][2] = {{{27, 17}, {17, 27}}, {{23, 22}, {0, 0}}};
    const int rows = (h + 31) >> 5;
    for (int row = 0; row < rows; ++row) {
        const int nrows = 1 + (g.overlap && row > 0);
        for (int pl = 0; pl < 3; ++pl) {
            if (pl == 0 ? !g.num_y : !(chroma && (g.csfl || g.num_uv[pl - 1]))) continue;
            const int sx = pl ? subx : 0, sy = pl ? suby : 0;
            const int pw = pl ? cw : w;
            const int bh = pl ? (std::min(h - row * 32, 32) + sy) >> sy : std::min(h - row * 32, 32);
            const int y0 = pl ? (row * 32) >> sy : row * 32;
            const uint8_t* sc = scaling[pl && !g.csfl ? pl : 0];
            const GrainLut& lt = lut[pl];
            const int lo = g.restricted ? 16 : 0, hi = g.restricted ? (pl && !is_id ? 240 : 235) : 255;
            unsigned seed[2];
            for (int i = 0; i < nrows; ++i) {
                seed[i] = static_cast<unsigned>(g.seed);
                seed[i] ^= static_cast<unsigned>((((row - i) * 37 + 178) & 0xFF) << 8);
                seed[i] ^= static_cast<unsigned>(((row - i) * 173 + 105) & 0xFF);
            }
            int offsets[2][2] = {};
            auto sample = [&](int bx, int by, int x, int y) {
                const int r = offsets[bx][by];
                const int offx = 3 + (2 >> sx) * (3 + (r >> 4)), offy = 3 + (2 >> sy) * (3 + (r & 0xF));
                return lt[offy + y + (32 >> sy) * by][offx + x + (32 >> sx) * bx];
            };
            uint8_t* dst = planes[pl];
            const uint8_t* src = pl ? nullptr : src_y.data();
            std::vector<uint8_t> src_c;
            if (pl) {
                src_c.assign(dst, dst + static_cast<size_t>(cw) * ch);
                src = src_c.data();
            }
            auto add = [&](int bx, int x, int y, int grain) {
                const int px = bx + x, py = y0 + y;
                const int v = src[static_cast<size_t>(py) * pw + px];
                int idx = v;
                if (pl) {
                    const int lx = px << sx, ly = py << sy;
                    const uint8_t* lrow = src_y.data() + static_cast<size_t>(ly) * w;
                    int avg = lrow[lx];
                    if (sx) avg = (avg + lrow[std::min(lx + 1, w - 1)] + 1) >> 1;
                    idx = avg;
                    if (!g.csfl)
                        idx = clip3(0, 255, ((avg * g.uv_luma_mult[pl - 1] + v * g.uv_mult[pl - 1]) >> 6) +
                                                g.uv_offset[pl - 1]);
                }
                const int noise = grain_round2(sc[idx] * grain, g.scaling_shift);
                dst[static_cast<size_t>(py) * pw + px] = static_cast<uint8_t>(clip3(lo, hi, v + noise));
            };
            const int bs = 32 >> sx;
            for (int bx = 0; bx < pw; bx += bs) {
                const int bw = std::min(bs, pw - bx);
                if (g.overlap && bx)
                    for (int i = 0; i < nrows; ++i) offsets[1][i] = offsets[0][i];
                for (int i = 0; i < nrows; ++i) offsets[0][i] = grain_random(8, seed[i]);
                const int ystart = g.overlap && row ? std::min(2 >> sy, bh) : 0;
                const int xstart = g.overlap && bx ? std::min(2 >> sx, bw) : 0;
                for (int y = ystart; y < bh; ++y) {
                    for (int x = xstart; x < bw; ++x) add(bx, x, y, sample(0, 0, x, y));
                    for (int x = 0; x < xstart; ++x) {
                        const int gr = grain_round2(sample(1, 0, x, y) * kW[sx][x][0] + sample(0, 0, x, y) * kW[sx][x][1], 5);
                        add(bx, x, y, clip3(-128, 127, gr));
                    }
                }
                for (int y = 0; y < ystart; ++y) {
                    for (int x = xstart; x < bw; ++x) {
                        const int gr = grain_round2(sample(0, 1, x, y) * kW[sy][y][0] + sample(0, 0, x, y) * kW[sy][y][1], 5);
                        add(bx, x, y, clip3(-128, 127, gr));
                    }
                    for (int x = 0; x < xstart; ++x) {
                        int top = grain_round2(sample(1, 1, x, y) * kW[sx][x][0] + sample(0, 1, x, y) * kW[sx][x][1], 5);
                        top = clip3(-128, 127, top);
                        int gr = grain_round2(sample(1, 0, x, y) * kW[sx][x][0] + sample(0, 0, x, y) * kW[sx][x][1], 5);
                        gr = clip3(-128, 127, gr);
                        gr = clip3(-128, 127, grain_round2(top * kW[sy][y][0] + gr * kW[sy][y][1], 5));
                        add(bx, x, y, gr);
                    }
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The symbol decoder (8.2) and the CDFs it adapts
// ---------------------------------------------------------------------------

struct Cdfs {
    uint16_t partition[20][11];
    uint16_t kf_y_mode[5][5][14];
    uint16_t uv_mode[2][13][15];
    uint16_t angle_delta[8][8];
    uint16_t tx_set1[4][13][8];
    uint16_t tx_set2[4][13][6];
    uint16_t tx_size[4][3][4];
    uint16_t cfl_sign[9];
    uint16_t cfl_alpha[6][17];
    uint16_t filter_intra[22][3];
    uint16_t filter_intra_mode[6];
    uint16_t skip[3][3];
    uint16_t intrabc[3];
    uint16_t seg_id[3][9];
    uint16_t pal_y_mode[7][3][3];
    uint16_t pal_uv_mode[2][3];
    uint16_t delta_q[5];
    uint16_t delta_lf[5];
    uint16_t delta_lf_multi[4][5];
    uint16_t txb_skip[5][13][3];
    uint16_t eob_extra[5][2][9][3];
    uint16_t dc_sign[2][3][3];
    uint16_t eob16[2][2][6];
    uint16_t eob32[2][2][7];
    uint16_t eob64[2][2][8];
    uint16_t eob128[2][2][9];
    uint16_t eob256[2][2][10];
    uint16_t eob512[2][2][11];
    uint16_t eob1024[2][2][12];
    uint16_t base_eob[5][2][4][4];
    uint16_t base[5][2][42][5];
    uint16_t br[5][2][21][5];
    uint16_t pal_y_size[7][8];
    uint16_t pal_uv_size[7][8];
    uint16_t pal_y_color[7][5][9];
    uint16_t pal_uv_color[7][5][9];
    uint16_t txfm_split[21][3];
    uint16_t inter_set1[2][17];
    uint16_t inter_set2[13];
    uint16_t inter_set3[4][3];
    uint16_t mv_joint[5];
    uint16_t mv_class[2][12];
    uint16_t mv_class0_bit[2][3];
    uint16_t mv_bit[2][10][3];
    uint16_t mv_sign[2][3];
    uint16_t restore_switchable[4];
    uint16_t restore_wiener[3];
    uint16_t restore_sgrproj[3];

    void init(int qctx) {
        std::memcpy(partition, kPartitionCdf, sizeof partition);
        std::memcpy(kf_y_mode, kKfYModeCdf, sizeof kf_y_mode);
        std::memcpy(uv_mode, kUvModeCdf, sizeof uv_mode);
        std::memcpy(angle_delta, kAngleDeltaCdf, sizeof angle_delta);
        std::memcpy(tx_set1, kIntraTxSet1Cdf, sizeof tx_set1);
        std::memcpy(tx_set2, kIntraTxSet2Cdf, sizeof tx_set2);
        std::memcpy(tx_size, kTxSizeCdf, sizeof tx_size);
        std::memcpy(cfl_sign, kCflSignCdf, sizeof cfl_sign);
        std::memcpy(cfl_alpha, kCflAlphaCdf, sizeof cfl_alpha);
        std::memcpy(filter_intra, kFilterIntraCdf, sizeof filter_intra);
        std::memcpy(filter_intra_mode, kFilterIntraModeCdf, sizeof filter_intra_mode);
        std::memcpy(skip, kSkipCdf, sizeof skip);
        std::memcpy(intrabc, kIntrabcCdf, sizeof intrabc);
        std::memcpy(seg_id, kSegmentIdCdf, sizeof seg_id);
        std::memcpy(pal_y_mode, kPaletteYModeCdf, sizeof pal_y_mode);
        std::memcpy(pal_uv_mode, kPaletteUvModeCdf, sizeof pal_uv_mode);
        std::memcpy(delta_q, kDeltaQCdf, sizeof delta_q);
        std::memcpy(delta_lf, kDeltaLfCdf, sizeof delta_lf);
        std::memcpy(delta_lf_multi, kDeltaLfMultiCdf, sizeof delta_lf_multi);
        std::memcpy(txb_skip, kTxbSkipCdf[qctx], sizeof txb_skip);
        std::memcpy(eob_extra, kEobExtraCdf[qctx], sizeof eob_extra);
        std::memcpy(dc_sign, kDcSignCdf[qctx], sizeof dc_sign);
        std::memcpy(eob16, kEobPt16Cdf[qctx], sizeof eob16);
        std::memcpy(eob32, kEobPt32Cdf[qctx], sizeof eob32);
        std::memcpy(eob64, kEobPt64Cdf[qctx], sizeof eob64);
        std::memcpy(eob128, kEobPt128Cdf[qctx], sizeof eob128);
        std::memcpy(eob256, kEobPt256Cdf[qctx], sizeof eob256);
        std::memcpy(eob512, kEobPt512Cdf[qctx], sizeof eob512);
        std::memcpy(eob1024, kEobPt1024Cdf[qctx], sizeof eob1024);
        std::memcpy(base_eob, kCoeffBaseEobCdf[qctx], sizeof base_eob);
        std::memcpy(base, kCoeffBaseCdf[qctx], sizeof base);
        std::memcpy(br, kCoeffBrCdf[qctx], sizeof br);
        std::memcpy(pal_y_size, kPaletteYSizeCdf, sizeof pal_y_size);
        std::memcpy(pal_uv_size, kPaletteUvSizeCdf, sizeof pal_uv_size);
        std::memcpy(pal_y_color, kPaletteYColorCdf, sizeof pal_y_color);
        std::memcpy(pal_uv_color, kPaletteUvColorCdf, sizeof pal_uv_color);
        std::memcpy(txfm_split, kTxfmSplitCdf, sizeof txfm_split);
        std::memcpy(inter_set1, kInterTxSet1Cdf, sizeof inter_set1);
        std::memcpy(inter_set2, kInterTxSet2Cdf, sizeof inter_set2);
        std::memcpy(inter_set3, kInterTxSet3Cdf, sizeof inter_set3);
        std::memcpy(mv_joint, kMvJointCdf, sizeof mv_joint);
        for (int c = 0; c < 2; ++c) {
            std::memcpy(mv_class[c], kMvClassCdf, sizeof mv_class[c]);
            std::memcpy(mv_class0_bit[c], kMvClass0BitCdf, sizeof mv_class0_bit[c]);
            std::memcpy(mv_bit[c], kMvBitCdf, sizeof mv_bit[c]);
            std::memcpy(mv_sign[c], kMvSignCdf, sizeof mv_sign[c]);
        }
        std::memcpy(restore_switchable, kRestoreSwitchableCdf, sizeof restore_switchable);
        std::memcpy(restore_wiener, kRestoreWienerCdf, sizeof restore_wiener);
        std::memcpy(restore_sgrproj, kRestoreSgrprojCdf, sizeof restore_sgrproj);
    }
};

struct SymbolDecoder {
    const uint8_t* d = nullptr;
    size_t n = 0, bitpos = 0;
    uint32_t value = 0, range = 0;
    int max_bits = 0;
    bool update = true;

    uint32_t bits(int k) {
        uint32_t v = 0;
        for (int i = 0; i < k; ++i) {
            const size_t byte = bitpos >> 3;
            const uint32_t bit = byte < n ? (d[byte] >> (7 - (bitpos & 7))) & 1 : 0;
            v = (v << 1) | bit;
            ++bitpos;
        }
        return v;
    }
    void init(const uint8_t* data, size_t size, bool disable_update) {
        d = data;
        n = size;
        bitpos = 0;
        const int num = static_cast<int>(std::min<size_t>(size * 8, 15));
        const uint32_t buf = bits(num);
        const uint32_t padded = buf << (15 - num);
        value = ((1u << 15) - 1) ^ padded;
        range = 1u << 15;
        max_bits = static_cast<int>(8 * size) - 15;
        update = !disable_update;
    }
    int symbol(uint16_t* cdf, int nsym, bool adapt = true) {
        uint32_t cur = range, prev;
        int sym = -1;
        do {
            ++sym;
            prev = cur;
            const uint32_t f = cdf[sym];  // the inverse CDF: (1 << 15) - cdf
            cur = ((range >> 8) * (f >> 6) >> 1) + 4 * static_cast<uint32_t>(nsym - sym - 1);
        } while (value < cur);
        range = prev - cur;
        value -= cur;
        const int b = 15 - floor_log2(range);
        range <<= b;
        const int num = std::min(b, std::max(0, max_bits));
        const uint32_t data = bits(num) << (b - num);
        value = data ^ (((value + 1) << b) - 1);
        max_bits -= b;
        if (adapt && update) {
            uint16_t& count = cdf[nsym];
            const int rate = 3 + (count > 15) + (count > 31) + std::min(floor_log2(static_cast<uint32_t>(nsym)), 2);
            for (int i = 0; i < nsym - 1; ++i) {
                if (i < sym) cdf[i] = static_cast<uint16_t>(cdf[i] + ((32768 - cdf[i]) >> rate));
                else cdf[i] = static_cast<uint16_t>(cdf[i] - (cdf[i] >> rate));
            }
            count = static_cast<uint16_t>(count + (count < 32));
        }
        return sym;
    }
    int boolean() {
        uint16_t cdf[3] = {1 << 14, 0, 0};
        return symbol(cdf, 2, false);
    }
    int literal(int k) {
        int v = 0;
        for (int i = 0; i < k; ++i) v = (v << 1) | boolean();
        return v;
    }
    int ns(int nv) {  // NS(n) of the tile data (4.10.10 through L())
        const int w = floor_log2(static_cast<uint32_t>(nv)) + 1;
        const int m = (1 << w) - nv;
        const int v = literal(w - 1);
        if (v < m) return v;
        return (v << 1) - m + literal(1);
    }
};

// ---------------------------------------------------------------------------
// Inverse transforms (7.13.2): libaom's and dav1d's butterflies, each add
// clamped to the pass's range
// ---------------------------------------------------------------------------

inline int cospi(int a) { return a >= 64 ? 0 : kCosPi[a]; }
inline int half_btf(int w0, int x0, int w1, int x1) {
    return static_cast<int>((static_cast<int64_t>(w0) * x0 + static_cast<int64_t>(w1) * x1 + 2048) >> 12);
}

struct Clamp {
    int lo, hi;
    int operator()(int64_t x) const { return static_cast<int>(x < lo ? lo : (x > hi ? hi : x)); }
};

int brev(int bits, int x) {
    int r = 0;
    for (int i = 0; i < bits; ++i) r |= ((x >> i) & 1) << (bits - 1 - i);
    return r;
}

// the odd half of an N-point inverse DCT (b: M = N / 2 values, the odd
// inputs in bit-reversed order): a rotation stage, then rounds of
// butterflies and rotations over doubling groups, then a rotation by π/4
void idct_odd(int* b, int m, const Clamp& cl) {
    const int n = 2 * m;
    const int lg = log2i(m / 2);
    for (int k = 0; k < m / 2; ++k) {
        const int a = 64 - 64 / n - (256 / n) * brev(lg, k);
        const int u = b[k], v = b[m - 1 - k];
        b[k] = half_btf(cospi(a), u, -cospi(64 - a), v);
        b[m - 1 - k] = half_btf(cospi(64 - a), u, cospi(a), v);
    }
    for (int g = 2; g <= m / 2; g *= 2) {
        for (int t = 0; t < m / g; ++t)
            for (int u = 0; u < g / 2; ++u) {
                const int i = t * g + u, j = t * g + g - 1 - u;
                const int x = b[i], y = b[j];
                if (t & 1) {
                    b[i] = cl(int64_t(y) - x);
                    b[j] = cl(int64_t(x) + y);
                } else {
                    b[i] = cl(int64_t(x) + y);
                    b[j] = cl(int64_t(x) - y);
                }
            }
        if (g < m / 2) {
            const int nb = m / (4 * g);
            for (int s = 0; s < nb; ++s) {
                const int alpha = 16 / nb + (64 / nb) * brev(log2i(nb), s);
                for (int p = 2 * g * s + g / 2; p < 2 * g * s + g; ++p) {  // type A
                    const int u = b[p], v = b[m - 1 - p];
                    b[p] = half_btf(-cospi(alpha), u, cospi(64 - alpha), v);
                    b[m - 1 - p] = half_btf(cospi(64 - alpha), u, cospi(alpha), v);
                }
                for (int p = 2 * g * s + g; p < 2 * g * s + g + g / 2; ++p) {  // type B
                    const int u = b[p], v = b[m - 1 - p];
                    b[p] = half_btf(-cospi(64 - alpha), u, -cospi(alpha), v);
                    b[m - 1 - p] = half_btf(-cospi(alpha), u, cospi(64 - alpha), v);
                }
            }
        }
    }
    for (int p = m / 4; p < m / 2; ++p) {
        const int u = b[p], v = b[m - 1 - p];
        b[p] = half_btf(-cospi(32), u, cospi(32), v);
        b[m - 1 - p] = half_btf(cospi(32), u, cospi(32), v);
    }
}

// in-place N-point inverse DCT of x (natural order)
void idct(int* x, int n, const Clamp& cl) {
    if (n == 2) {
        const int a = x[0], b = x[1];
        x[0] = half_btf(cospi(32), a, cospi(32), b);
        x[1] = half_btf(cospi(32), a, -cospi(32), b);
        return;
    }
    const int m = n / 2;
    int even[32], odd[32];
    for (int i = 0; i < m; ++i) even[i] = x[2 * i];
    for (int k = 0; k < m; ++k) odd[k] = x[2 * brev(log2i(m), k) + 1];
    idct(even, m, cl);
    if (m == 2) {  // the 4-point DCT's odd half: one rotation
        const int u = odd[0], v = odd[1];
        odd[0] = half_btf(cospi(48), u, -cospi(16), v);
        odd[1] = half_btf(cospi(16), u, cospi(48), v);
    } else {
        idct_odd(odd, m, cl);
    }
    for (int i = 0; i < m; ++i) {
        x[i] = cl(int64_t(even[i]) + odd[m - 1 - i]);
        x[n - 1 - i] = cl(int64_t(even[i]) - odd[m - 1 - i]);
    }
}

void iadst4(int* x) {
    const int x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    if (!(x0 | x1 | x2 | x3)) return;
    int64_t s0 = int64_t(kSinPi[1]) * x0, s1 = int64_t(kSinPi[2]) * x0, s2 = int64_t(kSinPi[3]) * x1;
    int64_t s3 = int64_t(kSinPi[4]) * x2, s4 = int64_t(kSinPi[1]) * x2, s5 = int64_t(kSinPi[2]) * x3;
    int64_t s6 = int64_t(kSinPi[4]) * x3;
    const int64_t s7 = int64_t(x0) - x2 + x3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = int64_t(kSinPi[3]) * s7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    const int64_t o0 = s0 + s3, o1 = s1 + s3, o2 = s2, o3 = s0 + s1 - s3;
    x[0] = round2(o0, 12);
    x[1] = round2(o1, 12);
    x[2] = round2(o2, 12);
    x[3] = round2(o3, 12);
}

void iadst8(int* x, const Clamp& cl) {
    int b[8] = {x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6]};
    int c[8];
    c[0] = half_btf(cospi(4), b[0], cospi(60), b[1]);
    c[1] = half_btf(cospi(60), b[0], -cospi(4), b[1]);
    c[2] = half_btf(cospi(20), b[2], cospi(44), b[3]);
    c[3] = half_btf(cospi(44), b[2], -cospi(20), b[3]);
    c[4] = half_btf(cospi(36), b[4], cospi(28), b[5]);
    c[5] = half_btf(cospi(28), b[4], -cospi(36), b[5]);
    c[6] = half_btf(cospi(52), b[6], cospi(12), b[7]);
    c[7] = half_btf(cospi(12), b[6], -cospi(52), b[7]);
    for (int i = 0; i < 4; ++i) {
        b[i] = cl(int64_t(c[i]) + c[i + 4]);
        b[i + 4] = cl(int64_t(c[i]) - c[i + 4]);
    }
    c[0] = b[0]; c[1] = b[1]; c[2] = b[2]; c[3] = b[3];
    c[4] = half_btf(cospi(16), b[4], cospi(48), b[5]);
    c[5] = half_btf(cospi(48), b[4], -cospi(16), b[5]);
    c[6] = half_btf(-cospi(48), b[6], cospi(16), b[7]);
    c[7] = half_btf(cospi(16), b[6], cospi(48), b[7]);
    b[0] = cl(int64_t(c[0]) + c[2]); b[1] = cl(int64_t(c[1]) + c[3]);
    b[2] = cl(int64_t(c[0]) - c[2]); b[3] = cl(int64_t(c[1]) - c[3]);
    b[4] = cl(int64_t(c[4]) + c[6]); b[5] = cl(int64_t(c[5]) + c[7]);
    b[6] = cl(int64_t(c[4]) - c[6]); b[7] = cl(int64_t(c[5]) - c[7]);
    c[0] = b[0]; c[1] = b[1];
    c[2] = half_btf(cospi(32), b[2], cospi(32), b[3]);
    c[3] = half_btf(cospi(32), b[2], -cospi(32), b[3]);
    c[4] = b[4]; c[5] = b[5];
    c[6] = half_btf(cospi(32), b[6], cospi(32), b[7]);
    c[7] = half_btf(cospi(32), b[6], -cospi(32), b[7]);
    x[0] = c[0]; x[1] = -c[4]; x[2] = c[6]; x[3] = -c[2];
    x[4] = c[3]; x[5] = -c[7]; x[6] = c[5]; x[7] = -c[1];
}

void iadst16(int* x, const Clamp& cl) {
    static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    int b[16], c[16];
    for (int i = 0; i < 16; ++i) b[i] = x[perm[i]];
    for (int i = 0; i < 8; ++i) {  // stage 2: angles 2, 10, ..., 58
        const int a = 2 + 8 * i;
        c[2 * i] = half_btf(cospi(a), b[2 * i], cospi(64 - a), b[2 * i + 1]);
        c[2 * i + 1] = half_btf(cospi(64 - a), b[2 * i], -cospi(a), b[2 * i + 1]);
    }
    for (int i = 0; i < 8; ++i) {
        b[i] = cl(int64_t(c[i]) + c[i + 8]);
        b[i + 8] = cl(int64_t(c[i]) - c[i + 8]);
    }
    for (int i = 0; i < 8; ++i) c[i] = b[i];
    c[8] = half_btf(cospi(8), b[8], cospi(56), b[9]);
    c[9] = half_btf(cospi(56), b[8], -cospi(8), b[9]);
    c[10] = half_btf(cospi(40), b[10], cospi(24), b[11]);
    c[11] = half_btf(cospi(24), b[10], -cospi(40), b[11]);
    c[12] = half_btf(-cospi(56), b[12], cospi(8), b[13]);
    c[13] = half_btf(cospi(8), b[12], cospi(56), b[13]);
    c[14] = half_btf(-cospi(24), b[14], cospi(40), b[15]);
    c[15] = half_btf(cospi(40), b[14], cospi(24), b[15]);
    for (int h = 0; h < 16; h += 8)
        for (int i = 0; i < 4; ++i) {
            b[h + i] = cl(int64_t(c[h + i]) + c[h + i + 4]);
            b[h + i + 4] = cl(int64_t(c[h + i]) - c[h + i + 4]);
        }
    for (int h = 0; h < 16; h += 8) {
        c[h] = b[h]; c[h + 1] = b[h + 1]; c[h + 2] = b[h + 2]; c[h + 3] = b[h + 3];
        c[h + 4] = half_btf(cospi(16), b[h + 4], cospi(48), b[h + 5]);
        c[h + 5] = half_btf(cospi(48), b[h + 4], -cospi(16), b[h + 5]);
        c[h + 6] = half_btf(-cospi(48), b[h + 6], cospi(16), b[h + 7]);
        c[h + 7] = half_btf(cospi(16), b[h + 6], cospi(48), b[h + 7]);
    }
    for (int h = 0; h < 16; h += 4) {
        b[h] = cl(int64_t(c[h]) + c[h + 2]);
        b[h + 1] = cl(int64_t(c[h + 1]) + c[h + 3]);
        b[h + 2] = cl(int64_t(c[h]) - c[h + 2]);
        b[h + 3] = cl(int64_t(c[h + 1]) - c[h + 3]);
    }
    for (int h = 0; h < 16; h += 4) {
        c[h] = b[h];
        c[h + 1] = b[h + 1];
        c[h + 2] = half_btf(cospi(32), b[h + 2], cospi(32), b[h + 3]);
        c[h + 3] = half_btf(cospi(32), b[h + 2], -cospi(32), b[h + 3]);
    }
    static const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; ++i) x[i] = (i & 1) ? -c[out[i]] : c[out[i]];
}

void iidentity(int* x, int n) {
    for (int i = 0; i < n; ++i) {
        if (n == 4) x[i] = round2(int64_t(x[i]) * 5793, 12);
        else if (n == 8) x[i] = x[i] * 2;
        else if (n == 16) x[i] = round2(int64_t(x[i]) * 11586, 12);
        else x[i] = x[i] * 4;
    }
}

void inverse_1d(int* x, int n, int type, const Clamp& cl) {
    if (type == T1_DCT) idct(x, n, cl);
    else if (type == T1_IDTX) iidentity(x, n);
    else if (n == 4) iadst4(x);
    else if (n == 8) iadst8(x, cl);
    else iadst16(x, cl);
}

void iwht4(int* t, int shift) {
    int a = t[0] >> shift, c = t[1] >> shift, d = t[2] >> shift, b = t[3] >> shift;
    a += c;
    d -= b;
    const int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    t[0] = a;
    t[1] = b;
    t[2] = c;
    t[3] = d;
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Plane {
    int w = 0, h = 0, stride = 0;  // w, h: the decoded area (mi units × 4 >> sub); stride with a margin
    std::vector<uint8_t> px;
    uint8_t& at(int y, int x) { return px[static_cast<size_t>(y) * stride + x]; }
};

struct Decoder {
    const Sequence& seq;
    Frame& fr;
    uint64_t tools = 0;
    int num_planes = 3, subx = 1, suby = 1;
    Plane planes[3];
    // per-4×4 (mi) information, frame-wide
    int mi_stride = 0;
    std::vector<uint8_t> mi_size, y_mode, uv_mode, skip, seg_id, tx_size;
    std::vector<uint8_t> pal_sizes[2], pal_colors[2];  // PaletteSizes and PaletteColors (8 a mi) of Y and U
    std::vector<uint8_t> is_inters, decoded, tx_types;  // IsInters, a mi written this frame, TxTypes (luma)
    std::vector<int16_t> mvs;  // an intraBC block's DV (row, column), 2 a mi
    std::vector<int8_t> delta_lfs;  // 4 a mi
    std::vector<uint8_t> lf_tx[3];  // the transform size of each plane's 4×4 unit, for the loop filter
    int lf_stride[3] = {};
    // the tile's state
    int mi_row_start = 0, mi_row_end = 0, mi_col_start = 0, mi_col_end = 0;
    SymbolDecoder sd;
    Cdfs cdf;
    std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
    int delta_lf[4] = {};
    int current_q = 0;
    bool read_deltas = false;
    int cdef_idx[4] = {-1, -1, -1, -1};
    std::vector<int8_t> cdef_frame;  // cdef_idx of each 64×64 (-1: none read, its blocks all skipped)
    // each restoration unit's type and coefficients (Wiener: 2 passes × 3
    // taps; self-guided: the set and 2 projection weights), the units of
    // each plane, and the tile's reference values (RefLrWiener, RefSgrXqd)
    struct LrUnit {
        int type = RESTORE_NONE, wiener[2][3] = {}, sgr_set = 0, xqd[2] = {};
    };
    std::vector<LrUnit> lr_units[3];
    int lr_rows[3] = {}, lr_cols[3] = {};
    int ref_wiener[3][2][3] = {}, ref_xqd[3][2] = {};
    int cdef_stride = 0;
    // block_decoded[plane][y + 1][x + 1], y and x from -1 to 32 (4×4 units in the superblock)
    uint8_t block_decoded[3][34][34] = {};
    // the current block
    int mi_row = 0, mi_col = 0, bsize = 0, bw4 = 0, bh4 = 0;
    bool has_chroma = false, avail_u = false, avail_l = false, avail_u_chroma = false, avail_l_chroma = false;
    int segment = 0, is_skip = 0, ymode = 0, uvmode = 0, angle_y = 0, angle_uv = 0, cfl_u = 0, cfl_v = 0;
    int use_filter_intra = 0, filter_mode = 0, txsz = 0;
    int pal_n[2] = {}, palette[3][8] = {};  // PaletteSizeY/UV, the Y, U and V colours
    int use_intrabc = 0, dv[2] = {};  // an intraBC block and its displacement (1/8 sample: row, column)
    uint8_t color_map[2][64][64];  // ColorMapY, ColorMapUV
    bool lossless = false;
    int max_luma_w = 0, max_luma_h = 0;
    int qctx = 0;
    // the coefficients of the current transform block, its residual, and
    // CfL's luma (per decoder: tiles of a grid decode on threads)
    int32_t quant[1024];
    int bc_mid[129][128];  // the intraBC copy's horizontal pass
    uint8_t levels[32 + 4][32 + 4];
    int resid[64][64];
    int lbuf[32][32];

    Decoder(const Sequence& s, Frame& f) : seq(s), fr(f) {}

    bool inside(int r, int c) const {
        return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
    }
    size_t mi(int r, int c) const { return static_cast<size_t>(r) * mi_stride + c; }

    void setup() {
        num_planes = seq.mono ? 1 : 3;
        subx = seq.subx;
        suby = seq.suby;
        mi_stride = fr.mi_cols + 32;
        const size_t mis = static_cast<size_t>(fr.mi_rows + 32) * mi_stride;
        mi_size.assign(mis, 0);
        y_mode.assign(mis, 0);
        uv_mode.assign(mis, 0);
        skip.assign(mis, 0);
        seg_id.assign(mis, 0);
        tx_size.assign(mis, 0);
        is_inters.assign(mis, 0);
        decoded.assign(mis, 0);
        tx_types.assign(mis, 0);
        mvs.assign(mis * 2, 0);
        for (int k = 0; k < 2; ++k) {
            pal_sizes[k].assign(mis, 0);
            pal_colors[k].assign(mis * 8, 0);
        }
        delta_lfs.assign(mis * 4, 0);
        for (int p = 0; p < num_planes; ++p) {
            const int sx = p ? subx : 0, sy = p ? suby : 0;
            Plane& pl = planes[p];
            pl.w = (fr.mi_cols * 4) >> sx;
            pl.h = (fr.mi_rows * 4) >> sy;
            pl.stride = pl.w + 160;
            pl.px.assign(static_cast<size_t>(pl.h + 160) * pl.stride, 0);
            lf_stride[p] = (fr.mi_cols >> sx) + 32;
            lf_tx[p].assign(static_cast<size_t>((fr.mi_rows >> sy) + 32) * lf_stride[p], 0);
            above_level[p].assign(fr.mi_cols + 64, 0);
            above_dc[p].assign(fr.mi_cols + 64, 0);
            left_level[p].assign(fr.mi_rows + 64, 0);
            left_dc[p].assign(fr.mi_rows + 64, 0);
        }
        for (int p = 0; p < num_planes; ++p) {
            if (fr.lr_type[p] == RESTORE_NONE) continue;
            const int sx = p ? subx : 0, sy = p ? suby : 0;
            lr_rows[p] = count_units(fr.lr_size[p], (fr.height + sy) >> sy);
            lr_cols[p] = count_units(fr.lr_size[p], (fr.width + sx) >> sx);
            lr_units[p].assign(static_cast<size_t>(lr_rows[p]) * lr_cols[p], LrUnit());
        }
        cdef_stride = (fr.mi_cols + 15) >> 4;
        cdef_frame.assign(static_cast<size_t>(cdef_stride) * ((fr.mi_rows + 15) >> 4), -1);
        qctx = fr.base_q <= 20 ? 0 : fr.base_q <= 60 ? 1 : fr.base_q <= 120 ? 2 : 3;
        if (num_planes == 1) tools |= TOOL_400;
        else if (subx && suby) tools |= TOOL_420;
        else if (subx) tools |= TOOL_422;
        else tools |= TOOL_444;
        if (seq.sb128) tools |= TOOL_SB128;
    }

    // ---- one tile (5.11)
    void decode_tile(const uint8_t* data, size_t size, int row, int col) {
        mi_row_start = fr.row_starts[row];
        mi_row_end = fr.row_starts[row + 1];
        mi_col_start = fr.col_starts[col];
        mi_col_end = fr.col_starts[col + 1];
        current_q = fr.base_q;
        cdf.init(qctx);
        sd.init(data, size, fr.disable_cdf_update);
        for (int p = 0; p < num_planes; ++p) {
            std::fill(above_level[p].begin(), above_level[p].end(), 0);
            std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
        }
        for (int& d : delta_lf) d = 0;
        for (int p = 0; p < 3; ++p)
            for (int pass = 0; pass < 2; ++pass) {
                ref_xqd[p][pass] = kSgrprojXqdMid[pass];
                for (int i = 0; i < 3; ++i) ref_wiener[p][pass][i] = kWienerTapsMid[i];
            }
        const int sb4 = seq.sb128 ? 32 : 16;
        for (int r = mi_row_start; r < mi_row_end; r += sb4) {
            for (int p = 0; p < num_planes; ++p) {
                std::fill(left_level[p].begin(), left_level[p].end(), 0);
                std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
            }
            for (int c = mi_col_start; c < mi_col_end; c += sb4) {
                read_deltas = fr.delta_q_present;
                for (int& k : cdef_idx) k = -1;
                clear_block_decoded(r, c, sb4);
                read_lr(r, c, sb4);
                decode_partition(r, c, seq.sb128 ? BLOCK_128X128 : BLOCK_64X64);
                for (int k = 0; k < (seq.sb128 ? 4 : 1); ++k) {
                    const int r64 = (r >> 4) + (k >> 1), c64 = (c >> 4) + (k & 1);
                    if ((r64 << 4) < fr.mi_rows && (c64 << 4) < fr.mi_cols)
                        cdef_frame[static_cast<size_t>(r64) * cdef_stride + c64] = static_cast<int8_t>(cdef_idx[k]);
                }
            }
        }
        // the specification's bound on the symbol decoder's read past its
        // data (SymbolMaxBits >= -14 at the tile's end), which dav1d enforces
        if (sd.max_bits < -14) broken("a tile whose symbols run past its data");
    }

    void clear_block_decoded(int r, int c, int sb4) {
        for (int p = 0; p < num_planes; ++p) {
            const int sx = p ? subx : 0, sy = p ? suby : 0;
            const int sbw4 = (mi_col_end - c) >> sx, sbh4 = (mi_row_end - r) >> sy;
            for (int y = -1; y <= (sb4 >> sy); ++y)
                for (int x = -1; x <= (sb4 >> sx); ++x) {
                    uint8_t v;
                    if (y < 0 && x < sbw4) v = 1;
                    else if (x < 0 && y < sbh4) v = 1;
                    else v = 0;
                    block_decoded[p][y + 1][x + 1] = v;
                }
            block_decoded[p][(sb4 >> sy) + 1][0] = 0;
        }
    }

    // ---- partitions (5.11.4)
    int partition_ctx(int r, int c, int bsl) {
        const int above = avail_u && log2i(kBlockW[mi_size[mi(r - 1, c)]] >> 2) < bsl;
        const int left = avail_l && log2i(kBlockH[mi_size[mi(r, c - 1)]] >> 2) < bsl;
        return left * 2 + above;
    }

    void decode_partition(int r, int c, int bs) {
        if (r >= fr.mi_rows || c >= fr.mi_cols) return;
        avail_u = inside(r - 1, c);
        avail_l = inside(r, c - 1);
        const int num4 = kBlockW[bs] >> 2, half = num4 >> 1, quarter = half >> 1;
        const bool has_rows = (r + half) < fr.mi_rows, has_cols = (c + half) < fr.mi_cols;
        int partition;
        if (bs < BLOCK_8X8) {
            partition = 0;
        } else {
            const int bsl = log2i(num4);  // 1 for 8×8 ... 5 for 128×128
            const int ctx = partition_ctx(r, c, bsl);
            uint16_t* pc = cdf.partition[(bsl - 1) * 4 + ctx];
            const int nsym = bsl == 1 ? 4 : (bsl == 5 ? 8 : 10);
            auto prob = [&](int e) { return (e > 0 ? pc[e - 1] : 32768) - pc[e]; };
            if (has_rows && has_cols) {
                partition = sd.symbol(pc, nsym);
                // dav1d refuses the vertical splits in 4:2:2 (their halves'
                // chroma would be narrower than the block sizes allow)
                if (num_planes > 1 && subx && !suby && (partition == 2 || partition == 6 || partition == 7 ||
                                                         partition == 9))
                    broken("a vertical partition in 4:2:2");
            } else if (has_cols) {  // split or horizontal: split takes every partition that cuts the top half
                int psum = prob(2) + prob(3);  // VERT, SPLIT
                if (bsl > 1) {
                    psum += prob(4) + prob(6) + prob(7);  // HORZ_A, VERT_A, VERT_B
                    if (bsl < 5) psum += prob(9);  // VERT_4
                }
                uint16_t tmp[3] = {static_cast<uint16_t>(psum), 0, 0};
                partition = sd.symbol(tmp, 2, false) ? 3 : 1;
            } else if (has_rows) {  // split or vertical: split takes every partition that cuts the left half
                int psum = prob(1) + prob(3);  // HORZ, SPLIT
                if (bsl > 1) {
                    psum += prob(4) + prob(5) + prob(6);  // HORZ_A, HORZ_B, VERT_A
                    if (bsl < 5) psum += prob(8);  // HORZ_4
                }
                uint16_t tmp[3] = {static_cast<uint16_t>(psum), 0, 0};
                partition = sd.symbol(tmp, 2, false) ? 3 : 2;
                if (num_planes > 1 && subx && !suby && partition == 2) broken("a vertical partition in 4:2:2");
            } else {
                partition = 3;
            }
        }
        const int w = kBlockW[bs], h = kBlockH[bs];
        const int split = block_of(w / 2, h / 2);
        switch (partition) {
            case 0: decode_block(r, c, bs); break;
            case 1:
                decode_block(r, c, block_of(w, h / 2));
                if (has_rows) decode_block(r + half, c, block_of(w, h / 2));
                break;
            case 2:
                decode_block(r, c, block_of(w / 2, h));
                if (has_cols) decode_block(r, c + half, block_of(w / 2, h));
                break;
            case 3:
                decode_partition(r, c, split);
                decode_partition(r, c + half, split);
                decode_partition(r + half, c, split);
                decode_partition(r + half, c + half, split);
                break;
            case 4:  // HORZ_A
                decode_block(r, c, split);
                decode_block(r, c + half, split);
                decode_block(r + half, c, block_of(w, h / 2));
                break;
            case 5:  // HORZ_B
                decode_block(r, c, block_of(w, h / 2));
                decode_block(r + half, c, split);
                decode_block(r + half, c + half, split);
                break;
            case 6:  // VERT_A
                decode_block(r, c, split);
                decode_block(r + half, c, split);
                decode_block(r, c + half, block_of(w / 2, h));
                break;
            case 7:  // VERT_B
                decode_block(r, c, block_of(w / 2, h));
                decode_block(r, c + half, split);
                decode_block(r + half, c + half, split);
                break;
            case 8:  // HORZ_4
                for (int i = 0; i < 4; ++i)
                    if (i < 3 || r + quarter * 3 < fr.mi_rows) decode_block(r + quarter * i, c, block_of(w, h / 4));
                break;
            default:  // VERT_4
                for (int i = 0; i < 4; ++i)
                    if (i < 3 || c + quarter * 3 < fr.mi_cols) decode_block(r, c + quarter * i, block_of(w / 4, h));
                break;
        }
    }

    // ---- a block (5.11.5)
    void decode_block(int r, int c, int bs) {
        if (bs == BLOCK_INVALID) broken("a partition into an invalid block size");
        mi_row = r;
        mi_col = c;
        bsize = bs;
        bw4 = kBlockW[bs] >> 2;
        bh4 = kBlockH[bs] >> 2;
        if (bh4 == 1 && suby && (mi_row & 1) == 0) has_chroma = false;
        else if (bw4 == 1 && subx && (mi_col & 1) == 0) has_chroma = false;
        else has_chroma = num_planes > 1;
        avail_u = inside(r - 1, c);
        avail_l = inside(r, c - 1);
        avail_u_chroma = avail_u;
        avail_l_chroma = avail_l;
        if (has_chroma) {
            if (suby && bh4 == 1) avail_u_chroma = inside(r - 2, c);
            if (subx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
        } else {
            avail_u_chroma = avail_l_chroma = false;
        }
        mode_info();
        palette_tokens();
        read_block_tx_size();
        if (is_skip) reset_block_context();
        for (int y = 0; y < bh4; ++y)
            for (int x = 0; x < bw4; ++x) {
                if (r + y >= fr.mi_rows || c + x >= fr.mi_cols) continue;
                const size_t k = mi(r + y, c + x);
                y_mode[k] = static_cast<uint8_t>(ymode);
                uv_mode[k] = static_cast<uint8_t>(uvmode);
                skip[k] = static_cast<uint8_t>(is_skip);
                if (!use_intrabc) tx_size[k] = static_cast<uint8_t>(txsz);  // InterTxSizes of an inter block: read_var_tx
                mi_size[k] = static_cast<uint8_t>(bs);
                is_inters[k] = static_cast<uint8_t>(use_intrabc);
                decoded[k] = 1;
                mvs[k * 2] = static_cast<int16_t>(dv[0]);
                mvs[k * 2 + 1] = static_cast<int16_t>(dv[1]);
                seg_id[k] = static_cast<uint8_t>(segment);
                for (int i = 0; i < 4; ++i) delta_lfs[k * 4 + i] = static_cast<int8_t>(delta_lf[i]);
                for (int pl = 0; pl < 2; ++pl) {
                    pal_sizes[pl][k] = static_cast<uint8_t>(pal_n[pl]);
                    for (int i = 0; i < pal_n[pl]; ++i) pal_colors[pl][k * 8 + i] = static_cast<uint8_t>(palette[pl][i]);
                }
            }
        if (use_intrabc) predict_intrabc();
        residual();
    }

    void mode_info() {
        is_skip = 0;  // a segment id read before skip predicts as for a block not skipped
        if (fr.seg_pre_skip) intra_segment_id();
        read_skip();
        if (!fr.seg_pre_skip) intra_segment_id();
        read_cdef();
        read_delta_qindex();
        read_delta_lf();
        read_deltas = false;
        use_intrabc = fr.allow_intrabc ? sd.symbol(cdf.intrabc, 2) : 0;
        dv[0] = dv[1] = 0;
        pal_n[0] = pal_n[1] = 0;
        use_filter_intra = 0;
        if (use_intrabc) {  // an inter block of DC_PRED modes for its neighbours' contexts
            ymode = uvmode = DC_PRED;
            angle_y = angle_uv = cfl_u = cfl_v = 0;
            intrabc_dv();
            tools |= TOOL_INTRABC;
            return;
        }
        const int above = kIntraModeContext[avail_u ? y_mode[mi(mi_row - 1, mi_col)] : DC_PRED];
        const int left = kIntraModeContext[avail_l ? y_mode[mi(mi_row, mi_col - 1)] : DC_PRED];
        ymode = sd.symbol(cdf.kf_y_mode[above][left], 13);
        const bool use_angle_delta = bsize >= BLOCK_8X8;
        angle_y = 0;
        if (use_angle_delta && directional(ymode)) angle_y = sd.symbol(cdf.angle_delta[ymode - V_PRED], 7) - 3;
        uvmode = DC_PRED;
        angle_uv = 0;
        cfl_u = cfl_v = 0;
        if (has_chroma) {
            const int residual_bs = plane_bsize(bsize, 1);
            bool cfl_allowed;
            if (lossless && residual_bs == BLOCK_4X4) cfl_allowed = true;
            else if (!lossless && std::max(kBlockW[bsize], kBlockH[bsize]) <= 32) cfl_allowed = true;
            else cfl_allowed = false;
            uvmode = cfl_allowed ? sd.symbol(cdf.uv_mode[1][ymode], 14) : sd.symbol(cdf.uv_mode[0][ymode], 13);
            if (uvmode == UV_CFL_PRED) {
                const int signs = sd.symbol(cdf.cfl_sign, 8);
                const int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
                if (sign_u) {
                    cfl_u = sd.symbol(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16) + 1;
                    if (sign_u == 1) cfl_u = -cfl_u;
                }
                if (sign_v) {
                    cfl_v = sd.symbol(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16) + 1;
                    if (sign_v == 1) cfl_v = -cfl_v;
                }
                tools |= TOOL_CFL;
            }
            if (use_angle_delta && directional(uvmode)) angle_uv = sd.symbol(cdf.angle_delta[uvmode - V_PRED], 7) - 3;
        }
        if (angle_y || angle_uv) tools |= TOOL_ANGLE_DELTA;
        if (bsize >= BLOCK_8X8 && kBlockW[bsize] <= 64 && kBlockH[bsize] <= 64 && fr.allow_screen_content)
            palette_mode_info();
        if (seq.enable_filter_intra && ymode == DC_PRED && !pal_n[0] &&
            std::max(kBlockW[bsize], kBlockH[bsize]) <= 32) {
            use_filter_intra = sd.symbol(cdf.filter_intra[bsize], 2);
            if (use_filter_intra) {
                filter_mode = sd.symbol(cdf.filter_intra_mode, 5);
                tools |= TOOL_FILTER_INTRA;
            }
        }
    }

    // ---- intraBC (5.11.7 use_intrabc, 7.10.2 find_mv_stack, 5.11.32 read_mv)
    int stack_mv[8][2] = {}, stack_weight[8] = {}, num_mv = 0;

    void add_candidate(int r, int c, int weight) {
        if (!is_inters[mi(r, c)]) return;  // only intraBC blocks hold a DV (RefFrame INTRA_FRAME)
        const int mr = mvs[mi(r, c) * 2], mc = mvs[mi(r, c) * 2 + 1];  // whole samples: lower_mv_precision keeps them
        int idx = 0;
        while (idx < num_mv && !(stack_mv[idx][0] == mr && stack_mv[idx][1] == mc)) ++idx;
        if (idx < num_mv) {
            stack_weight[idx] += weight;
        } else if (num_mv < 8) {
            stack_mv[num_mv][0] = mr;
            stack_mv[num_mv][1] = mc;
            stack_weight[num_mv++] = weight;
        }
    }
    void scan_row(int delta_row) {
        const int end4 = std::min(std::min(bw4, fr.mi_cols - mi_col), 16);
        int delta_col = 0;
        const bool step16 = bw4 >= 16;
        if (std::abs(delta_row) > 1) {
            delta_row += mi_row & 1;
            delta_col = 1 - (mi_col & 1);
        }
        for (int i = 0; i < end4;) {
            const int r = mi_row + delta_row, c = mi_col + delta_col + i;
            if (!inside(r, c)) break;
            int len = std::min(bw4, kBlockW[mi_size[mi(r, c)]] >> 2);
            if (std::abs(delta_row) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, c, len * 2);
            i += len;
        }
    }
    void scan_col(int delta_col) {
        const int end4 = std::min(std::min(bh4, fr.mi_rows - mi_row), 16);
        int delta_row = 0;
        const bool step16 = bh4 >= 16;
        if (std::abs(delta_col) > 1) {
            delta_row = 1 - (mi_row & 1);
            delta_col += mi_col & 1;
        }
        for (int i = 0; i < end4;) {
            const int r = mi_row + delta_row + i, c = mi_col + delta_col;
            if (!inside(r, c)) break;
            int len = std::min(bh4, kBlockH[mi_size[mi(r, c)]] >> 2);
            if (std::abs(delta_col) > 1) len = std::max(2, len);
            if (step16) len = std::max(4, len);
            add_candidate(r, c, len * 2);
            i += len;
        }
    }
    void scan_point(int delta_row, int delta_col) {
        const int r = mi_row + delta_row, c = mi_col + delta_col;
        if (inside(r, c) && decoded[mi(r, c)]) add_candidate(r, c, 4);
    }
    void sort_stack(int start, int end) {
        while (end > start) {
            int new_end = start;
            for (int i = start + 1; i < end; ++i)
                if (stack_weight[i - 1] < stack_weight[i]) {
                    std::swap(stack_weight[i - 1], stack_weight[i]);
                    std::swap(stack_mv[i - 1][0], stack_mv[i][0]);
                    std::swap(stack_mv[i - 1][1], stack_mv[i][1]);
                    new_end = i;
                }
            end = new_end;
        }
    }

    int read_mv_component(int comp) {
        const int sign = sd.symbol(cdf.mv_sign[comp], 2);
        const int cls = sd.symbol(cdf.mv_class[comp], 11);
        int mag;
        if (cls == 0) {
            mag = ((sd.symbol(cdf.mv_class0_bit[comp], 2) << 3) | (3 << 1) | 1) + 1;  // integer: fr 3, hp 1
        } else {
            int d = 0;
            for (int i = 0; i < cls; ++i) d |= sd.symbol(cdf.mv_bit[comp][i], 2) << i;
            mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
        }
        return sign ? -mag : mag;
    }

    void intrabc_dv() {
        // the spatial scan (the contexts it also yields serve inter frames alone)
        num_mv = 0;
        for (auto& m : stack_mv) m[0] = m[1] = 0;
        scan_row(-1);
        scan_col(-1);
        if (std::max(bw4, bh4) <= 16) scan_point(-1, bw4);
        const int nearest = num_mv;
        for (int i = 0; i < nearest; ++i) stack_weight[i] += 640;  // REF_CAT_LEVEL
        scan_point(-1, -1);
        scan_row(-3);
        scan_col(-3);
        if (bh4 > 1) scan_row(-5);
        if (bw4 > 1) scan_col(-5);
        sort_stack(0, nearest);
        sort_stack(nearest, num_mv);
        // extra_search adds nothing (an intra frame's blocks refer to no
        // other frame); the stack's rest stays the zero global MV
        for (int i = 0; i < num_mv; ++i) {  // context_and_clamping
            const int border_r = 128 + bh4 * 32, border_c = 128 + bw4 * 32;
            stack_mv[i][0] = clip3(-(mi_row * 32) - border_r, (fr.mi_rows - bh4 - mi_row) * 32 + border_r, stack_mv[i][0]);
            stack_mv[i][1] = clip3(-(mi_col * 32) - border_c, (fr.mi_cols - bw4 - mi_col) * 32 + border_c, stack_mv[i][1]);
        }
        int pred[2] = {stack_mv[0][0], stack_mv[0][1]};
        if (!pred[0] && !pred[1]) {
            pred[0] = stack_mv[1][0];
            pred[1] = stack_mv[1][1];
        }
        const int sb4 = seq.sb128 ? 32 : 16;
        if (!pred[0] && !pred[1]) {
            if (mi_row - sb4 < mi_row_start) {
                pred[0] = 0;
                pred[1] = -(sb4 * 4 + 256) * 8;
            } else {
                pred[0] = -(sb4 * 4 * 8);
                pred[1] = 0;
            }
        }
        // whole samples (libaom's (v >> 3) * 8 of the reference DV)
        pred[0] = (pred[0] >> 3) * 8;
        pred[1] = (pred[1] >> 3) * 8;
        const int joint = sd.symbol(cdf.mv_joint, 4);
        if (joint == 2 || joint == 3) pred[0] += read_mv_component(0);
        if (joint == 1 || joint == 3) pred[1] += read_mv_component(1);
        // dav1d's clip of the DV into the decoded part of the tile
        int border_left = mi_col_start * 4, border_top = mi_row_start * 4;
        if (has_chroma) {
            if (bw4 < 2 && subx) border_left += 4;
            if (bh4 < 2 && suby) border_top += 4;
        }
        int src_left = mi_col * 4 + (pred[1] >> 3), src_top = mi_row * 4 + (pred[0] >> 3);
        int src_right = src_left + bw4 * 4, src_bottom = src_top + bh4 * 4;
        const int border_right = ((mi_col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;
        if (src_left < border_left) {
            src_right += border_left - src_left;
            src_left = border_left;
        } else if (src_right > border_right) {
            src_left -= src_right - border_right;
            src_right = border_right;
        }
        if (src_top < border_top) {
            src_bottom += border_top - src_top;
            src_top = border_top;
        }
        const int sb_shift = seq.sb128 ? 5 : 4;
        const int sbx = (mi_col >> sb_shift) << (sb_shift + 2), sby = (mi_row >> sb_shift) << (sb_shift + 2);
        const int sb_size = 4 << sb_shift;
        if (src_bottom > sby && src_right > sbx) {
            if (src_top - border_top >= src_bottom - sby) {
                src_top -= src_bottom - sby;
                src_bottom = sby;
            } else if (src_left - border_left >= src_right - sbx) {
                src_left -= src_right - sbx;
                src_right = sbx;
            }
        }
        if (src_bottom > sby + sb_size) {
            src_top -= src_bottom - (sby + sb_size);
            src_bottom = sby + sb_size;
        }
        if (src_bottom > sby && src_right > sbx) broken("an intraBC vector into the superblock being decoded");
        dv[0] = (src_top - mi_row * 4) * 8;
        dv[1] = (src_left - mi_col * 4) * 8;
    }

    // the prediction: the block copied from the frame decoded so far, with
    // the BILINEAR filter where subsampled chroma lands between samples
    // (7.11.3.4, InterRound0 3 and InterRound1 11 at 8 bits)
    void predict_intrabc() {
        for (int p = 0; p < (has_chroma ? num_planes : 1); ++p) {
            const int sx = p ? subx : 0, sy = p ? suby : 0;
            const int pbs = plane_bsize(bsize, p);
            const int w = kBlockW[pbs], h = kBlockH[pbs];
            const int x0 = (mi_col >> sx) * 4, y0 = (mi_row >> sy) * 4;
            const int last_x = ((fr.width + sx) >> sx) - 1, last_y = ((fr.height + sy) >> sy) - 1;
            const int px = x0 * 16 + ((2 * dv[1]) >> sx), py = y0 * 16 + ((2 * dv[0]) >> sy);  // 1/16 sample
            const int ix = px >> 4, fx = px & 15, iy = py >> 4, fy = py & 15;
            Plane& pl = planes[p];
            for (int r = 0; r <= h; ++r) {
                const int yy = clip3(0, last_y, iy + r);
                for (int c = 0; c < w; ++c) {
                    const int a = pl.at(yy, clip3(0, last_x, ix + c)), b = pl.at(yy, clip3(0, last_x, ix + c + 1));
                    bc_mid[r][c] = round2((128 - 8 * fx) * a + 8 * fx * b, 3);
                }
            }
            for (int r = 0; r < h; ++r)
                for (int c = 0; c < w; ++c)
                    pl.at(y0 + r, x0 + c) =
                        static_cast<uint8_t>(clip3(0, 255, round2((128 - 8 * fy) * bc_mid[r][c] + 8 * fy * bc_mid[r + 1][c], 11)));
        }
    }

    // ---- palette (5.11.46, 5.11.49, 7.11.4)
    int palette_cache(int plane, int* cache) {
        const int above_n = (mi_row & 15) && avail_u ? pal_sizes[plane][mi(mi_row - 1, mi_col)] : 0;
        const int left_n = avail_l ? pal_sizes[plane][mi(mi_row, mi_col - 1)] : 0;
        const uint8_t* above = above_n ? &pal_colors[plane][mi(mi_row - 1, mi_col) * 8] : nullptr;
        const uint8_t* left = left_n ? &pal_colors[plane][mi(mi_row, mi_col - 1) * 8] : nullptr;
        int ai = 0, li = 0, n = 0;
        auto put = [&](int v) {
            if (n == 0 || v != cache[n - 1]) cache[n++] = v;
        };
        while (ai < above_n && li < left_n) {
            const int a = above[ai], l = left[li];
            if (l < a) {
                put(l);
                ++li;
            } else {
                put(a);
                ++ai;
                if (l == a) ++li;
            }
        }
        while (ai < above_n) put(above[ai++]);
        while (li < left_n) put(left[li++]);
        return n;
    }

    // the colours of one plane's palette from the cache, then literals and
    // deltas (Y: deltas of at least 1)
    void palette_colors(int plane, int n, bool y) {
        int cache[16];
        const int cache_n = palette_cache(plane, cache);
        int* colors = palette[plane];
        int idx = 0;
        for (int i = 0; i < cache_n && idx < n; ++i)
            if (sd.literal(1)) {
                colors[idx++] = cache[i];
                tools |= TOOL_PALETTE_CACHE;
            }
        if (idx < n) colors[idx++] = sd.literal(8);
        int bits = 0;
        if (idx < n) bits = 5 + sd.literal(2);
        while (idx < n) {
            const int delta = sd.literal(bits) + (y ? 1 : 0);
            colors[idx] = std::min(255, colors[idx - 1] + delta);
            const int range = 256 - colors[idx] - (y ? 1 : 0);
            bits = std::min(bits, range > 1 ? floor_log2(static_cast<uint32_t>(range - 1)) + 1 : 0);
            ++idx;
        }
        std::sort(colors, colors + n);
    }

    void palette_mode_info() {
        const int bctx = log2i(kBlockW[bsize] >> 2) + log2i(kBlockH[bsize] >> 2) - 2;
        if (ymode == DC_PRED) {
            const int ctx = (avail_u && pal_sizes[0][mi(mi_row - 1, mi_col)]) +
                            (avail_l && pal_sizes[0][mi(mi_row, mi_col - 1)]);
            if (sd.symbol(cdf.pal_y_mode[bctx][ctx], 2)) {
                pal_n[0] = sd.symbol(cdf.pal_y_size[bctx], 7) + 2;
                palette_colors(0, pal_n[0], true);
                tools |= TOOL_PALETTE_Y;
            }
        }
        if (has_chroma && uvmode == DC_PRED && sd.symbol(cdf.pal_uv_mode[pal_n[0] > 0], 2)) {
            const int n = pal_n[1] = sd.symbol(cdf.pal_uv_size[bctx], 7) + 2;
            palette_colors(1, n, false);
            int* v = palette[2];
            if (sd.literal(1)) {  // delta_encode_palette_colors_v
                const int bits = 4 + sd.literal(2);
                v[0] = sd.literal(8);
                for (int i = 1; i < n; ++i) {
                    int delta = sd.literal(bits);
                    if (delta && sd.literal(1)) delta = -delta;
                    int val = v[i - 1] + delta;
                    if (val < 0) val += 256;
                    if (val >= 256) val -= 256;
                    v[i] = clip3(0, 255, val);
                }
            } else {
                for (int i = 0; i < n; ++i) v[i] = sd.literal(8);
            }
            tools |= TOOL_PALETTE_UV;
        }
    }

    // the colour index map, read in anti-diagonal order, each index coded
    // by its rank among the neighbours' (get_palette_color_context)
    void color_map_tokens(int k, int n, int bw, int bh, int onw, int onh) {
        uint8_t (*m)[64] = color_map[k];
        m[0][0] = static_cast<uint8_t>(sd.ns(n));
        static const int kHashToCtx[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
        for (int i = 1; i < onh + onw - 1; ++i)
            for (int j = std::min(i, onw - 1); j >= std::max(0, i - onh + 1); --j) {
                const int r = i - j, c = j;
                int scores[8] = {}, order[8] = {0, 1, 2, 3, 4, 5, 6, 7};
                if (c > 0) scores[m[r][c - 1]] += 2;
                if (r > 0 && c > 0) scores[m[r - 1][c - 1]] += 1;
                if (r > 0) scores[m[r - 1][c]] += 2;
                for (int a = 0; a < 3; ++a) {
                    int best = scores[a], at = a;
                    for (int b = a + 1; b < n; ++b)
                        if (scores[b] > best) {
                            best = scores[b];
                            at = b;
                        }
                    if (at != a) {
                        const int o = order[at];
                        for (int b = at; b > a; --b) {
                            scores[b] = scores[b - 1];
                            order[b] = order[b - 1];
                        }
                        scores[a] = best;
                        order[a] = o;
                    }
                }
                const int ctx = kHashToCtx[scores[0] + 2 * scores[1] + 2 * scores[2]];
                uint16_t* c2 = k == 0 ? cdf.pal_y_color[n - 2][ctx] : cdf.pal_uv_color[n - 2][ctx];
                m[r][c] = static_cast<uint8_t>(order[sd.symbol(c2, n)]);
            }
        for (int i = 0; i < onh; ++i)
            for (int j = onw; j < bw; ++j) m[i][j] = m[i][onw - 1];
        for (int i = onh; i < bh; ++i)
            for (int j = 0; j < bw; ++j) m[i][j] = m[onh - 1][j];
    }

    void palette_tokens() {
        int bw = kBlockW[bsize], bh = kBlockH[bsize];
        int onh = std::min(bh, (fr.mi_rows - mi_row) * 4), onw = std::min(bw, (fr.mi_cols - mi_col) * 4);
        if (pal_n[0]) color_map_tokens(0, pal_n[0], bw, bh, onw, onh);
        if (pal_n[1]) {
            bw >>= subx;
            bh >>= suby;
            onw >>= subx;
            onh >>= suby;
            if (bw < 4) {
                bw += 2;
                onw += 2;
            }
            if (bh < 4) {
                bh += 2;
                onh += 2;
            }
            color_map_tokens(1, pal_n[1], bw, bh, onw, onh);
        }
    }

    void predict_palette(int plane, int start_x, int start_y, int x, int y, int t) {
        const int* colors = palette[plane];
        uint8_t (*m)[64] = color_map[plane > 0];
        for (int i = 0; i < kTxH[t]; ++i)
            for (int j = 0; j < kTxW[t]; ++j)
                planes[plane].at(start_y + i, start_x + j) = static_cast<uint8_t>(colors[m[y * 4 + i][x * 4 + j]]);
    }

    int plane_bsize(int bs, int plane) const {
        const int sx = plane ? subx : 0, sy = plane ? suby : 0;
        int w = kBlockW[bs] >> sx, h = kBlockH[bs] >> sy;
        int b = block_of(std::max(w, 4), std::max(h, 4));
        if (b == BLOCK_INVALID) {  // 4:2:2 of a 4×16 or 16×4 ... the specification's Subsampled_Size
            if (w < 4) w = 4;
            if (h < 4) h = 4;
            if (w == 4 && h == 16) b = BLOCK_4X16;
            else if (w == 8 && h == 32) b = BLOCK_8X32;
            else if (w == 2 * h && w <= 64) b = block_of(w, h);
            else b = block_of(std::min(w, h * 2), std::min(h, w * 2));
        }
        return b;
    }

    void intra_segment_id() {
        if (!fr.seg_enabled) {
            segment = 0;
        } else {
            const int prev_ul = (avail_u && avail_l) ? seg_id[mi(mi_row - 1, mi_col - 1)] : -1;
            const int prev_u = avail_u ? seg_id[mi(mi_row - 1, mi_col)] : -1;
            const int prev_l = avail_l ? seg_id[mi(mi_row, mi_col - 1)] : -1;
            int pred;
            if (prev_u == -1) pred = prev_l == -1 ? 0 : prev_l;
            else if (prev_l == -1) pred = prev_u;
            else pred = prev_ul == prev_u ? prev_u : prev_l;
            if (is_skip) {
                segment = pred;
            } else {
                int ctx;
                if (prev_ul < 0 || prev_u < 0 || prev_l < 0) ctx = 0;
                else if (prev_ul == prev_u && prev_ul == prev_l) ctx = 2;
                else if (prev_ul == prev_u || prev_ul == prev_l || prev_u == prev_l) ctx = 1;
                else ctx = 0;
                const int diff = sd.symbol(cdf.seg_id[ctx], MAX_SEGMENTS);
                const int max = fr.last_active_seg + 1;
                int v;
                if (!pred) v = diff;
                else if (pred >= max - 1) v = max - diff - 1;
                else if (2 * pred < max) {
                    if (diff <= 2 * pred) v = (diff & 1) ? pred + ((diff + 1) >> 1) : pred - (diff >> 1);
                    else v = diff;
                } else {
                    if (diff <= 2 * (max - pred - 1)) v = (diff & 1) ? pred + ((diff + 1) >> 1) : pred - (diff >> 1);
                    else v = max - (diff + 1);
                }
                // dav1d takes an id past the last active segment as 0 (the
                // specification clips it; only a damaged stream has one)
                segment = v < 0 || v > fr.last_active_seg ? 0 : v;
            }
        }
        lossless = fr.lossless[segment];
    }

    void read_skip() {
        if (fr.seg_pre_skip && seg_active(fr, segment, SEG_LVL_SKIP)) {
            is_skip = 1;
            return;
        }
        int ctx = 0;
        if (avail_u) ctx += skip[mi(mi_row - 1, mi_col)];
        if (avail_l) ctx += skip[mi(mi_row, mi_col - 1)];
        is_skip = sd.symbol(cdf.skip[ctx], 2);
    }

    void read_cdef() {
        if (is_skip || fr.coded_lossless || !seq.enable_cdef || fr.allow_intrabc) return;
        const int idx = seq.sb128 ? (((mi_row >> 4) & 1) * 2 + ((mi_col >> 4) & 1)) : 0;  // the 64² area
        if (cdef_idx[idx] == -1) {
            cdef_idx[idx] = sd.literal(fr.cdef_bits);
            // a 128² block covers all four 64² areas
            if (seq.sb128 && bsize == BLOCK_128X128) for (int& k : cdef_idx) k = cdef_idx[idx];
            else if (seq.sb128 && bsize == BLOCK_128X64) cdef_idx[idx ^ 1] = cdef_idx[idx];
            else if (seq.sb128 && bsize == BLOCK_64X128) cdef_idx[idx ^ 2] = cdef_idx[idx];
        }
    }

    void read_delta_qindex() {
        const int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (bsize == sb && is_skip) return;
        if (!read_deltas) return;
        int abs = sd.symbol(cdf.delta_q, 4);
        if (abs == 3) {
            const int rem = sd.literal(3) + 1;
            abs = sd.literal(rem) + (1 << rem) + 1;
        }
        if (abs) {
            const int sign = sd.literal(1);
            const int reduced = sign ? -abs : abs;
            current_q = clip3(1, 255, current_q + (reduced << fr.delta_q_res));
            tools |= TOOL_DELTA_Q;
        }
    }

    void read_delta_lf() {
        const int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
        if (bsize == sb && is_skip) return;
        if (!read_deltas || !fr.delta_lf_present) return;
        const int count = fr.delta_lf_multi ? (num_planes > 1 ? 4 : 2) : 1;
        for (int i = 0; i < count; ++i) {
            uint16_t* c = fr.delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
            int abs = sd.symbol(c, 4);
            if (abs == 3) {
                const int n = sd.literal(3) + 1;
                abs = sd.literal(n) + (1 << n) + 1;
            }
            if (abs) {
                const int sign = sd.literal(1);
                const int reduced = sign ? -abs : abs;
                delta_lf[i] = clip3(-63, 63, delta_lf[i] + (reduced << fr.delta_lf_res));
                tools |= fr.delta_lf_multi ? (TOOL_DELTA_LF | TOOL_DELTA_LF_MULTI) : TOOL_DELTA_LF;
            }
        }
    }

    // ---- transform size (5.11.15-17)
    // the neighbours' transform sizes (get_above_tx_width and
    // get_left_tx_height: a skipped inter block's size, else InterTxSizes)
    int above_tx_width(int r, int c) const {
        if (r == mi_row) {
            if (!avail_u) return 64;
            const size_t k = mi(r - 1, c);
            if (skip[k] && is_inters[k]) return kBlockW[mi_size[k]];
        }
        return kTxW[tx_size[mi(r - 1, c)]];
    }
    int left_tx_height(int r, int c) const {
        if (c == mi_col) {
            if (!avail_l) return 64;
            const size_t k = mi(r, c - 1);
            if (skip[k] && is_inters[k]) return kBlockH[mi_size[k]];
        }
        return kTxH[tx_size[mi(r, c - 1)]];
    }

    void read_var_tx_size(int r, int c, int t, int depth) {
        if (r >= fr.mi_rows || c >= fr.mi_cols) return;
        int split = 0;
        if (t != TX_4X4 && depth < 2) {
            const int above = above_tx_width(r, c) < kTxW[t], left = left_tx_height(r, c) < kTxH[t];
            const int size = std::min(64, std::max(kBlockW[bsize], kBlockH[bsize]));
            const int max_sq = tx_of(size, size);
            const int ctx = (tx_sqr_up(t) != max_sq) * 3 + (4 - max_sq) * 6 + above + left;
            split = sd.symbol(cdf.txfm_split[ctx], 2);
        }
        const int w4 = kTxW[t] >> 2, h4 = kTxH[t] >> 2;
        if (split) {
            const int sub = kTxSplit[t];
            for (int i = 0; i < h4; i += kTxH[sub] >> 2)
                for (int j = 0; j < w4; j += kTxW[sub] >> 2) read_var_tx_size(r + i, c + j, sub, depth + 1);
        } else {
            for (int i = 0; i < h4; ++i)
                for (int j = 0; j < w4; ++j)
                    if (r + i < fr.mi_rows && c + j < fr.mi_cols) tx_size[mi(r + i, c + j)] = static_cast<uint8_t>(t);
            txsz = t;
        }
    }

    void read_block_tx_size() {
        if (lossless) {
            txsz = TX_4X4;
            if (use_intrabc) fill_inter_tx(txsz);
            return;
        }
        const int max_rect = max_tx_rect(bsize);
        txsz = max_rect;
        if (use_intrabc) {
            if (fr.tx_mode_select && bsize > BLOCK_4X4 && !is_skip) {
                for (int r = mi_row; r < mi_row + bh4; r += kTxH[max_rect] >> 2)
                    for (int c = mi_col; c < mi_col + bw4; c += kTxW[max_rect] >> 2) read_var_tx_size(r, c, max_rect, 0);
            } else {
                fill_inter_tx(txsz);
            }
            return;
        }
        if (bsize > BLOCK_4X4 && fr.tx_mode_select) {
            int depth_to_4 = 0;
            for (int t = max_rect; t != TX_4X4; t = kTxSplit[t]) ++depth_to_4;
            const int cat = depth_to_4 - 1;
            const int max_depth = std::min(depth_to_4, 2);
            int above_w = 0, left_h = 0;
            if (avail_u) {
                const size_t k = mi(mi_row - 1, mi_col);
                above_w = is_inters[k] ? kBlockW[mi_size[k]] : above_tx_width(mi_row, mi_col);
            }
            if (avail_l) {
                const size_t k = mi(mi_row, mi_col - 1);
                left_h = is_inters[k] ? kBlockH[mi_size[k]] : left_tx_height(mi_row, mi_col);
            }
            const int ctx = (above_w >= kTxW[max_rect]) + (left_h >= kTxH[max_rect]);
            const int depth = sd.symbol(cdf.tx_size[cat][ctx], max_depth + 1);
            for (int i = 0; i < depth; ++i) txsz = kTxSplit[txsz];
        }
    }

    void fill_inter_tx(int t) {
        for (int r = mi_row; r < std::min(mi_row + bh4, fr.mi_rows); ++r)
            for (int c = mi_col; c < std::min(mi_col + bw4, fr.mi_cols); ++c) tx_size[mi(r, c)] = static_cast<uint8_t>(t);
    }

    void reset_block_context() {
        for (int p = 0; p < (has_chroma ? num_planes : 1); ++p) {
            const int sx = p ? subx : 0, sy = p ? suby : 0;
            for (int i = mi_col >> sx; i < ((mi_col + bw4) >> sx); ++i) {
                above_level[p][i] = 0;
                above_dc[p][i] = 0;
            }
            for (int i = mi_row >> sy; i < ((mi_row + bh4) >> sy); ++i) {
                left_level[p][i] = 0;
                left_dc[p][i] = 0;
            }
        }
    }
    // ---- residual and reconstruction (5.11.34-35, 7.11, 7.12, 7.13)
    int uv_tx_size() const {
        const int uvt = max_tx_rect(plane_bsize(bsize, 1));
        if (kTxW[uvt] == 64 || kTxH[uvt] == 64) {
            if (kTxW[uvt] == 16) return TX_16X32;
            if (kTxH[uvt] == 16) return TX_32X16;
            return TX_32X32;
        }
        return uvt;
    }

    void residual() {
        const int wchunks = std::max(1, kBlockW[bsize] >> 6), hchunks = std::max(1, kBlockH[bsize] >> 6);
        for (int cy = 0; cy < hchunks; ++cy)
            for (int cx = 0; cx < wchunks; ++cx) {
                for (int p = 0; p < 1 + (has_chroma ? 2 : 0); ++p) {
                    const int t = lossless ? TX_4X4 : (p ? uv_tx_size() : txsz);
                    const int step_x = kTxW[t] >> 2, step_y = kTxH[t] >> 2;
                    const int pbs = plane_bsize(bsize, p);
                    const int n4w = kBlockW[pbs] >> 2, n4h = kBlockH[pbs] >> 2;
                    const int sx = p ? subx : 0, sy = p ? suby : 0;
                    const int base_x = (mi_col >> sx) * 4, base_y = (mi_row >> sy) * 4;
                    if (use_intrabc && !lossless && p == 0) {  // the var-tx tree, a 64² chunk at a time
                        const int max_rect = max_tx_rect(bsize);
                        const int cw = std::min(kBlockW[bsize], 64), ch = std::min(kBlockH[bsize], 64);
                        for (int y = 0; y < ch; y += kTxH[max_rect])
                            for (int x = 0; x < cw; x += kTxW[max_rect])
                                transform_tree(base_x + (cx << 6) + x, base_y + (cy << 6) + y, kTxW[max_rect],
                                               kTxH[max_rect]);
                        continue;
                    }
                    for (int y = 0; y < std::min(n4h, 16 >> sy); y += step_y)
                        for (int x = 0; x < std::min(n4w, 16 >> sx); x += step_x)
                            transform_block(p, base_x, base_y, t, x + ((cx << 4) >> sx), y + ((cy << 4) >> sy));
                }
            }
    }

    void transform_tree(int x, int y, int w, int h) {
        if (x >= fr.mi_cols * 4 || y >= fr.mi_rows * 4) return;
        const int t = tx_size[mi(y >> 2, x >> 2)];
        if (w <= kTxW[t] && h <= kTxH[t]) {
            transform_block(0, x, y, tx_of(w, h), 0, 0);
        } else if (w > h) {
            transform_tree(x, y, w / 2, h);
            transform_tree(x + w / 2, y, w / 2, h);
        } else if (w < h) {
            transform_tree(x, y, w, h / 2);
            transform_tree(x, y + h / 2, w, h / 2);
        } else {
            transform_tree(x, y, w / 2, h / 2);
            transform_tree(x + w / 2, y, w / 2, h / 2);
            transform_tree(x, y + h / 2, w / 2, h / 2);
            transform_tree(x + w / 2, y + h / 2, w / 2, h / 2);
        }
    }

    void transform_block(int plane, int base_x, int base_y, int t, int x, int y) {
        const int sx = plane ? subx : 0, sy = plane ? suby : 0;
        const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
        const int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
        const int sb_mask = seq.sb128 ? 31 : 15;
        const int sub_r = row & sb_mask, sub_c = col & sb_mask;
        const int step_x = kTxW[t] >> 2, step_y = kTxH[t] >> 2;
        const int max_x = (fr.mi_cols * 4) >> sx, max_y = (fr.mi_rows * 4) >> sy;
        if (start_x >= max_x || start_y >= max_y) return;
        const bool is_cfl = plane > 0 && uvmode == UV_CFL_PRED;
        int mode;
        if (plane == 0) mode = ymode;
        else mode = is_cfl ? DC_PRED : uvmode;
        const int by = (sub_r >> sy), bx = (sub_c >> sx);
        const bool have_left = (plane == 0 ? avail_l : avail_l_chroma) || x > 0;
        const bool have_above = (plane == 0 ? avail_u : avail_u_chroma) || y > 0;
        const bool have_above_right = block_decoded[plane][by - 1 + 1][bx + step_x + 1];
        const bool have_below_left = block_decoded[plane][by + step_y + 1][bx - 1 + 1];
        if (use_intrabc) {
            // predicted for the whole block (predict_intrabc)
        } else if (pal_n[plane > 0]) {
            predict_palette(plane, start_x, start_y, x, y, t);
        } else {
            predict_intra(plane, start_x, start_y, have_left, have_above, have_above_right, have_below_left, mode,
                          log2i(kTxW[t]), log2i(kTxH[t]));
            if (is_cfl) predict_cfl(plane, start_x, start_y, t);
        }
        if (plane == 0) {
            max_luma_w = start_x + step_x * 4;
            max_luma_h = start_y + step_y * 4;
        }
        if (!is_skip) {
            const int eob = coeffs(start_x, start_y, plane, t);
            if (eob > 0) reconstruct(plane, start_x, start_y, t);
        }
        for (int i = 0; i < step_y; ++i)
            for (int j = 0; j < step_x; ++j) {
                const size_t li = static_cast<size_t>((row >> sy) + i) * lf_stride[plane] + (col >> sx) + j;
                if (li < lf_tx[plane].size()) lf_tx[plane][li] = static_cast<uint8_t>(t);
                if (by + i + 1 < 34 && bx + j + 1 < 34) block_decoded[plane][by + i + 1][bx + j + 1] = 1;
            }
        const int tw = kTxW[t], th = kTxH[t];
        tools |= tw == 4 || th == 4 ? TOOL_TX4 : 0;
        tools |= std::max(tw, th) == 8 ? TOOL_TX8 : 0;
        tools |= std::max(tw, th) == 16 ? TOOL_TX16 : 0;
        tools |= std::max(tw, th) == 32 ? TOOL_TX32 : 0;
        tools |= std::max(tw, th) == 64 ? TOOL_TX64 : 0;
        tools |= tw != th ? TOOL_TX_RECT : 0;
    }

    // ---- intra prediction (7.11.2)
    int filter_type(int plane) {
        auto smooth = [&](int r, int c, int p) {
            const int m = p == 0 ? y_mode[mi(r, c)] : uv_mode[mi(r, c)];
            return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
        };
        bool above = false, left = false;
        if (plane == 0 ? avail_u : avail_u_chroma) {
            int r = mi_row - 1, c = mi_col;
            if (plane > 0) {
                if (subx && !(mi_col & 1)) ++c;
                if (suby && (mi_row & 1)) --r;
            }
            above = smooth(r, c, plane);
        }
        if (plane == 0 ? avail_l : avail_l_chroma) {
            int r = mi_row, c = mi_col - 1;
            if (plane > 0) {
                if (subx && (mi_col & 1)) --c;
                if (suby && !(mi_row & 1)) ++r;
            }
            left = smooth(r, c, plane);
        }
        return above || left;
    }

    static int edge_strength(int w, int h, int type, int delta) {
        const int d = std::abs(delta), wh = w + h;
        int s = 0;
        if (type == 0) {
            if (wh <= 8) { if (d >= 56) s = 1; }
            else if (wh <= 12) { if (d >= 40) s = 1; }
            else if (wh <= 16) { if (d >= 40) s = 1; }
            else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
            else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
            else { if (d >= 1) s = 3; }
        } else {
            if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
            else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
            else if (wh <= 24) { if (d >= 4) s = 3; }
            else { if (d >= 1) s = 3; }
        }
        return s;
    }

    static bool use_upsample(int w, int h, int type, int delta) {
        const int d = std::abs(delta), wh = w + h;
        if (d <= 0 || d >= 40) return false;
        return type ? wh <= 8 : wh <= 16;
    }

    static void edge_filter(int* buf, int size, int strength) {  // buf[-1 .. size-2] filtered from index -1
        if (!strength) return;
        static const int kernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
        int edge[160];
        for (int i = 0; i < size; ++i) edge[i] = buf[i - 1];
        for (int i = 1; i < size; ++i) {
            int s = 0;
            for (int j = 0; j < 5; ++j) s += kernel[strength - 1][j] * edge[clip3(0, size - 1, i - 2 + j)];
            buf[i - 1] = (s + 8) >> 4;
        }
    }

    static void edge_upsample(int* buf, int num) {
        int dup[80];
        dup[0] = buf[-1];
        for (int i = -1; i < num; ++i) dup[i + 2] = buf[i];
        dup[num + 2] = buf[num - 1];
        buf[-2] = dup[0];
        for (int i = 0; i < num; ++i) {
            int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
            s = clip3(0, 255, round2(s, 4));
            buf[2 * i - 1] = s;
            buf[2 * i] = dup[i + 2];
        }
    }

    void predict_intra(int plane, int x, int y, bool have_left, bool have_above, bool have_above_right,
                       bool have_below_left, int mode, int log2w, int log2h) {
        Plane& pl = planes[plane];
        const int w = 1 << log2w, h = 1 << log2h;
        const int sx = plane ? subx : 0, sy = plane ? suby : 0;
        const int max_x = ((fr.mi_cols * 4) >> sx) - 1, max_y = ((fr.mi_rows * 4) >> sy) - 1;
        int above_buf[288], left_buf[288];
        int* above = above_buf + 16;
        int* left = left_buf + 16;
        const int n = w + h;
        if (!have_above && have_left) {
            for (int i = 0; i < n; ++i) above[i] = pl.at(y, x - 1);
        } else if (!have_above && !have_left) {
            for (int i = 0; i < n; ++i) above[i] = 127;
        } else {
            const int limit = std::min(max_x, x + (have_above_right ? 2 * w : w) - 1);
            for (int i = 0; i < n; ++i) above[i] = pl.at(y - 1, std::min(limit, x + i));
        }
        if (!have_left && have_above) {
            for (int i = 0; i < n; ++i) left[i] = pl.at(y - 1, x);
        } else if (!have_left && !have_above) {
            for (int i = 0; i < n; ++i) left[i] = 129;
        } else {
            const int limit = std::min(max_y, y + (have_below_left ? 2 * h : h) - 1);
            for (int i = 0; i < n; ++i) left[i] = pl.at(std::min(limit, y + i), x - 1);
        }
        if (have_above && have_left) above[-1] = pl.at(y - 1, x - 1);
        else if (have_above) above[-1] = pl.at(y - 1, x);
        else if (have_left) above[-1] = pl.at(y, x - 1);
        else above[-1] = 128;
        left[-1] = above[-1];
        int pred[64][64];
        if (plane == 0 && use_filter_intra) {
            const int8_t* taps = kFilterIntraTaps + filter_mode * 64;
            for (int i2 = 0; i2 < (h >> 1); ++i2)
                for (int j4 = 0; j4 < (w >> 2); ++j4) {
                    int p[7];
                    for (int i = 0; i < 7; ++i) {
                        if (i < 5) {
                            if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
                            else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
                            else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
                        } else {
                            if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
                            else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
                        }
                    }
                    for (int i = 0; i < 8; ++i) {
                        int pr = 0;
                        for (int j = 0; j < 7; ++j) pr += taps[i * 8 + j] * p[j];
                        pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip3(0, 255, round2signed(pr, 4));
                    }
                }
        } else if (directional(mode)) {
            const int angle_delta = plane == 0 ? angle_y : angle_uv;
            const int p_angle = kModeToAngle[mode] + angle_delta * 3;
            int up_above = 0, up_left = 0;
            tools |= (mode == V_PRED || mode == H_PRED) && !angle_delta ? TOOL_VH : TOOL_DIRECTIONAL;
            if (seq.enable_intra_edge_filter) {
                const int type = filter_type(plane);
                if (p_angle != 90 && p_angle != 180) {
                    if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
                        above[-1] = left[-1] = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
                    }
                    if (have_above) {
                        const int s = edge_strength(w, h, type, p_angle - 90);
                        const int num = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
                        if (s) tools |= TOOL_EDGE_FILTER;
                        edge_filter(above, num, s);
                    }
                    if (have_left) {
                        const int s = edge_strength(w, h, type, p_angle - 180);
                        const int num = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
                        if (s) tools |= TOOL_EDGE_FILTER;
                        edge_filter(left, num, s);
                    }
                }
                up_above = use_upsample(w, h, type, p_angle - 90);
                if (up_above) edge_upsample(above, w + (p_angle < 90 ? h : 0));
                up_left = use_upsample(w, h, type, p_angle - 180);
                if (up_left) edge_upsample(left, h + (p_angle > 180 ? w : 0));
                if (up_above || up_left) tools |= TOOL_EDGE_UPSAMPLE;
            }
            int dx = 0, dy = 0;
            if (p_angle < 90) dx = kDrIntraDerivative[p_angle];
            else if (p_angle > 90 && p_angle < 180) dx = kDrIntraDerivative[180 - p_angle];
            if (p_angle > 90 && p_angle < 180) dy = kDrIntraDerivative[p_angle - 90];
            else if (p_angle > 180) dy = kDrIntraDerivative[270 - p_angle];
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j) {
                    int v;
                    if (p_angle == 90) {
                        v = above[j];
                    } else if (p_angle == 180) {
                        v = left[i];
                    } else if (p_angle < 90) {
                        const int idx = (i + 1) * dx;
                        const int base = (idx >> (6 - up_above)) + (j << up_above);
                        const int shift = ((idx << up_above) >> 1) & 0x1f;
                        const int max_base = (w + h - 1) << up_above;
                        if (base < max_base) v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        else v = above[max_base];
                    } else if (p_angle < 180) {
                        int idx = (j << 6) - (i + 1) * dx;
                        int base = idx >> (6 - up_above);
                        if (base >= -(1 << up_above)) {
                            const int shift = ((idx * (1 << up_above)) >> 1) & 0x1f;
                            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
                        } else {
                            idx = (i << 6) - (j + 1) * dy;
                            base = idx >> (6 - up_left);
                            const int shift = ((idx * (1 << up_left)) >> 1) & 0x1f;
                            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        }
                    } else {
                        const int idx = (j + 1) * dy;
                        const int base = (idx >> (6 - up_left)) + (i << up_left);
                        const int shift = ((idx << up_left) >> 1) & 0x1f;
                        const int max_base = (w + h - 1) << up_left;
                        if (base < max_base) v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
                        else v = left[max_base];
                    }
                    pred[i][j] = v;
                }
        } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
            tools |= TOOL_SMOOTH;
            const uint8_t* wx = kSmoothWeights + (w - 2);
            const uint8_t* wy = kSmoothWeights + (h - 2);
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j) {
                    if (mode == SMOOTH_PRED) {
                        const int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] +
                                      (256 - wx[j]) * above[w - 1];
                        pred[i][j] = round2(s, 9);
                    } else if (mode == SMOOTH_V_PRED) {
                        pred[i][j] = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
                    } else {
                        pred[i][j] = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
                    }
                }
        } else if (mode == DC_PRED) {
            tools |= TOOL_DC;
            int avg;
            if (have_above && have_left) {
                int sum = 0;
                for (int k = 0; k < w; ++k) sum += above[k];
                for (int k = 0; k < h; ++k) sum += left[k];
                avg = (sum + ((w + h) >> 1)) / (w + h);
            } else if (have_above) {
                int sum = 0;
                for (int k = 0; k < w; ++k) sum += above[k];
                avg = (sum + (w >> 1)) >> log2w;
            } else if (have_left) {
                int sum = 0;
                for (int k = 0; k < h; ++k) sum += left[k];
                avg = (sum + (h >> 1)) >> log2h;
            } else {
                avg = 128;
            }
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j) pred[i][j] = avg;
        } else {  // PAETH
            tools |= TOOL_PAETH;
            for (int i = 0; i < h; ++i)
                for (int j = 0; j < w; ++j) {
                    const int base = above[j] + left[i] - above[-1];
                    const int p_left = std::abs(base - left[i]), p_top = std::abs(base - above[j]);
                    const int p_tl = std::abs(base - above[-1]);
                    if (p_left <= p_top && p_left <= p_tl) pred[i][j] = left[i];
                    else if (p_top <= p_tl) pred[i][j] = above[j];
                    else pred[i][j] = above[-1];
                }
        }
        for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) pl.at(y + i, x + j) = static_cast<uint8_t>(pred[i][j]);
    }

    void predict_cfl(int plane, int start_x, int start_y, int t) {
        const int w = kTxW[t], h = kTxH[t];
        const int alpha = plane == 1 ? cfl_u : cfl_v;
        int sum = 0;
        for (int i = 0; i < h; ++i) {
            const int luma_y = std::min((start_y + i) << suby, max_luma_h - (1 << suby));
            for (int j = 0; j < w; ++j) {
                const int luma_x = std::min((start_x + j) << subx, max_luma_w - (1 << subx));
                int tt = 0;
                for (int dy = 0; dy <= suby; ++dy)
                    for (int dx = 0; dx <= subx; ++dx) tt += planes[0].at(luma_y + dy, luma_x + dx);
                const int v = tt << (3 - subx - suby);
                lbuf[i][j] = v;
                sum += v;
            }
        }
        const int avg = round2(sum, log2i(w) + log2i(h));
        Plane& pl = planes[plane];
        for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) {
                const int dc = pl.at(start_y + i, start_x + j);
                const int scaled = round2signed(alpha * (lbuf[i][j] - avg), 6);
                pl.at(start_y + i, start_x + j) = static_cast<uint8_t>(clip3(0, 255, dc + scaled));
            }
    }

    // ---- coefficients (5.11.39)
    int plane_tx_type = 0;

    int get_tx_set(int t) const {
        if (tx_sqr_up(t) > TX_32X32) return TX_SET_DCTONLY;
        if (use_intrabc) {
            if (fr.reduced_tx_set || tx_sqr_up(t) == TX_32X32) return TX_SET_INTER_3;
            return tx_sqr(t) == TX_16X16 ? TX_SET_INTER_2 : TX_SET_INTER_1;
        }
        if (tx_sqr_up(t) == TX_32X32) return TX_SET_DCTONLY;
        if (fr.reduced_tx_set) return TX_SET_INTRA_2;
        if (tx_sqr(t) == TX_16X16) return TX_SET_INTRA_2;
        return TX_SET_INTRA_1;
    }

    void scan_of(int t, int type, std::vector<int>& scan) const {
        int w = std::min(kTxW[t], 32), h = std::min(kTxH[t], 32);
        if (t == TX_16X64) { w = 16; h = 32; }
        if (t == TX_64X16) { w = 32; h = 16; }
        scan.clear();
        const bool big = tx_sqr_up(t) == TX_64X64;
        const bool pref_row = !big && (type == V_DCT || type == V_ADST || type == V_FLIPADST);
        const bool pref_col = !big && (type == H_DCT || type == H_ADST || type == H_FLIPADST);
        if (pref_row) {
            for (int i = 0; i < w * h; ++i) scan.push_back(i);
        } else if (pref_col) {
            for (int c = 0; c < w; ++c)
                for (int r = 0; r < h; ++r) scan.push_back(r * w + c);
        } else {
            for (int d = 0; d < w + h - 1; ++d) {
                const int lo = std::max(0, d - (w - 1)), hi = std::min(d, h - 1);
                const bool reverse = (w == h && d % 2 == 0) || w > h;
                if (reverse)
                    for (int r = hi; r >= lo; --r) scan.push_back(r * w + d - r);
                else
                    for (int r = lo; r <= hi; ++r) scan.push_back(r * w + d - r);
            }
        }
    }

    int coeffs(int start_x, int start_y, int plane, int t) {
        const int sx = plane ? subx : 0, sy = plane ? suby : 0;
        const int x4 = start_x >> 2, y4 = start_y >> 2;
        const int w4 = kTxW[t] >> 2, h4 = kTxH[t] >> 2;
        const int tx_ctx = (tx_sqr(t) + tx_sqr_up(t) + 1) >> 1;
        const int ptype = plane > 0;
        const int seg_eob = (t == TX_16X64 || t == TX_64X16) ? 512 : std::min(1024, kTxW[t] * kTxH[t]);
        std::memset(quant, 0, sizeof(int32_t) * seg_eob);
        std::memset(levels, 0, sizeof levels);
        int eob = 0, cul_level = 0, dc_category = 0;
        const int max_x4 = fr.mi_cols >> sx, max_y4 = fr.mi_rows >> sy;
        // the all-zero context
        int ctx;
        if (plane == 0) {
            int top = 0, left = 0;
            for (int k = 0; k < w4; ++k)
                if (x4 + k < max_x4) top = std::max(top, int(above_level[plane][x4 + k]));
            for (int k = 0; k < h4; ++k)
                if (y4 + k < max_y4) left = std::max(left, int(left_level[plane][y4 + k]));
            top = std::min(top, 255);
            left = std::min(left, 255);
            if (kBlockW[bsize] == kTxW[t] && kBlockH[bsize] == kTxH[t]) ctx = 0;
            else if (top == 0 && left == 0) ctx = 1;
            else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
            else if (std::max(top, left) <= 3) ctx = 4;
            else if (std::min(top, left) <= 3) ctx = 5;
            else ctx = 6;
        } else {
            int above = 0, left = 0;
            for (int i = 0; i < w4; ++i)
                if (x4 + i < max_x4) above |= above_level[plane][x4 + i] | above_dc[plane][x4 + i];
            for (int i = 0; i < h4; ++i)
                if (y4 + i < max_y4) left |= left_level[plane][y4 + i] | left_dc[plane][y4 + i];
            ctx = (above != 0) + (left != 0) + 7;
            const int pbs = plane_bsize(bsize, plane);
            if (kBlockW[pbs] * kBlockH[pbs] > kTxW[t] * kTxH[t]) ctx += 3;
        }
        const int all_zero = sd.symbol(cdf.txb_skip[std::min(tx_ctx, 4)][ctx], 2);
        if (!all_zero) {
            // the transform type
            if (plane == 0) {
                const int set = get_tx_set(t);
                const int q = fr.seg_enabled ? qindex_of(fr, segment, current_q, true) : fr.base_q;
                int type = DCT_DCT;
                if (set > 0 && q > 0 && use_intrabc) {
                    if (set == TX_SET_INTER_1) type = kTxTypeInterInvSet1[sd.symbol(cdf.inter_set1[tx_sqr(t)], 16)];
                    else if (set == TX_SET_INTER_2) type = kTxTypeInterInvSet2[sd.symbol(cdf.inter_set2, 12)];
                    else type = sd.symbol(cdf.inter_set3[tx_sqr(t)], 2) ? DCT_DCT : IDTX;
                } else if (set > 0 && q > 0) {
                    static const int kFilterDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
                    const int dir = use_filter_intra ? kFilterDir[filter_mode] : ymode;
                    if (set == TX_SET_INTRA_1) type = kTxIntraInvSet1[sd.symbol(cdf.tx_set1[tx_sqr(t)][dir], 7)];
                    else type = kTxIntraInvSet2[sd.symbol(cdf.tx_set2[tx_sqr(t)][dir], 5)];
                }
                plane_tx_type = lossless || tx_sqr_up(t) > TX_32X32 ? DCT_DCT : type;
                set_tx_types(x4, y4, w4, h4, plane_tx_type);
            } else {
                if (lossless || tx_sqr_up(t) > TX_32X32) {
                    plane_tx_type = DCT_DCT;
                } else if (use_intrabc) {  // the luma type at the block's position (compute_tx_type)
                    const int type = tx_types[mi(std::max(mi_row, (y4 << sy)), std::max(mi_col, (x4 << sx)))];
                    plane_tx_type = in_inter_set(get_tx_set(t), type) ? type : DCT_DCT;
                } else {
                    const int type = kModeToTxfm[uvmode];
                    plane_tx_type = in_intra_set(get_tx_set(t), type) ? type : DCT_DCT;
                }
            }
            std::vector<int>& scan = scan_buf;
            scan_of(t, plane_tx_type, scan);
            const int eob_multi = std::min(log2i(kTxW[t]), 5) + std::min(log2i(kTxH[t]), 5) - 4;
            const int ectx = tx_class(plane_tx_type) == TX_CLASS_2D ? 0 : 1;
            int eob_pt;
            switch (eob_multi) {
                case 0: eob_pt = sd.symbol(cdf.eob16[ptype][ectx], 5) + 1; break;
                case 1: eob_pt = sd.symbol(cdf.eob32[ptype][ectx], 6) + 1; break;
                case 2: eob_pt = sd.symbol(cdf.eob64[ptype][ectx], 7) + 1; break;
                case 3: eob_pt = sd.symbol(cdf.eob128[ptype][ectx], 8) + 1; break;
                case 4: eob_pt = sd.symbol(cdf.eob256[ptype][ectx], 9) + 1; break;
                case 5: eob_pt = sd.symbol(cdf.eob512[ptype][ectx], 10) + 1; break;
                default: eob_pt = sd.symbol(cdf.eob1024[ptype][ectx], 11) + 1; break;
            }
            eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
            int eob_shift = eob_pt - 3;
            if (eob_shift >= 0) {
                if (sd.symbol(cdf.eob_extra[std::min(tx_ctx, 4)][ptype][eob_pt - 3], 2)) eob += 1 << eob_shift;
                for (int i = 1; i < std::max(1, eob_pt - 2); ++i) {
                    eob_shift = std::max(0, eob_pt - 2) - 1 - i;
                    if (sd.literal(1)) eob += 1 << eob_shift;
                }
            }
            if (eob > seg_eob) broken("an end of block past the transform");
            const int adj_w = std::min(kTxW[t], 32), adj_h = std::min(kTxH[t], 32);
            const int bwl = log2i(t == TX_16X64 ? 16 : adj_w);
            const int txh = t == TX_64X16 ? 16 : adj_h;
            const int txw = 1 << bwl;
            const int cls = tx_class(plane_tx_type);
            for (int c = eob - 1; c >= 0; --c) {
                const int pos = scan[c];
                const int row = pos >> bwl, col = pos - (row << bwl);
                int level;
                if (c == eob - 1) {
                    int ectx2;
                    if (c == 0) ectx2 = 0;
                    else if (c <= (txh << bwl) / 8) ectx2 = 1;
                    else if (c <= (txh << bwl) / 4) ectx2 = 2;
                    else ectx2 = 3;
                    level = sd.symbol(cdf.base_eob[std::min(tx_ctx, 4)][ptype][ectx2], 3) + 1;
                } else {
                    level = sd.symbol(cdf.base[std::min(tx_ctx, 4)][ptype][base_ctx(t, row, col, cls, txw, txh)], 4);
                }
                if (level > 2) {
                    const int bctx = br_ctx(row, col, cls, txw, txh, pos);
                    for (int idx = 0; idx < 4; ++idx) {
                        const int k = sd.symbol(cdf.br[std::min(tx_ctx, 3)][ptype][bctx], 4);
                        level += k;
                        if (k < 3) break;
                    }
                }
                quant[pos] = level;
                levels[row][col] = static_cast<uint8_t>(level);
            }
            for (int c = 0; c < eob; ++c) {
                const int pos = scan[c];
                int sign = 0;
                if (quant[pos]) {
                    if (c == 0) {
                        int dc_sign = 0;
                        for (int k = 0; k < w4; ++k)
                            if (x4 + k < max_x4) {
                                const int s = above_dc[plane][x4 + k];
                                if (s == 1) --dc_sign;
                                else if (s == 2) ++dc_sign;
                            }
                        for (int k = 0; k < h4; ++k)
                            if (y4 + k < max_y4) {
                                const int s = left_dc[plane][y4 + k];
                                if (s == 1) --dc_sign;
                                else if (s == 2) ++dc_sign;
                            }
                        const int dctx = dc_sign < 0 ? 1 : (dc_sign > 0 ? 2 : 0);
                        sign = sd.symbol(cdf.dc_sign[ptype][dctx], 2);
                    } else {
                        sign = sd.literal(1);
                    }
                }
                if (quant[pos] > 14) {
                    int length = 0, bit;
                    do {
                        ++length;
                        bit = sd.literal(1);
                        if (length > 32) broken("a Golomb code too long");
                    } while (!bit);
                    int x = 1;
                    for (int i = length - 2; i >= 0; --i) x = (x << 1) | sd.literal(1);
                    quant[pos] = x + 14;
                }
                if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
                quant[pos] &= 0xFFFFF;
                cul_level += quant[pos];
                if (sign) quant[pos] = -quant[pos];
            }
            cul_level = std::min(63, cul_level);
        } else if (plane == 0) {
            set_tx_types(x4, y4, w4, h4, DCT_DCT);
        }
        for (int i = 0; i < w4; ++i) {
            above_level[plane][x4 + i] = static_cast<uint8_t>(cul_level);
            above_dc[plane][x4 + i] = static_cast<uint8_t>(dc_category);
        }
        for (int i = 0; i < h4; ++i) {
            left_level[plane][y4 + i] = static_cast<uint8_t>(cul_level);
            left_dc[plane][y4 + i] = static_cast<uint8_t>(dc_category);
        }
        return eob;
    }

    std::vector<int> scan_buf;

    void set_tx_types(int x4, int y4, int w4, int h4, int type) {
        for (int i = 0; i < h4; ++i)
            for (int j = 0; j < w4; ++j)
                if (y4 + i < fr.mi_rows && x4 + j < fr.mi_cols) tx_types[mi(y4 + i, x4 + j)] = static_cast<uint8_t>(type);
    }

    int base_ctx(int t, int row, int col, int cls, int txw, int txh) {
        static const int offs[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                          {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                          {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
        int mag = 0;
        for (int k = 0; k < 5; ++k) {
            const int rr = row + offs[cls][k][0], cc = col + offs[cls][k][1];
            if (rr < txh && cc < txw) mag += std::min<int>(levels[rr][cc], 3);
        }
        const int ctx = std::min((mag + 1) >> 1, 4);
        if (cls == TX_CLASS_2D) {
            if (row == 0 && col == 0) return 0;
            static const int lo[3][5][5] = {
                {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}},
                {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21},
                 {16, 16, 21, 21, 21}},
                {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21},
                 {21, 21, 21, 21, 21}}};
            const int w = kTxW[t], h = kTxH[t];
            const int shape = w == h ? 0 : (w > h ? 1 : 2);
            return ctx + lo[shape][std::min(row, 4)][std::min(col, 4)];
        }
        const int idx = cls == TX_CLASS_VERT ? row : col;
        static const int pos_offset[3] = {26, 31, 36};
        return ctx + pos_offset[std::min(idx, 2)];
    }

    int br_ctx(int row, int col, int cls, int txw, int txh, int pos) {
        static const int offs[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}}, {{0, 1}, {1, 0}, {2, 0}}};
        int mag = 0;
        for (int k = 0; k < 3; ++k) {
            const int rr = row + offs[cls][k][0], cc = col + offs[cls][k][1];
            if (rr < txh && cc < txw) mag += std::min<int>(levels[rr][cc], 15);
        }
        mag = std::min((mag + 1) >> 1, 6);
        if (pos == 0) return mag;
        if (cls == TX_CLASS_2D) return (row < 2 && col < 2) ? mag + 7 : mag + 14;
        if (cls == TX_CLASS_HORIZ) return col == 0 ? mag + 7 : mag + 14;
        return row == 0 ? mag + 7 : mag + 14;
    }

    // ---- dequantisation and the 2D inverse transform (7.12.3, 7.13.3)
    // the quantiser matrix of a transform (the 64-point sizes take their
    // 32-point one), or null: a lossless segment's level is 15 (none), and
    // the identity and 1D types skip the matrix, as libaom's
    // IS_2D_TRANSFORM and dav1d's txtp < IDTX have it
    const uint8_t* qmatrix(int plane, int t) const {
        static const int kQmOffset[19] = {0, 16, 80, 336, 336, 1360, 1392, 1424, 1552, 1680, 2192, 336, 336, 2704,
                                          2768, 2832, 3088, 1680, 2192};
        const int level = fr.using_qm && !lossless ? fr.qm_level[plane] : 15;
        if (level >= 15 || plane_tx_type >= IDTX) return nullptr;
        return kQuantizerMatrix[level][plane > 0] + kQmOffset[t];
    }
    int dc_q(int plane) {
        const int q = qindex_of(fr, segment, current_q, false);
        const int d = plane == 0 ? fr.dq_ydc : (plane == 1 ? fr.dq_udc : fr.dq_vdc);
        return kDcQLookup[clip3(0, 255, q + d)];
    }
    int ac_q(int plane) {
        const int q = qindex_of(fr, segment, current_q, false);
        const int d = plane == 0 ? 0 : (plane == 1 ? fr.dq_uac : fr.dq_vac);
        return kAcQLookup[clip3(0, 255, q + d)];
    }

    void reconstruct(int plane, int x, int y, int t) {
        const int w = kTxW[t], h = kTxH[t];
        const int log2w = log2i(w), log2h = log2i(h);
        const int tw = std::min(32, w), th = std::min(32, h);
        const int pels = w * h;
        const int dq_shift = (pels > 256) + (pels > 1024);
        const int dcq = dc_q(plane), acq = ac_q(plane);
        const uint8_t* qm = qmatrix(plane, t);
        if (qm) tools |= TOOL_QM;
        for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) resid[i][j] = 0;
        for (int i = 0; i < th; ++i)
            for (int j = 0; j < tw; ++j) {
                const int q = quant[i * tw + j];
                if (!q) continue;
                int qv = (i == 0 && j == 0) ? dcq : acq;
                // the weights in libaom's coefficient order: column by column
                if (qm) qv = (qv * qm[j * th + i] + 16) >> 5;
                const int64_t mag = static_cast<int64_t>(std::abs(q)) * qv;
                int dq = static_cast<int>((mag & 0xFFFFFF) >> dq_shift);
                if (q < 0) dq = -dq;
                resid[i][j] = clip3(-(1 << 15), (1 << 15) - 1, dq);
            }
        Plane& pl = planes[plane];
        if (lossless) {
            tools |= TOOL_LOSSLESS;
            int tmp[4][4];
            for (int i = 0; i < 4; ++i) {
                int row[4] = {resid[i][0], resid[i][1], resid[i][2], resid[i][3]};
                iwht4(row, 2);
                for (int j = 0; j < 4; ++j) tmp[i][j] = row[j];
            }
            for (int j = 0; j < 4; ++j) {
                int col[4] = {tmp[0][j], tmp[1][j], tmp[2][j], tmp[3][j]};
                iwht4(col, 0);
                for (int i = 0; i < 4; ++i) pl.at(y + i, x + j) = static_cast<uint8_t>(clip3(0, 255, pl.at(y + i, x + j) + col[i]));
            }
            return;
        }
        const int type = plane_tx_type;
        const int vt = kVtx[type], ht = kHtx[type];
        if (vt == T1_DCT && ht == T1_DCT) tools |= TOOL_DCT;
        if (vt == T1_ADST || ht == T1_ADST) tools |= TOOL_ADST;
        if (type == IDTX) tools |= TOOL_IDTX;
        if (tx_class(type) != TX_CLASS_2D) tools |= TOOL_TX_1D;
        // dav1d's clips for 8-bit video: int16 through the rows and columns
        const Clamp row_cl{-(1 << 15), (1 << 15) - 1};
        const Clamp col_cl{-(1 << 15), (1 << 15) - 1};
        const int row_shift = kTxRowShift[t];
        const bool rect2 = std::abs(log2w - log2h) == 1;
        int buf[64];
        for (int i = 0; i < h; ++i) {
            if (i >= 32) {
                for (int j = 0; j < w; ++j) resid[i][j] = 0;
                continue;
            }
            bool any = false;
            for (int j = 0; j < w; ++j) {
                int v = resid[i][j];
                if (rect2) v = round2(int64_t(v) * 2896, 12);
                buf[j] = row_cl(v);
                any |= buf[j] != 0;
            }
            if (any) inverse_1d(buf, w, ht == T1_FLIPADST ? T1_ADST : ht, row_cl);
            for (int j = 0; j < w; ++j) resid[i][j] = col_cl(round2(buf[j], row_shift));
        }
        const bool lr_flip = ht == T1_FLIPADST, ud_flip = vt == T1_FLIPADST;
        for (int j = 0; j < w; ++j) {
            const int sj = lr_flip ? w - 1 - j : j;
            for (int i = 0; i < h; ++i) buf[i] = resid[i][sj];
            inverse_1d(buf, h, vt == T1_FLIPADST ? T1_ADST : vt, col_cl);
            for (int i = 0; i < h; ++i) {
                const int v = round2(buf[ud_flip ? h - 1 - i : i], 4);
                pl.at(y + i, x + j) = static_cast<uint8_t>(clip3(0, 255, pl.at(y + i, x + j) + v));
            }
        }
    }

    // ---- loop restoration: the units' coefficients (5.11.57), read with
    // the superblock whose area holds each unit's top-left corner
    static int count_units(int unit, int size) { return std::max((size + (unit >> 1)) / unit, 1); }

    int subexp(int num_syms, int k) {  // decode_subexp_bool
        int i = 0, mk = 0;
        while (true) {
            const int b2 = i ? k + i - 1 : k, a = 1 << b2;
            if (num_syms <= mk + 3 * a) return sd.ns(num_syms - mk) + mk;
            if (!sd.literal(1)) return sd.literal(b2) + mk;
            ++i;
            mk += a;
        }
    }
    static int inverse_recenter(int r, int v) {
        if (v > 2 * r) return v;
        return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
    }
    int signed_subexp(int low, int high, int k, int r) {  // decode_signed_subexp_with_ref_bool
        const int mx = high - low, rr = r - low;
        const int v = subexp(mx, k);
        const int x = (rr << 1) <= mx ? inverse_recenter(rr, v) : mx - 1 - inverse_recenter(mx - 1 - rr, v);
        return x + low;
    }

    void read_lr(int r, int c, int sb4) {
        if (fr.allow_intrabc) return;
        for (int p = 0; p < num_planes; ++p) {
            if (fr.lr_type[p] == RESTORE_NONE) continue;
            const int sx = p ? subx : 0, sy = p ? suby : 0, unit = fr.lr_size[p];
            const int row0 = (r * (4 >> sy) + unit - 1) / unit;
            const int row1 = std::min(lr_rows[p], ((r + sb4) * (4 >> sy) + unit - 1) / unit);
            const int col0 = (c * (4 >> sx) + unit - 1) / unit;
            const int col1 = std::min(lr_cols[p], ((c + sb4) * (4 >> sx) + unit - 1) / unit);
            for (int ur = row0; ur < row1; ++ur)
                for (int uc = col0; uc < col1; ++uc) read_lr_unit(p, lr_units[p][static_cast<size_t>(ur) * lr_cols[p] + uc]);
        }
    }

    void read_lr_unit(int p, LrUnit& u) {
        if (fr.lr_type[p] == RESTORE_WIENER) {
            u.type = sd.symbol(cdf.restore_wiener, 2) ? RESTORE_WIENER : RESTORE_NONE;
        } else if (fr.lr_type[p] == RESTORE_SGRPROJ) {
            u.type = sd.symbol(cdf.restore_sgrproj, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
        } else {
            u.type = sd.symbol(cdf.restore_switchable, 3);
            tools |= TOOL_SWITCHABLE_LR;
        }
        if (u.type == RESTORE_WIENER) {
            for (int pass = 0; pass < 2; ++pass) {
                u.wiener[pass][0] = 0;
                for (int j = p ? 1 : 0; j < 3; ++j) {
                    const int v = signed_subexp(kWienerTapsMin[j], kWienerTapsMax[j] + 1, kWienerTapsK[j], ref_wiener[p][pass][j]);
                    u.wiener[pass][j] = ref_wiener[p][pass][j] = v;
                }
            }
            tools |= TOOL_WIENER;
        } else if (u.type == RESTORE_SGRPROJ) {
            u.sgr_set = sd.literal(4);
            for (int i = 0; i < 2; ++i) {
                const int lo = kSgrprojXqdMin[i], hi = kSgrprojXqdMax[i];
                int v = 0;
                if (kSgrParams[u.sgr_set][i * 2]) v = signed_subexp(lo, hi + 1, 4, ref_xqd[p][i]);
                else if (i == 1) v = clip3(lo, hi, 128 - ref_xqd[p][0]);
                u.xqd[i] = ref_xqd[p][i] = v;
            }
            tools |= TOOL_SGRPROJ;
        }
    }

    // ---- loop restoration (7.17), a stripe × unit rectangle at a time:
    // the samples inside the stripe come from CDEF's output, the two rows
    // above and below it from the deblocked frame, the frame's edges
    // repeated
    std::vector<int> lr_src, lr_mid;
    std::vector<int32_t> sgr_a, sgr_b, sgr_f[2];

    void loop_restoration() {
        bool any = false;
        for (int p = 0; p < num_planes; ++p) any |= fr.lr_type[p] != RESTORE_NONE;
        if (!any) return;
        for (int p = 0; p < num_planes; ++p) {
            if (fr.lr_type[p] == RESTORE_NONE) continue;
            const int sx = p ? subx : 0, sy = p ? suby : 0, unit = fr.lr_size[p];
            const int pw = (fr.width + sx) >> sx, ph = (fr.height + sy) >> sy;
            const std::vector<uint8_t>& deblocked = cdef_src[p].empty() ? planes[p].px : cdef_src[p];
            std::vector<uint8_t> out = planes[p].px;
            for (int stripe = 0; (stripe * 64 - 8) < fr.height; ++stripe) {
                const int s0 = (stripe * 64 - 8) >> sy, s1 = s0 + (64 >> sy) - 1;  // StripeStartY, StripeEndY
                const int y0 = std::max(0, s0), y1 = std::min(ph, s1 + 1);
                const int ur = std::min(lr_rows[p] - 1, (((stripe * 64) >> sy)) / unit);
                for (int uc = 0; uc < lr_cols[p]; ++uc) {
                    const int x0 = uc * unit, x1 = uc == lr_cols[p] - 1 ? pw : std::min(pw, (uc + 1) * unit);
                    if (x0 >= x1 || y0 >= y1) continue;
                    const LrUnit& u = lr_units[p][static_cast<size_t>(ur) * lr_cols[p] + uc];
                    if (u.type == RESTORE_NONE) continue;
                    fill_lr_source(p, deblocked, x0, x1, y0, y1, s0, s1, pw, ph);
                    if (u.type == RESTORE_WIENER) wiener(p, u, x0, x1, y0, y1, out);
                    else self_guided(p, u, x0, x1, y0, y1, out);
                }
            }
            planes[p].px.swap(out);
        }
    }

    // lr_src: the rectangle with 3 samples around it, as get_source_sample
    // reads them
    int lr_w = 0;
    void fill_lr_source(int p, const std::vector<uint8_t>& deblocked, int x0, int x1, int y0, int y1, int s0, int s1,
                        int pw, int ph) {
        lr_w = x1 - x0 + 6;
        lr_src.resize(static_cast<size_t>(lr_w) * (y1 - y0 + 6));
        const int stride = planes[p].stride;
        for (int r = 0; r < y1 - y0 + 6; ++r) {
            int y = clip3(0, ph - 1, y0 - 3 + r);
            const std::vector<uint8_t>* src = &planes[p].px;
            if (y < s0) {
                y = std::max(s0 - 2, y);
                src = &deblocked;
            } else if (y > s1) {
                y = std::min(s1 + 2, y);
                src = &deblocked;
            }
            const uint8_t* row = src->data() + static_cast<size_t>(y) * stride;
            for (int c = 0; c < lr_w; ++c) lr_src[static_cast<size_t>(r) * lr_w + c] = row[clip3(0, pw - 1, x0 - 3 + c)];
        }
    }
    int src(int r, int c) const { return lr_src[static_cast<size_t>(r + 3) * lr_w + c + 3]; }

    void wiener(int p, const LrUnit& u, int x0, int x1, int y0, int y1, std::vector<uint8_t>& out) {
        int vf[7], hf[7];
        for (int pass = 0; pass < 2; ++pass) {
            int* f = pass ? hf : vf;
            f[3] = 128;
            for (int i = 0; i < 3; ++i) {
                f[i] = f[6 - i] = u.wiener[pass][i];
                f[3] -= 2 * u.wiener[pass][i];
            }
        }
        const int w = x1 - x0, h = y1 - y0;
        lr_mid.resize(static_cast<size_t>(w) * (h + 6));
        for (int r = 0; r < h + 6; ++r)
            for (int c = 0; c < w; ++c) {
                int sum = 0;
                for (int t = 0; t < 7; ++t) sum += hf[t] * src(r - 3, c + t - 3);
                lr_mid[static_cast<size_t>(r) * w + c] = clip3(-2048, 8191 - 2048, round2(sum, 3));
            }
        const int stride = planes[p].stride;
        for (int r = 0; r < h; ++r)
            for (int c = 0; c < w; ++c) {
                int sum = 0;
                for (int t = 0; t < 7; ++t) sum += vf[t] * lr_mid[static_cast<size_t>(r + t) * w + c];
                out[static_cast<size_t>(y0 + r) * stride + x0 + c] = static_cast<uint8_t>(clip3(0, 255, round2(sum, 11)));
            }
    }

    // box_filter: A and B over the rectangle and a ring of one sample, then
    // F of each pass
    void box_filter(int set, int pass, int w, int h, std::vector<int32_t>& f) {
        const int r = kSgrParams[set][pass * 2], s = kSgrParams[set][pass * 2 + 1];
        const int n = (2 * r + 1) * (2 * r + 1);
        const int one_over_n = ((1 << 12) + n / 2) / n;
        const int aw = w + 2;
        sgr_a.resize(static_cast<size_t>(aw) * (h + 2));
        sgr_b.resize(sgr_a.size());
        for (int i = -1; i < h + 1; ++i)
            for (int j = -1; j < w + 1; ++j) {
                int64_t a = 0;
                int b = 0;
                for (int dy = -r; dy <= r; ++dy)
                    for (int dx = -r; dx <= r; ++dx) {
                        const int c = src(i + dy, j + dx);
                        a += c * c;
                        b += c;
                    }
                const int64_t pv = std::max<int64_t>(0, a * n - static_cast<int64_t>(b) * b);
                const int64_t z = (pv * s + (1 << 19)) >> 20;
                int a2;
                if (z >= 255) a2 = 256;
                else if (z == 0) a2 = 1;
                else a2 = static_cast<int>(((z << 8) + z / 2) / (z + 1));
                const int64_t b2 = static_cast<int64_t>(256 - a2) * b * one_over_n;
                sgr_a[static_cast<size_t>(i + 1) * aw + j + 1] = a2;
                sgr_b[static_cast<size_t>(i + 1) * aw + j + 1] = static_cast<int32_t>((b2 + (1 << 11)) >> 12);
            }
        f.resize(static_cast<size_t>(w) * h);
        for (int i = 0; i < h; ++i) {
            const int shift = pass == 0 && (i & 1) ? 4 : 5;
            for (int j = 0; j < w; ++j) {
                int64_t a = 0, b = 0;
                for (int dy = -1; dy <= 1; ++dy)
                    for (int dx = -1; dx <= 1; ++dx) {
                        int weight;
                        if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
                        else weight = (dx == 0 || dy == 0) ? 4 : 3;
                        const size_t k = static_cast<size_t>(i + dy + 1) * aw + j + dx + 1;
                        a += weight * sgr_a[k];
                        b += weight * sgr_b[k];
                    }
                const int64_t v = a * src(i, j) + b;
                f[static_cast<size_t>(i) * w + j] = static_cast<int32_t>(round2(v, 8 + shift - 4));
            }
        }
    }

    void self_guided(int p, const LrUnit& u, int x0, int x1, int y0, int y1, std::vector<uint8_t>& out) {
        const int w = x1 - x0, h = y1 - y0, set = u.sgr_set;
        const int r0 = kSgrParams[set][0], r1 = kSgrParams[set][2];
        if (r0) box_filter(set, 0, w, h, sgr_f[0]);
        if (r1) box_filter(set, 1, w, h, sgr_f[1]);
        const int w0 = u.xqd[0], w1 = u.xqd[1], w2 = 128 - w0 - w1;
        const int stride = planes[p].stride;
        for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) {
                const int uu = src(i, j) << 4;
                int64_t v = static_cast<int64_t>(w1) * uu;
                v += static_cast<int64_t>(w0) * (r0 ? sgr_f[0][static_cast<size_t>(i) * w + j] : uu);
                v += static_cast<int64_t>(w2) * (r1 ? sgr_f[1][static_cast<size_t>(i) * w + j] : uu);
                out[static_cast<size_t>(y0 + i) * stride + x0 + j] = static_cast<uint8_t>(clip3(0, 255, round2(v, 11)));
            }
    }

    // ---- CDEF (7.15): each 8×8 filtered from the deblocked frame (src)
    // into the planes, along the direction its luma's search finds
    std::vector<uint8_t> cdef_src[3];

    void cdef() {
        if (!seq.enable_cdef || fr.coded_lossless || fr.allow_intrabc) return;
        for (int p = 0; p < num_planes; ++p) cdef_src[p] = planes[p].px;
        for (int r = 0; r < fr.mi_rows; r += 2)
            for (int c = 0; c < fr.mi_cols; c += 2) {
                const int idx = cdef_frame[static_cast<size_t>(r >> 4) * cdef_stride + (c >> 4)];
                if (idx == -1) continue;
                if (skip[mi(r, c)] && skip[mi(r + 1, c)] && skip[mi(r, c + 1)] && skip[mi(r + 1, c + 1)]) continue;
                int var = 0;
                const int y_dir = cdef_direction(r, c, &var);
                int pri = fr.cdef_y_pri[idx];
                const int sec = fr.cdef_y_sec[idx];
                const int var_str = (var >> 6) ? std::min(floor_log2(static_cast<uint32_t>(var >> 6)), 12) : 0;
                const int dir = pri ? y_dir : 0;
                pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
                if (pri || sec) tools |= TOOL_CDEF_Y;
                cdef_filter(0, r, c, pri, sec, fr.cdef_damping, dir);
                if (num_planes == 1) continue;
                const int uv_pri = fr.cdef_uv_pri[idx], uv_sec = fr.cdef_uv_sec[idx];
                const int uv_dir = uv_pri ? kCdefUvDir[subx][suby][y_dir] : 0;
                if (uv_pri || uv_sec) tools |= TOOL_CDEF_UV;
                cdef_filter(1, r, c, uv_pri, uv_sec, fr.cdef_damping - 1, uv_dir);
                cdef_filter(2, r, c, uv_pri, uv_sec, fr.cdef_damping - 1, uv_dir);
            }
    }

    int src_at(int p, int y, int x) const { return cdef_src[p][static_cast<size_t>(y) * planes[p].stride + x]; }

    int cdef_direction(int r, int c, int* var) const {
        int cost[8] = {}, partial[8][15] = {};
        const int x0 = c * 4, y0 = r * 4;
        for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j) {
                const int x = src_at(0, y0 + i, x0 + j) - 128;
                partial[0][i + j] += x;
                partial[1][i + j / 2] += x;
                partial[2][i] += x;
                partial[3][3 + i - j / 2] += x;
                partial[4][7 + i - j] += x;
                partial[5][3 - i / 2 + j] += x;
                partial[6][j] += x;
                partial[7][i / 2 + j] += x;
            }
        for (int i = 0; i < 8; ++i) {
            cost[2] += partial[2][i] * partial[2][i];
            cost[6] += partial[6][i] * partial[6][i];
        }
        cost[2] *= kCdefDivTable[8];
        cost[6] *= kCdefDivTable[8];
        for (int i = 0; i < 7; ++i) {
            cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * kCdefDivTable[i + 1];
            cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * kCdefDivTable[i + 1];
        }
        cost[0] += partial[0][7] * partial[0][7] * kCdefDivTable[8];
        cost[4] += partial[4][7] * partial[4][7] * kCdefDivTable[8];
        for (int i = 1; i < 8; i += 2) {
            for (int j = 0; j < 5; ++j) cost[i] += partial[i][3 + j] * partial[i][3 + j];
            cost[i] *= kCdefDivTable[8];
            for (int j = 0; j < 3; ++j)
                cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * kCdefDivTable[2 * j + 2];
        }
        int best = 0, dir = 0;
        for (int i = 0; i < 8; ++i)
            if (cost[i] > best) {
                best = cost[i];
                dir = i;
            }
        *var = (best - cost[(dir + 4) & 7]) >> 10;
        return dir;
    }

    static int constrain(int diff, int threshold, int damping) {
        if (!threshold) return 0;
        const int adj = std::max(0, damping - floor_log2(static_cast<uint32_t>(threshold)));
        const int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
        return diff < 0 ? -val : val;
    }

    void cdef_filter(int p, int r, int c, int pri, int sec, int damping, int dir) {
        static const int kPriTaps[2][2] = {{4, 2}, {3, 3}}, kSecTaps[2][2] = {{2, 1}, {2, 1}};
        const int sx = p ? subx : 0, sy = p ? suby : 0;
        const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
        const int rows = fr.mi_rows * 4 >> sy, cols = fr.mi_cols * 4 >> sx;  // is_inside_filter_region
        Plane& pl = planes[p];
        for (int i = 0; i < h; ++i)
            for (int j = 0; j < w; ++j) {
                const int x = src_at(p, y0 + i, x0 + j);
                int sum = 0, mx = x, mn = x;
                auto tap = [&](int d, int k, int sign, int str, int weight) {
                    const int yy = y0 + i + sign * kCdefDirections[d][k][0], xx = x0 + j + sign * kCdefDirections[d][k][1];
                    if (yy < 0 || yy >= rows || xx < 0 || xx >= cols) return;
                    const int v = src_at(p, yy, xx);
                    sum += weight * constrain(v - x, str, damping);
                    mx = std::max(mx, v);
                    mn = std::min(mn, v);
                };
                for (int k = 0; k < 2; ++k)
                    for (int sign = -1; sign <= 1; sign += 2) {
                        tap(dir, k, sign, pri, kPriTaps[pri & 1][k]);
                        tap((dir + 2) & 7, k, sign, sec, kSecTaps[pri & 1][k]);
                        tap((dir - 2) & 7, k, sign, sec, kSecTaps[pri & 1][k]);
                    }
                pl.at(y0 + i, x0 + j) = static_cast<uint8_t>(clip3(mn, mx, x + ((8 + sum - (sum < 0)) >> 4)));
            }
    }

    // ---- the deblocking filter (7.14)
    int filter_level(int row, int col, int plane, int pass) {
        const int seg = seg_id[mi(row, col)];
        const int i = plane == 0 ? pass : plane + 1;
        const int dlf = fr.delta_lf_multi ? delta_lfs[mi(row, col) * 4 + i] : delta_lfs[mi(row, col) * 4];
        int lvl = clip3(0, 63, dlf + fr.lf_level[i]);
        if (seg_active(fr, seg, SEG_LVL_ALT_LF_Y_V + i)) lvl = clip3(0, 63, lvl + fr.feature_data[seg][SEG_LVL_ALT_LF_Y_V + i]);
        if (fr.lf_delta_enabled) {
            const int n_shift = lvl >> 5;
            lvl = clip3(0, 63, lvl + (fr.lf_ref_deltas[0] * (1 << n_shift)));
        }
        return lvl;
    }

    void loop_filter() {
        if (!fr.lf_level[0] && !fr.lf_level[1]) return;
        for (int plane = 0; plane < num_planes; ++plane) {
            if (plane > 0 && !fr.lf_level[plane + 1]) continue;
            for (int pass = 0; pass < 2; ++pass) {
                const int row_step = plane == 0 ? 1 : (1 << suby), col_step = plane == 0 ? 1 : (1 << subx);
                for (int row = 0; row < fr.mi_rows; row += row_step)
                    for (int col = 0; col < fr.mi_cols; col += col_step) edge(plane, pass, row, col);
            }
        }
    }

    void edge(int plane, int pass, int row, int col) {
        const int sx = plane ? subx : 0, sy = plane ? suby : 0;
        const int dx = pass == 0, dy = pass == 1;
        const int x = col * 4, y = row * 4;
        row |= sy;
        col |= sx;
        if (x >= fr.width || y >= fr.height) return;
        if (pass == 0 && x == 0) return;
        if (pass == 1 && y == 0) return;
        const int xp = x >> sx, yp = y >> sy;
        const int prev_row = row - (dy << sy), prev_col = col - (dx << sx);
        const int t = lf_tx[plane][static_cast<size_t>(row >> sy) * lf_stride[plane] + (col >> sx)];
        const int prev_t = lf_tx[plane][static_cast<size_t>(prev_row >> sy) * lf_stride[plane] + (prev_col >> sx)];
        // an intra block filters every transform edge (applyFilter: isIntra),
        // skipped or not, block edge or not
        const bool tx_edge = pass == 0 ? xp % kTxW[t] == 0 : yp % kTxH[t] == 0;
        if (!tx_edge) return;
        const int base = pass == 0 ? std::min(kTxW[prev_t], kTxW[t]) : std::min(kTxH[prev_t], kTxH[t]);
        const int size = plane == 0 ? std::min(16, base) : std::min(8, base);
        int lvl = filter_level(row, col, plane, pass);
        if (lvl == 0) lvl = filter_level(prev_row, prev_col, plane, pass);
        if (lvl == 0) return;
        tools |= TOOL_DEBLOCK;
        const int shift = fr.lf_sharpness > 4 ? 2 : (fr.lf_sharpness > 0 ? 1 : 0);
        const int limit = fr.lf_sharpness > 0 ? clip3(1, 9 - fr.lf_sharpness, lvl >> shift) : std::max(1, lvl >> shift);
        const int blimit = 2 * (lvl + 2) + limit;
        const int thresh = lvl >> 4;
        for (int i = 0; i < 4; ++i) sample_filter(plane, xp + dy * i, yp + dx * i, limit, blimit, thresh, dx, dy, size);
    }

    void sample_filter(int plane, int x, int y, int limit, int blimit, int thresh, int dx, int dy, int size) {
        Plane& pl = planes[plane];
        auto F = [&](int k) -> uint8_t& { return pl.at(y + k * dy, x + k * dx); };
        const int q0 = F(0), q1 = F(1), q2 = size >= 8 ? F(2) : 0, q3 = size >= 8 ? F(3) : 0;
        const int p0 = F(-1), p1 = F(-2), p2 = size >= 8 ? F(-3) : 0, p3 = size >= 8 ? F(-4) : 0;
        const int hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
        const int len = size == 4 ? 4 : (plane ? 6 : (size == 8 ? 8 : 16));
        bool mask = std::abs(p1 - p0) > limit || std::abs(q1 - q0) > limit ||
                    std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 > blimit;
        if (len >= 6) mask = mask || std::abs(p2 - p1) > limit || std::abs(q2 - q1) > limit;
        if (len >= 8) mask = mask || std::abs(p3 - p2) > limit || std::abs(q3 - q2) > limit;
        if (mask) return;
        bool flat = false, flat2 = false;
        if (size >= 8) {
            flat = std::abs(p1 - p0) <= 1 && std::abs(q1 - q0) <= 1 && std::abs(p2 - p0) <= 1 && std::abs(q2 - q0) <= 1;
            if (len >= 8) flat = flat && std::abs(p3 - p0) <= 1 && std::abs(q3 - q0) <= 1;
        }
        if (size >= 16) {
            const int q4 = F(4), q5 = F(5), q6 = F(6), p4 = F(-5), p5 = F(-6), p6 = F(-7);
            flat2 = std::abs(p6 - p0) <= 1 && std::abs(q6 - q0) <= 1 && std::abs(p5 - p0) <= 1 && std::abs(q5 - q0) <= 1 &&
                    std::abs(p4 - p0) <= 1 && std::abs(q4 - q0) <= 1;
        }
        if (size == 4 || !flat) {
            auto c4 = [](int v) { return clip3(-128, 127, v); };
            const int ps1 = p1 - 128, ps0 = p0 - 128, qs0 = q0 - 128, qs1 = q1 - 128;
            int filter = hev ? c4(ps1 - qs1) : 0;
            filter = c4(filter + 3 * (qs0 - ps0));
            const int f1 = c4(filter + 4) >> 3, f2 = c4(filter + 3) >> 3;
            F(0) = static_cast<uint8_t>(c4(qs0 - f1) + 128);
            F(-1) = static_cast<uint8_t>(c4(ps0 + f2) + 128);
            if (!hev) {
                const int f = round2(f1, 1);
                F(1) = static_cast<uint8_t>(c4(qs1 - f) + 128);
                F(-2) = static_cast<uint8_t>(c4(ps1 + f) + 128);
            }
        } else if (size == 8 || !flat2) {
            wide(F, plane, 3);
        } else {
            wide(F, plane, 4);
        }
    }

    template <typename G>
    void wide(G& F, int plane, int log2size) {
        const int n = log2size == 4 ? 6 : (plane == 0 ? 3 : 2);
        const int n2 = (log2size == 3 && plane == 0) ? 0 : 1;
        int v[16], out[16];
        for (int k = -(n + 1); k <= n; ++k) v[k + 8] = F(k);
        for (int i = -n; i < n; ++i) {
            int t = 0;
            for (int j = -n; j <= n; ++j) {
                const int p = clip3(-(n + 1), n, i + j);
                const int tap = std::abs(j) <= n2 ? 2 : 1;
                t += v[p + 8] * tap;
            }
            out[i + 8] = round2(t, log2size);
        }
        for (int i = -n; i < n; ++i) F(i) = static_cast<uint8_t>(out[i + 8]);
    }
};

// ---------------------------------------------------------------------------
// The OBU walk (5.3) and the entry point
// ---------------------------------------------------------------------------

struct Image {
    Sequence seq;
    Frame fr;
    std::vector<uint8_t> planes;
    uint64_t tools = 0;
    int header_bits = 0;  // the frame header's length in bits: its last is clip_to_restricted_range with grain
};

void decode(const uint8_t* d, size_t n, long long max_pixels, Image& img) {
    Sequence& seq = img.seq;
    Frame& fr = img.fr;
    std::unique_ptr<Decoder> dec;
    bool have_header = false, done = false;
    int tiles_done = 0;
    size_t at = 0;
    while (at < n) {  // dav1d reads every OBU of the data, those after the frame too
        Bits hb(d + at, n - at);
        hb.f(1);  // obu_forbidden_bit: dav1d checks it only when told to be strict
        const int type = hb.f(4);
        const int ext = hb.f(1);
        const int has_size = hb.f(1);
        hb.f(1);
        int temporal_id = 0, spatial_id = 0;
        if (ext) {
            temporal_id = hb.f(3);
            spatial_id = hb.f(2);
            hb.f(3);
        }
        size_t p = at + 1 + ext;
        uint64_t size;
        if (has_size) size = leb128(d, n, &p);
        else size = n - p;
        if (size > n - p) fail(ST_TRUNCATED, "truncated AV1: an OBU runs past the item's data");
        const uint8_t* body = d + p;
        const size_t len = static_cast<size_t>(size);
        at = p + len;
        if (done) continue;  // past the frame, an OBU need only fit the data
        if (type == 1) {  // sequence header
            Bits b(body, len);
            Sequence s;
            read_sequence(b, s);
            b.f(1);  // dav1d's check_trailing_bits reads the trailing one bit, which must be in the OBU
            if (seq.seen && have_header) continue;
            seq = s;
        } else if (type == 3 || type == 6) {  // frame header, frame
            if (!seq.seen) broken("a frame before any sequence header");
            if (have_header) {
                if (type == 3) continue;  // a redundant copy
                broken("a second frame in a still picture");
            }
            if (seq.bit_depth != 8) refuse(std::to_string(seq.bit_depth) + "-bit samples");
            Bits b(body, len);
            read_frame_header(b, seq, fr, &img.tools, temporal_id, spatial_id);
            img.header_bits = static_cast<int>(b.pos);
            if (static_cast<long long>(fr.width) * fr.height > max_pixels)
                fail(ST_BOMB, "AV1 frame over the decoder's pixel limit");
            have_header = true;
            dec.reset(new Decoder(seq, fr));
            dec->setup();
            if (type == 6) {
                b.byte_align();
                const size_t hdr = b.pos / 8;
                // the tile group that follows in the same OBU
                const uint8_t* tg = body + hdr;
                const size_t tgn = len - hdr;
                Bits tb(tg, tgn);
                const int num_tiles = fr.tile_cols * fr.tile_rows;
                int start = 0, end = num_tiles - 1;
                if (num_tiles > 1 && tb.f(1)) {
                    const int bits = fr.tile_cols_log2 + fr.tile_rows_log2;
                    start = tb.f(bits);
                    end = tb.f(bits);
                }
                tb.byte_align();
                size_t q = tb.pos / 8;
                for (int t = start; t <= end; ++t) {
                    size_t tsize;
                    if (t == end) {
                        tsize = tgn - q;
                    } else {
                        if (q + fr.tile_size_bytes > tgn) fail(ST_TRUNCATED, "truncated AV1: a tile size ends early");
                        tsize = 0;
                        for (int k = 0; k < fr.tile_size_bytes; ++k) tsize |= static_cast<size_t>(tg[q + k]) << (8 * k);
                        tsize += 1;
                        q += fr.tile_size_bytes;
                        if (tsize > tgn - q) fail(ST_TRUNCATED, "truncated AV1: a tile runs past its tile group");
                    }
                    if (t >= num_tiles) broken("a tile past the frame's tiles");
                    dec->decode_tile(tg + q, tsize, t / fr.tile_cols, t % fr.tile_cols);
                    q += tsize;
                    ++tiles_done;
                }
                if (tiles_done >= num_tiles) done = true;
            }
        } else if (type == 4) {  // tile group
            if (!have_header) broken("a tile group before its frame header");
            Bits tb(body, len);
            const int num_tiles = fr.tile_cols * fr.tile_rows;
            int start = 0, end = num_tiles - 1;
            if (num_tiles > 1 && tb.f(1)) {
                const int bits = fr.tile_cols_log2 + fr.tile_rows_log2;
                start = tb.f(bits);
                end = tb.f(bits);
            }
            tb.byte_align();
            size_t q = tb.pos / 8;
            for (int t = start; t <= end; ++t) {
                size_t tsize;
                if (t == end) {
                    tsize = len - q;
                } else {
                    if (q + fr.tile_size_bytes > len) fail(ST_TRUNCATED, "truncated AV1: a tile size ends early");
                    tsize = 0;
                    for (int k = 0; k < fr.tile_size_bytes; ++k) tsize |= static_cast<size_t>(body[q + k]) << (8 * k);
                    tsize += 1;
                    q += fr.tile_size_bytes;
                    if (tsize > len - q) fail(ST_TRUNCATED, "truncated AV1: a tile runs past its tile group");
                }
                if (t >= num_tiles) broken("a tile past the frame's tiles");
                dec->decode_tile(body + q, tsize, t / fr.tile_cols, t % fr.tile_cols);
                q += tsize;
                ++tiles_done;
            }
            if (tiles_done >= num_tiles) done = true;
        }
        // temporal delimiters, metadata, padding and the rest are skipped
    }
    if (!done) fail(ST_TRUNCATED, "truncated AV1: the item's data ends before its frame's last tile");
    dec->loop_filter();
    dec->cdef();
    dec->loop_restoration();
    img.tools |= dec->tools;
    // the planes, cropped to the frame
    std::vector<size_t> starts;
    for (int pidx = 0; pidx < dec->num_planes; ++pidx) {
        const int sx = pidx ? seq.subx : 0, sy = pidx ? seq.suby : 0;
        const int w = (fr.width + sx) >> sx, h = (fr.height + sy) >> sy;
        Plane& pl = dec->planes[pidx];
        starts.push_back(img.planes.size());
        for (int y = 0; y < h; ++y) img.planes.insert(img.planes.end(), &pl.at(y, 0), &pl.at(y, 0) + w);
    }
    const auto& g = fr.grain;
    if (g.apply && (g.num_y || g.num_uv[0] || g.num_uv[1] || (g.restricted && g.csfl))) {  // dav1d's has_grain
        img.tools |= TOOL_FILM_GRAIN;
        std::vector<uint8_t*> at;
        for (size_t k : starts) at.push_back(img.planes.data() + k);
        apply_grain(g, seq.mono, seq.subx, seq.suby, seq.mc == 0, fr.width, fr.height, at);
    }
}

}  // namespace

extern "C" int mmtrs_av1_decode(const void* buf, long long n, long long max_pixels, void* out, void* dims, void* msg) {
    void** dst = static_cast<void**>(out);
    int* dm = static_cast<int*>(dims);
    char* text = static_cast<char*>(msg);
    *dst = nullptr;
    text[0] = 0;
    try {
        Image img;
        decode(static_cast<const uint8_t*>(buf), n > 0 ? static_cast<size_t>(n) : 0, max_pixels, img);
        const Sequence& s = img.seq;
        dm[0] = img.fr.width;
        dm[1] = img.fr.height;
        dm[2] = s.subx;
        dm[3] = s.suby;
        dm[4] = s.mono ? 1 : 3;
        dm[5] = s.bit_depth;
        dm[6] = s.cp;
        dm[7] = s.tc;
        dm[8] = s.mc;
        dm[9] = s.range;
        dm[10] = static_cast<int>(static_cast<uint32_t>(img.tools));
        dm[11] = static_cast<int>(static_cast<uint32_t>(img.tools >> 32));
        const auto& g = img.fr.grain;  // the film grain parameters' kinds, for the tests' coverage
        dm[12] = g.apply | (g.num_y > 0) << 1 | (g.num_uv[0] > 0 || g.num_uv[1] > 0) << 2 | g.csfl << 3 |
                 g.overlap << 4 | g.restricted << 5 | g.lag << 6 | (g.grain_scale_shift > 0) << 8;
        dm[13] = img.header_bits;
        void* mem = std::malloc(std::max<size_t>(img.planes.size(), 1));
        if (!mem) {
            std::snprintf(text, 256, "out of memory");
            return ST_BROKEN;
        }
        std::memcpy(mem, img.planes.data(), img.planes.size());
        *dst = mem;
        return 0;
    } catch (const Fail& f) {
        std::snprintf(text, 256, "%s", f.what.c_str());
        return f.status;
    } catch (const std::bad_alloc&) {
        std::snprintf(text, 256, "out of memory");
        return ST_BROKEN;
    }
}

extern "C" int mmtrs_av1_free(void* p) {
    std::free(p);
    return 0;
}

// ---------------------------------------------------------------------------
// libavif's avifImageScale: an AV1 frame of another size than its item's
// ispe (or its track's tkhd) is scaled to it, each plane through libyuv's
// ScalePlane with kFilterBox (scale.cc, scale_common.cc; the x86 rows it
// picks compute as these C rows do)
// ---------------------------------------------------------------------------

namespace {

enum FilterMode { kFilterNone, kFilterLinear, kFilterBilinear, kFilterBox };

int fixed_div(int num, int div) { return static_cast<int>((static_cast<int64_t>(num) << 16) / div); }
int fixed_div1(int num, int div) { return static_cast<int>(((static_cast<int64_t>(num) << 16) - 0x00010001) / (div - 1)); }
int center_start(int dx, int s) { return dx < 0 ? -((-dx >> 1) + s) : ((dx >> 1) + s); }
int min1(int x) { return x < 1 ? 1 : x; }

FilterMode filter_reduce(int sw, int sh, int dw, int dh, FilterMode f) {
    if (f == kFilterBox && (dw * 2 >= sw || dh * 2 >= sh)) f = kFilterBilinear;
    if (f == kFilterBilinear) {
        if (sh == 1) f = kFilterLinear;
        if (dh == sh || dh * 3 == sh) f = kFilterLinear;
        if (sw == 1) f = kFilterNone;
    }
    if (f == kFilterLinear) {
        if (sw == 1) f = kFilterNone;
        if (dw == sw || dw * 3 == sw) f = kFilterNone;
    }
    return f;
}

void scale_slope(int sw, int sh, int dw, int dh, FilterMode f, int* x, int* y, int* dx, int* dy) {
    if (dw == 1 && sw >= 32768) dw = sw;
    if (dh == 1 && sh >= 32768) dh = sh;
    if (f == kFilterBox) {
        *dx = fixed_div(sw, dw);
        *dy = fixed_div(sh, dh);
        *x = *y = 0;
    } else if (f == kFilterBilinear || f == kFilterLinear) {
        if (dw <= sw) {
            *dx = fixed_div(sw, dw);
            *x = center_start(*dx, -32768);
        } else if (sw > 1 && dw > 1) {
            *dx = fixed_div1(sw, dw);
            *x = 0;
        }
        if (f == kFilterLinear) {
            *dy = fixed_div(sh, dh);
            *y = *dy >> 1;
        } else if (dh <= sh) {
            *dy = fixed_div(sh, dh);
            *y = center_start(*dy, -32768);
        } else if (sh > 1 && dh > 1) {
            *dy = fixed_div1(sh, dh);
            *y = 0;
        }
    } else {
        *dx = fixed_div(sw, dw);
        *dy = fixed_div(sh, dh);
        *x = center_start(*dx, 0);
        *y = center_start(*dy, 0);
    }
}

// ScaleFilterCols_C with Intel's 7-bit BLENDER
void filter_cols(uint8_t* dst, const uint8_t* src, int dw, int x, int dx) {
    for (int j = 0; j < dw; ++j, x += dx) {
        const int xi = x >> 16, a = src[xi], b = src[xi + 1];
        dst[j] = static_cast<uint8_t>(a + ((((x & 0xffff) >> 9) * (b - a) + 0x40) >> 7));
    }
}
void scale_cols(uint8_t* dst, const uint8_t* src, int dw, int x, int dx) {
    for (int j = 0; j < dw; ++j, x += dx) dst[j] = src[x >> 16];
}
void interpolate_row(uint8_t* dst, const uint8_t* src, ptrdiff_t stride, int w, int f) {
    const uint8_t* src1 = src + stride;
    if (f == 0) {
        std::memcpy(dst, src, static_cast<size_t>(w));
        return;
    }
    for (int x = 0; x < w; ++x) dst[x] = static_cast<uint8_t>((src[x] * (256 - f) + src1[x] * f + 128) >> 8);
}
// ScaleRowUp2_Linear_Any_C and ScaleRowUp2_Bilinear_Any_C
void up2_linear(const uint8_t* s, uint8_t* d, int dw) {
    const int sw = (dw + 1) / 2;
    d[0] = s[0];
    for (int x = 0; x < sw - 1 && 2 * x + 2 < dw; ++x) {
        d[2 * x + 1] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + 2) >> 2);
        d[2 * x + 2] = static_cast<uint8_t>((s[x] + s[x + 1] * 3 + 2) >> 2);
    }
    d[dw - 1] = s[(dw - 1) / 2];
}
void up2_bilinear(const uint8_t* s, ptrdiff_t ss, uint8_t* d, ptrdiff_t ds, int dw) {
    const uint8_t* t = s + ss;
    uint8_t* e = d + ds;
    d[0] = static_cast<uint8_t>((s[0] * 3 + t[0] + 2) >> 2);
    e[0] = static_cast<uint8_t>((s[0] + t[0] * 3 + 2) >> 2);
    const int k = (dw - 1) / 2;
    for (int x = 0; x < k; ++x) {
        d[2 * x + 1] = static_cast<uint8_t>((s[x] * 9 + s[x + 1] * 3 + t[x] * 3 + t[x + 1] + 8) >> 4);
        d[2 * x + 2] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] * 9 + t[x] + t[x + 1] * 3 + 8) >> 4);
        e[2 * x + 1] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + t[x] * 9 + t[x + 1] * 3 + 8) >> 4);
        e[2 * x + 2] = static_cast<uint8_t>((s[x] + s[x + 1] * 3 + t[x] * 3 + t[x + 1] * 9 + 8) >> 4);
    }
    d[dw - 1] = static_cast<uint8_t>((s[k] * 3 + t[k] + 2) >> 2);
    e[dw - 1] = static_cast<uint8_t>((s[k] + t[k] * 3 + 2) >> 2);
}

void scale_plane(const uint8_t* src, int ss, int sw, int sh, uint8_t* dst, int ds, int dw, int dh) {
    FilterMode f = filter_reduce(sw, sh, dw, dh, kFilterBox);
    if (dw == sw && dh == sh) {
        for (int y = 0; y < dh; ++y) std::memcpy(dst + static_cast<ptrdiff_t>(y) * ds, src + static_cast<ptrdiff_t>(y) * ss, dw);
        return;
    }
    if (dw == sw && f != kFilterBox) {  // ScalePlaneVertical
        int dy = 0, y = 0;
        if (dh <= sh) {
            dy = fixed_div(sh, dh);
            y = center_start(dy, -32768);
        } else if (sh > 1 && dh > 1) {
            dy = fixed_div1(sh, dh);
        }
        const int max_y = sh > 1 ? ((sh - 1) << 16) - 1 : 0;
        for (int j = 0; j < dh; ++j, y += dy) {
            if (y > max_y) y = max_y;
            interpolate_row(dst + static_cast<ptrdiff_t>(j) * ds, src + static_cast<ptrdiff_t>(y >> 16) * ss, ss, dw,
                            f ? (y >> 8) & 255 : 0);
        }
        return;
    }
    if (dw <= sw && dh <= sh) {
        if (4 * dw == 3 * sw && 4 * dh == 3 * sh) {  // ScalePlaneDown34
            const ptrdiff_t fs = f == kFilterLinear ? 0 : ss;
            // the SSSE3 rows libyuv runs on the first dw - dw % 24 outputs
            // blend the rows first (pavgb: 3:1 as avg(s, avg(s, t)), 1:1
            // as avg(s, t)), then the columns 3:1, 2:2, 1:3 with 2 to round;
            // its C rows run on the rest
            const int simd = dw - dw % 24;
            auto pavg = [](int a, int b) { return (a + b + 1) >> 1; };
            auto simd_row = [&](const uint8_t* s, ptrdiff_t st, uint8_t* d, bool three) {
                const uint8_t* t = s + st;
                for (int x = 0; x < simd; x += 3, s += 4, t += 4, d += 3) {
                    int v[4];
                    for (int k = 0; k < 4; ++k) v[k] = three ? pavg(s[k], pavg(s[k], t[k])) : pavg(s[k], t[k]);
                    d[0] = static_cast<uint8_t>((v[0] * 3 + v[1] + 2) >> 2);
                    d[1] = static_cast<uint8_t>((v[1] * 2 + v[2] * 2 + 2) >> 2);
                    d[2] = static_cast<uint8_t>((v[2] + v[3] * 3 + 2) >> 2);
                }
            };
            auto row0 = [&](const uint8_t* s, ptrdiff_t st, uint8_t* d) {
                const uint8_t* t = s + st;
                int x = 0;
                if (f) {
                    simd_row(s, st, d, true);
                    x = simd, s += simd / 3 * 4, t += simd / 3 * 4, d += simd;
                }
                for (; x < dw; x += 3, s += 4, t += 4, d += 3) {
                    if (!f) {
                        d[0] = s[0], d[1] = s[1], d[2] = s[3];
                        continue;
                    }
                    const int a0 = (s[0] * 3 + s[1] + 2) >> 2, a1 = (s[1] + s[2] + 1) >> 1, a2 = (s[2] + s[3] * 3 + 2) >> 2;
                    const int b0 = (t[0] * 3 + t[1] + 2) >> 2, b1 = (t[1] + t[2] + 1) >> 1, b2 = (t[2] + t[3] * 3 + 2) >> 2;
                    d[0] = static_cast<uint8_t>((a0 * 3 + b0 + 2) >> 2);
                    d[1] = static_cast<uint8_t>((a1 * 3 + b1 + 2) >> 2);
                    d[2] = static_cast<uint8_t>((a2 * 3 + b2 + 2) >> 2);
                }
            };
            auto row1 = [&](const uint8_t* s, ptrdiff_t st, uint8_t* d) {
                const uint8_t* t = s + st;
                int x = 0;
                if (f) {
                    simd_row(s, st, d, false);
                    x = simd, s += simd / 3 * 4, t += simd / 3 * 4, d += simd;
                }
                for (; x < dw; x += 3, s += 4, t += 4, d += 3) {
                    if (!f) {
                        d[0] = s[0], d[1] = s[1], d[2] = s[3];
                        continue;
                    }
                    const int a0 = (s[0] * 3 + s[1] + 2) >> 2, a1 = (s[1] + s[2] + 1) >> 1, a2 = (s[2] + s[3] * 3 + 2) >> 2;
                    const int b0 = (t[0] * 3 + t[1] + 2) >> 2, b1 = (t[1] + t[2] + 1) >> 1, b2 = (t[2] + t[3] * 3 + 2) >> 2;
                    d[0] = static_cast<uint8_t>((a0 + b0 + 1) >> 1);
                    d[1] = static_cast<uint8_t>((a1 + b1 + 1) >> 1);
                    d[2] = static_cast<uint8_t>((a2 + b2 + 1) >> 1);
                }
            };
            int y = 0;
            for (; y < dh - 2; y += 3) {
                row0(src, fs, dst);
                src += ss, dst += ds;
                row1(src, fs, dst);
                src += ss, dst += ds;
                row0(src + ss, -fs, dst);
                src += 2 * ss, dst += ds;
            }
            if (dh % 3 == 2) {
                row0(src, fs, dst);
                src += ss, dst += ds;
                row1(src, 0, dst);
            } else if (dh % 3 == 1) {
                row0(src, 0, dst);
            }
            return;
        }
        if (2 * dw == sw && 2 * dh == sh) {  // ScalePlaneDown2
            for (int y = 0; y < dh; ++y) {
                const uint8_t* s = src + static_cast<ptrdiff_t>(2 * y) * ss;
                const uint8_t* t = s + (f == kFilterLinear ? 0 : ss);
                uint8_t* d = dst + static_cast<ptrdiff_t>(y) * ds;
                for (int x = 0; x < dw; ++x) {
                    if (!f) d[x] = s[ss + 2 * x + 1];
                    else if (f == kFilterLinear) d[x] = static_cast<uint8_t>((s[2 * x] + s[2 * x + 1] + 1) >> 1);
                    else d[x] = static_cast<uint8_t>((s[2 * x] + s[2 * x + 1] + t[2 * x] + t[2 * x + 1] + 2) >> 2);
                }
            }
            return;
        }
        if (8 * dw == 3 * sw && 8 * dh == 3 * sh) {  // ScalePlaneDown38
            const ptrdiff_t fs = f == kFilterLinear ? 0 : ss;
            // the two-row box's SSSE3 row (on the first dw - dw % 6
            // outputs) averages the rows first (pavgb), then divides the
            // column sums by 3 and 2
            const int simd = dw - dw % 6;
            auto box = [&](const uint8_t* s, ptrdiff_t st, int rows, uint8_t* d) {
                for (int x = 0; x < dw; x += 3, s += 8, d += 3) {
                    if (!f) {
                        d[0] = s[0], d[1] = s[3], d[2] = s[6];
                        continue;
                    }
                    if (rows == 2 && x < simd) {
                        int v[8];
                        for (int k = 0; k < 8; ++k) v[k] = (s[k] + s[st + k] + 1) >> 1;
                        d[0] = static_cast<uint8_t>(((v[0] + v[1] + v[2]) * (65536 / 3)) >> 16);
                        d[1] = static_cast<uint8_t>(((v[3] + v[4] + v[5]) * (65536 / 3)) >> 16);
                        d[2] = static_cast<uint8_t>(((v[6] + v[7]) * (65536 / 2)) >> 16);
                        continue;
                    }
                    int a = 0, b = 0, c = 0;
                    for (int r = 0; r < rows; ++r) {
                        const uint8_t* q = s + r * st;
                        a += q[0] + q[1] + q[2];
                        b += q[3] + q[4] + q[5];
                        c += q[6] + q[7];
                    }
                    const int k3 = rows == 3 ? 65536 / 9 : 65536 / 6, k2 = rows == 3 ? 65536 / 6 : 65536 / 4;
                    d[0] = static_cast<uint8_t>((a * k3) >> 16);
                    d[1] = static_cast<uint8_t>((b * k3) >> 16);
                    d[2] = static_cast<uint8_t>((c * k2) >> 16);
                }
            };
            int y = 0;
            for (; y < dh - 2; y += 3) {
                box(src, fs, 3, dst);
                src += 3 * ss, dst += ds;
                box(src, fs, 3, dst);
                src += 3 * ss, dst += ds;
                box(src, fs, 2, dst);
                src += 2 * ss, dst += ds;
            }
            if (dh % 3 == 2) {
                box(src, fs, 3, dst);
                src += 3 * ss, dst += ds;
                box(src, 0, 3, dst);
            } else if (dh % 3 == 1) {
                box(src, 0, 3, dst);
            }
            return;
        }
        if (4 * dw == sw && 4 * dh == sh && (f == kFilterBox || f == kFilterNone)) {  // ScalePlaneDown4
            for (int y = 0; y < dh; ++y) {
                const uint8_t* s = src + static_cast<ptrdiff_t>(4 * y) * ss;
                uint8_t* d = dst + static_cast<ptrdiff_t>(y) * ds;
                for (int x = 0; x < dw; ++x) {
                    if (!f) {
                        d[x] = s[2 * ss + 4 * x + 2];
                        continue;
                    }
                    int sum = 0;
                    for (int r = 0; r < 4; ++r)
                        for (int c = 0; c < 4; ++c) sum += s[r * ss + 4 * x + c];
                    d[x] = static_cast<uint8_t>((sum + 8) >> 4);
                }
            }
            return;
        }
    }
    if (f == kFilterBox && dh * 2 < sh) {  // ScalePlaneBox
        int x = 0, y = 0, dx = 0, dy = 0;
        scale_slope(sw, sh, dw, dh, kFilterBox, &x, &y, &dx, &dy);
        const int max_y = sh << 16;
        std::vector<int> row(static_cast<size_t>(sw));
        for (int j = 0; j < dh; ++j) {
            const int iy = y >> 16;
            y += dy;
            if (y > max_y) y = max_y;
            const int bh = min1((y >> 16) - iy);
            std::fill(row.begin(), row.end(), 0);
            for (int k = 0; k < bh; ++k)
                for (int i = 0; i < sw; ++i) row[i] += src[static_cast<ptrdiff_t>(iy + k) * ss + i];
            uint8_t* d = dst + static_cast<ptrdiff_t>(j) * ds;
            int xx = x;
            if (dx & 0xffff) {  // ScaleAddCols2_C
                const int minbw = dx >> 16;
                const int tbl[2] = {65536 / (min1(minbw) * bh), 65536 / (min1(minbw + 1) * bh)};
                for (int i = 0; i < dw; ++i) {
                    const int ix = xx >> 16;
                    xx += dx;
                    const int bw = min1((xx >> 16) - ix);
                    int sum = 0;
                    for (int k = 0; k < bw; ++k) sum += row[ix + k];
                    d[i] = static_cast<uint8_t>((sum * tbl[bw - minbw]) >> 16);
                }
            } else if (dx != 0x10000) {  // ScaleAddCols1_C
                const int bw = min1(dx >> 16), scale = 65536 / (bw * bh);
                int ix = xx >> 16;
                for (int i = 0; i < dw; ++i, ix += bw) {
                    int sum = 0;
                    for (int k = 0; k < bw; ++k) sum += row[ix + k];
                    d[i] = static_cast<uint8_t>((sum * scale) >> 16);
                }
            } else {  // ScaleAddCols0_C
                const int scale = 65536 / bh;
                for (int i = 0; i < dw; ++i) d[i] = static_cast<uint8_t>((row[(xx >> 16) + i] * scale) >> 16);
            }
        }
        return;
    }
    if ((dw + 1) / 2 == sw && f == kFilterLinear) {  // ScalePlaneUp2_Linear
        if (dh == 1) {
            up2_linear(src + static_cast<ptrdiff_t>((sh - 1) / 2) * ss, dst, dw);
        } else {
            const int dy = fixed_div(sh - 1, dh - 1);
            int y = (1 << 15) - 1;
            for (int i = 0; i < dh; ++i, y += dy) up2_linear(src + static_cast<ptrdiff_t>(y >> 16) * ss, dst + static_cast<ptrdiff_t>(i) * ds, dw);
        }
        return;
    }
    if ((dh + 1) / 2 == sh && (dw + 1) / 2 == sw && (f == kFilterBilinear || f == kFilterBox)) {  // ScalePlaneUp2_Bilinear
        up2_bilinear(src, 0, dst, 0, dw);
        dst += ds;
        for (int y = 0; y < sh - 1; ++y) {
            up2_bilinear(src, ss, dst, ds, dw);
            src += ss;
            dst += 2 * ds;
        }
        if (!(dh & 1)) up2_bilinear(src, 0, dst, 0, dw);
        return;
    }
    int x = 0, y = 0, dx = 0, dy = 0;
    if (f && dh > sh) {  // ScalePlaneBilinearUp
        scale_slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
        const int max_y = (sh - 1) << 16;
        auto cols = [&](uint8_t* d, const uint8_t* s) {
            if (f) filter_cols(d, s, dw, x, dx);
            else scale_cols(d, s, dw, x, dx);
        };
        if (y > max_y) y = max_y;
        int yi = y >> 16;
        const uint8_t* s = src + static_cast<ptrdiff_t>(yi) * ss;
        std::vector<uint8_t> rows(static_cast<size_t>(2 * dw) + 2);
        uint8_t* rowptr = rows.data();
        ptrdiff_t rowstride = dw;
        int lasty = yi;
        cols(rowptr, s);
        if (sh > 1) s += ss;
        cols(rowptr + rowstride, s);
        if (sh > 2) s += ss;
        for (int j = 0; j < dh; ++j, y += dy) {
            yi = y >> 16;
            if (yi != lasty) {
                if (y > max_y) {
                    y = max_y;
                    yi = y >> 16;
                    s = src + static_cast<ptrdiff_t>(yi) * ss;
                }
                if (yi != lasty) {
                    cols(rowptr, s);
                    rowptr += rowstride;
                    rowstride = -rowstride;
                    lasty = yi;
                    if (y + 65536 < max_y) s += ss;
                }
            }
            uint8_t* d = dst + static_cast<ptrdiff_t>(j) * ds;
            if (f == kFilterLinear) interpolate_row(d, rowptr, 0, dw, 0);
            else interpolate_row(d, rowptr, rowstride, dw, (y >> 8) & 255);
        }
        return;
    }
    if (f) {  // ScalePlaneBilinearDown
        scale_slope(sw, sh, dw, dh, f, &x, &y, &dx, &dy);
        const int max_y = (sh - 1) << 16;
        std::vector<uint8_t> row(static_cast<size_t>(sw) + 1);
        if (y > max_y) y = max_y;
        for (int j = 0; j < dh; ++j) {
            const uint8_t* s = src + static_cast<ptrdiff_t>(y >> 16) * ss;
            uint8_t* d = dst + static_cast<ptrdiff_t>(j) * ds;
            if (f == kFilterLinear) {
                filter_cols(d, s, dw, x, dx);
            } else {
                interpolate_row(row.data(), s, ss, sw, (y >> 8) & 255);
                filter_cols(d, row.data(), dw, x, dx);
            }
            y += dy;
            if (y > max_y) y = max_y;
        }
        return;
    }
    scale_slope(sw, sh, dw, dh, kFilterNone, &x, &y, &dx, &dy);  // ScalePlaneSimple
    for (int i = 0; i < dh; ++i, y += dy) scale_cols(dst + static_cast<ptrdiff_t>(i) * ds, src + static_cast<ptrdiff_t>(y >> 16) * ss, dw, x, dx);
}

}  // namespace

// a plane sw × sh (rows packed) → dw × dh (rows packed); 0, or 2 where
// libavif refuses the scale (a side over 16384, or of 0)
extern "C" int mmtrs_avif_scale_plane(const void* src, int sw, int sh, void* dst, int dw, int dh) {
    if (sw > 16384 || sh > 16384 || sw < 1 || sh < 1 || dw < 1 || dh < 1) return 2;
    scale_plane(static_cast<const uint8_t*>(src), sw, sw, sh, static_cast<uint8_t*>(dst), dw, dw, dh);
    return 0;
}
