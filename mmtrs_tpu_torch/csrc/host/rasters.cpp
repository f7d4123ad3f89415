// The sequential loops of utils/rasters.py's decoders, each a loop whose
// every step depends on the one before, as Pillow 12.1 runs it: TGA's,
// PCX's and SGI's run-length codes, QOI, the BCn block formats (BC1-BC7 of
// DDS and BLP2), CCITT fax (TIFF compressions 2, 3 and 4), FLI/FLC frames
// and PhotoCD; and Pillow's CIELab -> RGB conversion (LittleCMS's grid).
//
// C API (ctypes, plain C, no dependencies; every return is a status):
//   int mmtrs_tga_rle(const void* src, long long n, int pixel_bytes,
//                     long long row_bytes, void* dst, long long cap,
//                     void* used);
//     Packets of a byte (bit 7: a run; bits 0-6: count - 1) and one pixel
//     (a run) or count pixels (raw), filling dst continuously: a raw packet
//     may cross a row, a run may not (Pillow's TgaRleDecode overruns).
//     used: long long[1] <- source bytes read. 0 filled, 1 the source
//     ended first, 2 a run past its row's end.
//   int mmtrs_sun_rle(const void* src, long long n, void* dst, long long cap,
//                     void* used);
//     Sun raster RLE: 0x80 0 is the byte 0x80, 0x80 n v is n + 1 bytes v,
//     any other byte itself; runs fill dst continuously. 0 filled, 1 the
//     source ended first.
//   int mmtrs_pcx_rle(const void* src, long long n, long long row_bytes,
//                     int rows, void* dst, void* used);
//     A byte 0xC0 | count repeats the next byte count times, another byte
//     is itself. 0 filled, 1 the source ended first, 2 a run past the end
//     of its row (Pillow's PcxDecode overruns).
//   int mmtrs_packbits_rows(const void* src, long long n, long long row_bytes,
//                           int rows, void* dst, void* used);
//     PackBits as Pillow's PackbitsDecode reads PSD channels: 0x80 a no-op,
//     a run or literal that passes the end of a row cut there. 0 filled, 1
//     the source ended first.
//   int mmtrs_sgi_rle(const void* src, long long n, int w, int h, int z,
//                     int bpc, void* dst);
//     src: the file after its 512-byte header (the offset and length
//     tables, then the rows); dst: h rows of w x z samples (bpc bytes each,
//     big-endian as stored) in file order (the bottom row first), rows as
//     Pillow's SgiRleDecode leaves them: a row's buffer is not cleared
//     between rows, a row's length bounds its packets but not the file
//     (the terminator or the file's end does), and a row ending without its
//     0 terminator stops the decode. 0 ok, 1 a table or row outside the
//     file, or a run past the row.
//   int mmtrs_qoi_decode(const void* src, long long n, int w, int h,
//                        int channels, void* dst);
//     The QOI ops as Pillow's QoiDecoder reads them, dst w x h x channels.
//     0 ok, 1 the data ended first.
//   int mmtrs_bcn_decode(const void* src, long long n, int w, int h,
//                        int format, int sign, void* dst);
//     format 1-7 (BC1..BC7; sign: BC5's and BC6H's signed variants), dst
//     w x h pixels of 4 (BC1-3, BC7), 1 (BC4) or 3 (BC5, BC6H) bytes,
//     blocks 4x4 in rows, the image cropped from the block grid. 0 ok, 1
//     fewer bytes than the blocks need.
//   int mmtrs_ccitt_decode(const void* src, long long n, int w, int rows,
//                          int compression, int options, void* dst,
//                          void* done);
//     compression 2 (modified Huffman, rows byte-aligned, no EOL), 3
//     (Group 3; options: TIFF's T4Options, bit 0 two-dimensional rows) or
//     4 (Group 4); src in FillOrder 1 (the high bit first). dst: rows x w
//     bytes, 1 where the fax is black. done: int[1] <- rows decoded. 0 ok,
//     1 a code that is not T.4's or a run past the row, 2 the data ended
//     before the rows.
//   int mmtrs_fli_frame(const void* src, long long n, int w, int h, void* dst);
//     One FLI/FLC frame chunk as Pillow's FliDecode applies it to dst (h
//     rows of w palette indices, the buffer it starts from): BLACK, BRUN,
//     COPY, LC (byte delta) and SS2 (word delta, with its skip and last-byte
//     words); colour and stamp chunks skipped. src: the bytes Pillow's
//     reader holds (the frame, or fewer at a file's end), each bound checked
//     against them as Pillow checks it. 0 ok, 1 a packet or row past the
//     data or the image (Pillow's overrun), 2 not a frame chunk or an
//     unknown chunk, 3 a chunk of size 0, 4 a COPY chunk short of its data.
//   int mmtrs_pcd_decode(const void* src, long long n, void* dst);
//     PhotoCD's 768 x 512 base image as Pillow's PcdDecode reads it: src from
//     the image's offset, rows in pairs (two luma rows of 768, then 384 of
//     each chroma, whose samples cover a 2 x 2 block), each pixel's (Y, C1,
//     C2) through Pillow's PhotoYCC unpacker (UnpackYCC.c's tables, clipped
//     sums), dst 512 x 768 x 3 RGB. 0 ok, 1 the data ended first.
//   int mmtrs_lab_to_rgb(const void* src, long long pixels, void* dst);
//     Pillow's LAB (L, a + 128, b + 128 bytes) -> RGB as its LittleCMS
//     transform computes it: each byte times 257, tetrahedral interpolation
//     in lab_tables.h's 33^3 grid (cmsintrp.c's TetrahedralInterp16), 16 to
//     8 bits rounded as lcms2's FROM_16_TO_8. Integers only. 0 ok.
//
// Build: g++ -O3 -fPIC -shared rasters.cpp (see mmtrs_tpu_torch/_build.py)

#include <cstdint>
#include <cstring>
#include <vector>

#include "lab_tables.h"
#include "raster_tables.h"

namespace {

typedef unsigned char u8;

// ---------------------------------------------------------------------------
// BCn (Pillow's BcnDecode.c)
// ---------------------------------------------------------------------------

struct rgba { u8 r, g, b, a; };

inline rgba decode_565(uint16_t x) {
    rgba c;
    int r = (x & 0xf800) >> 8; r |= r >> 5;
    int g = (x & 0x7e0) >> 3; g |= g >> 6;
    int b = (x & 0x1f) << 3; b |= b >> 5;
    c.r = static_cast<u8>(r); c.g = static_cast<u8>(g); c.b = static_cast<u8>(b); c.a = 0xff;
    return c;
}

inline uint16_t load16(const u8* p) { return static_cast<uint16_t>(p[0] | (p[1] << 8)); }
inline uint32_t load32(const u8* p) {
    return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) | (static_cast<uint32_t>(p[2]) << 16)
           | (static_cast<uint32_t>(p[3]) << 24);
}

void bc1_color(rgba* dst, const u8* src, bool separate_alpha) {
    const uint16_t c0 = load16(src), c1 = load16(src + 2);
    const uint32_t lut = load32(src + 4);
    rgba p[4];
    p[0] = decode_565(c0);
    p[1] = decode_565(c1);
    const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
    if (c0 > c1 || separate_alpha) {  // BC2 and BC3 always act as c0 > c1
        p[2] = {static_cast<u8>((2 * r0 + r1) / 3), static_cast<u8>((2 * g0 + g1) / 3),
                static_cast<u8>((2 * b0 + b1) / 3), 0xff};
        p[3] = {static_cast<u8>((r0 + 2 * r1) / 3), static_cast<u8>((g0 + 2 * g1) / 3),
                static_cast<u8>((b0 + 2 * b1) / 3), 0xff};
    } else {
        p[2] = {static_cast<u8>((r0 + r1) / 2), static_cast<u8>((g0 + g1) / 2), static_cast<u8>((b0 + b1) / 2), 0xff};
        p[3] = {0, 0, 0, 0};
    }
    for (int n = 0; n < 16; ++n) dst[n] = p[3 & (lut >> (2 * n))];
}

// BC3's alpha block (BC4 and BC5 channels too): 8 levels from two
// endpoints, written into byte ``o`` of ``stride``-byte pixels
void bc3_alpha(u8* dst, const u8* src, int stride, int o, bool sign) {
    int a0, a1;
    if (sign) {
        a0 = static_cast<int8_t>(src[0]) + 128;
        a1 = static_cast<int8_t>(src[1]) + 128;
    } else {
        a0 = src[0];
        a1 = src[1];
    }
    const int lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
    const int lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
    u8 a[8];
    a[0] = static_cast<u8>(a0);
    a[1] = static_cast<u8>(a1);
    if (a0 > a1) {
        for (int i = 1; i < 7; ++i) a[i + 1] = static_cast<u8>(((7 - i) * a0 + i * a1) / 7);
    } else {
        for (int i = 1; i < 5; ++i) a[i + 1] = static_cast<u8>(((5 - i) * a0 + i * a1) / 5);
        a[6] = 0;
        a[7] = 0xff;
    }
    for (int n = 0; n < 8; ++n) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
    for (int n = 0; n < 8; ++n) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

inline int get_bit(const u8* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

inline int get_bits(const u8* src, int bit, int count) {
    if (!count) return 0;
    const int by = bit >> 3;
    bit &= 7;
    if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
    const int x = src[by] | (src[by + 1] << 8);
    return (x >> bit) & ((1 << count) - 1);
}

const uint8_t* weights(int n) { return n == 2 ? kWeights2 : n == 3 ? kWeights3 : kWeights4; }

inline int subset(int ns, int partition, int n) {
    if (ns == 2) return 1 & (kBc7Subsets2[partition] >> n);
    if (ns == 3) return 3 & (kBc7Subsets3[partition] >> (2 * n));
    return 0;
}

inline u8 expand_quantized(u8 v, int bits) {
    v = static_cast<u8>(v << (8 - bits));
    return static_cast<u8>(v | (v >> bits));
}

void bc7_lerp(rgba* dst, const rgba* e, int s0, int s1) {
    const int t0 = 64 - s0, t1 = 64 - s1;
    dst->r = static_cast<u8>((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
    dst->g = static_cast<u8>((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
    dst->b = static_cast<u8>((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
    dst->a = static_cast<u8>((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(rgba* col, const u8* src) {
    int mode = src[0];
    if (!mode) {  // no mode bit set: a reserved block
        for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
        return;
    }
    int bit = 0;
    while (!(mode & (1 << bit++))) {}
    mode = bit - 1;
    const uint8_t* info = kBc7Modes[mode];  // ns pb rb isb cb ab epb spb ib ib2
    const int ns = info[0], ib_c = info[8], ib2_m = info[9];
    int cb = info[4], ab = info[5];
    const uint8_t* cw = weights(ib_c);
    const uint8_t* aw = weights((ab && ib2_m) ? ib2_m : ib_c);
    const int partition = get_bits(src, bit, info[1]); bit += info[1];
    const int rotation = get_bits(src, bit, info[2]); bit += info[2];
    const int index_sel = get_bits(src, bit, info[3]); bit += info[3];
    const int numep = ns << 1;
    rgba ep[6];
    for (int i = 0; i < numep; ++i) { ep[i].r = static_cast<u8>(get_bits(src, bit, cb)); bit += cb; }
    for (int i = 0; i < numep; ++i) { ep[i].g = static_cast<u8>(get_bits(src, bit, cb)); bit += cb; }
    for (int i = 0; i < numep; ++i) { ep[i].b = static_cast<u8>(get_bits(src, bit, cb)); bit += cb; }
    for (int i = 0; i < numep; ++i) {
        if (ab) { ep[i].a = static_cast<u8>(get_bits(src, bit, ab)); bit += ab; } else { ep[i].a = 255; }
    }
    auto assign_p = [](u8& x, int v) { x = static_cast<u8>((x << 1) | v); };
    if (info[6]) {  // a p-bit per endpoint
        cb++;
        if (ab) ab++;
        for (int i = 0; i < numep; ++i) {
            const int v = get_bits(src, bit, 1); bit += 1;
            assign_p(ep[i].r, v); assign_p(ep[i].g, v); assign_p(ep[i].b, v);
            if (ab) assign_p(ep[i].a, v);
        }
    }
    if (info[7]) {  // a p-bit per subset
        cb++;
        if (ab) ab++;
        for (int i = 0; i < numep; i += 2) {
            const int v = get_bits(src, bit, 1); bit += 1;
            for (int j = 0; j < 2; ++j) {
                assign_p(ep[i + j].r, v); assign_p(ep[i + j].g, v); assign_p(ep[i + j].b, v);
                if (ab) assign_p(ep[i + j].a, v);
            }
        }
    }
    for (int i = 0; i < numep; ++i) {
        ep[i].r = expand_quantized(ep[i].r, cb);
        ep[i].g = expand_quantized(ep[i].g, cb);
        ep[i].b = expand_quantized(ep[i].b, cb);
        if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
    }
    int cibit = bit;
    int aibit = cibit + 16 * ib_c - ns;
    for (int i = 0; i < 16; ++i) {
        const int s = subset(ns, partition, i) << 1;
        int ib = ib_c;
        if (i == 0) {
            ib--;
        } else if (ns == 2) {
            if (i == kBc7Anchor2[partition]) ib--;
        } else if (ns == 3) {
            if (i == kBc7Anchor3a[partition]) ib--;
            else if (i == kBc7Anchor3b[partition]) ib--;
        }
        const int i0 = get_bits(src, cibit, ib);
        cibit += ib;
        if (ab && ib2_m) {
            int ib2 = ib2_m;
            if (i == 0) ib2--;
            const int i1 = get_bits(src, aibit, ib2);
            aibit += ib2;
            if (index_sel) bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
            else bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
        } else {
            bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
        }
        u8 t;
        if (rotation == 1) { t = col[i].r; col[i].r = col[i].a; col[i].a = t; }
        else if (rotation == 2) { t = col[i].g; col[i].g = col[i].a; col[i].a = t; }
        else if (rotation == 3) { t = col[i].b; col[i].b = col[i].a; col[i].a = t; }
    }
}

inline void bc6_sign_extend(uint16_t* v, int prec) {
    int x = *v;
    if (x & (1 << (prec - 1))) x |= -1 << prec;
    *v = static_cast<uint16_t>(x);
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
    int x;
    if (!sign) {
        x = v;
        if (prec >= 15) return x;
        if (x == 0) return 0;
        if (x == ((1 << prec) - 1)) return 0xffff;
        return ((x << 15) + 0x4000) >> (prec - 1);
    }
    x = static_cast<int16_t>(v);
    if (prec >= 16) return x;
    bool s = false;
    if (x < 0) { s = true; x = -x; }
    if (x != 0) {
        if (x >= ((1 << (prec - 1)) - 1)) x = 0x7fff;
        else x = ((x << 15) + 0x4000) >> (prec - 1);
    }
    return s ? -x : x;
}

float half_to_float(uint16_t h) {
    union { uint32_t u; float f; } o, m;
    m.u = 0x77800000;
    o.u = static_cast<uint32_t>(h & 0x7fff) << 13;
    o.f *= m.f;
    m.u = 0x47800000;
    if (o.f >= m.f) o.u |= 255u << 23;
    o.u |= static_cast<uint32_t>(h & 0x8000) << 16;
    return o.f;
}

float bc6_finalize(int v, bool sign) {
    if (sign) {
        if (v < 0) return half_to_float(static_cast<uint16_t>(0x8000 | ((-v) * 31) / 32));
        return half_to_float(static_cast<uint16_t>((v * 31) / 32));
    }
    return half_to_float(static_cast<uint16_t>((v * 31) / 64));
}

inline u8 bc6_clamp(float value) {
    if (value < 0.0f) return 0;
    if (value > 1.0f) return 255;
    return static_cast<u8>(value * 255.0f);
}

void bc6_lerp(rgba* col, const int* e0, const int* e1, int s, bool sign) {
    const int t = 64 - s;
    col->r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * s) >> 6, sign));
    col->g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * s) >> 6, sign));
    col->b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void bc6_block(rgba* col, const u8* src, bool sign) {
    int bit = 5, epbits = 75, ib = 3;
    int mode = src[0] & 0x1f;
    if ((mode & 3) == 0 || (mode & 3) == 1) {
        mode &= 3;
        bit = 2;
    } else if ((mode & 3) == 2) {
        mode = 2 + (mode >> 2);
        epbits = 72;
    } else {
        mode = 10 + (mode >> 2);
        epbits = 60;
        ib = 4;
    }
    if (mode >= 14) {  // a reserved mode
        std::memset(col, 0, 16 * sizeof(rgba));
        return;
    }
    const uint8_t* info = kBc6Modes[mode];  // ns tr pb epb rb gb bb
    const int ns = info[0], tr = info[1], pb = info[2], epb = info[3];
    const uint8_t* cw = weights(ib);
    const int numep = ns == 2 ? 12 : 6;
    uint16_t ep[12] = {0};
    for (int i = 0; i < epbits; ++i) {
        const int di = kBc6Packings[mode][i];
        ep[di >> 4] = static_cast<uint16_t>(ep[di >> 4] | (get_bit(src, bit + i) << (di & 15)));
    }
    bit += epbits;
    const int partition = get_bits(src, bit, pb);
    bit += pb;
    const int mask = (1 << epb) - 1;
    if (sign) {
        bc6_sign_extend(&ep[0], epb);
        bc6_sign_extend(&ep[1], epb);
        bc6_sign_extend(&ep[2], epb);
    }
    if (sign || tr) {
        for (int i = 3; i < numep; i += 3) {
            bc6_sign_extend(&ep[i], info[4]);
            bc6_sign_extend(&ep[i + 1], info[5]);
            bc6_sign_extend(&ep[i + 2], info[6]);
        }
    }
    if (tr) {
        for (int i = 3; i < numep; i += 3) {
            ep[i] = static_cast<uint16_t>((ep[i] + ep[0]) & mask);
            ep[i + 1] = static_cast<uint16_t>((ep[i + 1] + ep[1]) & mask);
            ep[i + 2] = static_cast<uint16_t>((ep[i + 2] + ep[2]) & mask);
        }
        // no sign extension after the deltas, as Pillow's decoder has it: a
        // signed endpoint the deltas made negative unquantises as positive
    }
    int ueps[12];
    for (int i = 0; i < numep; ++i) ueps[i] = bc6_unquantize(ep[i], epb, sign);
    for (int i = 0; i < 16; ++i) {
        const int s = subset(ns, partition, i) * 6;
        int ib2 = ib;
        if (i == 0) ib2--;
        else if (ns == 2 && i == kBc7Anchor2[partition]) ib2--;
        const int i0 = get_bits(src, bit, ib2);
        bit += ib2;
        bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
    }
}

// ---------------------------------------------------------------------------
// CCITT T.4 / T.6
// ---------------------------------------------------------------------------

struct BitReader {
    const u8* p;
    long long n;   // bytes
    long long pos; // bits
    int bit() {
        if (pos >= n * 8) { pos++; return -1; }
        const int b = (p[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    bool at_end() const { return pos >= n * 8; }
    void align() { pos = (pos + 7) & ~7LL; }
};

// code lookup: [bits][code] -> run (-1: none), 2..13 bits
struct RunTable {
    std::vector<int> by_len[14];
    explicit RunTable(const int32_t (*codes)[3]) {
        for (int l = 0; l < 14; ++l) by_len[l].assign(1 << l, -1);
        for (int i = 0; i < 104; ++i) by_len[codes[i][0]][codes[i][1]] = codes[i][2];
    }
};

const RunTable& white_table() { static RunTable t(kFaxWhite); return t; }
const RunTable& black_table() { static RunTable t(kFaxBlack); return t; }

// one code of ``color``; -1 bad code, -2 end of data
int read_code(BitReader& br, const RunTable& t) {
    int code = 0;
    for (int len = 1; len <= 13; ++len) {
        const int b = br.bit();
        if (b < 0) return -2;
        code = (code << 1) | b;
        if (len >= 2 && t.by_len[len][code] >= 0) return t.by_len[len][code];
    }
    return -1;
}

// a run: make-up codes then one terminating code; -1 bad, -2 end
int read_run(BitReader& br, int color) {
    const RunTable& t = color ? black_table() : white_table();
    int total = 0;
    for (;;) {
        const int r = read_code(br, t);
        if (r < 0) return r;
        total += r;
        if (r < 64) return total;
    }
}

// skip to after the next EOL (eleven or more 0 bits, then a 1): false at the end
bool sync_eol(BitReader& br) {
    int zeros = 0;
    for (;;) {
        const int b = br.bit();
        if (b < 0) return false;
        if (b == 0) {
            zeros++;
        } else {
            if (zeros >= 11) return true;
            zeros = 0;
        }
    }
}

// a row's changing elements (positions where the colour changes, from
// white) from its pixels
void changes_of(const u8* row, int w, std::vector<int>& ch) {
    ch.clear();
    int c = 0;
    for (int x = 0; x < w; ++x) {
        if (row[x] != c) { ch.push_back(x); c = row[x]; }
    }
}

void fill(u8* row, int from, int to, int color) {
    if (from < 0) from = 0;
    if (color && to > from) std::memset(row + from, 1, static_cast<size_t>(to - from));
}

int decode_1d(BitReader& br, u8* row, int w) {
    int a0 = 0, color = 0;
    while (a0 < w) {
        const int run = read_run(br, color);
        if (run < 0) return run == -2 ? 2 : 1;
        if (a0 + run > w) return 1;
        fill(row, a0, a0 + run, color);
        a0 += run;
        color ^= 1;
    }
    return 0;
}

// the mode codes of T.4's two-dimensional coding: 1 V0, 011 VR1, 010 VL1,
// 001 H, 0001 P, 000011 VR2, 000010 VL2, 0000011 VR3, 0000010 VL3
// -> 0..6 = V(-3..3) as 3 + offset, 7 H, 8 P; -1 bad, -2 end
int read_mode(BitReader& br) {
    int code = 0;
    for (int len = 1; len <= 7; ++len) {
        const int b = br.bit();
        if (b < 0) return -2;
        code = (code << 1) | b;
        switch (len) {
            case 1: if (code == 1) return 3; break;
            case 3: if (code == 3) return 4; if (code == 2) return 2; if (code == 1) return 7; break;
            case 4: if (code == 1) return 8; break;
            case 6: if (code == 3) return 5; if (code == 2) return 1; break;
            case 7: if (code == 3) return 6; if (code == 2) return 0; break;
            default: break;
        }
    }
    return -1;
}

int decode_2d(BitReader& br, u8* row, int w, const std::vector<int>& ref) {
    // ref: the reference row's changing elements, padded with w
    int a0 = -1, color = 0;
    size_t i = 0;
    while (a0 < w) {
        // b1: the first changing element of the reference row right of a0
        // (at or right of 0 at the row's start) whose colour is opposite to
        // ``color``: even entries turn black, odd ones white
        const int start = a0 < 0 ? 0 : a0 + 1;
        i = 0;
        while (i < ref.size() && (ref[i] < start || static_cast<int>(i & 1) != color)) ++i;
        const int b1 = i < ref.size() ? ref[i] : w;
        const int b2 = i + 1 < ref.size() ? ref[i + 1] : w;
        const int m = read_mode(br);
        if (m < 0) return m == -2 ? 2 : 1;
        const int from = a0 < 0 ? 0 : a0;
        if (m == 8) {  // pass
            fill(row, from, b2, color);
            a0 = b2;
        } else if (m == 7) {  // horizontal: two runs from a0
            const int r1 = read_run(br, color);
            if (r1 < 0) return r1 == -2 ? 2 : 1;
            const int r2 = read_run(br, color ^ 1);
            if (r2 < 0) return r2 == -2 ? 2 : 1;
            if (from + r1 + r2 > w) return 1;
            fill(row, from, from + r1, color);
            fill(row, from + r1, from + r1 + r2, color ^ 1);
            a0 = from + r1 + r2;
        } else {  // vertical: a1 = b1 + offset
            const int a1 = b1 + (m - 3);
            if (a1 < from || a1 > w) return 1;
            fill(row, from, a1, color);
            a0 = a1;
            color ^= 1;
        }
    }
    return 0;
}

}  // namespace

extern "C" int mmtrs_tga_rle(const void* src, long long n, int pixel_bytes, long long row_bytes, void* dst,
                             long long cap, void* used) {
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    long long i = 0, o = 0;
    while (o < cap) {
        if (i >= n) { *static_cast<long long*>(used) = i; return 1; }
        const int head = in[i++];
        const long long count = (head & 0x7f) + 1;
        if (head & 0x80) {
            if (i + pixel_bytes > n) { *static_cast<long long*>(used) = i; return 1; }
            if (o % row_bytes + count * pixel_bytes > row_bytes) { *static_cast<long long*>(used) = i; return 2; }
            for (long long k = 0; k < count && o < cap; ++k)
                for (int b = 0; b < pixel_bytes && o < cap; ++b) out[o++] = in[i + b];
            i += pixel_bytes;
        } else {
            const long long bytes = count * pixel_bytes;
            if (i + bytes > n) { *static_cast<long long*>(used) = i; return 1; }
            for (long long k = 0; k < bytes && o < cap; ++k) out[o++] = in[i + k];
            i += bytes;
        }
    }
    *static_cast<long long*>(used) = i;
    return 0;
}

extern "C" int mmtrs_sun_rle(const void* src, long long n, void* dst, long long cap, void* used) {
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    long long i = 0, o = 0;
    while (o < cap) {
        if (i >= n) { *static_cast<long long*>(used) = i; return 1; }
        if (in[i] == 0x80) {
            if (i + 1 >= n) { *static_cast<long long*>(used) = i; return 1; }
            if (in[i + 1] == 0) {
                out[o++] = 0x80;
                i += 2;
            } else {
                if (i + 2 >= n) { *static_cast<long long*>(used) = i; return 1; }
                for (int k = in[i + 1] + 1; k > 0 && o < cap; --k) out[o++] = in[i + 2];
                i += 3;
            }
        } else {
            out[o++] = in[i++];
        }
    }
    *static_cast<long long*>(used) = i;
    return 0;
}

extern "C" int mmtrs_pcx_rle(const void* src, long long n, long long row_bytes, int rows, void* dst, void* used) {
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    long long i = 0;
    for (int y = 0; y < rows; ++y) {
        u8* row = out + y * row_bytes;
        long long x = 0;
        while (x < row_bytes) {
            if (i >= n) { *static_cast<long long*>(used) = i; return 1; }
            if ((in[i] & 0xC0) == 0xC0) {
                if (i + 1 >= n) { *static_cast<long long*>(used) = i; return 1; }
                const int count = in[i] & 0x3F;
                if (x + count > row_bytes) { *static_cast<long long*>(used) = i; return 2; }
                for (int k = 0; k < count; ++k) row[x++] = in[i + 1];
                i += 2;
            } else {
                row[x++] = in[i++];
            }
        }
    }
    *static_cast<long long*>(used) = i;
    return 0;
}

extern "C" int mmtrs_packbits_rows(const void* src, long long n, long long row_bytes, int rows, void* dst,
                                  void* used) {
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    long long i = 0;
    for (int y = 0; y < rows; ++y) {
        u8* row = out + y * row_bytes;
        long long x = 0;
        while (x < row_bytes) {
            if (i >= n) { *static_cast<long long*>(used) = i; return 1; }
            const int head = in[i];
            if (head & 0x80) {
                if (head == 0x80) { i++; continue; }
                if (i + 1 >= n) { *static_cast<long long*>(used) = i; return 1; }
                for (int k = 257 - head; k > 0 && x < row_bytes; --k) row[x++] = in[i + 1];
                i += 2;
            } else {
                const long long len = head + 1;
                if (i + 1 + len > n) { *static_cast<long long*>(used) = i; return 1; }
                for (long long k = 0; k < len && x < row_bytes; ++k) row[x++] = in[i + 1 + k];
                i += 1 + len;
            }
        }
    }
    *static_cast<long long*>(used) = i;
    return 0;
}

namespace {

// Pillow's expandrow/expandrow2: -1 overrun, 1 the row's last byte is not
// the terminator, 0 ok
int sgi_row(u8* dest, const u8* src, long long n, int z, int xsize, const u8* end, int bpc) {
    int x = 0;
    for (; n > 0; n--) {
        if (src + (bpc - 1) > end) return -1;
        const u8 pixel = bpc == 1 ? src[0] : src[1];
        src += bpc;
        if (n == 1 && pixel != 0) return 1;
        int count = pixel & 0x7f;
        if (!count) return 0;
        if (x + count > xsize) return -1;
        x += count;
        if (pixel & 0x80) {
            if (src + static_cast<long long>(bpc) * count > end + (bpc == 1 ? 1 : 0)) return -1;
            while (count--) {
                std::memcpy(dest, src, static_cast<size_t>(bpc));
                src += bpc;
                dest += static_cast<long long>(z) * bpc;
            }
        } else {
            if (src + (bpc == 1 ? 0 : 2) > end) return -1;
            while (count--) {
                std::memcpy(dest, src, static_cast<size_t>(bpc));
                dest += static_cast<long long>(z) * bpc;
            }
            src += bpc;
        }
    }
    return 0;
}

}  // namespace

extern "C" int mmtrs_sgi_rle(const void* src, long long n, int w, int h, int z, int bpc, void* dst) {
    const u8* buf = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    const long long tablen = static_cast<long long>(z) * h;
    if (n < 8 * tablen) return 1;
    auto be32 = [&](long long at) {
        return static_cast<long long>((static_cast<uint32_t>(buf[at]) << 24) | (buf[at + 1] << 16) | (buf[at + 2] << 8)
                                      | buf[at + 3]);
    };
    const long long row_bytes = static_cast<long long>(w) * z * bpc;
    std::vector<u8> row(static_cast<size_t>(row_bytes), 0);  // kept between rows, as Pillow keeps it
    const u8* end = buf + n - 1;
    for (int y = 0; y < h; ++y) {
        for (int c = 0; c < z; ++c) {
            long long off = be32(4 * (y + static_cast<long long>(c) * h));
            const long long len = be32(4 * (tablen + y + static_cast<long long>(c) * h));
            if (off < 512) return 1;
            off -= 512;
            if (off >= n) return 1;  // the row starts past the file (Pillow's expandrow overruns at once)
            const int status = sgi_row(row.data() + static_cast<long long>(c) * bpc, buf + off, len, z, w, end, bpc);
            if (status == -1) return 1;
            if (status == 1) return 0;
        }
        std::memcpy(out + y * row_bytes, row.data(), static_cast<size_t>(row_bytes));
    }
    return 0;
}

extern "C" int mmtrs_qoi_decode(const void* src, long long n, int w, int h, int channels, void* dst) {
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    u8 seen[64][4];
    bool have[64] = {false};
    u8 prev[4] = {0, 0, 0, 255};
    const long long total = static_cast<long long>(w) * h;
    long long px = 0, i = 0;
    auto put = [&](const u8* v) {
        if (px < total) std::memcpy(out + px * channels, v, static_cast<size_t>(channels));
        px++;
    };
    auto remember = [&](const u8* v) {
        std::memcpy(prev, v, 4);
        const int hsh = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
        std::memcpy(seen[hsh], v, 4);
        have[hsh] = true;
    };
    while (px < total) {
        if (i >= n) return 1;
        const int byte = in[i++];
        u8 v[4];
        if (byte == 0xFE) {
            if (i + 3 > n) return 1;
            v[0] = in[i]; v[1] = in[i + 1]; v[2] = in[i + 2]; v[3] = prev[3];
            i += 3;
        } else if (byte == 0xFF) {
            if (i + 4 > n) return 1;
            std::memcpy(v, in + i, 4);
            i += 4;
        } else {
            const int op = byte >> 6;
            if (op == 0) {
                const int idx = byte & 0x3F;
                if (have[idx]) std::memcpy(v, seen[idx], 4);
                else std::memset(v, 0, 4);
            } else if (op == 1) {
                v[0] = static_cast<u8>(prev[0] + ((byte & 0x30) >> 4) - 2);
                v[1] = static_cast<u8>(prev[1] + ((byte & 0x0C) >> 2) - 2);
                v[2] = static_cast<u8>(prev[2] + (byte & 0x03) - 2);
                v[3] = prev[3];
            } else if (op == 2) {
                if (i >= n) return 1;
                const int second = in[i++];
                const int dg = (byte & 0x3F) - 32, dr = ((second & 0xF0) >> 4) - 8, db = (second & 0x0F) - 8;
                v[0] = static_cast<u8>(prev[0] + dg + dr);
                v[1] = static_cast<u8>(prev[1] + dg);
                v[2] = static_cast<u8>(prev[2] + dg + db);
                v[3] = prev[3];
            } else {  // a run of the previous pixel; the index is not updated
                const int run = (byte & 0x3F) + 1;
                for (int k = 0; k < run; ++k) put(prev);
                continue;
            }
        }
        remember(v);
        put(v);
    }
    return 0;
}

extern "C" int mmtrs_bcn_decode(const void* src, long long n, int w, int h, int format, int sign, void* dst) {
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    const int block = (format == 1 || format == 4) ? 8 : 16;
    const int channels = format == 4 ? 1 : (format == 5 || format == 6) ? 3 : 4;
    const int bw = (w + 3) / 4, bh = (h + 3) / 4;
    if (n < static_cast<long long>(bw) * bh * block) return 1;
    rgba col[16];
    u8 lum[16];
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
            const u8* b = in + (static_cast<long long>(by) * bw + bx) * block;
            std::memset(col, 0, sizeof(col));
            switch (format) {
                case 1: bc1_color(col, b, false); break;
                case 2:
                    bc1_color(col, b + 8, true);
                    for (int k = 0; k < 16; ++k) {
                        const int bi = k * 4;
                        const int av = 0xf & (b[bi >> 3] >> (bi & 7));
                        col[k].a = static_cast<u8>((av << 4) | av);
                    }
                    break;
                case 3:
                    bc1_color(col, b + 8, true);
                    bc3_alpha(reinterpret_cast<u8*>(col), b, 4, 3, false);
                    break;
                case 4: bc3_alpha(lum, b, 1, 0, false); break;
                case 5:
                    if (sign) for (int k = 0; k < 16; ++k) col[k].b = 128;  // Pillow's BC5S blue
                    bc3_alpha(reinterpret_cast<u8*>(col), b, 4, 0, sign != 0);
                    bc3_alpha(reinterpret_cast<u8*>(col), b + 8, 4, 1, sign != 0);
                    break;
                case 6: bc6_block(col, b, sign != 0); break;
                default: bc7_block(col, b); break;
            }
            for (int j = 0; j < 4; ++j) {
                const int y = by * 4 + j;
                if (y >= h) break;
                for (int i = 0; i < 4; ++i) {
                    const int x = bx * 4 + i;
                    if (x >= w) break;
                    u8* o = out + (static_cast<long long>(y) * w + x) * channels;
                    if (channels == 1) {
                        o[0] = lum[j * 4 + i];
                    } else {
                        const rgba& c = col[j * 4 + i];
                        o[0] = c.r; o[1] = c.g; o[2] = c.b;
                        if (channels == 4) o[3] = c.a;
                    }
                }
            }
        }
    }
    return 0;
}

extern "C" int mmtrs_ccitt_decode(const void* src, long long n, int w, int rows, int compression, int options,
                                  void* dst, void* done) {
    BitReader br{static_cast<const u8*>(src), n, 0};
    u8* out = static_cast<u8*>(dst);
    int* rows_done = static_cast<int*>(done);
    *rows_done = 0;
    std::vector<int> ref;  // the reference row's changing elements: all white at first
    ref.assign(2, w);
    std::vector<int> ch;
    const bool two_d = compression == 4 || (compression == 3 && (options & 1));
    for (int y = 0; y < rows; ++y) {
        u8* row = out + static_cast<long long>(y) * w;
        std::memset(row, 0, static_cast<size_t>(w));
        int status;
        if (compression == 2) {
            status = decode_1d(br, row, w);
            br.align();
        } else if (compression == 3) {
            if (!sync_eol(br)) return 2;
            bool one_d = true;
            if (two_d) {
                const int tag = br.bit();
                if (tag < 0) return 2;
                one_d = tag == 1;
            }
            status = one_d ? decode_1d(br, row, w) : decode_2d(br, row, w, ref);
        } else {
            status = decode_2d(br, row, w, ref);
        }
        if (status) return status;
        *rows_done = y + 1;
        if (two_d) {
            changes_of(row, w, ch);
            ref = ch;
            ref.push_back(w);
            ref.push_back(w);
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// FLI/FLC (FliDecode.c)
// ---------------------------------------------------------------------------

namespace {

inline int fli16(const u8* p) { return p[0] | (p[1] << 8); }
inline int32_t fli32(const u8* p) {
    return static_cast<int32_t>(static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
                                (static_cast<uint32_t>(p[2]) << 16) | (static_cast<uint32_t>(p[3]) << 24));
}

}  // namespace

extern "C" int mmtrs_fli_frame(const void* src, long long n, int w, int h, void* dst) {
    const u8* ptr = static_cast<const u8*>(src);
    u8* img = static_cast<u8*>(dst);
    long long bytes = n;
    if (bytes < 8) return 1;
    if (fli16(ptr + 4) != 0xF1FA) return 2;
    const int chunks = fli16(ptr + 6);
    ptr += 16;
    bytes -= 16;
    // Pillow's ERR_IF_DATA_OOB: data + off past the held bytes
#define OOB(off) if ((data - ptr) + static_cast<long long>(off) > bytes) return 1
    for (int c = 0; c < chunks; ++c) {
        if (bytes < 10) return 1;
        const u8* data = ptr + 6;
        switch (fli16(ptr + 4)) {
            case 4:
            case 11:
            case 18:
                break;
            case 7: {  // SS2: word delta
                const int lines = fli16(data);
                data += 2;
                int l = 0, y = 0;
                for (; l < lines && y < h; ++l, ++y) {
                    u8* row = img + static_cast<long long>(y) * w;
                    OOB(2);
                    int packets = fli16(data);
                    data += 2;
                    while (packets & 0x8000) {
                        if (packets & 0x4000) {
                            y += 65536 - packets;  // skip lines
                            if (y >= h) return 1;
                            row = img + static_cast<long long>(y) * w;
                        } else {
                            row[w - 1] = static_cast<u8>(packets);  // the last byte of an odd width
                        }
                        OOB(2);
                        packets = fli16(data);
                        data += 2;
                    }
                    int p = 0, x = 0;
                    for (; p < packets; ++p) {
                        OOB(2);
                        x += data[0];
                        if (data[1] >= 128) {
                            OOB(4);
                            const int i = 256 - data[1];
                            if (x + i + i > w) break;
                            for (int j = 0; j < i; ++j) {
                                row[x++] = data[2];
                                row[x++] = data[3];
                            }
                            data += 4;
                        } else {
                            const int i = 2 * data[1];
                            if (x + i > w) break;
                            OOB(2 + i);
                            std::memcpy(row + x, data + 2, static_cast<size_t>(i));
                            data += 2 + i;
                            x += i;
                        }
                    }
                    if (p < packets) break;
                }
                if (l < lines) return 1;
                break;
            }
            case 12: {  // LC: byte delta
                int y = fli16(data);
                const int ymax = y + fli16(data + 2);
                data += 4;
                for (; y < ymax && y < h; ++y) {
                    u8* row = img + static_cast<long long>(y) * w;
                    OOB(1);
                    const int packets = *data++;
                    int p = 0, x = 0, i = 0;
                    for (; p < packets; ++p, x += i) {
                        OOB(2);
                        x += data[0];
                        if (data[1] & 0x80) {
                            i = 256 - data[1];
                            if (x + i > w) break;
                            OOB(3);
                            std::memset(row + x, data[2], static_cast<size_t>(i));
                            data += 3;
                        } else {
                            i = data[1];
                            if (x + i > w) break;
                            OOB(2 + i);
                            std::memcpy(row + x, data + 2, static_cast<size_t>(i));
                            data += i + 2;
                        }
                    }
                    if (p < packets) break;
                }
                if (y < ymax) return 1;
                break;
            }
            case 13:
                std::memset(img, 0, static_cast<size_t>(w) * h);
                break;
            case 15:  // BRUN
                for (int y = 0; y < h; ++y) {
                    u8* row = img + static_cast<long long>(y) * w;
                    data += 1;  // the packet count, unused
                    int x = 0, i = 0;
                    for (; x < w; x += i) {
                        OOB(2);
                        if (data[0] & 0x80) {
                            i = 256 - data[0];
                            if (x + i > w) break;
                            OOB(i + 1);
                            std::memcpy(row + x, data + 1, static_cast<size_t>(i));
                            data += i + 1;
                        } else {
                            i = data[0];
                            if (x + i > w) break;
                            std::memset(row + x, data[1], static_cast<size_t>(i));
                            data += 2;
                        }
                    }
                    if (x != w) return 1;
                }
                break;
            case 16:  // COPY
                if ((data - ptr) + static_cast<long long>(w) * h > bytes) return 4;
                std::memcpy(img, data, static_cast<size_t>(w) * h);
                break;
            default:
                return 2;
        }
        const int32_t advance = fli32(ptr);
        if (advance == 0) return 3;
        if (advance < 0 || advance > bytes) return 1;
        ptr += advance;
        bytes -= advance;
    }
#undef OOB
    return 0;
}

// ---------------------------------------------------------------------------
// PhotoCD (PcdDecode.c, UnpackYCC.c)
// ---------------------------------------------------------------------------

extern "C" int mmtrs_pcd_decode(const void* src, long long n, void* dst) {
    constexpr int kW = 768, kH = 512, kPair = 3 * kW;
    if (n < static_cast<long long>(kPair) * (kH / 2)) return 1;
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    auto clip = [](int v) { return static_cast<u8>(v <= 0 ? 0 : v >= 255 ? 255 : v); };
    for (int pair = 0; pair < kH / 2; ++pair) {
        const u8* p = in + static_cast<long long>(pair) * kPair;
        for (int r = 0; r < 2; ++r) {
            u8* o = out + (static_cast<long long>(2 * pair + r) * kW) * 3;
            for (int x = 0; x < kW; ++x) {
                const int l = kYccL[p[x + r * kW]];
                const int cb = p[(x + 4 * kW) / 2], cr = p[(x + 5 * kW) / 2];
                o[3 * x] = clip(l + kYccCr[cr]);
                o[3 * x + 1] = clip(l + kYccGr[cr] + kYccGb[cb]);
                o[3 * x + 2] = clip(l + kYccCb[cb]);
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// CIELab -> RGB (LittleCMS's optimised transform, as Pillow builds it)
// ---------------------------------------------------------------------------

extern "C" int mmtrs_lab_to_rgb(const void* src, long long pixels, void* dst) {
    constexpr int kN = 33, kOptaL = 3 * kN * kN, kOptaA = 3 * kN, kOptaB = 3;
    const u8* in = static_cast<const u8*>(src);
    u8* out = static_cast<u8*>(dst);
    auto to_fixed = [](int v) { return v + (v + 0x7FFF) / 0xFFFF; };  // _cmsToFixedDomain
    for (long long i = 0; i < pixels; ++i, in += 3, out += 3) {
        const int L = in[0] * 257, A = in[1] * 257, B = in[2] * 257;
        const int fx = to_fixed(L * (kN - 1)), fy = to_fixed(A * (kN - 1)), fz = to_fixed(B * (kN - 1));
        const int rx = fx & 0xFFFF, ry = fy & 0xFFFF, rz = fz & 0xFFFF;
        int X1 = L == 0xFFFF ? 0 : kOptaL, Y1 = A == 0xFFFF ? 0 : kOptaA, Z1 = B == 0xFFFF ? 0 : kOptaB;
        const uint16_t* t = kLabGrid + (fx >> 16) * kOptaL + (fy >> 16) * kOptaA + (fz >> 16) * kOptaB;
        // the simplex's three further corners (cumulative offsets) and their weights
        int o1, o2, o3, w1, w2, w3;
        if (rx >= ry) {
            if (ry >= rz) { o1 = X1; o2 = X1 + Y1; w1 = rx; w2 = ry; w3 = rz; }
            else if (rz >= rx) { o1 = Z1; o2 = X1 + Z1; w1 = rz; w2 = rx; w3 = ry; }
            else { o1 = X1; o2 = X1 + Z1; w1 = rx; w2 = rz; w3 = ry; }
        } else {
            if (rx >= rz) { o1 = Y1; o2 = X1 + Y1; w1 = ry; w2 = rx; w3 = rz; }
            else if (ry >= rz) { o1 = Y1; o2 = Y1 + Z1; w1 = ry; w2 = rz; w3 = rx; }
            else { o1 = Z1; o2 = Y1 + Z1; w1 = rz; w2 = ry; w3 = rx; }
        }
        o3 = X1 + Y1 + Z1;
        for (int k = 0; k < 3; ++k) {
            const long long c0 = t[k], c1 = t[o1 + k], c2 = t[o2 + k], c3 = t[o3 + k];
            // 64-bit: a product passes 2^31 where the grid jumps, and Pillow's result is the unwrapped one
            const long long rest = (c1 - c0) * w1 + (c2 - c1) * w2 + (c3 - c2) * w3 + 0x8001;
            const auto v = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
            out[k] = static_cast<u8>((static_cast<uint32_t>(v) * 65281u + 8388608u) >> 24);
        }
    }
    return 0;
}
