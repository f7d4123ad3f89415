// The port's own JPEG decoder, for the frames that libjpeg on the CPU and
// nvJPEG on the card do not read as Pillow 12.1 does: lossless (SOF3,
// Huffman-coded, T.81 Annex H), arithmetic-coded DCT frames (SOF9
// sequential, SOF10 progressive, T.81 Annex D, F.2.4 and G.2) and Huffman
// progressive frames (SOF2, jdphuff.c) whose scans leave the progression
// incomplete (a coefficient never coded or not refined to its last bit:
// every file libjpeg smooths among them); and, for old-style JPEG-in-TIFF,
// Huffman sequential frames (SOF0, SOF1) as raw component planes. It decodes
// as Pillow's bundled libjpeg-turbo 3.1.3 does with the whole file in one
// buffer: its marker reader, its colour-space guess (default_decompress_parms,
// with the lossless rule that component ids 1, 2, 3 mean RGB), its handling
// of damaged data (a bad Huffman code decodes as 0; a bad arithmetic code
// leaves the rest of the scan at zero until the next restart; a marker met
// inside a scan feeds zero bits), its islow IDCT as the x86 SIMD code
// computes it (16-bit dequantisation and sums, saturating packs between the
// passes, so even wild coefficients give Pillow's pixels), and its
// upsampling (fancy for h2v1, h1v2 and h2v2, replication otherwise and in
// lossless mode, the edge rows and columns repeated).
//
// The result is the components as stored, at full size: gray, RGB, YCbCr,
// CMYK or YCCK, which utils/codec.py converts to RGB with libjpeg's
// fixed-point tables. A stream that ends early raises as Pillow raises: a
// suspending read past the end is a truncated file; a read the arithmetic
// decoder needs there is a broken stream (libjpeg's JERR_CANT_SUSPEND).
// Refused, as Pillow refuses them: a lossless frame that asks for colour
// conversion (libjpeg-turbo converts no colour in lossless mode),
// hierarchical frames (SOF5-7, SOF13-15, DHP), lossless arithmetic (SOF11),
// and a sampling libjpeg cannot upsample. A progressive frame whose scans
// leave the DC or low AC coefficients unrefined is smoothed first, as
// libjpeg's decompress_smooth_data smooths it (the rows past the last
// scan's data with the bits before that scan, as its last_good_iMCU_row
// has it).
//
// No global state: calls may run on many threads at once. Only the C++
// standard library is used; nothing is linked.
//
// C API (ctypes, plain C):
//   int mmtrs_jpeg_own_decode(const void* buf, long long n, long long max_pixels,
//                             void* out, void* dims, void* msg);
//     out: void*[1] <- a malloc'd h x w x c buffer (free with
//     mmtrs_jpeg_own_free); dims: int[4] <- h, w, c, colour space (1 gray,
//     2 RGB, 3 YCbCr, 4 CMYK, 5 YCCK: libjpeg's J_COLOR_SPACE numbers);
//     msg: char[256] <- the reason of a refusal. Returns 0 ok, 1 not a frame
//     of this decoder (its first frame header is SOF0 or SOF1, or SOF2 with
//     a complete progression, or it has none), 2 corrupt, 3 truncated, 5
//     over max_pixels (dims set), 6 a feature refused by name.
//   int mmtrs_jpeg_own_decode_as(const void* buf, long long n,
//                                long long max_pixels, int space, void* out,
//                                void* dims, void* msg);
//     The same with the colour space libtiff's JPEG codec sets for a
//     JPEG-in-TIFF chunk instead of libjpeg's guess (space 3: YCbCr, to be
//     converted; 6: JCS_UNKNOWN, the components as stored, no conversion
//     refused; 0: the guess), plus 0x100 for libtiff's data source (past
//     the chunk's end, a fake EOI marker at every fill: a cut chunk decodes
//     on as libjpeg decodes past a marker); dims[3] <- space (0 for 6).
//   int mmtrs_jpeg_own_decode_raw(const void* buf, long long n,
//                                 long long max_pixels, void* out, void* dims,
//                                 void* msg);
//     Old-style JPEG-in-TIFF: any frame of this decoder or SOF0/SOF1, each
//     component's plane at its own resolution (libjpeg's raw_data_out, no
//     upsampling, no colour conversion), the planes one after another; no
//     markers read after the scan. dims: int[20] <- h, w, c, the iMCU rows
//     decoded before the data ran out (-1: all; -2 - rows where they ran
//     out at a restart marker out of place), then per component its
//     plane's height, width and sampling factors.
//   int mmtrs_jpeg_own_takes_sof2(const void* buf, long long n);
//     1 where a SOF2 stream's scan headers leave its progression incomplete.
//   int mmtrs_jpeg_own_free(void* p);
//
// Build: g++ -O3 -std=c++17 -fPIC -shared jpeg.cpp (see mmtrs_tpu_torch/_build.py)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

namespace {

constexpr int ST_NOT_OWN = 1, ST_BROKEN = 2, ST_TRUNCATED = 3, ST_BOMB = 5, ST_REFUSED = 6;
constexpr int CS_GRAY = 1, CS_RGB = 2, CS_YCC = 3, CS_CMYK = 4, CS_YCCK = 5, CS_UNKNOWN = 6;
constexpr int LIBTIFF_SOURCE = 0x100;  // mmtrs_jpeg_own_decode_as: a chunk of a JPEG-in-TIFF

struct Fail {
    int status;
    std::string what;
};

[[noreturn]] void fail(int status, const std::string& what) { throw Fail{status, what}; }

// zigzag index -> natural index, with libjpeg's 16 spare entries
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define V(i, qe, lps, mps, sw) ((static_cast<int32_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
const int32_t kAritab[114] = {
    V(0, 0x5a1d, 1, 1, 1),       V(1, 0x2586, 14, 2, 0),      V(2, 0x1114, 16, 3, 0),
    V(3, 0x080b, 18, 4, 0),      V(4, 0x03d8, 20, 5, 0),      V(5, 0x01da, 23, 6, 0),
    V(6, 0x00e5, 25, 7, 0),      V(7, 0x006f, 28, 8, 0),      V(8, 0x0036, 30, 9, 0),
    V(9, 0x001a, 33, 10, 0),     V(10, 0x000d, 35, 11, 0),    V(11, 0x0006, 9, 12, 0),
    V(12, 0x0003, 10, 13, 0),    V(13, 0x0001, 12, 13, 0),    V(14, 0x5a7f, 15, 15, 1),
    V(15, 0x3f25, 36, 16, 0),    V(16, 0x2cf2, 38, 17, 0),    V(17, 0x207c, 39, 18, 0),
    V(18, 0x17b9, 40, 19, 0),    V(19, 0x1182, 42, 20, 0),    V(20, 0x0cef, 43, 21, 0),
    V(21, 0x09a1, 45, 22, 0),    V(22, 0x072f, 46, 23, 0),    V(23, 0x055c, 48, 24, 0),
    V(24, 0x0406, 49, 25, 0),    V(25, 0x0303, 51, 26, 0),    V(26, 0x0240, 52, 27, 0),
    V(27, 0x01b1, 54, 28, 0),    V(28, 0x0144, 56, 29, 0),    V(29, 0x00f5, 57, 30, 0),
    V(30, 0x00b7, 59, 31, 0),    V(31, 0x008a, 60, 32, 0),    V(32, 0x0068, 62, 33, 0),
    V(33, 0x004e, 63, 34, 0),    V(34, 0x003b, 32, 35, 0),    V(35, 0x002c, 33, 9, 0),
    V(36, 0x5ae1, 37, 37, 1),    V(37, 0x484c, 64, 38, 0),    V(38, 0x3a0d, 65, 39, 0),
    V(39, 0x2ef1, 67, 40, 0),    V(40, 0x261f, 68, 41, 0),    V(41, 0x1f33, 69, 42, 0),
    V(42, 0x19a8, 70, 43, 0),    V(43, 0x1518, 72, 44, 0),    V(44, 0x1177, 73, 45, 0),
    V(45, 0x0e74, 74, 46, 0),    V(46, 0x0bfb, 75, 47, 0),    V(47, 0x09f8, 77, 48, 0),
    V(48, 0x0861, 78, 49, 0),    V(49, 0x0706, 79, 50, 0),    V(50, 0x05cd, 48, 51, 0),
    V(51, 0x04de, 50, 52, 0),    V(52, 0x040f, 50, 53, 0),    V(53, 0x0363, 51, 54, 0),
    V(54, 0x02d4, 52, 55, 0),    V(55, 0x025c, 53, 56, 0),    V(56, 0x01f8, 54, 57, 0),
    V(57, 0x01a4, 55, 58, 0),    V(58, 0x0160, 56, 59, 0),    V(59, 0x0125, 57, 60, 0),
    V(60, 0x00f6, 58, 61, 0),    V(61, 0x00cb, 59, 62, 0),    V(62, 0x00ab, 61, 63, 0),
    V(63, 0x008f, 61, 32, 0),    V(64, 0x5b12, 65, 65, 1),    V(65, 0x4d04, 80, 66, 0),
    V(66, 0x412c, 81, 67, 0),    V(67, 0x37d8, 82, 68, 0),    V(68, 0x2fe8, 83, 69, 0),
    V(69, 0x293c, 84, 70, 0),    V(70, 0x2379, 86, 71, 0),    V(71, 0x1edf, 87, 72, 0),
    V(72, 0x1aa9, 87, 73, 0),    V(73, 0x174e, 72, 74, 0),    V(74, 0x1424, 72, 75, 0),
    V(75, 0x119c, 74, 76, 0),    V(76, 0x0f6b, 74, 77, 0),    V(77, 0x0d51, 75, 78, 0),
    V(78, 0x0bb6, 77, 79, 0),    V(79, 0x0a40, 77, 48, 0),    V(80, 0x5832, 80, 81, 1),
    V(81, 0x4d1c, 88, 82, 0),    V(82, 0x438e, 89, 83, 0),    V(83, 0x3bdd, 90, 84, 0),
    V(84, 0x34ee, 91, 85, 0),    V(85, 0x2eae, 92, 86, 0),    V(86, 0x299a, 93, 87, 0),
    V(87, 0x2516, 86, 71, 0),    V(88, 0x5570, 88, 89, 1),    V(89, 0x4ca9, 95, 90, 0),
    V(90, 0x44d9, 96, 91, 0),    V(91, 0x3e22, 97, 92, 0),    V(92, 0x3824, 99, 93, 0),
    V(93, 0x32b4, 99, 94, 0),    V(94, 0x2e17, 93, 86, 0),    V(95, 0x56a8, 95, 96, 1),
    V(96, 0x4f46, 101, 97, 0),   V(97, 0x47e5, 102, 98, 0),   V(98, 0x41cf, 103, 99, 0),
    V(99, 0x3c3d, 104, 100, 0),  V(100, 0x375e, 99, 93, 0),   V(101, 0x5231, 105, 102, 0),
    V(102, 0x4c0f, 106, 103, 0), V(103, 0x4639, 107, 104, 0), V(104, 0x415e, 103, 99, 0),
    V(105, 0x5627, 105, 106, 1), V(106, 0x50e7, 108, 107, 0), V(107, 0x4b85, 109, 103, 0),
    V(108, 0x5597, 110, 109, 0), V(109, 0x504f, 111, 107, 0), V(110, 0x5a10, 110, 111, 1),
    V(111, 0x5522, 112, 109, 0), V(112, 0x59eb, 112, 111, 1), V(113, 0x5a1d, 113, 113, 0)};
#undef V

struct HuffTable {
    bool defined = false;
    uint8_t bits[17] = {};
    uint8_t val[256] = {};
};

// jdhuff.c's derived table: maxcode/valoffset per length, 8-bit lookahead
struct Derived {
    int32_t maxcode[18];
    int32_t valoffset[18];
    int lookup[256];  // (code length << 8) | symbol, or 9 << 8 when longer
    const uint8_t* val;
};

struct Comp {
    int id = 0, h = 1, v = 1, tq = 0, index = 0;
    int dc_tbl = 0, ac_tbl = 0;
    int wib = 0, hib = 0;  // width/height in blocks (samples in lossless mode)
    int dw = 0, dh = 0;    // downsampled width/height in samples
    int bw = 0, bh = 0;    // allocated blocks: whole MCUs
    int mcu_w = 1, mcu_h = 1, last_row_height = 1;
    bool latched = false;
    int16_t qt[64] = {};              // the latched quantisation table, as libjpeg's SIMD IDCT reads it
    std::vector<int16_t> coef;        // bh x bw x 64, natural order
    std::vector<uint8_t> plane;       // the reconstructed component: pw x ph
    int pw = 0, ph = 0;
    int coef_bits[64];                // progression state (libjpeg's coef_bits)
    int prev_bits[64];                // each coefficient's bits before the last scan that coded it
};

struct Decoder {
    const uint8_t* d;
    size_t n;
    size_t pos = 0;
    int unread_marker = 0;

    bool saw_sof = false, progressive = false, lossless = false, arith = false;
    int precision = 8, height = 0, width = 0, ncomp = 0;
    std::vector<Comp> comp;
    int max_h = 1, max_v = 1;
    uint16_t qtab[4][64];
    bool qdef[4] = {false, false, false, false};
    HuffTable dc_huff[4], ac_huff[4];
    uint8_t dc_L[16], dc_U[16], ac_K[16];
    unsigned restart_interval = 0;
    bool jfif = false, adobe = false;
    int adobe_transform = 0;
    int space = 0;
    int forced_space = 0;  // JPEG-in-TIFF: libtiff's choice, 0 libjpeg's guess
    bool take_sof2 = false;  // a Huffman progressive frame whose progression is incomplete
    bool take_sequential = false;  // Huffman sequential frames too (old-style JPEG-in-TIFF's raw planes)
    bool multi_scan = false;
    int scan_number = 0;  // libjpeg's input_scan_number
    int last_good_imcu = 0;  // libjpeg's last_good_iMCU_row: the last iMCU row fetched with data in hand
    int rows_delivered = -1;  // raw planes: the iMCU rows decoded before the data ran out (-1: all)
    bool resync_failed = false;  // raw planes: they ran out at a restart marker out of place

    // the current scan
    int comps_in_scan = 0;
    Comp* cur[4] = {};
    int Ss = 0, Se = 0, Ah = 0, Al = 0;
    int next_restart_num = 0;
    int mcus_per_row = 0, mcu_rows = 0, blocks_in_mcu = 0;
    int membership[10] = {};  // each block of the MCU: its scan component,
    int member_y[10] = {}, member_x[10] = {};  // and its row and column within that component's blocks

    Decoder(const uint8_t* data, size_t size) : d(data), n(size) {
        for (int i = 0; i < 16; ++i) {
            dc_L[i] = 0;
            dc_U[i] = 1;
            ac_K[i] = 5;
        }
    }

    // ---- the data source: a read libjpeg may suspend on (markers, Huffman
    // data) finds no more bytes past the end -> Pillow's "truncated"
    int get() {
        if (pos >= n) {
            if (libtiff_source) return fake_eoi();
            fail(ST_TRUNCATED, "truncated JPEG: the stream ends early");
        }
        return d[pos++];
    }
    // libtiff's JPEG source (tif_jpeg.c std_fill_input_buffer): past the
    // chunk's end each fill is a fake EOI marker, as libjpeg then reads it
    bool libtiff_source = false;
    int fake = 0;
    int fake_eoi() { return (fake++ & 1) ? 0xD9 : 0xFF; }
    int get2() {
        const int a = get();
        return (a << 8) | get();
    }
    void skip(long long k) {
        if (k <= 0) return;
        if (libtiff_source && (pos >= n || static_cast<unsigned long long>(k) > n - pos)) {
            // std_skip_input_data: a skip past the buffer refills it instead
            if (pos < n || k > 2 - (fake & 1)) {
                pos = n;
                fake = 0;
            } else {
                fake += static_cast<int>(k);
            }
            return;
        }
        if (static_cast<unsigned long long>(k) > n - pos) fail(ST_TRUNCATED, "truncated JPEG: a marker segment ends early");
        pos += static_cast<size_t>(k);
    }
    // a byte for the arithmetic decoder, which cannot suspend
    int get_nosuspend() {
        if (pos >= n) {
            if (libtiff_source) return fake_eoi();
            fail(ST_BROKEN, "corrupt JPEG: arithmetic-coded data ends early");
        }
        return d[pos++];
    }

    // jdmarker.c next_marker
    void next_marker() {
        for (;;) {
            int c = get();
            while (c != 0xFF) c = get();
            do c = get();
            while (c == 0xFF);
            if (c != 0) {
                unread_marker = c;
                return;
            }
        }
    }

    void get_sof(int marker) {
        if (saw_sof) fail(ST_BROKEN, "corrupt JPEG: a second frame header");
        progressive = marker == 0xC2 || marker == 0xCA;
        lossless = marker == 0xC3 || marker == 0xCB;
        arith = marker >= 0xC9;
        int length = get2();
        precision = get();
        height = get2();
        width = get2();
        ncomp = get();
        length -= 8;
        if (height <= 0 || width <= 0 || ncomp <= 0) fail(ST_BROKEN, "corrupt JPEG: an empty image");
        if (length != ncomp * 3) fail(ST_BROKEN, "corrupt JPEG: a frame header of the wrong length");
        comp.assign(ncomp, Comp());
        for (int ci = 0; ci < ncomp; ++ci) {
            Comp& c = comp[ci];
            c.index = ci;
            c.id = get();
            const int hv = get();
            c.h = (hv >> 4) & 15;
            c.v = hv & 15;
            c.tq = get();
        }
        saw_sof = true;
    }

    void get_sos() {
        if (!saw_sof) fail(ST_BROKEN, "corrupt JPEG: a scan before the frame header");
        const int length = get2();
        const int ns = get();
        if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail(ST_BROKEN, "corrupt JPEG: a bad scan header");
        comps_in_scan = ns;
        for (auto& p : cur) p = nullptr;
        for (int i = 0; i < ns; ++i) {
            const int cc = get();
            const int t = get();
            // jdmarker.c get_sos: a component matches when the scan slot
            // with its index is still empty (so ids out of frame order are refused)
            int ci = 0;
            for (; ci < ncomp && ci < 4; ++ci)
                if (cc == comp[ci].id && !cur[ci]) break;
            if (ci >= ncomp || ci >= 4) fail(ST_BROKEN, "corrupt JPEG: a scan names no component of the frame");
            cur[i] = &comp[ci];
            comp[ci].dc_tbl = (t >> 4) & 15;
            comp[ci].ac_tbl = t & 15;
        }
        Ss = get();
        Se = get();
        const int a = get();
        Ah = (a >> 4) & 15;
        Al = a & 15;
        next_restart_num = 0;
    }

    void get_dht() {
        int length = get2() - 2;
        while (length > 16) {
            int index = get();
            uint8_t bits[17] = {};
            int count = 0;
            for (int i = 1; i <= 16; ++i) {
                bits[i] = static_cast<uint8_t>(get());
                count += bits[i];
            }
            length -= 17;
            if (count > 256 || count > length) fail(ST_BROKEN, "corrupt JPEG: a bad Huffman table");
            uint8_t val[256] = {};
            for (int i = 0; i < count; ++i) val[i] = static_cast<uint8_t>(get());
            length -= count;
            HuffTable* t;
            if (index & 0x10) {
                index -= 0x10;
                if (index < 0 || index >= 4) fail(ST_BROKEN, "corrupt JPEG: a bad Huffman table index");
                t = &ac_huff[index];
            } else {
                if (index < 0 || index >= 4) fail(ST_BROKEN, "corrupt JPEG: a bad Huffman table index");
                t = &dc_huff[index];
            }
            t->defined = true;
            std::memcpy(t->bits, bits, sizeof bits);
            std::memcpy(t->val, val, sizeof val);
        }
        if (length != 0) fail(ST_BROKEN, "corrupt JPEG: a Huffman table segment of the wrong length");
    }

    void get_dac() {
        int length = get2() - 2;
        while (length > 0) {
            const int index = get();
            const int val = get();
            length -= 2;
            if (index < 0 || index >= 32) fail(ST_BROKEN, "corrupt JPEG: a bad arithmetic table index");
            if (index >= 16) {
                ac_K[index - 16] = static_cast<uint8_t>(val);
            } else {
                dc_L[index] = static_cast<uint8_t>(val & 0x0F);
                dc_U[index] = static_cast<uint8_t>(val >> 4);
                if (dc_L[index] > dc_U[index]) fail(ST_BROKEN, "corrupt JPEG: a bad arithmetic conditioning value");
            }
        }
        if (length != 0) fail(ST_BROKEN, "corrupt JPEG: an arithmetic table segment of the wrong length");
    }

    void get_dqt() {
        int length = get2() - 2;
        while (length > 0) {
            int nq = get();
            const int prec = nq >> 4;
            nq &= 0x0F;
            if (nq >= 4) fail(ST_BROKEN, "corrupt JPEG: a bad quantisation table index");
            for (int i = 0; i < 64; ++i) qtab[nq][kNatural[i]] = static_cast<uint16_t>(prec ? get2() : get());
            qdef[nq] = true;
            length -= 65;
            if (prec) length -= 64;
        }
        if (length != 0) fail(ST_BROKEN, "corrupt JPEG: a quantisation table segment of the wrong length");
    }

    void get_dri() {
        if (get2() != 4) fail(ST_BROKEN, "corrupt JPEG: a restart interval segment of the wrong length");
        restart_interval = static_cast<unsigned>(get2());
    }

    // jdmarker.c get_interesting_appn: APP0 (JFIF) and APP14 (Adobe)
    void get_appn(int marker) {
        const int length = get2() - 2;
        const int numtoread = length >= 14 ? 14 : length > 0 ? length : 0;
        uint8_t b[14] = {};
        for (int i = 0; i < numtoread; ++i) b[i] = static_cast<uint8_t>(get());
        if (marker == 0xE0 && numtoread >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' && b[3] == 'F' && b[4] == 0)
            jfif = true;
        if (marker == 0xEE && numtoread >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
            adobe = true;
            adobe_transform = b[11];
        }
        skip(length - numtoread);
    }

    void skip_variable() { skip(static_cast<long long>(get2()) - 2); }

    // jdmarker.c read_markers: process markers until SOS or EOI; returns it
    int read_markers() {
        for (;;) {
            if (unread_marker == 0) next_marker();
            const int m = unread_marker;
            switch (m) {
                case 0xD8: fail(ST_BROKEN, "corrupt JPEG: a second SOI marker");
                case 0xC2:
                    if (take_sof2 && !saw_sof) {
                        get_sof(m);
                        break;
                    }
                    [[fallthrough]];
                case 0xC0: case 0xC1:
                    if (take_sequential && !saw_sof) {
                        get_sof(m);
                        break;
                    }
                    if (!saw_sof) fail(ST_NOT_OWN, "a Huffman-coded DCT frame");
                    fail(ST_BROKEN, "corrupt JPEG: a second frame header");
                case 0xC3: case 0xC9: case 0xCA: case 0xCB: get_sof(m); break;
                case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: {
                    char buf[96];
                    std::snprintf(buf, sizeof buf, "hierarchical JPEG (SOF%d) is not decoded (nor by Pillow)", m - 0xC0);
                    fail(ST_REFUSED, buf);
                }
                case 0xC8: fail(ST_BROKEN, "corrupt JPEG: a JPG extension frame");
                case 0xDA: get_sos(); unread_marker = 0; return 0xDA;
                case 0xD9: unread_marker = 0; return 0xD9;
                case 0xCC: get_dac(); break;
                case 0xC4: get_dht(); break;
                case 0xDB: get_dqt(); break;
                case 0xDD: get_dri(); break;
                case 0xE0: case 0xEE: get_appn(m); break;
                case 0xFE: skip_variable(); break;
                case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0x01:
                    break;
                case 0xDC: skip_variable(); break;
                case 0xDE: fail(ST_REFUSED, "hierarchical JPEG (a DHP marker) is not decoded (nor by Pillow)");
                default:
                    if (m >= 0xE1 && m <= 0xEF) {
                        skip_variable();
                        break;
                    }
                    char buf[64];
                    std::snprintf(buf, sizeof buf, "corrupt JPEG: unknown marker 0x%02x", m);
                    fail(ST_BROKEN, buf);
            }
            unread_marker = 0;
        }
    }

    // jdmarker.c read_restart_marker with jpeg_resync_to_restart
    void read_restart_marker() {
        if (unread_marker == 0) next_marker();
        if (unread_marker == 0xD0 + next_restart_num) {
            unread_marker = 0;
        } else {
            if (take_sequential) {  // tif_ojpeg.c's source manager fails libjpeg's resync
                resync_failed = true;
                fail(ST_TRUNCATED, "corrupt old-style JPEG: a restart marker out of place (libtiff's resync fails)");
            }
            const int desired = next_restart_num;
            int marker = unread_marker;
            for (;;) {
                int action;
                if (marker < 0xC0) action = 2;
                else if (marker < 0xD0 || marker > 0xD7) action = 3;
                else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7)) action = 3;
                else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7)) action = 2;
                else action = 1;
                if (action == 1) {
                    unread_marker = 0;
                    break;
                }
                if (action == 3) break;
                next_marker();
                marker = unread_marker;
            }
        }
        next_restart_num = (next_restart_num + 1) & 7;
    }

    // ---- frame set-up (jdinput.c initial_setup, default_decompress_parms,
    // the checks jpeg_start_decompress makes before reading scan data)
    void initial_setup(long long max_pixels, int* dims) {
        if (height > 65500 || width > 65500) fail(ST_BROKEN, "corrupt JPEG: an image over 65500 pixels a side");
        if (precision != 8) {
            char buf[96];
            std::snprintf(buf, sizeof buf, "JPEG of %d-bit precision is not decoded (nor by Pillow)", precision);
            fail(ST_REFUSED, buf);
        }
        if (ncomp > 10) fail(ST_BROKEN, "corrupt JPEG: too many components");
        for (auto& c : comp) {
            if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail(ST_BROKEN, "corrupt JPEG: bad sampling factors");
            max_h = c.h > max_h ? c.h : max_h;
            max_v = c.v > max_v ? c.v : max_v;
        }
        const int unit = lossless ? 1 : 8;
        for (auto& c : comp) {
            c.wib = static_cast<int>((static_cast<long long>(width) * c.h + max_h * unit - 1) / (max_h * unit));
            c.hib = static_cast<int>((static_cast<long long>(height) * c.v + max_v * unit - 1) / (max_v * unit));
            c.dw = static_cast<int>((static_cast<long long>(width) * c.h + max_h - 1) / max_h);
            c.dh = static_cast<int>((static_cast<long long>(height) * c.v + max_v - 1) / max_v);
            for (int& b : c.coef_bits) b = -1;
        }
        multi_scan = comps_in_scan < ncomp || progressive;
        // Pillow's opener takes 1, 3 and 4 components (L, RGB, CMYK)
        if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
            char buf[96];
            std::snprintf(buf, sizeof buf, "JPEG with %d components is not decoded (nor by Pillow)", ncomp);
            fail(ST_REFUSED, buf);
        }
        if (ncomp == 1) {
            space = CS_GRAY;
        } else if (ncomp == 3) {
            if (jfif) space = CS_YCC;
            else if (adobe) space = adobe_transform == 0 ? CS_RGB : CS_YCC;
            else if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) space = lossless ? CS_RGB : CS_YCC;
            else if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) space = CS_RGB;
            else space = lossless ? CS_RGB : CS_YCC;
        } else {
            space = adobe ? (adobe_transform == 0 ? CS_CMYK : CS_YCCK) : CS_CMYK;
        }
        if (forced_space) space = forced_space == CS_UNKNOWN ? 0 : forced_space;
        dims[0] = height;
        dims[1] = width;
        dims[2] = ncomp;
        dims[3] = space;
        if (max_pixels >= 0 && static_cast<long long>(width) * height > max_pixels) fail(ST_BOMB, "over the pixel limit");
        if (lossless && arith) fail(ST_REFUSED, "lossless arithmetic-coded JPEG (SOF11) is not decoded (nor by Pillow)");
        // Pillow asks for RGB (3 components) or CMYK (4): libjpeg-turbo
        // converts no colour in lossless mode
        if (lossless && (space == CS_YCC || space == CS_YCCK))
            fail(ST_REFUSED, "lossless JPEG that asks for colour conversion (JFIF, or Adobe transform 1 or 2) is not "
                             "decoded (nor by Pillow)");
        for (auto& c : comp) {
            const bool ok = (c.h == max_h || 2 * c.h == max_h || max_h % c.h == 0)
                            && (c.v == max_v || 2 * c.v == max_v || max_v % c.v == 0);
            if (!ok) fail(ST_REFUSED, "JPEG with fractional sampling factors is not decoded (nor by Pillow)");
        }
    }

    // jdinput.c per_scan_setup (unit: 8 for DCT blocks, 1 for lossless samples)
    void per_scan_setup() {
        const int unit = lossless ? 1 : 8;
        if (comps_in_scan == 1) {
            Comp& c = *cur[0];
            mcus_per_row = c.wib;
            mcu_rows = c.hib;
            c.mcu_w = c.mcu_h = 1;
            const int t = c.hib % c.v;
            c.last_row_height = t == 0 ? c.v : t;
            blocks_in_mcu = 1;
            membership[0] = member_y[0] = member_x[0] = 0;
        } else {
            mcus_per_row = static_cast<int>((static_cast<long long>(width) + max_h * unit - 1) / (max_h * unit));
            mcu_rows = static_cast<int>((static_cast<long long>(height) + max_v * unit - 1) / (max_v * unit));
            blocks_in_mcu = 0;
            for (int ci = 0; ci < comps_in_scan; ++ci) {
                Comp& c = *cur[ci];
                c.mcu_w = c.h;
                c.mcu_h = c.v;
                const int t = c.hib % c.v;
                c.last_row_height = t == 0 ? c.v : t;
                if (blocks_in_mcu + c.h * c.v > 10) fail(ST_BROKEN, "corrupt JPEG: too many blocks in an MCU");
                for (int k = 0; k < c.h * c.v; ++k) {
                    membership[blocks_in_mcu] = ci;
                    member_y[blocks_in_mcu] = k / c.h;
                    member_x[blocks_in_mcu++] = k % c.h;
                }
            }
        }
    }

    void decode(long long max_pixels, int* dims);
    void decode_lossless();
    void decode_dct();
    void smooth_idct(Comp& c, int total_imcu_rows);
    void finish_single_scan();
    std::vector<uint8_t> output(int nc);
};

// ---------------------------------------------------------------------------
// Huffman decoding for lossless frames (jdhuff.c's bit reader and
// jpeg_make_d_derived_tbl, jdlhuff.c's decode_mcus)
// ---------------------------------------------------------------------------

// max_symbol: a DC table's largest difference size (16 lossless, 15 DCT);
// an AC table's symbols are not checked
void derive(const HuffTable& t, Derived& out, int max_symbol) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        int i = t.bits[l];
        if (p + i > 256) fail(ST_BROKEN, "corrupt JPEG: a bad Huffman table");
        while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            ++code;
        }
        if (static_cast<long long>(code) >= (1LL << si)) fail(ST_BROKEN, "corrupt JPEG: a bad Huffman table");
        code <<= 1;
        ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (t.bits[l]) {
            out.valoffset[l] = p - huffcode[p];
            p += t.bits[l];
            out.maxcode[l] = huffcode[p - 1];
        } else {
            out.maxcode[l] = -1;
        }
    }
    out.valoffset[17] = 0;
    out.maxcode[17] = 0xFFFFF;
    for (int i = 0; i < 256; ++i) out.lookup[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; ++l) {
        for (int i = 1; i <= t.bits[l]; ++i, ++p) {
            int look = huffcode[p] << (8 - l);
            for (int ctr = 1 << (8 - l); ctr > 0; --ctr) out.lookup[look++] = (l << 8) | t.val[p];
        }
    }
    for (int i = 0; i < numsymbols; ++i)
        if (t.val[i] > max_symbol) fail(ST_BROKEN, "corrupt JPEG: a bad Huffman table");
    out.val = t.val;
}

struct BitReader {
    Decoder& dec;
    uint64_t buf = 0;
    int bits_left = 0;
    bool insufficient = false;
    static constexpr int kMinGetBits = 57;

    explicit BitReader(Decoder& d) : dec(d) {}

    // jpeg_fill_bit_buffer: at least kMinGetBits bits, or stop at a marker;
    // past a marker a request for more bits than are left gets zeros
    void fill(int nbits) {
        if (dec.unread_marker == 0) {
            while (bits_left < kMinGetBits) {
                int c = dec.get();
                if (c == 0xFF) {
                    do c = dec.get();
                    while (c == 0xFF);
                    if (c == 0) {
                        c = 0xFF;
                    } else {
                        dec.unread_marker = c;
                        goto no_more_bytes;
                    }
                }
                buf = (buf << 8) | static_cast<uint64_t>(c);
                bits_left += 8;
            }
            return;
        }
    no_more_bytes:
        if (nbits > bits_left) {
            insufficient = true;
            buf <<= kMinGetBits - bits_left;
            bits_left = kMinGetBits;
        }
    }
    int get_bits(int nbits) {
        if (bits_left < nbits) fill(nbits);
        bits_left -= nbits;
        return static_cast<int>((buf >> bits_left) & ((1ULL << nbits) - 1));
    }
    // HUFF_DECODE and jpeg_huff_decode
    int decode(const Derived& t) {
        int l, code;
        if (bits_left < 8) {
            fill(0);
            if (bits_left < 8) {
                l = 1;
                goto slow;
            }
        }
        {
            const int look = static_cast<int>((buf >> (bits_left - 8)) & 0xFF);
            const int nb = t.lookup[look] >> 8;
            if (nb <= 8) {
                bits_left -= nb;
                return t.lookup[look] & 0xFF;
            }
            l = nb;
        }
    slow:
        code = get_bits(l);
        while (code > t.maxcode[l]) {
            code = (code << 1) | get_bits(1);
            ++l;
        }
        if (l > 16) return 0;  // a bad code: libjpeg warns and takes 0
        return t.val[code + t.valoffset[l]];
    }
};

void Decoder::decode_lossless() {
    for (auto& c : comp) {
        c.pw = c.wib;
        c.ph = c.hib;
        c.plane.assign(static_cast<size_t>(c.pw) * c.ph, 0);
    }
    const int total_imcu_rows = (height + max_v - 1) / max_v;
    std::vector<std::vector<int>> prev(ncomp);  // each component's last undifferenced row
    for (auto& c : comp) prev[c.index].assign(c.wib, 0);
    for (;;) {
        per_scan_setup();
        if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
            fail(ST_BROKEN, "corrupt JPEG: bad lossless scan parameters");
        Derived tables[4];
        for (int ci = 0; ci < comps_in_scan; ++ci) {
            const int t = cur[ci]->dc_tbl;
            if (t >= 4 || !dc_huff[t].defined) fail(ST_BROKEN, "corrupt JPEG: a scan names a missing Huffman table");
            derive(dc_huff[t], tables[t], 16);
        }
        if (restart_interval % static_cast<unsigned>(mcus_per_row) != 0)
            fail(ST_BROKEN, "corrupt JPEG: a lossless restart interval that is not whole MCU rows");
        BitReader br(*this);
        bool first_row[10];
        for (bool& f : first_row) f = true;
        const int initial = 1 << (precision - Al - 1);
        unsigned restart_rows_to_go = restart_interval / static_cast<unsigned>(mcus_per_row);
        // diff rows of the iMCU row: per scan component, mcu_h rows of mcus_per_row * mcu_w samples
        std::vector<std::vector<int>> diff(comps_in_scan);
        for (int ci = 0; ci < comps_in_scan; ++ci)
            diff[ci].assign(static_cast<size_t>(cur[ci]->v) * mcus_per_row * cur[ci]->mcu_w, 0);
        std::vector<int> undiff;
        for (int imcu = 0; imcu < total_imcu_rows; ++imcu) {
            const bool last = imcu == total_imcu_rows - 1;
            const int rows_per_imcu = comps_in_scan > 1 ? 1 : (last ? cur[0]->last_row_height : cur[0]->v);
            for (int yoff = 0; yoff < rows_per_imcu; ++yoff) {
                if (restart_interval) {
                    if (restart_rows_to_go == 0) {
                        br.bits_left = 0;
                        read_restart_marker();
                        if (unread_marker == 0) br.insufficient = false;
                        for (bool& f : first_row) f = true;
                        restart_rows_to_go = restart_interval / static_cast<unsigned>(mcus_per_row);
                    }
                }
                if (br.insufficient) {  // out of data: zero differences, predictors reset
                    for (int ci = 0; ci < comps_in_scan; ++ci) {
                        const Comp& c = *cur[ci];
                        const int row_w = mcus_per_row * c.mcu_w;
                        for (int y = 0; y < c.mcu_h; ++y)
                            std::fill_n(diff[ci].begin() + static_cast<size_t>(yoff + y) * row_w, row_w, 0);
                    }
                    for (bool& f : first_row) f = true;
                } else {
                    for (int m = 0; m < mcus_per_row; ++m) {
                        for (int b = 0; b < blocks_in_mcu; ++b) {
                            const int ci = membership[b];
                            const Comp& c = *cur[ci];
                            int s = br.decode(tables[c.dc_tbl]);
                            if (s) {
                                if (s == 16) {
                                    s = 32768;
                                } else {
                                    const int r = br.get_bits(s);
                                    s = r < (1 << (s - 1)) ? r + ((-1) * (1 << s)) + 1 : r;
                                }
                            }
                            const int row_w = mcus_per_row * c.mcu_w;
                            diff[ci][static_cast<size_t>(yoff + member_y[b]) * row_w + m * c.mcu_w + member_x[b]] = s;
                        }
                    }
                }
                if (restart_interval) --restart_rows_to_go;
            }
            // undifference and scale the rows of this iMCU row
            for (int ci = 0; ci < comps_in_scan; ++ci) {
                Comp& c = *cur[ci];
                const int nrows = last ? c.last_row_height : c.v;
                const int row_w = mcus_per_row * c.mcu_w;
                const int w = c.wib;
                std::vector<int>& pr = prev[c.index];
                undiff.resize(w);
                for (int r = 0; r < nrows; ++r) {
                    const int* df = diff[ci].data() + static_cast<size_t>(r) * row_w;
                    if (first_row[c.index]) {
                        int ra = (df[0] + initial) & 0xFFFF;
                        undiff[0] = ra;
                        for (int x = 1; x < w; ++x) {
                            ra = (df[x] + ra) & 0xFFFF;
                            undiff[x] = ra;
                        }
                        first_row[c.index] = false;
                    } else {
                        int rb = pr[0];
                        int ra = (df[0] + rb) & 0xFFFF;
                        undiff[0] = ra;
                        for (int x = 1; x < w; ++x) {
                            const int rc = rb;
                            rb = pr[x];
                            int p;
                            switch (Ss) {
                                case 1: p = ra; break;
                                case 2: p = rb; break;
                                case 3: p = rc; break;
                                case 4: p = ra + rb - rc; break;
                                case 5: p = ra + ((rb - rc) >> 1); break;
                                case 6: p = rb + ((ra - rc) >> 1); break;
                                default: p = (ra + rb) >> 1; break;
                            }
                            ra = (df[x] + p) & 0xFFFF;
                            undiff[x] = ra;
                        }
                    }
                    const int row = imcu * c.v + r;
                    uint8_t* out = c.plane.data() + static_cast<size_t>(row) * c.pw;
                    for (int x = 0; x < w; ++x) out[x] = static_cast<uint8_t>(undiff[x] << Al);
                    pr.swap(undiff);
                }
            }
        }
        if (!multi_scan) {
            if (!take_sequential) finish_single_scan();
            return;
        }
        if (read_markers() == 0xD9) return;
    }
}

// ---------------------------------------------------------------------------
// Arithmetic decoding (jdarith.c)
// ---------------------------------------------------------------------------

struct Arith {
    Decoder& dec;
    int64_t c = 0, a = 0;  // JLONG
    int ct = -16;
    int last_dc_val[4] = {0, 0, 0, 0};
    int dc_context[4] = {0, 0, 0, 0};
    unsigned restarts_to_go = 0;
    uint8_t dc_stats[16][64];
    uint8_t ac_stats[16][256];
    uint8_t fixed_bin[4] = {113, 0, 0, 0};

    explicit Arith(Decoder& d) : dec(d) {}

    int byte() {
        if (dec.unread_marker) return 0;
        int data = dec.get_nosuspend();
        if (data == 0xFF) {
            do data = dec.get_nosuspend();
            while (data == 0xFF);
            if (data == 0) {
                data = 0xFF;
            } else {
                dec.unread_marker = data;
                data = 0;
            }
        }
        return data;
    }

    int decode(uint8_t* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                const int data = byte();
                c = (c << 8) | data;
                if ((ct += 8) < 0)
                    if (++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAritab[sv & 0x7F];
        const int nl = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        const int nm = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    bool dc_scan() const { return !dec.progressive || (dec.Ss == 0 && dec.Ah == 0); }
    bool ac_scan() const { return !dec.progressive || dec.Ss != 0; }

    void start_pass() {
        for (int ci = 0; ci < dec.comps_in_scan; ++ci) {
            const Comp& comp = *dec.cur[ci];
            if (dc_scan()) {
                std::memset(dc_stats[comp.dc_tbl], 0, 64);
                last_dc_val[ci] = 0;
                dc_context[ci] = 0;
            }
            if (ac_scan()) std::memset(ac_stats[comp.ac_tbl], 0, 256);
        }
        c = 0;
        a = 0;
        ct = -16;
        restarts_to_go = dec.restart_interval;
    }

    void process_restart() {
        try {
            dec.read_restart_marker();
        } catch (const Fail& f) {  // jdarith.c: the marker reader cannot suspend here
            if (f.status == ST_TRUNCATED) fail(ST_BROKEN, "corrupt JPEG: arithmetic-coded data ends early");
            throw;
        }
        for (int ci = 0; ci < dec.comps_in_scan; ++ci) {
            const Comp& comp = *dec.cur[ci];
            if (dc_scan()) {
                std::memset(dc_stats[comp.dc_tbl], 0, 64);
                last_dc_val[ci] = 0;
                dc_context[ci] = 0;
            }
            if (ac_scan()) std::memset(ac_stats[comp.ac_tbl], 0, 256);
        }
        c = 0;
        a = 0;
        ct = -16;
        restarts_to_go = dec.restart_interval;
    }

    void restart_check() {
        if (dec.restart_interval) {
            if (restarts_to_go == 0) process_restart();
            --restarts_to_go;
        }
    }

    // Figures F.19-F.24: one DC difference; false on a magnitude overflow
    bool dc_diff(int ci, int tbl, int* v_out) {
        uint8_t* st = dc_stats[tbl] + dc_context[ci];
        if (decode(st) == 0) {
            dc_context[ci] = 0;
            *v_out = 0;
            return true;
        }
        const int sign = decode(st + 1);
        st += 2 + sign;
        int m = decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;
            while (decode(st)) {
                if ((m <<= 1) == 0x8000) {
                    ct = -1;
                    return false;
                }
                st += 1;
            }
        }
        if (m < static_cast<int>((1L << dec.dc_L[tbl]) >> 1)) dc_context[ci] = 0;
        else if (m > static_cast<int>((1L << dec.dc_U[tbl]) >> 1)) dc_context[ci] = 12 + sign * 4;
        else dc_context[ci] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        *v_out = v;
        return true;
    }

    // AC coefficients Ss..Se of one block (sequential: 1..63, Al 0)
    bool ac_first(int16_t* block, int tbl, int ss, int se, int al) {
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (decode(st)) break;
            while (decode(st + 1) == 0) {
                st += 3;
                if (++k > se) {
                    ct = -1;
                    return false;
                }
            }
            const int sign = decode(fixed_bin);
            st += 2;
            int m = decode(st);
            if (m != 0) {
                if (decode(st)) {
                    m <<= 1;
                    st = ac_stats[tbl] + (k <= dec.ac_K[tbl] ? 189 : 217);
                    while (decode(st)) {
                        if ((m <<= 1) == 0x8000) {
                            ct = -1;
                            return false;
                        }
                        st += 1;
                    }
                }
            }
            int v = m;
            st += 14;
            while (m >>= 1)
                if (decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            block[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
        }
        return true;
    }

    void mcu_sequential(int16_t** blocks) {
        restart_check();
        if (ct == -1) return;
        for (int b = 0; b < dec.blocks_in_mcu; ++b) {
            const int ci = dec.membership[b];
            const Comp& comp = *dec.cur[ci];
            int v;
            if (!dc_diff(ci, comp.dc_tbl, &v)) return;
            last_dc_val[ci] = (last_dc_val[ci] + v) & 0xFFFF;
            blocks[b][0] = static_cast<int16_t>(last_dc_val[ci]);
            if (!ac_first(blocks[b], comp.ac_tbl, 1, 63, 0)) return;
        }
    }

    void mcu_dc_first(int16_t** blocks) {
        restart_check();
        if (ct == -1) return;
        for (int b = 0; b < dec.blocks_in_mcu; ++b) {
            const int ci = dec.membership[b];
            int v;
            if (!dc_diff(ci, dec.cur[ci]->dc_tbl, &v)) return;
            if (v) last_dc_val[ci] = (last_dc_val[ci] + v) & 0xFFFF;
            blocks[b][0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc_val[ci]) << dec.Al);
        }
    }

    void mcu_ac_first(int16_t** blocks) {
        restart_check();
        if (ct == -1) return;
        ac_first(blocks[0], dec.cur[0]->ac_tbl, dec.Ss, dec.Se, dec.Al);
    }

    void mcu_dc_refine(int16_t** blocks) {
        restart_check();
        const int p1 = 1 << dec.Al;
        for (int b = 0; b < dec.blocks_in_mcu; ++b)
            if (decode(fixed_bin)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
    }

    void mcu_ac_refine(int16_t** blocks) {
        restart_check();
        if (ct == -1) return;
        int16_t* block = blocks[0];
        const int tbl = dec.cur[0]->ac_tbl;
        const int p1 = 1 << dec.Al;
        const int m1 = -1 * (1 << dec.Al);
        int kex = dec.Se;
        for (; kex > 0; --kex)
            if (block[kNatural[kex]]) break;
        for (int k = dec.Ss; k <= dec.Se; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (k > kex)
                if (decode(st)) break;
            for (;;) {
                int16_t* coef = block + kNatural[k];
                if (*coef) {
                    if (decode(st + 2)) *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
                    break;
                }
                if (decode(st + 1)) {
                    *coef = static_cast<int16_t>(decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > dec.Se) {
                    ct = -1;
                    return;
                }
            }
        }
    }
};

// ---------------------------------------------------------------------------
// Huffman-coded progressive scans (jdphuff.c): DC first and refine, AC
// first with its EOB runs, AC refine with its correction bits; restarts
// reset the predictions and the run; past a marker the bit reader feeds
// zeros and the remaining MCUs of the interval are left as they are
// ---------------------------------------------------------------------------

inline int huff_extend(int r, int s) { return r < (1 << (s - 1)) ? r + static_cast<int>(~0u << s) + 1 : r; }

struct HuffProg {
    Decoder& dec;
    BitReader br;
    Derived tables[4];     // a progressive scan's tables; a sequential scan's AC tables
    Derived dc_tables[4];  // a sequential scan's DC tables
    const Derived* ac = nullptr;
    int last_dc_val[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    unsigned restarts_to_go = 0;

    // start_pass_phuff_decoder: the tables a scan needs, its state reset
    explicit HuffProg(Decoder& d) : dec(d), br(d) {
        restarts_to_go = dec.restart_interval;
        if (!dec.progressive) {  // jdhuff.c start_pass_huff_decoder: both tables of each component
            for (int ci = 0; ci < dec.comps_in_scan; ++ci) {
                const Comp& c = *dec.cur[ci];
                if (c.dc_tbl >= 4 || c.ac_tbl >= 4 || !dec.dc_huff[c.dc_tbl].defined || !dec.ac_huff[c.ac_tbl].defined)
                    fail(ST_BROKEN, "corrupt JPEG: a scan names a missing Huffman table");
                derive(dec.dc_huff[c.dc_tbl], dc_tables[c.dc_tbl], 15);
                derive(dec.ac_huff[c.ac_tbl], tables[c.ac_tbl], 255);
            }
            return;
        }
        const bool dc = dec.Ss == 0;
        for (int ci = 0; ci < dec.comps_in_scan; ++ci) {
            const Comp& c = *dec.cur[ci];
            if (dc && dec.Ah != 0) continue;  // DC refinement reads no table
            const int t = dc ? c.dc_tbl : c.ac_tbl;
            const HuffTable* h = t < 4 ? (dc ? &dec.dc_huff[t] : &dec.ac_huff[t]) : nullptr;
            if (!h || !h->defined) fail(ST_BROKEN, "corrupt JPEG: a scan names a missing Huffman table");
            derive(*h, tables[t], dc ? 15 : 255);
            if (!dc) ac = &tables[t];
        }
    }

    // process_restart: unused bits dropped, the RSTn marker read, the
    // predictions and the EOB run reset; out of data stays so only when
    // the marker reader stopped at another marker
    void restart_check() {
        if (!dec.restart_interval) return;
        if (restarts_to_go == 0) {
            br.bits_left = 0;
            dec.read_restart_marker();
            for (int& v : last_dc_val) v = 0;
            eobrun = 0;
            restarts_to_go = dec.restart_interval;
            if (dec.unread_marker == 0) br.insufficient = false;
        }
        --restarts_to_go;
    }

    void dc_first(int16_t** blocks) {
        restart_check();
        if (br.insufficient) return;
        for (int b = 0; b < dec.blocks_in_mcu; ++b) {
            const int ci = dec.membership[b];
            int s = br.decode(tables[dec.cur[ci]->dc_tbl]);
            if (s) s = huff_extend(br.get_bits(s), s);
            const int last = last_dc_val[ci];
            if ((last >= 0 && s > INT32_MAX - last) || (last < 0 && s < INT32_MIN - last))
                fail(ST_BROKEN, "corrupt JPEG: a DC coefficient out of range");
            last_dc_val[ci] = last + s;
            blocks[b][0] = static_cast<int16_t>(static_cast<uint32_t>(last_dc_val[ci]) << dec.Al);
        }
    }

    void ac_first(int16_t** blocks) {
        restart_check();
        if (br.insufficient) return;
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        int16_t* block = blocks[0];
        for (int k = dec.Ss; k <= dec.Se; ++k) {
            int s = br.decode(*ac);
            int r = s >> 4;
            s &= 15;
            if (s) {
                k += r;
                s = huff_extend(br.get_bits(s), s);
                block[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(s) << dec.Al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1u << r;
                if (r) eobrun += static_cast<unsigned>(br.get_bits(r));
                --eobrun;
                break;
            }
        }
    }

    void dc_refine(int16_t** blocks) {
        restart_check();
        const int p1 = 1 << dec.Al;
        for (int b = 0; b < dec.blocks_in_mcu; ++b)
            if (br.get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
    }

    void ac_refine(int16_t** blocks) {
        restart_check();
        if (br.insufficient) return;
        int16_t* block = blocks[0];
        const int p1 = 1 << dec.Al;
        const int m1 = static_cast<int>(~0u << dec.Al);
        auto correct = [&](int16_t* coef) {
            if (br.get_bits(1) && (*coef & p1) == 0) *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
        };
        int k = dec.Ss;
        if (eobrun == 0) {
            for (; k <= dec.Se; ++k) {
                int s = br.decode(*ac);
                int r = s >> 4;
                s &= 15;
                if (s) {  // a size other than 1 is a bad code libjpeg warns of, read as 1
                    s = br.get_bits(1) ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1u << r;
                    if (r) eobrun += static_cast<unsigned>(br.get_bits(r));
                    break;
                }
                do {
                    int16_t* coef = block + kNatural[k];
                    if (*coef != 0) {
                        correct(coef);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= dec.Se);
                if (s) block[kNatural[k]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= dec.Se; ++k) {
                int16_t* coef = block + kNatural[k];
                if (*coef != 0) correct(coef);
            }
            --eobrun;
        }
    }

    // jdhuff.c decode_mcu: each block's DC difference, then its AC run
    // lengths and sizes to the end of block
    void sequential(int16_t** blocks) {
        restart_check();
        if (br.insufficient) return;
        for (int b = 0; b < dec.blocks_in_mcu; ++b) {
            const int ci = dec.membership[b];
            const Comp& c = *dec.cur[ci];
            int s = br.decode(dc_tables[c.dc_tbl]);
            if (s) s = huff_extend(br.get_bits(s), s);
            last_dc_val[ci] = static_cast<int>(static_cast<unsigned>(last_dc_val[ci]) + static_cast<unsigned>(s));
            int16_t* block = blocks[b];
            block[0] = static_cast<int16_t>(last_dc_val[ci]);
            const Derived& t = tables[c.ac_tbl];
            for (int k = 1; k < 64; ++k) {
                s = br.decode(t);
                const int r = s >> 4;
                s &= 15;
                if (s) {
                    k += r;
                    block[kNatural[k]] = static_cast<int16_t>(huff_extend(br.get_bits(s), s));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
        }
    }

    void mcu(int16_t** blocks) {
        if (!dec.progressive) sequential(blocks);
        else if (dec.Ah == 0 && dec.Ss == 0) dc_first(blocks);
        else if (dec.Ah == 0) ac_first(blocks);
        else if (dec.Ss == 0) dc_refine(blocks);
        else ac_refine(blocks);
    }
};

// ---------------------------------------------------------------------------
// The islow IDCT as libjpeg-turbo's SIMD code (jidctint-avx2/sse2) computes
// it: 16-bit dequantisation, the sums in0 +- in4, in7 + in3 and in5 + in1 in
// 16 bits, the rest in wrapping 32-bit arithmetic, each pass descaled and
// packed to 16 bits with saturation, the result saturated to 8 bits and
// level-shifted. On ordinary data this equals jidctint.c.
// ---------------------------------------------------------------------------

constexpr int32_t F029 = 2446, F039 = 3196, F054 = 4433, F076 = 6270, F089 = 7373, F117 = 9633, F150 = 12299,
                  F184 = 15137, F196 = 16069, F205 = 16819, F256 = 20995, F307 = 25172;

inline int16_t sat16(int32_t x) { return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x); }
inline uint32_t mul(int32_t a, int32_t k) { return static_cast<uint32_t>(a * k); }

// one 1-D pass over the 8 columns of in[row][col]
void idct_pass(const int16_t in[8][8], int16_t out[8][8], int shift) {
    const uint32_t round = 1u << (shift - 1);
    auto desc = [&](uint32_t x) { return sat16(static_cast<int32_t>(x + round) >> shift); };
    for (int col = 0; col < 8; ++col) {
        const int32_t in0 = in[0][col], in1 = in[1][col], in2 = in[2][col], in3 = in[3][col];
        const int32_t in4 = in[4][col], in5 = in[5][col], in6 = in[6][col], in7 = in[7][col];
        const int32_t s04 = static_cast<int16_t>(in0 + in4), d04 = static_cast<int16_t>(in0 - in4);
        const uint32_t tmp0 = static_cast<uint32_t>(s04) << 13, tmp1 = static_cast<uint32_t>(d04) << 13;
        const uint32_t tmp2 = mul(in2, F054) + mul(in6, F054 - F184);
        const uint32_t tmp3 = mul(in2, F054 + F076) + mul(in6, F054);
        const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        const int32_t z3 = static_cast<int16_t>(in7 + in3), z4 = static_cast<int16_t>(in5 + in1);
        const uint32_t z3p = mul(z3, F117 - F196) + mul(z4, F117);
        const uint32_t z4p = mul(z3, F117) + mul(z4, F117 - F039);
        const uint32_t o0 = mul(in7, F029 - F089) + mul(in1, -F089) + z3p;
        const uint32_t o1 = mul(in5, F205 - F256) + mul(in3, -F256) + z4p;
        const uint32_t o2 = mul(in5, -F256) + mul(in3, F307 - F256) + z3p;
        const uint32_t o3 = mul(in7, -F089) + mul(in1, F150 - F089) + z4p;
        out[0][col] = desc(tmp10 + o3);
        out[7][col] = desc(tmp10 - o3);
        out[1][col] = desc(tmp11 + o2);
        out[6][col] = desc(tmp11 - o2);
        out[2][col] = desc(tmp12 + o1);
        out[5][col] = desc(tmp12 - o1);
        out[3][col] = desc(tmp13 + o0);
        out[4][col] = desc(tmp13 - o0);
    }
}

void idct_block(const int16_t* coef, const int16_t* qt, uint8_t* out, size_t stride) {
    int16_t in[8][8], ws[8][8], t[8][8], res[8][8];
    bool ac_zero = true;
    for (int i = 8; i < 64; ++i)
        if (coef[i]) {
            ac_zero = false;
            break;
        }
    if (ac_zero) {  // rows 1-7 all zero: the DC row, shifted in 16 bits
        for (int col = 0; col < 8; ++col) {
            const int16_t dc = static_cast<int16_t>(static_cast<uint16_t>(static_cast<int16_t>(coef[col] * qt[col])) << 2);
            for (int row = 0; row < 8; ++row) ws[row][col] = dc;
        }
    } else {
        for (int i = 0; i < 64; ++i) in[i >> 3][i & 7] = static_cast<int16_t>(coef[i] * qt[i]);
        idct_pass(in, ws, 11);
    }
    for (int r = 0; r < 8; ++r)
        for (int c = 0; c < 8; ++c) t[c][r] = ws[r][c];
    idct_pass(t, res, 18);  // res[k][r]: output row r, column k
    for (int r = 0; r < 8; ++r)
        for (int k = 0; k < 8; ++k) {
            int v = res[k][r];
            v = v < -128 ? -128 : v > 127 ? 127 : v;
            out[r * stride + k] = static_cast<uint8_t>(v + 128);
        }
}

// libjpeg's block smoothing (jdcoefct.c smoothing_ok) would apply
bool smoothing_applies(const Decoder& dec) {
    if (!dec.progressive) return false;
    static const int kQPos[9] = {1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : dec.comp) {
        if (!c.latched) return false;
        if (c.qt[0] == 0) return false;
        for (int p : kQPos)
            if (c.qt[p] == 0) return false;
        if (c.coef_bits[0] < 0) return false;
        for (int k = 1; k < 10; ++k)
            if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
}

void Decoder::decode_dct() {
    const int mcus_x = (width + max_h * 8 - 1) / (max_h * 8);
    const int mcus_y = (height + max_v * 8 - 1) / (max_v * 8);
    for (auto& c : comp) {
        c.bw = mcus_x * c.h;
        c.bh = mcus_y * c.v;
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    Arith ar(*this);
    for (;;) {
        per_scan_setup();
        for (int ci = 0; ci < comps_in_scan; ++ci) {  // jdinput.c latch_quant_tables
            Comp& c = *cur[ci];
            if (c.latched) continue;
            if (c.tq < 0 || c.tq >= 4 || !qdef[c.tq]) fail(ST_BROKEN, "corrupt JPEG: a missing quantisation table");
            for (int i = 0; i < 64; ++i) c.qt[i] = static_cast<int16_t>(qtab[c.tq][i]);
            c.latched = true;
        }
        ++scan_number;
        if (progressive) {  // jdarith.c / jdphuff.c start_pass: validate the progression
            bool bad = false;
            if (Ss == 0) {
                bad = Se != 0;
            } else {
                bad = Se < Ss || Se > 63 || comps_in_scan != 1;
            }
            if (Ah != 0 && Ah - 1 != Al) bad = true;
            if (Al > 13) bad = true;
            if (bad) fail(ST_BROKEN, "corrupt JPEG: a bad progressive scan");
            for (int ci = 0; ci < comps_in_scan; ++ci) {
                Comp& c = *cur[ci];
                for (int k = std::min(Ss, 1); k <= std::max(Se, 9); ++k) c.prev_bits[k] = scan_number > 1 ? c.coef_bits[k] : 0;
                for (int k = Ss; k <= Se; ++k) c.coef_bits[k] = Al;
            }
        }
        std::unique_ptr<HuffProg> hp;
        if (arith) ar.start_pass();
        else hp.reset(new HuffProg(*this));
        int16_t* blocks[10];
        for (int my = 0; my < mcu_rows; ++my) {
            for (int mx = 0; mx < mcus_per_row; ++mx) {
                if (comps_in_scan == 1) {
                    Comp& c = *cur[0];
                    blocks[0] = c.coef.data() + (static_cast<size_t>(my) * c.bw + mx) * 64;
                } else {
                    int b = 0;
                    for (int ci = 0; ci < comps_in_scan; ++ci) {
                        Comp& c = *cur[ci];
                        for (int y = 0; y < c.v; ++y)
                            for (int x = 0; x < c.h; ++x)
                                blocks[b++] = c.coef.data()
                                              + (static_cast<size_t>(my * c.v + y) * c.bw + mx * c.h + x) * 64;
                    }
                }
                const int imcu = comps_in_scan == 1 ? my / cur[0]->v : my;
                if (!hp || !hp->br.insufficient) last_good_imcu = imcu;
                if (hp && take_sequential && !multi_scan) {
                    try {
                        hp->mcu(blocks);
                    } catch (const Fail& f) {  // libtiff's source fails: the iMCU rows before this one stand
                        if (f.status != ST_TRUNCATED) throw;
                        rows_delivered = imcu;
                        my = mcu_rows;
                        break;
                    }
                } else if (hp) hp->mcu(blocks);
                else if (!progressive) ar.mcu_sequential(blocks);
                else if (Ah == 0 && Ss == 0) ar.mcu_dc_first(blocks);
                else if (Ah == 0) ar.mcu_ac_first(blocks);
                else if (Ss == 0) ar.mcu_dc_refine(blocks);
                else ar.mcu_ac_refine(blocks);
            }
        }
        if (!multi_scan) {
            if (!take_sequential) finish_single_scan();  // libtiff reads no markers after the rows
            break;
        }
        if (read_markers() == 0xD9) break;
    }
    const bool smooth = smoothing_applies(*this);
    for (auto& c : comp) {
        c.pw = c.bw * 8;
        c.ph = c.bh * 8;
        c.plane.assign(static_cast<size_t>(c.pw) * c.ph, 0);
        if (!c.latched) {  // never in a scan: libjpeg's zero multipliers give mid-grey
            std::fill(c.plane.begin(), c.plane.end(), 128);
            continue;
        }
        if (smooth) {
            smooth_idct(c, mcus_y);
            continue;
        }
        for (int by = 0; by < c.hib; ++by)
            for (int bx = 0; bx < c.wib; ++bx)
                idct_block(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.qt,
                           c.plane.data() + static_cast<size_t>(by) * 8 * c.pw + bx * 8, static_cast<size_t>(c.pw));
    }
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1.3): each block's DC
// (where no AC coefficient was ever coded) and its AC 1-9 (where still 0
// and not known to full precision) estimated from the DC values of the 5 x
// 5 blocks around it, then the IDCT. The neighbours are found iMCU row by
// iMCU row as libjpeg finds them: the rows above and below clamped by its
// image_block_row arithmetic (which, in the last iMCU row, counts that
// row's blocks as if every row had as many), the columns by its sliding
// registers, which repeat the edge block.
void Decoder::smooth_idct(Comp& c, int total_imcu_rows) {
    int prev[10];  // smoothing_ok's latch of the bits before each coefficient's last scan
    for (int k = 1; k < 10; ++k) prev[k] = scan_number > 1 ? c.prev_bits[k] : -1;
    const int* bits = c.coef_bits;
    bool change_dc = false;
    auto q = [&](int pos) { return static_cast<long long>(static_cast<uint16_t>(c.qt[pos])); };
    const long long Q00 = q(0), Q01 = q(1), Q10 = q(8), Q20 = q(16), Q11 = q(9), Q02 = q(2);
    long long Q03 = 0, Q12 = 0, Q21 = 0, Q30 = 0;
    auto latch = [&](const int* b) {  // DC interpolated only where no AC coefficient is known at all
        bits = b;
        change_dc = true;
        for (int k = 1; k < 10; ++k)
            if (bits[k] != -1) change_dc = false;
        Q03 = change_dc ? q(3) : 0;
        Q12 = change_dc ? q(10) : 0;
        Q21 = change_dc ? q(17) : 0;
        Q30 = change_dc ? q(24) : 0;
    };
    auto dc = [&](int row, int col) { return static_cast<int>(c.coef[(static_cast<size_t>(row) * c.bw + col) * 64]); };
    // an estimate from num, scaled by Q00 / Q, clamped below 2^Al when Al > 0
    auto estimate = [](long long num, long long qk, int al) {
        int pred;
        if (num >= 0) {
            pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        } else {
            pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
        }
        return static_cast<int16_t>(pred);
    };
    const int last_imcu = total_imcu_rows - 1;
    const int last_col = c.wib - 1;
    int16_t ws[64];
    for (int r = 0; r < total_imcu_rows; ++r) {
        // past the last iMCU row the last scan fetched before its data ran
        // out, the bits as they were before that scan
        latch(r > last_good_imcu ? prev : c.coef_bits);
        int block_rows = c.v;
        if (r == last_imcu) {
            block_rows = c.hib % c.v;
            if (block_rows == 0) block_rows = c.v;
        }
        const int image_block_rows = block_rows * total_imcu_rows;
        for (int br = 0; br < block_rows; ++br) {
            const int row = r * c.v + br;
            const int ibr = r * block_rows + br;
            const int prev = ibr > 0 ? row - 1 : row;
            const int pprev = ibr > 1 ? row - 2 : prev;
            const int next = ibr < image_block_rows - 1 ? row + 1 : row;
            const int nnext = ibr < image_block_rows - 2 ? row + 2 : next;
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10, DC11, DC12, DC13, DC14, DC15, DC16,
                DC17, DC18, DC19, DC20, DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = dc(pprev, 0);
            DC06 = DC07 = DC08 = DC09 = DC10 = dc(prev, 0);
            DC11 = DC12 = DC13 = DC14 = DC15 = dc(row, 0);
            DC16 = DC17 = DC18 = DC19 = DC20 = dc(next, 0);
            DC21 = DC22 = DC23 = DC24 = DC25 = dc(nnext, 0);
            for (int col = 0; col <= last_col; ++col) {
                std::memcpy(ws, c.coef.data() + (static_cast<size_t>(row) * c.bw + col) * 64, sizeof ws);
                if (col == 0 && col < last_col) {  // two blocks wide: the second is also the one past it
                    DC04 = DC05 = dc(pprev, 1);
                    DC09 = DC10 = dc(prev, 1);
                    DC14 = DC15 = dc(row, 1);
                    DC19 = DC20 = dc(next, 1);
                    DC24 = DC25 = dc(nnext, 1);
                }
                if (col + 1 < last_col) {
                    DC05 = dc(pprev, col + 2);
                    DC10 = dc(prev, col + 2);
                    DC15 = dc(row, col + 2);
                    DC20 = dc(next, col + 2);
                    DC25 = dc(nnext, col + 2);
                }
                int al;
                if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
                    const long long num = Q00 * (change_dc
                        ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11
                           + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21
                           - DC22 + DC24 + DC25)
                        : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = estimate(num, Q01, al);
                }
                if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
                    const long long num = Q00 * (change_dc
                        ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09
                           - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23
                           + 3 * DC24 + DC25)
                        : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = estimate(num, Q10, al);
                }
                if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
                    const long long num = Q00 * (change_dc
                        ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17
                           + 7 * DC18 + 2 * DC19 + DC23)
                        : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = estimate(num, Q20, al);
                }
                if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
                    const long long num = Q00 * (change_dc
                        ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
                        : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06
                           + 10 * DC07 - 10 * DC09));
                    ws[9] = estimate(num, Q11, al);
                }
                if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
                    const long long num = Q00 * (change_dc
                        ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15
                           + 2 * DC17 - 5 * DC18 + 2 * DC19)
                        : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
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
                    const long long num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06
                                                 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11
                                                 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16
                                                 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21
                                                 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
                    ws[0] = estimate(num, Q00, 0);
                }
                idct_block(ws, c.qt, c.plane.data() + static_cast<size_t>(row) * 8 * c.pw + col * 8,
                           static_cast<size_t>(c.pw));
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

// after a single-scan image's last row Pillow's jpeg_finish_decompress reads
// markers up to EOI: an error there fails the decode, running out of data
// does not (the decoder suspends with every row out)
void Decoder::finish_single_scan() {
    try {
        for (;;) {
            const int m = read_markers();
            if (m == 0xD9) return;
            fail(ST_BROKEN, "corrupt JPEG: a scan after the image's only scan");
        }
    } catch (const Fail& f) {
        if (f.status != ST_TRUNCATED) throw;
    }
}

// ---------------------------------------------------------------------------
// Upsampling (jdsample.c) and the interleaved output
// ---------------------------------------------------------------------------

std::vector<uint8_t> Decoder::output(int nc) {
    std::vector<uint8_t> out(static_cast<size_t>(width) * height * nc);
    const bool fancy = !lossless;  // jdsample.c: do_fancy needs a DCT scaled size over 1
    std::vector<uint8_t> row(static_cast<size_t>(width) + 16);
    std::vector<int> colsum;
    for (int ci = 0; ci < nc; ++ci) {
        const Comp& c = comp[ci];
        const uint8_t* P = c.plane.data();
        const int pw = c.pw, dw = c.dw, dh = c.dh;
        auto prow = [&](int y) { return P + static_cast<size_t>(y < 0 ? 0 : y >= dh ? dh - 1 : y) * pw; };
        enum { FULL, H2V1F, H1V2F, H2V2F, INT } kind;
        if (c.h == max_h && c.v == max_v) kind = FULL;
        else if (2 * c.h == max_h && c.v == max_v) kind = fancy && dw > 2 ? H2V1F : INT;
        else if (c.h == max_h && 2 * c.v == max_v) kind = fancy ? H1V2F : INT;
        else if (2 * c.h == max_h && 2 * c.v == max_v) kind = fancy && dw > 2 ? H2V2F : INT;
        else kind = INT;
        const int hx = max_h / c.h, vx = max_v / c.v;
        colsum.assign(dw, 0);
        for (int y = 0; y < height; ++y) {
            const uint8_t* r;
            switch (kind) {
                case FULL: r = prow(y); break;
                case INT: {
                    const uint8_t* in = prow(y / vx);
                    for (int x = 0; x < width; ++x) row[x] = in[x / hx];
                    r = row.data();
                    break;
                }
                case H2V1F: {
                    const uint8_t* in = prow(y);
                    uint8_t* o = row.data();
                    o[0] = in[0];
                    o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
                    for (int i = 1; i < dw - 1; ++i) {
                        const int v = in[i] * 3;
                        o[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
                        o[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
                    }
                    const int i = dw - 1;
                    o[2 * i] = static_cast<uint8_t>((in[i] * 3 + in[i - 1] + 1) >> 2);
                    o[2 * i + 1] = in[i];
                    r = o;
                    break;
                }
                case H1V2F: {
                    const int i = y / 2;
                    const uint8_t* in0 = prow(i);
                    const uint8_t* in1 = prow(y % 2 == 0 ? i - 1 : i + 1);
                    const int bias = y % 2 == 0 ? 1 : 2;
                    for (int x = 0; x < dw; ++x) row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
                    r = row.data();
                    break;
                }
                default: {  // H2V2F
                    const int i = y / 2;
                    const uint8_t* in0 = prow(i);
                    const uint8_t* in1 = prow(y % 2 == 0 ? i - 1 : i + 1);
                    for (int x = 0; x < dw; ++x) colsum[x] = in0[x] * 3 + in1[x];
                    uint8_t* o = row.data();
                    o[0] = static_cast<uint8_t>((colsum[0] * 4 + 8) >> 4);
                    o[1] = static_cast<uint8_t>((colsum[0] * 3 + colsum[1] + 7) >> 4);
                    for (int k = 1; k < dw - 1; ++k) {
                        o[2 * k] = static_cast<uint8_t>((colsum[k] * 3 + colsum[k - 1] + 8) >> 4);
                        o[2 * k + 1] = static_cast<uint8_t>((colsum[k] * 3 + colsum[k + 1] + 7) >> 4);
                    }
                    const int k = dw - 1;
                    o[2 * k] = static_cast<uint8_t>((colsum[k] * 3 + colsum[k - 1] + 8) >> 4);
                    o[2 * k + 1] = static_cast<uint8_t>((colsum[k] * 4 + 7) >> 4);
                    r = o;
                    break;
                }
            }
            uint8_t* dst = out.data() + static_cast<size_t>(y) * width * nc + ci;
            for (int x = 0; x < width; ++x) dst[static_cast<size_t>(x) * nc] = r[x];
        }
    }
    return out;
}

// Whether a Huffman-coded progressive (SOF2) stream leaves its progression
// incomplete: a component never in a scan, or a coefficient never coded or
// not refined to its last bit. That takes in every stream libjpeg smooths
// (smoothing_ok), and those where nvJPEG on the card refuses the file or
// reads the unrefined bits otherwise than libjpeg. Read from the headers
// alone: the frame, the component's tables latched at their first scan and
// the coefficient bits the scan headers leave (jdphuff.c start_pass), the
// entropy-coded data skipped as next_marker skips it. A stream that ends
// early is judged by the scans it has; one whose headers libjpeg refuses
// (a bad progression, a missing table) is left to libjpeg.
bool sof2_incomplete(const uint8_t* d, size_t n) {
    Decoder w(d, n);
    w.take_sof2 = true;
    try {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) return false;
        w.pos = 2;
        if (w.read_markers() != 0xDA) return false;
        if (!w.saw_sof || !w.progressive || w.arith || w.precision != 8) return false;
        for (auto& c : w.comp)
            for (int& b : c.coef_bits) b = -1;
        for (;;) {
            for (int ci = 0; ci < w.comps_in_scan; ++ci) {
                Comp& c = *w.cur[ci];
                if (c.latched) continue;
                if (c.tq < 0 || c.tq >= 4 || !w.qdef[c.tq]) return false;
                for (int i = 0; i < 64; ++i) c.qt[i] = static_cast<int16_t>(w.qtab[c.tq][i]);
                c.latched = true;
            }
            const bool bad = (w.Ss == 0 ? w.Se != 0 : w.Se < w.Ss || w.Se > 63 || w.comps_in_scan != 1)
                             || (w.Ah != 0 && w.Ah - 1 != w.Al) || w.Al > 13;
            if (bad) return false;
            for (int ci = 0; ci < w.comps_in_scan; ++ci)
                for (int k = w.Ss; k <= w.Se; ++k) w.cur[ci]->coef_bits[k] = w.Al;
            try {
                if (w.read_markers() == 0xD9) break;
            } catch (const Fail& f) {
                if (f.status != ST_TRUNCATED) return false;
                break;
            }
        }
        for (const auto& c : w.comp) {
            if (!c.latched) return true;
            for (int b : c.coef_bits)
                if (b != 0) return true;
        }
        return false;
    } catch (const Fail&) {
        return false;
    }
}

void Decoder::decode(long long max_pixels, int* dims) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail(ST_BROKEN, "not a JPEG: no SOI marker");
    pos = 2;
    for (;;) {
        const int m = read_markers();
        if (m == 0xDA) break;
        // EOI before any scan: a tables-only stream, followed by nothing Pillow reads
        fail(pos >= n ? ST_TRUNCATED : ST_BROKEN, "corrupt JPEG: no image before EOI");
    }
    if (!saw_sof) fail(ST_NOT_OWN, "no frame header");
    initial_setup(max_pixels, dims);
    if (lossless) decode_lossless();
    else decode_dct();
}

}  // namespace

extern "C" int mmtrs_jpeg_own_decode_as(const void* buf, long long n, long long max_pixels, int space, void* out,
                                        void* dims, void* msg) {
    void** dst = static_cast<void**>(out);
    int* dm = static_cast<int*>(dims);
    char* text = static_cast<char*>(msg);
    *dst = nullptr;
    text[0] = 0;
    try {
        const size_t size = n > 0 ? static_cast<size_t>(n) : 0;
        Decoder dec(static_cast<const uint8_t*>(buf), size);
        dec.forced_space = space & 0xFF;
        dec.libtiff_source = (space & LIBTIFF_SOURCE) != 0;
        dec.take_sof2 = sof2_incomplete(static_cast<const uint8_t*>(buf), size);
        dec.decode(max_pixels, dm);
        const int nc = dec.ncomp;
        std::vector<uint8_t> px = dec.output(nc);
        void* mem = std::malloc(px.size());
        if (!mem) {
            std::snprintf(text, 256, "out of memory");
            return ST_BROKEN;
        }
        std::memcpy(mem, px.data(), px.size());
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

extern "C" int mmtrs_jpeg_own_decode(const void* buf, long long n, long long max_pixels, void* out, void* dims,
                                     void* msg) {
    return mmtrs_jpeg_own_decode_as(buf, n, max_pixels, 0, out, dims, msg);
}

extern "C" int mmtrs_jpeg_own_decode_raw(const void* buf, long long n, long long max_pixels, void* out, void* dims,
                                         void* msg) {
    void** dst = static_cast<void**>(out);
    int* dm = static_cast<int*>(dims);
    char* text = static_cast<char*>(msg);
    *dst = nullptr;
    text[0] = 0;
    try {
        Decoder dec(static_cast<const uint8_t*>(buf), n > 0 ? static_cast<size_t>(n) : 0);
        dec.take_sequential = true;
        dec.forced_space = CS_UNKNOWN;
        dec.decode(max_pixels, dm);
        dm[3] = dec.resync_failed ? -2 - dec.rows_delivered : dec.rows_delivered;
        size_t total = 0;
        for (int ci = 0; ci < dec.ncomp; ++ci) {
            const Comp& c = dec.comp[ci];
            dm[4 + 4 * ci] = c.dh;
            dm[5 + 4 * ci] = c.dw;
            dm[6 + 4 * ci] = c.h;
            dm[7 + 4 * ci] = c.v;
            total += static_cast<size_t>(c.dh) * c.dw;
        }
        uint8_t* mem = static_cast<uint8_t*>(std::malloc(total ? total : 1));
        if (!mem) {
            std::snprintf(text, 256, "out of memory");
            return ST_BROKEN;
        }
        uint8_t* p = mem;
        for (int ci = 0; ci < dec.ncomp; ++ci) {
            const Comp& c = dec.comp[ci];
            for (int y = 0; y < c.dh; ++y, p += c.dw)
                std::memcpy(p, c.plane.data() + static_cast<size_t>(y) * c.pw, static_cast<size_t>(c.dw));
        }
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

extern "C" int mmtrs_jpeg_own_takes_sof2(const void* buf, long long n) {
    return sof2_incomplete(static_cast<const uint8_t*>(buf), n > 0 ? static_cast<size_t>(n) : 0) ? 1 : 0;
}

extern "C" int mmtrs_jpeg_own_free(void* p) {
    std::free(p);
    return 0;
}
