// The port's own JPEG 2000 decoder: a codestream (the contents of a .jp2
// file's jp2c box, or a raw .j2k stream) decoded as Pillow 12.1 drives its
// bundled OpenJPEG 2.5.4 (Jpeg2KDecode.c: opj_read_header, then tile by
// tile opj_read_tile_header / opj_decode_tile_data, reduce 0, every quality
// layer, strict mode). The stages, in OpenJPEG's order:
//
// - the codestream's markers (j2k.c): SIZ, COD, COC, QCD, QCC, RGN, POC,
//   PPM, PPT, SOT/SOD and tile-parts; TLM, PLM, PLT, CRG, COM and unknown
//   markers skipped as OpenJPEG skips them;
// - tier 2 (t2.c, pi.c, tgt.c, bio.c): packet iterators for LRCP, RLCP,
//   RPCL, PCRL and CPRL with progression order changes, tag trees,
//   code-block inclusion, zero bit-planes, pass counts, Lblock, SOP and
//   EPH (a missing SOP passes, a missing EPH fails), headers from PPM and
//   PPT;
// - tier 1 (t1.c, mqc.c): the MQ decoder and the three coding passes, with
//   every code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM)
//   and ROI shifts;
// - dequantisation with OpenJPEG's reconstruction offsets (half a step:
//   one extra fractional bit halved for the 5/3, 0.5 * step for the 9/7);
// - the inverse wavelets (dwt.c): the 5/3 in integers, the 9/7 in single
//   precision with OpenJPEG's lifting constants and order (scaling by K
//   and 2/K first, then the delta, gamma, beta and alpha steps, rows before
//   columns at each level); build with -ffp-contract=off and no fast math;
// - the component transforms (mct.c: RCT and ICT) and the DC level shift
//   with OpenJPEG's clamps (tcd.c; lrintf for the 9/7).
//
// The result is each decoded tile's components as OpenJPEG hands them to
// Pillow (32-bit samples at the component's resolution); utils/rasters.py
// unpacks them as Pillow's unpackers do. No global state (a tile's
// code-blocks and components run on up to 8 threads of the call); only the
// C++ standard library; nothing is linked.
//
// C API (ctypes, plain C):
//   int mmtrs_jp2_decode(const void* buf, long long n, long long max_pixels,
//                        void* out, void* out_len, void* msg);
//     buf: a codestream (from SOC). out: void*[1] <- a malloc'd blob (free
//     with mmtrs_jp2_free): int32 words. The image: x0, y0, x1, y1,
//     numcomps, then per component dx, dy, prec, sgnd; the count of decoded
//     tiles; per tile its index, x0, y0, x1, y1 (the reference grid, as
//     opj_read_tile_header reports them), then per component its width,
//     height and samples. out_len: long long[1] <- the words in the blob.
//     msg: char[256] <- the reason of a refusal. Returns 0 ok, 2 corrupt
//     (OpenJPEG refuses it in strict mode), 3 truncated, 5 over max_pixels,
//     6 a feature refused by name.
//   int mmtrs_jp2_free(void* p);
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off -pthread jp2.cpp (see mmtrs_tpu_torch/_build.py)

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int ST_BROKEN = 2, ST_TRUNCATED = 3, ST_BOMB = 5, ST_REFUSED = 6;

struct Fail {
    int status;
    std::string what;
};

[[noreturn]] void fail(int status, const std::string& what) { throw Fail{status, what}; }
[[noreturn]] void broken(const std::string& what) { fail(ST_BROKEN, "corrupt JPEG 2000: " + what); }

inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int32_t ceildivpow2(int64_t a, int b) { return static_cast<int32_t>((a + (int64_t(1) << b) - 1) >> b); }
inline int32_t floordivpow2(int32_t a, int b) { return a >> b; }
inline uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) {
        a >>= 1;
        ++l;
    }
    return l;
}

// ---------------------------------------------------------------------------
// Coding parameters (OpenJPEG's opj_cp_t, opj_tcp_t, opj_tccp_t)
// ---------------------------------------------------------------------------

constexpr int kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;
// code-block styles; PTERM (16) changes nothing a decoder does
enum { CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8, CBLK_SEGSYM = 32 };
enum { PRG_LRCP = 0, PRG_RLCP = 1, PRG_RPCL = 2, PRG_PCRL = 3, PRG_CPRL = 4 };

struct Tccp {
    uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    uint32_t qntsty = 0, numgbits = 0;
    int32_t roishift = 0;
    uint32_t prcw[kMaxRes] = {}, prch[kMaxRes] = {};
    int32_t expn[kMaxBands] = {}, mant[kMaxBands] = {};
};

struct Poc {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0, prg = 0;
};

struct Tcp {
    uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
    std::vector<Tccp> tccps;
    std::vector<Poc> pocs;
    bool has_poc = false;
    std::vector<std::vector<uint8_t>> ppt_parts;  // the PPT segments' packet headers, by Zppt
    bool ppt = false;
    std::vector<uint8_t> data;  // the tile-parts' bodies, in order
    int parts_seen = 0, parts_total = 0;
    bool has_data = false;
};

struct CompInfo {
    uint32_t dx = 1, dy = 1, prec = 8, sgnd = 0;
};

struct Image {
    uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    std::vector<CompInfo> comps;
};

// ---------------------------------------------------------------------------
// The codestream reader
// ---------------------------------------------------------------------------

struct Stream {
    const uint8_t* d;
    size_t n, pos = 0;
    size_t left() const { return n - pos; }
    uint32_t u8() {
        if (pos >= n) fail(ST_TRUNCATED, "truncated JPEG 2000: the codestream ends early");
        return d[pos++];
    }
    uint32_t u16() {
        const uint32_t a = u8();
        return (a << 8) | u8();
    }
};

// a marker segment's body, read with OpenJPEG's bounds (its length checked
// against what the marker needs)
struct Seg {
    const uint8_t* p;
    uint32_t n, pos = 0;
    uint32_t get(int bytes) {
        if (pos + static_cast<uint32_t>(bytes) > n) broken("a marker segment shorter than its fields");
        uint32_t v = 0;
        for (int i = 0; i < bytes; ++i) v = (v << 8) | p[pos++];
        return v;
    }
    uint32_t left() const { return n - pos; }
};

struct Codestream {
    Image img;
    Tcp def;                // the main header's defaults
    std::vector<Tcp> tcps;  // one a tile
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_parts;  // by Zppm
    std::vector<uint8_t> ppm_data;                // the PPM's Ippm, concatenated, consumed tile-part by tile-part
    size_t ppm_used = 0;
    bool have_cod = false, have_qcd = false;
    // OpenJPEG's resno_decoded: by component, the highest resolution of any
    // packet read so far in the image (it never falls from tile to tile); a
    // tile is reconstructed and handed out at that resolution
    std::vector<uint32_t> resno_decoded;

    uint32_t comp_room() const { return img.comps.size() <= 256 ? 1 : 2; }

    void read_siz(Seg& s, long long max_pixels) {
        s.get(2);  // Rsiz
        img.x1 = s.get(4);
        img.y1 = s.get(4);
        img.x0 = s.get(4);
        img.y0 = s.get(4);
        img.tdx = s.get(4);
        img.tdy = s.get(4);
        img.tx0 = s.get(4);
        img.ty0 = s.get(4);
        const uint32_t nc = s.get(2);
        if (s.n != 36 + 3 * nc) broken("a SIZ segment of the wrong length");
        if (nc == 0 || nc > 16384) broken("a SIZ segment with a bad component count");
        if (img.x0 >= img.x1 || img.y0 >= img.y1) broken("an empty image");
        if (img.tdx == 0 || img.tdy == 0) broken("tiles of size 0");
        if (img.tx0 > img.x0 || img.ty0 > img.y0) broken("a tile origin past the image origin");
        if (static_cast<uint64_t>(img.tx0) + img.tdx <= img.x0 || static_cast<uint64_t>(img.ty0) + img.tdy <= img.y0)
            broken("a first tile outside the image");
        img.comps.resize(nc);
        for (auto& c : img.comps) {
            const uint32_t ssiz = s.get(1);
            c.prec = (ssiz & 0x7f) + 1;
            c.sgnd = ssiz >> 7;
            c.dx = s.get(1);
            c.dy = s.get(1);
            if (c.dx == 0 || c.dy == 0) broken("a component subsampling of 0");
            if (c.prec > 31) fail(ST_REFUSED, "JPEG 2000 of more than 31 bits a sample is not decoded (nor by Pillow)");
        }
        img.tw = static_cast<uint32_t>(ceildiv(static_cast<int64_t>(img.x1) - img.tx0, img.tdx));
        img.th = static_cast<uint32_t>(ceildiv(static_cast<int64_t>(img.y1) - img.ty0, img.tdy));
        if (img.tw == 0 || img.th == 0 || static_cast<uint64_t>(img.tw) * img.th > 65535)
            broken("a bad number of tiles");
        const long long w = static_cast<long long>(img.x1) - img.x0, h = static_cast<long long>(img.y1) - img.y0;
        if (max_pixels >= 0 && w * h > max_pixels) fail(ST_BOMB, "over the pixel limit");
        def.tccps.assign(nc, Tccp());
    }

    // opj_j2k_read_SPCod_SPCoc: the component's coding style from byte 0 of SPcod
    static void read_spcod(Seg& s, Tccp& t, bool precincts) {
        t.numresolutions = s.get(1) + 1;
        if (t.numresolutions > kMaxRes) broken("more decomposition levels than allowed");
        t.cblkw = s.get(1) + 2;
        t.cblkh = s.get(1) + 2;
        if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) broken("a bad code-block size");
        t.cblksty = s.get(1);
        if (t.cblksty & 0x80) broken("a mixed high-throughput code-block style");
        if (t.cblksty & 0x40)
            fail(ST_REFUSED, "JPEG 2000 high-throughput code-blocks (HTJ2K) are not supported by the port's codec");
        t.qmfbid = s.get(1);
        if (t.qmfbid > 1) broken("an unknown wavelet transform");
        t.csty = precincts ? 1 : 0;
        if (precincts) {
            for (uint32_t r = 0; r < t.numresolutions; ++r) {
                const uint32_t v = s.get(1);
                if (r != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) broken("a precinct size of 1 in a resolution over 0");
                t.prcw[r] = v & 0xf;
                t.prch[r] = v >> 4;
            }
        } else {
            for (uint32_t r = 0; r < t.numresolutions; ++r) t.prcw[r] = t.prch[r] = 15;
        }
    }

    void read_cod(Seg& s, Tcp& tcp) {
        tcp.csty = s.get(1);
        if (tcp.csty & ~7u) broken("an unknown coding style");
        tcp.prg = s.get(1);
        if (tcp.prg > 4) broken("an unknown progression order");
        tcp.numlayers = s.get(2);
        if (tcp.numlayers == 0) broken("no quality layers");
        tcp.mct = s.get(1);
        if (tcp.mct > 1) broken("a multiple component transform other than 0 or 1 (Part 2)");
        Tccp first;
        read_spcod(s, first, tcp.csty & 1);
        if (s.left() != 0) broken("a COD segment of the wrong length");
        for (auto& t : tcp.tccps) {
            t.csty = first.csty;
            t.numresolutions = first.numresolutions;
            t.cblkw = first.cblkw;
            t.cblkh = first.cblkh;
            t.cblksty = first.cblksty;
            t.qmfbid = first.qmfbid;
            std::memcpy(t.prcw, first.prcw, sizeof t.prcw);
            std::memcpy(t.prch, first.prch, sizeof t.prch);
        }
    }

    void read_coc(Seg& s, Tcp& tcp) {
        const uint32_t c = s.get(comp_room());
        if (c >= img.comps.size()) broken("a COC segment for a component the image lacks");
        const uint32_t scoc = s.get(1);
        read_spcod(s, tcp.tccps[c], scoc & 1);
        if (s.left() != 0) broken("a COC segment of the wrong length");
    }

    // opj_j2k_read_SQcd_SQcc
    static void read_sqcd(Seg& s, Tccp& t) {
        const uint32_t sq = s.get(1);
        t.qntsty = sq & 0x1f;
        t.numgbits = sq >> 5;
        // any style but 0 (none) and 1 (derived) is read as 2 (expounded); steps
        // past the last band are read and dropped
        const uint32_t bands = t.qntsty == 1 ? 1 : t.qntsty == 0 ? s.left() : s.left() / 2;
        for (uint32_t b = 0; b < bands; ++b) {
            int32_t e, m = 0;
            if (t.qntsty == 0) {
                e = static_cast<int32_t>(s.get(1) >> 3);
            } else {
                const uint32_t v = s.get(2);
                e = static_cast<int32_t>(v >> 11);
                m = static_cast<int32_t>(v & 0x7ff);
            }
            if (b < kMaxBands) {
                t.expn[b] = e;
                t.mant[b] = m;
            }
        }
        if (t.qntsty == 1) {
            for (uint32_t b = 1; b < kMaxBands; ++b) {
                const int32_t e = t.expn[0] - static_cast<int32_t>((b - 1) / 3);
                t.expn[b] = e > 0 ? e : 0;
                t.mant[b] = t.mant[0];
            }
        }
    }

    void read_qcd(Seg& s, Tcp& tcp) {
        Tccp q;
        read_sqcd(s, q);
        if (s.left() != 0) broken("a QCD segment of the wrong length");
        for (size_t c = 0; c < tcp.tccps.size(); ++c) {  // as OpenJPEG: every component, a QCC read before too
            Tccp& t = tcp.tccps[c];
            t.qntsty = q.qntsty;
            t.numgbits = q.numgbits;
            std::memcpy(t.expn, q.expn, sizeof t.expn);
            std::memcpy(t.mant, q.mant, sizeof t.mant);
        }
    }

    void read_qcc(Seg& s, Tcp& tcp) {
        const uint32_t c = s.get(comp_room());
        if (c >= img.comps.size()) broken("a QCC segment for a component the image lacks");
        read_sqcd(s, tcp.tccps[c]);
        if (s.left() != 0) broken("a QCC segment of the wrong length");
    }

    void read_rgn(Seg& s, Tcp& tcp) {
        const uint32_t c = s.get(comp_room());
        s.get(1);  // Srgn
        const uint32_t shift = s.get(1);
        if (s.left() != 0) broken("an RGN segment of the wrong length");
        if (c >= img.comps.size()) broken("an RGN segment for a component the image lacks");
        tcp.tccps[c].roishift = static_cast<int32_t>(shift);
    }

    void read_poc(Seg& s, Tcp& tcp) {
        const uint32_t room = comp_room();
        const uint32_t chunk = 5 + 2 * room;
        if (s.n % chunk != 0 || s.n == 0) broken("a POC segment of the wrong length");
        const uint32_t count = s.n / chunk;
        if (tcp.pocs.size() + count >= 32) broken("32 or more progression order changes");
        for (uint32_t i = 0; i < count; ++i) {
            Poc p;
            p.resno0 = s.get(1);
            p.compno0 = s.get(room);
            p.layno1 = std::min(s.get(2), tcp.numlayers);
            p.resno1 = s.get(1);
            p.compno1 = std::min<uint32_t>(s.get(room), static_cast<uint32_t>(img.comps.size()));
            p.prg = s.get(1);
            tcp.pocs.push_back(p);
        }
        tcp.has_poc = true;
    }

    static void read_ppx(Seg& s, std::vector<std::vector<uint8_t>>& parts, const char* what) {
        if (s.n < 1) broken(std::string("a ") + what + " segment of the wrong length");
        const uint32_t z = s.get(1);
        if (parts.size() <= z) parts.resize(z + 1);
        if (!parts[z].empty()) broken(std::string("a repeated ") + what + " index");
        parts[z].assign(s.p + 1, s.p + s.n);
    }
};

// ---------------------------------------------------------------------------
// The tile's structure (tcd.c opj_tcd_init_tile): components, resolutions,
// bands, precincts and code-blocks on the reference grid
// ---------------------------------------------------------------------------

struct SegInfo {
    uint32_t len = 0, numpasses = 0, maxpasses = 0, numnewpasses = 0, newlen = 0;
};

struct Cblk {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
    size_t first_new_seg = 0;   // the first segment the current packet adds passes to
    std::vector<SegInfo> segs;  // segs.size() is OpenJPEG's numsegs
    std::vector<uint8_t> data;  // the chunks, in the order the packets bring them
};

// tgt.c: a quad tree over the code-blocks of a precinct's band
struct TagTree {
    struct Node {
        int32_t value = 999, low = 0;
        int parent = -1;
    };
    std::vector<Node> nodes;
    void init(uint32_t w, uint32_t h) {
        nodes.clear();
        if (w == 0 || h == 0) return;
        std::vector<uint32_t> lw{w}, lh{h};
        while (lw.back() * lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        std::vector<size_t> start(lw.size());
        size_t total = 0;
        for (size_t l = 0; l < lw.size(); ++l) {
            start[l] = total;
            total += static_cast<size_t>(lw[l]) * lh[l];
        }
        nodes.assign(total, Node());
        for (size_t l = 0; l + 1 < lw.size(); ++l)
            for (uint32_t y = 0; y < lh[l]; ++y)
                for (uint32_t x = 0; x < lw[l]; ++x)
                    nodes[start[l] + static_cast<size_t>(y) * lw[l] + x].parent =
                        static_cast<int>(start[l + 1] + static_cast<size_t>(y / 2) * lw[l + 1] + x / 2);
    }
};

struct Precinct {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t bandno = 0;
    int32_t numbps = 0;
    float stepsize = 0;
    std::vector<Precinct> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
    Band bands[3];
};

struct TileComp {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    uint32_t numres = 0;
    std::vector<Resolution> res;
    std::vector<int32_t> idata;  // the reversible path's coefficients and samples
    std::vector<float> fdata;    // the irreversible path's
    size_t w() const { return static_cast<size_t>(x1 - x0); }
    size_t h() const { return static_cast<size_t>(y1 - y0); }
};

struct Tile {
    int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<TileComp> comps;
};

void init_tile(const Codestream& cs, const Tcp& tcp, uint32_t tileno, Tile& t) {
    const Image& img = cs.img;
    const uint32_t p = tileno % img.tw, q = tileno / img.tw;
    const uint64_t tx0 = static_cast<uint64_t>(img.tx0) + static_cast<uint64_t>(p) * img.tdx;
    const uint64_t ty0 = static_cast<uint64_t>(img.ty0) + static_cast<uint64_t>(q) * img.tdy;
    t.x0 = static_cast<int32_t>(std::max<uint64_t>(tx0, img.x0));
    t.y0 = static_cast<int32_t>(std::max<uint64_t>(ty0, img.y0));
    t.x1 = static_cast<int32_t>(std::min<uint64_t>(tx0 + img.tdx, img.x1));
    t.y1 = static_cast<int32_t>(std::min<uint64_t>(ty0 + img.tdy, img.y1));
    if (t.x0 < 0 || t.x1 < 0 || t.y0 < 0 || t.y1 < 0 || t.x1 <= t.x0 || t.y1 <= t.y0) broken("a tile outside the image");
    t.comps.assign(img.comps.size(), TileComp());
    for (size_t c = 0; c < img.comps.size(); ++c) {
        const CompInfo& ci = img.comps[c];
        const Tccp& tc = tcp.tccps[c];
        TileComp& tcomp = t.comps[c];
        tcomp.x0 = static_cast<int32_t>(ceildiv(t.x0, ci.dx));
        tcomp.y0 = static_cast<int32_t>(ceildiv(t.y0, ci.dy));
        tcomp.x1 = static_cast<int32_t>(ceildiv(t.x1, ci.dx));
        tcomp.y1 = static_cast<int32_t>(ceildiv(t.y1, ci.dy));
        tcomp.numres = tc.numresolutions;
        tcomp.res.assign(tc.numresolutions, Resolution());
        for (uint32_t r = 0; r < tc.numresolutions; ++r) {
            Resolution& res = tcomp.res[r];
            const uint32_t level = tc.numresolutions - 1 - r;
            res.x0 = ceildivpow2(tcomp.x0, level);
            res.y0 = ceildivpow2(tcomp.y0, level);
            res.x1 = ceildivpow2(tcomp.x1, level);
            res.y1 = ceildivpow2(tcomp.y1, level);
            res.pdx = tc.prcw[r];
            res.pdy = tc.prch[r];
            const int32_t prc_x0 = floordivpow2(res.x0, res.pdx) << res.pdx;
            const int32_t prc_y0 = floordivpow2(res.y0, res.pdy) << res.pdy;
            const int32_t prc_x1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
            const int32_t prc_y1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
            res.pw = res.x0 == res.x1 ? 0 : static_cast<uint32_t>((prc_x1 - prc_x0) >> res.pdx);
            res.ph = res.y0 == res.y1 ? 0 : static_cast<uint32_t>((prc_y1 - prc_y0) >> res.pdy);
            if (static_cast<uint64_t>(res.pw) * res.ph > (1u << 28)) broken("too many precincts");
            int32_t cbg_x0, cbg_y0;
            uint32_t cbgw, cbgh;
            if (r == 0) {
                cbg_x0 = prc_x0;
                cbg_y0 = prc_y0;
                cbgw = res.pdx;
                cbgh = res.pdy;
                res.numbands = 1;
            } else {
                cbg_x0 = ceildivpow2(prc_x0, 1);
                cbg_y0 = ceildivpow2(prc_y0, 1);
                cbgw = res.pdx - 1;
                cbgh = res.pdy - 1;
                res.numbands = 3;
            }
            const uint32_t cblkw = std::min(tc.cblkw, cbgw), cblkh = std::min(tc.cblkh, cbgh);
            for (uint32_t b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                band.bandno = r == 0 ? 0 : b + 1;
                if (r == 0) {
                    band.x0 = ceildivpow2(tcomp.x0, level);
                    band.y0 = ceildivpow2(tcomp.y0, level);
                    band.x1 = ceildivpow2(tcomp.x1, level);
                    band.y1 = ceildivpow2(tcomp.y1, level);
                } else {
                    const int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
                    band.x0 = ceildivpow2(tcomp.x0 - (x0b << level), level + 1);
                    band.y0 = ceildivpow2(tcomp.y0 - (y0b << level), level + 1);
                    band.x1 = ceildivpow2(tcomp.x1 - (x0b << level), level + 1);
                    band.y1 = ceildivpow2(tcomp.y1 - (y0b << level), level + 1);
                }
                const uint32_t idx = r == 0 ? 0 : 3 * (r - 1) + band.bandno;
                if (idx >= static_cast<uint32_t>(kMaxBands)) broken("a band past the quantisation steps");
                // the decoder's 9/7 path folds the subband gains into its 2/K scaling
                const int32_t log2_gain = tc.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
                const int32_t rb = static_cast<int32_t>(img.comps[c].prec) + log2_gain;
                band.stepsize = static_cast<float>((1.0 + tc.mant[idx] / 2048.0) * std::pow(2.0, rb - tc.expn[idx]));
                band.numbps = tc.expn[idx] + static_cast<int32_t>(tc.numgbits) - 1;
                band.precs.assign(static_cast<size_t>(res.pw) * res.ph, Precinct());
                for (uint32_t pn = 0; pn < res.pw * res.ph; ++pn) {
                    Precinct& prc = band.precs[pn];
                    const int32_t cx0 = cbg_x0 + static_cast<int32_t>(pn % res.pw) * (1 << cbgw);
                    const int32_t cy0 = cbg_y0 + static_cast<int32_t>(pn / res.pw) * (1 << cbgh);
                    prc.x0 = std::max(cx0, band.x0);
                    prc.y0 = std::max(cy0, band.y0);
                    prc.x1 = std::min(cx0 + (1 << cbgw), band.x1);
                    prc.y1 = std::min(cy0 + (1 << cbgh), band.y1);
                    const int32_t bx0 = floordivpow2(prc.x0, cblkw) << cblkw;
                    const int32_t by0 = floordivpow2(prc.y0, cblkh) << cblkh;
                    const int32_t bx1 = ceildivpow2(prc.x1, cblkw) << cblkw;
                    const int32_t by1 = ceildivpow2(prc.y1, cblkh) << cblkh;
                    prc.cw = bx1 > bx0 ? static_cast<uint32_t>((bx1 - bx0) >> cblkw) : 0;
                    prc.ch = by1 > by0 ? static_cast<uint32_t>((by1 - by0) >> cblkh) : 0;
                    if (prc.x0 >= prc.x1 || prc.y0 >= prc.y1) prc.cw = prc.ch = 0;
                    prc.cblks.assign(static_cast<size_t>(prc.cw) * prc.ch, Cblk());
                    for (uint32_t k = 0; k < prc.cw * prc.ch; ++k) {
                        Cblk& cb = prc.cblks[k];
                        const int32_t kx = bx0 + static_cast<int32_t>(k % prc.cw) * (1 << cblkw);
                        const int32_t ky = by0 + static_cast<int32_t>(k / prc.cw) * (1 << cblkh);
                        cb.x0 = std::max(kx, prc.x0);
                        cb.y0 = std::max(ky, prc.y0);
                        cb.x1 = std::min(kx + (1 << cblkw), prc.x1);
                        cb.y1 = std::min(ky + (1 << cblkh), prc.y1);
                    }
                    prc.incl.init(prc.cw, prc.ch);
                    prc.imsb.init(prc.cw, prc.ch);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Tier 2: the packet headers' bit reader (bio.c), tag trees, packets (t2.c)
// ---------------------------------------------------------------------------

struct Bio {
    const uint8_t *start, *bp, *end;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n; i > 0; --i) v |= bit() << (i - 1);
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
    int stk[64];
    int sp = 0;
    int node = static_cast<int>(leaf);
    while (tree.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = tree.nodes[node].parent;
    }
    int32_t low = 0;
    for (;;) {
        TagTree::Node& nd = tree.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.read(1)) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

void init_seg(Cblk& cb, uint32_t cblksty, bool first) {
    SegInfo s;
    if (cblksty & CBLK_TERMALL) {
        s.maxpasses = 1;
    } else if (cblksty & CBLK_LAZY) {
        if (first) s.maxpasses = 10;
        else s.maxpasses = (cb.segs.back().maxpasses == 1 || cb.segs.back().maxpasses == 10) ? 2 : 1;
    } else {
        s.maxpasses = 109;
    }
    cb.segs.push_back(s);
}

// the packet header bytes: in the tile's data, or from PPM / PPT
struct HeaderSource {
    const uint8_t* p;
    size_t left;
};

// opj_t2_read_packet_header + opj_t2_read_packet_data for one packet; data
// (the tile's bytes) advances past the packet
void read_packet(const Tcp& tcp, Tile& tile, uint32_t compno, uint32_t resno, uint32_t precno, uint32_t layno,
                 const uint8_t*& data, const uint8_t* data_end, HeaderSource* hdr) {
    TileComp& tc = tile.comps[compno];
    Resolution& res = tc.res[resno];
    const uint32_t cblksty = tcp.tccps[compno].cblksty;
    const uint8_t* cur = data;
    if (tcp.csty & 2) {  // SOP: skipped where present, a warning where not
        if (static_cast<size_t>(data_end - cur) >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hstart;
    size_t hlen;
    if (hdr) {
        hstart = hdr->p;
        hlen = hdr->left;
    } else {
        hstart = cur;
        hlen = static_cast<size_t>(data_end - cur);
    }
    Bio bio(hstart, hlen);
    const uint32_t present = bio.read(1);
    if (present) {
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            if (precno >= band.precs.size()) broken("a packet of a precinct the band lacks");
            Precinct& prc = band.precs[precno];
            for (uint32_t k = 0; k < prc.cw * prc.ch; ++k) {
                Cblk& cb = prc.cblks[k];
                uint32_t included;
                if (cb.segs.empty()) included = tgt_decode(bio, prc.incl, k, static_cast<int32_t>(layno + 1));
                else included = bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (cb.segs.empty()) {
                    uint32_t i = 0;
                    while (!tgt_decode(bio, prc.imsb, k, static_cast<int32_t>(i))) ++i;
                    cb.numbps = static_cast<uint32_t>(band.numbps) + 1 - i;
                    cb.numlenbits = 3;
                }
                // opj_t2_getnumpasses
                uint32_t n;
                if (!bio.read(1)) n = 1;
                else if (!bio.read(1)) n = 2;
                else if ((n = bio.read(2)) != 3) n += 3;
                else if ((n = bio.read(5)) != 31) n += 6;
                else n = 37 + bio.read(7);
                cb.numnewpasses = n;
                // opj_t2_getcommacode
                uint32_t inc = 0;
                while (bio.read(1)) ++inc;
                cb.numlenbits += inc;
                size_t segno;
                if (cb.segs.empty()) {
                    init_seg(cb, cblksty, true);
                    segno = 0;
                } else {
                    segno = cb.segs.size() - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, cblksty, false);
                    }
                }
                cb.first_new_seg = segno;
                int32_t left = static_cast<int32_t>(n);
                do {
                    SegInfo& s = cb.segs[segno];
                    s.numnewpasses = std::min<uint32_t>(s.maxpasses - s.numpasses, static_cast<uint32_t>(left));
                    const uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
                    if (bits > 32) broken("a code-block length field over 32 bits");
                    s.newlen = bio.read(bits);
                    left -= static_cast<int32_t>(s.numnewpasses);
                    if (left > 0) {
                        ++segno;
                        init_seg(cb, cblksty, false);
                    }
                } while (left > 0);
            }
        }
    }
    bio.inalign();
    const uint8_t* hcur = hstart + bio.numbytes();
    if (tcp.csty & 4) {  // EPH: OpenJPEG refuses a packet header without it
        const size_t used = static_cast<size_t>(hcur - hstart);
        if (hlen - std::min(hlen, used) < 2 || hcur[0] != 0xff || hcur[1] != 0x92)
            broken("a packet header without its EPH marker");
        hcur += 2;
    }
    const size_t header_len = static_cast<size_t>(hcur - hstart);
    if (hdr) {
        if (header_len > hdr->left) broken("packet headers past the end of their PPM or PPT segments");
        hdr->p += header_len;
        hdr->left -= header_len;
    } else {
        cur += header_len;
    }
    if (present) {
        for (uint32_t b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& prc = band.precs[precno];
            for (uint32_t k = 0; k < prc.cw * prc.ch; ++k) {
                Cblk& cb = prc.cblks[k];
                if (!cb.numnewpasses) continue;
                for (size_t segno = cb.first_new_seg; segno < cb.segs.size(); ++segno) {
                    SegInfo& s = cb.segs[segno];
                    if (cur > data_end || s.newlen > static_cast<size_t>(data_end - cur))
                        fail(ST_TRUNCATED, "truncated JPEG 2000: a code-block's data runs past its tile-part "
                                           "(OpenJPEG refuses it in strict mode)");
                    cb.data.insert(cb.data.end(), cur, cur + s.newlen);
                    cur += s.newlen;
                    s.numpasses += s.numnewpasses;
                    s.len += s.newlen;
                    s.numnewpasses = 0;
                    s.newlen = 0;
                }
                cb.numnewpasses = 0;
            }
        }
    }
    data = cur;
}

// ---------------------------------------------------------------------------
// Tier 1: the MQ decoder (mqc.c, T.800 Annex C) and the coding passes
// (t1.c, Annex D)
// ---------------------------------------------------------------------------

struct MqState {
    uint32_t qe;
    uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},
    {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0},
    {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0}, {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0}, {0x1c01, 25, 22, 0},
    {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0},
    {0x02a1, 36, 33, 0}, {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

struct Mqc {
    const uint8_t* bp = nullptr;
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t st[NUM_CTX], mps[NUM_CTX];

    void reset_states() {
        for (int i = 0; i < NUM_CTX; ++i) st[i] = mps[i] = 0;
        st[CTX_UNI] = 46;
        st[CTX_AGG] = 3;
        st[CTX_ZC] = 4;
    }
    // p holds len bytes and then 0xFF 0xFF (OpenJPEG's artificial marker)
    void init(const uint8_t* p, size_t len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : static_cast<uint32_t>(*bp) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                ++bp;
                c += static_cast<uint32_t>(*bp) << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += static_cast<uint32_t>(*bp) << 8;
            ct = 8;
        }
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    int decode(int ctx) {
        const MqState& s = kMq[st[ctx]];
        a -= s.qe;
        int d;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                a = s.qe;
                d = mps[ctx];
                st[ctx] = s.nmps;
            } else {
                a = s.qe;
                d = 1 - mps[ctx];
                if (s.sw) mps[ctx] ^= 1;
                st[ctx] = s.nlps;
            }
            renorm();
            return d;
        }
        c -= s.qe << 16;
        if ((a & 0x8000) == 0) {
            if (a < s.qe) {
                d = 1 - mps[ctx];
                if (s.sw) mps[ctx] ^= 1;
                st[ctx] = s.nlps;
            } else {
                d = mps[ctx];
                st[ctx] = s.nmps;
            }
            renorm();
            return d;
        }
        return mps[ctx];
    }
    // the BYPASS passes' raw bits (opj_mqc_raw_init_dec / opj_mqc_raw_decode)
    void raw_init(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return static_cast<int>((c >> ct) & 1);
    }
};

struct T1 {
    int w = 0, h = 0, stride = 0;
    std::vector<int32_t> data;
    std::vector<uint8_t> sig, neg, pi, mu;  // (w + 2) x (h + 2), a border of zeros
    Mqc mqc;
    int orient = 0;
    bool vsc = false;

    void reset(int cw, int ch) {
        w = cw;
        h = ch;
        stride = w + 2;
        data.assign(static_cast<size_t>(w) * h, 0);
        const size_t n = static_cast<size_t>(stride) * (h + 2);
        sig.assign(n, 0);
        neg.assign(n, 0);
        pi.assign(n, 0);
        mu.assign(n, 0);
    }
    size_t at(int y, int x) const { return static_cast<size_t>(y + 1) * stride + x + 1; }
    // the neighbour below is out of reach for the last row of a stripe in
    // vertically causal mode
    bool below(int y) const { return !(vsc && (y & 3) == 3); }

    int zc_ctx(int y, int x) const {
        const size_t i = at(y, x);
        int hh = sig[i - 1] + sig[i + 1];
        int vv = sig[i - stride];
        int dd = sig[i - stride - 1] + sig[i - stride + 1];
        if (below(y)) {
            vv += sig[i + stride];
            dd += sig[i + stride - 1] + sig[i + stride + 1];
        }
        if (orient == 3) {
            const int hv = hh + vv;
            if (dd == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
            if (dd == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
            if (dd == 2) return hv == 0 ? 6 : 7;
            return 8;
        }
        if (orient == 1) std::swap(hh, vv);  // HL: the vertical neighbours count first
        if (hh == 0) {
            if (vv == 0) return dd == 0 ? 0 : dd == 1 ? 1 : 2;
            return vv == 1 ? 3 : 4;
        }
        if (hh == 1) {
            if (vv == 0) return dd == 0 ? 5 : 6;
            return 7;
        }
        return 8;
    }
    bool any_neighbour(int y, int x) const {
        const size_t i = at(y, x);
        if (sig[i - 1] | sig[i + 1] | sig[i - stride] | sig[i - stride - 1] | sig[i - stride + 1]) return true;
        return below(y) && (sig[i + stride] | sig[i + stride - 1] | sig[i + stride + 1]);
    }
    // Table D.3: the sign context and the bit it is XORed with
    void sc_ctx(int y, int x, int* ctx, int* xorbit) const {
        const size_t i = at(y, x);
        auto contrib = [&](size_t j) { return sig[j] ? (neg[j] ? -1 : 1) : 0; };
        int hc = contrib(i - 1) + contrib(i + 1);
        int vc = contrib(i - stride) + (below(y) ? contrib(i + stride) : 0);
        hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
        vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
        static const int kCtx[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};  // [hc + 1][vc + 1] for hc >= 0, mirrored
        static const int kXor[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
        *ctx = kCtx[hc + 1][vc + 1];
        *xorbit = kXor[hc + 1][vc + 1];
    }
    void set_sig(int y, int x, int negative, int32_t value) {
        data[static_cast<size_t>(y) * w + x] = value;
        sig[at(y, x)] = 1;
        neg[at(y, x)] = static_cast<uint8_t>(negative);
    }

    void sigpass(int bpno, bool raw) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    const size_t i = at(y, x);
                    if (sig[i] || pi[i] || !any_neighbour(y, x)) continue;
                    if (raw) {
                        if (mqc.raw()) {
                            const int s = mqc.raw();
                            set_sig(y, x, s, s ? -oneplushalf : oneplushalf);
                        }
                    } else if (mqc.decode(zc_ctx(y, x))) {
                        int ctx, xb;
                        sc_ctx(y, x, &ctx, &xb);
                        const int s = mqc.decode(ctx) ^ xb;
                        set_sig(y, x, s, s ? -oneplushalf : oneplushalf);
                    }
                    pi[i] = 1;
                }
    }

    void refpass(int bpno, bool raw) {
        const int32_t poshalf = (1 << bpno) >> 1;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    const size_t i = at(y, x);
                    if (!sig[i] || pi[i]) continue;
                    int v;
                    if (raw) v = mqc.raw();
                    else v = mqc.decode(mu[i] ? CTX_MAG + 2 : any_neighbour(y, x) ? CTX_MAG + 1 : CTX_MAG);
                    int32_t& d = data[static_cast<size_t>(y) * w + x];
                    d += (v ^ (d < 0)) ? poshalf : -poshalf;
                    mu[i] = 1;
                }
    }

    void clnpass(int bpno, bool segsym) {
        const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        auto step = [&](int y, int x, bool known) {
            const size_t i = at(y, x);
            if (!known) {
                if (sig[i] || pi[i]) return;
                if (!mqc.decode(zc_ctx(y, x))) return;
            }
            int ctx, xb;
            sc_ctx(y, x, &ctx, &xb);
            const int s = mqc.decode(ctx) ^ xb;
            set_sig(y, x, s, s ? -oneplushalf : oneplushalf);
        };
        for (int k = 0; k < h; k += 4) {
            const bool full = k + 4 <= h;
            for (int x = 0; x < w; ++x) {
                bool run = full;
                for (int y = k; run && y < k + 4; ++y) {
                    const size_t i = at(y, x);
                    if (sig[i] || pi[i] || any_neighbour(y, x)) run = false;
                }
                if (run) {
                    if (mqc.decode(CTX_AGG)) {
                        int runlen = mqc.decode(CTX_UNI);
                        runlen = (runlen << 1) | mqc.decode(CTX_UNI);
                        step(k + runlen, x, true);
                        for (int y = k + runlen + 1; y < k + 4; ++y) {
                            if (!mqc.decode(zc_ctx(y, x))) continue;
                            int ctx, xb;
                            sc_ctx(y, x, &ctx, &xb);
                            const int s = mqc.decode(ctx) ^ xb;
                            set_sig(y, x, s, s ? -oneplushalf : oneplushalf);
                        }
                    }
                } else {
                    for (int y = k; y < std::min(k + 4, h); ++y) step(y, x, false);
                }
                for (int y = k; y < std::min(k + 4, h); ++y) pi[at(y, x)] = 0;
            }
        }
        if (segsym) {
            for (int i = 0; i < 4; ++i) mqc.decode(CTX_UNI);
        }
    }
};

// opj_t1_decode_cblk: the code-block's passes, segment by segment
void decode_cblk(T1& t1, const Cblk& cb, uint32_t orient, uint32_t roishift, uint32_t cblksty) {
    t1.reset(cb.x1 - cb.x0, cb.y1 - cb.y0);
    t1.orient = static_cast<int>(orient);
    t1.vsc = cblksty & CBLK_VSC;
    int32_t bpno_plus_one = static_cast<int32_t>(roishift + cb.numbps);
    if (bpno_plus_one >= 31) broken("a code-block of 31 or more bit-planes");
    int passtype = 2;
    t1.mqc.reset_states();
    std::vector<uint8_t> seg;
    size_t at = 0;
    for (const SegInfo& s : cb.segs) {
        // the segment's bytes and OpenJPEG's 0xFF 0xFF after them
        seg.assign(cb.data.begin() + static_cast<std::ptrdiff_t>(std::min(at, cb.data.size())),
                   cb.data.begin() + static_cast<std::ptrdiff_t>(std::min(at + s.len, cb.data.size())));
        seg.resize(s.len, 0);
        seg.push_back(0xff);
        seg.push_back(0xff);
        at += s.len;
        const bool raw = (cblksty & CBLK_LAZY) && bpno_plus_one <= static_cast<int32_t>(cb.numbps) - 4 && passtype < 2;
        if (raw) t1.mqc.raw_init(seg.data());
        else t1.mqc.init(seg.data(), s.len);
        for (uint32_t p = 0; p < s.numpasses && bpno_plus_one >= 1; ++p) {
            if (passtype == 0) t1.sigpass(bpno_plus_one, raw);
            else if (passtype == 1) t1.refpass(bpno_plus_one, raw);
            else t1.clnpass(bpno_plus_one, cblksty & CBLK_SEGSYM);
            if ((cblksty & CBLK_RESET) && !raw) t1.mqc.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                --bpno_plus_one;
            }
        }
    }
    if (roishift) {
        if (roishift >= 31) {
            std::fill(t1.data.begin(), t1.data.end(), 0);
        } else {
            const int32_t thresh = 1 << roishift;
            for (int32_t& v : t1.data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The inverse wavelets (dwt.c), one line at a time
// ---------------------------------------------------------------------------

// the interleaved line: lows at the even positions for cas 0, the odd for cas 1
template <typename T>
void interleave(const T* in, size_t in_stride, int sn, int dn, int cas, T* out) {
    for (int i = 0; i < sn; ++i) out[2 * i + cas] = in[static_cast<size_t>(i) * in_stride];
    for (int i = 0; i < dn; ++i) out[2 * i + 1 - cas] = in[static_cast<size_t>(sn + i) * in_stride];
}

void idwt53_line(int32_t* x, int n, int cas) {
    if (n == 1) {
        if (cas == 1) x[0] /= 2;
        return;
    }
    auto at = [&](int p) { return x[p < 0 ? -p : p >= n ? 2 * (n - 1) - p : p]; };
    for (int p = cas; p < n; p += 2)  // the lows
        x[p] = static_cast<int32_t>(static_cast<int64_t>(x[p]) - ((static_cast<int64_t>(at(p - 1)) + at(p + 1) + 2) >> 2));
    for (int p = 1 - cas; p < n; p += 2)  // the highs
        x[p] = static_cast<int32_t>(static_cast<int64_t>(x[p]) + ((static_cast<int64_t>(at(p - 1)) + at(p + 1)) >> 1));
}

constexpr float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f;
constexpr float kK = 1.230174105f, kTwoInvK = 1.625732422f;

void idwt97_line(float* x, int n, int sn, int dn, int cas) {
    if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
    const int a = cas, b = 1 - cas;
    for (int p = a; p < n; p += 2) x[p] *= kK;
    for (int p = b; p < n; p += 2) x[p] *= kTwoInvK;
    auto lift = [&](int first, float c) {
        for (int p = first; p < n; p += 2) {
            const float l = x[p - 1 < 0 ? p + 1 : p - 1];
            const float r = x[p + 1 >= n ? p - 1 : p + 1];
            x[p] = x[p] + (l + r) * c;
        }
    };
    lift(a, -kDelta);
    lift(b, -kGamma);
    lift(a, -kBeta);
    lift(b, -kAlpha);
}

template <typename T, typename F>
void idwt_2d(TileComp& tc, uint32_t numres, T* buf, F line) {
    const size_t w = tc.w();
    std::vector<T> tmp;
    for (uint32_t r = 1; r < numres; ++r) {
        const Resolution& lo = tc.res[r - 1];
        const Resolution& hi = tc.res[r];
        const int rw = hi.x1 - hi.x0, rh = hi.y1 - hi.y0;
        const int snh = lo.x1 - lo.x0, snv = lo.y1 - lo.y0;
        const int cash = hi.x0 & 1, casv = hi.y0 & 1;
        tmp.resize(static_cast<size_t>(std::max(rw, rh)) + 2);
        if (rw > 0)
            for (int j = 0; j < rh; ++j) {
                T* row = buf + static_cast<size_t>(j) * w;
                interleave(row, 1, snh, rw - snh, cash, tmp.data());
                line(tmp.data(), rw, snh, rw - snh, cash);
                std::copy(tmp.begin(), tmp.begin() + rw, row);
            }
        if (rh > 0)
            for (int i = 0; i < rw; ++i) {
                T* col = buf + i;
                interleave(col, w, snv, rh - snv, casv, tmp.data());
                line(tmp.data(), rh, snv, rh - snv, casv);
                for (int j = 0; j < rh; ++j) col[static_cast<size_t>(j) * w] = tmp[j];
            }
    }
}

// ---------------------------------------------------------------------------
// The packet iterator (pi.c) and a tile's decode (tcd.c)
// ---------------------------------------------------------------------------

struct PacketOrder {
    uint32_t numcomps, maxres, maxprec, numlayers;
    std::vector<uint8_t> include;
    size_t index(uint32_t l, uint32_t r, uint32_t c, uint32_t p) const {
        return ((static_cast<size_t>(l) * maxres + r) * numcomps + c) * maxprec + p;
    }
};

// every packet of one progression (a POC entry or the whole tile), in its
// order, each once across the tile (OpenJPEG's include array)
template <typename F>
void for_each_packet(const Tile& tile, const std::vector<CompInfo>& comps, PacketOrder& po, const Poc& poc,
                     uint32_t layno1, F visit) {
    auto take = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
        const size_t i = po.index(l, r, c, p);
        if (i >= po.include.size()) broken("a packet index past the packet iterator's table");
        if (po.include[i]) return;
        po.include[i] = 1;
        visit(c, r, p, l);
    };
    const uint32_t compno1 = std::min<uint32_t>(poc.compno1, po.numcomps);
    const uint32_t resno1 = std::min(poc.resno1, po.maxres);
    if (poc.compno0 >= po.numcomps || compno1 > po.numcomps) broken("a progression over components the image lacks");
    if (poc.prg == PRG_LRCP || poc.prg == PRG_RLCP) {
        auto inner = [&](uint32_t l, uint32_t r) {
            for (uint32_t c = poc.compno0; c < compno1; ++c) {
                const TileComp& tc = tile.comps[c];
                if (r >= tc.numres) continue;
                const Resolution& res = tc.res[r];
                for (uint32_t p = 0; p < res.pw * res.ph; ++p) take(l, r, c, p);
            }
        };
        if (poc.prg == PRG_LRCP) {
            for (uint32_t l = 0; l < layno1; ++l)
                for (uint32_t r = poc.resno0; r < resno1; ++r) inner(l, r);
        } else {
            for (uint32_t r = poc.resno0; r < resno1; ++r)
                for (uint32_t l = 0; l < layno1; ++l) inner(l, r);
        }
        return;
    }
    // the position-driven orders: steps of the smallest precinct on the reference grid
    auto steps = [&](uint32_t c0, uint32_t c1, uint64_t* dx, uint64_t* dy) {
        *dx = *dy = 0;
        for (uint32_t c = c0; c < c1; ++c) {
            const TileComp& tc = tile.comps[c];
            for (uint32_t r = 0; r < tc.numres; ++r) {
                const Resolution& res = tc.res[r];
                const uint32_t level = tc.numres - 1 - r;
                if (res.pdx + level < 32) {
                    const uint64_t d = static_cast<uint64_t>(comps[c].dx) << (res.pdx + level);
                    if (d <= UINT32_MAX) *dx = *dx ? std::min(*dx, d) : d;
                }
                if (res.pdy + level < 32) {
                    const uint64_t d = static_cast<uint64_t>(comps[c].dy) << (res.pdy + level);
                    if (d <= UINT32_MAX) *dy = *dy ? std::min(*dy, d) : d;
                }
            }
        }
    };
    const uint64_t tx0 = static_cast<uint64_t>(tile.x0), ty0 = static_cast<uint64_t>(tile.y0);
    const uint64_t tx1 = static_cast<uint64_t>(tile.x1), ty1 = static_cast<uint64_t>(tile.y1);
    // the precinct that starts at (x, y) of component c at resolution r, if one does (B.12.1.3)
    auto at_position = [&](uint32_t c, uint32_t r, uint64_t x, uint64_t y, uint32_t* precno) {
        const TileComp& tc = tile.comps[c];
        if (r >= tc.numres) return false;
        const Resolution& res = tc.res[r];
        const uint32_t level = tc.numres - 1 - r;
        const uint64_t cdx = comps[c].dx, cdy = comps[c].dy;
        if (level >= 32 || (cdx << level) > INT_MAX || (cdy << level) > INT_MAX) return false;
        const uint64_t trx0 = ceildiv(static_cast<int64_t>(tx0), static_cast<int64_t>(cdx << level));
        const uint64_t try0 = ceildiv(static_cast<int64_t>(ty0), static_cast<int64_t>(cdy << level));
        const uint64_t trx1 = ceildiv(static_cast<int64_t>(tx1), static_cast<int64_t>(cdx << level));
        const uint64_t try1 = ceildiv(static_cast<int64_t>(ty1), static_cast<int64_t>(cdy << level));
        const uint32_t rpx = res.pdx + level, rpy = res.pdy + level;
        if (rpx >= 31 || rpy >= 31) return false;
        if (!((y % (cdy << rpy) == 0) || (y == ty0 && ((try0 << level) % (uint64_t(1) << rpy))))) return false;
        if (!((x % (cdx << rpx) == 0) || (x == tx0 && ((trx0 << level) % (uint64_t(1) << rpx))))) return false;
        if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return false;
        const uint64_t prci = (ceildiv(static_cast<int64_t>(x), static_cast<int64_t>(cdx << level)) >> res.pdx) -
                              (trx0 >> res.pdx);
        const uint64_t prcj = (ceildiv(static_cast<int64_t>(y), static_cast<int64_t>(cdy << level)) >> res.pdy) -
                              (try0 >> res.pdy);
        *precno = static_cast<uint32_t>(prci + prcj * res.pw);
        return true;
    };
    uint64_t dx, dy;
    uint32_t precno;
    if (poc.prg == PRG_RPCL) {
        steps(0, po.numcomps, &dx, &dy);
        if (dx == 0 || dy == 0) return;
        for (uint32_t r = poc.resno0; r < resno1; ++r)
            for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (uint32_t c = poc.compno0; c < compno1; ++c)
                        if (at_position(c, r, x, y, &precno))
                            for (uint32_t l = 0; l < layno1; ++l) take(l, r, c, precno);
    } else if (poc.prg == PRG_PCRL) {
        steps(0, po.numcomps, &dx, &dy);
        if (dx == 0 || dy == 0) return;
        for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                for (uint32_t c = poc.compno0; c < compno1; ++c)
                    for (uint32_t r = poc.resno0; r < std::min<uint32_t>(resno1, tile.comps[c].numres); ++r)
                        if (at_position(c, r, x, y, &precno))
                            for (uint32_t l = 0; l < layno1; ++l) take(l, r, c, precno);
    } else if (poc.prg == PRG_CPRL) {
        for (uint32_t c = poc.compno0; c < compno1; ++c) {
            steps(c, c + 1, &dx, &dy);
            if (dx == 0 || dy == 0) return;
            for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
                for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                    for (uint32_t r = poc.resno0; r < std::min<uint32_t>(resno1, tile.comps[c].numres); ++r)
                        if (at_position(c, r, x, y, &precno))
                            for (uint32_t l = 0; l < layno1; ++l) take(l, r, c, precno);
        }
    } else {
        broken("an unknown progression order");
    }
}

// fn(i, t1) for i in [0, n) on up to 8 threads, each with its own tier-1
// state; the first failure is raised after every thread has stopped
template <typename F>
void parallel_for(size_t n, F fn) {
    const size_t threads = std::min<size_t>({n, 8, std::max(1u, std::thread::hardware_concurrency())});
    std::atomic<size_t> next(0);
    std::atomic<bool> failed(false);
    Fail first{0, ""};
    std::mutex lock;
    auto work = [&]() {
        T1 t1;
        for (size_t i; !failed && (i = next.fetch_add(1)) < n;) {
            try {
                fn(i, t1);
            } catch (const Fail& f) {
                std::lock_guard<std::mutex> g(lock);
                if (!failed.exchange(true)) first = f;
            } catch (const std::bad_alloc&) {
                std::lock_guard<std::mutex> g(lock);
                if (!failed.exchange(true)) first = Fail{ST_BROKEN, "out of memory"};
            }
        }
    };
    if (threads <= 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        for (size_t t = 1; t < threads; ++t) pool.emplace_back(work);
        work();
        for (auto& th : pool) th.join();
    }
    if (failed) throw first;
}

void decode_tile(Codestream& cs, uint32_t tileno, Tile& tile) {
    Tcp& tcp = cs.tcps[tileno];
    const Image& img = cs.img;
    init_tile(cs, tcp, tileno, tile);
    const uint32_t nc = static_cast<uint32_t>(img.comps.size());
    // tier 2
    PacketOrder po;
    po.numcomps = nc;
    po.maxres = 0;
    po.maxprec = 0;
    for (const TileComp& tc : tile.comps) {
        po.maxres = std::max(po.maxres, tc.numres);
        for (const Resolution& r : tc.res) po.maxprec = std::max(po.maxprec, r.pw * r.ph);
    }
    po.numlayers = tcp.numlayers;
    const size_t table = static_cast<size_t>(po.numlayers + 1) * po.maxres * nc * std::max<uint32_t>(po.maxprec, 1);
    if (table > (size_t(1) << 31)) broken("too many packets");
    po.include.assign(table, 0);
    HeaderSource hs{nullptr, 0}, *hdr = nullptr;
    std::vector<uint8_t> ppt;
    if (cs.ppm) {
        hs.p = cs.ppm_data.data() + cs.ppm_used;
        hs.left = cs.ppm_data.size() - cs.ppm_used;
        hdr = &hs;
    } else if (tcp.ppt) {
        for (const auto& part : tcp.ppt_parts) ppt.insert(ppt.end(), part.begin(), part.end());
        hs.p = ppt.data();
        hs.left = ppt.size();
        hdr = &hs;
    }
    const uint8_t* data = tcp.data.data();
    const uint8_t* end = data + tcp.data.size();
    if (cs.resno_decoded.size() != nc) cs.resno_decoded.assign(nc, 0);
    auto visit = [&](uint32_t c, uint32_t r, uint32_t p, uint32_t l) {
        read_packet(tcp, tile, c, r, p, l, data, end, hdr);
        cs.resno_decoded[c] = std::max(cs.resno_decoded[c], r);
    };
    if (tcp.has_poc) {
        for (const Poc& poc : tcp.pocs)  // an unknown order in a POC gives no packets
            if (poc.prg <= 4) for_each_packet(tile, img.comps, po, poc, poc.layno1, visit);
    } else {
        Poc all;
        all.compno1 = nc;
        all.resno1 = po.maxres;
        all.layno1 = tcp.numlayers;
        all.prg = tcp.prg;
        for_each_packet(tile, img.comps, po, all, tcp.numlayers, visit);
    }
    if (cs.ppm) cs.ppm_used = static_cast<size_t>(hs.p - cs.ppm_data.data());
    // tier 1 and dequantisation, into each component's buffer at its bands'
    // places: the code-blocks are independent, so they run on a few threads
    // (each with its own tier-1 state), as OpenJPEG's thread pool runs them
    struct Job {
        TileComp* tc;
        const Band* band;
        const Cblk* cb;
        size_t x0, y0;
        uint32_t roishift, cblksty;
        bool rev;
    };
    std::vector<Job> jobs;
    for (uint32_t c = 0; c < nc; ++c) {
        TileComp& tc = tile.comps[c];
        const Tccp& tcc = tcp.tccps[c];
        const bool rev = tcc.qmfbid == 1;
        if (rev) tc.idata.assign(tc.w() * tc.h(), 0);
        else tc.fdata.assign(tc.w() * tc.h(), 0.0f);
        for (uint32_t r = 0; r < tc.numres; ++r) {
            const Resolution& res = tc.res[r];
            for (uint32_t b = 0; b < res.numbands; ++b) {
                const Band& band = res.bands[b];
                if (band.empty()) continue;
                size_t xoff = 0, yoff = 0;
                if (band.bandno & 1) xoff = static_cast<size_t>(tc.res[r - 1].x1 - tc.res[r - 1].x0);
                if (band.bandno & 2) yoff = static_cast<size_t>(tc.res[r - 1].y1 - tc.res[r - 1].y0);
                for (const Precinct& prc : band.precs)
                    for (const Cblk& cb : prc.cblks)
                        if (cb.x1 > cb.x0 && cb.y1 > cb.y0)
                            jobs.push_back({&tc, &band, &cb, static_cast<size_t>(cb.x0 - band.x0) + xoff,
                                            static_cast<size_t>(cb.y0 - band.y0) + yoff,
                                            static_cast<uint32_t>(tcc.roishift), tcc.cblksty, rev});
            }
        }
    }
    auto run_t1 = [](const Job& jb, T1& t1) {
        decode_cblk(t1, *jb.cb, jb.band->bandno, jb.roishift, jb.cblksty);
        const size_t w = jb.tc->w();
        const float step = 0.5f * jb.band->stepsize;
        for (int y = 0; y < t1.h; ++y)
            for (int x = 0; x < t1.w; ++x) {
                const int32_t v = t1.data[static_cast<size_t>(y) * t1.w + x];
                const size_t at = (jb.y0 + y) * w + jb.x0 + x;
                if (jb.rev) jb.tc->idata[at] = v / 2;
                else jb.tc->fdata[at] = static_cast<float>(v) * step;
            }
    };
    parallel_for(jobs.size(), [&](size_t k, T1& t1) { run_t1(jobs[k], t1); });
    parallel_for(nc, [&](size_t c, T1&) {
        TileComp& tc = tile.comps[c];
        const uint32_t numres = std::min(cs.resno_decoded[c] + 1, tc.numres);
        if (tcp.tccps[c].qmfbid == 1)
            idwt_2d(tc, numres, tc.idata.data(), [](int32_t* x, int n, int, int, int cas) { idwt53_line(x, n, cas); });
        else
            idwt_2d(tc, numres, tc.fdata.data(), idwt97_line);
    });
    // the component transform (on the first three, of one size) and the DC level shift
    if (tcp.mct && nc >= 3) {
        const TileComp &c0 = tile.comps[0], &c1 = tile.comps[1], &c2 = tile.comps[2];
        if (c0.w() * c0.h() != c1.w() * c1.h() || c0.w() * c0.h() != c2.w() * c2.h())
            broken("a component transform over components of different sizes");
        const bool rev = tcp.tccps[0].qmfbid == 1;
        if (tcp.tccps[1].qmfbid != tcp.tccps[0].qmfbid || tcp.tccps[2].qmfbid != tcp.tccps[0].qmfbid)
            fail(ST_REFUSED, "JPEG 2000 with a component transform over components of different wavelets is not "
                             "supported by the port's codec");
        const size_t n = c0.w() * c0.h();
        if (rev) {
            int32_t *y = tile.comps[0].idata.data(), *u = tile.comps[1].idata.data(), *v = tile.comps[2].idata.data();
            for (size_t i = 0; i < n; ++i) {
                const int32_t g = y[i] - ((u[i] + v[i]) >> 2);
                const int32_t r = v[i] + g, b = u[i] + g;
                y[i] = r;
                u[i] = g;
                v[i] = b;
            }
        } else {
            float *y = tile.comps[0].fdata.data(), *u = tile.comps[1].fdata.data(), *v = tile.comps[2].fdata.data();
            for (size_t i = 0; i < n; ++i) {
                const float yy = y[i], uu = u[i], vv = v[i];
                const float r = yy + (vv * 1.402f);
                const float g = yy - (uu * 0.34413f) - (vv * (0.71414f));
                const float b = yy + (uu * 1.772f);
                y[i] = r;
                u[i] = g;
                v[i] = b;
            }
        }
    }
    for (uint32_t c = 0; c < nc; ++c) {
        TileComp& tc = tile.comps[c];
        const CompInfo& ci = img.comps[c];
        const int32_t shift = ci.sgnd ? 0 : static_cast<int32_t>(1u << (ci.prec - 1));
        const int64_t lo = ci.sgnd ? -(int64_t(1) << (ci.prec - 1)) : 0;
        const int64_t hi = ci.sgnd ? (int64_t(1) << (ci.prec - 1)) - 1 : static_cast<int64_t>((1ull << ci.prec) - 1);
        if (tcp.tccps[c].qmfbid == 1) {
            for (int32_t& v : tc.idata) v = static_cast<int32_t>(std::min(std::max(int64_t(v) + shift, lo), hi));
        } else {
            tc.idata.resize(tc.fdata.size());
            for (size_t i = 0; i < tc.fdata.size(); ++i) {
                const float f = tc.fdata[i];
                int64_t v;
                if (f > static_cast<float>(INT_MAX)) v = hi;
                else if (f < static_cast<float>(INT_MIN)) v = lo;
                else v = std::min(std::max(static_cast<int64_t>(std::lrintf(f)) + shift, lo), hi);
                tc.idata[i] = static_cast<int32_t>(v);
            }
            std::vector<float>().swap(tc.fdata);
        }
    }
}

// ---------------------------------------------------------------------------
// The codestream's headers (j2k.c opj_j2k_read_header, opj_j2k_read_tile_header)
// ---------------------------------------------------------------------------

// OpenJPEG's marker handler table (j2k_memory_marker_handler_tab): where each
// marker may stand, 1 the main header, 2 a tile-part header; 3 for a marker it
// does not know (read as unknown in the main header, refused in a tile-part's)
bool known_marker(uint32_t m) {
    switch (m) {
        case 0xff90: case 0xff52: case 0xff53: case 0xff5e: case 0xff5c: case 0xff5d: case 0xff5f: case 0xff51:
        case 0xff55: case 0xff57: case 0xff58: case 0xff60: case 0xff61: case 0xff91: case 0xff63: case 0xff64:
        case 0xff74: case 0xff78: case 0xff50: case 0xff59: case 0xff75: case 0xff77:
            return true;
        default:
            return false;
    }
}

int marker_states(uint32_t m) {
    switch (m) {
        case 0xff90: return 1;  // SOT ends the main header
        case 0xff52: case 0xff53: case 0xff5e: case 0xff5c: case 0xff5d: case 0xff5f: case 0xff64: case 0xff74:
        case 0xff75: case 0xff77:
            return 3;
        case 0xff55: case 0xff57: case 0xff60: case 0xff63: case 0xff78: case 0xff50: case 0xff59: return 1;
        case 0xff58: case 0xff61: return 2;
        case 0xff51: case 0xff91: return 0x10;  // SIZ only first, SOP nowhere in a header
        default: return known_marker(m) ? 3 : 0;
    }
}

std::vector<uint32_t> decode(const uint8_t* d, size_t n, long long max_pixels) {
    Codestream cs;
    Stream s{d, n};
    if (s.u16() != 0xff4f) broken("no SOC marker");
    if (s.u16() != 0xff51) broken("no SIZ marker after SOC");
    auto segment = [&]() {
        const uint32_t len = s.u16();
        if (len < 2) broken("a marker segment of length under 2");
        if (s.left() < len - 2) fail(ST_TRUNCATED, "truncated JPEG 2000: a marker segment runs past the end");
        Seg seg{s.d + s.pos, len - 2};
        s.pos += len - 2;
        return seg;
    };
    {
        Seg siz = segment();
        cs.read_siz(siz, max_pixels);
    }
    // the main header, to the first SOT (opj_j2k_read_header_procedure): an
    // unknown marker makes OpenJPEG scan on, two bytes at a time, to the next
    // marker it knows; a known marker out of its place fails
    uint32_t marker = s.u16();
    for (;;) {
        if (marker == 0xff90) break;
        if (marker < 0xff00) broken("a byte other than a marker in the main header");
        int where = marker_states(marker);
        if (where == 0) {
            for (;;) {
                marker = s.u16();
                if (marker < 0xff00) continue;
                where = marker_states(marker);
                if (!(where & 1)) broken("a marker out of its place in the main header");
                if (where != 3 || known_marker(marker)) break;
            }
            if (marker == 0xff90) break;
        }
        if (!(where & 1)) broken("a marker out of its place in the main header");
        Seg seg = segment();
        switch (marker) {
            case 0xff52: cs.read_cod(seg, cs.def); cs.have_cod = true; break;
            case 0xff53: cs.read_coc(seg, cs.def); break;
            case 0xff5c: cs.read_qcd(seg, cs.def); cs.have_qcd = true; break;
            case 0xff5d: cs.read_qcc(seg, cs.def); break;
            case 0xff5e: cs.read_rgn(seg, cs.def); break;
            case 0xff5f: cs.read_poc(seg, cs.def); break;
            case 0xff60: cs.ppm = true; Codestream::read_ppx(seg, cs.ppm_parts, "PPM"); break;
            default: break;  // TLM, PLM, CRG, COM and Part 2 and 15 markers: nothing the decode reads
        }
        marker = s.u16();
    }
    if (!cs.have_cod) broken("no COD marker in the main header");
    if (!cs.have_qcd) broken("no QCD marker in the main header");
    if (cs.ppm) {  // opj_j2k_merge_ppm: the Ippm of every Nppm, concatenated
        uint32_t remaining = 0;
        for (const auto& part : cs.ppm_parts) {
            size_t at = 0;
            if (remaining >= part.size()) {
                remaining -= static_cast<uint32_t>(part.size());
                cs.ppm_data.insert(cs.ppm_data.end(), part.begin(), part.end());
                continue;
            }
            cs.ppm_data.insert(cs.ppm_data.end(), part.begin(), part.begin() + remaining);
            at = remaining;
            remaining = 0;
            while (at < part.size()) {
                if (part.size() - at < 4) broken("a PPM segment without room for its Nppm");
                const uint32_t nppm = (uint32_t(part[at]) << 24) | (uint32_t(part[at + 1]) << 16) |
                                      (uint32_t(part[at + 2]) << 8) | part[at + 3];
                at += 4;
                const size_t take = std::min<size_t>(nppm, part.size() - at);
                cs.ppm_data.insert(cs.ppm_data.end(), part.begin() + at, part.begin() + at + take);
                at += take;
                remaining = static_cast<uint32_t>(nppm - take);
            }
        }
        if (remaining) broken("PPM segments shorter than their Nppm");
    }
    const uint32_t numtiles = cs.img.tw * cs.img.th;
    cs.tcps.assign(numtiles, cs.def);
    std::vector<uint32_t> order;  // the tiles in the order their data first came
    // tile-parts; where the stream ends right after a marker of a tile-part's
    // header (OpenJPEG's NEOC state), OpenJPEG stops with the tiles it has
    // decoded, or fails where a tile read only in part is still to decode
    auto neoc = [&]() {
        for (const Tcp& t : cs.tcps)
            if (t.has_data && t.parts_seen != t.parts_total)
                broken("the codestream ends inside a tile-part header while a tile is read only in part");
    };
    while (marker == 0xff90) {
        const size_t sot_at = s.pos - 2;
        if (s.left() == 0) {
            neoc();
            break;
        }
        Seg sot = segment();
        if (sot.n != 8) broken("an SOT segment of the wrong length");
        const uint32_t tileno = sot.get(2), psot = sot.get(4), tpsot = sot.get(1), tnsot = sot.get(1);
        if (psot != 0 && psot < 14 && psot != 12) broken("a tile-part length under 14");
        if (tileno >= numtiles) broken("a tile-part of a tile the image lacks");
        Tcp& tcp = cs.tcps[tileno];
        if (tcp.parts_total && tpsot >= static_cast<uint32_t>(tcp.parts_total)) broken("a tile-part index past the tile's count");
        if (tnsot) {
            if (tpsot >= tnsot) broken("a tile-part index past its count");
            tcp.parts_total = static_cast<int>(tnsot);
        }
        bool ended = false;
        for (;;) {
            marker = s.u16();
            if (marker == 0xff93) break;
            if (s.left() == 0) {
                ended = true;
                break;
            }
            if (marker < 0xff00) broken("a byte other than a marker in a tile-part header");
            if (!known_marker(marker) || !(marker_states(marker) & 2))
                broken("an unknown marker, or one out of its place, in a tile-part header");
            Seg seg = segment();
            switch (marker) {
                case 0xff52: cs.read_cod(seg, tcp); break;
                case 0xff53: cs.read_coc(seg, tcp); break;
                case 0xff5c: cs.read_qcd(seg, tcp); break;
                case 0xff5d: cs.read_qcc(seg, tcp); break;
                case 0xff5e: cs.read_rgn(seg, tcp); break;
                case 0xff5f: cs.read_poc(seg, tcp); break;
                case 0xff61:
                    if (cs.ppm) broken("a PPT where the main header has a PPM");
                    tcp.ppt = true;
                    Codestream::read_ppx(seg, tcp.ppt_parts, "PPT");
                    break;
                case 0xff90: case 0xffd9: case 0xff51: broken("a tile-part header without SOD");
                default: break;  // PLT, COM and markers OpenJPEG skips
            }
        }
        if (ended) {
            neoc();
            break;
        }
        size_t len;
        if (psot == 0) {  // the last tile-part: to the end, less the EOC
            if (s.left() < 2) fail(ST_TRUNCATED, "truncated JPEG 2000: the last tile-part ends early");
            len = s.left() - 2;
        } else {
            const size_t header = s.pos - sot_at;
            if (psot < header) broken("a tile-part length shorter than its header");
            len = psot - header;
            if (len > s.left())
                fail(ST_TRUNCATED, "truncated JPEG 2000: a tile-part runs past the end of the codestream (OpenJPEG "
                                   "refuses it in strict mode)");
        }
        if (!tcp.has_data) order.push_back(tileno);
        tcp.has_data = true;
        tcp.data.insert(tcp.data.end(), s.d + s.pos, s.d + s.pos + len);
        s.pos += len;
        ++tcp.parts_seen;
        // the next marker: OpenJPEG's read of the tile after refuses a stream
        // that ends here, or goes on with anything but SOT or EOC
        if (s.left() < 2) broken("the codestream ends without a marker after a tile-part");
        marker = s.u16();
        if (marker != 0xff90 && marker != 0xffd9) broken("a marker other than SOT or EOC after a tile-part");
    }
    // decode each tile that has data, in the order its data came
    std::vector<uint32_t> out;
    const Image& img = cs.img;
    out.push_back(img.x0);
    out.push_back(img.y0);
    out.push_back(img.x1);
    out.push_back(img.y1);
    out.push_back(static_cast<uint32_t>(img.comps.size()));
    for (const CompInfo& c : img.comps) {
        out.push_back(c.dx);
        out.push_back(c.dy);
        out.push_back(c.prec);
        out.push_back(c.sgnd);
    }
    out.push_back(static_cast<uint32_t>(order.size()));
    for (uint32_t tileno : order) {
        Tile tile;
        decode_tile(cs, tileno, tile);
        out.push_back(tileno);
        out.push_back(static_cast<uint32_t>(tile.x0));
        out.push_back(static_cast<uint32_t>(tile.y0));
        out.push_back(static_cast<uint32_t>(tile.x1));
        out.push_back(static_cast<uint32_t>(tile.y1));
        // each component at its resno_decoded (opj_tcd_update_tile_data): the
        // top-left corner of the tile's buffer, packed
        for (size_t c = 0; c < tile.comps.size(); ++c) {
            const TileComp& tc = tile.comps[c];
            const Resolution& res = tc.res[std::min(cs.resno_decoded[c], tc.numres - 1)];
            const size_t rw = static_cast<size_t>(res.x1 - res.x0), rh = static_cast<size_t>(res.y1 - res.y0);
            out.push_back(static_cast<uint32_t>(rw));
            out.push_back(static_cast<uint32_t>(rh));
            for (size_t y = 0; y < rh; ++y)
                for (size_t x = 0; x < rw; ++x) out.push_back(static_cast<uint32_t>(tc.idata[y * tc.w() + x]));
        }
    }
    return out;
}

}  // namespace

extern "C" int mmtrs_jp2_decode(const void* buf, long long n, long long max_pixels, void* out, void* out_len,
                                void* msg) {
    void** dst = static_cast<void**>(out);
    long long* len = static_cast<long long*>(out_len);
    char* text = static_cast<char*>(msg);
    *dst = nullptr;
    *len = 0;
    text[0] = 0;
    try {
        std::vector<uint32_t> words = decode(static_cast<const uint8_t*>(buf), n > 0 ? static_cast<size_t>(n) : 0,
                                             max_pixels);
        void* mem = std::malloc(words.size() * sizeof(uint32_t));
        if (!mem) {
            std::snprintf(text, 256, "out of memory");
            return ST_BROKEN;
        }
        std::memcpy(mem, words.data(), words.size() * sizeof(uint32_t));
        *dst = mem;
        *len = static_cast<long long>(words.size());
        return 0;
    } catch (const Fail& f) {
        std::snprintf(text, 256, "%s", f.what.c_str());
        return f.status;
    } catch (const std::bad_alloc&) {
        std::snprintf(text, 256, "out of memory");
        return ST_BROKEN;
    }
}

extern "C" int mmtrs_jp2_free(void* p) {
    std::free(p);
    return 0;
}
