// The sequential loops of utils/codec.py's host decoders, each a loop over
// bytes whose every step depends on the one before, which numpy cannot
// express: the PNG row unfilter (the five filter types of the PNG
// specification, section 9), LZW (GIF's and TIFF's variants), TIFF's
// PackBits, and BMP's RLE8/RLE4 as Pillow's BmpRleDecoder reads them.
//
// C API (ctypes, plain C, no dependencies):
//   int mmtrs_png_unfilter(const void* src, int rows, long long stride,
//                          int bpp, void* dst);
//     src: rows x (1 + stride) bytes, each row led by its filter type;
//     dst: rows x stride bytes; bpp: bytes per whole pixel (at least 1).
//     Returns 0, or 1 + the index of the first row whose filter type is
//     not 0..4.
//   int mmtrs_lzw_decode(const void* src, long long n, int min_bits,
//                        int tiff, void* dst, long long cap, void* out_len);
//     GIF (tiff 0): codes packed from the low bit, min_bits + 1 bits wide
//     at the start, clear = 1 << min_bits, end = clear + 1, a code grows
//     when the table reaches 1 << width. TIFF (tiff 1, min_bits 8): codes
//     packed from the high bit, 9 bits at the start, clear 256, end 257,
//     a code grows one entry early. Writes at most ``cap`` bytes;
//     out_len: long long[1] <- bytes written. 0 ok (the stream ended, at
//     its end code or its last byte), 2 a code not yet in the table.
//   int mmtrs_packbits(const void* src, long long n, void* dst,
//                      long long cap, void* out_len);
//     0 ok, out_len <- bytes written (at most cap).
//   int mmtrs_bmp_rle(const void* src, long long n, int rle4, int odd_start,
//                     int width, int height, void* dst);
//     dst: width x height indices (zeroed first) in file order (the first
//     row decoded is the bottom row). Pillow's reading, quirks kept: a
//     delta escape skips two bytes and takes (right, up) from the next
//     two, an RLE4 absolute run of n reads n / 2 bytes (n - 1 pixels for
//     odd n) but advances x by n, and runs are word-aligned by the file
//     offset (odd_start: the pixel data begins at an odd one). Returns 0.
//
// Build: g++ -O3 -fPIC -shared png.cpp (see mmtrs_tpu_torch/_build.py)

#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline unsigned char paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<unsigned char>(a);
    if (pb <= pc) return static_cast<unsigned char>(b);
    return static_cast<unsigned char>(c);
}

}  // namespace

extern "C" int mmtrs_png_unfilter(const void* src, int rows, long long stride, int bpp, void* dst) {
    const unsigned char* in = static_cast<const unsigned char*>(src);
    unsigned char* out = static_cast<unsigned char*>(dst);
    const unsigned char* prev = nullptr;  // the row above, unfiltered; none for row 0
    for (int y = 0; y < rows; ++y) {
        const unsigned char* f = in + static_cast<size_t>(y) * (stride + 1);
        const int type = f[0];
        const unsigned char* r = f + 1;
        unsigned char* o = out + static_cast<size_t>(y) * stride;
        switch (type) {
            case 0:
                std::memcpy(o, r, static_cast<size_t>(stride));
                break;
            case 1:
                for (long long x = 0; x < stride; ++x)
                    o[x] = static_cast<unsigned char>(r[x] + (x >= bpp ? o[x - bpp] : 0));
                break;
            case 2:
                for (long long x = 0; x < stride; ++x)
                    o[x] = static_cast<unsigned char>(r[x] + (prev ? prev[x] : 0));
                break;
            case 3:
                for (long long x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? o[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    o[x] = static_cast<unsigned char>(r[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (long long x = 0; x < stride; ++x) {
                    const int a = x >= bpp ? o[x - bpp] : 0;
                    const int b = prev ? prev[x] : 0;
                    const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    o[x] = static_cast<unsigned char>(r[x] + paeth(a, b, c));
                }
                break;
            default:
                return 1 + y;
        }
        prev = o;
    }
    return 0;
}

extern "C" int mmtrs_lzw_decode(const void* src, long long n, int min_bits, int tiff, void* dst, long long cap,
                                void* out_len) {
    const unsigned char* in = static_cast<const unsigned char*>(src);
    unsigned char* out = static_cast<unsigned char*>(dst);
    long long* len = static_cast<long long*>(out_len);
    const int clear = 1 << min_bits, end = clear + 1;
    // the table: each entry is its prefix code and its last byte; strings
    // are written back to front from the chain
    std::vector<int> prefix(4096, -1);
    std::vector<unsigned char> suffix(4096), first(4096);
    std::vector<int> length(4096, 0);
    for (int i = 0; i < clear; ++i) {
        suffix[i] = first[i] = static_cast<unsigned char>(i);
        length[i] = 1;
    }
    int width = min_bits + 1, next = end + 1, prev = -1;
    long long o = 0, bitpos = 0;
    const long long total_bits = n * 8;
    int status = 0;
    while (bitpos + width <= total_bits) {
        int code = 0;
        if (tiff) {
            for (int b = 0; b < width; ++b, ++bitpos)
                code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
        } else {
            for (int b = 0; b < width; ++b, ++bitpos) code |= ((in[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
        }
        if (code == clear) {
            width = min_bits + 1;
            next = end + 1;
            prev = -1;
            continue;
        }
        if (code == end) break;
        int emit;  // the code whose string is written
        if (prev < 0) {
            if (code >= clear) {
                status = 2;
                break;
            }
            emit = code;
        } else {
            if (code > next || (code == next && next >= 4096)) {
                status = 2;
                break;
            }
            if (next < 4096) {  // the new entry: prev's string + the first byte of code's
                prefix[next] = prev;
                suffix[next] = code < next ? first[code] : first[prev];
                first[next] = first[prev];
                length[next] = length[prev] + 1;
                ++next;
            }
            emit = code;
        }
        const int l = length[emit];
        long long at = o + l - 1;
        for (int c = emit; c >= 0; c = prefix[c], --at)
            if (at < cap) out[at] = suffix[c];
        o += l;
        prev = code;
        const int grow = tiff ? next + 1 : next;
        if (grow >= (1 << width) && width < 12) ++width;
    }
    *len = o < cap ? o : cap;
    return status;
}

extern "C" int mmtrs_packbits(const void* src, long long n, void* dst, long long cap, void* out_len) {
    const signed char* in = static_cast<const signed char*>(src);
    unsigned char* out = static_cast<unsigned char*>(dst);
    long long i = 0, o = 0;
    while (i < n && o < cap) {
        const int h = in[i++];
        if (h >= 0) {
            if (i + h + 1 > n) break;  // a literal the data cannot hold: libtiff stops before it
            for (int k = 0; k <= h; ++k, ++i)
                if (o < cap) out[o++] = static_cast<unsigned char>(in[i]);
        } else if (h != -128) {
            if (i >= n) break;
            const unsigned char v = static_cast<unsigned char>(in[i++]);
            for (int k = 0; k < 1 - h && o < cap; ++k) out[o++] = v;
        }
    }
    *static_cast<long long*>(out_len) = o;
    return 0;
}

extern "C" int mmtrs_bmp_rle(const void* src, long long n, int rle4, int odd_start, int width, int height,
                             void* dst) {
    const unsigned char* in = static_cast<const unsigned char*>(src);
    unsigned char* out = static_cast<unsigned char*>(dst);
    const long long total = static_cast<long long>(width) * height;
    std::memset(out, 0, static_cast<size_t>(total));
    long long d = 0, i = 0, x = 0;  // data length, input position, Pillow's x
    auto put = [&](unsigned char v) {
        if (d < total) out[d] = v;
        ++d;
    };
    while (d < total) {
        if (i + 2 > n) break;
        const int num = in[i], byte = in[i + 1];
        i += 2;
        if (num) {  // encoded run, cut at the row's end
            long long cnt = num;
            if (x + cnt > width) cnt = width - x > 0 ? width - x : 0;
            for (long long k = 0; k < cnt; ++k) put(rle4 ? (k % 2 == 0 ? byte >> 4 : byte & 15) : byte);
            x += cnt;
        } else if (byte == 0) {  // end of line
            while (d % width != 0) put(0);
            x = 0;
        } else if (byte == 1) {  // end of bitmap
            break;
        } else if (byte == 2) {  // delta, as Pillow reads it: two bytes skipped, then right and up
            if (i + 2 > n) break;
            i += 2;
            if (i + 2 > n) break;
            const int right = in[i], up = in[i + 1];
            i += 2;
            for (long long k = 0; k < right + static_cast<long long>(up) * width; ++k) put(0);
            x = d % width;
        } else {  // absolute run
            const long long want = rle4 ? byte / 2 : byte;
            const long long got = want < n - i ? want : n - i;
            for (long long k = 0; k < got; ++k) {
                const int v = in[i + k];
                if (rle4) {
                    put(v >> 4);
                    put(v & 15);
                } else {
                    put(v);
                }
            }
            i += got;
            if (got < want) break;
            x += byte;
            if ((i + odd_start) % 2 != 0) ++i;  // word alignment by the file offset
        }
    }
    return 0;
}
