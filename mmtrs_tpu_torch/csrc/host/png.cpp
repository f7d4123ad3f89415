// PNG row unfilter for utils/codec.py: the five filter types of the PNG
// specification (section 9), applied in scan order.
//
// Python inflates the IDAT stream with zlib and hands the filtered rows
// here: Sub, Average and Paeth depend on the byte just decoded to their
// left, which is a sequential loop per row that numpy cannot express.
//
// C API (ctypes, plain C, no dependencies):
//   int mmtrs_png_unfilter(const void* src, int rows, long long stride,
//                          int bpp, void* dst);
//     src: rows x (1 + stride) bytes, each row led by its filter type;
//     dst: rows x stride bytes; bpp: bytes per whole pixel (at least 1).
//     Returns 0, or 1 + the index of the first row whose filter type is
//     not 0..4.
//
// Build: g++ -O3 -fPIC -shared png.cpp (see mmtrs_tpu_torch/_build.py)

#include <cstdlib>
#include <cstring>

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
