"""Build the package's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -fmad=false -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -shared -o build/mmtrs_tpu_torch/libmmtrs_kernels_<hash>.so *.o

``-fmad=false`` keeps every multiply and add a separately rounded f32 step,
as the plain PyTorch versions (one op per kernel) and the JAX reference
compute them: the LAB quantiser sits on rounding boundaries where a fused
multiply-add moves a pixel by a level, which the CLAHE LUT then amplifies.
There is no ``--use_fast_math`` for the same reason.

The library lands in ``build/mmtrs_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, and is built at the first call of
:func:`library` — never at import. Without a CUDA device or ``nvcc`` that
call raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mmtrs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points (csrc/*.cu): each returns the cudaGetLastError() code of
# its launch; every pointer and the stream are c_void_p so none is cut to 32 bits
_SIGNATURES = {
    "mmtrs_clahe_lab_fwd_lut": (_P, _P, _P, _P, _P),
    "mmtrs_clahe_apply_lab_bwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmtrs_clahe_hist_lut": (_P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "mmtrs_clahe_apply": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmtrs_shift_rows": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmtrs_shift_rows_windowed": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "mmtrs_resample_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "mmtrs_photometric": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "mmtrs_scatter_rows": (_P, _P, _P, _L, _L, _L, _P),
}


# C entry points of the codec's host libraries (csrc/host/*.cpp); each
# returns a status, and a pointer or a 64-bit length is never cut to a C int
_HOST_SIGNATURES = {
    "mmtrs_png_unfilter": (_P, _I, _L, _I, _P),
    "mmtrs_lzw_decode": (_P, _L, _I, _I, _P, _L, _P),
    "mmtrs_packbits": (_P, _L, _P, _L, _P),
    "mmtrs_bmp_rle": (_P, _L, _I, _I, _I, _I, _P),
    "mmtrs_jpeg_info": (_P, _L, _P),
    "mmtrs_jpeg_decode": (_P, _L, _P, _I, _I),
    "mmtrs_jpeg_decode_paths": (_P, _I, _I, _I, _P, _P, _P, _P, _L, _P),
    "mmtrs_jpeg_decode_tiff": (_P, _L, _P, _I, _I, _I, _I),
    "mmtrs_jpeg_encode": (_P, _I, _I, _I, _P, _P),
    "mmtrs_codec_free": (_P,),
    "mmtrs_nvjpeg_info": (_P, _L, _P),
    "mmtrs_nvjpeg_decode": (_P, _L, _P, _I, _I, _I, _P),
    "mmtrs_nvjpeg_decode_planes": (_P, _L, _P, _P),
    "mmtrs_nvjpeg_encode": (_P, _I, _I, _I, _P, _P, _P),
    "mmtrs_nvjpeg_free": (_P,),
    "mmtrs_jpeg_own_decode": (_P, _L, _L, _P, _P, _P),
    "mmtrs_jpeg_own_decode_as": (_P, _L, _L, _I, _P, _P, _P),
    "mmtrs_jpeg_own_free": (_P,),
    "mmtrs_jpeg_own_takes_sof2": (_P, _L),
    "mmtrs_jpeg_own_decode_raw": (_P, _L, _L, _P, _P, _P),
    "mmtrs_jp2_decode": (_P, _L, _L, _P, _P, _P),
    "mmtrs_jp2_free": (_P,),
    "mmtrs_av1_decode": (_P, _L, _L, _P, _P, _P),
    "mmtrs_av1_free": (_P,),
    "mmtrs_avif_scale_plane": (_P, _I, _I, _P, _I, _I),
    "mmtrs_webp_vp8_decode": (_P, _L, _I, _I, _P),
    "mmtrs_webp_vp8l_decode": (_P, _L, _I, _I, _P),
    "mmtrs_webp_alpha_check": (_P, _L, _I, _I),
    "mmtrs_tga_rle": (_P, _L, _I, _L, _P, _L, _P),
    "mmtrs_sun_rle": (_P, _L, _P, _L, _P),
    "mmtrs_pcx_rle": (_P, _L, _L, _I, _P, _P),
    "mmtrs_sgi_rle": (_P, _L, _I, _I, _I, _I, _P),
    "mmtrs_qoi_decode": (_P, _L, _I, _I, _I, _P),
    "mmtrs_bcn_decode": (_P, _L, _I, _I, _I, _I, _P),
    "mmtrs_ccitt_decode": (_P, _L, _I, _I, _I, _I, _P, _P),
    "mmtrs_packbits_rows": (_P, _L, _L, _I, _P, _P),
    "mmtrs_fli_frame": (_P, _L, _I, _I, _P),
    "mmtrs_pcd_decode": (_P, _L, _P),
    "mmtrs_lab_to_rgb": (_P, _L, _P),
}
HOST_CSRC = CSRC / "host"
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")  # g++; nvcc passes -fPIC on with -Xcompiler


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "mmtrs_tpu_torch CUDA kernels need nvcc (not on PATH nor under "
        f"{cuda_home}/bin); the port has no CPU fallback for CUDA tensors"
    )


def _check_nvcc(cmd: list[str], code: int, log: str) -> None:
    if code != 0:
        raise RuntimeError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n{log}")


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mmtrs_tpu_torch CUDA kernels need a CUDA device; none is visible"
        )
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    out = BUILD_DIR / f"libmmtrs_kernels_{_source_hash(sources + headers)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        objs = [BUILD_DIR / f"{src.stem}.{os.getpid()}.o" for src in sources]
        t0 = time.perf_counter()
        try:
            cmds = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(sources, objs)]
            procs = [
                subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for c in cmds
            ]
            logs = [p.communicate()[0] for p in procs]  # wait for all before raising
            for cmd, proc, log in zip(cmds, procs, logs):
                _check_nvcc(cmd, proc.returncode, log)
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            _check_nvcc(link, res.returncode, res.stdout + res.stderr)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, out)
        library.build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


library.build_seconds = 0.0  # seconds the last nvcc run took (0: cached)


def _build_host(name: str, source: str, compiler: list[str], libs: tuple[str, ...],
                headers: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``csrc/host/<source>`` with ``compiler`` (the program and its
    flags) into ``build/.../lib<name>_<hash>.so`` once per hash of the source
    and the ``headers`` it includes, load it and bind its ``_HOST_SIGNATURES``."""
    src = HOST_CSRC / source
    h = hashlib.sha256(" ".join((*compiler[1:], *libs)).encode())
    for path in (src, *(HOST_CSRC / hdr for hdr in headers)):
        h.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*compiler, str(src), "-o", str(tmp), *libs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {source} failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for fn_name, argtypes in _HOST_SIGNATURES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("the image codec's host code needs g++, which is not on PATH")
    return found


def _find_header(header: str, dirs: list[Path]) -> None:
    if not any((d / header).exists() for d in dirs):
        raise RuntimeError(f"{header} not found under {', '.join(map(str, dirs))}")


@functools.cache
def png_library() -> ctypes.CDLL:
    """The host decoders' sequential loops (``csrc/host/png.cpp``: PNG's
    row unfilter, LZW, PackBits, BMP RLE); needs only g++."""
    return _build_host("mmtrs_png", "png.cpp", [_gxx(), *HOST_FLAGS], ())


@functools.cache
def webp_library() -> ctypes.CDLL:
    """The WebP decoders (``csrc/host/webp.cpp``: VP8 and VP8L, with the
    tables of ``webp_tables.h``); needs only g++."""
    return _build_host("mmtrs_webp", "webp.cpp", [_gxx(), *HOST_FLAGS], (), ("webp_tables.h",))


@functools.cache
def jpeg_own_library() -> ctypes.CDLL:
    """The port's own JPEG decoder (``csrc/host/jpeg.cpp``: lossless,
    arithmetic-coded and smoothed Huffman progressive frames, on either
    device's route); needs only g++ and links nothing."""
    return _build_host("mmtrs_jpeg_own", "jpeg.cpp", [_gxx(), *HOST_FLAGS], ())


@functools.cache
def jp2_library() -> ctypes.CDLL:
    """The port's own JPEG 2000 decoder (``csrc/host/jp2.cpp``), built with
    no contraction of float operations (the 9/7 wavelet's and the ICT's
    roundings are OpenJPEG's); needs only g++ and links nothing."""
    return _build_host("mmtrs_jp2", "jp2.cpp", [_gxx(), *HOST_FLAGS, "-ffp-contract=off", "-pthread"], ())


@functools.cache
def av1_library() -> ctypes.CDLL:
    """The port's own AV1 intra decoder for AVIF (``csrc/host/av1.cpp``, with
    the tables of ``av1_tables.h``); needs only g++ and links nothing."""
    return _build_host("mmtrs_av1", "av1.cpp", [_gxx(), *HOST_FLAGS], (), ("av1_tables.h",))


@functools.cache
def raster_library() -> ctypes.CDLL:
    """The other raster formats' sequential loops (``csrc/host/rasters.cpp``:
    TGA, PCX and SGI run lengths, QOI, BC1-BC7 blocks, CCITT fax, FLI
    frames, PhotoCD, CIELab → RGB, with the tables of ``raster_tables.h``
    and ``lab_tables.h``); needs only g++."""
    return _build_host("mmtrs_rasters", "rasters.cpp", [_gxx(), *HOST_FLAGS], (),
                       ("raster_tables.h", "lab_tables.h"))


@functools.cache
def jpeg_library() -> ctypes.CDLL:
    """The CPU backend's JPEG codec on the system libjpeg
    (``csrc/host/codec.cpp``, ``-ljpeg``); raises naming libjpeg when its
    header or library is missing."""
    gxx = _gxx()
    try:
        _find_header("jpeglib.h", [Path("/usr/include"), Path("/usr/local/include")])
    except RuntimeError as e:
        raise RuntimeError(f"the CPU JPEG codec needs libjpeg: {e}") from None
    return _build_host("mmtrs_codec", "codec.cpp", [gxx, *HOST_FLAGS], ("-ljpeg",))


@functools.cache
def nvjpeg_library() -> ctypes.CDLL:
    """The card backend's JPEG codec on the CUDA toolkit's nvJPEG
    (``csrc/host/nvjpeg.cpp``, built by nvcc with ``-lnvjpeg``); raises
    without a CUDA device, nvcc or nvJPEG."""
    if not torch.cuda.is_available():
        raise RuntimeError("the nvJPEG codec needs a CUDA device; none is visible")
    nvcc = _nvcc()
    cuda_home = Path(nvcc).resolve().parent.parent
    try:
        _find_header("nvjpeg.h", [cuda_home / "include"])
    except RuntimeError as e:
        raise RuntimeError(f"the card's JPEG codec needs nvJPEG: {e}") from None
    flags = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-shared")
    return _build_host("mmtrs_nvjpeg", "nvjpeg.cpp", [nvcc, *flags], ("-lnvjpeg",))


_BOUND: dict[str, ctypes._CFuncPtr] = {}


def kernel(name: str) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library, looked up once (the first
    call builds the library) and then taken from a dict."""
    fn = _BOUND.get(name)
    if fn is None:
        fn = _BOUND[name] = getattr(library(), name)
    return fn


def stream_handle() -> int:
    """PyTorch's current CUDA stream as an integer handle for ctypes, read
    raw as PyTorch's own generated code reads it: building a
    ``torch.cuda.Stream`` for it cost a kernel launch's host time."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def check_launch(name: str, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {code}")
