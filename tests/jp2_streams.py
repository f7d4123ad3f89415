"""JPEG 2000 streams the port's tests need and Pillow cannot write: the
settings of OpenJPEG's encoder that Pillow's ``save`` hides (code-block
styles, progression order changes, SOP and EPH markers, tile-parts, 12- and
16-bit and signed samples), reached through the encoder of the OpenJPEG
2.5.4 that Pillow's wheel bundles (``pillow.libs/libopenjp2-*.so``) by
ctypes, and codestream rewrites for what no encoder writes (packet headers
moved into PPM or PPT marker segments). Only to encode: the answer a test
holds a decode to is always Pillow's decode of the stream.
"""

from __future__ import annotations

import ctypes
import struct
import tempfile
from pathlib import Path

import numpy as np

OPJ_PATH_LEN, OPJ_J2K_MAXRLVLS, JPWL_SPECS = 4096, 33, 16
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block styles (COD's SPcod byte 4)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
SOP, EPH = 2, 4


class _Poc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
                                               "precno0", "precno1")] + [
        ("prg1", ctypes.c_int), ("prg", ctypes.c_int), ("progorder", ctypes.c_char * 5), ("tile", ctypes.c_uint32)] + [
        (n, ctypes.c_uint32) for n in ("tx0", "tx1", "ty0", "ty1", "layS", "resS", "compS", "prcS", "layE", "resE",
                                       "compE", "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t", "res_t",
                                       "comp_t", "prc_t", "tx0_t", "ty0_t")]


class _Params(ctypes.Structure):
    """openjpeg.h's opj_cparameters_t (2.5), with room after its last field."""
    _fields_ = [
        ("tile_size_on", ctypes.c_int), ("cp_tx0", ctypes.c_int), ("cp_ty0", ctypes.c_int), ("cp_tdx", ctypes.c_int),
        ("cp_tdy", ctypes.c_int), ("cp_disto_alloc", ctypes.c_int), ("cp_fixed_alloc", ctypes.c_int),
        ("cp_fixed_quality", ctypes.c_int), ("cp_matrice", ctypes.c_void_p), ("cp_comment", ctypes.c_char_p),
        ("csty", ctypes.c_int), ("prog_order", ctypes.c_int), ("POC", _Poc * 32), ("numpocs", ctypes.c_uint32),
        ("tcp_numlayers", ctypes.c_int), ("tcp_rates", ctypes.c_float * 100), ("tcp_distoratio", ctypes.c_float * 100),
        ("numresolution", ctypes.c_int), ("cblockw_init", ctypes.c_int), ("cblockh_init", ctypes.c_int),
        ("mode", ctypes.c_int), ("irreversible", ctypes.c_int), ("roi_compno", ctypes.c_int),
        ("roi_shift", ctypes.c_int), ("res_spec", ctypes.c_int), ("prcw_init", ctypes.c_int * OPJ_J2K_MAXRLVLS),
        ("prch_init", ctypes.c_int * OPJ_J2K_MAXRLVLS), ("infile", ctypes.c_char * OPJ_PATH_LEN),
        ("outfile", ctypes.c_char * OPJ_PATH_LEN), ("index_on", ctypes.c_int), ("index", ctypes.c_char * OPJ_PATH_LEN),
        ("image_offset_x0", ctypes.c_int), ("image_offset_y0", ctypes.c_int), ("subsampling_dx", ctypes.c_int),
        ("subsampling_dy", ctypes.c_int), ("decod_format", ctypes.c_int), ("cod_format", ctypes.c_int),
        ("jpwl_epc_on", ctypes.c_int), ("jpwl_hprot_MH", ctypes.c_int),
        ("jpwl_hprot_TPH_tileno", ctypes.c_int * JPWL_SPECS), ("jpwl_hprot_TPH", ctypes.c_int * JPWL_SPECS),
        ("jpwl_pprot_tileno", ctypes.c_int * JPWL_SPECS), ("jpwl_pprot_packno", ctypes.c_int * JPWL_SPECS),
        ("jpwl_pprot", ctypes.c_int * JPWL_SPECS), ("jpwl_sens_size", ctypes.c_int), ("jpwl_sens_addr", ctypes.c_int),
        ("jpwl_sens_range", ctypes.c_int), ("jpwl_sens_MH", ctypes.c_int),
        ("jpwl_sens_TPH_tileno", ctypes.c_int * JPWL_SPECS), ("jpwl_sens_TPH", ctypes.c_int * JPWL_SPECS),
        ("cp_cinema", ctypes.c_int), ("max_comp_size", ctypes.c_int), ("cp_rsiz", ctypes.c_int),
        ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char), ("tcp_mct", ctypes.c_char), ("jpip_on", ctypes.c_int),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", ctypes.c_int), ("rsiz", ctypes.c_uint16),
        ("_room", ctypes.c_char * 4096)]


class _CompParm(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]


class _Comp(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                               "resno_decoded", "factor")] + [
        ("data", ctypes.POINTER(ctypes.c_int32)), ("alpha", ctypes.c_uint16)]


class _Image(ctypes.Structure):
    _fields_ = [(n, ctypes.c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
        ("color_space", ctypes.c_int), ("comps", ctypes.POINTER(_Comp)), ("icc_profile_buf", ctypes.c_void_p),
        ("icc_profile_len", ctypes.c_uint32)]


_LIB = None


def openjpeg() -> ctypes.CDLL:
    """The wheel's libopenjp2, its encoder's entry points bound, its
    opj_cparameters_t layout checked against the library's defaults."""
    global _LIB
    if _LIB is not None:
        return _LIB
    import PIL

    found = sorted((Path(PIL.__file__).parent.parent / "pillow.libs").glob("libopenjp2-*.so*"))
    if not found:
        raise RuntimeError("the Pillow wheel's libopenjp2 is not installed")
    lib = ctypes.CDLL(str(found[0]))
    lib.opj_version.restype = ctypes.c_char_p
    lib.opj_image_create.restype = ctypes.POINTER(_Image)
    lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.POINTER(_CompParm), ctypes.c_int]
    lib.opj_create_compress.restype = ctypes.c_void_p
    lib.opj_create_compress.argtypes = [ctypes.c_int]
    lib.opj_setup_encoder.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Params), ctypes.POINTER(_Image)]
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.opj_start_compress.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Image), ctypes.c_void_p]
    lib.opj_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_end_compress.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
    lib.opj_set_default_encoder_parameters.argtypes = [ctypes.POINTER(_Params)]
    p = _Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    got = (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx, p.subsampling_dy,
           p.decod_format, p.cod_format)
    if got != (6, 64, 64, -1, 1, 1, -1, -1) or lib.opj_version() != b"2.5.4":
        raise RuntimeError(f"libopenjp2 {lib.opj_version()}: opj_cparameters_t is not laid out as expected ({got})")
    _LIB = lib
    return lib


def openjpeg_encode(px: np.ndarray, prec: int = 8, signed: bool = False, jp2: bool = False, *, rates: tuple = (),
                    irreversible: bool = False, cblk: tuple = (64, 64), mode: int = 0, csty: int = 0,
                    pocs: tuple = (), tile: tuple | None = None, tile_parts: str = "", mct: int | None = None) -> bytes:
    """An [h, w] or [h, w, c] integer array as a JPEG 2000 codestream (or
    .jp2 file) from OpenJPEG's encoder (6 resolutions, LRCP). ``mode``:
    code-block styles; ``csty``: SOP / EPH; ``pocs``: (resno0, compno0,
    layno1, resno1, compno1, order) each, for tile 1; ``tile``: its (width,
    height); ``tile_parts``: "R", "L" or "C" (a tile-part per resolution,
    layer or component)."""
    lib = openjpeg()
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, nc = px.shape
    parms = (_CompParm * nc)()
    for c in range(nc):
        parms[c].dx, parms[c].dy = 1, 1
        parms[c].w, parms[c].h = w, h
        parms[c].prec, parms[c].bpp, parms[c].sgnd = prec, prec, int(signed)
    space = 1 if nc >= 3 else 2  # sRGB, gray
    img = lib.opj_image_create(nc, parms, space)
    im = img.contents
    im.x1, im.y1 = w, h
    for c in range(nc):
        flat = np.ascontiguousarray(px[..., c].astype(np.int32)).ravel()
        ctypes.memmove(im.comps[c].data, flat.ctypes.data, flat.nbytes)
    p = _Params()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers = max(1, len(rates))
    for i, r in enumerate(rates or (0,)):
        p.tcp_rates[i] = r
    p.cp_disto_alloc = 1
    p.irreversible = int(irreversible)
    p.cblockw_init, p.cblockh_init = cblk
    p.mode = mode
    p.csty = csty
    for i, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
        poc = p.POC[i]
        poc.tile, poc.resno0, poc.compno0, poc.layno1, poc.resno1, poc.compno1 = 1, r0, c0, l1, r1, c1
        poc.prg1 = PROGRESSIONS[order]
    p.numpocs = len(pocs)
    if tile:
        p.tile_size_on, p.cp_tdx, p.cp_tdy = 1, tile[0], tile[1]
    if tile_parts:
        p.tp_on, p.tp_flag = b"\x01", tile_parts.encode()
    p.tcp_mct = bytes([(1 if nc >= 3 else 0) if mct is None else mct])
    p.cod_format = 1 if jp2 else 0
    codec = lib.opj_create_compress(2 if jp2 else 0)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / ("out.jp2" if jp2 else "out.j2k")).encode()
        stream = None
        try:
            if not lib.opj_setup_encoder(codec, ctypes.byref(p), img):
                raise RuntimeError("opj_setup_encoder refused the parameters")
            stream = lib.opj_stream_create_default_file_stream(path, 0)
            ok = lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream) \
                and lib.opj_end_compress(codec, stream)
            if not ok:
                raise RuntimeError("OpenJPEG's encoder failed")
        finally:
            if stream:
                lib.opj_stream_destroy(stream)
            lib.opj_destroy_codec(codec)
            lib.opj_image_destroy(img)
        return Path(path.decode()).read_bytes()


# ---------------------------------------------------------------------------
# Codestream rewrites
# ---------------------------------------------------------------------------


def _segments(cs: bytes) -> tuple[list[tuple[int, bytes]], int]:
    """The main header's marker segments [(marker, body)] and the offset of the first SOT."""
    pos, out = 2, []
    while True:
        marker = struct.unpack(">H", cs[pos:pos + 2])[0]
        if marker == 0xFF90:
            return out, pos
        n = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
        out.append((marker, cs[pos + 4:pos + 2 + n]))
        pos += 2 + n


def _tile_parts(cs: bytes, first: int) -> list[tuple[bytes, bytes]]:
    """(tile-part header segments after SOT, up to SOD; body) of each tile-part."""
    pos, parts = first, []
    while struct.unpack(">H", cs[pos:pos + 2])[0] == 0xFF90:
        psot = struct.unpack(">I", cs[pos + 6:pos + 10])[0]
        sot = cs[pos:pos + 12]
        sod = cs.index(b"\xff\x93", pos + 12)
        end = pos + psot if psot else len(cs) - 2
        parts.append((sot + cs[pos + 12:sod], cs[sod + 2:end]))
        pos = end
    return parts


def _split_packets(body: bytes) -> list[tuple[bytes, bytes]]:
    """A tile-part body written with SOP and EPH → [(header with its EPH,
    packet body)] (SOP markers dropped)."""
    starts = [i for i in range(len(body) - 1) if body[i] == 0xFF and body[i + 1] == 0x91]
    out = []
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else len(body)
        eph = body.index(b"\xff\x92", s + 6) + 2
        out.append((body[s + 6:eph], body[eph:end]))
    return out


def _without_sop(segments: list[tuple[int, bytes]]) -> list[tuple[int, bytes]]:
    out = []
    for m, b in segments:
        if m == 0xFF52:  # COD: keep EPH, drop SOP (the bodies lose their SOP markers)
            b = bytes([b[0] & ~SOP]) + b[1:]
        out.append((m, b))
    return out


def _write(segments, parts) -> bytes:
    out = bytearray(b"\xff\x4f")
    for m, b in segments:
        out += struct.pack(">HH", m, len(b) + 2) + b
    for head, body in parts:
        tp = bytearray(head + b"\xff\x93" + body)
        tp[6:10] = struct.pack(">I", len(tp))
        out += tp
    return bytes(out + b"\xff\xd9")


def to_ppt(cs: bytes) -> bytes:
    """A codestream written with SOP and EPH, each tile-part's packet
    headers moved into PPT segments (SOP markers dropped)."""
    segments, first = _segments(cs)
    parts = []
    for head, body in _tile_parts(cs, first):
        packets = _split_packets(body)
        headers = b"".join(h for h, _ in packets)
        ppt = b"".join(struct.pack(">HHB", 0xFF61, 3 + len(chunk), z) + chunk
                       for z, chunk in enumerate(headers[i:i + 60000] for i in range(0, max(len(headers), 1), 60000)))
        parts.append((head + ppt, b"".join(b for _, b in packets)))
    return _write(_without_sop(segments), parts)


def to_ppm(cs: bytes) -> bytes:
    """A codestream written with SOP and EPH, every tile-part's packet
    headers moved into the main header's PPM segment (Nppm then Ippm for
    each tile-part, SOP markers dropped)."""
    segments, first = _segments(cs)
    ippm, parts = b"", []
    for head, body in _tile_parts(cs, first):
        packets = _split_packets(body)
        headers = b"".join(h for h, _ in packets)
        ippm += struct.pack(">I", len(headers)) + headers
        parts.append((head, b"".join(b for _, b in packets)))
    segments = _without_sop(segments) + [(0xFF60, b"\x00" + ippm)]
    return _write(segments, parts)
