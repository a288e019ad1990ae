"""`identify(data)`: the format name Pillow 12.1's `Image.open` gives image
bytes (`Image.open(...).format`), or None where it raises, by the order PIL
tries its plugins in.

`Image.open` first tries the plugins `preinit()` loads (BMP, DIB, GIF, JPEG,
PPM, PNG), then every other plugin in the order of `Image.ID`. A plugin with
an `_accept` is tried only when its signature matches; one without
(IM, IMT, IPTC, PCD, SPIDER and TGA) always is. A plugin whose `_open`
raises SyntaxError, IndexError, TypeError, KeyError, EOFError or
struct.error (or leaves the image without a mode or a size) is passed over;
any other exception, or a size past twice MAX_IMAGE_PIXELS, ends the open.

TGA has no signature: a file is TGA when its 18-byte header passes
`TgaImageFile._open`'s checks and no plugin before it opens the file or ends
the open. The plugins before TGA that can take such a header are followed
here as far as their `_open`s decide (AVIF, CUR, PCX, FLI, GBR, ICO, IM,
IMT, IPTC, MPEG, PCD, SPIDER); the others have signatures no TGA header can
carry, and are named by their signatures. So are the formats the port reads
(their decoders refuse what PIL's `_open`s refuse), except a PPM magic PIL
does not know, a DIB header it cannot read, and an ICO or CUR file whose
directory or DIB header it cannot read: PIL passes those on to the later
plugins, and so does `identify`. An ICO's PNG entry is not opened here (one
that PIL cannot open leaves the file to the later plugins; TGA can take it
only when the entry's size field passes 64 KiB), nor are an ICO's pixels,
which PIL loads in `_open`.
"""

from __future__ import annotations

import math
import re
import struct

_MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)  # twice PIL's Image.MAX_IMAGE_PIXELS
_OPEN, _PASS, _RAISE = "open", "pass", "raise"

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_JP2_MAGIC = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
_TIFF_MAGIC = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00")


def _u16(d: bytes, at: int) -> int | None:
    return struct.unpack_from("<H", d, at)[0] if len(d) >= at + 2 else None


def _u32(d: bytes, at: int) -> int | None:
    return struct.unpack_from("<I", d, at)[0] if len(d) >= at + 4 else None


def _too_big(w: int, h: int) -> bool:
    return max(1, w) * max(1, h) > _MAX_PIXELS


def tga_header_ok(data: bytes) -> bool:
    """TgaImageFile._open passes (the tile may still be missing)."""
    if len(data) < 18:
        return False
    cmap_type, image_type, depth = data[1], data[2], data[16]
    w, h = _u16(data, 12), _u16(data, 14)
    if cmap_type not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        return False
    if image_type not in (1, 2, 3, 9, 10, 11):
        return False
    return not cmap_type or data[7] in (16, 24, 32)


# ------------------------------------------------------ DIB (ICO, CUR) ----

_BITFIELDS_SUPPORTED = {
    32: [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0), (0xFF000000, 0xFF00, 0xFF, 0x0),
         (0xFF000000, 0xFF0000, 0xFF00, 0xFF), (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)],
    24: [(0xFF0000, 0xFF00, 0xFF)],
    16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)],
}


def _dib(data: bytes, at: int) -> tuple[str, int, int]:
    """BmpImageFile._bitmap of a DIB at byte `at` -> (outcome, width, height)."""
    header_size = _u32(data, at)
    if header_size is None:
        return _PASS, 0, 0
    need = header_size - 4
    hd = data[at + 4:at + 4 + max(need, 0)]
    if need > 0 and len(hd) < need:
        return _RAISE, 0, 0  # ImageFile._safe_read: "Truncated File Read"
    pos = at + 4 + max(need, 0)
    colors = 0
    if header_size == 12:
        w, h, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        compression = 0
    elif header_size in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        w, h = _u32(hd, 0), _u32(hd, 4)
        h = 2**32 - h if flip else h
        bits, compression, colors = _u16(hd, 10), _u32(hd, 12), _u32(hd, 28)
        if compression == 3:
            if len(hd) >= 48:
                masks = [_u32(hd, 36 + 4 * i) for i in range(4 if len(hd) >= 52 else 3)] + ([] if len(hd) >= 52
                                                                                          else [0])
            else:
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                if None in masks:
                    return _PASS, 0, 0  # struct.error reading a mask
    else:
        return _RAISE, 0, 0
    if bits not in (1, 4, 8, 16, 24, 32):
        return _RAISE, 0, 0
    if compression == 3:
        if bits not in _BITFIELDS_SUPPORTED:
            return _RAISE, 0, 0
        if not ((bits == 32 and tuple(masks) in _BITFIELDS_SUPPORTED[32]) or
                (bits in (24, 16) and tuple(masks[:3]) in _BITFIELDS_SUPPORTED[bits])):
            return _RAISE, 0, 0
    elif compression not in (0, 1, 2):
        return _RAISE, 0, 0
    if bits <= 8 and not 0 < (colors or (1 << bits)) <= 65536:
        return _RAISE, 0, 0
    return _OPEN, w, h


def _dib_file(data: bytes) -> str:
    outcome, w, h = _dib(data, 0)
    if outcome != _OPEN:
        return outcome
    if w <= 0 or h <= 0:
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


def _ico(data: bytes) -> str:
    count = _u16(data, 4)
    if count is None:
        return _PASS
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            return _PASS  # IndexError / struct.error on a short entry
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        bpp = _u16(s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w * h, depth, _u32(s, 12)))
    if not entries:
        return _PASS  # entry[0]: IndexError
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    offset = entries[0][2]
    if data[offset:offset + 8] == _PNG_MAGIC:
        return _OPEN
    outcome, w, h = _dib(data, offset)
    if outcome != _OPEN:
        return outcome
    if w <= 0 or h <= 0:
        return _PASS  # "not identified by this driver"
    return _RAISE if _too_big(w, h) else _OPEN


def _cur(data: bytes) -> str:
    count = _u16(data, 4)
    if count is None:
        return _PASS
    best = b""
    try:
        for i in range(count):
            s = data[6 + 16 * i:22 + 16 * i]
            if not best:
                best = s
            elif s[0] > best[0] and s[1] > best[1]:
                best = s
    except IndexError:
        return _PASS
    if not best:
        return _PASS  # "No cursors were found"
    offset = _u32(best, 12)
    if offset is None:
        return _PASS
    at = offset if offset else 6 + 16 * count  # _bitmap(0) reads where the directory ended
    outcome, w, h = _dib(data, at)
    if outcome != _OPEN:
        return outcome
    h //= 2
    if w <= 0 or h <= 0:
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


# ------------------------------------- the other plugins before TGA ----

def _avif(data: bytes) -> str:
    # A TGA header cannot begin a real AVIF file (its ftyp box would be
    # larger than 64 KiB): libavif refuses it and PIL passes it on.
    return _PASS if tga_header_ok(data) else _OPEN


def _pcx(data: bytes) -> str:
    s = data[:68]
    if len(s) < 12:
        return _PASS
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        return _PASS  # "bad PCX image size"
    if len(s) < 68:
        return _PASS
    version, bits, planes = s[1], s[3], s[65]
    if not ((bits == 1 and planes in (1, 2, 4)) or (version == 5 and bits == 8 and planes in (1, 3))):
        return _RAISE  # "unknown PCX mode"
    return _RAISE if _too_big(x1 + 1 - x0, y1 + 1 - y0) else _OPEN


def _fli(data: bytes) -> str:
    s = data[:128]
    if not (s[20:22] == b"\0\0" and s[42:80] == bytes(38) and s[88:] == bytes(40)):
        return _PASS
    w, h = _u16(s, 8), _u16(s, 10)
    s = data[128:144]
    if len(s) < 6:
        return _PASS
    pos = 144
    if _u16(s, 4) == 0xF100:
        pos = 128 + _u32(s, 0)
        s = data[pos:pos + 16]
        pos += len(s)
        if len(s) < 6:
            return _PASS
    if _u16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_u16(s, 6)):
            if chunk_size is not None:
                pos = max(0, pos + chunk_size - 6)
            c = data[pos:pos + 6]
            pos += len(c)
            if len(c) < 6:
                return _PASS
            if _u16(c, 4) in (4, 11):
                # FliImageFile._palette: packets of (skip, count, count RGB triples)
                packets = _u16(data, pos)
                if packets is None:
                    return _PASS
                pos += 2
                i = 0
                for _ in range(packets):
                    if pos + 2 > len(data):
                        return _PASS
                    i += data[pos]
                    rgb = data[pos + 2:pos + 2 + 3 * (data[pos + 1] or 256)]
                    pos += 2 + len(rgb)
                    if len(rgb) % 3 or i + len(rgb) // 3 > 256:
                        return _PASS  # a short triple, or palette[256]: IndexError
                    i += len(rgb) // 3
                break
            chunk_size = _u32(c, 0)
            if not chunk_size:
                break
    # seek(0): one frame at least, and its size
    if _u16(data, 6) == 0 or len(data[128:132]) < 4:
        return _PASS
    if w <= 0 or h <= 0:
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


def _gbr(data: bytes) -> str:
    fields = [struct.unpack_from(">I", data, 4 * i)[0] if len(data) >= 4 * i + 4 else None for i in range(5)]
    header_size, version, w, h, depth = fields
    if header_size is None or header_size < 20 or version is None or version not in (1, 2):
        return _PASS
    if w is None or h is None or depth is None or w == 0 or h == 0 or depth not in (1, 4):
        return _PASS
    if version == 2 and (data[20:24] != b"GIMP" or len(data) < 28):
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


def _mpeg(data: bytes) -> str:
    if len(data) < 7:
        return _PASS
    v = int.from_bytes(data[4:7], "big")
    w, h = v >> 12, v & 0xFFF
    if w <= 0 or h <= 0:
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


_IM_SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = {"Comment", "Date", "Digitalization equipment", "File size (no of images)", "Lut", "Name",
            "Scale (x,y)", "Image size (x*y)", "Image type"}
_IM_MODES = {"0 1 image": "1", "L 1 image": "1", "Greyscale image": "L", "Grayscale image": "L", "RGB image": "RGB",
             "RLB image": "RGB", "RYB image": "RGB", "B1 image": "1", "B2 image": "P", "B4 image": "P",
             "X 24 image": "RGB", "L 32 S image": "I", "L 32 F image": "F", "RGB3 image": "RGB",
             "RYB3 image": "RGB", "LA image": "LA", "PA image": "LA", "RGBA image": "RGBA", "RGBX image": "RGB",
             "CMYK image": "CMYK", "YCC image": "YCbCr"}


def _im_number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def _im(data: bytes) -> str:
    """ImImageFile._open: a text header of "key: value" lines."""
    if b"\n" not in data[:100]:
        return _PASS
    pos, n, info = 0, 0, {"Image type": "L", "Image size (x*y)": (512, 512)}
    s = b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            return _PASS
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = _IM_SPLIT.match(s)
        if not m:
            return _PASS
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in ("File size (no of images)", "Scale (x,y)", "Image size (x*y)"):
            try:
                v = tuple(map(_im_number, v.replace("*", ",").split(",")))
            except ValueError:
                return _RAISE
            if len(v) == 1:
                v = v[0]
        elif k == "Image type" and v in _IM_MODES:
            v = _IM_MODES[v]
        info[k] = v
        n += k in _IM_TAGS
    if not n:
        return _PASS
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        return _PASS  # "File truncated"
    if "Lut" in info and len(data) - pos < 768:
        return _PASS  # the LUT's palette[i + 512]: IndexError
    size, mode = info["Image size (x*y)"], info["Image type"]
    if not isinstance(size, tuple) or not mode or size[0] <= 0 or size[1] <= 0:
        return _PASS  # (0, 0) + size: TypeError, or "not identified by this driver"
    return _RAISE if max(1, size[0]) * max(1, size[1]) > _MAX_PIXELS else _OPEN


def _imt(data: bytes) -> str:
    """ImtImageFile._open: "width", "height" and "pixel n8" lines."""
    buffer = data[:100]
    if b"\n" not in buffer:
        return _PASS
    pos, w, h, mode = 100, 0, 0, ""
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s = data[pos:pos + 1]
            pos += len(s)
        if not s or s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos += len(data[pos:pos + 100])
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError:
            return _RAISE
        if k == b"pixel" and v == b"n8":
            mode = "L"
    if not mode or w <= 0 or h <= 0:
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


def _iptc(data: bytes) -> str:
    """IptcImageFile._open: IPTC/NAA fields up to the image (8, 10)."""
    pos, info, tag = 0, {}, None
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            tag = None
            break
        if len(s) < 3:
            return _PASS  # s[1], s[2]: IndexError
        tag = (s[1], s[2])
        if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return _PASS
        if len(s) < 4:
            return _PASS
        size = s[3]
        if size > 132:
            return _RAISE  # "illegal field length"
        if size == 128:
            size = 0
        elif size > 128:
            c = data[pos:pos + size - 128]
            pos += len(c)
            size = int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")
        else:
            if len(s) < 5:
                return _PASS
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        value = None
        if size:
            value = data[pos:pos + size]
            pos += len(value)
        if tag in info:
            info[tag] = (info[tag] if isinstance(info[tag], list) else [info[tag]]) + [value]
        else:
            info[tag] = value

    def getint(key):
        c = info[key]  # KeyError: passed over
        if not isinstance(c, bytes):
            raise TypeError
        return int.from_bytes((b"\0\0\0\0" + c)[-4:], "big")

    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = "L" if layers == 1 and not component else (
            "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else "")
        if not (layers == 1 and not component):
            if (3, 65) in info:
                info[(3, 65)][0] - 1  # noqa: B018 - the band; a TypeError passes the file over
        w, h = getint((3, 20)), getint((3, 30))
    except (KeyError, IndexError, TypeError):
        return _PASS
    try:
        compression = getint((3, 120))
    except (KeyError, TypeError) as e:
        return _RAISE if isinstance(e, KeyError) else _PASS
    if compression not in (1, 5):
        return _RAISE  # "Unknown IPTC image compression"
    if not mode or w <= 0 or h <= 0:
        return _PASS
    return _RAISE if _too_big(w, h) else _OPEN


def _pcd(data: bytes) -> str:
    return _OPEN if len(data) >= 2048 + 1539 and data[2048:2052] == b"PCD_" else _PASS


def _spider(data: bytes) -> str:
    """SpiderImageFile._open: 27 floats of a plausible header, either order."""
    f = data[:108]
    if len(f) < 108:
        return _PASS

    def is_int(x) -> bool:
        try:
            return x - int(x) == 0
        except (ValueError, OverflowError):
            return False

    def header_len(t) -> int:
        h = (99,) + t
        if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)) or int(h[5]) not in (1, 3, -11, -12, -21, -22):
            return 0
        labbyt = int(h[22])
        return labbyt if labbyt == int(h[13]) * int(h[23]) else 0

    t = struct.unpack(">27f", f)
    if not header_len(t):
        t = struct.unpack("<27f", f)
        if not header_len(t):
            return _PASS
    h = (99,) + t
    if int(h[5]) != 1:
        return _PASS  # "not a Spider 2D image"
    try:
        w, height, istack, imgnumber = int(h[12]), int(h[2]), int(h[24]), int(h[27])
    except (ValueError, OverflowError):
        return _RAISE
    if istack == 0 and imgnumber > 0:
        return _RAISE  # reads an attribute _open never sets
    if not ((istack == 0 and imgnumber == 0) or (istack > 0 and imgnumber == 0)):
        return _PASS  # "inconsistent stack header values"
    if w <= 0 or height <= 0:
        return _PASS
    return _RAISE if _too_big(w, height) else _OPEN


# ---------------------------------------------------------- PPM magic ----

_PPM_MAGICS = (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"P0CMYK", b"Pf", b"PyP", b"PyRGBA", b"PyCMYK")


def _ppm(data: bytes) -> str:
    """PpmImageFile's magic: up to 6 bytes before whitespace (the tokens
    after it are `decode_ppm`'s)."""
    magic = b""
    for c in data[:6]:
        if c in b" \t\n\x0b\x0c\r":
            break
        magic += bytes((c,))
    return _OPEN if magic in _PPM_MAGICS else _PASS


# --------------------------------------------------------------- order ----

def identify(data: bytes) -> str | None:
    """The format PIL's `Image.open(io.BytesIO(data)).format` names, or None
    where `Image.open` raises."""
    data = bytes(data)
    p = data[:16]
    u32 = struct.unpack_from("<I", p)[0] if len(p) >= 4 else None
    steps = (
        # preinit: BMP, DIB, GIF, JPEG, PPM, PNG
        (lambda: p.startswith(b"BM"), "BMP", None),
        (lambda: u32 in (12, 40, 52, 56, 64, 108, 124), "DIB", _dib_file),
        (lambda: p[:6] in (b"GIF87a", b"GIF89a"), "GIF", None),
        (lambda: p.startswith(b"\xff\xd8\xff"), "JPEG", None),
        (lambda: p[:1] == b"P" and len(p) >= 2 and p[1] in b"0123456fy", "PPM", _ppm),
        (lambda: p.startswith(_PNG_MAGIC), "PNG", None),
        # then the rest of Image.ID, in its order, up to TGA
        (lambda: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), "AVIF", _avif),
        (lambda: p[:4] in (b"BLP1", b"BLP2"), "BLP", None),
        (lambda: p[:4] in (b"BUFR", b"ZCZC"), "BUFR", None),
        (lambda: p.startswith(b"\0\0\2\0"), "CUR", _cur),
        (lambda: len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5), "PCX", _pcx),
        (lambda: u32 == 0x3ADE68B1, "DCX", None),
        (lambda: p.startswith(b"DDS "), "DDS", None),
        (lambda: p[:4] == b"%!PS" or u32 == 0xC6D3D0C5, "EPS", None),
        (lambda: p.startswith(b"SIMPLE"), "FITS", None),
        (lambda: len(p) >= 16 and _u16(p, 4) in (0xAF11, 0xAF12) and _u16(p, 14) in (0, 3), "FLI", _fli),
        (lambda: p.startswith(b"FTEX"), "FTEX", None),
        (lambda: len(p) >= 8 and struct.unpack_from(">I", p)[0] >= 20 and struct.unpack_from(">I", p, 4)[0] in (1, 2),
         "GBR", _gbr),
        (lambda: len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1, "GRIB", None),
        (lambda: p.startswith(b"\x89HDF\r\n\x1a\n"), "HDF5", None),
        (lambda: p[:4] == b"\xff\x4f\xff\x51" or p[:12] == _JP2_MAGIC, "JPEG2000", None),
        (lambda: p.startswith(b"icns"), "ICNS", None),
        (lambda: p.startswith(b"\0\0\1\0"), "ICO", _ico),
        (lambda: True, "IM", _im),
        (lambda: True, "IMT", _imt),
        (lambda: True, "IPTC", _iptc),
        (lambda: p.startswith(b"\0\0\0\0\0\0\0\x04"), "MCIDAS", None),
        (lambda: p.startswith(b"\0\0\1\xb3"), "MPEG", _mpeg),
        (lambda: p[:4] in _TIFF_MAGIC, "TIFF", None),
        (lambda: p[:4] in (b"DanM", b"LinS"), "MSP", None),
        (lambda: True, "PCD", _pcd),
        (lambda: p[:4] == b"\x80\xe8\x00\x00", "PIXAR", None),
        (lambda: p.startswith(b"8BPS"), "PSD", None),
        (lambda: p.startswith(b"qoif"), "QOI", None),
        (lambda: len(p) >= 2 and struct.unpack_from(">H", p)[0] == 474, "SGI", None),
        (lambda: True, "SPIDER", _spider),
        (lambda: len(p) >= 4 and struct.unpack_from(">I", p)[0] == 0x59A66A95, "SUN", None),
    )
    for accept, name, opens in steps:
        if not accept():
            continue
        outcome = _OPEN if opens is None else opens(data)
        if outcome == _OPEN:
            return name
        if outcome == _RAISE:
            return None
    if tga_header_ok(data):
        return None if _too_big(_u16(data, 12), _u16(data, 14)) else "TGA"
    # after TGA: WEBP, WMF, XBM, XPM, XVTHUMB
    if p[:4] == b"RIFF" and p[8:12] == b"WEBP":
        return "WEBP"
    if p.startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")):
        return "WMF"
    if p.lstrip().startswith(b"#define"):
        return "XBM"
    if p.startswith(b"/* XPM */"):
        return "XPM"
    if p.startswith(b"P7 332"):
        return "XVTHUMB"
    return None
