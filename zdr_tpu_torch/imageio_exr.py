"""Minimal self-contained OpenEXR codec, an 8-bit PNG writer, and unified
image load/save helpers (the port's own copy of zdr_tpu/imageio_exr.py).

The texture-recovery apps read PNG textures and EXR environment maps and
write EXR images with PNG previews. The codec implements the small subset of
the OpenEXR 2.0 format the workflow needs, from the public format spec:

  write: scanline, ZIP_COMPRESSION, float32 or half channels, RGB(A)/Y
  read:  scanline, NO/RLE/ZIPS/ZIP compression, half/float/uint channels,
         any channel names (R,G,B[,A] ordered out front), data==display win

Everything else (tiled, deep, PIZ/B44/DWA compression, multi-part) raises a
clear error. PNG is written here (8-bit, no filter, one IDAT chunk), so
writing an app's outputs needs numpy and the standard library alone;
reading an LDR file and writing a format other than EXR or PNG delegate to
imageio, imported where it is needed.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_VERSION = 2

# pixel types (OpenEXR spec)
_UINT = 0
_HALF = 1
_FLOAT = 2

_PT_DTYPE = {_UINT: np.uint32, _HALF: np.float16, _FLOAT: np.float32}
_PT_SIZE = {_UINT: 4, _HALF: 2, _FLOAT: 4}

NO_COMPRESSION = 0
RLE_COMPRESSION = 1
ZIPS_COMPRESSION = 2  # zip, 1 scanline per block
ZIP_COMPRESSION = 3  # zip, 16 scanlines per block

_BLOCK_LINES = {
    NO_COMPRESSION: 1,
    RLE_COMPRESSION: 1,
    ZIPS_COMPRESSION: 1,
    ZIP_COMPRESSION: 16,
}


# --------------------------------------------------------------- write


def _attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
    return name + b"\x00" + typ + b"\x00" + struct.pack("<i", len(payload)) + payload


def _chlist(names: List[str], pixel_type: int) -> bytes:
    out = b""
    for n in names:
        out += n.encode() + b"\x00"
        out += struct.pack("<i", pixel_type)
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\x00"


def _zip_predict_encode(raw: bytes) -> bytes:
    """OpenEXR zip preprocess (ImfZip.cpp Zip::compress): FIRST reorder the
    bytes (even-indexed bytes to the front half, odd-indexed to the back),
    THEN delta-predict over the reordered buffer, then deflate (the other
    order is its own decoder's inverse, but no standard OpenEXR reader's)."""
    a = np.frombuffer(raw, np.uint8)
    n = a.shape[0]
    half = (n + 1) // 2
    inter = np.empty(n, np.uint8)
    inter[:half] = a[0::2]
    inter[half:] = a[1::2]
    t = inter.astype(np.int16)
    d = np.empty_like(t)
    d[0] = t[0]
    # d[i] = inter[i] - inter[i-1] + 128 (mod 256)
    d[1:] = (t[1:] - t[:-1] + 128 + 256) % 256
    return zlib.compress(d.astype(np.uint8).tobytes())


def _zip_predict_decode(comp: bytes, out_len: int) -> bytes:
    """Inverse (ImfZip.cpp Zip::uncompress): inflate, undo the delta
    predictor (cumsum), then merge the two halves back (interleave)."""
    d = np.frombuffer(zlib.decompress(comp), np.uint8)
    a = d.astype(np.int16)
    a = a.copy()
    a[1:] -= 128
    inter = (np.cumsum(a, dtype=np.int64) % 256).astype(np.uint8)
    n = inter.shape[0]
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = inter[:half]
    out[1::2] = inter[half:]
    return out[:out_len].tobytes()


def _rle_decode(comp: bytes, out_len: int) -> bytes:
    src = np.frombuffer(comp, np.uint8)
    out = np.empty(out_len, np.uint8)
    i = 0
    o = 0
    while i < len(src) and o < out_len:
        count = int(np.int8(src[i]))
        i += 1
        if count < 0:
            n = -count
            out[o : o + n] = src[i : i + n]
            i += n
        else:
            n = count + 1
            out[o : o + n] = src[i]
            i += 1
        o += n
    # undo delta + deinterleave (same postprocess as zip)
    a = out.astype(np.int16)
    a[1:] -= 128
    d = (np.cumsum(a, dtype=np.int64) % 256).astype(np.uint8)
    half = (out_len + 1) // 2
    res = np.empty(out_len, np.uint8)
    res[0::2] = d[:half]
    res[1::2] = d[half:]
    return res.tobytes()


def save_exr(path: str, img: np.ndarray, half: bool = True) -> None:
    """Write (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) float array as a
    scanline EXR (ZIP compression). `half=True` stores float16 channels
    (the usual choice for HDR images); False stores float32."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"save_exr: unsupported shape {img.shape}")
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["B", "G", "R"], 4: ["A", "B", "G", "R"]}[c]
    # channel data in file order must be alphabetical; map to array indices
    chan_idx = {1: [0], 3: [2, 1, 0], 4: [3, 2, 1, 0]}[c]
    ptype = _HALF if half else _FLOAT
    dt = _PT_DTYPE[ptype]
    data = img.astype(dt)

    hdr = struct.pack("<ii", _MAGIC, _VERSION)
    hdr += _attr(b"channels", b"chlist", _chlist(names, ptype))
    hdr += _attr(b"compression", b"compression", struct.pack("<B", ZIP_COMPRESSION))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr += _attr(b"dataWindow", b"box2i", box)
    hdr += _attr(b"displayWindow", b"box2i", box)
    hdr += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    hdr += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    hdr += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    hdr += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    hdr += b"\x00"  # end of header

    n_blocks = (h + 15) // 16
    blocks = []
    for b in range(n_blocks):
        y0 = b * 16
        y1 = min(y0 + 16, h)
        # per scanline: channels in file order, each w pixels contiguous
        rows = []
        for y in range(y0, y1):
            for ci in chan_idx:
                rows.append(data[y, :, ci].tobytes())
        raw = b"".join(rows)
        comp = _zip_predict_encode(raw)
        if len(comp) >= len(raw):
            comp = raw
        blocks.append(struct.pack("<ii", y0, len(comp)) + comp)

    offset_table_size = 8 * n_blocks
    base = len(hdr) + offset_table_size
    offsets = []
    acc = base
    for blk in blocks:
        offsets.append(acc)
        acc += len(blk)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for blk in blocks:
            f.write(blk)


# ---------------------------------------------------------------- read


def _read_cstr(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_header(buf: bytes) -> Tuple[Dict, int]:
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    if version & (0x800 | 0x1000):
        raise NotImplementedError("deep/multi-part EXR not supported")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        name, pos = _read_cstr(buf, pos)
        typ, pos = _read_cstr(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size
    return attrs, pos + 1


def _parse_chlist(payload: bytes) -> List[Tuple[str, int]]:
    chans = []
    pos = 0
    while payload[pos] != 0:
        name, pos = _read_cstr(payload, pos)
        (ptype,) = struct.unpack_from("<i", payload, pos)
        pos += 16  # type + pLinear/reserved + samplings
        chans.append((name, ptype))
    return chans


def load_exr(path: str) -> np.ndarray:
    """Read a scanline EXR -> float32 (H, W, C). Channels ordered R,G,B,A
    first (when present), remaining channels alphabetically after."""
    with open(path, "rb") as f:
        buf = f.read()
    attrs, pos = _parse_header(buf)
    chans = _parse_chlist(attrs["channels"][1])  # file order (alphabetical)
    comp = attrs["compression"][1][0]
    if comp not in _BLOCK_LINES:
        raise NotImplementedError(f"EXR compression {comp} not supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    if "displayWindow" in attrs and attrs["displayWindow"][1] != attrs["dataWindow"][1]:
        raise NotImplementedError(
            "EXR with dataWindow != displayWindow not supported"
        )
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    if not (0 < w <= 65536 and 0 < h <= 65536):
        raise ValueError(f"EXR: malformed data window {w}x{h}")
    lines_per_block = _BLOCK_LINES[comp]
    n_blocks = (h + lines_per_block - 1) // lines_per_block

    line_bytes = sum(_PT_SIZE[pt] for _, pt in chans) * w
    out = {name: np.empty((h, w), _PT_DTYPE[pt]) for name, pt in chans}

    pos += 8 * n_blocks  # skip offset table; blocks are sequential
    for _ in range(n_blocks):
        by, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        payload = buf[pos : pos + size]
        pos += size
        if not (y0 <= by <= y1) or size < 0 or len(payload) != size:
            raise ValueError("EXR: malformed scanline block header")
        ystart = by - y0
        n_lines = min(lines_per_block, h - ystart)
        raw_len = line_bytes * n_lines
        if comp == NO_COMPRESSION or size == raw_len:
            raw = payload
        elif comp in (ZIPS_COMPRESSION, ZIP_COMPRESSION):
            raw = _zip_predict_decode(payload, raw_len)
        else:  # RLE
            raw = _rle_decode(payload, raw_len)
        off = 0
        for ly in range(n_lines):
            for name, pt in chans:
                nb = _PT_SIZE[pt] * w
                out[name][ystart + ly] = np.frombuffer(
                    raw, _PT_DTYPE[pt], count=w, offset=off
                )
                off += nb

    order = [n for n in ("R", "G", "B", "A") if n in out]
    order += sorted(n for n in out if n not in ("R", "G", "B", "A"))
    planes = [out[n].astype(np.float32) for n in order]
    return np.stack(planes, axis=-1)


# --------------------------------------------------------- unified API


def load_image(path: str) -> np.ndarray:
    """Load an image as float32 (H, W, C). EXR via the built-in codec;
    LDR formats via imageio, scaled to [0,1] (no gamma conversion — the
    caller applies **2.2 like reference example.py:18)."""
    if path.lower().endswith(".exr"):
        return load_exr(path)
    import imageio.v3 as iio

    img = np.asarray(iio.imread(path))
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, u8: np.ndarray) -> None:
    """Write an 8-bit (H, W) or (H, W, C) array, C in 1-4 (gray, gray +
    alpha, RGB, RGBA), as a PNG: every row with filter 0, one IDAT chunk."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8:
        raise TypeError(f"save_png: uint8 expected, got {u8.dtype}")
    if u8.ndim == 2:
        u8 = u8[..., None]
    if u8.ndim != 3 or u8.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"save_png: unsupported shape {u8.shape}")
    h, w, c = u8.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)  # a filter byte (0) a row
    rows[:, 1:] = u8.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def save_image(path: str, img: np.ndarray) -> None:
    """Save float (H, W[, C]) image. EXR keeps HDR values; LDR formats are
    clipped to [0,1] and quantized to 8-bit (sRGB handling is the caller's):
    PNG by save_png, other formats by imageio."""
    img = np.asarray(img)
    if path.lower().endswith(".exr"):
        save_exr(path, img)
        return
    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if path.lower().endswith(".png"):
        save_png(path, u8)
        return
    import imageio.v3 as iio

    iio.imwrite(path, u8)
