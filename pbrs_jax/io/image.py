"""Image I/O: self-contained PNG and OpenEXR writers/readers.

The reference writes EXR via the `exr` crate and PNG via `png`
(reference src/main.rs:28-53). Neither needs a library here: `write_exr`
emits uncompressed single-part scanline OpenEXR 2.0 — enough for float32
RGB, readable by any EXR tool and by `read_exr` below — and the PNG codec
is zlib plus the five scanline filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .. import radiometry

_EXR_MAGIC = 0x01312F76
_FLOAT = 2  # OpenEXR pixel type


def _attr(name: str, type_name: str, payload: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_name.encode() + b"\0"
        + struct.pack("<i", len(payload)) + payload
    )


def write_exr(path: str, image: np.ndarray) -> None:
    """Write [H,W,3] float32 linear RGB as uncompressed scanline EXR."""
    img = np.asarray(image, np.float32)
    h, w, _ = img.shape

    chlist = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, required by the format
        chlist += name + b"\0" + struct.pack("<iiii", _FLOAT, 0, 1, 1)
    chlist += b"\0"

    header = b""
    header += _attr("channels", "chlist", chlist)
    header += _attr("compression", "compression", b"\0")  # none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\0")  # increasing Y
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"  # end of header

    preamble = struct.pack("<Ii", _EXR_MAGIC, 2) + header
    table_start = len(preamble)
    offsets_size = 8 * h
    line_bytes = 8 + 3 * 4 * w  # y + size prefix + 3 channels of float32
    data_start = table_start + offsets_size

    offsets = [data_start + i * line_bytes for i in range(h)]
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # channel order B, G, R
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an EXR written by `write_exr` (uncompressed float RGB)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic, _version = struct.unpack_from("<Ii", raw, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while raw[pos] != 0:
        name_end = raw.index(b"\0", pos)
        name = raw[pos:name_end].decode()
        pos = name_end + 1
        type_end = raw.index(b"\0", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        attrs[name] = raw[pos:pos + size]
        pos += size
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    pos += 8 * h  # skip offset table
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(h):
        y, size = struct.unpack_from("<ii", raw, pos)
        pos += 8
        row = np.frombuffer(raw, np.float32, count=3 * w, offset=pos)
        pos += size
        img[y, :, 2] = row[:w]
        img[y, :, 1] = row[w:2 * w]
        img[y, :, 0] = row[2 * w:]
    return img


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray, gamma: bool = True) -> None:
    """sqrt-gamma + u8 PNG, matching the reference PNG path.
    [ref: src/main.rs:28-40, radiometry gamma_encode]"""
    img = np.asarray(image, np.float32)
    if gamma:
        img = np.sqrt(np.maximum(img, 0.0))
    u8 = radiometry.to_u8(img)
    h, w = u8.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           u8.reshape(h, w * 3)], axis=1)  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters -> [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along each byte lane
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.int32)])
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)
            cur = cur[:stride] & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential in x
            cur = [0] * stride
            ln, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(cur, np.int32)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Non-interlaced 8/16-bit gray, RGB, palette or alpha PNG ->
    float32 [H, W, 3] in [0, 1] (alpha dropped, gray replicated)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, palette, hdr = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace or ctype not in _PNG_CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, color "
                         f"type {ctype}, interlace {interlace})")
    chans = _PNG_CHANNELS[ctype]
    bpp = chans * depth // 8
    rows = _png_unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        px = rows.reshape(h, w * chans, 2).astype(np.float32)
        px = (px[..., 0] * 256.0 + px[..., 1]) / 65535.0
    else:
        px = rows.astype(np.float32) / 255.0
    px = px.reshape(h, w, chans)
    if ctype == 3:
        return palette[rows.reshape(h, w)].astype(np.float32) / 255.0
    if chans <= 2:  # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def load_image(path: str) -> np.ndarray:
    """Texture / environment image -> float32 [H, W, 3]: PNG (display
    values in [0, 1]) or OpenEXR (linear). Other formats go through PIL
    where it is installed."""
    low = path.lower()
    if low.endswith(".png"):
        return read_png(path)
    if low.endswith(".exr"):
        return read_exr(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(f"{path}: only PNG and EXR images are read without "
                         "PIL") from e
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
