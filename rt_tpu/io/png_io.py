"""PNG output and image decoding.

Replaces the reference's use of the `image` crate (PNG/JPEG/WebP decode at
camera.rs:62-81, texture.rs:89-92).  Decoding happens on host and lands in
f32[H,W,3] arrays in [0,1] — the SoA device format — instead of the
reference's AoS ``Vec<(x, y, Vec3)>`` (24+ B/px; camera.rs:56-60).

PNG goes through the standard library (``zlib`` + ``struct``): writing
8-bit RGB, reading 8-bit grey/RGB with or without alpha, non-interlaced,
all five scanline filters.  Other formats (JPEG/WebP textures, palette or
16-bit PNGs) need PIL.
"""

from __future__ import annotations

import io as _io
import struct
import zlib

import numpy as np

from rt_tpu import color as color_mod

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Colour type -> channels (8-bit grey, RGB, grey + alpha, RGBA).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """u8[H,W,3] -> PNG bytes (filter 0 on every scanline)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (
        PNG_SIGNATURE
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline filter (PNG spec §9); arrays are int32 rows."""
    if kind == 0:
        return line
    if kind == 2:
        return (line + prev) & 0xFF
    out = line.copy()
    if kind == 1:
        for i in range(bpp, len(out)):
            out[i] = (out[i] + out[i - bpp]) & 0xFF
        return out
    if kind == 3:
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
        return out
    if kind == 4:
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            up_left = prev[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(left, prev[i], up_left)) & 0xFF
        return out
    raise ValueError(f"bad PNG filter type {kind}")


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> u8[H,W,C] (C = 1, 2, 3 or 4 as stored).

    Raises NotImplementedError for what the stdlib path does not read
    (palette, 16-bit or interlaced images)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    header = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise NotImplementedError(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace}: only 8-bit non-interlaced grey/RGB(A) is decoded "
            "without PIL"
        )
    ch = _CHANNELS[ctype]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1).astype(np.int32)
    out = np.empty((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        prev = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, ch)
        out[y] = prev
    return out.astype(np.uint8).reshape(h, w, ch)


def write_png(path: str, image_linear: np.ndarray, gamma: bool = True) -> None:
    """Write a linear f32[H,W,3] image as 8-bit PNG (gamma-corrected by
    default, like the reference's final outputs)."""
    arr = np.asarray(image_linear, np.float32)
    rgb = np.asarray(color_mod.to_u8_gamma(arr) if gamma else color_mod.to_u8(arr))
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _to_rgb_f32(pixels: np.ndarray) -> np.ndarray:
    """u8[H,W,C] -> f32[H,W,3] in [0,1]; alpha dropped, grey replicated
    (what PIL's convert("RGB") does)."""
    if pixels.shape[2] in (1, 2):
        pixels = np.repeat(pixels[:, :, :1], 3, axis=2)
    return pixels[:, :, :3].astype(np.float32) / 255.0


def load_image(path_or_bytes) -> np.ndarray:
    """Decode an image file (PNG/JPEG/WebP/...) to f32[H,W,3] in [0,1].

    Reference analog: ``Image::from(DynamicImage)`` (camera.rs:62-81) —
    channels scaled by 1/255, no gamma handling (the reference treats texel
    values as linear; replicated for parity).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    if data.startswith(PNG_SIGNATURE):
        try:
            return _to_rgb_f32(decode_png(data))
        except NotImplementedError:
            pass  # palette / 16-bit / interlaced: PIL below
    try:
        from PIL import Image
    except ImportError:
        kind = "PNG" if data.startswith(PNG_SIGNATURE) else "non-PNG"
        raise ImportError(
            f"decoding this {kind} image ({data[:8]!r}...) needs PIL, which "
            "is not installed"
        ) from None
    img = Image.open(_io.BytesIO(data)).convert("RGB")
    return np.asarray(img, np.float32) / 255.0
