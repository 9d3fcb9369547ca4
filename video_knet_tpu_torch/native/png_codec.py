"""The port's PNG reader and writer, with no PIL.

Counterpart of `video_knet_tpu/native/png_codec.py:read_png`. Python walks
the chunks (IHDR, PLTE, IDAT, IEND) and inflates the joined IDAT data with
the standard library's `zlib`; one C function (`png_codec.cpp`, built by
`build.py`) undoes the scanline filters into a numpy buffer. Both release
the GIL, so loader threads decode in parallel.

Read: bit depth 8 gray, gray + alpha, RGB, RGBA and palette (the index
plane, as `np.asarray(PIL.Image.open(p))` gives for mode P), and bit depth
16 of the same colour types (`uint16`, native byte order). An interlaced
PNG or a bit depth below 8 raises `ValueError` naming the file; nothing
falls back to another decoder.

Write: `uint8` gray and RGB, and `uint16` gray (what the datasets' GT and
the tools' outputs use), filter type 0 on every row.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

MAGIC = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    """Decode the PNG at `path` to [H, W] or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, path)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    from video_knet_tpu_torch.native.build import load_library

    if data[:8] != MAGIC:
        raise ValueError(f"{name}: not a PNG file")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if color not in _CHANNELS or depth not in (8, 16) or (color == 3 and depth != 8):
        raise ValueError(f"{name}: unsupported PNG (bit depth {depth}, colour type {color}); "
                         "8- and 16-bit gray, gray + alpha, RGB, RGBA and 8-bit palette only")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = bpp * width
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != (stride + 1) * height:
        raise ValueError(f"{name}: {len(raw)} inflated bytes for {height} rows of {stride}")
    out = np.empty(height * stride, np.uint8)
    rc = load_library().vk_png_unfilter(raw, len(raw), out.ctypes.data_as(ctypes.c_void_p),
                                        height, stride, bpp)
    if rc:
        raise ValueError(f"{name}: bad scanline filter (code {rc})")
    arr = out.view(">u2").astype(np.uint16) if depth == 16 else out
    return arr.reshape((height, width) if channels == 1 else (height, width, channels))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(arr: np.ndarray) -> bytes:
    """[H, W] uint8 / uint16 or [H, W, 3] uint8 -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.dtype == np.uint16 and arr.ndim == 2:
        depth, color, rows = 16, 0, arr.astype(">u2")
    elif arr.dtype == np.uint8 and (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        depth, color, rows = 8, 0 if arr.ndim == 2 else 2, arr
    else:
        raise ValueError(f"cannot write a PNG of dtype {arr.dtype} and shape {arr.shape}: "
                         "uint8 [H, W] / [H, W, 3] or uint16 [H, W] only")
    h, w = arr.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1).view(np.uint8)
    filtered = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (MAGIC + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(filtered.tobytes()))
            + _chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray) -> None:
    data = encode_png(arr)
    with open(path, "wb") as f:
        f.write(data)
