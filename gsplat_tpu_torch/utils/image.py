"""Minimal image IO: PNG through a tiny pure-python encoder (numpy and zlib,
no hard PIL dependency). A copy of `gsplat_tpu.utils.image`, so that the
port imports nothing of the JAX package: headless rendering writes images
to disk instead of a swapchain.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """img: (H, W, 3) float in [0,1] or uint8."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    h, w, c = arr.shape
    assert c == 3
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB/RGBA, non-interlaced). Returns (H,W,3)
    float32 in [0,1]. Falls back to PIL if the file uses other features."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload
            )
            if bit_depth != 8 or color_type not in (2, 6) or interlace:
                try:
                    from PIL import Image

                    im = np.asarray(Image.open(path).convert("RGB"))
                    return im.astype(np.float32) / 255.0
                except ImportError:
                    raise ValueError("unsupported PNG variant and PIL unavailable")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    nch = 3 if color_type == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for row in range(h):
        ft = raw[row * (stride + 1)]
        line = np.frombuffer(
            raw, np.uint8, count=stride, offset=row * (stride + 1) + 1
        ).copy()
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for i in range(nch, stride):
                line[i] = (line[i] + line[i - nch]) & 0xFF
        elif ft == 2:  # Up
            line = (line + prev) & 0xFF
        elif ft == 3:  # Average
            for i in range(stride):
                left = line[i - nch] if i >= nch else 0
                line[i] = (line[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - nch]) if i >= nch else 0
                b = int(prev[i])
                cc = int(prev[i - nch]) if i >= nch else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                line[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter {ft}")
        out[row] = line
        prev = line
    img = out.reshape(h, w, nch)[:, :, :3]
    return img.astype(np.float32) / 255.0
