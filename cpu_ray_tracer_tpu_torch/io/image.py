"""Texture image loading (host side, numpy and the standard library).

Same contract as the JAX package's `cpu_ray_tracer_tpu/io/image.py`, which
reproduces the reference's stb_image path (template/texture.h:15-39):
decode to 8 bits, expand greyscale to RGB, drop alpha, return float32 in
[0, 1].  The "HDR" skydome goes through the same 8-bit quantisation.

PNG is decoded here with `zlib` and numpy, so the port needs no imaging
library: 8-bit greyscale, grey+alpha, RGB and RGBA, non-interlaced, all
five scanline filter types.  `write_png` encodes a rendered frame (8-bit
RGB, filter type 0) the same way.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def load_texture_image(path: str) -> np.ndarray:
    """Returns float32 [H, W, 3] in [0, 1]."""
    if path.lower().endswith(".hdr"):
        rgb = _load_radiance_hdr(path)
        # stb would LDR-clamp: quantize to 8 bits like the reference.
        rgb = np.round(np.clip(rgb, 0.0, 1.0) * 255.0) / 255.0
        return rgb.astype(np.float32)
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: only .png and .hdr textures are supported")
    arr = decode_png(path)
    if arr.shape[-1] <= 2:  # greyscale (+ alpha) expands to RGB
        arr = np.repeat(arr[..., :1], 3, axis=-1)
    return arr[..., :3].astype(np.float32) / 255.0


def decode_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to uint8 [H, W, C]
    (C = 1 grey, 2 grey+alpha, 3 RGB, 4 RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length  # length, type, body, CRC
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
            f"interlace {interlace})"
        )
    channels = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(height, 1 + width * channels)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(height, width, channels))


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Write uint8 [H, W, 3] as an 8-bit RGB PNG (no filtering)."""
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png: expected uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(kinds: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec 9.2) for 8-bit samples.

    Pixel (y, x) depends on its left, upper and upper-left neighbours, so
    the pixels of one anti-diagonal x + y = k are independent: each
    diagonal is one vectorised step, W + H - 1 steps in all."""
    if np.any(kinds > 4):
        raise ValueError(f"bad PNG filter type {int(kinds.max())}")
    h, w, c = filtered.shape
    out = np.zeros((h + 1, w + 1, c), np.int32)  # zero row above, column left
    filt = filtered.astype(np.int32)
    kinds = kinds.astype(np.int32)
    for k in range(h + w - 1):
        ys = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        xs = k - ys
        a = out[ys + 1, xs]  # left
        b = out[ys, xs + 1]  # up
        cc = out[ys, xs]  # up-left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
        kind = kinds[ys][:, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [a, b, (a + b) >> 1, paeth],
            default=0,
        )
        out[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def _load_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance .hdr (RGBE) reader, RLE and flat scanlines."""
    with open(path, "rb") as f:
        line = f.readline()
        if not line.startswith(b"#?"):
            raise ValueError(f"{path}: not a Radiance HDR file")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"{path}: unsupported HDR orientation {dims}")
        h, w = int(dims[1]), int(dims[3])
        data = np.zeros((h, w, 4), np.uint8)
        for y in range(h):
            head = f.read(4)
            if len(head) < 4:
                raise ValueError("truncated HDR")
            if head[0] == 2 and head[1] == 2 and (head[2] << 8 | head[3]) == w:
                # new-style RLE: each channel run-length encoded
                for c in range(4):
                    x = 0
                    while x < w:
                        n = f.read(1)[0]
                        if n > 128:
                            data[y, x : x + n - 128, c] = f.read(1)[0]
                            x += n - 128
                        else:
                            buf = np.frombuffer(f.read(n), np.uint8)
                            data[y, x : x + n, c] = buf
                            x += n
            else:
                row = head + f.read(4 * w - 4)
                data[y] = np.frombuffer(row, np.uint8).reshape(w, 4)
        rgbe = data.astype(np.float32)
        exp = np.ldexp(1.0, data[..., 3].astype(np.int32) - 136)  # 128+8
        rgb = rgbe[..., :3] * exp[..., None]
        rgb[data[..., 3] == 0] = 0.0
        return rgb
