"""Image output: tonemapped PNG + Radiance HDR (.hdr) + raw .npy.

The reference snapshots its float accumulator to EXR via FreeImage
(``Application.hpp:324-343``); this environment has no EXR codec, so the
HDR path writes Radiance RGBE (.hdr) — same purpose (lossless-ish float
radiance dump), self-contained writer.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray, exposure: float = 1.0,
            gamma: float = 2.2) -> np.ndarray:
    """Simple exposure + gamma to 8-bit (the blit shader clamps to LDR,
    ``render.frag:33-36``; we add gamma since we skip GL's sRGB path)."""
    x = np.clip(np.asarray(img, np.float32) * exposure, 0.0, 1.0)
    x = x ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img: np.ndarray, exposure: float = 1.0) -> None:
    """Tonemapped 8-bit RGB PNG, written with zlib (no image library)."""
    px = tonemap(img, exposure)
    h, w, _ = px.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),      # filter: none
                          px.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def load_image_rgba(source) -> np.ndarray:
    """Decode an image file (path or file-like) to f32[H, W, 4] in
    [0, 1].  Decoding needs Pillow, which is optional: without it this
    raises an ImportError that names the package."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "decoding image textures needs the 'Pillow' package "
            "(import PIL); install it or use untextured scenes") from e
    return np.asarray(Image.open(source).convert("RGBA"),
                      np.float32) / 255.0


def save_hdr(path: str, img: np.ndarray) -> None:
    """Write Radiance RGBE (.hdr), flat (non-RLE) scanlines."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = np.maximum(img.max(axis=-1), 1e-32)
    exp = np.ceil(np.log2(maxc)).astype(np.int32)
    mant = img / (2.0 ** exp[..., None])
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(mant * 256.0, 0, 255).astype(np.uint8)
    rgbe[..., 3] = (exp + 128).astype(np.uint8)
    zero = maxc < 1e-30
    rgbe[zero] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Read back flat RGBE written by save_hdr (round-trip testing)."""
    with open(path, "rb") as f:
        data = f.read()
    # find resolution line
    idx = data.index(b"\n\n") + 2
    nl = data.index(b"\n", idx)
    dims = data[idx:nl].split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(data[nl + 1:], np.uint8).reshape(h, w, 4)
    exp = rgbe[..., 3].astype(np.int32) - 128
    img = rgbe[..., :3].astype(np.float32) / 256.0 * (2.0 ** exp[..., None])
    img[rgbe[..., 3] == 0] = 0.0
    return img


def save_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, np.float32))
