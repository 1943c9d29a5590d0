"""24-bit BMP writer + thermal colormap: a numpy copy of lam_tpu/apps/bmp.py
(the reference's heat_to_bmp), byte-identical output.

BITMAPFILEHEADER + 40-byte BITMAPINFOHEADER, 24 bpp, bottom-up rows
padded to 4 bytes. The colormap is the reference's 4-segment
blue->green->red ramp:

    val = 4 * (T - min) / (max - min)
    r = clamp((val - 2) * 255);  g = clamp((2 - |val - 2|) * 255)
    b = clamp((2 - val) * 255)
"""

from __future__ import annotations

import os
import struct

import numpy as np

_FILE_HEADER = struct.Struct("<2sIHHI")
_INFO_HEADER = struct.Struct("<IiiHHIIiiII")


def colormap(values, min_val=0.0, max_val=100.0):
    """(..., ) float -> (..., 3) uint8 RGB, reference 4-segment ramp."""
    span = max_val - min_val
    if span <= 0:
        # degenerate range (a constant plate): everything maps to the
        # ramp's cold end instead of dividing by zero
        span = 1.0
    v = 4.0 * (np.asarray(values, dtype=np.float64) - min_val) / span
    r = np.clip(((v - 2.0) * 255.0).astype(np.int64), 0, 255)
    g = np.clip(((2.0 - np.abs(v - 2.0)) * 255.0).astype(np.int64), 0, 255)
    b = np.clip(((2.0 - v) * 255.0).astype(np.int64), 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def write_bmp(path, rgb):
    """Write an (H, W, 3) uint8 RGB array as a 24-bit BMP; row 0 of `rgb`
    lands at the BOTTOM of the image (positive-height bottom-up BMP)."""
    rgb = np.asarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError("expected (H, W, 3) RGB")
    row_stride = w * 3
    padded_stride = (row_stride + 3) // 4 * 4
    data_size = padded_stride * h
    offset = _FILE_HEADER.size + _INFO_HEADER.size
    header = _FILE_HEADER.pack(b"BM", offset + data_size, 0, 0, offset)
    info = _INFO_HEADER.pack(_INFO_HEADER.size, w, h, 1, 24, 0,
                             data_size, 0, 0, 0, 0)
    # BGR byte order, rows bottom-up == row 0 first
    bgr = rgb[:, :, ::-1]
    rows = np.zeros((h, padded_stride), dtype=np.uint8)
    rows[:, :row_stride] = bgr.reshape(h, row_stride)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(info)
        f.write(rows.tobytes())


def read_bmp(path):
    """Read back a 24-bit uncompressed BMP as (H, W, 3) uint8 RGB (row 0 =
    bottom)."""
    with open(path, "rb") as f:
        magic, _, _, _, offset = _FILE_HEADER.unpack(
            f.read(_FILE_HEADER.size))
        if magic != b"BM":
            raise ValueError(f"{path}: not a BMP")
        (_, w, h, _, bpp, comp, _, _, _, _, _) = \
            _INFO_HEADER.unpack(f.read(_INFO_HEADER.size))
        if bpp != 24 or comp != 0:
            raise ValueError(f"{path}: only 24bpp uncompressed supported")
        f.seek(offset)
        padded_stride = (w * 3 + 3) // 4 * 4
        raw = np.frombuffer(f.read(padded_stride * h), dtype=np.uint8)
    rows = raw.reshape(h, padded_stride)[:, : w * 3]
    return rows.reshape(h, w, 3)[:, :, ::-1]
