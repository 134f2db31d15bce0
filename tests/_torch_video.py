"""Uncompressed AVI files written with nothing but the standard library
and numpy, for decode tests and runs on machines without cv2's writer.

One video stream of 24-bit BI_RGB frames (top-down BGR rows, a negative
``biHeight``, each row padded to 4 bytes; chunks ``00db``) with an
``idx1`` index: the layout libavformat's AVI demuxer and cv2 read as raw
video.  (cv2's FFmpeg reader corrupts its heap on bottom-up rows, which
libavformat flips with a negative line size.)
"""

from __future__ import annotations

import struct

import numpy as np


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(kind: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", kind + payload)


def write_raw_avi(path: str, frames_rgb: np.ndarray, fps: int = 10) -> str:
    """Write (N, H, W, 3) uint8 RGB frames to ``path`` as an uncompressed
    AVI at ``fps``; returns the path.  The decoded frames equal the
    input bit for bit."""
    frames_rgb = np.asarray(frames_rgb, dtype=np.uint8)
    n, h, w, c = frames_rgb.shape
    if c != 3 or n < 1:
        raise ValueError(f"need (N>=1, H, W, 3) frames, got "
                         f"{frames_rgb.shape}")
    stride = (w * 3 + 3) // 4 * 4
    size = stride * h
    avih = struct.pack("<10I4I", 1_000_000 // fps, size * fps, 0, 0x10, n,
                       0, 1, size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"\0\0\0\0", 0, 0, 0,
                       0, 1, fps, 0, n, size, -1, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + _list(
        b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)))

    rows = np.zeros((h, stride), np.uint8)
    chunks, index = [], []
    offset = 4                      # from the 'movi' fourcc
    for frame in frames_rgb:
        rows[:, :w * 3] = frame[:, :, ::-1].reshape(h, w * 3)   # BGR
        data = _chunk(b"00db", rows.tobytes())
        index.append(struct.pack("<4sIII", b"00db", 0x10, offset, size))
        chunks.append(data)
        offset += len(data)
    movi = _list(b"movi", b"".join(chunks))
    body = b"AVI " + hdrl + movi + _chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return path
