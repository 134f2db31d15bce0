"""Video decoding through the native shim (counterpart of
sasvqa_tpu/data/video_decode.py).

A ctypes binding over ``native/libvideodecode.so`` (libavformat, libavcodec,
libswscale; build it with ``make -C native``), falling back to cv2 when the
library does not load.  The library is loaded at the first decode, not at
import; cv2 is imported only by :func:`_import_cv2`, where a video is read
without the shim.  When neither loads, opening a video raises an error that
names both causes.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native", "libvideodecode.so"),
    "libvideodecode.so",
]


@functools.lru_cache(maxsize=None)
def _load_lib():
    """-> (the bound library or None, why it did not load)."""
    errors = []
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
        except OSError as e:
            errors.append(str(e))
            continue
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        lib.vd_info.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64)]
        lib.vd_read_frames.restype = ctypes.c_int
        lib.vd_read_frames.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        try:
            lib.vd_read_frames_seq.restype = ctypes.c_int
            lib.vd_read_frames_seq.argtypes = lib.vd_read_frames.argtypes
        except AttributeError:
            # a library built before the chunked-read API: iter_frames
            # falls back to one full read (make -C native to refresh)
            lib.vd_read_frames_seq = None
        lib.vd_read_window.restype = ctypes.c_int
        lib.vd_read_window.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        return lib, ""
    return None, "; ".join(errors)


def native_available() -> bool:
    return _load_lib()[0] is not None


def _import_cv2():
    """cv2, the fallback decoder."""
    import cv2
    return cv2


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class VideoDecoder:
    """Decode every ``interval``-th frame of a video to RGB uint8."""

    def __init__(self, path: str):
        self.path = path
        self._h = None
        self._lib, why = _load_lib()
        if self._lib is not None:
            self._h = self._lib.vd_open(path.encode())
            if not self._h:
                raise IOError(f"native decoder failed to open {path}")
            return
        try:
            _import_cv2()
        except ImportError as e:
            raise IOError(
                f"cannot decode {path}: the native shim did not load "
                f"({why}; build it with make -C native) and cv2 is not "
                f"installed ({e})") from e

    def info(self) -> Tuple[int, int, float, int]:
        """-> (width, height, fps, container nb_frames or 0)."""
        if self._h:
            w = ctypes.c_int()
            h = ctypes.c_int()
            fps = ctypes.c_double()
            n = ctypes.c_int64()
            self._lib.vd_info(self._h, ctypes.byref(w), ctypes.byref(h),
                              ctypes.byref(fps), ctypes.byref(n))
            return w.value, h.value, fps.value, int(n.value)
        cv2 = _import_cv2()
        cap = cv2.VideoCapture(self.path)
        out = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
               int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
               float(cap.get(cv2.CAP_PROP_FPS)),
               int(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
        cap.release()
        return out

    def _size(self, out_size):
        if out_size is None:
            w, h, _, _ = self.info()
            return w, h
        return out_size

    def read_frames(self, interval: int = 1, max_frames: int = 4096,
                    out_size: Optional[Tuple[int, int]] = None,
                    ) -> np.ndarray:
        """-> (N, H, W, 3) uint8 RGB frames."""
        w, h = self._size(out_size)
        if self._h:
            max_frames = self._cap_rows(interval, max_frames)
            buf = np.empty((max_frames, h, w, 3), dtype=np.uint8)
            n = self._lib.vd_read_frames(self._h, interval, max_frames, w, h,
                                         _ptr(buf))
            if n < 0:
                raise IOError(f"decode error {n} on {self.path}")
            return buf[:n].copy()
        return self._cv2_read(interval, max_frames, (w, h))

    def _cap_rows(self, interval: int, max_frames: int) -> int:
        """Bound the output buffer by the container's frame count when it
        is recorded (a 4096-row buffer of 1080p frames is ~25 GB).
        nb_frames is metadata and can undercount, so keep a slack of
        nb/16 (at least 8); unknown (0) keeps ``max_frames``."""
        _, _, _, nb = self.info()
        if nb <= 0:
            return max_frames
        return max(1, min(max_frames, -(-nb // interval) + max(8, nb // 16)))

    def iter_frames(self, interval: int = 1, chunk: int = 256,
                    max_frames: int = 4096,
                    out_size: Optional[Tuple[int, int]] = None):
        """Yield (n <= chunk, H, W, 3) uint8 RGB arrays from frame 0 on,
        so a long full-resolution video never exists whole in host
        memory.  The native path continues the stream across calls
        (``vd_read_frames_seq``, after a first ``vd_read_frames`` that
        rewinds the handle); the cv2 fallback keeps one capture."""
        w, h = self._size(out_size)
        remaining = self._cap_rows(interval, max_frames)
        if self._h and self._lib.vd_read_frames_seq:
            first = True
            while remaining > 0:
                n_req = min(chunk, remaining)
                buf = np.empty((n_req, h, w, 3), dtype=np.uint8)
                read = (self._lib.vd_read_frames if first
                        else self._lib.vd_read_frames_seq)
                first = False
                n = read(self._h, interval, n_req, w, h, _ptr(buf))
                if n < 0:
                    raise IOError(f"decode error {n} on {self.path}")
                if n == 0:
                    return
                remaining -= n
                # a fresh buffer every chunk: the view needs no copy
                yield buf[:n]
            return
        if self._h:  # a library without the seq API: one full read
            frames = self.read_frames(interval, max_frames, out_size)
            for i in range(0, len(frames), chunk):
                yield frames[i:i + chunk]
            return
        cv2 = _import_cv2()
        cap = cv2.VideoCapture(self.path)
        try:
            buf: list = []
            i = 0
            while remaining > 0:
                ok, frame = cap.read()
                if not ok:
                    break
                if i % interval == 0:
                    buf.append(_cv2_rgb(cv2, frame, (w, h)))
                    remaining -= 1
                    if len(buf) == chunk:
                        yield np.stack(buf)
                        buf = []
                i += 1
            if buf:
                yield np.stack(buf)
        finally:
            cap.release()

    def read_window(self, start_sec: float, end_sec: float,
                    interval: int = 1, max_frames: int = 4096,
                    out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """PTS-window selective decode -> (N, H, W, 3) uint8 RGB."""
        w, h = self._size(out_size)
        if self._h:
            buf = np.empty((max_frames, h, w, 3), dtype=np.uint8)
            n = self._lib.vd_read_window(
                self._h, float(start_sec), float(end_sec), interval,
                max_frames, w, h, _ptr(buf))
            if n < 0:
                raise IOError(f"window decode error {n} on {self.path}")
            return buf[:n].copy()
        return self._cv2_read_window(start_sec, end_sec, interval,
                                     max_frames, (w, h))

    def _cv2_read_window(self, start_sec, end_sec, interval, max_frames,
                         size):
        """cv2 fallback of ``vd_read_window`` (native/videodecode.cpp):
        frames with start_sec <= t <= end_sec, every ``interval``-th
        counted from the first in-window frame.  cv2's ffmpeg backend
        seeks to the nearest keyframe and decodes forward, so the seek is
        frame-accurate like the native backward seek."""
        cv2 = _import_cv2()
        cap = cv2.VideoCapture(self.path)
        cap.set(cv2.CAP_PROP_POS_MSEC, start_sec * 1e3)
        frames = []
        seen = 0
        while len(frames) < max_frames:
            t = cap.get(cv2.CAP_PROP_POS_MSEC) / 1e3  # next frame's PTS
            ok, frame = cap.read()
            if not ok or t > end_sec:
                break
            if t >= start_sec:
                if seen % interval == 0:
                    frames.append(_cv2_rgb(cv2, frame, size))
                seen += 1
        cap.release()
        if not frames:
            return np.empty((0, size[1], size[0], 3), dtype=np.uint8)
        return np.stack(frames)

    def _cv2_read(self, interval, max_frames, size):
        cv2 = _import_cv2()
        cap = cv2.VideoCapture(self.path)
        frames = []
        i = 0
        while len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if i % interval == 0:
                frames.append(_cv2_rgb(cv2, frame, size))
            i += 1
        cap.release()
        if not frames:
            return np.zeros((0, size[1], size[0], 3), dtype=np.uint8)
        return np.stack(frames)

    def close(self):
        if self._h:
            self._lib.vd_close(self._h)
            self._h = None

    def __del__(self):
        # a handle the caller never closed must not leak its three libav
        # contexts (file descriptors run out over a sweep of many videos)
        try:
            self.close()
        except Exception:  # interpreter teardown may have freed the lib
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _cv2_rgb(cv2, frame: np.ndarray, size) -> np.ndarray:
    """A cv2 BGR frame as RGB at ``size`` (w, h)."""
    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    if (frame.shape[1], frame.shape[0]) != tuple(size):
        frame = cv2.resize(frame, tuple(size))
    return frame


def decode_video(path: str, interval: int = 1, max_frames: int = 4096,
                 out_size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    with VideoDecoder(path) as dec:
        return dec.read_frames(interval, max_frames, out_size)
