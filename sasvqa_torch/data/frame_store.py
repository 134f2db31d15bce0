"""HDF5 frame store + vidmapping (counterpart of
sasvqa_tpu/data/frame_store.py).

File-compatible with the reference store: one dataset
``"sampled_frames"`` of shape (num_videos, K, 3*H*W) float32 holding
flattened CHW frames, plus ``vidmapping.json`` {video_id: row}
(reference: src/preprocessing/extract_features.py:77-97,
src/datasets/dataset_base.py:104, dataset_video_qa.py:53-56).  The reader
converts CHW -> HWC on the host: the models take NHWC pixels.

``h5py`` is imported only where a store is opened (:func:`_open_h5`), so
importing this module needs no h5py.  Without h5py, frames reach the task
loop through any object with :class:`FrameStoreReader`'s methods
(``shape`` and ``read_frames_nhwc``), passed as ``open_store``;
:class:`MemoryFrameStores` is such a pair of writer and reader over host
memory.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from sasvqa_torch.utils.basic import load_json, save_json

DATASET_NAME = "sampled_frames"


def _open_h5(path: str, mode: str):
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "reading or writing an HDF5 frame store needs the h5py package; "
            "without it, pass the task loop an in-memory reader with "
            "FrameStoreReader's methods (open_store=...)") from e
    return h5py.File(path, mode)


class FrameStoreWriter:
    def __init__(self, h5_path: str, num_videos: int, num_frames: int,
                 img_hw: int):
        os.makedirs(os.path.dirname(os.path.abspath(h5_path)), exist_ok=True)
        self._f = _open_h5(h5_path, "w")
        self._ds = self._f.create_dataset(
            DATASET_NAME, (num_videos, num_frames, 3 * img_hw * img_hw),
            dtype="float32")
        self.img_hw = img_hw
        self.num_frames = num_frames

    def write(self, row: int, frames_chw: np.ndarray) -> None:
        """frames_chw: (K, 3, H, W) or (K, 3*H*W) float32."""
        self._ds[row] = frames_chw.reshape(self.num_frames, -1)

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FrameStoreReader:
    """Lazy per-row reads.  The handle opens at first use and reopens in
    a forked process (HDF5 handles shared across fork corrupt reads); a
    pickled reader (a collation worker's copy) carries the path only."""

    def __init__(self, h5_path: str):
        self._path = h5_path
        self._f: Optional[Any] = None
        self._pid: Optional[int] = None

    def __getstate__(self):
        return {"_path": self._path, "_f": None, "_pid": None}

    def _ds(self):
        if self._f is None or self._pid != os.getpid():
            self._f = _open_h5(self._path, "r")
            self._pid = os.getpid()
        return self._f[DATASET_NAME]

    @property
    def shape(self):
        return self._ds().shape

    def read_frames_nhwc(self, row: int, frame_inds) -> np.ndarray:
        """Selected frames of one video -> (T, H, W, 3) float32, reading
        only those frames.  ``frame_inds`` may be unsorted and repeat;
        h5py wants increasing unique indices, so the read is
        unique-sorted and re-gathered."""
        inds = np.asarray(frame_inds, dtype=np.int64).reshape(-1)
        ds = self._ds()
        k, d = ds.shape[1], ds.shape[2]
        u, inv = np.unique(inds, return_inverse=True)
        flat = np.asarray(ds[row] if len(u) == k else ds[row, u])
        hw = int(round((d // 3) ** 0.5))
        frames = np.ascontiguousarray(
            flat.reshape(len(u), 3, hw, hw).transpose(0, 2, 3, 1))
        return frames[inv]

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class MemoryFrameStores:
    """Frame stores in host memory, for a machine without h5py.
    :meth:`writer` takes :class:`FrameStoreWriter`'s arguments and keeps
    the rows it is given under the store's path (nothing is written to
    disk); :meth:`open_store` reads a kept store back with
    :class:`FrameStoreReader`'s methods and values."""

    def __init__(self):
        self.rows: Dict[str, np.ndarray] = {}

    def writer(self, h5_path: str, num_videos: int, num_frames: int,
               img_hw: int) -> "_MemoryWriter":
        rows = np.zeros((num_videos, num_frames, 3 * img_hw * img_hw),
                        np.float32)
        self.rows[h5_path] = rows
        return _MemoryWriter(rows)

    def open_store(self, h5_path: str) -> "_MemoryReader":
        return _MemoryReader(self.rows[h5_path])


class _MemoryWriter:
    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def write(self, row: int, frames_chw: np.ndarray) -> None:
        self.rows[row] = frames_chw.reshape(self.rows.shape[1], -1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class _MemoryReader:
    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.shape = rows.shape

    def read_frames_nhwc(self, row: int, frame_inds) -> np.ndarray:
        inds = np.asarray(frame_inds, dtype=np.int64).reshape(-1)
        hw = int(round((self.shape[2] // 3) ** 0.5))
        return np.ascontiguousarray(self.rows[row, inds].reshape(
            len(inds), 3, hw, hw).transpose(0, 2, 3, 1))


class LazyVideoFrames:
    """A frame-store row that gathers lazily: indexes like the eager
    ``(K, H, W, 3)`` array collators gather from (``vid[inds] -> (T, H, W,
    3)`` float32), but reads only the selected frames."""

    __slots__ = ("store", "row", "shape")

    ndim = 4

    def __init__(self, store: FrameStoreReader, row: int):
        _, k, d = store.shape
        hw = int(round((d // 3) ** 0.5))
        self.store = store
        self.row = int(row)
        self.shape = (k, hw, hw, 3)

    def __getitem__(self, frame_inds) -> np.ndarray:
        return self.store.read_frames_nhwc(self.row, frame_inds)


def save_vidmapping(video_ids: List[str], path: str) -> Dict[str, int]:
    mapping = {vid: i for i, vid in enumerate(video_ids)}
    save_json(mapping, path)
    return mapping


def load_vidmapping(path: str) -> Dict[str, int]:
    return load_json(path)
