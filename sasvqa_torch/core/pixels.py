"""Host wire formats for pixel staging: uint8 and bf16.

Counterpart of sasvqa_tpu/core/pixels.py.  Frame stores hold
CLIP-normalized floats ``x = (u/255 - mean_c) / std_c`` of uint8 frames
``u``; :func:`quantize_u8` inverts that affine on the host and
:func:`dequantize` re-applies it on the device in the same f32 op order
(u8 -> f32, /255, -mean, /std), so on-grid frames come back bit-equal.

numpy has no bfloat16, so bf16-staged pixels travel as their bit
patterns in ``uint16`` arrays (:func:`bf16_bits`, rounded to nearest even
as ``ml_dtypes`` rounds) and become ``torch.bfloat16`` tensors in
:func:`host_tensor`.  No other batch leaf is ``uint16``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

# quantize: u = rint(x * 255*std + 255*mean), the exact inverse of the
# store's (u/255 - mean)/std
_Q_SCALE = (255.0 * CLIP_STD).astype(np.float32)
_Q_BIAS = (255.0 * CLIP_MEAN).astype(np.float32)


def quantize_u8(frames: np.ndarray) -> np.ndarray:
    """Normalized float frames ``(..., 3)`` -> uint8 wire format.

    Exact on the uint8 grid; off-grid values round to the nearest grid
    point and out-of-range values clip to [0, 255]."""
    q = frames * _Q_SCALE + _Q_BIAS
    np.rint(q, out=q)
    np.clip(q, 0.0, 255.0, out=q)
    return q.astype(np.uint8)


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 values -> the bit patterns (``uint16``) of their bf16
    roundings: to nearest, ties to even; a NaN becomes the quiet NaN of
    its sign (0x7FC0 | sign), as ``ml_dtypes.bfloat16`` casts."""
    x = np.asarray(x, np.float32)
    bits = x.view(np.uint32)
    lsb = (bits >> np.uint32(16)) & np.uint32(1)
    out = ((bits + np.uint32(0x7FFF) + lsb) >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        sign = (bits[nan] >> np.uint32(16)).astype(np.uint16) & np.uint16(0x8000)
        out[nan] = sign | np.uint16(0x7FC0)
    return out


def host_tensor(x) -> torch.Tensor:
    """A host batch leaf as a CPU tensor sharing its memory: ``uint16``
    arrays (bf16 bit patterns, :func:`bf16_bits`) as ``torch.bfloat16``,
    every other array in its own dtype; tensors pass through."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.ascontiguousarray(x)
    if x.dtype == np.uint16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def dequantize(pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """uint8 wire frames -> normalized pixels in ``dtype``, computed in
    f32 in the store's op order before the final cast."""
    mean, std = _normalize_consts(pixel_values.device)
    x = pixel_values.to(torch.float32) / np.float32(255.0)
    return ((x - mean) / std).to(dtype)


@functools.lru_cache(maxsize=None)
def _normalize_consts(dev: torch.device):
    """CLIP's mean and std on ``dev``, copied there once: a copy from
    host memory inside a forward would stop a CUDA graph's capture."""
    return (torch.from_numpy(CLIP_MEAN).to(dev),
            torch.from_numpy(CLIP_STD).to(dev))


def maybe_dequantize(pixel_values: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Dequantize u8-staged pixels; float pixels pass through unchanged."""
    if pixel_values.dtype == torch.uint8:
        return dequantize(pixel_values, dtype)
    return pixel_values
