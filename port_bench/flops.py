"""Operations and bytes of GIT's work, from shapes alone.

Model FLOPs count the matrix products the inputs need: two per
multiply-add, the forward's products times three for a training step
(forward, and the two products of each backward), nothing recomputed.
Attention counts only the (row, column) pairs its mask lets through.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W):
989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Mapping, Sequence

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
BWD_OVER_FWD = 2.5


def tokens_per_frame(c: Mapping) -> int:
    v = c["vision_config"]
    return (v["image_size"] // v["patch_size"]) ** 2 + 1


def vision_fwd(c: Mapping, frames: int) -> float:
    """The image encoder over ``frames`` frames, with the patch
    embedding and GIT's visual projection."""
    v = c["vision_config"]
    d, f, p = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    t = tokens_per_frame(c)
    patch = 2.0 * (t - 1) * v["num_channels"] * p * p * d
    layer = 2.0 * t * d * (4 * d + 2 * f) + 4.0 * t * t * d
    proj = 2.0 * t * d * c["hidden_size"]
    return frames * (patch + v["num_hidden_layers"] * layer + proj)


def git_pairs(num_img: int, text_len: int, valid: int) -> int:
    """(row, column) pairs GIT's mask lets through for one sequence:
    image rows see the image, text row r the image and the valid text
    columns up to r."""
    causal = sum(min(r + 1, valid) for r in range(text_len))
    return num_img * num_img + text_len * num_img + causal


def text_fwd(c: Mapping, num_img: int, text_len: int,
             valid: Sequence[int], head_rows: int) -> float:
    """The text layers over [image; text] for each sequence (``valid``:
    its unpadded text length) and the LM head over ``head_rows``
    positions a sequence."""
    d, f = c["hidden_size"], c["intermediate_size"]
    s = num_img + text_len
    dense = 2.0 * s * d * (4 * d + 2 * f)
    total = 0.0
    for n in valid:
        total += c["num_hidden_layers"] * (
            dense + 4.0 * d * git_pairs(num_img, text_len, int(n)))
        total += 2.0 * head_rows * d * c["vocab_size"]
    return total


def git_train_micro(c: Mapping, frames_per_row: int, text_len: int,
                    valid: Sequence[int]) -> float:
    """Model FLOPs of one training micro-batch (one video a row)."""
    m = frames_per_row * tokens_per_frame(c)
    fwd = vision_fwd(c, frames_per_row * len(valid)) \
        + text_fwd(c, m, text_len, valid, text_len - 1)
    return 3.0 * fwd


def git_flash_bounds(c: Mapping, num_img: int, text_len: int,
                     valid: Sequence[int]) -> dict:
    """Least seconds of one forward (K1) and one backward (K2) launch of
    the GIT-mask attention over a batch: max(operations / peak, bytes /
    bandwidth).  Each input byte is read once and each output byte
    written once (bf16 tensors, f32 row statistics, int32 mask); the
    backward does 2.5 times the forward's operations."""
    h = c["num_attention_heads"]
    dh = c["hidden_size"] // h
    b, s = len(valid), num_img + text_len
    pairs = sum(git_pairs(num_img, text_len, int(n)) for n in valid)
    fwd_flops = 4.0 * dh * h * pairs
    t = b * h * s * dh * 2          # one bf16 (B, H, S, Dh) tensor
    lse = b * h * s * 4
    mask = b * text_len * 4
    fwd_bytes = 3 * t + mask + t + lse
    bwd_bytes = 5 * t + lse + mask + 3 * t
    return {
        "fwd": max(fwd_flops / PEAK_BF16_FLOPS, fwd_bytes / PEAK_BYTES_PER_S),
        "bwd": max(BWD_OVER_FWD * fwd_flops / PEAK_BF16_FLOPS,
                   bwd_bytes / PEAK_BYTES_PER_S)}
