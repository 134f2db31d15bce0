"""Offline stage A: video decode -> frame sampling -> HDF5 frame store
(counterpart of sasvqa_tpu/tools/extract_frames.py, with its CLI flags).

    python -m sasvqa_torch.tools.extract_frames \\
        --dataset msvd_qa --dataset_root ./dataset \\
        --sampling_strategy repr --K 16 --W 8

- decode through the native shim (data/video_decode.py) in one
  background thread with a bounded queue (4), so decode applies
  backpressure; the HF-processor geometry (shortest-edge bicubic resize
  and centre crop, through PIL) runs in that thread;
- ``repr`` (MDF) encodes every frame of a video with GIT-base's frozen
  vision tower in bf16 on the device and selects K frames there
  (sampling/mdf.py); a video is padded to a length bucket and clamped at
  2,048 frames, the padded semantics the selection is held to;
- ``uni`` and ``git6`` are index arithmetic on the host.

The store matches the reference's format: ``sampled_frames`` (num_videos,
K, 3*H*W) float32 CHW-flattened, and ``vidmapping.json``.  ``--platform
cpu`` runs on the CPU; the default is the GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.core.pixels import CLIP_MEAN, CLIP_STD
from sasvqa_torch.data.frame_store import (DATASET_NAME, FrameStoreWriter,
                                           _open_h5)
from sasvqa_torch.data.video_decode import VideoDecoder
from sasvqa_torch.models import convert as cv
from sasvqa_torch.models.clip import CLIPVisionEncoder
from sasvqa_torch.models.git import GIT_BASE
from sasvqa_torch.models.presets import _load_torch_state_dict
from sasvqa_torch.sampling.mdf import mdf_select_padded
from sasvqa_torch.utils.basic import load_json, save_json

BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _hf_resize_dims(h: int, w: int, size: int) -> Tuple[int, int]:
    """Shortest-edge target dims (HF ``get_resize_output_image_size``,
    default_to_square=False): the short edge becomes ``size``, the long
    edge scales by the same ratio, truncated toward zero."""
    short, long = (h, w) if h <= w else (w, h)
    new_short, new_long = size, int(size * long / short)
    return (new_short, new_long) if h <= w else (new_long, new_short)


def preprocess_frames(frames_u8: np.ndarray, img_size: int) -> np.ndarray:
    """(N, H, W, 3) uint8 RGB -> (N, S, S, 3) float32 normalised: the
    CLIPImageProcessor pipeline (shortest-edge bicubic resize through
    PIL, centre crop, rescale 1/255, CLIP mean/std)."""
    return normalize_frames(geometry_frames(frames_u8, img_size))


def geometry_frames(frames_u8: np.ndarray, img_size: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, S, S, 3) uint8: the resize and crop.
    Frames already S x S pass through (the bicubic resize would be the
    identity and the crop a no-op), so they need no PIL."""
    n, h, w = frames_u8.shape[:3]
    if (h, w) == (img_size, img_size):
        return frames_u8
    from PIL import Image
    nh, nw = _hf_resize_dims(h, w, img_size)
    top = (nh - img_size) // 2
    left = (nw - img_size) // 2
    out = np.empty((n, img_size, img_size, 3), np.uint8)
    for i in range(n):
        f = np.asarray(Image.fromarray(frames_u8[i]).resize(
            (nw, nh), Image.Resampling.BICUBIC))
        out[i] = f[top:top + img_size, left:left + img_size]
    return out


def normalize_frames(frames_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32, rescale 1/255 and CLIP mean/std."""
    out = frames_u8.astype(np.float32) / 255.0
    return (out - CLIP_MEAN) / CLIP_STD


def git6_indices(num_frames: int, clip_len: int, frame_sample_rate: int,
                 rng: np.random.Generator) -> np.ndarray:
    """GIT-VideoQA sampling: a random end index and a linspace of
    ``clip_len`` frames before it.  Videos shorter than
    clip_len * rate sample with repeats inside the real frame range (the
    reference's randint raises there)."""
    converted_len = int(clip_len * frame_sample_rate)
    end_idx = int(rng.integers(converted_len,
                               max(num_frames, converted_len + 1)))
    start_idx = end_idx - converted_len
    idx = np.linspace(start_idx, end_idx, num=clip_len)
    idx = np.clip(idx, start_idx, end_idx - 1).astype(np.int64)
    return np.clip(idx, 0, num_frames - 1)


def _uniform_centers(n: int, k: int) -> np.ndarray:
    """K frames at interval centres."""
    intv = n / k
    idx = [int(intv // 2 + i * intv) for i in range(k)]
    return np.clip(np.asarray(idx), 0, n - 1)


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


class MDFEncoder:
    """GIT-base's frozen vision tower (every token post-LN'd, no
    projection) in bf16 on ``device``, and MDF selection on its pooled
    features.  ``weights_path``: a local HF checkpoint, GIT
    (``git.image_encoder.vision_model.*``) or CLIP (``vision_model.*``);
    without one the tower keeps its seeded init (seed 0)."""

    def __init__(self, k: int, window: int, interval: int = 20,
                 weights_path: Optional[str] = None, img_size: int = 224,
                 device: DeviceLike = "cuda"):
        self.k, self.window, self.interval = k, window, interval
        self.device = resolve_device(device)
        vision_cfg = GIT_BASE.vision
        if img_size != vision_cfg.image_size:
            vision_cfg = dataclasses.replace(vision_cfg, image_size=img_size)
        self.tower = CLIPVisionEncoder(
            vision_cfg, dtype=torch.bfloat16, post_ln_all_tokens=True,
            with_projection=False)
        if weights_path:
            sd = _load_torch_state_dict(weights_path)
            prefix = ("git.image_encoder.vision_model"
                      if any(key.startswith("git.") for key in sd)
                      else "vision_model")
            report = cv.merge_pretrained(self.tower, cv.convert_clip_vision(
                sd, vision_cfg.num_layers, prefix=prefix, projection_key=""))
            LOGGER.info(f"MDF encoder: loaded {len(report['loaded'])} "
                        f"tensors from {weights_path}")
        self.tower.to(self.device).eval()

    def encode(self, frames: np.ndarray) -> torch.Tensor:
        """(N, S, S, 3) float32 -> pooled features (N, D) f32 on the
        device."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(frames)).to(
                self.device)
            return self.tower(x)[1].float()

    def pad(self, frames: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Clamp to the largest bucket and pad to a bucket -> (padded
        frames, n valid, resolved window)."""
        n = frames.shape[0]
        if n > BUCKETS[-1]:
            LOGGER.warning(
                f"MDF: clamping {n} decoded frames to the largest bucket "
                f"({BUCKETS[-1]}); raise --intv to cover longer videos at "
                "full span")
            frames = frames[:BUCKETS[-1]]
            n = BUCKETS[-1]
        w = max(n // self.interval, 1) if self.window == -1 else self.window
        padded = np.zeros((bucket_for(n),) + frames.shape[1:], frames.dtype)
        padded[:n] = frames
        return padded, n, w

    def __call__(self, frames: np.ndarray) -> Tuple[np.ndarray, bool]:
        """frames (N, S, S, 3) float32 -> ((K,) selected indices, whether
        the suppression search exhausted).  The adaptive window resolves
        on the true N before padding."""
        if frames.shape[0] == 0:
            return np.zeros((self.k,), np.int64), True
        padded, n, w = self.pad(frames)
        with torch.inference_mode():
            inds, exhausted = mdf_select_padded(
                self.encode(padded), n, self.k, w, self.interval)
            out = torch.cat([inds, exhausted.long()[None]]).cpu().numpy()
        return out[:-1], bool(out[-1])


def load_video_paths(dataset: str, dataset_root: str,
                     anno_path: str = "annotations") -> List[str]:
    """The unique video paths of the annotation splits."""
    droot = os.path.join(dataset_root, dataset)
    video_dir = os.path.join(droot, "video")
    seen, paths = set(), []
    for split in ("train", "val", "test"):
        anno = os.path.join(droot, anno_path, f"qa_{split}.json")
        if not os.path.exists(anno):
            continue
        for qa in load_json(anno):
            name = qa.get("video") or f"video{qa.get('video_id')}.mp4"
            if name not in seen:
                seen.add(name)
                paths.append(os.path.join(video_dir, name))
    return paths


def parse_shard(spec: Optional[str]) -> Optional[Tuple[int, int]]:
    """'i/N' -> (i, N); 'auto' -> this process's ``torch.distributed``
    rank and world size when a process group is initialised, else
    (0, 1)."""
    if not spec:
        return None
    if spec == "auto":
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    i, n = spec.split("/")
    i, n = int(i), int(n)
    if not 0 <= i < n:
        raise ValueError(f"--shard {spec!r}: need 0 <= i < N")
    return i, n


def _shard_suffix(shard: Optional[Tuple[int, int]]) -> str:
    return f".shard{shard[0]}of{shard[1]}" if shard else ""


def collect_shard_set(dirname: str, prefix: str,
                      suffix: str = "") -> Optional[List[str]]:
    """A complete ``{prefix}.shard{i}of{N}{suffix}`` set: the N paths in
    shard order, None when no shard file matches; FileNotFoundError on an
    incomplete or mixed-N set."""
    import glob
    import re
    spec = re.compile(r"\.shard(\d+)of(\d+)" + re.escape(suffix) + "$")
    found = {}
    for p in glob.glob(os.path.join(dirname,
                                    f"{prefix}.shard*of*{suffix}")):
        m = spec.search(p)
        if m:
            found[int(m.group(1))] = (p, int(m.group(2)))
    if not found:
        return None
    n = next(iter(found.values()))[1]
    missing = sorted(set(range(n)) - set(found))
    if missing or any(total != n for _, total in found.values()):
        raise FileNotFoundError(
            f"incomplete shard set for {prefix} under {dirname}: have "
            f"{sorted(found)}, expected 0..{n - 1} of {n} "
            f"(missing {missing})")
    return [found[i][0] for i in range(n)]


def decode_frames(path: str, img_size: int, interval: int) -> np.ndarray:
    """A video -> (N, S, S, 3) uint8: native-resolution decode in bounded
    chunks, each resized and centre-cropped as the HF processor does (a
    decode at S x S would squash the aspect ratio)."""
    with VideoDecoder(path) as dec:
        chunks = [geometry_frames(c, img_size)
                  for c in dec.iter_frames(interval=interval)]
    if not chunks:
        return np.zeros((0, img_size, img_size, 3), np.uint8)
    return np.concatenate(chunks)


def extract(video_paths: List[str], out_dir: str, args,
            shard: Optional[Tuple[int, int]] = None,
            global_rows: Optional[List[int]] = None, *,
            open_writer: Callable[..., FrameStoreWriter] = FrameStoreWriter,
            decode: Callable[[str, int, int], np.ndarray] = decode_frames,
            device: DeviceLike = "cuda") -> Dict[str, int]:
    """Decode (background thread) -> sample -> store.

    ``shard``/``global_rows``: this call handles only its stride slice of
    the shuffled video list; outputs get a ``.shard{i}of{N}`` suffix, and
    ``vidrows`` lists each store row's global row, so
    :func:`merge_extracted_shards` rebuilds a one-shot store.
    ``open_writer(path, num_videos, K, S)`` opens the store (any object
    with ``write(row, frames_chw)`` and the context-manager protocol);
    ``decode(path, S, intv)`` gives a video's (N, S, S, 3) uint8 frames.
    Returns the counts of exhausted MDF searches and empty videos."""
    os.makedirs(out_dir, exist_ok=True)
    sfx = _shard_suffix(shard)
    h5_out = os.path.join(out_dir, f"{args.dataset}_video_feat.h5{sfx}")
    map_out = os.path.join(out_dir, f"vidmapping{sfx}.json"
                           if shard else "vidmapping.json")
    # the reference's id: the file name up to its FIRST dot ('clip.v2.mp4'
    # maps as 'clip'), as the annotation side strips ids
    video_ids = [os.path.basename(p).split(".")[0] for p in video_paths]
    if global_rows is None:
        global_rows = list(range(len(video_paths)))
    save_json({vid: row for vid, row in zip(video_ids, global_rows)},
              map_out)
    if shard:
        # the {vid: row} mapping drops ids that truncate alike, so the
        # rows of a shard's store are listed one by one
        save_json(list(global_rows),
                  os.path.join(out_dir, f"vidrows{sfx}.json"))

    mdf = None
    if args.sampling_strategy == "repr":
        mdf = MDFEncoder(args.K, args.W, weights_path=args.vision_weights,
                         img_size=args.img_size, device=device)

    counter = {"Failure": 0, "Zeros": 0}
    empty = np.zeros((0, args.img_size, args.img_size, 3), np.uint8)
    q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def decode_worker():
        for i, path in enumerate(video_paths):
            try:
                frames = decode(path, args.img_size, args.intv)
            except Exception as e:
                LOGGER.warning(f"decode failed for {path}: {e}")
                frames = empty
            if not put((i, frames)):
                return
        put(None)

    t = threading.Thread(target=decode_worker, daemon=True,
                         name="stage-a-decode")
    t.start()
    try:
        with open_writer(h5_out, len(video_paths), args.K,
                         args.img_size) as writer:
            while True:
                item = q.get()
                if item is None:
                    break
                i, frames_u8 = item
                writer.write(i, _sample(args, frames_u8, global_rows[i],
                                        mdf, counter).transpose(0, 3, 1, 2))
                if (i + 1) % 50 == 0:
                    LOGGER.info(f"extracted {i + 1}/{len(video_paths)}")
    finally:
        stop.set()
        t.join()
    LOGGER.info(f"Total Failure:{counter['Failure']} "
                f"Zeros:{counter['Zeros']}")
    return counter


def _sample(args, frames_u8: np.ndarray, global_row: int,
            mdf: Optional[MDFEncoder], counter: Dict[str, int]
            ) -> np.ndarray:
    """One video's (N, S, S, 3) uint8 frames -> its K stored frames
    (K, S, S, 3) float32."""
    s = args.img_size
    if len(frames_u8) == 0:
        counter["Zeros"] += 1
        return np.zeros((args.K, s, s, 3), np.float32)
    frames = normalize_frames(frames_u8)
    n = frames.shape[0]
    if args.sampling_strategy == "repr":
        inds, exhausted = mdf(frames)
        counter["Failure"] += int(exhausted)
    elif args.sampling_strategy == "uni":
        if n < args.K:  # repeat-pad short videos, then sample
            frames = np.repeat(frames, int(np.ceil(args.K / n)), axis=0)
        inds = _uniform_centers(frames.shape[0], args.K)
    elif args.sampling_strategy == "git6":
        # seeded by (seed, global row): a sharded extraction draws the
        # frames a one-shot run draws
        inds = git6_indices(n, args.K, 4,
                            np.random.default_rng((args.seed, global_row)))
    else:
        raise ValueError(args.sampling_strategy)
    return frames[inds]


def merge_extracted_shards(out_dir: str, args) -> Dict[str, int]:
    """Reassemble per-shard stores into the one-shot layout.  Each
    shard's ``vidrows`` lists the global row of every store row; an id
    two shards share resolves to its higher global row, as a one-shot
    dict build does."""
    shard_h5s = collect_shard_set(out_dir, f"{args.dataset}_video_feat.h5")
    if shard_h5s is None:
        raise FileNotFoundError(
            f"no shard stores under {out_dir}; run extract with "
            "--shard i/N first")
    n = len(shard_h5s)
    mappings = [load_json(os.path.join(
        out_dir, f"vidmapping.shard{i}of{n}.json")) for i in range(n)]
    row_lists = [load_json(os.path.join(
        out_dir, f"vidrows.shard{i}of{n}.json")) for i in range(n)]
    total_rows = sum(len(r) for r in row_lists)
    if len({row for rows in row_lists for row in rows}) != total_rows:
        raise ValueError("overlapping global rows across shards: shards "
                         "must partition one video list")
    rows_by_id: Dict[str, int] = {}
    for m in mappings:
        for vid, row in m.items():
            rows_by_id[vid] = max(int(row), rows_by_id.get(vid, -1))

    h5_out = os.path.join(out_dir, f"{args.dataset}_video_feat.h5")
    with _open_h5(shard_h5s[0], "r") as f0:
        _, k, d = f0[DATASET_NAME].shape
    hw = int(round((d // 3) ** 0.5))
    with FrameStoreWriter(h5_out, total_rows, k, hw) as writer:
        for i in range(n):
            with _open_h5(shard_h5s[i], "r") as f:
                ds = f[DATASET_NAME]
                for local, grow in enumerate(row_lists[i]):
                    writer.write(int(grow), np.asarray(ds[local]))
    save_json(rows_by_id, os.path.join(out_dir, "vidmapping.json"))
    LOGGER.info(f"merged {n} shards -> {h5_out} ({total_rows} videos)")
    return {"shards": n, "videos": total_rows}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="stage A frame extraction")
    p.add_argument("--dataset", default="msvd_qa",
                   choices=["msvd_qa", "msrvtt_qa", "svqa"])
    p.add_argument("--dataset_root", default="./dataset")
    p.add_argument("--anno_path", default="annotations")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--intv", type=int, default=1,
                   help="decode keeps every intv-th frame")
    p.add_argument("--sampling_strategy", default="uni",
                   choices=["uni", "repr", "git6"])
    p.add_argument("--K", type=int, default=16)
    p.add_argument("--W", type=int, default=8,
                   help="MDF suppression window; -1 = adaptive N//20")
    p.add_argument("--h5_fname", default="processed")
    p.add_argument("--vision_weights", default=None,
                   help="local HF checkpoint for the MDF vision encoder")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--shard", default=None,
                   help="'i/N': extract only the i-th stride slice of "
                        "the video list (outputs suffixed .shard{i}of"
                        "{N}); 'auto' = this process's torch.distributed "
                        "rank/world size. Run --merge_shards afterwards.")
    p.add_argument("--merge_shards", action="store_true",
                   help="merge .shard*of* stores in the output dir into "
                        "the final h5 + vidmapping.json")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    out_dir = os.path.join(args.dataset_root, args.dataset, args.h5_fname)
    if args.merge_shards:
        return merge_extracted_shards(out_dir, args)
    paths = load_video_paths(args.dataset, args.dataset_root,
                             args.anno_path)
    np.random.default_rng(args.seed).shuffle(paths)
    shard = parse_shard(args.shard)
    if shard is None:
        return extract(paths, out_dir, args, device=device)
    si, sn = shard
    rows = list(range(si, len(paths), sn))
    return extract([paths[r] for r in rows], out_dir, args, shard=shard,
                   global_rows=rows, device=device)


if __name__ == "__main__":
    main()
