"""Video-text retrieval evaluation with the projected CLIP towers
(counterpart of sasvqa_tpu/tasks/run_retrieval.py):

    python -m sasvqa_torch.tasks.run_retrieval --config cfg.json

Encodes one caption per video (the first question of a QA-style split)
with the text tower through ``text_projection``, and ``nframe`` uniformly
spaced stored frames of each video with the vision tower through
``visual_projection``, in ``val_batch_size`` chunks; then scores every
caption against every frame by cosine similarity, pools the per-frame
SCORES with ``score_agg_func`` (mean / max / lse, the reference's
run_video_retrieval.py:404-418) and reports text->video R@1/5/10, MedR and
MeanR.  ``model.pretrained_weights`` names a local HF CLIPModel
checkpoint that is overlaid on the seeded towers.  It runs on the GPU
unless the config sets ``"platform": "cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from sasvqa_torch.core.config import load_config
from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.data.annotations import load_datalist
from sasvqa_torch.data.frame_store import FrameStoreReader, load_vidmapping
from sasvqa_torch.models.clip import CLIPTextEncoder, CLIPVisionEncoder
from sasvqa_torch.models.convert import (convert_clip_text,
                                         convert_clip_vision,
                                         merge_pretrained)
from sasvqa_torch.models.presets import (_clip_configs,
                                         _load_torch_state_dict)
from sasvqa_torch.tasks.run_video_qa import build_tokenizer
from sasvqa_torch.tools.extract_frames import _uniform_centers
from sasvqa_torch.train.retrieval import (aggregate_clip_scores,
                                          retrieval_metrics,
                                          similarity_matrix)


def build_towers(cfg: Mapping[str, Any], dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
    """Standalone projected CLIP towers on ``device``, in eval mode: both
    ends land in the shared embedding space (the task model's text tower
    is unprojected).  ``model.vocab_size`` and ``img_size`` override the
    preset as in the JAX package."""
    dev = resolve_device(device)
    tc, vc = _clip_configs(cfg["model"]["pretrained_model"].lower())
    vocab = cfg["model"].get("vocab_size")
    if vocab:
        tc = dataclasses.replace(tc, vocab_size=vocab,
                                 eos_token_id=vocab - 1)
    if cfg.get("img_size") and cfg["img_size"] != vc.image_size:
        vc = dataclasses.replace(vc, image_size=cfg["img_size"])
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    txt_tower = CLIPTextEncoder(tc, dtype=dtype, with_projection=True,
                                projection_dim=vc.projection_dim,
                                generator=gen)
    vis_tower = CLIPVisionEncoder(vc, dtype=dtype, with_projection=True,
                                  generator=gen)
    return txt_tower.to(dev).eval(), vis_tower.to(dev).eval()


@torch.no_grad()
def encode_corpus(txt_tower, vis_tower, tokenizer, captions: List[str],
                  frames: np.ndarray, cfg: Mapping[str, Any],
                  batch_size: int = 64) -> Dict[str, np.ndarray]:
    """captions: N strings; frames: (N, T, H, W, C) f32, encoded in
    chunks of ``batch_size`` on the towers' device.

    Returns f32 text (N, D) and PER-FRAME video (N, T, D) embeddings in
    the shared CLIP space; the clip pooling happens over scores in
    :func:`evaluate_retrieval`.  The last chunk runs at its own size (the
    JAX package pads it to its compiled shape; the rows are the same)."""
    dev = next(txt_tower.parameters()).device
    enc = tokenizer(captions, max_length=cfg.get("max_txt_len", 20))
    n = len(captions)
    bs = min(batch_size, n)
    txt_out, vid_out = [], []
    for s in range(0, n, bs):
        e = min(s + bs, n)
        ids = torch.from_numpy(enc["input_ids"][s:e]).long().to(dev)
        mask = torch.from_numpy(enc["attention_mask"][s:e]).to(dev)
        chunk = torch.from_numpy(np.ascontiguousarray(frames[s:e])).to(dev)
        _, txt = txt_tower(ids, mask)
        b, t = chunk.shape[:2]
        _, _, image_embeds = vis_tower(chunk.flatten(0, 1))
        txt_out.append(txt.float().cpu().numpy())
        vid_out.append(image_embeds.reshape(b, t, -1).float().cpu().numpy())
    return {"text": np.concatenate(txt_out), "video": np.concatenate(vid_out)}


def clip_score_matrix(text: np.ndarray, video: np.ndarray, agg: str,
                      device: DeviceLike) -> np.ndarray:
    """(Nt, Nv) text->video scores: cosine similarity of each caption
    with each frame (Nt, Nv, T), pooled over the frames by ``agg``, in f32
    on ``device``."""
    dev = resolve_device(device)
    txt = torch.from_numpy(text).float().to(dev)
    vid = torch.from_numpy(video).float().to(dev)
    nv, t, d = vid.shape
    sim_frames = similarity_matrix(txt, vid.reshape(nv * t, d)).reshape(
        len(txt), nv, t)
    return aggregate_clip_scores(sim_frames, agg, dim=-1).cpu().numpy()


def evaluate_retrieval(txt_tower, vis_tower, tokenizer, captions, frames,
                       cfg: Mapping[str, Any],
                       batch_size: int = 64) -> Dict[str, float]:
    embeds = encode_corpus(txt_tower, vis_tower, tokenizer, captions, frames,
                           cfg, batch_size)
    # the default 'mean' is the shared parser's and the reference's
    # (reference config.py:99); shipped configs set 'lse'
    sim = clip_score_matrix(embeds["text"], embeds["video"],
                            cfg.get("score_agg_func", "mean"),
                            next(txt_tower.parameters()).device)
    metrics = retrieval_metrics(sim)
    LOGGER.info(f"retrieval: {metrics}")
    return metrics


def main(argv: Optional[List[str]] = None, *,
         open_store: Callable[[str], Any] = FrameStoreReader
         ) -> Dict[str, float]:
    """Evaluate ``--config``'s first val split; ``open_store(path)`` opens
    its frame store (default HDF5; any object with
    :class:`FrameStoreReader`'s ``shape`` and ``read_frames_nhwc``)."""
    p = argparse.ArgumentParser(description="video-text retrieval eval")
    p.add_argument("--config", required=True)
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    dev = resolve_device("cpu" if cfg.get("platform") == "cpu" else "cuda")

    txt_tower, vis_tower = build_towers(cfg, device=dev)
    tokenizer = build_tokenizer(cfg, "clip")

    datalist = load_datalist(cfg.task, cfg.val_datasets[0].txt)
    store = open_store(cfg.val_datasets[0].img)
    vid2id = load_vidmapping(cfg.vid_mapping)
    # one caption per unique video (the first question acts as the query
    # in QA-style annotations; retrieval datasets provide real captions)
    seen: Dict[str, str] = {}
    for d in datalist:
        seen.setdefault(d["video_id"], d["question"])
    video_ids = list(seen)
    captions = [seen[v] for v in video_ids]
    k = store.shape[1]
    inds = _uniform_centers(k, cfg.get("nframe", 4))
    frames = np.stack([store.read_frames_nhwc(vid2id[v], inds)
                       for v in video_ids])

    weights = cfg.model.get("pretrained_weights")
    if weights:
        sd = _load_torch_state_dict(weights)
        merge_pretrained(txt_tower, convert_clip_text(
            sd, txt_tower.config.num_layers))
        merge_pretrained(vis_tower, convert_clip_vision(
            sd, vis_tower.config.num_layers))

    metrics = evaluate_retrieval(
        txt_tower, vis_tower, tokenizer, captions, frames, cfg,
        batch_size=cfg.get("val_batch_size", 64))
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
