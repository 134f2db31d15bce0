"""Offline stage B: MIF caption generation and question-aware frame
scoring (counterpart of sasvqa_tpu/tools/gen_sample.py, with its CLI
flags).

    python -m sasvqa_torch.tools.gen_sample --task gen_cap --dataset msvd_qa
    python -m sasvqa_torch.tools.gen_sample --task gen_inds --dataset msvd_qa
    python -m sasvqa_torch.tools.gen_sample --task merge --dataset msvd_qa

- gen_cap: every stored frame of every video -> a GIT caption ('[CLS]'
  prompt, greedy, ``--max_length`` 30) -> ``frame_captions.json``; the
  K frames of ``--batch_rows`` videos decode as one batch (the final
  chunk padded with zero frames);
- gen_inds: per QA pair, score (question, caption_k) with a BERT
  sequence classifier, logits[:, 0], downsample ::ds_rate, top K ->
  ``qa_winds_{split}.json``;
- merge: reassemble ``--shard i/N`` outputs into the one-shot files.

``--platform cpu`` runs on the CPU; the default is the GPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from sasvqa_torch.core.device import resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.data.frame_store import FrameStoreReader
from sasvqa_torch.data.tokenization import (WordPieceTokenizer,
                                            make_test_wordpiece)
from sasvqa_torch.models.bert import (BERTConfig,
                                      BERTForSequenceClassification,
                                      convert_bert_classifier)
from sasvqa_torch.models.convert import merge_pretrained
from sasvqa_torch.models.git import GITForCausalLM, greedy_generate
from sasvqa_torch.models.presets import (_git_config,
                                         _load_torch_state_dict,
                                         load_pretrained_params)
from sasvqa_torch.sampling.mif import generate_inds_for_split
from sasvqa_torch.tools.extract_frames import (_shard_suffix,
                                               collect_shard_set,
                                               parse_shard)
from sasvqa_torch.utils.basic import load_json, save_json


def _tokenizer(args) -> WordPieceTokenizer:
    if args.tokenizer_dir:
        return WordPieceTokenizer.from_vocab_file(
            os.path.join(args.tokenizer_dir, "vocab.txt"))
    LOGGER.warning("no --tokenizer_dir; using built-in test vocab")
    return make_test_wordpiece()


def run_gen_cap(args, open_store: Callable[[str], Any] = FrameStoreReader
                ) -> Dict[str, List[str]]:
    """Caption every stored frame; write frame_captions.json.
    ``open_store(path)`` opens the frame store (any object with
    FrameStoreReader's ``shape`` and ``read_frames_nhwc``)."""
    dev = args.device
    tok = _tokenizer(args)
    model = GITForCausalLM(_git_config(args.vlm_model.lower()),
                           dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        load_pretrained_params("git", model, args.weights)
    model.to(dev).eval()

    store = open_store(args.h5_file)
    num_videos, k, _ = store.shape
    # --shard i/N: caption only this stride slice of the store rows
    shard = parse_shard(args.shard)
    all_rows = (list(range(num_videos)) if shard is None
                else list(range(shard[0], num_videos, shard[1])))
    rows_per = max(int(args.batch_rows), 1)
    bsz = rows_per * k
    ids0 = torch.full((bsz, 1), tok.cls_token_id, dtype=torch.long)
    plen = torch.ones((bsz,), dtype=torch.long)

    captions: Dict[str, List[str]] = {}
    for start in range(0, len(all_rows), rows_per):
        rows = all_rows[start:start + rows_per]
        frames = np.concatenate([store.read_frames_nhwc(r, np.arange(k))
                                 for r in rows])        # (n*K, H, W, 3)
        if frames.shape[0] < bsz:                       # pad the last chunk
            pad = np.zeros((bsz - frames.shape[0],) + frames.shape[1:],
                           frames.dtype)
            frames = np.concatenate([frames, pad])
        with torch.inference_mode():
            out = greedy_generate(
                model, ids0, plen, torch.from_numpy(frames)[:, None],
                max_text_len=args.max_length,
                max_new_tokens=args.max_length - 1, device=dev)
        out = out.cpu().numpy()
        for j, r in enumerate(rows):
            captions[str(r)] = [tok.decode(out[j * k + i])
                                for i in range(k)]
        done = start + len(rows)
        if done >= 50 and done % 50 < rows_per:
            LOGGER.info(f"captioned {done}/{len(all_rows)}")

    out_file = os.path.join(
        args.anno_dir, f"frame_captions{_shard_suffix(shard)}.json")
    save_json(captions, out_file)
    LOGGER.info(f"wrote {out_file}")
    return captions


def build_scorer(args, vocab_size: int):
    """The BERT scorer of the flags (BERT-base, or the tiny dims of
    ``--tiny``) in f32 on the device, ``--weights`` overlaid."""
    cfg = BERTConfig(vocab_size=vocab_size) if not args.tiny else \
        BERTConfig(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=4, intermediate_size=64,
                   max_position_embeddings=128)
    model = BERTForSequenceClassification(
        cfg, generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        report = merge_pretrained(model, convert_bert_classifier(
            _load_torch_state_dict(args.weights), cfg.num_layers))
        LOGGER.info(f"scorer: loaded {len(report['loaded'])} tensors")
    return model.to(args.device).eval()


def run_gen_inds(args) -> None:
    """Score question/caption pairs; write qa_winds_{split}.json."""
    if "bert" not in args.sim_model.lower():
        # the scorer is a fixed BERT architecture: refuse to load another
        # model's --weights into its shapes
        raise ValueError(
            f"--sim_model {args.sim_model!r}: only BERT-base-class "
            "scorers are supported (the reference default "
            "iarfmoose/bert-base-cased-qa-evaluator is one)")
    if args.dataset == "msvd_qa":
        vid_name = "video"          # '<id>.avi'
    elif args.dataset == "msrvtt_qa":
        vid_name = "video_id"       # int <id>, stored file 'video<id>.*'
    else:
        raise ValueError("supported datasets: msvd_qa, msrvtt_qa")
    # captions are keyed by store row: annotation ids go through the
    # vidmapping, which must exist (a raw numeric id would silently score
    # another row's captions)
    if not (args.vid_mapping and os.path.exists(args.vid_mapping)):
        raise FileNotFoundError(
            f"vidmapping not found at {args.vid_mapping!r}; run "
            "tools/extract_frames (stage A) first: gen_inds keys captions "
            "by store row through it")
    vid2row = load_json(args.vid_mapping)

    def caption_key(sample):
        raw = sample[vid_name]
        vid_id = (str(raw).split(".")[0] if args.dataset == "msvd_qa"
                  else f"video{raw}")
        if vid_id not in vid2row:
            raise KeyError(
                f"video id {vid_id!r} missing from vidmapping "
                f"({args.vid_mapping}): the annotation references a video "
                "stage A never extracted")
        return str(vid2row[vid_id])

    tok = _tokenizer(args)
    model = build_scorer(args, max(tok.vocab.values()) + 1)
    dev = args.device
    all_captions = load_json(os.path.join(args.anno_dir,
                                          "frame_captions.json"))

    @torch.inference_mode()
    def score(ids, mask, types):
        return model(ids.to(dev), mask.to(dev), types.to(dev))

    # --shard i/N: score only this stride slice of each split's samples;
    # --task merge re-interleaves them
    shard = parse_shard(args.shard)
    for split in ("train", "val", "test"):
        read_file = os.path.join(args.anno_dir, f"qa_{split}.json")
        if not os.path.exists(read_file):
            continue
        samples = load_json(read_file)
        if shard is not None:
            samples = samples[shard[0]::shard[1]]
        new_ds = generate_inds_for_split(
            score, tok, samples, all_captions, caption_key,
            k=args.K, ds_rate=args.ds_rate,
            max_length=args.score_max_length)
        out_file = os.path.join(
            args.anno_dir, f"qa_winds_{split}{_shard_suffix(shard)}.json")
        save_json(new_ds, out_file)
        LOGGER.info(f"wrote {out_file} ({len(new_ds)} samples)")


def run_merge(args) -> None:
    """Merge ``--shard`` outputs into the one-shot files: caption shards
    are a dict union in store-row order; winds shards re-interleave by
    stride (shard i held samples [i::N])."""
    def shard_set(prefix: str):
        return collect_shard_set(args.anno_dir, prefix, suffix=".json")

    merged_any = False
    caps = shard_set("frame_captions")
    if caps:
        union: Dict[str, List[str]] = {}
        for p in caps:
            union.update(load_json(p))
        out = {str(r): union[str(r)] for r in sorted(map(int, union))}
        out_file = os.path.join(args.anno_dir, "frame_captions.json")
        save_json(out, out_file)
        LOGGER.info(f"merged {len(caps)} caption shards -> {out_file} "
                    f"({len(out)} videos)")
        merged_any = True
    for split in ("train", "val", "test"):
        shards = shard_set(f"qa_winds_{split}")
        if not shards:
            continue
        lists = [load_json(p) for p in shards]
        n = len(lists)
        total = sum(len(l) for l in lists)
        merged = [lists[j % n][j // n] for j in range(total)]
        out_file = os.path.join(args.anno_dir, f"qa_winds_{split}.json")
        save_json(merged, out_file)
        LOGGER.info(f"merged {n} winds shards -> {out_file} "
                    f"({total} samples)")
        merged_any = True
    if not merged_any:
        raise FileNotFoundError(
            f"no .shard*of*.json outputs under {args.anno_dir}; run "
            "gen_cap/gen_inds with --shard i/N first")


def build_argparser():
    p = argparse.ArgumentParser(description="stage B MIF caption/score")
    p.add_argument("--dataset", default="msvd_qa",
                   choices=["msvd_qa", "msrvtt_qa"])
    p.add_argument("--dataset_root", default="./dataset")
    p.add_argument("--anno_path", default="annotations")
    p.add_argument("--h5_path", default="processed")
    p.add_argument("--task", choices=["gen_cap", "gen_inds", "merge"],
                   default="gen_cap")
    p.add_argument("--vlm_model", default="microsoft/git-base-coco")
    p.add_argument("--sim_model",
                   default="iarfmoose/bert-base-cased-qa-evaluator",
                   help="stage-2 scorer name.  The scorer is BERT-base "
                        "(or --tiny): this flag names the checkpoint "
                        "--weights should hold; a non-BERT name is "
                        "refused")
    p.add_argument("--weights", default=None,
                   help="local HF checkpoint for the captioner/scorer")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--K", type=int, default=32)
    p.add_argument("--ds_rate", type=int, default=1)
    p.add_argument("--max_length", type=int, default=30,
                   help="gen_cap caption budget (the reference's generate "
                        "max_length=30)")
    p.add_argument("--score_max_length", type=int, default=64,
                   help="gen_inds question+caption tokenization budget "
                        "(the scorer's own length, not the caption "
                        "budget: 30 would cut most pairs)")
    p.add_argument("--batch_rows", type=int, default=4,
                   help="videos captioned per decode call (frames batch "
                        "as batch_rows*K)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model dims (tests/synthetic)")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--shard", default=None,
                   help="'i/N': process only the i-th stride slice "
                        "(gen_cap: store rows; gen_inds: QA samples per "
                        "split); 'auto' = this process's torch."
                        "distributed rank/world size. Merge afterwards "
                        "with --task merge.")
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    return p


def main(argv=None, open_store: Callable[[str], Any] = FrameStoreReader):
    """The CLI; ``open_store`` opens gen_cap's frame store (default:
    HDF5)."""
    args = build_argparser().parse_args(argv)
    args.device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    droot = os.path.join(args.dataset_root, args.dataset)
    args.anno_dir = os.path.join(droot, args.anno_path)
    h5_dir = os.path.join(droot, args.h5_path)
    args.h5_file = os.path.join(h5_dir, f"{args.dataset}_video_feat.h5")
    args.vid_mapping = os.path.join(h5_dir, "vidmapping.json")
    if args.task == "gen_cap":
        if "git" not in args.vlm_model.lower():
            raise ValueError("captioning model must be a GIT variant")
        run_gen_cap(args, open_store)
    elif args.task == "merge":
        run_merge(args)
    else:
        run_gen_inds(args)


if __name__ == "__main__":
    main()
