"""Single-video question answering from the command line (counterpart of
sasvqa_tpu/tasks/predict.py).

    python -m sasvqa_torch.tasks.predict --video clip.avi \\
        --question "what is the man doing?" \\
        --model microsoft/git-base-msrvtt-qa \\
        --weights ./pretrained/git-base-msrvtt-qa \\
        --tokenizer_dir ./pretrained/tokenizer --nframe 6

Decodes the video (data/video_decode.py), takes ``nframe`` frames at
uniform interval centres, and answers with the generative GIT path (the
last word of the generated text) or a classifier with an ans2label
vocabulary.  ``--platform cpu`` runs on the CPU; the default is the GPU.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from sasvqa_torch.core.checkpoint import ModelSaver
from sasvqa_torch.core.config import ConfigDict
from sasvqa_torch.core.device import DeviceLike, resolve_device
from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.models.git import greedy_generate
from sasvqa_torch.models.presets import build_model, load_pretrained_params
from sasvqa_torch.tasks.run_video_qa import build_tokenizer
from sasvqa_torch.tools.extract_frames import (_uniform_centers,
                                               decode_frames,
                                               normalize_frames)
from sasvqa_torch.utils.basic import load_json


def load_frames(video: str, nframe: int, img_size: int) -> np.ndarray:
    """(1, nframe, S, S, 3) normalised frames at uniform interval
    centres, through the stage-A decode (native-resolution chunks, the HF
    processor's resize and crop)."""
    frames_u8 = decode_frames(video, img_size, 1)
    if not len(frames_u8):
        raise IOError(f"no frames decoded from {video}")
    sel = frames_u8[_uniform_centers(len(frames_u8), nframe)]
    return normalize_frames(sel)[None]


def answer_from_frames(model, family: str, tokenizer, frames: np.ndarray,
                       question: str, max_length: int = 50,
                       ans2label: Optional[Dict[str, int]] = None,
                       device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Answer ``question`` about ``frames`` (1, T, S, S, 3).

    GIT: the prompt is [CLS] + the question's tokens, cut to
    ``max_length - 8`` to leave room to generate; greedy decoding to
    ``max_length`` text tokens; the answer is the last generated word.
    Returns {"answer", "ids"}.  A classifier answers the
    ``ans2label`` entry of its argmax label: {"answer", "label"}."""
    dev = resolve_device(device)
    pixels = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    if family == "git":
        budget = max(max_length - 8, 1)
        ids_list = ([tokenizer.cls_token_id] + tokenizer.encode(
            question, add_special_tokens=False))[:budget]
        with torch.inference_mode():
            out = greedy_generate(model, np.asarray([ids_list], np.int32),
                                  np.asarray([len(ids_list)], np.int32),
                                  pixels, max_text_len=max_length,
                                  device=dev)
        ids = out[0].cpu().numpy()
        text = tokenizer.decode(ids)
        LOGGER.info(f"generated: {text!r}")
        words = text.split()
        return {"answer": words[-1] if words else "", "ids": ids}
    if not ans2label:
        raise ValueError("classifier models need --ans2label")
    label2ans = {v: k for k, v in ans2label.items()}
    enc = tokenizer([question], max_length=max_length)
    with torch.inference_mode():
        out = model(torch.from_numpy(enc["input_ids"]).long().to(dev),
                    torch.from_numpy(enc["attention_mask"]).to(dev), pixels)
    pred = int(out["logits"].argmax().item())
    return {"answer": label2ans.get(pred, str(pred)), "label": pred}


def load_model(args, snapshot_step: Optional[int],
               device: DeviceLike = "cuda"):
    """(family, model, tokenizer) of the CLI flags: the seeded bf16 model,
    overlaid by ``--weights`` (a local HF checkpoint) and then by the
    ModelSaver snapshot of a training run (``--orbax_ckpt``) at
    ``snapshot_step``, None for the latest."""
    cfg = ConfigDict({
        "model": {"pretrained_model": args.model, "vocab_size": None},
        "img_size": args.img_size, "num_labels": args.num_labels,
        "tokenizer_dir": args.tokenizer_dir,
        # the training run's head ("mlp" is the training default): a
        # snapshot of the other head shape does not load
        "classifier": args.classifier,
    })
    family, model = build_model(cfg, dtype=torch.bfloat16, device=device)
    tokenizer = build_tokenizer(cfg, family)
    if args.weights:
        load_pretrained_params(family, model, args.weights)
    if args.orbax_ckpt:
        saver = ModelSaver(args.orbax_ckpt)
        step = (saver.latest_step() if snapshot_step is None
                else snapshot_step)
        if step is None:
            raise FileNotFoundError(
                f"no eval snapshots under {args.orbax_ckpt}")
        LOGGER.info(f"loading snapshot model_step_{step}")
        model.load_state_dict(saver.restore(int(step)))
    return family, model, tokenizer


def predict(args) -> str:
    device = resolve_device("cpu" if args.platform == "cpu" else "cuda")
    family, model, tokenizer = load_model(
        args, args.orbax_step if args.orbax_step > 0 else None, device)
    ans2label = None
    if args.ans2label:
        ans2label = load_json(args.ans2label)
    frames = load_frames(args.video, args.nframe, args.img_size)
    return answer_from_frames(model, family, tokenizer, frames,
                              args.question, max_length=args.max_length,
                              ans2label=ans2label, device=device)["answer"]


def build_argparser():
    p = argparse.ArgumentParser(description="single-video QA inference")
    p.add_argument("--video", required=True)
    p.add_argument("--question", required=True)
    p.add_argument("--model", default="microsoft/git-base-msrvtt-qa")
    p.add_argument("--weights", default=None,
                   help="local HF checkpoint dir (converted on load)")
    p.add_argument("--orbax_ckpt", default=None,
                   help="a training run's ckpt/ dir of this package's "
                        "ModelSaver snapshots (model_step_{N}.pt; the "
                        "name is the JAX CLI's); loads --orbax_step or "
                        "the latest")
    p.add_argument("--orbax_step", type=int, default=-1,
                   help="snapshot step; <= 0 = the latest")
    p.add_argument("--tokenizer_dir", default=None)
    p.add_argument("--ans2label", default=None,
                   help="answer vocab json (classifier models)")
    p.add_argument("--nframe", type=int, default=6)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--num_labels", type=int, default=1000)
    p.add_argument("--classifier", default="mlp",
                   choices=["mlp", "linear"],
                   help="classifier head shape; must match the training "
                        "run (training default: mlp)")
    p.add_argument("--max_length", type=int, default=50)
    p.add_argument("--platform", default=None,
                   help="'cpu' runs on the CPU; default: the GPU")
    return p


def main(argv: Optional[List[str]] = None) -> str:
    args = build_argparser().parse_args(argv)
    answer = predict(args)
    print(f"Q: {args.question}\nA: {answer}")
    return answer


if __name__ == "__main__":
    main()
