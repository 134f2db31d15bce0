"""Shared helpers for the port-vs-JAX parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package's Flax params are carried into the port's modules with
``sasvqa_torch.models.convert.state_dict_from_flax``.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from sasvqa_torch.models.convert import state_dict_from_flax

# one thread per test worker: the suite runs several workers at once
torch.set_num_threads(1)

TINY_GIT = {"model": {"pretrained_model": "tiny-git", "vocab_size": None},
            "img_size": 32, "num_labels": 1, "tokenizer_dir": None,
            "classifier": "mlp"}


def numpy_tree(tree):
    """Flax params (jax arrays) -> the same nested dict of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, tree)


def load_flax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Carry Flax params into a port module (strict: every leaf maps)."""
    module.load_state_dict(state_dict_from_flax(numpy_tree(params)),
                           strict=True)
    return module


def to_torch(x, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(
        dtype=dtype)


def frames(seed: int, k: int, img: int) -> np.ndarray:
    """(K, IMG, IMG, 3) f32 normalized-looking frames from a seed."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(k, img, img, 3)).astype(np.float32)


def port_git_config(jax_cfg):
    """The port's GITConfig with the same fields as a JAX GITConfig."""
    import dataclasses

    from sasvqa_torch.models.clip import CLIPVisionConfig
    from sasvqa_torch.models.git import GITConfig
    fields = dataclasses.asdict(jax_cfg)
    fields["vision"] = CLIPVisionConfig(**fields["vision"])
    return GITConfig(**fields)


# ---- tiny HF models at the port's tiny presets' widths (tiny-git,
# tiny-clip, tiny-blip), built from config objects (no downloads) ----------

TINY_HF = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4)
TINY_HF_VISION = dict(TINY_HF, image_size=32, patch_size=16)


def hf_tiny_clip(vocab_size=512, max_position_embeddings=32, seed=0):
    """transformers.CLIPModel at tiny-clip's widths (eos = vocab - 1)."""
    from transformers import CLIPConfig, CLIPModel
    torch.manual_seed(seed)
    cfg = CLIPConfig(
        text_config=dict(TINY_HF, vocab_size=vocab_size,
                         max_position_embeddings=max_position_embeddings,
                         bos_token_id=vocab_size - 2,
                         eos_token_id=vocab_size - 1, pad_token_id=1),
        vision_config=TINY_HF_VISION, projection_dim=32)
    return CLIPModel(cfg).eval()


def hf_tiny_git(num_frames=2, vocab_size=512, max_position_embeddings=128,
                seed=0):
    """transformers.GitForCausalLM at tiny-git's widths, with the
    temporal embeddings of ``num_frames`` frames."""
    from transformers import GitConfig, GitForCausalLM, GitVisionConfig
    torch.manual_seed(seed)
    cfg = GitConfig(
        vocab_size=vocab_size, max_position_embeddings=max_position_embeddings,
        vision_config=GitVisionConfig(**TINY_HF_VISION).to_dict(),
        num_image_with_embedding=num_frames, **TINY_HF)
    return GitForCausalLM(cfg).eval()


def hf_tiny_blip(vocab_size=512, image_size=32, seed=0):
    """transformers.BlipModel (vision_model + cross-attending text_model)
    at tiny-blip's widths."""
    from transformers import BlipConfig, BlipModel
    torch.manual_seed(seed)
    cfg = BlipConfig(
        text_config=dict(TINY_HF, vocab_size=vocab_size,
                         max_position_embeddings=64, encoder_hidden_size=32),
        vision_config=dict(TINY_HF_VISION, image_size=image_size))
    return BlipModel(cfg).eval()


def save_hf(model, path, fmt: str) -> str:
    """``save_pretrained`` as safetensors (``fmt="safetensors"``) or as
    pytorch_model.bin (``"bin"``); returns the directory."""
    model.save_pretrained(str(path), safe_serialization=fmt == "safetensors")
    return str(path)
