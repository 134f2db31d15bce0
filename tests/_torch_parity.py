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
