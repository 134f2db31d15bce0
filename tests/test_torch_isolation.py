"""The port stands alone: no JAX, Flax, Optax, ml_dtypes or sasvqa_tpu
imports, and h5py only where a frame store is opened; nothing runs on the
CPU unless asked; CPU tensors never reach the kernel."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "sasvqa_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "h5py",
             "sasvqa_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _port_modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if rel.startswith("sasvqa_torch"):
            mod = rel[:-3].replace(os.sep, ".")
            mods.append(mod[:-len(".__init__")]
                        if mod.endswith(".__init__") else mod)
    return mods


# the one place the port may import h5py: inside the function that opens
# an HDF5 frame store, so that importing the port never needs it
H5PY_SITE = ("sasvqa_torch/data/frame_store.py", "_open_h5")


def test_no_forbidden_imports_ast():
    bad, h5py_sites = [], []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        funcs = {}   # import node -> the function that holds it
        for fn in ast.walk(tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    funcs.setdefault(node, fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                if n.split(".")[0] not in FORBIDDEN:
                    continue
                if n == "h5py" and (rel, funcs.get(node)) == H5PY_SITE:
                    h5py_sites.append(node.lineno)
                else:
                    bad.append(f"{rel}: {n}")
    assert not bad, bad
    assert len(h5py_sites) == 1, h5py_sites
    assert len(_port_files()) > 16


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"leaked = sorted(m for m in sys.modules "
        f"if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "assert not leaked, leaked\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU the entry points raise unless device='cpu' is
    passed; nothing silently runs on the CPU."""
    from sasvqa_torch.data.tokenization import make_test_wordpiece
    from sasvqa_torch.models.git import greedy_generate
    from sasvqa_torch.models.presets import build_model
    from sasvqa_torch.tasks.serve import QAEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"model": {"pretrained_model": "tiny-git"}, "img_size": 32}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    _, model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QAEngine(model, "git", make_test_wordpiece())
    ids = np.ones((1, 4), np.int32)
    px = np.zeros((1, 1, 32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(model, ids, np.array([4]), px)
    out = greedy_generate(model, ids, np.array([4]), px, max_text_len=6,
                          device="cpu")
    assert out.shape == (1, 5) and out.device.type == "cpu"

    from sasvqa_torch.train.steps import (create_train_state,
                                          make_git_train_step,
                                          make_scan_train_step)
    cfg = {"learning_rate": 1e-3}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model, cfg, total_steps=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_git_train_step()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_scan_train_step(2)
    state = create_train_state(model, cfg, total_steps=4, device="cpu")
    batch = {"text_input_ids": ids, "text_attention_mask": np.ones_like(ids),
             "visual_inputs": px, "labels": ids}
    state, metrics = make_git_train_step(device="cpu")(state, batch, 0)
    assert state.step == 1 and np.isfinite(metrics["loss"].item())

    # the task loop: the GPU unless the config says "platform": "cpu"
    from sasvqa_torch.core.config import ConfigDict
    from sasvqa_torch.tasks.run_video_qa import start_training
    with pytest.raises(RuntimeError, match="device='cpu'"):
        start_training(ConfigDict({"platform": None}))


def test_cpu_model_never_counts_a_kernel_launch():
    """The whole tiny model on CPU tensors, forced onto the git-flash
    route, takes the plain version: the launch counter stays 0."""
    from sasvqa_torch.models.git import GITForCausalLM, greedy_generate
    from sasvqa_torch.models.presets import _git_config
    from sasvqa_torch.ops import _build

    _build.reset_launch_counts()
    model = GITForCausalLM(_git_config("tiny"), flash=True).eval()
    ids = np.full((2, 5), 7, np.int32)
    px = np.random.default_rng(0).normal(size=(2, 1, 32, 32, 3)).astype(
        np.float32)
    greedy_generate(model, ids, np.array([5, 2]), px, max_text_len=8,
                    device="cpu")
    # and a training forward/backward with every dropout on
    tid = torch.from_numpy(ids).long()
    loss = model.train()(tid, torch.ones_like(tid), torch.from_numpy(px),
                         labels=tid, deterministic=False,
                         generator=torch.Generator().manual_seed(0))["loss"]
    loss.backward()
    assert model.layer_0.attention.qkv.weight.grad.abs().sum() > 0
    assert set(_build.launch_counts) == {"git_flash_fwd", "git_flash_bwd",
                                         "git_flash_bwd_dq",
                                         "git_flash_bwd_dkv",
                                         "hash_dropout", "flash_fwd",
                                         "flash_bwd_dq", "flash_bwd_dkv"}
    assert not any(_build.launch_counts.values()), _build.launch_counts


def test_seeded_init_is_reproducible():
    from sasvqa_torch.models.git import GITForCausalLM
    from sasvqa_torch.models.presets import _git_config
    cfg = _git_config("tiny")
    a = GITForCausalLM(cfg, generator=torch.Generator().manual_seed(3))
    b = GITForCausalLM(cfg, generator=torch.Generator().manual_seed(3))
    c = GITForCausalLM(cfg, generator=torch.Generator().manual_seed(4))
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all(), name
    assert not torch.equal(a.output.weight, c.output.weight)
