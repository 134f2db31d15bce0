"""The task loop's single-device options in the port vs the JAX package, on
the CPU at tiny size: bf16 host pixel staging (bits equal to the JAX
collators' ``ml_dtypes`` output, forwards equal to f32 staging), the
optimizer surface (adamax, sgd, the fallback of an unknown name, bf16
Adam moments) and MultiSteps accumulation (``scan_accum: 0``) against
the JAX ``make_optimizer``, resume from a snapshot inside an accumulation
window, ``CollatorPool``, and ``start_training`` under each option."""

import json
import multiprocessing
import os
import signal
import threading
import time
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import optax
import torch

from sasvqa_tpu.core import logging as jlogging
from sasvqa_tpu.core.config import ConfigDict as JConfigDict
from sasvqa_tpu.core.config import get_video_qa_args as jget_args
from sasvqa_tpu.data import dataset as jdataset
from sasvqa_tpu.data import tokenization as jtok
from sasvqa_tpu.data.synthetic import make_synthetic_dataset
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.tasks import run_video_qa as jrun
from sasvqa_tpu.train import steps as jsteps

from sasvqa_torch.core import logging as tlogging
from sasvqa_torch.core import pixels as tpixels
from sasvqa_torch.core.checkpoint import (FormulationMismatchError,
                                          TrainingRestorer)
from sasvqa_torch.core.config import get_video_qa_args
from sasvqa_torch.data import annotations as tann
from sasvqa_torch.data import dataset as tdataset
from sasvqa_torch.data import pipeline as tpipe
from sasvqa_torch.data import tokenization as ttok
from sasvqa_torch.data.frame_store import FrameStoreReader, load_vidmapping
from sasvqa_torch.models import presets as tpresets
from sasvqa_torch.models.convert import state_dict_from_flax
from sasvqa_torch.tasks import run_video_qa as trun
from sasvqa_torch.train import steps as tsteps

from _torch_parity import frames, load_flax_params, numpy_tree, to_torch
from _torch_pool import RaisingCollator, SleepingCollator

# the optimizer trajectories: parameters within 1e-6 after 8 updates
PARAM_ATOL = 1e-6
# the JAX-vs-port loops' per-update losses
LOSS_TOL = 1e-5
# each pool test's own limit (seconds): a hung worker fails its test
POOL_TIMEOUT = 120

TINY_CLIP = {"model": {"pretrained_model": "tiny-clip", "vocab_size": 512,
                       "hidden_dropout_prob": 0.0},
             "img_size": 32, "num_labels": 7, "classifier": "mlp"}
QUESTIONS = ["what is the man doing?", "Who plays with the red ball",
             "where is the dog running in the video frame", "how"]


def _items(n_groups=3, k=6, img=32, seed=0):
    return [{"vid": frames(seed + i, k, img), "n_examples": 1,
             "examples": [{"q_str": QUESTIONS[i % len(QUESTIONS)],
                           "str_label": "dog", "label": i % 3,
                           "question_id": i}]}
            for i in range(n_groups)]


# ---- bf16 host staging -------------------------------------------------------

@pytest.mark.parametrize("family", ["git", "clip"])
def test_bf16_staged_bits_equal_jax(family):
    """The port's GIT and classifier collators stage bf16 as uint16 bit
    patterns equal to the JAX collators' ml_dtypes bfloat16 bits, and
    host_tensor reads them back as the same bf16 values."""
    cfg = {"max_txt_len": 9, "task": "msvd_qa", "nframe": 3,
           "samp_policy": "random", "bf16": True}
    assert tdataset.pixel_dtype_for(cfg) == "bf16"
    ref_col = jdataset.make_collator(family, jtok.make_test_wordpiece(),
                                     JConfigDict(cfg))
    our_col = tdataset.make_collator(family, ttok.make_test_wordpiece(), cfg)
    items = _items()
    ref = ref_col(items, rng=np.random.default_rng(5))["visual_inputs"]
    ours = our_col(items, rng=np.random.default_rng(5))["visual_inputs"]
    assert ours.dtype == np.uint16 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref.view(np.uint16))
    back = tpixels.host_tensor(ours)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(),
                                  ref.astype(np.float32))


def test_bf16_bits_round_like_ml_dtypes():
    """Ties to even, NaN and infinities, denormals, random bit patterns."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
            np.uint32).view(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40,
                  1.00390625, 1.01171875, 3.4e38], np.float32)])
    with np.errstate(invalid="ignore"):
        ref = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(tpixels.bf16_bits(x), ref)


@pytest.mark.parametrize("cfg", [
    {}, {"bf16": 0}, {"stage_pixels_bf16": 0}, {"stage_pixels_u8": 1},
    {"bf16": 0, "stage_pixels_u8": 1}])
def test_pixel_dtype_rule_matches_jax(cfg):
    assert tdataset.pixel_dtype_for(cfg) == \
        jdataset.pixel_dtype_for(JConfigDict(cfg))


@pytest.mark.parametrize("model", ["tiny-git", "tiny-clip"])
def test_bf16_staged_forward_equals_f32_staged(model):
    """A bf16 model's forward on bf16-staged pixels equals the same
    forward on f32-staged pixels exactly: the first product rounds the
    f32 pixels to the same bf16 values."""
    family = model.split("-")[1]
    cfg = dict(TINY_CLIP, model=dict(TINY_CLIP["model"],
                                     pretrained_model=model))
    _, tm = tpresets.build_model(cfg, dtype=torch.bfloat16, device="cpu")
    outs = []
    with torch.no_grad():
        for staging in ({"bf16": False}, {"bf16": True}):
            col = tdataset.make_collator(
                family, ttok.make_test_wordpiece(),
                dict(staging, max_txt_len=9, nframe=2,
                     samp_policy="uniform"))
            b = col(_items(), rng=np.random.default_rng(0))
            px = tpixels.host_tensor(b["visual_inputs"])
            assert px.dtype == (torch.bfloat16 if staging["bf16"]
                                else torch.float32)
            outs.append(tm(to_torch(b["text_input_ids"], torch.long),
                           to_torch(b["text_attention_mask"]),
                           px)["logits"])
    assert torch.equal(outs[0], outs[1])


def test_prefetcher_stages_bf16_leaves():
    """The prefetcher stages a uint16 leaf as the bf16 tensor of its bits."""
    x = np.linspace(-2, 2, 12, dtype=np.float32)
    pf = tpipe.DevicePrefetcher(iter([{"visual_inputs": tpixels.bf16_bits(
        x)}]), device="cpu")
    arrays, _ = next(pf)
    pf.close()
    assert arrays["visual_inputs"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        arrays["visual_inputs"].float().numpy(),
        x.astype(ml_dtypes.bfloat16).astype(np.float32))


# ---- optimizers and MultiSteps ----------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny-clip classifier's params and 8 seeded gradient trees."""
    _, jm = jpresets.build_model(JConfigDict(TINY_CLIP), dtype=jnp.float32)
    ids = jnp.ones((2, 5), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), ids, ids,
                              jnp.zeros((2, 1, 32, 32, 3)))
    rng = np.random.default_rng(1)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
        params) for _ in range(8)]
    return params, grads


def _opt_cfg(**kw):
    cfg = dict(learning_rate=1e-3, betas=[0.9, 0.98], weight_decay=1e-2,
               grad_norm=0.5, decay="linear", warmup_ratio=0.25,
               transformer_lr_mul=2.0, transformer_lr_mul_prefix="vis_model",
               num_train_epochs=1)
    cfg.update(kw)
    return cfg


def _port(params):
    _, tm = tpresets.build_model(TINY_CLIP, device="cpu")
    return load_flax_params(tm, params)


def _port_grads(tm, g):
    sd = state_dict_from_flax(numpy_tree(g))
    return [sd[n] for n, _ in tm.named_parameters()]


def _run_jax(cfg, params, grads, total):
    tx = jsteps.make_optimizer(JConfigDict(cfg), total, params=params)
    update = jax.jit(tx.update)
    state = tx.init(params)
    for g in grads:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    return params, state


def _close_params(tm, jparams, atol=PARAM_ATOL):
    ref = state_dict_from_flax(numpy_tree(jparams))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   atol=atol, rtol=0, err_msg=name)


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("optim,moments", [
    ("adamax", "f32"), ("sgd", "f32"), ("lamb", "f32"), ("adamw", "bf16")])
def test_optimizer_trajectory_matches_jax(tiny, optim, moments):
    """8 updates of seeded gradients under the clip -> optimizer (linear
    warmup/decay) -> lr_mul chain: parameters within 1e-6 of the JAX
    make_optimizer's.  An unknown name ("lamb") is adamw in both.  bf16
    moments do not match to the bit: XLA fuses the moving averages'
    multiply-adds where ATen rounds each product, so a moment near a
    rounding boundary lands on the neighbouring bf16 value, and the
    difference is carried into later updates.  Each stored moment is held
    within one bf16 step (2^-8) of its tensor's largest magnitude of
    optax's, with at least 99.9 % of them bit-equal; a moment that far off
    moves its element's update by at most 2^-7 of lr * lr_mul, so the
    parameters are held within 1e-6 but for fewer than 0.1 % of elements,
    and those within 2^-6 lr * lr_mul."""
    params, grads = tiny
    cfg = _opt_cfg(optim=optim, adamw_moment_dtype=moments)
    jparams, jstate = _run_jax(cfg, params, grads, 8)
    tm = _port(params)
    opt = tsteps.make_optimizer(cfg, 8, tm)
    assert opt.kind == {"lamb": "adamw", "adamw": "adamw/bf16"}.get(
        optim, optim)
    for g in grads:
        opt.update(_port_grads(tm, g))
    assert opt.count == 8
    if moments != "bf16":
        _close_params(tm, jparams)
        return
    _close_params(tm, jparams, atol=2 ** -6 * cfg["learning_rate"]
                  * cfg["transformer_lr_mul"])
    ref = state_dict_from_flax(numpy_tree(jparams))
    off = sum(int((np.abs(p.detach().numpy() - ref[n].numpy())
                   > PARAM_ATOL).sum()) for n, p in tm.named_parameters())
    assert off < 1e-3 * sum(p.numel() for p in tm.parameters()), off
    names = [n for n, _ in tm.named_parameters()]
    steps = equal = 0
    for key, moms in (("mu", opt.mu), ("nu", opt.nu)):
        ref = state_dict_from_flax(numpy_tree(jax.tree_util.tree_map(
            lambda x: np.asarray(x.astype(jnp.float32)),
            optax.tree_utils.tree_get(jstate, key))))
        for name, m in zip(names, moms):
            assert m.dtype == torch.bfloat16
            want = torch.from_numpy(np.ascontiguousarray(
                ref[name].numpy())).to(torch.bfloat16)
            got, ref_m = m.float().numpy(), want.float().numpy()
            np.testing.assert_allclose(
                got, ref_m, rtol=0,
                atol=2 ** -8 * float(np.abs(ref_m).max()), err_msg=name)
            same = _bits(m) == _bits(want)
            steps += int((~same).sum())
            equal += int(same.sum())
    assert equal > 999 * steps, (equal, steps)


@pytest.mark.parametrize("grad_mean", [0, 1])
def test_multisteps_matches_jax(tiny, grad_mean):
    """scan_accum 0, K=4: 8 micros through optax.MultiSteps and through
    the port's MultiSteps, state compared at every micro (the open
    window's accumulator and mini-step, the update count) and the
    parameters after each update within 1e-6."""
    params, grads = tiny
    cfg = _opt_cfg(optim="adamw", gradient_accumulation_steps=4,
                   scan_accum=0, accum_grad_mean=grad_mean)
    tx = jsteps.make_optimizer(JConfigDict(cfg), 2, params=params)
    update = jax.jit(tx.update)
    jstate, jparams = tx.init(params), params
    tm = _port(params)
    opt = tsteps.make_optimizer(cfg, 2, tm)
    assert isinstance(opt, tsteps.MultiSteps) and opt.kind == \
        "multisteps(adamw)"
    names = [n for n, _ in tm.named_parameters()]
    for i, g in enumerate(grads):
        upd, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        norm = opt.update(_port_grads(tm, g))
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)),
                                   rtol=1e-6)
        assert opt.mini_step == int(jstate.mini_step) == (i + 1) % 4
        assert opt.gradient_step == int(jstate.gradient_step) == (i + 1) // 4
        acc = state_dict_from_flax(numpy_tree(jstate.acc_grads))
        for name, a in zip(names, opt.acc):
            np.testing.assert_allclose(a.numpy(), acc[name].numpy(),
                                       atol=1e-7, rtol=1e-6, err_msg=name)
        _close_params(tm, jparams)
    assert opt.count == 2


def _train_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"text_input_ids": rng.integers(5, 512, (2, 6)).astype(np.int32),
             "text_attention_mask": np.ones((2, 6), np.int32),
             "visual_inputs": np.stack([frames(seed + 10 * i + j, 1, 32)
                                        for j in range(2)]),
             "labels": rng.integers(0, 7, (2,)).astype(np.int32)}
            for i in range(n)]


def _multisteps_state(params, **kw):
    cfg = _opt_cfg(optim="adamw", gradient_accumulation_steps=2,
                   scan_accum=0, **kw)
    return tsteps.create_train_state(_port(params), cfg, 2, device="cpu")


def test_multisteps_matches_the_scan_path_and_resumes_mid_window(
        tiny, tmp_path):
    """4 micros as 2 updates of K=2: per-micro calls through MultiSteps
    give the parameters of the scan path's 2 calls of 2 stacked micros.
    A snapshot taken after micro 3 (inside the second window) restores
    the accumulator and mini-step: the resumed run's last micro lands on
    the uninterrupted run's parameters bit for bit.  A snapshot of
    another optimizer layout is refused."""
    params, _ = tiny
    micros = _train_batches(4)
    step = tsteps.make_classifier_train_step("cpu")
    full = _multisteps_state(params)
    for i, mb in enumerate(micros):
        full, _ = step(full, mb, 5)
        if i == 2:
            TrainingRestorer(str(tmp_path), save_steps=1).force_save(3, full)
    assert full.step == 4 and full.optimizer.count == 2
    scan_cfg = _opt_cfg(optim="adamw", gradient_accumulation_steps=2)
    scan = tsteps.create_train_state(_port(params), scan_cfg, 2,
                                     device="cpu")
    scan_step = tsteps.make_scan_train_step(2, "classifier", device="cpu")
    for stacked in tpipe.stack_microbatches(iter(micros), 2):
        scan, _ = scan_step(scan, stacked, 5)
    for (name, a), b in zip(full.model.named_parameters(),
                            scan.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    resumed = TrainingRestorer(str(tmp_path)).restore_into(
        _multisteps_state(params))
    assert resumed.step == 3 and resumed.optimizer.mini_step == 1
    resumed, _ = step(resumed, micros[3], 5)
    for (name, a), b in zip(full.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    with pytest.raises(FormulationMismatchError):
        TrainingRestorer(str(tmp_path)).restore_into(
            _multisteps_state(params, adamw_moment_dtype="bf16"))


def test_restore_reads_the_older_scan_layout(tiny, tmp_path):
    """A restore snapshot whose layout predates the optimizer's kind
    ({"formulation": "scan"}: f32 Adam or AdamW moments as count, mu,
    nu) resumes an adamw run; an adamax run refuses it, naming the
    optimizer."""
    params, _ = tiny
    cfg = _opt_cfg(optim="adamw")
    state = tsteps.create_train_state(_port(params), cfg, 2, device="cpu")
    state, _ = tsteps.make_classifier_train_step("cpu")(
        state, _train_batches(1)[0], 5)
    TrainingRestorer(str(tmp_path)).force_save(1, state)
    path = os.path.join(str(tmp_path), "restore", "step_1.pt")
    saved = torch.load(path, weights_only=True)
    assert set(saved["opt_state"]) == {"count", "mu", "nu"}
    saved["layout"] = {"formulation": "scan",
                       "params": saved["layout"]["params"]}
    torch.save(saved, path)
    resumed = TrainingRestorer(str(tmp_path)).restore_into(
        tsteps.create_train_state(_port(params), cfg, 2, device="cpu"))
    assert resumed.step == 1 and resumed.optimizer.count == 1
    for (name, a), b in zip(state.model.named_parameters(),
                            resumed.model.parameters()):
        assert torch.equal(a, b), name
    for a, b in zip(state.optimizer.nu, resumed.optimizer.nu):
        assert torch.equal(a, b)
    with pytest.raises(FormulationMismatchError, match="adamax now"):
        TrainingRestorer(str(tmp_path)).restore_into(
            tsteps.create_train_state(_port(params), _opt_cfg(optim="adamax"),
                                      2, device="cpu"))


# ---- CollatorPool ------------------------------------------------------------

@pytest.fixture
def deadline():
    """Fails the test after POOL_TIMEOUT seconds instead of letting a hung
    worker hold the suite."""
    def expire(signum, frame):
        raise TimeoutError(f"pool test exceeded {POOL_TIMEOUT}s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(POOL_TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("synth")),
                                  num_videos=4, stored_frames=8, img_hw=32,
                                  questions_per_video=2)


def _train_ds(synth):
    a2l = tann.build_common_answer_dict([synth["train"]], 1000)
    grouped = tann.group_datalist(
        tann.load_datalist("msvd_qa", synth["train"]), 1, True)
    ds = tdataset.VideoQADataset("msvd_qa", grouped,
                                 FrameStoreReader(synth["h5"]),
                                 load_vidmapping(synth["vidmapping"]), a2l)
    ds.get_group(0)         # the reader's file is open when it pickles
    return ds


def _collator(pixel_dtype="bf16"):
    return tdataset.ClassifierCollator(
        ttok.make_test_wordpiece(), max_txt_len=9, nframe=2,
        samp_policy="random", pixel_dtype=pixel_dtype)


def _assert_same_batches(ours, ref):
    assert set(ours) == set(ref)
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            assert ours[key].dtype == val.dtype
            np.testing.assert_array_equal(ours[key], val, err_msg=key)
        else:
            assert ours[key] == val, key


def test_pool_batches_equal_the_thread_batches(synth, deadline):
    """Two epochs of random-policy batches from 2 spawn workers equal the
    in-thread batches of the same seed, in order; close() leaves no
    worker alive."""
    ds, col = _train_ds(synth), _collator()
    pool = tpipe.CollatorPool(ds, col, 2)
    try:
        pooled = tpipe.infinite_batches(ds, col, 3, np.random.default_rng(7),
                                        pool=pool)
        thread = tpipe.infinite_batches(ds, col, 3, np.random.default_rng(7))
        for _ in range(4):     # 8 groups in batches of 3, drop_last
            _assert_same_batches(next(pooled), next(thread))
        pids = [p.pid for p in multiprocessing.active_children()]
        assert len(pids) == 2
    finally:
        pool.close()
    assert not multiprocessing.active_children()
    for pid in pids:
        with pytest.raises(OSError):
            os.kill(pid, 0)


def test_pool_worker_exception_reaches_the_consumer(synth, deadline):
    ds = _train_ds(synth)
    qid = ds.datalist[5][1][0]["question_id"]
    pool = tpipe.CollatorPool(ds, RaisingCollator(_collator(), qid), 2)
    try:
        with pytest.raises(ValueError, match="refused question"):
            for _ in tpipe.epoch_batches(ds, pool=pool, collator=None,
                                         batch_size=2, shuffle=False):
                pass
    finally:
        pool.close()
    assert not multiprocessing.active_children()


def test_a_dead_pool_worker_fails_and_close_leaves_nothing(synth, deadline):
    """A worker killed while its batch collates (30 s a batch) fails the
    consumer's wait with BrokenProcessPool: no fallback to collation in
    the consumer's thread.  The consumer is a daemon thread, so a wait
    that never ends cannot hold the suite past the join's timeout."""
    ds = _train_ds(synth)
    pool = tpipe.CollatorPool(ds, SleepingCollator(_collator(), 30.0), 2)
    errors = []

    def consume():
        try:
            next(pool.imap(iter([(np.arange(2), 0), (np.arange(2, 4), 1)])))
        except Exception as e:  # handed to the test's thread
            errors.append(e)

    consumer = threading.Thread(target=consume, daemon=True)
    try:
        consumer.start()
        while not multiprocessing.active_children():
            time.sleep(0.05)
        time.sleep(3.0)        # spawned, imported, inside the sleep
        # the first-spawned worker: the executor's manager thread watches
        # its sentinel from its first wait, while a later worker's may be
        # added after the manager re-armed its wait (then its death goes
        # unseen until the other worker's 30 s result)
        first = next(iter(pool._executor._processes.values()))
        os.kill(first.pid, signal.SIGKILL)
        consumer.join(POOL_TIMEOUT)
        assert len(errors) == 1 and isinstance(errors[0], BrokenProcessPool)
    finally:
        pool.close()
    assert not multiprocessing.active_children()


# ---- the loop under each option ---------------------------------------------

def _loop_cfg(synth, out, **overrides):
    """tiny-clip, 3 updates of 2 micros of 2 questions, f32, dropout off."""
    cfg = dict(TINY_CLIP, **{
        "task": "msvd_qa",
        "train_datasets": [{"name": "msvd_qa", "txt": synth["train"],
                            "img": synth["h5"]}],
        "val_datasets": [{"name": "msvd_qa", "txt": synth["val"],
                          "img": synth["h5"]}],
        "inference_txt_db": synth["test"], "inference_img_db": synth["h5"],
        "vid_mapping": synth["vidmapping"], "nframe": 2,
        "samp_policy": "random", "max_n_example_per_group": 2,
        "train_batch_size": 2, "val_batch_size": 4,
        "gradient_accumulation_steps": 2, "num_train_epochs": 3,
        "min_valid_steps": 1, "num_valid": 1, "learning_rate": 1e-3,
        "decay": "constant", "optim": "adamw", "seed": 0,
        "platform": "cpu", "mesh_shape": [1], "bf16": 0,
        "output_dir": str(out), "max_txt_len": 12})
    del cfg["num_labels"]
    cfg.update(overrides)
    return cfg


def _scalars(out, tag="train/loss"):
    with open(os.path.join(out, "log", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in rows if r["tag"] == tag}


def _port_loop(synth, root, name, **overrides):
    tlogging.TB_LOGGER.global_step = 0
    cfg = _loop_cfg(synth, root / name, **overrides)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    result = trun.start_training(get_video_qa_args(
        ["--task", "msvd_qa", "--config", str(path)]))
    return result, _scalars(str(root / name))


@pytest.fixture(scope="module")
def base_loop(synth, tmp_path_factory):
    return _port_loop(synth, tmp_path_factory.mktemp("base"), "base")


@pytest.mark.parametrize("name,overrides", [
    ("multisteps", {"scan_accum": 0}),
    ("bf16_moments", {"adamw_moment_dtype": "bf16"}),
    ("adamax", {"optim": "adamax"}),
    ("sgd", {"optim": "sgd"}),
    ("pool", {"n_workers": 2}),
    ("bf16_staging", {"bf16": 1, "model": dict(TINY_CLIP["model"])})])
def test_loop_runs_under_each_option(synth, tmp_path, base_loop, name,
                                     overrides, deadline):
    """start_training takes each option on the CPU: 3 finite losses and
    the final scores; collation in 2 workers gives the in-thread run's
    losses exactly (the same batches)."""
    result, losses = _port_loop(synth, tmp_path, name, **overrides)
    assert result["global_step"] == 3 and sorted(losses) == [1, 2, 3]
    assert all(np.isfinite(list(losses.values())))
    assert "overall_acc" in result["val"]
    if name == "pool":
        assert losses == base_loop[1]
        assert result["val"] == base_loop[0]["val"]
    assert not multiprocessing.active_children()


def test_multisteps_loop_matches_jax(synth, tmp_path):
    """scan_accum 0 in both loops (MultiSteps, the loss of each window's
    last micro logged): per-update losses within 1e-5 and equal scores."""
    out = {}
    for pkg in ("jax", "port"):
        cfg = _loop_cfg(synth, tmp_path / pkg, scan_accum=0,
                        samp_policy="uniform")
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps(cfg))
        argv = ["--task", "msvd_qa", "--config", str(path)]
        jlogging.TB_LOGGER.global_step = tlogging.TB_LOGGER.global_step = 0
        if pkg == "jax":
            result = jrun.start_training(jget_args(argv))
        else:
            params = _jax_loop_init(cfg)
            mp = pytest.MonkeyPatch()
            real = trun.build_model
            mp.setattr(trun, "build_model", lambda c, **kw: (
                lambda fm: (fm[0], load_flax_params(fm[1], params)))(
                    real(c, **kw)))
            try:
                result = trun.start_training(get_video_qa_args(argv))
            finally:
                mp.undo()
        out[pkg] = (result, _scalars(str(tmp_path / pkg)))
    (jres, jl), (tres, tl) = out["jax"], out["port"]
    assert sorted(tl) == sorted(jl) == [1, 2, 3]
    np.testing.assert_allclose([tl[s] for s in (1, 2, 3)],
                               [jl[s] for s in (1, 2, 3)], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert _scalars(str(tmp_path / "port"), "train/lr") == \
        _scalars(str(tmp_path / "jax"), "train/lr")
    assert tres["val"] == jres["val"] and tres["test"] == jres["test"]


def _jax_loop_init(cfg):
    _, jm = jpresets.build_model(JConfigDict(cfg), dtype=jnp.float32)
    ids = jnp.ones((1, 4), jnp.int32)
    return jax.jit(jm.init)(jax.random.key(cfg["seed"]), ids, ids,
                            jnp.zeros((1, 1, 32, 32, 3)))
