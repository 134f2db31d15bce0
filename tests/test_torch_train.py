"""Port training slice vs the JAX package, in f32 on the CPU: the tiny-GIT
training forward and gradients on both attention routes, the dropouts,
the optimizer (groups, clipping, schedules, lr_at) and the K-micro scan
train step's trajectory in mean and sum modes."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from sasvqa_tpu.core.config import ConfigDict
from sasvqa_tpu.data.pipeline import stack_microbatches as jax_stack
from sasvqa_tpu.models import git as jgit
from sasvqa_tpu.ops import git_flash as jgf
from sasvqa_tpu.train import schedules as jsched
from sasvqa_tpu.train import steps as jsteps

from sasvqa_torch.data.pipeline import stack_microbatches
from sasvqa_torch.models import git as tgit
from sasvqa_torch.models.convert import state_dict_from_flax
from sasvqa_torch.models.layers import Dropout
from sasvqa_torch.ops import _build
from sasvqa_torch.train import schedules as tsched
from sasvqa_torch.train import steps as tsteps

from _torch_parity import (load_flax_params, numpy_tree, port_git_config,
                           to_torch)
from test_torch_git import ROUTES

# f32 forward and gradients of a 2-layer model: summation order differs
# between XLA and ATen, relative error ~1e-6 of each gradient's scale
ATOL, RTOL = 2e-5, 2e-4


@pytest.fixture(autouse=True)
def interpret_mode():
    jgf.set_interpret_mode(True)
    yield
    jgf.set_interpret_mode(False)


def _no_dropout(cfg, attention_dropout=0.0, dropout=0.0):
    return dataclasses.replace(cfg, dropout=dropout,
                               attention_dropout=attention_dropout)


def _pair(route, **drop):
    base, flash = ROUTES[route]
    cfg = _no_dropout(base, **drop)
    jm = jgit.GITForCausalLM(cfg, flash=flash)
    img = cfg.vision.image_size
    ids = jnp.ones((1, 4), jnp.int32)
    params = jax.jit(jm.init)(jax.random.key(0), ids, ids,
                              jnp.zeros((1, 1, img, img, 3)))
    tm = load_flax_params(tgit.GITForCausalLM(port_git_config(cfg),
                                              flash=flash), params)
    return jm, params, tm.train()


def _batch(cfg, b=3, t=2, l=10, seed=0):
    rng = np.random.default_rng(seed)
    img = cfg.vision.image_size
    ids = rng.integers(5, cfg.vocab_size, size=(b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1:, 7:] = 0
    mask[2:, 4:] = 0
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :3] = -100                   # the question prefix
    px = rng.normal(size=(b, t, img, img, 3)).astype(np.float32)
    return {"text_input_ids": ids, "text_attention_mask": mask,
            "visual_inputs": px, "labels": labels}


def _port_grads(tm):
    return {n: p.grad.numpy() for n, p in tm.named_parameters()}


def _assert_tree_close(port: dict, flax_tree, atol=ATOL, rtol=RTOL,
                       key_bias_atol=None):
    """Every leaf within (atol, rtol).  ``key_bias_atol``: the K third of
    each fused qkv bias is compared only within this bound: softmax does
    not change when a constant is added to every key, so that bias's true
    gradient is 0 and both frameworks hand Adam f32 rounding noise, which
    it scales up to steps of size ~lr with an arbitrary sign."""
    ref = state_dict_from_flax(numpy_tree(flax_tree))
    assert set(port) == set(ref)
    for name, val in ref.items():
        ours, val = port[name], val.numpy()
        if key_bias_atol is not None and name.endswith("qkv.bias"):
            d = val.shape[0] // 3
            np.testing.assert_allclose(ours[d:2 * d], val[d:2 * d],
                                       atol=key_bias_atol, rtol=0,
                                       err_msg=name)
            ours, val = np.delete(ours, np.s_[d:2 * d]), \
                np.delete(val, np.s_[d:2 * d])
        np.testing.assert_allclose(ours, val, atol=atol, rtol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_training_forward_loss_and_grads_match_jax(route):
    """deterministic=False with both dropout rates 0: loss and every
    parameter's gradient equal jax.grad of the JAX training forward (the
    git-flash route runs the JAX Pallas kernels in interpret mode and the
    port's plain forward and backward)."""
    jm, params, tm = _pair(route)
    bt = _batch(jm.config)

    def loss_fn(p):
        return jm.apply(p, bt["text_input_ids"], bt["text_attention_mask"],
                        bt["visual_inputs"], labels=bt["labels"],
                        deterministic=False,
                        rngs={"dropout": jax.random.key(1)})["loss"]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    loss = tm(to_torch(bt["text_input_ids"], torch.long),
              to_torch(bt["text_attention_mask"]),
              to_torch(bt["visual_inputs"]),
              labels=to_torch(bt["labels"], torch.long), deterministic=False,
              generator=torch.Generator().manual_seed(1))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL,
                               rtol=RTOL)
    _assert_tree_close(_port_grads(tm), jgrads)


def _port_loss(tm, bt, seed, deterministic=False):
    return tm(to_torch(bt["text_input_ids"], torch.long),
              to_torch(bt["text_attention_mask"]),
              to_torch(bt["visual_inputs"]),
              labels=to_torch(bt["labels"], torch.long),
              deterministic=deterministic,
              generator=torch.Generator().manual_seed(seed))["loss"]


def test_flash_route_matches_dense_route_with_attention_dropout():
    """Equal seeds draw equal masks on both routes: the git-flash route's
    plain kernels and the dense hash-dropout route give the same loss and
    gradients at attention dropout 0.3 (and hidden dropout 0.1); the loss
    is seed-deterministic, varies with the seed and differs from the
    deterministic forward (the JAX test_model_train_step_with_attention_
    dropout pattern)."""
    _, params, flash = _pair("git_flash", attention_dropout=0.3, dropout=0.1)
    cfg = flash.config
    dense = load_flax_params(tgit.GITForCausalLM(cfg, flash=False),
                             params).train()
    bt = _batch(cfg, seed=4)
    lf, ld = _port_loss(flash, bt, 5), _port_loss(dense, bt, 5)
    lf.backward()
    ld.backward()
    np.testing.assert_allclose(lf.item(), ld.item(), atol=ATOL, rtol=RTOL)
    gf, gd = _port_grads(flash), _port_grads(dense)
    for name in gf:
        np.testing.assert_allclose(gf[name], gd[name], atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    with torch.no_grad():
        again = _port_loss(flash, bt, 5).item()
        other = _port_loss(flash, bt, 6).item()
        det = _port_loss(flash, bt, 5, deterministic=True).item()
    assert again == lf.item()
    assert other != again and det != again
    with pytest.raises(ValueError, match="generator"):
        flash(to_torch(bt["text_input_ids"], torch.long),
              to_torch(bt["text_attention_mask"]),
              to_torch(bt["visual_inputs"]), deterministic=False)


def test_dropout_module_keeps_rate_and_scale():
    x = torch.ones(200_000)
    y = Dropout(0.3)(x, torch.Generator().manual_seed(0))
    assert abs((y == 0).float().mean().item() - 0.3) < 0.01
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(Dropout(0.3)(x), x)            # no generator: off
    assert torch.equal(Dropout(0.0)(x, torch.Generator()), x)


# ---- optimizer ------------------------------------------------------------

def _flat_flax(tree):
    """{Flax dotted path without the 'params' root: leaf}"""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", k)) for k in path
                     if getattr(k, "key", k) != "params"): leaf
            for path, leaf in flat}


def test_decay_and_lr_mul_masks_match_jax():
    """Biases and LayerNorm scales never decay, embeddings do, exactly as
    the JAX masks over the same model; lr_mul matches the Flax-equivalent
    dotted name."""
    _, params, tm = _pair("dense")
    names = tsteps.flax_param_names(tm)
    ours = {names[n]: v for n, v in tsteps.decay_mask(tm).items()}
    assert ours == _flat_flax(jsteps.decay_mask(params))
    assert ours["word_embeddings.embedding"] is True
    assert ours["layer_0.attention.out_ln.scale"] is False
    assert ours["layer_0.attention.qkv.bias"] is False
    for prefix in ("image_encoder", "attention.qkv", "ln.scale"):
        ours = {names[n]: v for n, v in tsteps.lr_mul_mask(tm, prefix).items()}
        assert ours == _flat_flax(jsteps.lr_mul_mask(params, prefix))
        assert any(ours.values())


def _opt_cfg(**kw):
    base = dict(optim="adamw", learning_rate=3e-3, decay="linear",
                warmup_ratio=0.25, weight_decay=0.05, betas=[0.9, 0.98],
                grad_norm=1.0, num_train_epochs=1,
                gradient_accumulation_steps=1, transformer_lr_mul=0.5,
                transformer_lr_mul_prefix="image_encoder")
    base.update(kw)
    return base


@pytest.mark.parametrize("grad_norm", [1.0, 1e6, -1])
def test_adamw_updates_match_optax_chain(grad_norm):
    """Three updates of the port's optimizer equal the JAX make_optimizer
    chain (clip -> adamw with the decay mask and a linear schedule -> lr_mul)
    on the same params and gradients: clipping on, never triggered, and
    off."""
    _, params, tm = _pair("dense")
    cfg = _opt_cfg(grad_norm=grad_norm)
    total = 8
    tx = jsteps.make_optimizer(ConfigDict(cfg), total, params=params)
    opt = tsteps.make_optimizer(cfg, total, tm)
    rng = np.random.default_rng(9)
    jp, jstate = params, tx.init(params)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape) * 0.3,
                                  jnp.float32), params)
        port_g = state_dict_from_flax(numpy_tree(grads))
        updates, jstate = tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        gnorm = opt.update([port_g[n] for n, _ in tm.named_parameters()])
        np.testing.assert_allclose(gnorm.item(),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-6)
    assert set(port_g) == {n for n, _ in tm.named_parameters()}
    ours = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    # three f32 Adam updates of size ~lr: rounding of the f32 moments
    _assert_tree_close(ours, jp, atol=1e-6, rtol=1e-5)


def test_clip_uses_optax_formula():
    p = torch.nn.Parameter(torch.zeros(4))
    opt = tsteps.AdamW([p], tsched.constant(1.0), 0.9, 0.98, 0.0, [False],
                       [1.0], max_norm=2.0)
    g = torch.tensor([3.0, 4.0, 0.0, 0.0])          # norm 5 >= 2: clipped
    assert opt.update([g]).item() == 5.0
    # first Adam step of a clipped g: mu_hat/sqrt(nu_hat) = sign(g)
    np.testing.assert_allclose(p.detach().numpy(), [-1, -1, 0, 0],
                               atol=1e-6)


@pytest.mark.parametrize("decay,kw", [
    ("constant", {}),
    ("multi_step", {"milestones": [5, 17], "gamma": 0.3}),
    ("linear", {"warmup_ratio": 0.2}),
    ("invsqrt", {"warmup_ratio": 0.1}),
])
def test_schedules_match_jax(decay, kw):
    total = 40
    args = dict(total_steps=total, warmup_ratio=kw.get("warmup_ratio", 0.1),
                milestones=kw.get("milestones"), gamma=kw.get("gamma", 0.5))
    jfn = jsched.get_lr_schedule(decay, 3e-4, **args)
    tfn = tsched.get_lr_schedule(decay, 3e-4, **args)
    for step in range(total + 5):
        ref = float(jfn(jnp.asarray(step)))
        np.testing.assert_allclose(tfn(step), ref, rtol=1e-6)
        np.testing.assert_allclose(
            tsched.lr_value(decay, 3e-4, step, **args),
            jsched.lr_value(decay, 3e-4, step, **args), rtol=1e-12)
    with pytest.raises(ValueError, match="unknown decay"):
        tsched.get_lr_schedule("cosine", 1.0)


def test_lr_at_matches_jax():
    cfg = dict(optim="adamw", learning_rate=1e-2, decay="multi_step",
               step_decay_epochs=[1], num_train_epochs=2, gamma=0.5)
    for gs in range(1, 10):
        assert tsteps.lr_at(cfg, 8, gs) == jsteps.lr_at(ConfigDict(cfg), 8,
                                                        gs)
    lin = dict(learning_rate=1e-3, decay="linear", warmup_ratio=0.25)
    for gs in range(1, 12):
        np.testing.assert_allclose(tsteps.lr_at(lin, 10, gs),
                                   jsteps.lr_at(ConfigDict(lin), 10, gs),
                                   rtol=1e-12)


# ---- the scan train step ----------------------------------------------------

def _micros(cfg, n, seed=0):
    return [_batch(cfg, b=2, t=1, l=8, seed=seed + i) for i in range(n)]


@pytest.mark.parametrize("grad_mean", [True, False])
def test_scan_train_step_trajectory_matches_jax(grad_mean):
    """8 micro-batches as 4 updates of K=2 through make_scan_train_step
    (family "git"): each update's loss (mean over its micros) and
    grad_norm, the micro counter and the final params equal the JAX scan
    step's, in gradient-mean and gradient-sum modes."""
    k = 2
    jm, params, tm = _pair("dense")
    cfg = _opt_cfg(learning_rate=1e-3, decay="constant", grad_norm=0.5,
                   gradient_accumulation_steps=k, scan_accum=1)
    micros = _micros(jm.config, 8)
    total = 4

    jstate = jsteps.create_train_state(
        jm, jax.tree_util.tree_map(jnp.array, params), ConfigDict(cfg),
        total)
    jstep = jsteps.make_scan_train_step(k, "git", grad_mean=grad_mean)
    state = tsteps.create_train_state(tm, cfg, total, device="cpu")
    step = tsteps.make_scan_train_step(k, "git", grad_mean=grad_mean,
                                       device="cpu")
    key = jax.random.key(3)
    for jb, tb in zip(jax_stack(iter(micros), k),
                      stack_microbatches(iter(micros), k)):
        jstate, jm_ = jstep(jstate, jb, key)
        state, m = step(state, tb, 3)
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(jm_["grad_norm"]), rtol=1e-4)
    assert state.step == int(jstate.step) == 8
    assert state.optimizer.count == 4
    ours = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    # four clipped Adam updates of size <= lr (1e-3); f32 rounding of the
    # gradients reaches the params through m/sqrt(v).  The key bias, whose
    # gradient is pure rounding noise, moves by at most 4 updates of lr.
    _assert_tree_close(ours, jstate.params, atol=2e-6, rtol=1e-4,
                       key_bias_atol=4 * 1e-3 * 2)


def test_git_train_step_is_one_micro_scan():
    """make_git_train_step == make_scan_train_step(1) on the same batch,
    with dropout on (same seed -> same generator stream)."""
    _, params, ta = _pair("dense", attention_dropout=0.2, dropout=0.1)
    tb = load_flax_params(tgit.GITForCausalLM(ta.config, flash=False),
                          params)
    cfg = _opt_cfg(decay="constant")
    bt = _batch(ta.config)
    sa = tsteps.create_train_state(ta, cfg, 2, device="cpu")
    sb = tsteps.create_train_state(tb, cfg, 2, device="cpu")
    sa, ma = tsteps.make_git_train_step(device="cpu")(sa, bt, 11)
    stacked = {k: v[None] for k, v in bt.items()}
    sb, mb = tsteps.make_scan_train_step(1, device="cpu")(sb, stacked, 11)
    assert sa.step == sb.step == 1
    assert ma["loss"].item() == mb["loss"].item()
    for (n, pa), pb in zip(ta.named_parameters(), tb.parameters()):
        assert torch.equal(pa, pb), n
        assert torch.equal(pa.grad, pb.grad), n


def test_stack_microbatches_matches_jax():
    micros = _micros(jgit.GIT_BASE, 5)
    for mb in micros:
        mb["question_ids"] = ["a", "b"]
        mb["n_examples_list"] = [1, 1]
    ours = list(stack_microbatches(iter(micros), 2))
    ref = list(jax_stack(iter(micros), 2))
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]


# ---- the captured micro (MicroGraph) ----------------------------------------

def _tiny_git():
    cfg = port_git_config(_no_dropout(ROUTES["dense"][0],
                                      attention_dropout=0.1, dropout=0.1))
    return tgit.GITForCausalLM(cfg, flash=False)


def _tiny_clip():
    from sasvqa_torch.models.presets import build_model
    return build_model({"model": {"pretrained_model": "tiny-clip"},
                        "img_size": 32, "num_labels": 5,
                        "classifier": "mlp"}, device="cpu")[1]


def _family_micros(family, n, seed=0):
    if family == "git":
        return _micros(port_git_config(ROUTES["dense"][0]), n, seed)
    out = []
    for i in range(n):
        rng = np.random.default_rng(seed + i)
        mask = np.ones((3, 6), np.int32)
        mask[1:, 4:] = 0
        out.append({"text_input_ids": rng.integers(3, 400, (3, 6)),
                    "text_attention_mask": mask,
                    "visual_inputs": rng.normal(
                        size=(3, 1, 32, 32, 3)).astype(np.float32),
                    "labels": rng.integers(0, 5, (3,))})
    return out


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


class _RunOnTheCPU(tsteps.MicroGraph):
    """The graph route with the graph's work (the shared micro on the
    static buffers, with the device-scalar Welford factor) run eagerly
    where the graph would replay it, on the CPU."""

    WARMUP = 1

    def takes(self, state, dev, mb):
        return True

    def _record(self, model, params, dev):
        return lambda: self._run(model, params, dev)

    def bound_run_ahead(self):
        pass                # the CPU runs each op as it is called


def test_micro_graph_route_is_chosen_from_what_the_step_observes():
    """The graph is taken on a CUDA device, without a process group or
    remat, for micros with the shapes and dtypes of the first one it took
    on the same model; anything else, the CPU first, stays eager."""
    cuda = torch.device("cuda")      # only compared: nothing runs there
    cfg = _opt_cfg(decay="constant")
    state = tsteps.create_train_state(_tiny_git(), cfg, 4, device="cpu")
    mb = _micros(port_git_config(ROUTES["dense"][0]), 1)[0]
    g = tsteps.MicroGraph(tsteps._git_loss, True)
    assert not g.takes(state, torch.device("cpu"), mb)
    assert not g.takes(dataclasses.replace(state, plan=object()), cuda, mb)
    remat = tgit.GITForCausalLM(_tiny_git().config, flash=False, remat=True)
    rstate = tsteps.create_train_state(remat, cfg, 4, device="cpu")
    assert not g.takes(rstate, cuda, mb) and g.key is None
    assert g.takes(state, cuda, mb)              # fixes the captured key
    assert g.takes(state, cuda, dict(_micros(
        port_git_config(ROUTES["dense"][0]), 1, seed=5)[0]))
    longer = _batch(port_git_config(ROUTES["dense"][0]), b=2, t=1, l=9)
    assert not g.takes(state, cuda, longer)
    assert not g.takes(state, cuda, dict(
        mb, visual_inputs=mb["visual_inputs"].astype(np.float64)))
    other = tsteps.create_train_state(_tiny_git(), cfg, 4, device="cpu")
    assert not g.takes(other, cuda, mb)
    assert not g.takes(rstate, cuda, mb)
    # on the CPU every micro of a step runs eagerly
    tsteps.reset_micro_counts()
    step = tsteps.make_scan_train_step(2, device="cpu")
    state, _ = step(state, next(stack_microbatches(iter(
        _micros(port_git_config(ROUTES["dense"][0]), 2)), 2)), 0)
    assert tsteps.micro_counts == {"replayed": 0, "eager": 2}


@pytest.mark.parametrize("family", ["git", "classifier"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("grad_mean", [True, False])
def test_micro_graph_body_equals_the_eager_path_bitwise(family, k,
                                                        grad_mean):
    """The graph route with the graph's work run eagerly (static inputs,
    the reseeded generator, the device-scalar Welford factor, the static
    accumulators, micro 0's copy, the cloned outputs) gives the eager
    path's losses, counts, gradients, AdamW moments and parameters bit
    for bit, over updates that warm up, capture mid-update and replay."""
    build = _tiny_git if family == "git" else _tiny_clip
    loss_fn = tsteps._loss_fn(family, 0)
    cfg = _opt_cfg(decay="constant", grad_norm=0.5)
    eager = tsteps.create_train_state(build().train(), cfg, 8, device="cpu")
    graphed = tsteps.create_train_state(build().train(), cfg, 8,
                                        device="cpu")
    graph = _RunOnTheCPU(loss_fn, grad_mean)
    cpu = torch.device("cpu")
    tsteps.reset_micro_counts()
    updates = 3 if k == 1 else 2
    micros = _family_micros(family, k * updates)
    for u in range(updates):
        mbs = micros[u * k:(u + 1) * k]
        eager, me = tsteps._accumulate_and_update(eager, mbs, 9, grad_mean,
                                                  cpu, loss_fn)
        graphed, mg = tsteps._accumulate_and_update(graphed, mbs, 9,
                                                    grad_mean, cpu, loss_fn,
                                                    graph)
        assert me.keys() == mg.keys()
        for key in me:
            assert torch.equal(_bits(me[key]), _bits(mg[key])), (u, key)
    assert tsteps.micro_counts["replayed"] == k * updates - 1
    for (name, pe), pg in zip(eager.model.named_parameters(),
                              graphed.model.parameters()):
        assert torch.equal(_bits(pe), _bits(pg)), name
        assert torch.equal(_bits(pe.grad), _bits(pg.grad)), name
    for moments in ("mu", "nu"):
        for a, b in zip(getattr(eager.optimizer, moments),
                        getattr(graphed.optimizer, moments)):
            assert torch.equal(_bits(a), _bits(b)), moments


def test_a_capture_takes_back_its_launch_counts_and_replays_add_them():
    """The wrappers' counts made while a graph is captured (nothing ran)
    leave ``launch_counts`` and come back once a replay, counted in
    ``replayed_counts`` too; a reset clears both."""
    _build.reset_launch_counts()
    _build.count_launch("git_flash_fwd")
    with _build.capturing() as recorded:
        _build.count_launch("git_flash_fwd")
        _build.count_launch(_build.HASH_DROPOUT)
    assert recorded == {"git_flash_fwd": 1, _build.HASH_DROPOUT: 1}
    assert _build.launch_counts["git_flash_fwd"] == 1
    assert _build.launch_counts[_build.HASH_DROPOUT] == 0
    for _ in range(3):
        _build.count_replay(recorded)
    assert _build.launch_counts["git_flash_fwd"] == 4
    assert _build.replayed_counts == dict(
        dict.fromkeys(_build.COUNTERS, 0), git_flash_fwd=3,
        **{_build.HASH_DROPOUT: 3})
    _build.reset_launch_counts()
    assert not any(_build.launch_counts.values())
    assert not any(_build.replayed_counts.values())
