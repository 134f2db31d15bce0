"""The port's parallel layout rules (sasvqa_torch/parallel) on the CPU
without a process group, against the JAX package's where both decide the
same thing (tests/test_sharding.py's counterparts): each rank's batch
rows on (data), (data, fsdp) and (data, model) meshes of 1, 2 and 4
ranks; batch padding; the tensor-parallel classification of every
tiny-git, tiny-clip and tiny-blip parameter and the block plan realised
from it; the FSDP leaf rule; the mesh-size and mesh-axes errors; the
process-group device rule."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax.tree_util import tree_flatten_with_path

from sasvqa_tpu.core.config import ConfigDict as JConfigDict
from sasvqa_tpu.models import presets as jpresets
from sasvqa_tpu.parallel import mesh as jmesh
from sasvqa_tpu.parallel import tp as jtp

from sasvqa_torch.core.config import get_video_qa_args
from sasvqa_torch.models.convert import flax_param_names
from sasvqa_torch.models.presets import build_model
from sasvqa_torch.parallel import mesh as tmesh
from sasvqa_torch.parallel import tp as ttp

FAMILIES = ("tiny-git", "tiny-clip", "tiny-blip")


@pytest.fixture(scope="module")
def trees():
    """family -> (port model, {Flax path: JAX leaf path, shape})."""
    out = {}
    for name in FAMILIES:
        cfg = {"model": {"pretrained_model": name, "vocab_size": 512},
               "img_size": 32, "num_labels": 7}
        _, jm = jpresets.build_model(JConfigDict(cfg), dtype=jnp.float32)
        ids = jnp.ones((1, 4), jnp.int32)
        params = jax.jit(jm.init)(jax.random.key(0), ids, ids,
                                  jnp.zeros((1, 1, 32, 32, 3)))
        leaves, _ = tree_flatten_with_path(params)
        jleaves = {".".join(str(k.key) for k in path[1:]): (path, leaf)
                   for path, leaf in leaves}
        out[name] = (build_model(cfg, device="cpu")[1], jleaves)
    return out


@pytest.mark.parametrize("axes,shape", [
    (("data",), (1,)), (("data",), (2,)), (("data",), (4,)),
    (("data", "fsdp"), (1, 2)), (("data", "fsdp"), (2, 2)),
    (("data", "model"), (1, 2)), (("data", "model"), (2, 2)),
    (("data", "fsdp", "model"), (1, 2, 2)),
])
def test_host_batch_positions(axes, shape):
    """(data, fsdp) coordinates own disjoint contiguous blocks covering
    the batch; ranks that differ only on ``model`` read the same rows."""
    layout = tmesh.MeshLayout(shape, axes)
    world = int(np.prod(shape))
    rows = 8
    per_rank = {r: tmesh.host_batch_positions(layout, rows, r)
                for r in range(world)}
    sizes = dict(zip(axes, shape))
    tp = sizes.get("model", 1)
    dp = world // tp
    blocks = {}
    for r, pos in per_rank.items():
        idx, size = tmesh.dp_coordinate(layout, r)
        assert size == dp
        assert len(pos) == rows // dp
        np.testing.assert_array_equal(pos, np.arange(pos[0], pos[0]
                                                     + len(pos)))
        blocks.setdefault(idx, []).append(pos)
    assert len(blocks) == dp
    for reps in blocks.values():        # the model replicas
        assert len(reps) == tp
        for pos in reps[1:]:
            np.testing.assert_array_equal(pos, reps[0])
    covered = np.concatenate([reps[0] for _, reps in sorted(blocks.items())])
    np.testing.assert_array_equal(covered, np.arange(rows))
    # one process: every row
    np.testing.assert_array_equal(tmesh.host_batch_positions(None, rows),
                                  np.arange(rows))


def test_host_batch_positions_refuses_partial_overlap():
    layout = tmesh.MeshLayout((3,), ("data",))
    with pytest.raises(ValueError, match="partially overlapping"):
        tmesh.host_batch_positions(layout, 8, 0)


class _Indices:
    """A dataset whose groups are their indices."""

    def __len__(self):
        return 10

    def get_group(self, i):
        return i


def _collate(items, rng):
    return {"idx": list(items), "draw": float(rng.random())}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("pos", [[0, 1], [2, 3], [0, 1, 2, 3]])
def test_epoch_batches_general_form_equals_jax(drop_last, pos):
    """A rank's rows of every global batch of 4 over two epochs: the same
    samples and collation draws as the JAX pipeline's general form."""
    from sasvqa_tpu.data import pipeline as jpipe

    from sasvqa_torch.data import pipeline as tpipe
    got, want = [], []
    for epochs, module, out in ((2, tpipe, got), (2, jpipe, want)):
        rng = np.random.default_rng(5)
        for _ in range(epochs):
            out += list(module.epoch_batches(
                _Indices(), _collate, len(pos), True, rng,
                drop_last=drop_last, host_positions=np.asarray(pos),
                global_batch=4))
    assert got == want and len(got) == (4 if drop_last else 6)


@pytest.mark.parametrize("multiple", [1, 2, 3, 4])
def test_pad_batch_to_multiple_equals_jax(multiple):
    rng = np.random.default_rng(multiple)
    batch = {"visual_inputs": rng.normal(size=(5, 2, 3)).astype(np.float32),
             "text_input_ids": rng.integers(0, 9, (5, 4)).astype(np.int32),
             "labels": rng.integers(0, 3, 5), "question_ids": list("abcde"),
             "extra": None}
    want = jmesh.pad_batch_to_multiple(dict(batch), multiple)
    got = tmesh.pad_batch_to_multiple(dict(batch), multiple)
    assert set(got) == set(want)
    for k in want:
        if hasattr(want[k], "shape"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k]


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_classification_equals_jax(trees, family):
    """One rule decides both packages: every parameter's kind from its
    Flax path equals the JAX ``_classify`` of the same leaf."""
    model, jleaves = trees[family]
    names = flax_param_names(model)
    assert set(names.values()) == set(jleaves)
    kinds = ttp.classify_params(model)
    for name, flax in names.items():
        path, _ = jleaves[flax]
        assert kinds[name] == jtp._classify(path), flax
    assert {"column", "row"} <= set(kinds.values())


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("tp", [2, 3])
def test_tp_plan_realises_the_classification(trees, family, tp):
    """The block plan shards only classified projections, attention by
    whole heads and MLPs by hidden units; the fused qkv head-aligned; a
    column projection without a sharded partner (the LM head) gathers
    its output; a size the TP degree does not divide stays replicated."""
    model, _ = trees[family]
    kinds = {n.rsplit(".", 1)[0]: k
             for n, k in ttp.classify_params(model).items()
             if n.endswith(".weight")}
    plan = ttp.tp_plan(model, tp)
    assert plan
    for name, style in plan.items():
        mod = model.get_submodule(name)
        if style is None:                       # a sharded attention block
            assert mod.num_heads % tp == 0
            continue
        out_f, in_f = mod.weight.shape
        if isinstance(style, ttp.RowwiseParallel):
            assert kinds[name] == "row" and in_f % tp == 0
        else:
            assert kinds[name] == "column" and out_f % tp == 0
        if isinstance(style, ttp._FusedQKVColwise):
            assert name.endswith("qkv") and plan[name.rsplit(".", 1)[0]] \
                is None
    if family == "tiny-git":
        vocab = model.config.vocab_size
        assert ("output" in plan) == (vocab % tp == 0)
        if "output" in plan:
            assert plan["output"].output_layouts[0].is_replicate()
        heads_ok = model.config.num_heads % tp == 0
        assert ("layer_0.attention" in plan) == heads_ok
        assert isinstance(plan.get("layer_0.attention.qkv"),
                          ttp._FusedQKVColwise) == heads_ok


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n_shard,min_size", [(1, 2 ** 16), (2, 64),
                                              (4, 64), (3, 64)])
def test_fsdp_leaf_rule_equals_jax(trees, family, n_shard, min_size):
    """Which leaves FSDP shards: the JAX ``fsdp_leaf_sharding`` decision
    for every leaf (the port's leaves are the Flax ones, transposed)."""
    model, jleaves = trees[family]
    devices = np.array(jax.devices("cpu")[:n_shard])
    jm = jax.sharding.Mesh(devices, ("fsdp",))
    names = flax_param_names(model)
    n_sharded = 0
    for name, p in model.named_parameters():
        _, leaf = jleaves[names[name]]
        want = jmesh.fsdp_leaf_sharding(leaf, jm, "fsdp", n_shard,
                                        min_size).spec != P()
        axis = tmesh.fsdp_leaf_sharding(tuple(p.shape), n_shard, min_size)
        assert (axis is not None) == want, name
        if axis is not None:
            assert p.shape[axis] == max(p.shape)
            n_sharded += 1
    assert n_sharded > 0 or min_size == 2 ** 16


def test_mesh_size_must_be_the_world_size():
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        tmesh.make_mesh([2])
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        tmesh.mesh_spec([2, 2], ["data", "fsdp"], world=2)
    assert tmesh.mesh_spec(None, ["data", "fsdp"], world=4) == \
        ((4, 1), ("data", "fsdp"))
    assert tmesh.make_mesh([1]) is None      # one process, no group
    with pytest.raises(ValueError, match="name 1"):
        tmesh.mesh_spec([2, 2], ["data"], world=4)
    with pytest.raises(ValueError, match="at most once"):
        tmesh.mesh_spec([2, 2], ["data", "data"], world=4)


@pytest.mark.parametrize("flags,match", [
    (["--mesh_shape", "2", "2"], "name 1"),
    (["--mesh_shape", "2", "--mesh_axes", "data", "fsdp"], "name 2"),
    (["--mesh_axes", "data", "pipe"], "at most once"),
])
def test_config_checks_mesh_axes(tmp_path, flags, match):
    path = tmp_path / "c.json"
    path.write_text('{"task": "msvd_qa"}')
    with pytest.raises(ValueError, match=match):
        get_video_qa_args(["--config", str(path)] + flags)


def test_init_distributed_device_rule(monkeypatch):
    """No WORLD_SIZE: no group.  With one, the GPU unless the CPU is asked
    for: no CUDA raises before anything joins."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmesh.init_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="platform 'cpu'"):
        tmesh.init_distributed(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 has no GPU"):
        tmesh.init_distributed(None)
    assert not tmesh.is_distributed()
