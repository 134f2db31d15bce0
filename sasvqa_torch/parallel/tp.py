"""Megatron tensor parallelism over the ``model`` mesh axis (counterpart
of sasvqa_tpu/parallel/tp.py), realised with ``parallelize_module``.

One rule decides both packages: :func:`classify` reads a parameter's Flax
path (``models/convert.flax_param_names``) as the JAX package's
``_classify`` does.  Column-parallel projections (qkv, q/k/v, fc1,
intermediate, the LM head) shard their output features, row-parallel
ones (out_proj, out_dense, fc2, the FFN's output) their input features.

The realisation works block by block, so that every kernel sees local,
plain, contiguous tensors:

- an attention block whose head count the TP size divides shards its
  q/k/v projections by heads and its output projection by rows; each rank
  then attends over its own heads (the block's ``num_heads`` becomes the
  local count).  GIT's and CLIP's fused qkv (one ``Dense(D, 3D)`` split
  by ``chunk(3)``) shards head-aligned: rank r holds the rows of its
  heads of q, of k and of v (``_StridedShard(0, split_factor=3)``), so
  the local ``chunk(3)`` is right and the whole tensor keeps the
  unsharded layout;
- an MLP whose hidden width the TP size divides shards fc1/intermediate
  by columns and fc2/output by rows;
- any other column projection (the LM head over the vocabulary) gathers
  its output, so that the loss reduces over the whole vocabulary; any
  other row projection slices its replicated input;
- a dimension the TP size does not divide stays replicated, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor import distribute_module, distribute_tensor
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)

from sasvqa_torch.models.convert import flax_param_names
from sasvqa_torch.models.layers import Dense

# module names whose Dense shards OUTPUT features (column-parallel)
_COLUMN = frozenset({
    "qkv", "q_proj", "k_proj", "v_proj",       # CLIP/GIT attention
    "query", "key", "value",                   # BERT attention
    "fc1", "intermediate",                     # MLPs (CLIP / BERT / GIT)
})
# module names whose Dense shards INPUT features (row-parallel)
_ROW = frozenset({"out_proj", "out_dense", "fc2"})

_ATTN_COLUMN = ("qkv", "q_proj", "k_proj", "v_proj", "query", "key", "value")
_ATTN_ROW = ("out_proj", "out_dense")
_MLP = (("fc1", "fc2"), ("intermediate", "output"))


def classify(flax_path: str) -> Optional[str]:
    """'column' | 'row' | None for one dotted Flax parameter path (the JAX
    package's ``_classify``)."""
    names = flax_path.split(".")
    if len(names) < 2:
        return None
    module = names[-2]
    parent = names[-3] if len(names) >= 3 else None
    if module in _COLUMN:
        return "column"
    if module in _ROW:
        return "row"
    if module == "output":
        # GitFFN/BertFFN second dense lives under an "ffn" scope; the
        # top-level GIT LM head does not
        return "row" if parent == "ffn" else "column"
    return None


def classify_params(model: nn.Module) -> Dict[str, Optional[str]]:
    """Parameter name -> :func:`classify` of its Flax path."""
    return {name: classify(flax)
            for name, flax in flax_param_names(model).items()}


class _DenseColwise(ColwiseParallel):
    """ColwiseParallel for the port's :class:`Dense` (weight (out, in))."""

    def _apply(self, module, device_mesh):
        return distribute_module(
            module, device_mesh, self._partition_linear_fn,
            functools.partial(self._prepare_input_fn, self.input_layouts,
                              self.desired_input_layouts),
            functools.partial(self._prepare_output_fn, self.output_layouts,
                              self.use_local_output))


class _DenseRowwise(RowwiseParallel):
    """RowwiseParallel for the port's :class:`Dense`."""

    def _apply(self, module, device_mesh):
        self.desired_input_layouts = (Shard(-1),)
        return distribute_module(
            module, device_mesh, self._partition_linear_fn,
            functools.partial(self._prepare_input_fn, self.input_layouts,
                              self.desired_input_layouts),
            functools.partial(self._prepare_output_fn, self.output_layouts,
                              self.use_local_output))


def _local_linear(module: Dense, x):
    dt = module.dtype
    bias = None if module.bias is None else module.bias.to_local().to(dt)
    return F.linear(x.to(dt), module.weight.to_local().to(dt), bias)


class _FusedQKVColwise(ColwiseParallel):
    """Head-aligned column parallelism of a fused (D, 3D) qkv: rank r
    holds [q_r; k_r; v_r] and computes its local (.., 3D/tp) output from
    plain tensors; the replicated input's gradient is all-reduced."""

    def _partition_linear_fn(self, name, module, device_mesh):
        from torch.distributed.tensor.placement_types import _StridedShard
        for pname, param in list(module.named_parameters(recurse=False)):
            module.register_parameter(pname, nn.Parameter(
                distribute_tensor(param, device_mesh,
                                  [_StridedShard(0, split_factor=3)]),
                requires_grad=param.requires_grad))

    @staticmethod
    def _input_fn(mod, inputs, device_mesh):
        # identity forward; the gradient of the replicated input is a
        # partial sum over the model axis, reduced on the way back
        return DTensor.from_local(inputs[0], device_mesh, [Replicate()],
                                  run_check=False).to_local(
            grad_placements=[Partial()])

    def _apply(self, module, device_mesh):
        module = distribute_module(module, device_mesh,
                                   self._partition_linear_fn,
                                   self._input_fn)
        module.forward = functools.partial(_local_linear, module)
        return module


def _dense(parent: nn.Module, name: str) -> Optional[Dense]:
    child = getattr(parent, name, None)
    return child if isinstance(child, Dense) else None


def tp_plan(model: nn.Module, tp: int) -> Dict[str, object]:
    """Module name -> parallel style for a TP size ``tp`` (see the module
    doc); attention blocks it shards are listed under their own name with
    the style None, for :func:`apply_tp` to divide their head count."""
    kinds = {n.rsplit(".", 1)[0]: k for n, k in classify_params(model).items()
             if n.endswith(".weight") and k is not None}
    plan: Dict[str, object] = {}
    for pname, parent in model.named_modules():
        prefix = f"{pname}." if pname else ""
        cols = [c for c in _ATTN_COLUMN if _dense(parent, c) is not None]
        rows = [r for r in _ATTN_ROW if _dense(parent, r) is not None]
        heads = getattr(parent, "num_heads", None)
        if (cols and len(rows) == 1 and isinstance(heads, int)
                and heads % tp == 0
                and all(kinds.get(prefix + c) == "column" for c in cols)
                and kinds.get(prefix + rows[0]) == "row"):
            for c in cols:
                plan[prefix + c] = (_FusedQKVColwise() if c == "qkv"
                                    else _DenseColwise())
            plan[prefix + rows[0]] = _DenseRowwise()
            plan[pname] = None
        for col, row in _MLP:
            fc1, fc2 = _dense(parent, col), _dense(parent, row)
            if (fc1 is not None and fc2 is not None
                    and kinds.get(prefix + col) == "column"
                    and kinds.get(prefix + row) == "row"
                    and fc1.weight.shape[0] % tp == 0):
                plan[prefix + col] = _DenseColwise()
                plan[prefix + row] = _DenseRowwise()
    for name, kind in kinds.items():
        if name in plan:
            continue
        mod = model.get_submodule(name)
        if not isinstance(mod, Dense):
            continue
        out_f, in_f = mod.weight.shape
        if kind == "column" and out_f % tp == 0:
            plan[name] = _DenseColwise(output_layouts=Replicate())
        elif kind == "row" and in_f % tp == 0:
            plan[name] = _DenseRowwise(input_layouts=Replicate())
    return plan


def apply_tp(model: nn.Module, tp_mesh) -> Dict[str, Optional[int]]:
    """Tensor-parallelise ``model`` in place over the 1-D ``tp_mesh``.
    Returns, for each parameter it sharded, the dimension a composed
    FSDP may shard (the JAX package's other dimension: a column weight's
    input features, a row weight's output features), or None for the
    biases, which FSDP leaves alone."""
    tp = tp_mesh.size()
    plan = tp_plan(model, tp)
    for name, style in plan.items():
        if style is None:
            block = model.get_submodule(name)
            block.num_heads //= tp
    styles = {n: s for n, s in plan.items() if s is not None}
    parallelize_module(model, tp_mesh, styles)
    other: Dict[str, Optional[int]] = {}
    for name, style in styles.items():
        mod = model.get_submodule(name)
        row = isinstance(style, RowwiseParallel)
        other[f"{name}.weight"] = 0 if row else 1
        if mod.bias is not None:
            other[f"{name}.bias"] = None
    return other
