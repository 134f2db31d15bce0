"""Process group, device mesh and per-rank batch rows on
``torch.distributed`` (counterpart of sasvqa_tpu/parallel/mesh.py).

One process owns one device.  The mesh names the JAX package's axes:
``data`` (replicated parameters, gradients all-reduced), ``fsdp``
(ZeRO-3 parameter sharding, FSDP2's ``fully_shard``) and ``model``
(Megatron tensor parallelism, :mod:`sasvqa_torch.parallel.tp`).  Unlike
JAX, ranks on ``fsdp`` are data-parallel too: a rank's rows of the global
batch are one contiguous block per (data, fsdp) coordinate, and ranks that
differ only in their ``model`` coordinate are replicas that read the same
rows.  :func:`param_sharding_for_mesh` picks the route from the axis
names and returns the :class:`ParallelPlan` the train step reduces with.

A run is launched as ``torchrun --nproc_per_node N -m
sasvqa_torch.tasks.run_video_qa ...``; :func:`init_distributed` reads the
environment torchrun sets.  The group's backend is NCCL on the GPU and
gloo only when the CPU is asked for; nothing falls back from one to the
other.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from sasvqa_torch.core.logging import LOGGER
from sasvqa_torch.core.pixels import host_tensor

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "model"
AXES = (DATA_AXIS, FSDP_AXIS, TP_AXIS)


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def init_distributed(platform: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout_s: float = 1800.0) -> bool:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``; ``init_method``, e.g. ``file://...``, replaces the
    last two).  NCCL with ``torch.cuda.set_device(LOCAL_RANK)`` unless
    ``platform`` is "cpu" (then gloo); a rank whose ``LOCAL_RANK`` has no
    GPU raises.  Returns False, and does nothing, without ``WORLD_SIZE``;
    True once the group is up (also when it already was)."""
    if is_distributed():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    kwargs: Dict[str, Any] = {}
    if platform == "cpu":
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass platform 'cpu' "
                               "to run the process group on the CPU (gloo)")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} has no GPU: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank_, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    LOGGER.info(f"process group: rank {rank_} of {world} ({backend})")
    return True


def _check_axes(shape: Sequence[int], axes: Sequence[str]) -> None:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} has {len(shape)} dims "
                         f"but axes {tuple(axes)} name {len(axes)}: pass "
                         f"matching --mesh_shape/--mesh_axes")
    bad = [a for a in axes if a not in AXES]
    if bad or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {tuple(axes)}: each of {AXES} at most "
                         f"once")


def mesh_spec(shape: Optional[Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None, world: int = 1
              ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axes) of a mesh over ``world`` processes: all of them on
    ``data`` by default.  Raises ValueError when the axes do not match the
    shape, or the shape's size is not the number of processes (one
    process owns one device)."""
    axes = tuple(axes) if axes else (DATA_AXIS,)
    shape = (tuple(int(s) for s in shape) if shape
             else (world,) + (1,) * (len(axes) - 1))
    _check_axes(shape, axes)
    n = int(np.prod(shape))
    if n != world:
        raise ValueError(
            f"mesh shape {shape} needs {n} processes, one a device, but "
            f"{world} run: launch with `torchrun --nproc_per_node {n} -m "
            f"sasvqa_torch.tasks.run_video_qa ...`")
    return shape, axes


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None,
              platform: Optional[str] = None):
    """The ``DeviceMesh`` of ``shape`` over ``axes`` (default: every rank
    on ``data``), or None in a process without a process group (whose
    mesh may only have size 1).  ``prod(shape)`` must equal the world
    size (:func:`mesh_spec`)."""
    shape, axes = mesh_spec(shape, axes, world_size())
    if not is_distributed():
        return None
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu" if platform == "cpu" else "cuda", shape,
                            mesh_dim_names=axes)


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's shape and axis names with no process group behind it: the
    attributes of a ``DeviceMesh`` that :func:`host_batch_positions` and
    :func:`dp_coordinate` read."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def mesh(self) -> torch.Tensor:
        return torch.arange(int(np.prod(self.shape))).reshape(self.shape)


def _coords(mesh, rank_: int) -> Dict[str, int]:
    ranks = mesh.mesh
    where = (ranks == rank_).nonzero()
    if where.shape[0] != 1:
        raise ValueError(f"rank {rank_} is not in the mesh {ranks.tolist()}")
    return dict(zip(mesh.mesh_dim_names, where[0].tolist()))


def dp_coordinate(mesh, rank_: Optional[int] = None) -> Tuple[int, int]:
    """(index, size) of the rank's data-parallel coordinate: its place on
    the (data, fsdp) axes, row-major.  Ranks that differ only on
    ``model`` share it."""
    rank_ = rank() if rank_ is None else rank_
    coords = _coords(mesh, rank_)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    index, size = 0, 1
    for axis in (DATA_AXIS, FSDP_AXIS):
        if axis in sizes:
            index = index * int(sizes[axis]) + coords[axis]
            size *= int(sizes[axis])
    return index, size


def host_batch_positions(mesh, global_rows: int,
                         rank_: Optional[int] = None) -> np.ndarray:
    """Sorted positions of the rows of a global batch that ``rank_`` (by
    default this process) supplies: one contiguous block a data-parallel
    coordinate (:func:`dp_coordinate`), so that ranks on (data, fsdp) hold
    disjoint blocks and ranks that differ only on ``model`` are replicas
    with the same rows.  ``mesh`` None (one process): every row.  Raises
    ValueError when the blocks cannot be equal (rows not a multiple of
    the data-parallel size): two ranks' rows would partially overlap."""
    if mesh is None:
        return np.arange(global_rows)
    index, size = dp_coordinate(mesh, rank_)
    if global_rows % size:
        raise ValueError(
            f"{global_rows} batch rows do not split into {size} equal "
            f"blocks: ranks would address partially overlapping rows; make "
            f"the batch a multiple of the (data, fsdp) size")
    per = global_rows // size
    return np.arange(index * per, (index + 1) * per)


def shard_batch(batch: Mapping[str, Any], device: torch.device
                ) -> Dict[str, Any]:
    """The rank's rows (a collated host batch) as tensors on its device;
    None and non-array leaves pass through."""
    return {k: (host_tensor(v).to(device) if hasattr(v, "shape") else v)
            for k, v in batch.items()}


def pad_batch_to_multiple(batch: Mapping[str, Any], multiple: int
                          ) -> Dict[str, Any]:
    """Pad the leading axis of every array leaf to a multiple of
    ``multiple`` (zeros; ``labels`` with -100, so that padded rows drop
    out of the loss and the metrics)."""
    def pad(x, value=0):
        if not hasattr(x, "shape") or x.ndim == 0:
            return x
        rem = (-x.shape[0]) % multiple
        if rem == 0:
            return x
        widths = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths, constant_values=value)

    out = {}
    for k, v in batch.items():
        if k == "labels" and v is not None:
            out[k] = pad(v, -100)
        elif hasattr(v, "shape"):
            out[k] = pad(v)
        else:
            out[k] = v
    return out


# -- DTensor leaves -------------------------------------------------------

def is_dtensor(x: Any) -> bool:
    return isinstance(x, DTensor)


def local(x: torch.Tensor) -> torch.Tensor:
    """The rank's shard of a DTensor (sharing its storage under no_grad);
    a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def full(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank calls it);
    a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def fetch_params_for_save(state: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A state dict as whole, unsharded CPU copies (every rank calls it:
    sharded leaves are gathered)."""
    return {k: full(v).detach().to("cpu", copy=True)
            for k, v in state.items()}


@torch.no_grad()
def load_full_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the whole tensor ``src`` into ``dst``: a DTensor takes its own
    shard of it (sliced locally, no communication)."""
    if is_dtensor(dst):
        from torch.distributed.tensor import distribute_tensor
        shard = distribute_tensor(src.to(dst.device, dst.dtype),
                                  dst.device_mesh, dst.placements,
                                  src_data_rank=None).to_local()
        dst.to_local().copy_(shard)
    else:
        dst.copy_(src)


def load_full_state_dict(model: nn.Module,
                         state: Mapping[str, torch.Tensor]) -> None:
    """``model.load_state_dict(state, strict=True)`` for a model whose
    parameters may be sharded: each rank keeps its shard of every whole
    tensor of ``state``."""
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise RuntimeError(f"state dict keys differ: missing {missing}, "
                           f"unexpected {unexpected}")
    for k, dst in own.items():
        if tuple(dst.shape) != tuple(state[k].shape):
            raise RuntimeError(f"{k}: shape {tuple(state[k].shape)} in the "
                               f"checkpoint, {tuple(dst.shape)} in the model")
        load_full_into(dst, state[k])


# -- the parallel routes ---------------------------------------------------

def fsdp_leaf_sharding(shape: Sequence[int], n_shard: int,
                       min_size: int = 2 ** 16) -> Optional[int]:
    """The one ZeRO per-leaf rule: the axis a leaf shards on (its largest,
    when it has 2 or more dims, at least ``min_size`` elements and a
    largest axis ``n_shard`` divides), else None (replicated)."""
    if len(shape) >= 2 and int(np.prod(shape)) >= min_size:
        axis = int(np.argmax(shape))
        if shape[axis] % n_shard == 0:
            return axis
    return None


@dataclasses.dataclass
class ParallelPlan:
    """How one rank of a mesh trains: ``route`` "data" (every gradient
    all-reduced), "fsdp" (FSDP2 reduce-scatters the gradients of the
    leaves it shards) or "tp" (tensor parallelism, with FSDP2 when the
    mesh has ``fsdp``); the rank's data-parallel coordinate; ``dp_group``
    the ranks that share its ``model`` coordinate (None: every rank);
    ``fsdp_params`` the parameters whose gradients FSDP2 reduces;
    ``collective_forward``: the forward itself communicates, so that every
    rank of the group must run each forward (eval loops stay in step)."""
    mesh: Any
    route: str
    dp_index: int
    dp_size: int
    dp_group: Any = None
    fsdp_params: frozenset = frozenset()
    collective_forward: bool = False

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data-parallel group, in place."""
        dist.all_reduce(t, group=self.dp_group)
        return t

    def reduce_grads(self, params: Sequence[nn.Parameter]) -> None:
        """One coalesced all-reduce (sum over the data-parallel group) of
        the gradients FSDP2 does not reduce."""
        grads = [local(p.grad) for p in params
                 if p.grad is not None and id(p) not in self.fsdp_params]
        if not grads:
            return
        from torch._utils import (_flatten_dense_tensors,
                                  _unflatten_dense_tensors)
        flat = _flatten_dense_tensors(grads)
        self.all_reduce(flat)
        for g, r in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(r)

    def all_done(self, done: torch.Tensor) -> bool:
        """True when every rank's rows are done (a generation loop's early
        exit), agreed over all ranks when the forward communicates."""
        flag = done.all().to(torch.int32)
        if self.collective_forward:
            dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag)


def _dp_group(mesh):
    """The process group of this rank's data-parallel replicas' peers:
    the ranks that share its ``model`` coordinate (None: every rank)."""
    names = mesh.mesh_dim_names
    if TP_AXIS not in names:
        return None
    ranks = mesh.mesh.movedim(names.index(TP_AXIS), -1)
    ranks = ranks.reshape(-1, ranks.shape[-1])
    mine = None
    for j in range(ranks.shape[1]):      # every rank creates every group
        group = dist.new_group(ranks[:, j].tolist())
        if rank() in ranks[:, j].tolist():
            mine = group
    return mine


def _fsdp_mesh(mesh):
    dims = tuple(a for a in (DATA_AXIS, FSDP_AXIS)
                 if a in mesh.mesh_dim_names)
    return mesh[dims] if len(dims) > 1 else mesh[dims[0]]


def _fully_shard(model: nn.Module, mesh, placements: Dict[str, int]
                 ) -> frozenset:
    """FSDP2 over the (data, fsdp) axes (HSDP when both are there):
    parameter ``name`` shards on axis ``placements[name]``; every other
    one stays as it is.  Gradients are summed, not averaged (the train
    step normalises the loss by the global count).  Returns the ids of
    the sharded parameters."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)
    from torch.distributed.tensor import Shard
    named = dict(model.named_parameters())
    by_param = {id(named[n]): axis for n, axis in placements.items()}
    ignored = {p for n, p in named.items() if n not in placements}
    fully_shard(model, mesh=_fsdp_mesh(mesh), ignored_params=ignored,
                shard_placement_fn=lambda p: Shard(by_param[id(p)]))
    model.set_gradient_divide_factor(1.0)
    model.set_force_sum_reduction_for_comms(True)   # gloo has no PREMUL_SUM
    # the generation and multiple-choice entry points unshard like forward
    for method in ("prompt_fill", "decode_step", "multiple_choice"):
        if hasattr(model, method):
            register_fsdp_forward_method(model, method)
    return frozenset(id(p) for n, p in model.named_parameters()
                     if n in placements)


def param_sharding_for_mesh(model: nn.Module, mesh
                            ) -> Optional[ParallelPlan]:
    """Shard ``model`` in place as the mesh's axis names say and return
    its :class:`ParallelPlan` (None without a mesh):

    - ``model`` on the mesh: tensor parallelism (:func:`tp.apply_tp`),
      and with ``fsdp`` also FSDP2 on the leaves' other dimension;
    - ``fsdp``: FSDP2 on each leaf :func:`fsdp_leaf_sharding` shards;
    - ``data`` only: replicated parameters, gradients all-reduced.

    An axis selects its route by name, at any size (a size-1 axis runs the
    route's collectives on one rank)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.mesh.shape))
    index, size = dp_coordinate(mesh)
    plan = ParallelPlan(mesh, "data", index, size)
    n_fsdp = int(sizes.get(FSDP_AXIS, 1))
    if TP_AXIS in names:
        from sasvqa_torch.parallel.tp import apply_tp
        plan.route = "tp"
        plan.collective_forward = True
        plan.dp_group = _dp_group(mesh)
        other = apply_tp(model, mesh[TP_AXIS])
        if FSDP_AXIS in names:
            placements = {}
            for n, p in model.named_parameters():
                if n in other:
                    axis = other[n]
                    if axis is not None and p.shape[axis] % n_fsdp == 0:
                        placements[n] = axis
                else:
                    axis = fsdp_leaf_sharding(tuple(p.shape), n_fsdp)
                    if axis is not None:
                        placements[n] = axis
            plan.fsdp_params = _fully_shard(model, mesh, placements)
    elif FSDP_AXIS in names:
        plan.route = "fsdp"
        plan.collective_forward = True
        placements = {}
        for n, p in model.named_parameters():
            axis = fsdp_leaf_sharding(tuple(p.shape), n_fsdp)
            if axis is not None:
                placements[n] = axis
        plan.fsdp_params = _fully_shard(model, mesh, placements)
    LOGGER.info(f"mesh {dict(sizes)}: route {plan.route}, data-parallel "
                f"{plan.dp_index}/{plan.dp_size}, "
                f"{len(plan.fsdp_params)} FSDP-sharded leaves")
    return plan


def fetch_replicated(x: torch.Tensor, plan: Optional[ParallelPlan]
                     ) -> torch.Tensor:
    """The rows of every data-parallel coordinate, in order, from each
    rank's ``x`` (an all-gather of the tiny eval outputs; one replica of
    each coordinate is kept).  Without a plan, ``x``."""
    if plan is None:
        return x
    mesh = plan.mesh
    gathered = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(gathered, x.contiguous())
    first: Dict[int, int] = {}
    for r in mesh.mesh.flatten().tolist():
        first.setdefault(dp_coordinate(mesh, r)[0], r)
    return torch.cat([gathered[first[i]] for i in sorted(first)])

