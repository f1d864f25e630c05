"""Training across ranks: a (data, model) mesh of processes, one per card.

Counterpart of ``fmri_tpu/parallel/mesh.py``. The JAX package places arrays
on a ``jax.sharding.Mesh`` and XLA's SPMD partitioner writes the
collectives; here each rank is a process with its own card, and the
collectives are written out, all of them in this module:

* a :class:`Mesh` holds the world size, this rank's ``(data, model)``
  coordinate (``model`` innermost, as ``make_mesh`` lays the JAX mesh out)
  and two process groups: the **data group**, the ranks with this rank's
  model index, over which gradients, BatchNorm statistics and metrics are
  summed; and the **model group**, the ranks with this rank's data index,
  which hold the same rows and split the row-parallel layers' inputs;
* data parallelism over ``data``: rank (d, m) takes rows ``[d * b / D,
  (d + 1) * b / D)`` of each global batch, every BatchNorm normalises with
  the global batch's statistics (``models/norm.py``), each rank pulls back
  its rows' part of the global loss, and the gradients are summed over the
  data group before the optimizer, so a D-way step equals the
  single-process step on the global batch;
* row-parallel tensor parallelism over ``model`` of the cognitive
  encoder's ``fc1`` (``voxel_tp``) and of the decoder's projection
  (``decoder_tp``): model rank m holds the input columns
  ``[m * n / M, (m + 1) * n / M)`` of the weight (``[out, in]``, torch's
  layout), computes the partial product of its columns, and
  :func:`reduce_from_model` sums the parts before the BatchNorm; a
  replicated input enters through :func:`scatter_to_model`, whose backward
  gathers the columns' gradients. Row and not column parallelism, as the
  JAX package chose (``decoder_param_specs``' docstring there);
* NCCL on CUDA, gloo on the CPU. Two ranks may share one card only over
  gloo (``make_mesh(..., devices=[cuda:0] * k, backend="gloo")``), asked
  for by name: NCCL refuses a duplicate card, and so does :func:`make_mesh`.

Every collective is an ``all_reduce`` (sum) or a ``broadcast``, the two that
gloo runs on CUDA tensors; a gather is an all-reduce of a zero-filled
buffer with this rank's slot written. The autograd-aware helpers are
``torch.autograd.Function`` s of their own: ``torch.distributed.nn``'s
all-reduce sums the gradient in its backward too, which multiplies a
replicated gradient by the group's size.

``Mesh.reduced_bytes`` counts the bytes this rank has all-reduced or
broadcast, for the per-step numbers of ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the weight each tensor-parallel flag shards: (group, its parameter name)
TP_LAYERS = {"voxel_tp": ("encoder", "fc1.0.weight"),
             "decoder_tp": ("decoder", "fc.0.weight")}


def _tp_module(flag: str, module: torch.nn.Module) -> bool:
    """Whether ``module`` is the kind of network ``flag`` shards (a
    CognitiveEncoder for ``voxel_tp``, a Decoder for ``decoder_tp``)."""
    from fmri_tpu_torch.models.nets import CognitiveEncoder, Decoder

    return isinstance(module, CognitiveEncoder if flag == "voxel_tp" else Decoder)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "gloo") -> None:
    """Join the process group (a no-op once joined): at ``coordinator``
    (``host:port``) as ``process_id`` of ``num_processes``; else from
    torchrun's environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); else as the one rank of a world of one on a free
    ``localhost`` port."""
    if dist.is_initialized():
        return
    if coordinator is not None:
        init, world, rank = f"tcp://{coordinator}", num_processes, process_id
    elif "WORLD_SIZE" in os.environ:
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0))
    else:
        init, world, rank = f"tcp://localhost:{free_port()}", 1, 0
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)


def check_batch(batch_size: int, data: int) -> None:
    """The JAX trainer's divisibility check (``fmri_tpu/train/trainer.py:133-139``)."""
    if batch_size % data:
        raise ValueError(
            f"batch_size={batch_size} is not divisible by the mesh data axis "
            f"({data} devices); pick a batch size that shards evenly")


class Mesh:
    """This rank's place in a (data, model) mesh of ``data * model``
    processes and its two groups (None where the axis is 1); build it with
    :func:`make_mesh`."""

    def __init__(self, data: int, model: int, rank: int, device: torch.device,
                 backend: str, data_group=None, model_group=None):
        self.data, self.model = data, model
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.world, self.rank = data * model, rank
        self.data_index, self.model_index = divmod(rank, model)
        self.device, self.backend = device, backend
        self.data_group, self.model_group = data_group, model_group
        self.reduced_bytes = 0

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    @property
    def is_writer(self) -> bool:
        """Rank 0 writes the run's files."""
        return self.rank == 0

    # ------------------------------------------------------------ collectives

    def _reduce(self, t: torch.Tensor, group, size: int) -> torch.Tensor:
        if size > 1:
            dist.all_reduce(t, group=group)
            self.reduced_bytes += t.numel() * t.element_size()
        return t

    def data_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: ``t`` summed over the data group."""
        return self._reduce(t.detach().clone(), self.data_group, self.data)

    def sum_grads(self, grads: Mapping[str, Mapping[str, torch.Tensor]]
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{group: {name: gradient}}`` summed over the data group, one flat
        buffer (one all-reduce) per group."""
        if self.data == 1:
            return {g: dict(named) for g, named in grads.items()}
        out = {}
        for g, named in grads.items():
            keys = list(named)
            flat = torch.cat([named[k].reshape(-1) for k in keys])
            self._reduce(flat, self.data_group, self.data)
            parts = flat.split([named[k].numel() for k in keys])
            out[g] = {k: p.view(named[k].shape) for k, p in zip(keys, parts)}
        return out

    def _gather(self, t: torch.Tensor, dim: int, group, size: int, index: int):
        if size == 1:
            return t
        buf = torch.zeros((size, *t.shape), dtype=t.dtype, device=t.device)
        buf[index] = t
        self._reduce(buf, group, size)
        return torch.cat(list(buf.unbind(0)), dim=dim)

    def gather_data(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The data group's ``t`` concatenated along ``dim`` in data order."""
        return self._gather(t.detach(), dim, self.data_group, self.data, self.data_index)

    def gather_model(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The model group's ``t`` concatenated along ``dim`` in model order."""
        return self._gather(t, dim, self.model_group, self.model, self.model_index)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as rank 0 holds it, in place, on every rank."""
        if self.world > 1:
            dist.broadcast(t, src=0)
            self.reduced_bytes += t.numel() * t.element_size()
        return t

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (the stop decisions: a rank that
        stops alone hangs the others at their next collective)."""
        t = torch.tensor([float(flag)], device=self.device)
        return bool(self.broadcast(t).item())

    def broadcast_int(self, value: int) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        return int(self.broadcast(t).item())

    def barrier(self) -> None:
        """Every rank waits here for every other (an all-reduce read on
        the host)."""
        if self.world > 1:
            t = torch.ones(1, device=self.device)
            dist.all_reduce(t)
            t.item()

    def close(self) -> None:
        """Leave the process group (the processes' last collective)."""
        if dist.is_initialized():
            dist.destroy_process_group()

    # ------------------------------------------------------------ layouts

    def model_slice(self, n: int) -> Tuple[int, int]:
        """This model rank's ``[lo, hi)`` of ``n`` columns."""
        if n % self.model:
            raise ValueError(f"{n} columns are not divisible by the mesh model "
                             f"axis ({self.model}): the row-parallel layers need "
                             f"an even split")
        w = n // self.model
        return self.model_index * w, (self.model_index + 1) * w

    def data_rows(self, n: int) -> Tuple[int, int]:
        """This data rank's ``[lo, hi)`` of a global batch of ``n`` rows."""
        check_batch(n, self.data)
        w = n // self.data
        return self.data_index * w, (self.data_index + 1) * w

    def rows(self, t):
        """This data rank's rows of ``t`` (None stays None)."""
        if t is None or self.data == 1:
            return t
        lo, hi = self.data_rows(t.shape[0])
        return t[lo:hi]


def _rank_device(data: int, model: int, world: int, rank: int,
                 devices: Optional[Sequence[torch.device]]) -> torch.device:
    """This rank's device once the mesh fits: ``devices[rank]``, or with
    ``devices=None`` one card per rank across hosts (the mesh against the
    world, then this host's ``LOCAL_RANK`` against its own cards)."""
    n_devices = world if devices is None else len(devices)
    if data * model > n_devices:
        raise ValueError(f"mesh {data}x{model} exceeds {n_devices} devices")
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not cover the world of {world} ranks")
    if devices is not None:
        return devices[rank]
    local, cards = int(os.environ.get("LOCAL_RANK", rank)), torch.cuda.device_count()
    if local >= cards:
        raise ValueError(f"rank {rank} runs on this host's card {local} (LOCAL_RANK) "
                         f"and the host has {cards}")
    return torch.device("cuda", local)


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence[Any]] = None,
              backend: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over the world's processes, joining the process
    group first if needed (:func:`initialize_multihost`).

    ``data=None`` takes every rank not consumed by the model axis. Rank r
    runs on ``devices[r]``, or by default on its host's
    ``cuda:<LOCAL_RANK>`` (a torchrun world may span hosts: the mesh is
    held against the world's size and the local rank against the host's
    cards); ``backend`` defaults to NCCL on CUDA and gloo on the CPU.
    Raises where the JAX function does (a world not divisible by ``model``,
    a mesh larger than the devices), where the mesh does not cover the
    world, and where NCCL would share a card."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no devices given and torch.cuda.is_available() "
                               "is False; pass devices=['cpu'] * world to run on the CPU")
    else:  # a bare "cuda" is the current card
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if torch.device(d) == torch.device("cuda") else torch.device(d)
                   for d in devices]
    kinds = {d.type for d in devices} if devices is not None else {"cuda"}
    backend = backend or ("nccl" if kinds == {"cuda"} else "gloo")
    if backend == "nccl":
        if kinds != {"cuda"}:
            raise ValueError(f"NCCL needs CUDA devices, got {sorted(kinds)}")
        if devices is not None and len(set(devices)) < len(devices):
            raise ValueError("NCCL refuses two ranks on one card; several ranks share "
                             "a card only with backend='gloo', asked for by name")
    initialize_multihost(backend=backend)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    device = _rank_device(data, model, world, rank, devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # every rank creates every group, in the same order (new_group's rule)
    data_index, model_index = divmod(rank, model)
    groups = {}
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)]) if data > 1 else None
        groups.setdefault("data", {})[m] = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)]) if model > 1 else None
        groups.setdefault("model", {})[d] = g
    mesh = Mesh(data, model, rank, device, backend, groups["data"][model_index],
                groups["model"][data_index])
    # the group forms: one all-reduce over the world
    t = torch.ones(1, device=device)
    dist.all_reduce(t)
    if int(t.item()) != world:
        raise RuntimeError(f"mesh handshake summed {t.item()} over {world} ranks")
    return mesh


# ---------------------------------------------------------------- autograd


class _ReduceFromModel(torch.autograd.Function):
    """Forward: the sum of the model group's partial products. Backward:
    the identity (the cotangent is the same on every model rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh._reduce(x.clone(), mesh.model_group, mesh.model)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToModel(torch.autograd.Function):
    """Forward: this model rank's columns of a replicated [N, n] input.
    Backward: the model group's column gradients gathered back to [N, n]."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        lo, hi = mesh.model_slice(x.shape[1])
        return x[:, lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather_model(g.contiguous(), dim=1), None


class _SyncDataSum(torch.autograd.Function):
    """A sum over the data group both ways: each rank's statistics sum to
    the global batch's, and each rank's cotangent of them reaches every
    rank's rows (the global-batch BatchNorm's statistics)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.data_sum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.data_sum(g), None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, mesh) if mesh.model > 1 else x


def scatter_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _ScatterToModel.apply(x, mesh) if mesh.model > 1 else x


def sync_data_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _SyncDataSum.apply(x, mesh) if mesh.data > 1 else x


def row_parallel_linear(x: torch.Tensor, weight: torch.Tensor, mesh: Mesh,
                        compute_dtype: Optional[str] = None) -> torch.Tensor:
    """``x @ W.T`` with ``weight`` this model rank's input columns of W:
    the partial product of its columns of x (``ops/conv.py::linear``, bf16
    operands included), summed over the model group. x is the full
    replicated input; its gradient, where asked for, is the gathered one."""
    from fmri_tpu_torch.ops.conv import linear

    part = linear(scatter_to_model(x, mesh), weight, None, compute_dtype)
    return reduce_from_model(part, mesh)


# ------------------------------------------------------------- placement


# Name parity with ``fmri_tpu.parallel``: the JAX package's placement
# specs, which no path of the port reads (each rank holds its own rows).


def batch_sharding(mesh: Mesh, ndim: int) -> tuple:
    """A batch's spec: its leading axis over ``data``."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def replicated(mesh: Mesh) -> tuple:
    """A replicated array's spec."""
    return ()


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This data rank's rows of a batch (array, tensor, or ``{'fmri',
    'image'}`` dict of them), as tensors on the mesh's device. The fMRI rows
    stay whole under ``voxel_tp``: the row-parallel ``fc1`` takes its own
    columns (:func:`scatter_to_model`)."""

    def place(x):
        t = x if torch.is_tensor(x) else torch.from_numpy(x)
        return mesh.rows(t).to(mesh.device)

    if isinstance(batch, dict):
        return {k: place(v) for k, v in batch.items()}
    return place(batch)


shard_batch_multihost = shard_batch  # each process holds its own rows already


def _layer_specs(module: torch.nn.Module, flag: str) -> Dict[str, tuple]:
    key = TP_LAYERS[flag][1]
    sharded = _tp_module(flag, module)
    return {name: ((None, MODEL_AXIS) if sharded and name == key else ())
            for name, _ in module.named_parameters()}


def cognitive_param_specs(module: torch.nn.Module) -> Dict[str, tuple]:
    """Specs of a cognitive encoder's parameters: ``fc1.0.weight`` [hidden,
    voxels] with its voxel (input) axis over ``model``, every other
    parameter replicated. ``module`` may live on the ``meta`` device, so
    the ``fullbrain`` geometry needs no memory."""
    return _layer_specs(module, "voxel_tp")


def decoder_param_specs(module: torch.nn.Module) -> Dict[str, tuple]:
    """Specs of a decoder's parameters: the projection ``fc.0.weight``
    [features, latent] with its latent (input) axis over ``model``, every
    other parameter replicated."""
    return _layer_specs(module, "decoder_tp")


def _local(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    if spec == (None, MODEL_AXIS):
        lo, hi = mesh.model_slice(t.shape[1])
        return t[:, lo:hi].clone()
    return t


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh,
                 specs: Optional[Mapping[str, tuple]] = None) -> Dict[str, torch.Tensor]:
    """Named tensors on the mesh's device: replicated by default, or this
    rank's shard of each per ``specs``."""
    specs = specs or {}
    return {k: _local(v, specs.get(k, ()), mesh).to(mesh.device) for k, v in params.items()}


def shard_state(state, mesh: Mesh, voxel_tp: bool = False, decoder_tp: bool = False):
    """Place a full ``TrainState`` on this rank, in place: modules and
    moments on the mesh's device, every BatchNorm over the data group, and

    * with ``voxel_tp`` the cognitive encoder's ``fc1`` weight (and its
      optimizer moments) as this model rank's voxel columns;
    * with ``decoder_tp`` the decoder's projection weight (and moments) as
      its latent columns.

    Both compose with data parallelism and with each other. A state placed
    on ``mesh`` already comes back as it is; on another mesh, it raises."""
    from fmri_tpu_torch.models.norm import attach_mesh
    from fmri_tpu_torch.train.optim import AdamState

    if state.mesh is not None:
        if state.mesh is not mesh:
            raise ValueError("the state is placed on another mesh")
        return state
    nets = state.nets.to(mesh.device)
    attach_mesh(nets, mesh)
    shards = {}
    for flag, on in (("voxel_tp", voxel_tp), ("decoder_tp", decoder_tp)):
        group, key = TP_LAYERS[flag]
        if not on or group not in nets.PREFIXES or not _tp_module(flag, nets.module(group)):
            continue
        module = nets.module(group)
        layer = module.get_submodule(key.rsplit(".", 1)[0])
        layer.weight = torch.nn.Parameter(_local(layer.weight.data, (None, MODEL_AXIS), mesh))
        module.tp = mesh
        shards[(group, key)] = (None, MODEL_AXIS)

    def place(moments, group):
        out = {}
        for k, v in moments.items():
            v = v.to(mesh.device)
            out[k] = _local(v, shards.get((group, k), ()), mesh).contiguous()
        return out

    for g, m in list(state.opt_state.items()):
        if isinstance(m, AdamState):
            state.opt_state[g] = AdamState(place(m.mu, g), place(m.nu, g),
                                           m.count.to(mesh.device))
        else:
            state.opt_state[g] = place(m, g)
    state.nets = nets
    state.step = state.step.to(mesh.device)
    state.mesh, state.shards = mesh, shards
    return state
