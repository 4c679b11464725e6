"""Device mesh and the data-parallel layer over `torch.distributed`.

Port of `parrot_tts_tpu/core/mesh.py`. The reference's only distribution
strategy is NCCL data-parallel DDP (`utils/vocoder/train.py:34-40`,
Lightning `strategy="auto"`, `train.py:158-161`). The JAX package lays a
(data, model) `jax.sharding.Mesh` over the devices and lets XLA derive the
collectives; here they are explicit:

- a `Mesh` is a (data, model) grid. Without a process group it holds this
  process's devices (`create_mesh()`: every visible CUDA device; a caller
  may pass any list, repeats included, such as ["cpu"] * 4). Under a
  process group (`initialize_distributed`, one process per device, as
  torchrun starts them) each rank holds its own device and the axes span
  the ranks, rank-major: rank r is (r // model size, r % model size);
- a batch is split into contiguous row blocks, process-major, then over
  this process's devices (`local_rows`, `shard_batch`), and the outputs are
  read back in the same order (`fetch`), so every rank sees the global
  result;
- gradients and loss denominators are summed with `all_reduce_sum`, one
  flat bucket per call (`train/tte.py`, `train/vocoder.py`);
- under tensor parallelism (a model axis over the ranks) the TTE forward
  sums the partial products of its row-parallel weights (`model_sum`,
  with each bias added `once`) and gathers its column-parallel outputs
  (`gather_last`), `parallel/tensor.py`.

With one process no collective runs.
"""

from __future__ import annotations

import copy
import datetime
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from parrot_tts_tpu_torch.core.config import MeshConfig
from parrot_tts_tpu_torch.core.device import batch_to_device, resolve_device

DATA_AXIS = MeshConfig.data_axis
MODEL_AXIS = MeshConfig.model_axis


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Rank 0, the process that writes logs and checkpoints."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if process_count() > 1:
        dist.barrier()


@dataclass
class Mesh:
    """A (data, model) grid. `devices` are this process's devices, in
    mesh order; `shape` counts the whole grid, across processes.
    `model_group` is this rank's model-axis process group (tensor
    parallelism across ranks), `model_rank` its place on that axis."""

    devices: list[torch.device]
    shape: dict[str, int]
    axis_names: tuple[str, str] = (DATA_AXIS, MODEL_AXIS)
    process_index: int = 0
    process_count: int = 1
    model_group: object = None
    model_rank: int = 0

    @property
    def n_data(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def n_model(self) -> int:
        return self.shape[self.axis_names[1]]

    @property
    def local_data(self) -> list[torch.device]:
        """This process's devices on the data axis: the shards it runs.
        The data-parallel paths (serving, training; their collectives run
        over the default group) take a mesh whose model axis is 1."""
        if self.n_model != 1:
            raise ValueError(f"a data-parallel path wants model axis 1, "
                             f"this mesh has {self.n_model}")
        return self.devices


def _local_device() -> torch.device:
    """This rank's card (LOCAL_RANK). Raises without CUDA, as
    `resolve_device(None)` does: a rank runs on the host only when its
    caller asks for the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank; pass device='cpu' "
                           "(a gloo group) to run on the host")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def create_mesh(devices: list | None = None, model_parallel_size: int = 1,
                data_axis: str = DATA_AXIS,
                model_axis: str = MODEL_AXIS) -> Mesh:
    """A (data, model) mesh. devices=None: every visible CUDA device, or,
    under a process group, this rank's card (LOCAL_RANK; raises without
    CUDA), the axes spanning the ranks. A given list is taken as it is,
    repeats included; one naming more CUDA devices than exist raises.
    Under a process group the model axis groups consecutive ranks (one
    device each) and every rank must call this, since it makes the groups
    collectively."""
    pi, pc = process_index(), process_count()
    if devices is None:
        if pc > 1:
            devices = [_local_device()]
        else:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("create_mesh: no CUDA device; pass "
                                   "devices=['cpu'] to build a host mesh")
            devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"create_mesh: {d} does not exist "
                               f"({torch.cuda.device_count()} CUDA devices)")
    n = len(devices) * pc
    if n % model_parallel_size:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel_size={model_parallel_size}")
    mesh = Mesh(devices, {data_axis: n // model_parallel_size,
                          model_axis: model_parallel_size},
                (data_axis, model_axis), pi, pc)
    if pc > 1 and model_parallel_size > 1:
        if len(devices) != 1:
            raise ValueError("a model axis across ranks takes one device "
                             "per rank")
        mp = model_parallel_size
        for row in range(pc // mp):          # collective: every rank makes
            ranks = list(range(row * mp, (row + 1) * mp))    # every group
            group = dist.new_group(ranks)
            if pi in ranks:
                mesh.model_group, mesh.model_rank = group, pi - row * mp
    return mesh


def training_mesh(device=None, mesh_cfg: MeshConfig | None = None) -> Mesh:
    """The mesh of a training run. Under torchrun (WORLD_SIZE > 1) it
    joins the process group (`initialize_distributed`) on this rank's
    device: its card (LOCAL_RANK; raises without CUDA), or `device` when
    given (a gloo group for "cpu"), the data axis spanning the ranks;
    otherwise `device` alone (None: the card). mesh_cfg
    (`PipelineConfig.mesh`) names the axes; training is data-parallel
    only, so its model_parallel_size must be 1."""
    mc = mesh_cfg or MeshConfig()
    if mc.model_parallel_size != 1:
        raise ValueError(f"model_parallel_size={mc.model_parallel_size}: "
                         "training is data-parallel only (tensor "
                         "parallelism serves the TTE forward, "
                         "parallel/tensor.py)")
    axes = {"data_axis": mc.data_axis, "model_axis": mc.model_axis}
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dev = _local_device() if device is None else resolve_device(device)
        initialize_distributed("gloo" if dev.type == "cpu" else None)
        return create_mesh([dev], **axes)
    return create_mesh([resolve_device(device)], **axes)


def data_parallel(mesh: Mesh | None) -> bool:
    """Whether a training step runs over a process group: a mesh of one
    device per process (model axis 1) across more than one process. A
    mesh of several devices in one process cannot train."""
    if mesh is None:
        return False
    if len(mesh.local_data) != 1:
        raise ValueError("data-parallel training takes one device per "
                         f"process, this mesh has {len(mesh.devices)} here")
    return mesh.process_count > 1


def pad_rows_to_multiple(n: int, multiple: int) -> int:
    """Rows a batch must grow to so the leading dim shards evenly."""
    return -(-n // multiple) * multiple


def local_rows(global_rows: int) -> slice:
    """This process's contiguous block of a global batch's rows (the
    convention of `shard_batch`, `fetch` and the loaders: process-major
    blocks). global_rows must divide evenly by the process count."""
    pc = process_count()
    if global_rows % pc:
        raise ValueError(f"{global_rows} rows do not divide over {pc} "
                         "processes")
    loc = global_rows // pc
    return slice(process_index() * loc, (process_index() + 1) * loc)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    """Rows per data-axis shard of a global batch; raises unless even."""
    if global_batch % mesh.n_data != 0:
        raise ValueError(f"global batch {global_batch} % data axis "
                         f"{mesh.n_data} != 0")
    return global_batch // mesh.n_data


def shard_batch(mesh: Mesh, batch: dict, dtypes: dict,
                batch_axis: int = 0) -> list[dict]:
    """This process's rows of a numpy batch (the keys of `dtypes`) split
    evenly over its data-axis devices: one dict of tensors per device,
    copied from pinned memory without blocking the host
    (`core/device.py::batch_to_device`). batch_axis=1 splits stacked
    (K, B, ...) micro-batches on B."""
    devs = mesh.local_data
    out = []
    for i, dev in enumerate(devs):
        part = {}
        for k in dtypes:
            if k not in batch:
                continue
            x = np.asarray(batch[k])
            n = x.shape[batch_axis]
            if n % len(devs):
                raise ValueError(f"shard_batch: {k} has {n} rows, not a "
                                 f"multiple of {len(devs)} devices")
            loc = n // len(devs)
            part[k] = np.take(x, np.arange(i * loc, (i + 1) * loc),
                              axis=batch_axis)
        out.append(batch_to_device(part, dtypes, dev))
    return out


def broadcast(tensors) -> None:
    """Rank 0's values of the tensors into every rank's, in place
    (nothing without a process group)."""
    if process_count() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)


def broadcast_state(module: torch.nn.Module) -> None:
    """Rank 0's parameters and persistent buffers into every rank's
    module, in place (nothing without a process group)."""
    broadcast(module.state_dict().values())


def replicated(mesh: Mesh, module: torch.nn.Module) -> list[torch.nn.Module]:
    """One copy of `module` per data-axis device of this process (the JAX
    package's `replicated` / `shard_params`), rank 0's state under a process
    group. Devices that repeat share one copy; the module itself serves its
    own device."""
    broadcast_state(module)
    own = next(module.parameters()).device
    copies: dict[torch.device, torch.nn.Module] = {own: module}
    out = []
    for dev in mesh.local_data:
        if dev not in copies:
            copies[dev] = copy.deepcopy(module).to(dev)
        out.append(copies[dev])
    return out


def fetch(shards) -> np.ndarray:
    """The global numpy value of per-device shards (a tensor, or a list in
    `shard_batch` order): this process's shards joined on the host, then,
    across processes, gathered rank-major (`all_gather_rows`); one process
    runs no collective."""
    if isinstance(shards, torch.Tensor):
        shards = [shards]
    local = torch.cat([s.detach().cpu() for s in shards])
    if process_count() == 1:
        return local.numpy()
    return all_gather_rows(local).numpy()


def all_gather_rows(local: torch.Tensor) -> torch.Tensor:
    """Every rank's `local` (a host tensor, the same shape on each),
    concatenated rank-major. A collective even in a group of one. It runs
    on the group's CPU backend: gloo, which gathers no CUDA tensor, and
    which `initialize_distributed` puts beside NCCL for this."""
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts)


def all_reduce_sum(tensors: list[torch.Tensor],
                   scale: float | None = None) -> None:
    """Sum each tensor over the ranks in place, as one flat bucket (one
    collective), then multiply by `scale` when given (1 / world for a
    mean). Nothing runs without a process group of more than one rank."""
    if process_count() == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    if scale is not None:
        flat.mul_(scale)
    off = 0
    for t in tensors:
        t.copy_(flat[off: off + t.numel()].view_as(t))
        off += t.numel()


def _tp(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.n_model > 1


def model_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """x summed over the mesh's model axis, in place: the partial sums of
    a row-parallel product (`parallel/tensor.py`). Nothing without a
    model axis."""
    if _tp(mesh):
        dist.all_reduce(x, group=mesh.model_group)
    return x


def model_part(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This model rank's block of x's last dim: the input features of a
    row-parallel product (all of x without a model axis)."""
    if not _tp(mesh):
        return x
    w = x.shape[-1] // mesh.n_model
    return x[..., mesh.model_rank * w: (mesh.model_rank + 1) * w]


def once(bias: torch.Tensor | None, mesh: Mesh | None):
    """A bias to add before `model_sum`: on model rank 0 alone, so the
    sum holds it once."""
    return bias if mesh is None or mesh.model_rank == 0 else None


def gather_last(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Concatenate the model axis's shards of x along its last dim, on
    x's device: each rank's shard in its slot of a zero tensor, summed
    over the model group (x + 0 is x, so the result is exact; gloo has no
    all_gather of CUDA tensors). x itself without a model axis."""
    if not _tp(mesh):
        return x
    n = mesh.n_model
    w = x.shape[-1]
    full = x.new_zeros(*x.shape[:-1], w * n)
    full[..., mesh.model_rank * w: (mesh.model_rank + 1) * w] = x
    dist.all_reduce(full, group=mesh.model_group)
    return full


def initialize_distributed(backend: str | None = None,
                           init_method: str = "env://",
                           world_size: int | None = None,
                           rank: int | None = None,
                           timeout_s: float = 600.0) -> None:
    """Join the process group (the reference's `init_process_group(nccl,
    env://)`; torchrun sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT). backend=None: NCCL, which needs CUDA (raises without
    it; a group on the host asks for "gloo"). An NCCL group carries gloo
    beside it for host tensors ("cuda:nccl,cpu:gloo"): NCCL runs no
    collective on them, and `fetch` gathers host copies. With CUDA the
    rank's card (LOCAL_RANK) becomes the current device first. A failed
    init raises; nothing falls back to another backend or to the CPU.
    Already initialised: nothing."""
    if dist.is_initialized():
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device for "
                               "NCCL; pass backend='gloo' for a group on "
                               "the host")
        backend = "nccl"
    if backend == "nccl":
        backend = "cuda:nccl,cpu:gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(_local_device())
    kw = {} if world_size is None else {"world_size": world_size}
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
