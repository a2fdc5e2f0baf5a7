"""Process groups of the multi-device runner (port of
``gennbv_tpu/parallel/mesh.py``).

The JAX package shards the env axis over a device mesh and runs the whole
training iteration under one jit, so GSPMD computes what one device would.
Here each rank is a process of a ``torch.distributed`` group, and the
runner says where data crosses ranks:

- ``make_mesh``: a 1-D ``'env'`` mesh.  The env axis is the data-parallel
  axis: a rank holds a contiguous slice of the envs (``env_rows``) and a
  replica of the policy; gradients, BatchNorm sums and metrics are summed
  over the env axis (``Mesh.all_reduce_``).
- ``make_multislice_mesh``: ``('slice', 'env')``, both axes sharding the
  envs jointly, as ``P(('slice', 'env'))`` does.  The sum runs in two
  stages, within a slice and then across slices, the route GSPMD takes
  over ICI and DCN.
- ``make_mesh_tp``: ``('env', 'model')`` with the model axis minor.  The
  ranks of one model group hold the same envs; the Linears that
  ``param_spec``'s rule shards become ``ColwiseParallel`` over the model
  axis (DTensor), which all-gathers each output where GSPMD would.

Backends: NCCL where each rank has its own card, gloo on the CPU.  NCCL
refuses two ranks on one card, so ranks sharing a card run over gloo,
which carries CUDA tensors for all_reduce, all_gather and broadcast (and
their autograd forms).  DTensor's tensor parallelism runs on the
functional collectives, whose all_gather_tensor over gloo on CUDA tensors
crashed a rank (SIGSEGV) on an H100 with torch 2.11, so ``make_mesh_tp``
refuses that pairing.

The renderer: on more than one device the JAX runner moves the renderer's
"auto" implementations off Pallas, because a ``pallas_call`` has no GSPMD
rule.  Here each rank holds its envs on its own device and its three CUDA
kernels serve its own rows; the kernels are exact against the MXU forms,
so the numbers are the same and nothing is switched.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
from torch import nn
from torch.distributed.tensor import DTensor

ENV_AXIS = "env"
DCN_AXIS = "slice"
MODEL_AXIS = "model"

# how long a rank waits on a collective or the store before it fails
TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the mesh.  `shape` maps each axis to its size in
    the JAX mesh's order; the envs are split into `env_width` slices, of
    which this rank holds number `env_index`."""
    shape: dict
    rank: int
    env_index: int
    env_width: int
    # the env-axis sum: one group, or (this slice, this env across slices)
    reduce_groups: tuple
    # the ranks of this rank's model index, in env order
    env_group: Any
    device_mesh: Any = None      # the ('env', 'model') DeviceMesh (TP only)

    @property
    def model_axis(self) -> int:
        return self.shape.get(MODEL_AXIS, 1)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sums `t` over the env axis, in place."""
        for g in self.reduce_groups:
            dist.all_reduce(t, group=g)
        return t

    def all_reduce_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the env axis, differentiable: its backward
        sums the gradients over the env axis."""
        with warnings.catch_warnings():
            # deprecated for the functional collectives, which have no
            # backward; this one's backward is the sum the loss needs
            warnings.simplefilter("ignore", FutureWarning)
            for g in self.reduce_groups:
                t = dist_nn.all_reduce(t, group=g)
        return t

    def model_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sums `t` over the model axis, in place."""
        dist.all_reduce(t, group=self.device_mesh[MODEL_AXIS].get_group())
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every env slice's `t`, concatenated along `dim` in env order."""
        parts = [torch.empty_like(t) for _ in range(self.env_width)]
        dist.all_gather(parts, t.contiguous(), group=self.env_group)
        return torch.cat(parts, dim)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's `t` on every rank, in place."""
        dist.broadcast(t, 0)
        return t


def _world(num_devices: int) -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised torch.distributed "
                           "process group (launch the ranks with torchrun or "
                           "parallel.mesh.launch)")
    world = dist.get_world_size()
    if num_devices not in (0, world):
        raise ValueError(f"runner.num_devices={num_devices}, but the process "
                         f"group has {world} ranks (0 means all of them)")
    return world


def make_mesh(num_devices: int = 0) -> Mesh:
    world = _world(num_devices)
    rank = dist.get_rank()
    return Mesh({ENV_AXIS: world}, rank, rank, world, (dist.group.WORLD,),
                dist.group.WORLD)


def make_multislice_mesh(num_slices: int, num_devices: int = 0) -> Mesh:
    world = _world(num_devices)
    if world % num_slices:
        raise ValueError(f"num_devices ({world}) must be divisible by "
                         f"num_slices ({num_slices})")
    per = world // num_slices
    # every rank creates every group, in the same order
    slices = [dist.new_group(list(range(s * per, (s + 1) * per)))
              for s in range(num_slices)]
    across = [dist.new_group(list(range(e, world, per))) for e in range(per)]
    rank = dist.get_rank()
    return Mesh({DCN_AXIS: num_slices, ENV_AXIS: per}, rank, rank, world,
                (slices[rank // per], across[rank % per]), dist.group.WORLD)


def make_mesh_tp(model_axis: int, num_devices: int = 0,
                 device_type: str = "cpu") -> Mesh:
    world = _world(num_devices)
    if world % model_axis:
        raise ValueError(f"num_devices ({world}) must be divisible by "
                         f"model_axis ({model_axis})")
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(
            "tensor parallelism on CUDA tensors needs the nccl backend: "
            "DTensor's functional all_gather_tensor over gloo on CUDA "
            "tensors crashed a rank; run "
            f"model_axis={model_axis} with a card a rank, or on the CPU")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device_type, (world // model_axis, model_axis),
                          mesh_dim_names=(ENV_AXIS, MODEL_AXIS))
    env_group = dm[ENV_AXIS].get_group()
    rank = dist.get_rank()
    return Mesh({ENV_AXIS: world // model_axis, MODEL_AXIS: model_axis}, rank,
                rank // model_axis, world // model_axis, (env_group,),
                env_group, dm)


def mesh_for(runner_cfg, device: torch.device) -> Optional[Mesh]:
    """The mesh `runner_cfg` asks for (``num_devices``, ``num_slices``,
    ``model_axis``, as the JAX runner builds it), or None for one process
    outside any process group."""
    if not dist.is_initialized():
        n = max(runner_cfg.num_devices, runner_cfg.num_slices,
                runner_cfg.model_axis)
        if n > 1:
            raise RuntimeError(
                f"runner.num_devices={runner_cfg.num_devices}, num_slices="
                f"{runner_cfg.num_slices}, model_axis={runner_cfg.model_axis} "
                "need one process per rank: launch with `python -m "
                f"torch.distributed.run --standalone --nproc_per_node {n} -m "
                "gennbv_tpu_torch.train.train_gennbv ... --set "
                f"runner.num_devices={n}`")
        return None
    if runner_cfg.model_axis > 1:
        return make_mesh_tp(runner_cfg.model_axis, runner_cfg.num_devices,
                            device.type)
    if runner_cfg.num_slices > 1:
        return make_multislice_mesh(runner_cfg.num_slices,
                                    runner_cfg.num_devices)
    return make_mesh(runner_cfg.num_devices)


def env_rows(num_envs: int, mesh: Optional[Mesh]) -> slice:
    """The envs this rank holds: ``[i * N / W, (i + 1) * N / W)`` for env
    index i of W, in the order of ``P(('slice', 'env'))``."""
    if mesh is None:
        return slice(0, num_envs)
    if num_envs % mesh.env_width:
        raise ValueError(f"num_envs ({num_envs}) must be divisible by the env "
                         f"axis ({mesh.env_width} ranks)")
    n = num_envs // mesh.env_width
    return slice(mesh.env_index * n, (mesh.env_index + 1) * n)


def shards_features(features: int, model_axis: int) -> bool:
    """``param_spec``'s rule: an output dimension of at least 128 that the
    model axis divides is sharded over it."""
    return features % model_axis == 0 and features >= 128


def param_plan(policy: nn.Module, model_axis: int) -> dict:
    """``parallelize_module``'s plan: ``param_spec``'s rule on the port's
    modules.  A Linear stores its weight [out, in], so its output features
    are dimension 0; a qualifying Linear's weight and bias are sharded on
    it, its output all-gathered.  Everything else (the Conv3d kernels, the
    BatchNorms, the value head) is replicated."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel
    return {name: ColwiseParallel(output_layouts=Replicate())
            for name, mod in policy.named_modules()
            if isinstance(mod, nn.Linear)
            and shards_features(mod.out_features, model_axis)}


def shard_policy(policy: nn.Module, mesh: Optional[Mesh]) -> None:
    """Applies ``param_plan`` over the mesh's model axis (nothing without
    one), and points the policy's BatchNorms at the mesh."""
    if mesh is None:
        return
    from gennbv_tpu_torch.models.encoder import BatchNorm
    for mod in policy.modules():
        if isinstance(mod, BatchNorm):
            mod.mesh = mesh
    if mesh.model_axis > 1:
        from torch.distributed.tensor.parallel import parallelize_module
        parallelize_module(policy, mesh.device_mesh[MODEL_AXIS],
                           param_plan(policy, mesh.model_axis))


def check_replicas(module: nn.Module, mesh: Optional[Mesh]) -> None:
    """Raises unless every rank holds rank 0's parameters and buffers
    (broadcast from rank 0 and compared)."""
    if mesh is None:
        return
    for name, t in module.state_dict().items():
        mine = t.detach().clone()
        if not torch.equal(mesh.broadcast_(t.detach().clone()), mine):
            raise RuntimeError(f"rank {mesh.rank}'s {name} differs from rank "
                               "0's: the seeded initialisation diverged")


def is_sharded(t: torch.Tensor) -> bool:
    return isinstance(t, DTensor) and any(p.is_shard() for p in t.placements)


@torch.no_grad()
def local(tensors) -> list:
    """The local tensor of each DTensor (its storage: in-place writes
    reach it), the others as they are."""
    return [t.to_local() if isinstance(t, DTensor) else t for t in tensors]


@torch.no_grad()
def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor: a DTensor's is gathered over its mesh (every rank
    of it must call this)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


@torch.no_grad()
def like(whole: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`whole` laid out as `ref`: a DTensor's local shard of it, else
    `whole` itself."""
    if not isinstance(ref, DTensor):
        return whole
    part = whole.to(ref.device)
    for dim_mesh, place in enumerate(ref.placements):
        if place.is_shard():
            sub = ref.device_mesh
            part = part.chunk(sub.size(dim_mesh), place.dim)[
                sub.get_local_rank(dim_mesh)]
    return DTensor.from_local(part.contiguous(), ref.device_mesh,
                              ref.placements, run_check=False)


@torch.no_grad()
def load_state(module: nn.Module, state: dict) -> None:
    """``load_state_dict`` of whole tensors into a module whose parameters
    may be sharded DTensors."""
    own = module.state_dict()
    if set(own) != set(state):
        raise KeyError(f"state keys differ: missing "
                       f"{sorted(set(own) - set(state))}, unexpected "
                       f"{sorted(set(state) - set(own))}")
    for name, t in own.items():
        src = like(state[name], t)
        local([t])[0].copy_(local([src])[0])


def backend_for(device: torch.device | str, world_size: int) -> str:
    """nccl where `device` is a card and there is a card a rank, else
    gloo."""
    return ("nccl" if torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= world_size else "gloo")


def launch(fn: Callable, world_size: int, *args, device: str = "cuda",
           backend: Optional[str] = None) -> list:
    """Runs ``fn(device, *args)`` on `world_size` new processes, the ranks
    of a process group over a ``FileStore`` in a temporary directory (no
    network); returns their return values in rank order.  `fn` must be
    importable by name; its values are pickled.  A rank on the CPU keeps
    to one torch thread, as the ranks of one host are meant for small
    shapes.  With nccl each rank takes its own card, cuda:rank; gloo ranks
    share `device`; `backend` defaults to ``backend_for``'s.  A rank's
    failure raises here with its traceback."""
    device = torch.device(device)
    backend = backend or backend_for(device, world_size)
    if backend == "nccl" and (device.type != "cuda" or
                              world_size > torch.cuda.device_count()):
        raise RuntimeError(
            f"nccl needs a card a rank: {world_size} ranks, "
            f"{torch.cuda.device_count()} cards; ranks sharing a card or "
            "the CPU run over gloo")
    with tempfile.TemporaryDirectory(prefix="gennbv_ranks_") as tmp:
        torch.multiprocessing.spawn(
            _rank_main, args=(world_size, tmp, backend, str(device), fn, args),
            nprocs=world_size, join=True)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))   # written by the ranks above
        return out


def _rank_main(rank: int, world: int, tmp: str, backend: str, device: str,
               fn: Callable, args: tuple) -> None:
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    extra = {}
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        extra["device_id"] = dev
    elif dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(
        os.path.join(tmp, "store"), world), rank=rank, world_size=world,
        timeout=TIMEOUT, **extra)
    try:
        result = fn(dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@contextlib.contextmanager
def torchrun_group(device: str):
    """The run's device.  Under torchrun (``RANK`` set) this rank's, inside
    the default process group initialised from torchrun's environment and
    destroyed on exit: nccl on the card, each rank on cuda:LOCAL_RANK, and
    gloo on the CPU.  Otherwise `device`, and no group."""
    dev = torch.device(device)
    if "RANK" not in os.environ:
        yield dev
        return
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=TIMEOUT, device_id=dev)
    else:
        dist.init_process_group("gloo", timeout=TIMEOUT)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
