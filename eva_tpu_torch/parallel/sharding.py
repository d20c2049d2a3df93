"""Device meshes over torch.distributed, and sharded ciphertext batches.

Port of eva_tpu/parallel/sharding.py: `make_device_mesh`,
`check_ici_axes`, `batch_axes`, `shard_batch`, `replicated` and
`batch_pipeline_step` keep its names. The JAX package builds a
`jax.sharding.Mesh` over the devices one controller sees and runs each
program under `shard_map`. The port runs one process per device (one
rank per card, NCCL; or one rank per CPU process, gloo), and the mesh is
a `torch.distributed.device_mesh.DeviceMesh` over the default process
group with the JAX mesh's axis names and shapes; each axis has its own
process group, over which that axis's collectives run.

Batched ciphertext planes have shape [batch, n_sub, N]:
  * `batch` shards over the mesh "batch" axis (and "host" on a mesh with
    hosts > 1; independent ciphertexts, no communication),
  * `n_sub` (RNS limbs) over the "limb" axis where shard_batch is asked
    for it; the executor shards key-switch digits over "limb" instead
    (backend/executor_torch.TorchProgram, parallel/ks_shard),
  * `N` over the "seq" axis when requested (parallel/seq_exec).

Every rank calls the same functions with the same global arguments (the
SPMD counterpart of the JAX single controller's global view);
`shard_batch` returns the calling rank's local slice.

`shard_map_compat` and `eval_jaxpr_compat` of the JAX module have no
counterpart: they paper over API changes between JAX versions
(`jax.shard_map` vs `jax.experimental.shard_map`, `jax.core.eval_jaxpr`
vs `jax.extend.core`), and the port neither traces nor runs shard_map."""

from __future__ import annotations

import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..backend.tables import DeviceLevelOps

# The process-group backend each mesh device type runs on. No fallback:
# a CUDA mesh over any other backend raises.
BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def mesh_layout(n_devices: int, limb_axis: int = 1, hosts: int = 1,
                seq_axis: int = 1, dcn_limb: int = 1
                ) -> Tuple[List[int], List[str]]:
    """(shape, axis names) of the mesh make_device_mesh builds, laid out
    as eva_tpu.parallel.make_device_mesh lays out its Mesh: ("batch",
    "limb"), a leading "host" with hosts > 1, a trailing "seq" with
    seq_axis > 1, a leading "hlimb" with dcn_limb > 1."""
    if hosts > 1 and dcn_limb > 1:
        raise ValueError("hosts and dcn_limb both claim the process "
                         "dimension")
    if dcn_limb > 1 and limb_axis == 1:
        raise ValueError(
            "dcn_limb needs an intra-host limb axis > 1: the hierarchical "
            "all-reduce's cross-node saving is 1/limb_axis of the plane "
            "bytes")
    cut = limb_axis * hosts * seq_axis * dcn_limb
    if n_devices % cut:
        raise ValueError(f"{n_devices} devices do not split into "
                         f"limb {limb_axis} x hosts {hosts} x seq "
                         f"{seq_axis} x dcn_limb {dcn_limb}")
    shape, names = [n_devices // cut, limb_axis], ["batch", "limb"]
    if seq_axis > 1:
        shape.append(seq_axis)
        names.append("seq")
    if hosts > 1:
        shape.insert(0, hosts)
        names.insert(0, "host")
    if dcn_limb > 1:
        shape.insert(0, dcn_limb)
        names.insert(0, "hlimb")
    return shape, names


def check_ici_axes(nodes: np.ndarray, names: Sequence[str]) -> None:
    """Refuse collective-bearing mesh axes ("limb", "seq") that span
    nodes. `nodes` holds the node (host machine) of each mesh position,
    in the mesh's shape (see node_ids). Their collectives run once per
    key switch or per NTT, and across nodes they would leave NVLink for
    the network. Only the batch axis (no communication) and the
    explicit "host" / "hlimb" axes may cross nodes.
    EVA_TPU_ALLOW_DCN_LIMB=1 overrides for experimentation."""
    if os.environ.get("EVA_TPU_ALLOW_DCN_LIMB"):
        return
    nodes = np.asarray(nodes)
    for ax_name in ("limb", "seq"):
        if ax_name not in names:
            continue
        ax = list(names).index(ax_name)
        if nodes.shape[ax] == 1:
            continue
        first = np.take(nodes, [0], axis=ax)
        if not (nodes == first).all():
            raise ValueError(
                f'mesh axis "{ax_name}" spans multiple hosts (nodes '
                f"{sorted(set(nodes.ravel().tolist()))}): its per-op "
                f"collectives would cross the network between nodes "
                f'instead of NVLink. Shard digits across nodes with the '
                f'"hlimb" axis instead (make_device_mesh dcn_limb=H): its '
                f"accumulation is the hierarchical modular all-reduce, "
                f"whose cross-node hop carries 1/limb of the plane bytes "
                f"(parallel/ks_shard). Or set EVA_TPU_ALLOW_DCN_LIMB=1 to "
                f"override.")


def node_ids(mesh) -> np.ndarray:
    """The node of each rank of `mesh`, in the mesh's shape: rank //
    LOCAL_WORLD_SIZE under torchrun, else the index of each rank's host
    name, gathered from every rank (a collective: every rank calls)."""
    world = dist.get_world_size()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        ids = np.arange(world) // int(local)
    else:
        hosts: List[Optional[str]] = [None] * world
        dist.all_gather_object(hosts, socket.gethostname())
        order = {h: i for i, h in reversed(list(enumerate(hosts)))}
        ids = np.array([order[h] for h in hosts])
    return ids[mesh.mesh.cpu().numpy()]


def check_backend(device_type: str) -> None:
    """Raise unless the default process group can carry collectives of
    `device_type` tensors: NCCL for "cuda" (with a CUDA device), gloo for
    "cpu" (alone or in a per-device backend string)."""
    if device_type not in BACKEND:
        raise ValueError(f"mesh device type {device_type!r}: choose "
                         f"'cuda' or 'cpu'")
    if not dist.is_initialized():
        raise RuntimeError(
            "eva_tpu_torch.parallel: call torch.distributed."
            "init_process_group first (one process per device)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eva_tpu_torch.parallel: a CUDA mesh needs a "
                           "CUDA device")
    backend = str(dist.get_backend())  # e.g. "nccl", "cuda:nccl,cpu:gloo"
    if BACKEND[device_type] not in backend:
        raise RuntimeError(
            f"eva_tpu_torch.parallel: a {device_type} mesh needs the "
            f"{BACKEND[device_type]} backend, not {backend}")


def make_device_mesh(n_devices: Optional[int] = None, limb_axis: int = 1,
                     hosts: int = 1, seq_axis: int = 1, dcn_limb: int = 1,
                     device_type: str = "cuda"):
    """A DeviceMesh over every rank of the default process group, with
    eva_tpu.parallel.make_device_mesh's axes: ("batch", "limb"), with
    hosts > 1 a leading "host" axis, with seq_axis > 1 a trailing "seq"
    axis (the ring dimension N of every polynomial sharded; seq_exec),
    and with dcn_limb > 1 a leading "hlimb" axis, a second digit axis
    that may span nodes (its accumulation is the hierarchical modular
    all-reduce; ks_shard). Ranks fill the mesh in row-major order, so a
    node's consecutive ranks share the inner axes. Every rank calls it;
    it needs torch.distributed.init_process_group first (NCCL for the
    default "cuda", gloo for "cpu"), and n_devices, when given, must be
    the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    check_backend(device_type)
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_device_mesh: {n_devices} devices asked "
                         f"for, the world has {world} ranks")
    shape, names = mesh_layout(n_devices, limb_axis, hosts, seq_axis,
                               dcn_limb)
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))
    check_ici_axes(node_ids(mesh), names)
    return mesh


def mesh_device(mesh) -> torch.device:
    """The torch device this rank computes on for `mesh`."""
    check_backend(mesh.device_type)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis `name`; 1 when the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    return mesh.shape[names.index(name)] if name in names else 1


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along the mesh axis `name` (0 without it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(name) if name in names else 0


def axis_group(mesh, name: str):
    """The process group of the mesh axis `name` (None without it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_group(name) if name in names else None


def batch_axes(mesh):
    """The mesh axis (or axes) the ciphertext-batch dimension shards
    over: ("host", "batch") on a mesh with hosts, "batch" otherwise."""
    return ("host", "batch") if "host" in (mesh.mesh_dim_names or ()) \
        else "batch"


def batch_shard(mesh) -> Tuple[int, int]:
    """(shards, this rank's shard) of the batch dimension: the batch axes
    flattened, "host" major."""
    axes = batch_axes(mesh)
    axes = axes if isinstance(axes, tuple) else (axes,)
    count, index = 1, 0
    for name in axes:
        index = index * axis_size(mesh, name) + axis_index(mesh, name)
        count *= axis_size(mesh, name)
    return count, index


def _residues(planes) -> torch.Tensor:
    """Residue planes as a tensor: a numpy array (values below 2^32) as
    int32 uint32 bits (backend/modmath.py), a tensor as it is."""
    if isinstance(planes, np.ndarray):
        return torch.from_numpy(
            np.ascontiguousarray(planes, dtype=np.uint32).view(np.int32))
    return torch.as_tensor(planes)


def shard_batch(planes, mesh) -> torch.Tensor:
    """This rank's slice of [batch, n_sub, N] planes (numpy residues or
    an int32 tensor): batch over the batch axes, limbs over "limb" when
    it is > 1 and divides n_sub (as eva_tpu.parallel.shard_batch places
    them). The batch must divide evenly."""
    planes = _residues(planes)
    count, index = batch_shard(mesh)
    if planes.shape[0] % count:
        raise ValueError(f"batch {planes.shape[0]} does not split over "
                         f"{count} batch shards")
    loc = planes.shape[0] // count
    out = planes[index * loc:(index + 1) * loc]
    limb = axis_size(mesh, "limb")
    if limb > 1 and planes.shape[1] % limb == 0:
        rows = planes.shape[1] // limb
        i = axis_index(mesh, "limb")
        out = out[:, i * rows:(i + 1) * rows]
    return out.contiguous().to(mesh_device(mesh))


def replicated(arr, mesh) -> torch.Tensor:
    """The whole of `arr` (numpy residues or an int32 tensor) on this
    rank's device of `mesh`."""
    return _residues(arr).to(mesh_device(mesh))


def batch_pipeline_step(dev: DeviceLevelOps, mesh=None):
    """A representative homomorphic step over a sharded ciphertext batch:
    dyadic multiply of two batched size-2 ciphertexts (tensor product),
    an NTT round-trip (as rescale/key-switch do), and the batch-sum of
    results, a cross-ciphertext reduction. Called on this rank's local
    planes (shard_batch); with a mesh the batch sum is the modular
    all-reduce of the local sums over the batch axes, so every rank
    holds the sum over the whole batch, as the JAX step's is. `dev`
    holds the primes of the local limb rows."""
    from .ks_shard import _modular_all_reduce

    def step(a0, a1, b0, b1):
        c0 = dev.mul(a0, b0)
        c1 = dev.add(dev.mul(a0, b1), dev.mul(a1, b0))
        c2 = dev.mul(a1, b1)
        c1 = dev.ntt(dev.intt(c1))
        total = c0
        for c in (c1, c2):
            total = dev.add(total, c)
        batch_sum = total[0]
        for i in range(1, total.shape[0]):
            batch_sum = dev.add(batch_sum, total[i])
        if mesh is not None:
            axes = batch_axes(mesh)
            for name in (axes if isinstance(axes, tuple) else (axes,)):
                batch_sum = _modular_all_reduce(batch_sum, dev,
                                                axis_group(mesh, name))
        return c0, c1, c2, batch_sum

    return step
