"""Process groups and the 1-D mesh of the sharded backends.

The port of lam_tpu/parallel/mesh.py:22-91. lam_tpu builds a
`jax.sharding.Mesh` and lets XLA emit the collectives; here each shard is
a rank of a `torch.distributed` process group, one rank per device, and
the collectives of the sharded solvers are methods of `Mesh`.

Backend: NCCL when every rank has a card of its own (a CUDA device and
at most one rank per visible card), gloo when ranks share a card or the
device is the CPU. Gloo's point-to-point operations take CPU tensors
only, so under gloo every collective sends a CUDA tensor through the
host (`Mesh._to_comm` / `_from_comm`, the one place that copies); the
vectors and the matrix stay on the rank's card. Under NCCL the tensors
never leave the card.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from lam_tpu_torch.solver.operators import resolve_device, vdot

ROWS_AXIS = "rows"


def _rank_device(dev_type, rank):
    """The device of rank r: cuda:{r % device_count} or the CPU."""
    if dev_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def choose_backend(device, num_processes):
    """'nccl' when each of num_processes ranks has a card of its own,
    else 'gloo' (ranks sharing a card, or the CPU)."""
    if (resolve_device(device).type == "cuda"
            and num_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def distributed_init(coordinator_address, num_processes, process_id,
                     device="cuda", timeout_s=1800):
    """Join the process group of a multi-process run (the analog of
    lam_tpu's jax.distributed bootstrap and of the reference's MPI_Init +
    NCCL communicator setup): `init_process_group` over
    tcp://<coordinator_address> with the given world size and rank, on
    the backend `choose_backend` picks. Returns the backend.

    Calling it again with the same world size and rank is a no-op; a
    process group of another shape cannot be joined a second time."""
    if num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --num-processes and "
                         "--process-id beside --coordinator")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside "
                         f"0..{num_processes - 1}")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes,
                                                        process_id):
            raise RuntimeError(
                "torch.distributed is already initialized with world size "
                f"{dist.get_world_size()} and rank {dist.get_rank()}; it "
                "cannot be joined again as rank "
                f"{process_id} of {num_processes}")
        return dist.get_backend()
    backend = choose_backend(device, num_processes)
    if backend == "nccl":
        torch.cuda.set_device(_rank_device("cuda", process_id))
    elif (resolve_device(device).type == "cpu"
          and "OMP_NUM_THREADS" not in os.environ):
        # the ranks of a CPU cluster share the host's cores: a full
        # thread pool in each would oversubscribe them many times over
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // num_processes))
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


class Mesh:
    """A 1-D mesh of `size` ranks: this process's `rank`, its `device`,
    the process `group` and its `backend` (both None without a group) and
    the collectives of the sharded solvers. A mesh of one rank needs no
    process group: every collective is the identity."""

    axis = ROWS_AXIS

    def __init__(self, rank, size, device, backend=None, group=None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        # gloo sends CUDA tensors through the host
        self._via_host = backend == "gloo" and self.device.type == "cuda"

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")

    def _to_comm(self, x):
        """A copy of x where the backend reads it (the caller's tensor
        is never handed to a collective that writes in place)."""
        return x.detach().to("cpu" if self._via_host else x.device,
                             copy=True).contiguous()

    def _from_comm(self, x):
        return x.to(self.device)

    def all_reduce(self, x):
        """The sum of x over the ranks, on every rank."""
        if self.size == 1:
            return x
        buf = self._to_comm(x)
        dist.all_reduce(buf, group=self.group)
        return self._from_comm(buf)

    def all_gather(self, x):
        """The ranks' x concatenated in rank order (tiled), on every rank
        (jax.lax.all_gather(tiled=True))."""
        if self.size == 1:
            return x
        buf = self._to_comm(x)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return self._from_comm(torch.cat(parts))

    def ppermute_prev(self, x):
        """Send x to rank - 1 and return what rank + 1 sent (the ring
        shift of lam_tpu/parallel/pcg.py:82)."""
        if self.size == 1:
            return x
        buf = self._to_comm(x)
        got = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, (self.rank - 1) % self.size,
                          self.group),
               dist.P2POp(dist.irecv, got, (self.rank + 1) % self.size,
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._from_comm(got)

    def dot(self, u, v):
        """u . v over vectors split across the ranks: the local vdot,
        all-reduced, so every rank holds the same value."""
        return self.all_reduce(vdot(u, v))


def make_mesh(n_devices=None, device="cuda"):
    """The 1-D mesh of this process: every rank of the initialized
    process group, or one rank without a group. Raises when n_devices is
    given and is not the group's size (lam_tpu's make_mesh raises when
    asked for more devices than it has)."""
    dev_type = resolve_device(device).type
    if dist.is_initialized():
        group = dist.group.WORLD
        rank, size, backend = (dist.get_rank(), dist.get_world_size(),
                               dist.get_backend())
        if backend == "nccl" and dev_type != "cuda":
            raise ValueError("the process group runs NCCL: its ranks need "
                             "CUDA devices")
    else:
        rank, size, backend, group = 0, 1, None, None
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"requested {n_devices} devices, the process group has {size} "
            "rank(s): start one process per device (--coordinator, "
            "--num-processes, --process-id)")
    return Mesh(rank, size, _rank_device(dev_type, rank), backend, group)
