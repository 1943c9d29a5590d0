"""Process groups and the meshes of the sharded backends.

The port of lam_tpu/parallel/mesh.py:22-91 and of the grid of
lam_tpu/parallel/pcg2d.py:57-96. lam_tpu builds a `jax.sharding.Mesh`
and lets XLA emit the collectives; here each shard is a rank of a
`torch.distributed` process group, one rank per device, and the
collectives of the sharded solvers are methods of `Mesh` (1-D) and
`Mesh2D` (the R x R grid: rank i * R + j sits at grid row i, grid
column j, with a process subgroup per grid row and per grid column).

Backend: NCCL when every rank has a card of its own (a CUDA device and
at most one rank of this host per visible card; the host's share of the
ranks is torchrun's LOCAL_WORLD_SIZE where set), gloo when ranks share a
card or the device is the CPU. Gloo's point-to-point operations take CPU tensors
only, so under gloo every collective sends a CUDA tensor through the
host (`Mesh._to_comm` / `_from_comm`, the one place that copies); the
vectors and the matrix stay on the rank's card. Under NCCL the tensors
never leave the card.
"""

from __future__ import annotations

import datetime
import math
import os
import sys

import torch
import torch.distributed as dist

from lam_tpu_torch.solver.operators import resolve_device, vdot

ROWS_AXIS = "rows"


def _local_layout(rank, num_processes):
    """(local rank, local world size) of this process on its host:
    torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE where set; else every rank
    is taken to share this host (rank, num_processes)."""
    local_size = os.environ.get("LOCAL_WORLD_SIZE")
    if local_size is None:
        return rank, num_processes
    return int(os.environ.get("LOCAL_RANK", rank)), int(local_size)


def _rank_device(dev_type, rank):
    """The device of rank r: the card of its LOCAL rank on a host whose
    launcher says so (LOCAL_RANK), else cuda:{r % device_count}; or the
    CPU."""
    if dev_type == "cuda":
        local_rank, _ = _local_layout(rank, None)
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def choose_backend(device, num_processes):
    """'nccl' when each rank of THIS host has a card of its own (the
    host's LOCAL_WORLD_SIZE where set, else all num_processes ranks,
    against the visible cards), else 'gloo' (ranks sharing a card, or
    the CPU). With 2 hosts x 4 cards x 4 ranks each, the 8 ranks run
    NCCL."""
    _, local_size = _local_layout(0, num_processes)
    if (resolve_device(device).type == "cuda"
            and local_size <= torch.cuda.device_count()):
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
    active = True  # every rank of a 1-D mesh takes part (see Mesh2D)

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

    def _reduce(self, x, group, size):
        if size == 1:
            return x
        buf = self._to_comm(x)
        dist.all_reduce(buf, group=group)
        return self._from_comm(buf)

    def _gather(self, x, group, size):
        if size == 1:
            return x
        buf = self._to_comm(x)
        parts = [torch.empty_like(buf) for _ in range(size)]
        dist.all_gather(parts, buf, group=group)
        return self._from_comm(torch.cat(parts))

    def _exchange(self, x, dst, src):
        """Send x to rank dst and return what rank src sent."""
        buf = self._to_comm(x)
        got = torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, buf, dst, self.group),
               dist.P2POp(dist.irecv, got, src, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._from_comm(got)

    def all_reduce(self, x):
        """The sum of x over the ranks, on every rank."""
        return self._reduce(x, self.group, self.size)

    def all_gather(self, x):
        """The ranks' x concatenated in rank order (tiled), on every rank
        (jax.lax.all_gather(tiled=True))."""
        return self._gather(x, self.group, self.size)

    def ppermute_prev(self, x):
        """Send x to rank - 1 and return what rank + 1 sent (the ring
        shift of lam_tpu/parallel/pcg.py:82)."""
        if self.size == 1:
            return x
        return self._exchange(x, (self.rank - 1) % self.size,
                              (self.rank + 1) % self.size)

    def halo(self, first, last):
        """The halo exchange of a row-sharded grid (lam_tpu/apps/heat.py:
        183-192): send this rank's `first` row to rank - 1 and its `last`
        row to rank + 1; returns (up, dn), the last row of rank - 1 and
        the first row of rank + 1, zeros on the mesh's edges (rank 0's
        up, rank size-1's dn), whatever the ring delivers there. Every
        rank posts the same four operations in one batch, the sends and
        receives of each direction under a tag of its own, so they pair
        up in the same order on every rank (two ranks are each other's
        both neighbours)."""
        if self.size == 1:
            return torch.zeros_like(first), torch.zeros_like(last)
        buf = self._to_comm(torch.stack([first, last]))
        got = torch.empty_like(buf)
        prev, nxt = (self.rank - 1) % self.size, (self.rank + 1) % self.size
        ops = [dist.P2POp(dist.isend, buf[1], nxt, self.group, tag=0),
               dist.P2POp(dist.isend, buf[0], prev, self.group, tag=1),
               dist.P2POp(dist.irecv, got[0], prev, self.group, tag=0),
               dist.P2POp(dist.irecv, got[1], nxt, self.group, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if self.rank == 0:
            got[0].zero_()
        if self.rank == self.size - 1:
            got[1].zero_()
        up, dn = self._from_comm(got)
        return up, dn

    def dot(self, u, v):
        """u . v over vectors split across the ranks: the local vdot,
        all-reduced, so every rank holds the same value."""
        return self.all_reduce(vdot(u, v))

    def barrier(self):
        """Return once every rank of the mesh has called it (an
        all-reduce of a zero: the ranks outside a grid take no part)."""
        self.all_reduce(torch.zeros(1, device=self.device))


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


def transpose_perm(r):
    """(source, destination) linear indices of the grid's transpose
    exchange: rank (i, j) receives from (j, i); linear index = i * r + j
    (lam_tpu/parallel/pcg2d.py:81-83)."""
    return [(i * r + j, j * r + i) for i in range(r) for j in range(r)]


class Mesh2D(Mesh):
    """An R x R grid over the first R^2 ranks of the process group: this
    process sits at grid row i = rank // R, grid column j = rank % R.
    `row_group` joins the ranks of its grid row (lam_tpu's psum over
    'cols'), `col_group` those of its grid column (psum over 'rows').
    A rank beyond R^2 is outside the grid (`active` False) and takes no
    part in any solve. A grid of one rank needs no process group."""

    def __init__(self, rank, r, device, backend=None, group=None,
                 row_group=None, col_group=None):
        super().__init__(rank, r * r, device, backend, group)
        self.r = r
        self.active = rank < r * r
        self.i, self.j = divmod(rank, r)
        self.row_group = row_group
        self.col_group = col_group

    def __repr__(self):
        return (f"Mesh2D(rank={self.rank}, grid={self.r}x{self.r}, "
                f"device={self.device}, backend={self.backend})")

    def transpose(self, x):
        """Send x to rank (j, i) and return what it sent: the exchange
        that hands rank (i, j) the vector block j."""
        if self.i == self.j:
            return x
        peer = self.j * self.r + self.i
        return self._exchange(x, peer, peer)

    def all_reduce_row(self, x):
        """The sum of x over this rank's grid row, on each of its ranks."""
        return self._reduce(x, self.row_group, self.r)

    def all_gather_col(self, x):
        """The blocks of this rank's grid column in grid-row order: the
        whole of a vector that is split over grid rows."""
        return self._gather(x, self.col_group, self.r)

    def dot(self, u, v):
        """u . v over vectors split across grid rows and replicated
        across grid columns: the local vdot summed over the grid column."""
        return self._reduce(vdot(u, v), self.col_group, self.r)

    def barrier(self):
        """Return once every rank of the grid has called it: a reduction
        over the grid column, then one over the grid row, which meets a
        rank of every column."""
        zero = torch.zeros(1, device=self.device)
        self.all_reduce_row(self._reduce(zero, self.col_group, self.r))


def make_mesh2d(r=None, device="cuda"):
    """The R x R grid over the first R^2 ranks of the initialized process
    group (default: the largest square; one rank without a group). Every
    rank of the group calls this, the ranks left outside the grid too:
    the row and column subgroups are created collectively. When the
    default leaves ranks idle that is said on stderr (rank 0), and a grid
    larger than the group raises, as lam_tpu's make_mesh2d does."""
    dev_type = resolve_device(device).type
    if dist.is_initialized():
        rank, world, backend = (dist.get_rank(), dist.get_world_size(),
                                dist.get_backend())
        if backend == "nccl" and dev_type != "cuda":
            raise ValueError("the process group runs NCCL: its ranks need "
                             "CUDA devices")
    else:
        rank, world, backend = 0, 1, None
    if r is None:
        r = math.isqrt(world)
        if r * r < world and rank == 0:
            print(f"lam-cg: 2-D grid uses the largest square: "
                  f"{r}x{r} = {r * r} of {world} devices "
                  f"({world - r * r} idle; the 1-D sharded "
                  f"backend uses all devices)", file=sys.stderr)
    if r * r > world:
        raise ValueError(f"need {r * r} devices for a {r}x{r} grid, "
                         f"have {world}")
    row_group = col_group = None
    if r > 1:
        # every rank creates every subgroup, in one order
        for a in range(r):
            grp = dist.new_group([a * r + b for b in range(r)])
            if rank < r * r and rank // r == a:
                row_group = grp
        for b in range(r):
            grp = dist.new_group([a * r + b for a in range(r)])
            if rank < r * r and rank % r == b:
                col_group = grp
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh2D(rank, r, _rank_device(dev_type, rank), backend, group,
                  row_group, col_group)
