"""Process groups and the meshes of the sharded backends.

The port of lam_tpu/parallel/mesh.py:22-91 and of the grid of
lam_tpu/parallel/pcg2d.py:57-96. lam_tpu builds a `jax.sharding.Mesh`
and lets XLA emit the collectives; here each shard is a rank of a
`torch.distributed` process group, one rank per device, and the
collectives of the sharded solvers are methods of `Mesh` (1-D) and
`Mesh2D` (the R x R grid: rank i * R + j sits at grid row i, grid
column j, with a process subgroup per grid row and per grid column).

A run starts as lam_tpu's does (`distributed_init`): one process a rank,
with the coordinator, the rank count and the rank given as flags, or
taken, where they are not given, from the variables of the launcher that
started the processes (srun or mpirun, detected by jax's rules). Each
rank takes the card of its index on its host (the launcher's local id,
or torchrun's LOCAL_RANK), and the ranks exchange their cards' UUIDs
before they join. Backend: NCCL when every rank has a card of its own,
gloo when ranks share a card or the device is the CPU. Gloo's
point-to-point operations take CPU tensors only, so under gloo every
collective sends a CUDA tensor through the host (`Mesh._to_comm` /
`_from_comm`, the one place that copies); the vectors and the matrix stay
on the rank's card. Under NCCL the tensors never leave the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import math
import os
import re
import socket
import sys

import torch
import torch.distributed as dist

from lam_tpu_torch.solver.operators import resolve_device, vdot

ROWS_AXIS = "rows"


# The launchers of lam_tpu's runs, detected by jax.distributed.initialize
# (jax/_src/clusters/{ompi,slurm}_cluster.py), in jax's order: a launcher
# is present only when all of its variables are set
_OMPI_URI = "OMPI_MCA_orte_hnp_uri"
_OMPI = ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
         "OMPI_COMM_WORLD_LOCAL_RANK")
_SLURM = ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
          "SLURM_PROCID", "SLURM_LOCALID")
_PORT_BASE = 65535 - 2**12 + 1  # the coordinator's port range: 4096 ports
_CARD_KEY = "lam_tpu_torch/card/"


def launcher():
    """'ompi' or 'slurm': the launcher this process was started by, as
    jax detects it (Open MPI by OMPI_MCA_orte_hnp_uri, SLURM by all of
    SLURM_JOB_ID, SLURM_STEP_NODELIST, SLURM_NTASKS, SLURM_PROCID and
    SLURM_LOCALID), or None."""
    if _OMPI_URI in os.environ:
        return "ompi"
    if all(var in os.environ for var in _SLURM):
        return "slurm"
    return None


def _env_int(var):
    if var not in os.environ:
        raise ValueError(f"{var} is not set, but {_OMPI_URI} is: this is "
                         "no complete Open MPI launch")
    return int(os.environ[var])


def _launcher_coordinator(name):
    """The coordinator jax derives from the launcher's variables: the
    first host of the SLURM step's node list on port SLURM_JOB_ID % 4096
    + 61440, or the first tcp/tcp6 address of Open MPI's launcher URI on
    port (job id // 4096) % 4096 + 61440; JAX_COORDINATOR_PORT, where
    set, is the port."""
    port = os.environ.get("JAX_COORDINATOR_PORT")
    if name == "slurm":
        if not port:
            port = int(os.environ["SLURM_JOB_ID"]) % 2**12 + _PORT_BASE
        # node001 | node001,host2 | node[001-015],host2 | node[001,007],h
        nodes = os.environ["SLURM_STEP_NODELIST"]
        head = re.match(r"[^,\[]*", nodes).group()
        if nodes[len(head):].startswith("["):
            head += re.match(r"[^,\-]*", nodes[len(head) + 1:]).group()
        return f"{head}:{port}"
    uri = os.environ[_OMPI_URI]
    if not port:
        port = int(uri.split(".", 1)[0]) // 2**12 % 2**12 + _PORT_BASE
    found = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if found is None:
        raise ValueError(f"no tcp address in {_OMPI_URI}={uri!r}")
    return f"{found.group(1) or found.group(2)}:{port}"


@dataclasses.dataclass(frozen=True)
class Launch:
    """A rank's place in a multi-process run and where each part of it
    came from. `source` maps 'coordinator', 'num_processes', 'process_id'
    and 'local_id' to 'flags' (given by the caller), 'slurm', 'ompi' or
    'torchrun' (LOCAL_RANK, which only places the card), or None where
    nothing gave it. `local_id` is the rank's index on its host, which
    picks its card. After the join, `device`, `backend`, `host` and
    `uuid` (the card's; None on the CPU) are filled in, and `source`
    also holds 'card' (where the card's index came from: the local id's
    source, or 'flags' for the rank) and 'backend' ('cards' when the
    ranks' card UUIDs decided it, 'cpu' on the CPU)."""

    coordinator: str | None
    num_processes: int | None
    process_id: int | None
    local_id: int | None
    source: dict
    device: str | None = None
    backend: str | None = None
    host: str | None = None
    uuid: str | None = None

    @property
    def launched_by(self):
        """Where the rank came from: 'slurm', 'ompi', or 'flags' when the
        caller gave it."""
        return self.source["process_id"]


def _local_id():
    """(the rank's index on its host, its source): Open MPI's or SLURM's
    local rank under those launchers, torchrun's LOCAL_RANK, or (None,
    None)."""
    name = launcher()
    if name == "ompi":
        return _env_int("OMPI_COMM_WORLD_LOCAL_RANK"), name
    if name == "slurm":
        return int(os.environ["SLURM_LOCALID"]), name
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"]), "torchrun"
    return None, None


def detect(coordinator_address=None, num_processes=None, process_id=None):
    """The run's coordinator, rank count, rank and local id: each value
    given wins, each one not given comes from the launcher, if one is
    found (jax's ClusterEnv.auto_detect_unset_distributed_params with
    lam_tpu's launchers). A value nothing gave stays None."""
    name = launcher()
    given = {"coordinator": coordinator_address,
             "num_processes": num_processes, "process_id": process_id}
    source = {k: "flags" if v is not None else None for k, v in given.items()}
    if name is not None:
        if coordinator_address is None:
            coordinator_address = _launcher_coordinator(name)
            source["coordinator"] = name
        count, rank = (("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK")
                       if name == "ompi" else ("SLURM_NTASKS", "SLURM_PROCID"))
        if num_processes is None:
            num_processes = _env_int(count)
            source["num_processes"] = name
        if process_id is None:
            process_id = _env_int(rank)
            source["process_id"] = name
    local_id, source["local_id"] = _local_id()
    return Launch(coordinator_address, num_processes, process_id, local_id,
                  source)


def _card_index(local_id, rank):
    """The card of a rank: its local id's, else its rank's, modulo the
    visible cards (one card a task under `srun --gpus-per-task=1`)."""
    return (rank if local_id is None else local_id) % torch.cuda.device_count()


def _rank_device(dev_type, rank):
    """The device of rank r: on CUDA the card of its local id where a
    launcher sets one (SLURM_LOCALID, OMPI_COMM_WORLD_LOCAL_RANK,
    LOCAL_RANK), else cuda:{r % device_count}; or the CPU."""
    if dev_type == "cuda":
        return torch.device("cuda", _card_index(_local_id()[0], rank))
    return torch.device("cpu")


def choose_backend(device, cards):
    """'nccl' when the device is CUDA and every rank has a card of its
    own: `cards`, one (host, card UUID) a rank, holds no card twice;
    'gloo' when ranks share a card, or on the CPU. Every rank decides
    from the same list, whatever the layout of its own host."""
    if resolve_device(device).type == "cuda" and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def _split_address(address):
    """(host, port) of 'host:port' or 'tcp://host:port' (an IPv6 host
    bare, as jax writes Open MPI's, or in brackets)."""
    host, port = address.split("://", 1)[-1].rsplit(":", 1)
    return host.strip("[]"), int(port)


def _exchange_cards(store, rank, size, card):
    """Every rank's card, in rank order, through the coordinator's store:
    the counterpart of the reference's host-name hash, which binds the
    ranks to their cards (ConjugateGradient_MultiGPUS_CUDA_MPI.cu:444-456)."""
    store.set(f"{_CARD_KEY}{rank}", json.dumps(card))
    keys = [f"{_CARD_KEY}{r}" for r in range(size)]
    store.wait(keys)
    return [tuple(json.loads(store.get(k))) for k in keys]


_joined = None  # the Launch of this process's group, once joined here


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None, device="cuda", timeout_s=1800):
    """Join the process group of a multi-process run (the analog of
    lam_tpu's `distributed_init`, the reference's MPI_Init + NCCL
    communicator setup) and return its `Launch`.

    The values given win; each one not given comes from the launcher
    (`detect`: srun's or mpirun's variables), the coordinator too. With
    no coordinator and no launcher this is a no-op that returns None:
    one process, no group. A coordinator without a rank count or rank is
    a ValueError that names what is missing. The ranks meet in a TCP
    store at the coordinator (rank 0 hosts it), exchange their cards'
    (host, UUID), and join over NCCL when every card is distinct, else
    over gloo (`choose_backend`); a failing NCCL join raises.

    Calling it again when joined is a no-op where the rank count and rank
    match; a process group of another shape cannot be joined a second
    time."""
    global _joined
    launch = detect(coordinator_address, num_processes, process_id)
    size, rank = launch.num_processes, launch.process_id
    if dist.is_initialized():
        if ((size is not None and size != dist.get_world_size())
                or (rank is not None and rank != dist.get_rank())):
            raise RuntimeError(
                "torch.distributed is already initialized with world size "
                f"{dist.get_world_size()} and rank {dist.get_rank()}; it "
                f"cannot be joined again as rank {rank} of {size}")
        if _joined is not None and (_joined.num_processes,
                                    _joined.process_id) == (
                                        dist.get_world_size(),
                                        dist.get_rank()):
            return _joined
        return dataclasses.replace(
            launch, num_processes=dist.get_world_size(),
            process_id=dist.get_rank(), backend=dist.get_backend())
    if launch.coordinator is None:
        if size is not None or rank is not None:
            raise ValueError("--num-processes and --process-id need "
                             "--coordinator")
        return None
    missing = [what for what, value in (
        ("the rank count (--num-processes)", size),
        ("this process's rank (--process-id)", rank)) if value is None]
    if missing:
        raise ValueError(
            f"--coordinator {launch.coordinator} needs "
            f"{' and '.join(missing)}: no launcher gave it (srun sets "
            f"{', '.join(_SLURM)}; mpirun {_OMPI_URI}, "
            f"{', '.join(_OMPI)})")
    if not 0 <= rank < size:
        raise ValueError(f"process id {rank} is outside 0..{size - 1}")
    dev = resolve_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    host, port = _split_address(launch.coordinator)
    store = dist.TCPStore(host, port, size, rank == 0, timeout=timeout,
                          multi_tenant=True)
    me, source = socket.gethostname(), dict(launch.source)
    if dev.type == "cuda":
        index = _card_index(launch.local_id, rank)
        uuid = str(torch.cuda.get_device_properties(index).uuid)
        backend = choose_backend(dev, _exchange_cards(store, rank, size,
                                                      (me, uuid)))
        device_name = f"cuda:{index}"
        source.update(card=source["local_id"] or "flags", backend="cards")
        if backend == "nccl":
            torch.cuda.set_device(index)
    else:
        uuid, backend, device_name = None, "gloo", "cpu"
        source.update(card=None, backend="cpu")
        if "OMP_NUM_THREADS" not in os.environ:
            # the ranks of a CPU cluster share the host's cores: a full
            # thread pool in each would oversubscribe them many times over
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    dist.init_process_group(backend, store=store, world_size=size, rank=rank,
                            timeout=timeout)
    _joined = dataclasses.replace(launch, source=source, device=device_name,
                                  backend=backend, host=me, uuid=uuid)
    return _joined


@contextlib.contextmanager
def process_group(coordinator, num_processes, process_id, device="cuda"):
    """The process group of an entry point's run (the CLIs' --coordinator,
    --num-processes, --process-id): joined by `distributed_init`, which
    takes the rank count and rank from srun's or mpirun's variables where
    the flags leave them out, and left at the end, after a barrier, since
    the store's host (rank 0) must not leave while another rank still
    talks to it. A group the caller joined already (a launcher running
    several entry points a process) is kept. Without a coordinator there
    is no group to join, under a launcher too (lam_tpu's CLI joins only
    with --coordinator), and a rank count or rank alone is refused."""
    if not coordinator:
        if num_processes is not None or process_id is not None:
            raise ValueError("--num-processes and --process-id need "
                             "--coordinator")
        yield
        return
    owns = not dist.is_initialized()
    distributed_init(coordinator, num_processes, process_id, device=device)
    try:
        yield
        if owns:
            dist.barrier()
    finally:
        if owns:
            dist.destroy_process_group()


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
