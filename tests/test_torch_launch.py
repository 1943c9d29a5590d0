"""How a sharded run of the port starts (lam_tpu_torch/parallel/mesh.py),
against lam_tpu's (CPU, no rank processes).

- (a) the launcher detection: for every case of a table of environments
  (srun's and mpirun's variables, JAX_COORDINATOR_PORT, explicit values),
  the port's `detect` gives what jax's
  `ClusterEnv.auto_detect_unset_distributed_params` gives lam_tpu's
  `distributed_init`: (coordinator, rank count, rank, local id);
- (b) the card and the backend on faked layouts: each rank's card picked
  by `_rank_device` under its own environment, every rank's (host, card
  UUID) handed to `choose_backend`: NCCL exactly when no card is shared,
  on even and uneven launcher layouts and under per-task card binding;
- (c) `distributed_init` without a launcher (no group), its refusals and
  their wording, the CLIs' one stderr line, a one-rank join from srun's
  variables in process, and a failing NCCL join, which is not retried on
  gloo.
"""

import contextlib
import io
import os
import socket

import pytest
import torch
import torch.distributed as dist
from jax._src import clusters

from lam_tpu_torch import cli as tcli
from lam_tpu_torch.apps import heat_cli
from lam_tpu_torch.bench import runner
from lam_tpu_torch.parallel import mesh as pmesh

_LAUNCH_VARS = ("SLURM_", "OMPI_", "JAX_COORDINATOR_PORT", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "KUBERNETES_SERVICE_HOST")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def env(monkeypatch):
    """A clean launcher environment: set(**vars) puts a case's variables
    in place of every launcher variable of this process."""
    for var in list(os.environ):
        if var.startswith(_LAUNCH_VARS):
            monkeypatch.delenv(var)

    def put(**variables):
        for var in list(os.environ):
            if var.startswith(_LAUNCH_VARS):
                monkeypatch.delenv(var)
        for var, value in variables.items():
            monkeypatch.setenv(var, value)
    return put


def _slurm(nodes="node001", job="123456", ntasks="8", procid="5",
           localid="1"):
    return {"SLURM_JOB_ID": job, "SLURM_STEP_NODELIST": nodes,
            "SLURM_NTASKS": ntasks, "SLURM_PROCID": procid,
            "SLURM_LOCALID": localid}


def _ompi(uri="1531576320.0;tcp://10.96.0.1,10.148.0.1:34911", size="4",
          rank="2", local="0"):
    return {"OMPI_MCA_orte_hnp_uri": uri, "OMPI_COMM_WORLD_SIZE": size,
            "OMPI_COMM_WORLD_RANK": rank, "OMPI_COMM_WORLD_LOCAL_RANK": local}


def _without(variables, var):
    return {k: v for k, v in variables.items() if k != var}


# (name, environment, explicit (coordinator, rank count, rank))
NONE = (None, None, None)
CASES = [
    ("no-launcher", {}, NONE),
    ("no-launcher-explicit", {}, ("h:1", 4, 3)),
    # the four node-list forms of slurm_cluster.py:44-58
    ("slurm-one-node", _slurm("node001"), NONE),
    ("slurm-two-nodes", _slurm("node001,host2"), NONE),
    ("slurm-range", _slurm("node[001-015],host2"), NONE),
    ("slurm-list", _slurm("node[001,007-015],host2"), NONE),
    ("slurm-bracketed", _slurm("mel[2001-2004],mel3001"), NONE),
    # the port range's edges: job % 4096 + 61440
    ("slurm-job-0", _slurm(job="0"), NONE),
    ("slurm-job-4095", _slurm(job="4095"), NONE),
    ("slurm-job-4096", _slurm(job="4096"), NONE),
    ("slurm-job-8191", _slurm(job="8191"), NONE),
    ("slurm-port-override", {**_slurm(), "JAX_COORDINATOR_PORT": "29500"},
     NONE),
    ("slurm-empty-port-override", {**_slurm(), "JAX_COORDINATOR_PORT": ""},
     NONE),
    ("slurm-one-task", _slurm(ntasks="1", procid="0", localid="0"), NONE),
    # a launcher environment with a variable missing is not a launcher
    *[(f"slurm-without-{var}", _without(_slurm(), var), NONE)
      for var in _slurm()],
    *[(f"slurm-without-{var}-explicit", _without(_slurm(), var),
       ("h:1", 4, 3)) for var in _slurm()],
    # explicit values over the environment, one by one
    ("slurm-coordinator-given", _slurm(), ("h:1", None, None)),
    ("slurm-count-given", _slurm(), (None, 16, None)),
    ("slurm-rank-given", _slurm(), (None, None, 7)),
    ("slurm-all-given", _slurm(), ("h:1", 16, 7)),
    # Open MPI: tcp and tcp6 URIs, the port from the job id
    ("ompi-tcp", _ompi(), NONE),
    ("ompi-tcp-one-address", _ompi("1234567.0;tcp://192.168.1.7:40000"),
     NONE),
    ("ompi-tcp6", _ompi("1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,"
                        "2620:10d:c083:150e::3000:2]:43370"), NONE),
    ("ompi-tcp6-one-address", _ompi("4096.0;tcp6://[::1]:43370"), NONE),
    ("ompi-job-0", _ompi("0.0;tcp://10.0.0.1:1"), NONE),
    ("ompi-job-top", _ompi(f"{4095 * 4096}.0;tcp://10.0.0.1:1"), NONE),
    ("ompi-job-wraps", _ompi(f"{4096 * 4096}.0;tcp://10.0.0.1:1"), NONE),
    ("ompi-port-override", {**_ompi(), "JAX_COORDINATOR_PORT": "29500"},
     NONE),
    ("ompi-coordinator-given", _ompi(), ("h:1", None, None)),
    ("ompi-count-given", _ompi(), (None, 16, None)),
    ("ompi-rank-given", _ompi(), (None, None, 7)),
    # jax's order: Open MPI before SLURM
    ("ompi-and-slurm", {**_slurm(), **_ompi()}, NONE),
]


@pytest.mark.parametrize("name,variables,given", CASES,
                         ids=[c[0] for c in CASES])
def test_detection_matches_lam_tpus(env, name, variables, given):
    env(**variables)
    jax_says = clusters.ClusterEnv.auto_detect_unset_distributed_params(
        *given, None, None, None)
    launch = pmesh.detect(*given)
    local = None if launch.local_id is None else [launch.local_id]
    assert (launch.coordinator, launch.num_processes, launch.process_id,
            local) == tuple(jax_says)
    found = pmesh.launcher()
    for key, value in zip(("coordinator", "num_processes", "process_id"),
                          given):
        assert launch.source[key] == ("flags" if value is not None
                                      else found if getattr(
                                          launch, key) is not None
                                      else None)
    assert launch.source["local_id"] == found


def test_the_reference_cases_of_the_slurm_and_ompi_rules(env):
    """The values jax gives on the environments of lam_tpu's launches."""
    env(**_slurm("mel[2001-2004],mel3001"))
    launch = pmesh.detect()
    assert (launch.coordinator, launch.num_processes, launch.process_id,
            launch.local_id) == ("mel2001:62016", 8, 5, 1)
    assert launch.launched_by == "slurm"
    assert pmesh.detect("h:1").coordinator == "h:1"
    env(**_ompi())
    launch = pmesh.detect()
    assert (launch.coordinator, launch.num_processes, launch.process_id,
            launch.local_id) == ("10.96.0.1:62624", 4, 2, 0)
    assert launch.launched_by == "ompi"


def test_torchrun_places_only_the_card(env):
    """LOCAL_RANK picks the card; the rank and count stay the caller's."""
    env(LOCAL_RANK="3", LOCAL_WORLD_SIZE="4", RANK="7", WORLD_SIZE="8")
    launch = pmesh.detect()
    assert (launch.coordinator, launch.num_processes,
            launch.process_id) == NONE
    assert (launch.local_id, launch.source["local_id"]) == (3, "torchrun")
    assert launch.launched_by is None


def test_an_incomplete_open_mpi_launch_is_refused(env):
    env(**_without(_ompi(), "OMPI_COMM_WORLD_RANK"))
    with pytest.raises(ValueError, match="OMPI_COMM_WORLD_RANK is not set"):
        pmesh.detect()
    assert pmesh.detect(process_id=0).process_id == 0
    env(**_ompi("1.0;ud://x"))
    with pytest.raises(ValueError, match="no tcp address"):
        pmesh.detect()


@pytest.mark.parametrize("address,split", [
    ("127.0.0.1:29500", ("127.0.0.1", 29500)),
    ("tcp://node001:61440", ("node001", 61440)),
    ("fe80::b9b:ac5d:9cf0:b858:62880", ("fe80::b9b:ac5d:9cf0:b858", 62880)),
    ("[::1]:5", ("::1", 5))])
def test_coordinator_addresses(address, split):
    assert pmesh._split_address(address) == split


# -- the card and the backend ----------------------------------------------


def _cards(monkeypatch, env, layout, cards_per_host=4, per_task=False):
    """(host, card UUID) of each rank of a layout: layout is a list of
    (host, environment) a rank, each rank's card its `_rank_device` under
    its environment among the cards it sees (all of its host's, or under
    per-task binding only its own, CUDA_VISIBLE_DEVICES one card)."""
    out, devices = [], []
    for rank, (host, variables) in enumerate(layout):
        env(**variables)
        if per_task:
            monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
            visible = [f"GPU-{host}-{rank % cards_per_host}"]
        else:
            monkeypatch.setattr(torch.cuda, "device_count",
                                lambda: cards_per_host)
            visible = [f"GPU-{host}-{c}" for c in range(cards_per_host)]
        dev = pmesh._rank_device("cuda", rank)
        devices.append(dev.index)
        out.append((host, visible[dev.index]))
    return out, devices


def _slurm_layout(ranks_per_host):
    """srun over hosts with these many tasks each: (host, variables)."""
    layout, g = [], sum(ranks_per_host)
    for h, n in enumerate(ranks_per_host):
        for local in range(n):
            layout.append((f"node{h:03d}", _slurm(
                "node[000-009]", ntasks=str(g), procid=str(len(layout)),
                localid=str(local))))
    return layout


def _ompi_layout(ranks_per_host):
    layout, g = [], sum(ranks_per_host)
    for h, n in enumerate(ranks_per_host):
        for local in range(n):
            layout.append((f"host{h}", _ompi(size=str(g),
                                             rank=str(len(layout)),
                                             local=str(local))))
    return layout


@pytest.fixture
def cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_the_old_layouts_keep_their_backends(cuda, monkeypatch, env):
    """tests/test_torch_sharded.py's four cases, through the exchange."""
    one_host = [("h", {})] * 8
    cards, devices = _cards(monkeypatch, env, one_host[:4])
    assert pmesh.choose_backend("cuda", cards) == "nccl"  # 4 on 4 cards
    assert devices == [0, 1, 2, 3]
    cards, devices = _cards(monkeypatch, env, one_host)
    assert pmesh.choose_backend("cuda", cards) == "gloo"  # 8 on 4 cards
    assert devices == [0, 1, 2, 3] * 2
    torchrun = [(f"h{r // 4}", {"LOCAL_RANK": str(r % 4),
                                "LOCAL_WORLD_SIZE": "4"}) for r in range(8)]
    cards, _ = _cards(monkeypatch, env, torchrun)
    assert pmesh.choose_backend("cuda", cards) == "nccl"  # 2 hosts x 4
    two_a_card = [("h", {"LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "8"})
                  for r in range(8)]
    cards, _ = _cards(monkeypatch, env, two_a_card)
    assert pmesh.choose_backend("cuda", cards) == "gloo"
    assert pmesh.choose_backend("cpu", cards[:1]) == "gloo"


def test_srun_over_two_hosts_runs_nccl(cuda, monkeypatch, env):
    """2 hosts x 4 cards, `srun -n 8`: each task on the card of its
    SLURM_LOCALID, not of its rank modulo the cards alone; every card
    distinct, so NCCL (today's rule read all 8 ranks as one host)."""
    cards, devices = _cards(monkeypatch, env, _slurm_layout([4, 4]))
    assert devices == [0, 1, 2, 3] * 2
    assert pmesh.choose_backend("cuda", cards) == "nccl"
    # SLURM_LOCALID, not the rank: 3 tasks on the first host
    cards, devices = _cards(monkeypatch, env, _slurm_layout([3, 4]))
    assert devices == [0, 1, 2, 0, 1, 2, 3]
    assert pmesh.choose_backend("cuda", cards) == "nccl"


def test_per_task_binding_runs_nccl(cuda, monkeypatch, env):
    """`srun --gpus-per-task=1`: each task sees one card, cuda:0, its own;
    the UUIDs differ, so NCCL, though device_count() is 1 on every rank."""
    cards, devices = _cards(monkeypatch, env, _slurm_layout([4, 4]),
                            per_task=True)
    assert devices == [0] * 8
    assert pmesh.choose_backend("cuda", cards) == "nccl"


def test_an_uneven_open_mpi_layout_runs_gloo_on_every_rank(cuda,
                                                           monkeypatch,
                                                           env):
    """mpirun with 4 ranks on one host and 6 on the other (4 cards each):
    two ranks of the second host share a card. Every rank decides from
    the same list, so all of them take gloo (ranks that chose different
    backends would hang in init_process_group)."""
    cards, devices = _cards(monkeypatch, env, _ompi_layout([4, 6]))
    assert devices == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1]
    assert pmesh.choose_backend("cuda", cards) == "gloo"
    even, _ = _cards(monkeypatch, env, _ompi_layout([4, 4]))
    assert pmesh.choose_backend("cuda", even) == "nccl"


def test_an_incomplete_slurm_environment_places_by_rank(cuda, monkeypatch,
                                                        env):
    """SLURM_LOCALID missing: no launcher, so rank r takes card r % 4."""
    layout = [(host, _without(v, "SLURM_STEP_NODELIST"))
              for host, v in _slurm_layout([3, 3])]
    _, devices = _cards(monkeypatch, env, layout)
    assert devices == [0, 1, 2, 3, 0, 1]


# -- distributed_init ------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_no_launcher_and_no_coordinator_is_one_process(env):
    assert pmesh.distributed_init(device="cpu") is None
    assert not dist.is_initialized()
    assert pmesh.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="need --coordinator"):
        pmesh.distributed_init(num_processes=2, device="cpu")


@pytest.mark.parametrize("given,missing", [
    ({}, ("the rank count (--num-processes)",
          "this process's rank (--process-id)")),
    ({"process_id": 0}, ("the rank count (--num-processes)",)),
    ({"num_processes": 2}, ("this process's rank (--process-id)",))])
def test_a_coordinator_alone_names_what_is_missing(env, given, missing):
    with pytest.raises(ValueError) as e:
        pmesh.distributed_init("127.0.0.1:1", device="cpu", **given)
    msg = str(e.value)
    assert msg.startswith("--coordinator 127.0.0.1:1 needs ")
    for what in missing:
        assert what in msg
    assert ("--num-processes" in msg) == ("num_processes" not in given)
    for var in ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
                "SLURM_PROCID", "SLURM_LOCALID", "OMPI_MCA_orte_hnp_uri",
                "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
                "OMPI_COMM_WORLD_LOCAL_RANK"):
        assert var in msg
    assert "\n" not in msg
    assert not dist.is_initialized()


@pytest.mark.parametrize("main,argv,prog", [
    (tcli.main, [], "lam-cg"),
    (heat_cli.main, ["10", "10", "h.bin", "--devices", "2"], "lam-heat"),
    (runner.main, ["--sizes", "64"], "lam-bench")])
def test_the_clis_refuse_a_coordinator_without_a_launcher(env, main, argv,
                                                          prog, capsys,
                                                          tmp_path,
                                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(argv + ["--coordinator", "127.0.0.1:1",
                            "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert err.startswith(f"{prog}: --coordinator 127.0.0.1:1 needs the "
                          "rank count (--num-processes) and this process's "
                          "rank (--process-id)")
    assert len(err.splitlines()) == 1
    assert not dist.is_initialized()


def test_a_one_rank_join_from_srun_variables(env):
    """srun -n 1: distributed_init() with no arguments joins a group of one
    at the node list's first host and JAX_COORDINATOR_PORT; again it is a
    no-op, and a join of another shape is refused."""
    env(**_slurm("127.0.0.1", ntasks="1", procid="0", localid="0"),
        JAX_COORDINATOR_PORT=str(_free_port()))
    launch = pmesh.distributed_init(device="cpu", timeout_s=60)
    try:
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert (launch.process_id, launch.num_processes, launch.device,
                launch.backend, launch.launched_by) == (0, 1, "cpu", "gloo",
                                                        "slurm")
        assert launch.coordinator == \
            f"127.0.0.1:{os.environ['JAX_COORDINATOR_PORT']}"
        assert launch.source == {
            "coordinator": "slurm", "num_processes": "slurm",
            "process_id": "slurm", "local_id": "slurm", "card": None,
            "backend": "cpu"}
        assert pmesh.distributed_init(device="cpu") is launch
        assert pmesh.distributed_init("elsewhere:1", 1, 0,
                                      device="cpu") is launch
        with pytest.raises(RuntimeError, match="cannot be joined again"):
            pmesh.distributed_init(None, 2, 1, device="cpu")
        mesh = pmesh.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
    finally:
        dist.destroy_process_group()


def test_a_failing_nccl_join_is_not_retried_on_gloo(cuda, env,
                                                    monkeypatch):
    """One rank with a card of its own chooses NCCL; when NCCL's join
    fails, distributed_init raises that failure and joins nothing."""
    class Props:
        uuid = "GPU-0"

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: Props())
    monkeypatch.setattr(torch.cuda, "set_device", lambda index: None)
    joins = []

    def init_process_group(backend, **kw):
        joins.append(backend)
        raise RuntimeError(f"{backend} join failed")

    monkeypatch.setattr(dist, "init_process_group", init_process_group)
    with pytest.raises(RuntimeError, match="nccl join failed"):
        pmesh.distributed_init(f"127.0.0.1:{_free_port()}", 1, 0,
                               device="cuda", timeout_s=60)
    assert joins == ["nccl"]
    assert not dist.is_initialized()
