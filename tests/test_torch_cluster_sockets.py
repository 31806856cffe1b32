"""Socket transport + net-chaos suite of the port (``placement=
"sockets"``, workers on the CPU) — case for case the JAX package's
``tests/test_serving_sockets.py``.

The TCP placement must be *the same serving cluster, plus the network
as a first-class failure domain*: identical framing and corruption
taxonomy as pipes, an authenticated hello (token + shard + pid), and —
the part pipes cannot do — RECONNECTION: a worker that loses its link
redials under a deterministic RetryPolicy and the router reattaches the
SAME live process, resyncing the decisions the dead link ate instead of
paying a journal recovery.  Every ``net:drop|delay|partition|reconnect``
fault must end bit-identical to a clean run with the accounting
identity closed, on CPU, deterministically.
"""

import os
import subprocess
import sys
import time

import pytest

from redqueen_tpu_torch import serving
from redqueen_tpu_torch.runtime import faultinject
from redqueen_tpu_torch.serving.transport import (ENV_WORKER_TOKEN, Listener,
                                            TransportTimeout,
                                            connect_worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_FEEDS = 12
N_BATCHES = 14
TOKEN = "test-cluster-token"

CLUSTER_KW = dict(n_feeds=N_FEEDS, n_shards=2, snapshot_every=10 ** 9,
                  coalesce=4, flush_mode="group",
                  max_unflushed_records=64, max_flush_delay_ms=25.0,
                  reorder_window=4, queue_capacity=64)


def _batches():
    return serving.synthetic_stream(0, N_BATCHES, N_FEEDS,
                                    events_per_batch=5)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Clean in-process run: the digests every socket/chaos run must
    reproduce bitwise (placement is not identity)."""
    d = tmp_path_factory.mktemp("sock_ref")
    cl = serving.ServingCluster(dir=str(d), **CLUSTER_KW, device="cpu")
    with cl:
        serving.drive(cl, _batches())
        return {"cluster": cl.cluster_digest(),
                "edge": cl.edge_digest()}


def _socket_cluster(dir, **kw):
    kw.setdefault("worker_request_timeout_s", 1.5)
    kw.setdefault("worker_read_timeout_s", 5.0)
    kw.setdefault("worker_reattach_grace_s", 10.0)
    return serving.ServingCluster(dir=str(dir), placement="sockets",
                                  token=TOKEN, **CLUSTER_KW, **kw,
device="cpu")


# ---------------------------------------------------------------------------
# net:* fault parsing + placement validation (fast, torch-free)
# ---------------------------------------------------------------------------


class TestNetFaultSpecs:
    def test_parse_every_mode(self):
        for mode in faultinject.NET_MODES:
            nf = faultinject.parse_net(f"{mode}@shard1,batch5")
            assert nf == faultinject.NetFault(mode, 1, 5)
        assert faultinject.parse_net("drop@shard0") == \
            faultinject.NetFault("drop", 0, None)

    @pytest.mark.parametrize("bad", [
        "net:@shard0", "net:sever@shard0", "net:drop@lane0",
        "net:drop@shard-1", "net:drop@shard0,lane2"])
    def test_malformed_specs_raise(self, bad, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, bad)
        with pytest.raises(ValueError):
            faultinject.maybe_inject()

    def test_env_accessor_fires_only_for_net_kind(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "net:drop@shard1")
        assert faultinject.net_fault() == \
            faultinject.NetFault("drop", 1, None)
        monkeypatch.setenv(faultinject.ENV_FAULT, "ingest:dup@batch1")
        assert faultinject.net_fault() is None

    def test_net_fault_refused_off_socket_placement(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "net:drop@shard0")
        with pytest.raises(ValueError, match="could never fire"):
            serving.ServingCluster(dir=str(tmp_path / "a"), **CLUSTER_KW,
                                   device="cpu")

    def test_net_fault_shard_range_checked(self, tmp_path, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "net:drop@shard7")
        with pytest.raises(ValueError, match="could never fire"):
            _socket_cluster(tmp_path / "b")

    def test_sockets_need_directory(self):
        with pytest.raises(ValueError, match="needs a cluster directory"):
            serving.ServingCluster(n_feeds=4, n_shards=2,
                                   placement="sockets", device="cpu")

    def test_partition_shard_needs_sockets(self, tmp_path):
        cl = serving.ServingCluster(dir=str(tmp_path / "c"),
                                    **CLUSTER_KW, device="cpu")
        with cl:
            with pytest.raises(ValueError, match="sockets"):
                cl.partition_shard(0)


# ---------------------------------------------------------------------------
# Listener authentication (fast, torch-free)
# ---------------------------------------------------------------------------


class TestListenerAuth:
    def test_hello_roundtrip(self):
        with Listener() as lst:
            sock = connect_worker(lst.address, shard=3, token="tok")
            conn, hello, reader = lst.accept("tok", 3, timeout_s=5.0)
            assert hello["shard"] == 3 and hello["pid"] == os.getpid()
            conn.close()
            sock.close()

    @pytest.mark.parametrize("wrong", [
        {"token": "WRONG"}, {"shard": 9}])
    def test_bad_credentials_refused(self, wrong):
        """A connection with the wrong token or shard is closed and the
        slot stays open (the accept times out rather than adopting a
        stranger)."""
        with Listener() as lst:
            kw = dict(shard=3, token="tok")
            kw.update(wrong)
            sock = connect_worker(lst.address, **kw)
            with pytest.raises(TransportTimeout):
                lst.accept("tok", 3, timeout_s=0.5)
            sock.close()

    def test_wrong_pid_refused_on_reattach(self):
        """Reattach requires the SAME process: a hello with a foreign
        pid is refused even with valid token + shard."""
        with Listener() as lst:
            sock = connect_worker(lst.address, shard=3, token="tok")
            with pytest.raises(TransportTimeout):
                lst.accept("tok", 3, timeout_s=0.5,
                           expect_pid=os.getpid() + 12345)
            sock.close()

    def test_connect_worker_closes_socket_when_hello_write_fails(
            self, monkeypatch):
        """Regression (the redial-loop fd leak): a hello
        that fails to send must CLOSE the dialed socket before the
        error propagates — the RetryPolicy redial loop retries for
        hours, and one leaked fd per attempt exhausts the fd table."""
        from redqueen_tpu_torch.serving import transport as tmod

        def boom(fd, payload):
            raise OSError("injected hello failure")

        monkeypatch.setattr(tmod, "write_frame", boom)
        with Listener() as lst:
            fds_before = len(os.listdir("/proc/self/fd"))
            with pytest.raises(OSError, match="injected hello"):
                connect_worker(lst.address, shard=3, token="tok")
            fds_after = len(os.listdir("/proc/self/fd"))
        assert fds_after == fds_before, (
            "connect_worker leaked a socket fd on the failed-hello "
            "path")

    def test_accept_closes_conn_when_handshake_read_raises(
            self, monkeypatch):
        """Regression: an OSError mid-handshake (reset
        conn, dead fd) must close the accepted connection and keep
        waiting — never leak the fd or abort the slot."""
        from redqueen_tpu_torch.serving import transport as tmod

        def boom(self, timeout_s=None):
            raise OSError("injected reset")

        monkeypatch.setattr(tmod.FrameReader, "read_frame", boom)
        with Listener() as lst:
            sock = connect_worker(lst.address, shard=3, token="tok")
            fds_before = len(os.listdir("/proc/self/fd"))
            with pytest.raises(TransportTimeout):
                lst.accept("tok", 3, timeout_s=0.5)
            fds_after = len(os.listdir("/proc/self/fd"))
            sock.close()
        assert fds_after <= fds_before, (
            "Listener.accept leaked the accepted conn on the "
            "mid-handshake failure path")

    def test_remote_command_shape(self, tmp_path):
        cl = _socket_cluster(tmp_path / "rc", _open_runtimes=False)
        cmds = cl.remote_worker_commands()
        assert len(cmds) == 2
        for c in cmds:
            assert "--connect" in c["argv"]
            assert c["env"] == [ENV_WORKER_TOKEN]
            assert TOKEN not in " ".join(c["argv"])  # never in argv
        cl.close()


# ---------------------------------------------------------------------------
# End-to-end socket serving (slow: spawns torch workers)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_socket_placement_is_bit_identical(tmp_path, reference):
    """Same stream over TCP workers: same cluster digest, same edge
    digest, closed accounting — placement is not identity."""
    cl = _socket_cluster(tmp_path / "srv")
    with cl:
        serving.drive(cl, _batches())
        assert cl.applied_seq == N_BATCHES - 1
        rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
        assert rep["reconciles"]
        assert rep["crashes"] == 0
        assert cl.cluster_digest() == reference["cluster"]
        assert cl.edge_digest() == reference["edge"]


@pytest.mark.slow
@pytest.mark.parametrize("fault", [
    "net:drop@shard1,batch5",
    "net:delay@shard1,batch5",
    "net:partition@shard1,batch5",
    "net:reconnect@shard1,batch5",
])
def test_net_chaos_heals_bit_identically(tmp_path, monkeypatch,
                                         reference, fault):
    """Every link failure mode: the stream ends bit-identical to a
    clean run, no worker is ever crashed/journal-recovered for a mere
    network failure, and the ledger reconciles — with the healing
    mechanism visible in the counters (reattach for partition/
    reconnect, resync for responses the link ate)."""
    monkeypatch.setenv(faultinject.ENV_FAULT, fault)
    mode = fault.split(":")[1].split("@")[0]
    cl = _socket_cluster(tmp_path / "chaos")
    with cl:
        serving.drive(cl, _batches(), max_retransmit_rounds=8,
                      retry_delay_s=0.4)
        assert cl.applied_seq == N_BATCHES - 1
        rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
        assert rep["reconciles"]
        assert rep["crashes"] == 0, \
            [s["last_crash_reason"] for s in rep["shards"]]
        assert rep["recoveries"] == 0  # no journal replay for net chaos
        if mode in ("drop", "delay"):
            assert rep["timeouts"] >= 1
        if mode in ("partition", "reconnect"):
            assert rep["reattaches"] >= 1
        if mode in ("drop", "partition"):
            # The response the network ate was resynced from the
            # worker's recent-ring, never silently lost.
            assert rep["resyncs"] >= 1
        assert cl.cluster_digest() == reference["cluster"]
        assert cl.edge_digest() == reference["edge"]


@pytest.mark.slow
def test_router_side_partition_and_kill_compound(tmp_path, reference):
    """The bench's compound chaos at test scale: one worker REALLY
    SIGKILLed and another's link severed from the ROUTER side in the
    same window — the partitioned worker reattaches (no replay), the
    killed one restarts + journal-recovers, the stream reconverges
    bit-identically and the ledger closes."""
    batches = _batches()
    cl = _socket_cluster(tmp_path / "compound", auto_recover=True)
    with cl:
        serving.drive(cl, batches[:7])
        cl.kill_shard(0, reason="test: compound chaos kill")
        cl.partition_shard(1)
        serving.drive(cl, batches, max_retransmit_rounds=10,
                      retry_delay_s=0.4)
        assert cl.applied_seq == N_BATCHES - 1
        rep = cl.metrics.report(cl.pending_by_shard, cl.health_by_shard)
        assert rep["reconciles"]
        assert rep["crashes"] >= 1 and rep["recoveries"] >= 1
        assert rep["reattaches"] >= 1
        assert cl.cluster_digest() == reference["cluster"]
        assert cl.edge_digest() == reference["edge"]


@pytest.mark.slow
def test_remote_spawn_recipe_serves(tmp_path, reference):
    """The remote-spawn proof, PUBLIC API only: build the cluster with
    ``external_workers=True``, launch every worker OURSELVES from the
    printed recipe (argv + token env — exactly what an operator runs on
    another host), ``adopt_external_worker`` each dial-in, and serve
    the full stream bit-identically."""
    cl = _socket_cluster(tmp_path / "remote", external_workers=True)
    procs = []
    try:
        cmds = cl.remote_worker_commands()
        env = dict(os.environ)
        env["RQ_SERVING_WORKER"] = "1"
        env[ENV_WORKER_TOKEN] = TOKEN
        for c in cmds:
            procs.append(subprocess.Popen(c["argv"], env=env, cwd=REPO,
                                          stdin=subprocess.DEVNULL))
        for c in cmds:
            cl.adopt_external_worker(c["shard"], accept_timeout_s=30.0)
        serving.drive(cl, _batches())
        assert cl.applied_seq == N_BATCHES - 1
        assert cl.cluster_digest() == reference["cluster"]
        # the router never owns an external process: recovery is the
        # operator's adoption, not an auto-respawn
        with pytest.raises(ValueError, match="adopt_external_worker"):
            cl.kill_shard(0, reason="test")
            cl.recover_shard(0)
        cl.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)


@pytest.mark.slow
def test_worker_child_stays_torch_free_until_open_socket(tmp_path):
    """The import-discipline proof carries over to socket mode: a
    spawned --connect worker answers hello + shutdown without ever
    importing torch (or jax)."""
    from redqueen_tpu_torch.serving.worker import SocketWorkerHandle

    lst = Listener()
    code = (
        "import sys\n"
        "sys.argv = ['worker', '--dir', %r, '--shard', '0',"
        " '--connect', %r]\n"
        "from redqueen_tpu_torch.serving import worker\n"
        "rc = worker.main(sys.argv[1:])\n"
        "assert 'torch' not in sys.modules, 'worker imported torch'\n"
        "assert 'jax' not in sys.modules, 'worker imported jax'\n"
        "sys.exit(rc)\n" % (str(tmp_path / "w"), lst.address))
    env = dict(os.environ)
    env["RQ_SERVING_WORKER"] = "1"
    env[ENV_WORKER_TOKEN] = "tok"
    os.makedirs(tmp_path / "w", exist_ok=True)
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            cwd=REPO, stdin=subprocess.DEVNULL)
    try:
        conn, hello, reader = lst.accept("tok", 0, timeout_s=30.0,
                                         expect_pid=proc.pid)
        h = SocketWorkerHandle(proc, 0, lst, "tok", conn, reader)
        t0 = time.monotonic()
        h.request("shutdown", timeout_s=10.0)
        assert time.monotonic() - t0 < 10.0
        assert proc.wait(timeout=10.0) == 0  # the in-child assert ran
    finally:
        if proc.poll() is None:
            proc.kill()
        lst.close()
