"""Out-of-process shard workers of the port (workers on the CPU, case
for case the JAX package's ``tests/test_serving_workers.py``): the
frame transport's fuzz
contract, placement equivalence, supervised restart, and THE
process-level chaos acceptance scenario — SIGKILL 1 of 4 REAL worker
processes mid-stream and prove (a) the surviving processes keep serving
without stall or shed, (b) the restarted worker recovers a bit-identical
carry and decision stream from its own journal, and (c) cluster
accounting reconciles including the outage window.  All deterministic,
on CPU, driven by the ``worker:*`` fault kinds.

The worker-spawning tests pay a real subprocess + torch import per worker
— they are the POINT (the crash domain is a process), so the suite keeps
their count small and shares one uninterrupted in-process reference
(which doubles as the placement-equivalence witness: worker-mode runs
must reproduce its digests bitwise).  Those scenarios carry
``@pytest.mark.slow`` exactly where the JAX package's counterparts do:
the tier-1 gate (``-m 'not slow'``) skips them; run this file
unfiltered to include them.
"""

import os
import signal
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

from redqueen_tpu_torch import serving
from redqueen_tpu_torch.runtime import faultinject
from redqueen_tpu_torch.runtime.supervisor import RetryPolicy
from redqueen_tpu_torch.serving import cluster as cluster_mod
from redqueen_tpu_torch.serving import transport
from redqueen_tpu_torch.serving import worker as worker_mod
from redqueen_tpu_torch.serving.journal import Journal
from redqueen_tpu_torch.serving.transport import (FrameError, FrameReader,
                                            TransportEOF,
                                            TransportTimeout,
                                            encode_frame, write_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS = dict(n_feeds=16, n_shards=4, q=1.0, seed=0, snapshot_every=3,
              reorder_window=8, queue_capacity=64)
N_BATCHES = 10

# Restarts gate on the RetryPolicy clock; zero delays keep the chaos
# tests fast and deterministic while still exercising the gate itself.
FAST_RESTART = RetryPolicy(max_attempts=3, base_delay_s=0.0,
                           multiplier=2.0, max_delay_s=0.0, jitter=0.0,
                           seed=0)


def _batches(n=N_BATCHES):
    return serving.synthetic_stream(0, n, PARAMS["n_feeds"],
                                    events_per_batch=6)


def _worker_cluster(dir, **kw):
    kw.setdefault("placement", "workers")
    kw.setdefault("restart_policy", FAST_RESTART)
    kw.setdefault("worker_request_timeout_s", 60.0)
    return serving.ServingCluster(dir=str(dir), **PARAMS, **kw, device="cpu")


def _drain(cl, batches, rounds=12, sleep_s=0.05):
    """Retransmit everything past the cluster's acked position until it
    converges (the source model) — poll-first so restarts/recovery run;
    the small sleep lets worker restarts land between rounds."""
    for _ in range(rounds):
        cl.poll()
        missing = [b for b in batches if int(b.seq) > cl.applied_seq]
        if not missing:
            break
        for b in missing:
            cl.submit(b)
            cl.poll()
        time.sleep(sleep_s)
    cl.poll()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted IN-PROCESS run: every worker-mode scenario must
    reproduce its digests and per-shard decision histories bitwise —
    one fixture proves both chaos recovery AND placement equivalence."""
    d = tmp_path_factory.mktemp("worker_ref")
    batches = _batches()
    cl = serving.ServingCluster(dir=str(d), **PARAMS, device="cpu")
    with cl:
        for b in batches:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches)
        assert cl.applied_seq == N_BATCHES - 1
        return {
            "cluster_digest": cl.cluster_digest(),
            "edge_digest": cl.edge_digest(),
            "decisions": [serving.journal_decisions(sd)
                          for sd in cl.shard_dirs],
        }


def _assert_matches_reference(cl, reference):
    assert cl.applied_seq == N_BATCHES - 1
    assert cl.cluster_digest() == reference["cluster_digest"]
    assert cl.edge_digest() == reference["edge_digest"]
    for sd, want in zip(cl.shard_dirs, reference["decisions"]):
        assert serving.journal_decisions(sd) == want
    assert cl.metrics.reconciles(cl.pending_by_shard)


# ---------------------------------------------------------------------------
# Frame transport: every corruption shape is a TYPED error, never a
# silently trusted payload (satellite: fuzz tests)
# ---------------------------------------------------------------------------


class _Pipe:
    """One os.pipe with a FrameReader on the read end."""

    def __init__(self):
        self.r, self.w = os.pipe()
        self.reader = FrameReader(self.r)

    def close_w(self):
        os.close(self.w)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for fd in (self.r, self.w):
            try:
                os.close(fd)
            except OSError:
                pass


class TestTransport:
    def test_round_trip(self):
        with _Pipe() as p:
            payloads = [{"kind": "req", "id": 1, "op": "poll"},
                        {"v": [1.5, float("inf")], "nan": float("nan")},
                        {"empty": {}, "unicode": "ß∂é", "n": None}]
            for pl in payloads:
                write_frame(p.w, pl)
            got = [p.reader.read_frame(timeout_s=1.0) for _ in payloads]
            assert got[0] == payloads[0]
            assert got[1]["v"] == [1.5, float("inf")]
            assert np.isnan(got[1]["nan"])
            assert got[2] == payloads[2]

    def test_timeout_with_no_frame(self):
        with _Pipe() as p:
            with pytest.raises(TransportTimeout):
                p.reader.read_frame(timeout_s=0.05)

    def test_timeout_with_partial_frame_then_completion(self):
        with _Pipe() as p:
            data = encode_frame({"x": 1})
            os.write(p.w, data[:7])
            with pytest.raises(TransportTimeout):
                p.reader.read_frame(timeout_s=0.05)
            os.write(p.w, data[7:])
            assert p.reader.read_frame(timeout_s=1.0) == {"x": 1}

    def test_clean_eof(self):
        with _Pipe() as p:
            p.close_w()
            with pytest.raises(TransportEOF) as ei:
                p.reader.read_frame(timeout_s=1.0)
            assert ei.value.partial_bytes == 0

    def test_torn_frame_eof_reports_partial_bytes(self):
        with _Pipe() as p:
            data = encode_frame({"big": "x" * 100})
            os.write(p.w, data[: len(data) // 2])
            p.close_w()
            with pytest.raises(TransportEOF) as ei:
                p.reader.read_frame(timeout_s=1.0)
            assert ei.value.partial_bytes == len(data) // 2

    def test_bad_magic_is_frame_error(self):
        with _Pipe() as p:
            data = bytearray(encode_frame({"x": 1}))
            data[:4] = b"EVIL"
            os.write(p.w, bytes(data))
            with pytest.raises(FrameError, match="magic"):
                p.reader.read_frame(timeout_s=1.0)

    def test_bit_flip_in_payload_is_checksum_error(self):
        with _Pipe() as p:
            data = bytearray(encode_frame({"x": 1, "y": "payload"}))
            data[transport.HEADER_BYTES + 5] ^= 0x40
            os.write(p.w, bytes(data))
            with pytest.raises(FrameError, match="checksum"):
                p.reader.read_frame(timeout_s=1.0)

    def test_oversized_declared_length_refused_before_payload(self):
        with _Pipe() as p:
            hdr = struct.pack(">4sII", transport.MAGIC,
                              transport.MAX_FRAME_BYTES + 1, 0)
            os.write(p.w, hdr)  # no payload follows — must not matter
            with pytest.raises(FrameError, match="MAX_FRAME_BYTES"):
                p.reader.read_frame(timeout_s=1.0)

    def test_oversized_send_refused(self, monkeypatch):
        monkeypatch.setattr(transport, "MAX_FRAME_BYTES", 64)
        with pytest.raises(FrameError, match="refusing to send"):
            encode_frame({"x": "y" * 128})

    def test_valid_checksum_but_non_json_payload(self):
        with _Pipe() as p:
            body = b"\xff\xfenot json at all"
            os.write(p.w, struct.pack(">4sII", transport.MAGIC,
                                      len(body), zlib.crc32(body)) + body)
            with pytest.raises(FrameError, match="not valid JSON"):
                p.reader.read_frame(timeout_s=1.0)

    def test_non_object_payload_refused(self):
        with _Pipe() as p:
            body = b"[1,2,3]"
            os.write(p.w, struct.pack(">4sII", transport.MAGIC,
                                      len(body), zlib.crc32(body)) + body)
            with pytest.raises(FrameError, match="must be an object"):
                p.reader.read_frame(timeout_s=1.0)

    def test_random_garbage_fuzz_never_escapes_the_taxonomy(self):
        """Whatever bytes a broken worker emits, the reader answers with
        a typed transport error or a timeout — never a payload it did
        not verify, never an unrelated exception."""
        rng = np.random.RandomState(0)
        for trial in range(50):
            with _Pipe() as p:
                n = int(rng.randint(1, 200))
                os.write(p.w, rng.bytes(n))
                p.close_w()
                with pytest.raises((FrameError, TransportEOF,
                                    TransportTimeout)):
                    while True:  # drain until the stream classifies
                        p.reader.read_frame(timeout_s=0.2)

    def test_zero_timeout_drains_already_delivered_frames(self):
        """``timeout_s=0`` is the heartbeat-drain contract: frames the
        peer already wrote MUST come back without waiting (a reader
        that refuses to poll the fd would make drain_beats a no-op and
        let a healthy worker's beat_age grow to quarantine)."""
        with _Pipe() as p:
            for i in range(3):
                write_frame(p.w, {"kind": "beat", "i": i})
            got = [p.reader.read_frame(timeout_s=0) for _ in range(3)]
            assert [f["i"] for f in got] == [0, 1, 2]
            with pytest.raises(TransportTimeout):
                p.reader.read_frame(timeout_s=0)

    def test_interleaved_beats_and_short_writes(self):
        """A frame split across arbitrary write boundaries reassembles
        exactly (the reader buffers across fills)."""
        with _Pipe() as p:
            data = b"".join(encode_frame({"kind": "beat", "i": i})
                            for i in range(5))
            for i in range(0, len(data), 11):
                os.write(p.w, data[i:i + 11])
            got = [p.reader.read_frame(timeout_s=1.0) for _ in range(5)]
            assert [f["i"] for f in got] == list(range(5))


# ---------------------------------------------------------------------------
# Fault-spec parsing + placement validation
# ---------------------------------------------------------------------------


class TestWorkerFaultSpecs:
    def test_parse_every_mode(self):
        for mode in faultinject.WORKER_MODES:
            spec = faultinject.parse_fault(f"worker:{mode}@shard2,batch7")
            assert spec.kind == "worker"
            f = faultinject.parse_worker(spec.arg)
            assert f == faultinject.WorkerFault(mode, 2, 7)
        f = faultinject.parse_worker("kill@shard1")
        assert f == faultinject.WorkerFault("kill", 1, None)

    @pytest.mark.parametrize("bad", [
        None, "kill", "segv@shard1", "kill@lane3", "kill@shardX",
        "kill@shard-1", "kill@shard1,lane2", "kill@shard1,batchX",
    ])
    def test_malformed_specs_raise(self, bad):
        with pytest.raises(ValueError):
            faultinject.parse_worker(bad)

    def test_env_accessor_fires_only_for_worker_kind(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "worker:hang@shard0")
        assert faultinject.worker_fault() == \
            faultinject.WorkerFault("hang", 0, None)
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:crash@shard0")
        assert faultinject.worker_fault() is None
        monkeypatch.delenv(faultinject.ENV_FAULT)
        assert faultinject.worker_fault() is None

    def test_maybe_inject_validates_worker_specs_fast(self, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "worker:bogus@shard1")
        with pytest.raises(ValueError, match="bogus"):
            faultinject.maybe_inject()
        monkeypatch.setenv(faultinject.ENV_FAULT, "worker:kill@shard1")
        faultinject.maybe_inject()  # valid data-plane spec: no-op here

    def test_worker_fault_refused_under_in_process_placement(
            self, monkeypatch):
        """A worker:* spec can never fire without worker placement — a
        vacuously green chaos run must refuse at construction."""
        monkeypatch.setenv(faultinject.ENV_FAULT, "worker:kill@shard1")
        with pytest.raises(ValueError, match="could never fire"):
            serving.ServingCluster(**PARAMS, device="cpu")

    def test_shard_fault_refused_under_worker_placement(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "shard:crash@shard1")
        with pytest.raises(ValueError, match="worker:"):
            _worker_cluster(tmp_path / "srv")

    def test_out_of_range_worker_shard_refused(self, tmp_path,
                                               monkeypatch):
        monkeypatch.setenv(faultinject.ENV_FAULT, "worker:kill@shard4")
        with pytest.raises(ValueError, match="could never fire"):
            _worker_cluster(tmp_path / "srv")

    def test_workers_placement_needs_a_directory(self):
        with pytest.raises(ValueError, match="directory"):
            serving.ServingCluster(placement="workers", **PARAMS, device="cpu")

    def test_unknown_placement_refused(self):
        with pytest.raises(ValueError, match="placement"):
            serving.ServingCluster(placement="threads", **PARAMS, device="cpu")


# ---------------------------------------------------------------------------
# Journal group commit (satellite: fsync_every_n)
# ---------------------------------------------------------------------------


class TestGroupCommit:
    def _counting_fsync(self, monkeypatch):
        calls = {"n": 0}
        real = os.fsync

        def counted(fd):
            calls["n"] += 1
            return real(fd)

        monkeypatch.setattr(os, "fsync", counted)
        return calls

    def test_default_is_fsync_per_append(self, tmp_path, monkeypatch):
        calls = self._counting_fsync(monkeypatch)
        j = Journal(str(tmp_path / "j.jsonl"))
        for i in range(5):
            j.append({"seq": i})
        assert calls["n"] == 5
        j.close()

    def test_group_commit_fsyncs_every_nth(self, tmp_path, monkeypatch):
        calls = self._counting_fsync(monkeypatch)
        j = Journal(str(tmp_path / "j.jsonl"), fsync_every_n=3)
        for i in range(7):
            j.append({"seq": i})
        assert calls["n"] == 2  # after appends 3 and 6
        j.sync()
        assert calls["n"] == 3  # the 7th forced out
        j.sync()
        assert calls["n"] == 3  # idempotent with nothing unsynced
        j.append({"seq": 7})
        j.close()
        assert calls["n"] == 4  # close() forces the tail

    def test_invalid_n_refused(self, tmp_path):
        with pytest.raises(ValueError, match="fsync_every_n"):
            Journal(str(tmp_path / "j.jsonl"), fsync_every_n=0)
        with pytest.raises(ValueError, match="fsync_every_n"):
            serving.ServingRuntime(n_feeds=4, fsync_every_n=-1, device="cpu")
        with pytest.raises(ValueError, match="fsync_every_n"):
            serving.ServingCluster(fsync_every_n=0, **PARAMS, device="cpu")

    def test_recovery_semantics_unchanged(self, tmp_path):
        """Group commit changes WHEN records hit media, never what they
        say: a cleanly closed group-committed runtime recovers
        bit-identically, and recover() reuses the stored knob."""
        d = str(tmp_path / "srv")
        batches = _batches(6)
        rt = serving.ServingRuntime(n_feeds=PARAMS["n_feeds"], dir=d,
                                    snapshot_every=100, fsync_every_n=4,
device="cpu")
        with rt:
            for b in batches:
                rt.submit(b)
                rt.poll()
            digest = rt.state_digest()
            decisions = serving.journal_decisions(d)
        rt2, info = serving.recover(d, device="cpu")
        with rt2:
            assert rt2.fsync_every_n == 4
            assert rt2.state_digest() == digest
            assert serving.journal_decisions(d) == decisions
            assert info.torn is None


# ---------------------------------------------------------------------------
# The worker child stays importable without torch (proven in a real
# subprocess)
# ---------------------------------------------------------------------------


def test_spawn_wires_the_short_read_deadline(tmp_path):
    """The cheap read ops (decide/status — the cluster's never-blocks
    read path) run on ``read_timeout_s``, and ``spawn`` forwards it to
    the handle; a wedged worker must cost a read seconds, not the full
    apply budget."""
    h = worker_mod.WorkerHandle.spawn(str(tmp_path), 0,
                                      read_timeout_s=3.25, device="cpu")
    try:
        assert h.read_timeout_s == 3.25
        assert set(h.READ_OPS) == {"decide", "status"}
    finally:
        h.kill()


def test_worker_child_imports_stay_torch_free():
    code = (
        "import sys\n"
        "import redqueen_tpu_torch.serving.worker\n"
        "import redqueen_tpu_torch.serving.transport\n"
        "assert 'torch' not in sys.modules, 'torch leaked into the child'\n"
        "assert 'jax' not in sys.modules, 'jax leaked into the child'\n"
        # the lazy (PEP 562) surface still resolves everything
        "import redqueen_tpu_torch\n"
        "assert redqueen_tpu_torch.serving.ServingRuntime is not None\n"
        "assert redqueen_tpu_torch.GraphBuilder is not None\n"
        "assert 'torch' in sys.modules  # ...by PAYING only when touched\n"
        "assert 'jax' not in sys.modules\n"
        "print('TORCHFREE-OK')\n")
    env = dict(os.environ, RQ_SERVING_WORKER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "TORCHFREE-OK" in out.stdout


# ---------------------------------------------------------------------------
# THE process-level chaos acceptance scenario: SIGKILL a REAL worker
# process mid-stream
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_sigkill_one_worker_mid_stream_isolates_and_recovers(
        tmp_path, monkeypatch, reference):
    """kill 1 of 4 real worker processes at sub-batch 5: survivors keep
    serving without stall or shed, the supervised restart recovers the
    dead shard bit-identically from its own journal, accounting
    reconciles through the outage."""
    monkeypatch.setenv(faultinject.ENV_FAULT, "worker:kill@shard1,batch5")
    batches = _batches()
    cl = _worker_cluster(tmp_path / "srv")
    with cl:
        pids = {k: cl._slots[k].runtime.proc.pid for k in range(4)}
        for b in batches:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches)
        # the worker REALLY died (SIGKILL leaves rc=-9) and the slot
        # runs a REPLACEMENT process now
        s1 = cl.metrics.shards[1]
        assert s1.crashes >= 1 and s1.recoveries >= 1
        assert cl._slots[1].runtime.proc.pid != pids[1]
        # (a) survivors never stalled or shed: every global batch
        # applied exactly once on their first delivery
        for k in (0, 2, 3):
            s = cl.metrics.shards[k]
            assert s.applied == N_BATCHES
            assert s.shed_queue == s.shed_unavailable == 0
            assert s.lost_on_crash == s.rejected == s.timeouts == 0
            assert cl._slots[k].runtime.proc.pid == pids[k]
        # (b) bit-identical to the uninterrupted IN-PROCESS run — one
        # assertion proving both recovery and placement equivalence
        _assert_matches_reference(cl, reference)
        # (c) health converged back through probation
        assert cl.health_by_shard[1] in (cluster_mod.DEGRADED,
                                         cluster_mod.HEALTHY)


@pytest.mark.slow
@pytest.mark.parametrize("fault", [
    "worker:eof@shard2,batch3",
    "worker:garbage@shard0,batch2",
])
def test_torn_frame_and_garbage_degrade_one_shard_only(
        tmp_path, monkeypatch, reference, fault):
    """A worker that tears its response frame mid-write (eof) or emits
    non-protocol bytes (garbage) is a TYPED transport failure: the
    router tears exactly that shard down and restarts it; the other
    shards and the router itself never notice."""
    monkeypatch.setenv(faultinject.ENV_FAULT, fault)
    batches = _batches()
    cl = _worker_cluster(tmp_path / "srv")
    with cl:
        for b in batches:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches)
        pf = faultinject.parse_worker(fault.split(":", 1)[1])
        s = cl.metrics.shards[pf.shard]
        assert s.crashes >= 1 and s.recoveries >= 1
        if pf.mode == "garbage":
            assert "FrameError" in s.last_crash_reason
        else:
            assert "TransportEOF" in s.last_crash_reason
        for k in range(4):
            if k != pf.shard:
                assert cl.metrics.shards[k].crashes == 0
        _assert_matches_reference(cl, reference)


@pytest.mark.slow
def test_hung_worker_degrades_backs_off_and_heals(tmp_path, monkeypatch,
                                                  reference):
    """The wedged-worker shape: the child drops HANG_FIRES poll requests
    (deadline expiry at the router), the shard degrades and backs off,
    then the stream reconverges and the shard heals — the worker process
    is never killed (fires < QUARANTINE_AFTER)."""
    monkeypatch.setenv(faultinject.ENV_FAULT, "worker:hang@shard3,batch4")
    batches = _batches()
    cl = _worker_cluster(tmp_path / "srv")
    with cl:
        pid3 = cl._slots[3].runtime.proc.pid
        # warm every worker past its first-apply cost BEFORE arming the
        # short deadline that makes the injected drops cheap to detect
        for b in batches[:3]:
            cl.submit(b)
            cl.poll()
        for slot in cl._slots:
            slot.runtime.request_timeout_s = 2.0
        for b in batches[3:]:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches)
        s = cl.metrics.shards[3]
        # >= not ==: an IO-wave-stalled status read past the (short)
        # read deadline also counts a timeout — it degrades, never
        # crashes, so the heal assertions below still bite.
        assert s.timeouts >= worker_mod.HANG_FIRES
        assert s.backoff_rounds > 0
        assert s.crashes == 0 and s.recoveries == 0
        assert cl._slots[3].runtime.proc.pid == pid3  # same process
        assert cl.health_by_shard[3] == cluster_mod.HEALTHY
        _assert_matches_reference(cl, reference)


@pytest.mark.slow
def test_wedged_past_quarantine_is_killed_and_restarted(
        tmp_path, monkeypatch, reference):
    """QUARANTINE_AFTER consecutive deadline expiries presume the worker
    dead: the router SIGKILLs the (still running, still wedged) process
    and quarantines the shard; a replacement worker then recovers it
    from its journal.  ``auto_recover`` is off and the fault env is
    cleared before the restart — a replacement spawned with the hang
    spec still armed would wedge on the same un-applied batch forever
    (the spec addresses a seq, and that seq never journaled), which is
    exactly the crash-loop the RetryPolicy give-up exists for, not what
    this test measures."""
    monkeypatch.setenv(faultinject.ENV_FAULT, "worker:hang@shard2,batch4")
    monkeypatch.setenv(worker_mod.ENV_HANG_FIRES, "99")  # never yields
    batches = _batches()
    cl = _worker_cluster(tmp_path / "srv", auto_recover=False)
    with cl:
        proc2 = cl._slots[2].runtime.proc
        for b in batches[:3]:
            cl.submit(b)
            cl.poll()
        for slot in cl._slots:
            slot.runtime.request_timeout_s = 1.0
        for b in batches[3:]:
            cl.submit(b)
            cl.poll()
        for _ in range(12):  # poll rounds burn the backoff to quarantine
            if cl.health_by_shard[2] == cluster_mod.QUARANTINED:
                break
            cl.poll()
        s = cl.metrics.shards[2]
        assert cl.health_by_shard[2] == cluster_mod.QUARANTINED
        assert s.timeouts >= cluster_mod.QUARANTINE_AFTER
        assert s.crashes >= 1
        assert "quarantined after" in str(s.last_crash_reason)
        proc2.wait(timeout=10)
        assert proc2.returncode == -signal.SIGKILL  # REALLY killed
        # survivors were never touched
        for k in (0, 1, 3):
            assert cl.metrics.shards[k].crashes == 0
        # operator restart with the wedge cause fixed (env cleared)
        monkeypatch.delenv(faultinject.ENV_FAULT)
        monkeypatch.delenv(worker_mod.ENV_HANG_FIRES)
        cl.recover_shard(2)
        assert s.recoveries == 1
        assert cl._slots[2].runtime.proc.pid != proc2.pid
        _drain(cl, batches)
        _assert_matches_reference(cl, reference)


@pytest.mark.slow
def test_worker_recover_classmethod_round_trip(tmp_path, reference):
    """ServingCluster.recover(placement='workers',
                              device="cpu") rebuilds a directory
    written by EITHER placement, in parallel worker processes, and the
    running worker cluster survives close() → recover() cycles."""
    batches = _batches()
    d = tmp_path / "srv"
    cl = _worker_cluster(d)
    with cl:
        for b in batches[:6]:
            cl.submit(b)
            cl.poll()
        _drain(cl, batches[:6])
    cl2, infos = serving.ServingCluster.recover(
        str(d), placement="workers", restart_policy=FAST_RESTART, device="cpu")
    with cl2:
        assert len(infos) == 4
        assert all(i.recovered_seq == 5 for i in infos)
        for b in batches[6:]:
            cl2.submit(b)
            cl2.poll()
        _drain(cl2, batches)
        _assert_matches_reference(cl2, reference)


# ---------------------------------------------------------------------------
# The stream CLI drives worker placement end to end (satellite:
# --workers toggle) — a separate process tree, like an operator would
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("fault", [None, "worker:kill@shard0,batch3"])
def test_stream_cli_worker_mode_survives_kill(tmp_path, fault):
    d = str(tmp_path / "srv")
    env = dict(os.environ)
    env.pop(faultinject.ENV_FAULT, None)
    if fault:
        env[faultinject.ENV_FAULT] = fault
    out = subprocess.run(
        [sys.executable, "-m", "redqueen_tpu_torch.serving.stream",
         "--dir", d, "--shards", "2", "--workers", "--feeds", "8",
         "--batches", "6", "--events-per-batch", "4",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=570)
    assert out.returncode == 0, out.stderr[-2000:]
    from redqueen_tpu_torch.runtime import integrity

    final = integrity.read_json(os.path.join(d, "final.json"),
                                schema="rq.serving.cluster.final/1")
    assert final["applied_seq"] == 5
    assert final["metrics"]["reconciles"]
    if fault:
        assert final["metrics"]["crashes"] >= 1


def test_stream_cli_workers_needs_shards():
    out = subprocess.run(
        [sys.executable, "-m", "redqueen_tpu_torch.serving.stream",
         "--dir", "/tmp/unused", "--workers"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--shards" in out.stderr


# ---------------------------------------------------------------------------
# The port's placements against the JAX package, and the device contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["workers", "sockets"])
def test_worker_placements_match_in_process_and_the_reference(
        tmp_path, placement):
    """Worker processes (``--device cpu``) serve the stream to the
    in-process placement's shard, cluster and edge digests, which are
    the JAX package's; every child reports the device it serves on."""
    from redqueen_tpu import serving as jserving

    batches = _batches()
    with jserving.ServingCluster(dir=str(tmp_path / "jax"),
                                 **PARAMS) as cj:
        _drain(cj, batches)
        want = (cj.shard_digests(), cj.edge_digest())
    with serving.ServingCluster(dir=str(tmp_path / "in"), **PARAMS,
                                device="cpu") as ci:
        _drain(ci, batches)
        assert (ci.shard_digests(), ci.edge_digest()) == want
    with _worker_cluster(tmp_path / "w", placement=placement) as cw:
        assert [s.runtime.device for s in cw._slots] == ["cpu"] * 4
        assert len({s.runtime.proc.pid for s in cw._slots}) == 4
        _drain(cw, batches)
        assert (cw.shard_digests(), cw.edge_digest()) == want


def test_worker_without_a_card_fails_its_open_and_says_why(tmp_path):
    """A worker child started without ``--device cpu`` resolves the
    card when it opens its shard; with none it answers the open with
    the reason (the router sees ``WorkerOpError``) and never serves on
    the CPU.  The same open with ``device="cpu"`` serves."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the child's open succeeds")
    cfg = {"n_feeds": 4, "q": 1.0, "s_sink": [1.0] * 4, "seed": 0,
           "start_seq": 0, "snapshot_every": 8, "reorder_window": 8,
           "queue_capacity": 64, "max_batch_events": 256}
    h = worker_mod.WorkerHandle.spawn(str(tmp_path / "a"), 0)
    try:
        assert h.proc.args[-2:] == ["--device", "cuda"]
        with pytest.raises(worker_mod.WorkerOpError,
                           match="CUDA is not available"):
            h.finish_open(h.start_open(cfg))
        assert h.device is None
        assert not os.path.exists(str(tmp_path / "a" / "config.json"))
    finally:
        h.kill()
    h = worker_mod.WorkerHandle.spawn(str(tmp_path / "b"), 0, device="cpu")
    try:
        assert h.finish_open(h.start_open(cfg)) == -1
        assert h.device == "cpu"
    finally:
        h.kill()


@pytest.mark.parametrize("module", ["redqueen_tpu_torch.serving.worker",
                                    "redqueen_tpu_torch.serving.replication"])
def test_child_entry_points_import_neither_torch_nor_jax(module):
    """Under ``RQ_SERVING_WORKER=1`` (set by the worker spawn and by the
    replication follower's) the children's modules load without torch:
    the package, ``serving`` and ``runtime`` inits skip their eager
    re-exports."""
    code = (f"import sys, {module}\n"
            "bad = [m for m in ('torch', 'jax', 'redqueen_tpu') "
            "if m in sys.modules]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, RQ_SERVING_WORKER="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_remote_command_names_the_device():
    cmd = worker_mod.SocketWorkerHandle.remote_command(
        "/d/shard-0000", 0, "127.0.0.1:1", device="cpu")
    assert cmd["argv"][-2:] == ["--device", "cpu"]
    assert "redqueen_tpu_torch.serving.worker" in cmd["argv"]
