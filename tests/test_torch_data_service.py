"""The port's distributed data service (``mxnet_tpu_torch.io.data_service``)
against the JAX package's on the CPU: every case of the reference's
``tests/test_data_service.py`` (the shared fault registry's feed domain,
the global shuffle, worker and client, ``DataFeed.seek``'s epoch
rollover), and

- a worker's shard — over HTTP, from a threaded worker and from a
  ``python -m mxnet_tpu_torch.io.data_service --worker`` process — is
  bit for bit the reference's ``make_source(spec).read_shard`` for the
  same spec, seed and cursor (synthetic and ``rec:`` sources);
- ``next_raw(out=)`` (``DataFeed``'s contract) leaves the data in the
  given buffer, read straight into it when ``prefetch=0``;
- ``DataFeed`` over a ``FeedClient``, ``seek``ed, resumes the stream a
  run that never stopped gives; ``checkpoint.save_trainer(feed=)``
  records the client's position."""
import io as _io
import os
import subprocess
import sys
import time

import numpy as onp
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.io import data_service as jds  # noqa: E402
from mxnet_tpu_torch import faults  # noqa: E402
from mxnet_tpu_torch import telemetry  # noqa: E402
from mxnet_tpu_torch.io.data_service import (  # noqa: E402
    DecodeWorker, FeedClient, FeedServiceError, epoch_permutation,
    make_source)
from mxnet_tpu_torch.io.datafeed import DataFeed  # noqa: E402

torch.set_num_threads(1)

SPEC = "synthetic:4x3x8x8:10:64"    # 16 shards/epoch
SEED = 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------ shared faults --
class TestSharedFaults:
    def test_registry_has_all_three_domains(self):
        import mxnet_tpu_torch.checkpoint  # noqa: F401 — ckpt knob
        import mxnet_tpu_torch.serve.faults  # noqa: F401
        doms = faults.domains()
        assert set(doms) >= {"MXNET_CKPT_FAULT", "MXNET_SERVE_FAULT",
                             "MXNET_FEED_FAULT"}
        assert doms["MXNET_FEED_FAULT"].sites == ("worker", "client")
        assert doms["MXNET_SERVE_FAULT"].sites == ("server", "batcher")

    def test_parse_grammar(self):
        dom = faults.domains()["MXNET_FEED_FAULT"]
        assert dom.parse("error") == ("worker", "error", 1.0, 0.0)
        assert dom.parse("client:delay:0.5:40") == \
            ("client", "delay", 0.5, 0.04)
        assert dom.parse("black_hole")[3] == 30.0
        assert dom.parse("delay")[3] == 0.1

    @pytest.mark.parametrize("raw", ["nope", "worker:nope", "error:2.0",
                                     "delay:0.5:10:extra"])
    def test_malformed_specs_raise(self, raw):
        dom = faults.domains()["MXNET_FEED_FAULT"]
        with pytest.raises(ValueError):
            dom.parse(raw)

    def test_serve_shim_api_intact(self):
        from mxnet_tpu_torch.serve import faults as serve_faults
        assert serve_faults.FAULT_ENV == "MXNET_SERVE_FAULT"
        assert serve_faults.parse("batcher:delay:1.0:25") == \
            ("batcher", "delay", 1.0, 0.025)
        assert callable(serve_faults.apply_delay)

    def test_maybe_counts_firing(self, monkeypatch):
        prev = telemetry.set_enabled(True)
        try:
            dom = faults.domains()["MXNET_FEED_FAULT"]
            monkeypatch.setenv("MXNET_FEED_FAULT", "client:error")
            assert dom.maybe("worker") is None
            before = telemetry.raw_snapshot()["counters"].get(
                "feed_service.fault.client.error", 0)
            assert dom.maybe("client") == ("error", 0.0)
            after = telemetry.raw_snapshot()["counters"].get(
                "feed_service.fault.client.error", 0)
            assert after == before + 1
        finally:
            telemetry.set_enabled(prev)


# ------------------------------------------------------ shuffle/source --
class TestGlobalShuffle:
    def test_permutation_properties(self):
        p0 = epoch_permutation(SEED, 0, 64)
        assert sorted(p0.tolist()) == list(range(64))
        assert not onp.array_equal(p0, epoch_permutation(SEED, 1, 64))
        assert onp.array_equal(p0, epoch_permutation(SEED, 0, 64))
        assert not onp.array_equal(p0, epoch_permutation(SEED + 1, 0, 64))
        for e in (0, 1, 7):
            assert onp.array_equal(epoch_permutation(SEED, e, 64),
                                   jds.epoch_permutation(SEED, e, 64))

    @pytest.mark.parametrize("epoch,shard", [(0, 0), (0, 15), (3, 7)])
    def test_source_is_the_reference_source(self, epoch, shard):
        da, la, pa = make_source(SPEC, seed=SEED).read_shard(epoch, shard)
        db, lb, pb = jds.make_source(SPEC, seed=SEED).read_shard(epoch,
                                                                 shard)
        assert da.tobytes() == db.tobytes()
        assert la.tobytes() == lb.tobytes()
        assert da.dtype == db.dtype and la.dtype == lb.dtype
        assert pa == pb == 0
        assert make_source(SPEC, seed=SEED).describe() == \
            jds.make_source(SPEC, seed=SEED).describe()

    def test_epoch_covers_every_record_once(self):
        src = make_source("synthetic:4x1x2x2:4:16", seed=1)
        seen = []
        for k in range(src.num_batches):
            _, lab, _ = src.read_shard(0, k)
            seen += lab.reshape(-1).tolist()
        assert sorted(seen) == sorted(float(r % 4) for r in range(16))

    def test_bad_specs_raise(self):
        with pytest.raises(ValueError):
            make_source("synthetic:4x3x8x8")
        with pytest.raises(ValueError):
            make_source("synthetic:8x3x8x8:10:4")
        with pytest.raises(ValueError):
            make_source("martian:whatever")

    def test_rec_source_is_the_reference_source(self, tmp_path):
        """A RecordIO pack of ``.npy`` payloads (one of them smaller than
        the target, one grey): the port's shards equal the reference's
        source's bit for bit."""
        from mxnet_tpu_torch import recordio
        rs = onp.random.RandomState(0)
        rec = recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                         str(tmp_path / "d.rec"), "w")
        for i in range(12):
            shape = [(10, 12, 3), (6, 5, 3), (9, 9)][i % 3]
            img = rs.randint(0, 256, shape).astype(onp.uint8)
            buf = _io.BytesIO()
            onp.save(buf, img)
            hdr = recordio.IRHeader(0, [float(i), float(i % 3)], i, 0)
            rec.write_idx(i, recordio.pack(hdr, buf.getvalue()))
        rec.close()
        spec = f"rec:{tmp_path / 'd.rec'}:4x3x8x8:2"
        port, ref = make_source(spec, seed=3), jds.make_source(spec, seed=3)
        assert port.num_batches == ref.num_batches == 3
        for epoch, shard in [(0, 0), (0, 2), (1, 1)]:
            a = port.read_shard(epoch, shard)
            b = ref.read_shard(epoch, shard)
            assert a[0].tobytes() == b[0].tobytes()
            assert a[1].tobytes() == b[1].tobytes()
        with pytest.raises(FileNotFoundError):
            make_source(f"rec:{tmp_path / 'none.rec'}:4x3x8x8")


# ----------------------------------------------------- worker + client --
class TestWorkerClient:
    def test_round_trip_and_epoch_stream(self):
        src = jds.make_source(SPEC, seed=SEED)
        with DecodeWorker(SPEC, seed=SEED) as w, \
                FeedClient(workers=[w.addr], spec=SPEC, seed=SEED,
                           prefetch=3, start_probing=False) as c:
            for k in range(4):
                d, lab, pad = c.next_raw()
                rd, rl, _ = src.read_shard(0, k)
                assert d.tobytes() == rd.tobytes()
                assert lab.tobytes() == rl.tobytes()
                assert pad == 0
            c.reset()
            d, _, _ = c.next_raw()
            assert d.tobytes() == src.read_shard(1, 0)[0].tobytes()
            assert c.stats()["remote_batches"] >= 5

    def test_stop_iteration_at_epoch_end(self):
        spec = "synthetic:4x1x2x2:4:8"
        with DecodeWorker(spec, seed=0) as w, \
                FeedClient(workers=[w.addr], spec=spec, seed=0,
                           prefetch=0, start_probing=False) as c:
            c.next_raw()
            c.next_raw()
            with pytest.raises(StopIteration):
                c.next_raw()

    def test_cursor_seek_rolls_epochs(self):
        with DecodeWorker(SPEC, seed=SEED) as w, \
                FeedClient(workers=[w.addr], spec=SPEC, seed=SEED,
                           prefetch=2, start_probing=False) as c:
            assert c.seek(16 + 3) == {"epoch": 1, "batch": 3}
            d, _, _ = c.next_raw()
            src = jds.make_source(SPEC, seed=SEED)
            assert d.tobytes() == src.read_shard(1, 3)[0].tobytes()
            assert c.seek(2, epoch=4) == {"epoch": 4, "batch": 2}
            with pytest.raises(ValueError):
                c.seek(-1)

    def test_seed_mismatch_is_hard_error(self):
        with DecodeWorker(SPEC, seed=SEED) as w:
            with pytest.raises(FeedServiceError):
                FeedClient(workers=[w.addr], seed=SEED + 1,
                           start_probing=False)

    def test_spec_discovery_from_worker(self):
        with DecodeWorker(SPEC, seed=SEED) as w, \
                FeedClient(workers=[w.addr], seed=SEED,
                           start_probing=False) as c:
            assert c.batch_size == 4
            assert c.num_batches == 16
            assert c.provide_data[0].shape == (4, 3, 8, 8)
            assert c.provide_label[0].shape == (4, 1)
            d, _, _ = c.next_raw()
            assert d.shape == (4, 3, 8, 8)

    def test_local_fallback_counted_and_bitwise(self):
        src = jds.make_source(SPEC, seed=SEED)
        with FeedClient(workers=["127.0.0.1:1"], spec=SPEC, seed=SEED,
                        prefetch=0, retries=2, backoff_ms=1,
                        timeout_ms=200, deadline_ms=600,
                        start_probing=False) as c:
            d, lab, _ = c.next_raw()
            assert d.tobytes() == src.read_shard(0, 0)[0].tobytes()
            st = c.stats()
            assert st["local_fallback_batches"] == 1
            assert st["fetch_failures"] >= 1

    def test_no_fallback_raises(self):
        with FeedClient(workers=["127.0.0.1:1"], spec=SPEC, seed=SEED,
                        prefetch=0, retries=1, backoff_ms=1,
                        timeout_ms=100, deadline_ms=300,
                        local_fallback=False,
                        start_probing=False) as c:
            with pytest.raises(FeedServiceError):
                c.next_raw()

    def test_injected_worker_error_retries_to_survivor(self, monkeypatch):
        src = jds.make_source(SPEC, seed=SEED)
        monkeypatch.setenv("MXNET_FEED_FAULT", "worker:error:0.5")
        with DecodeWorker(SPEC, seed=SEED) as wa, \
                DecodeWorker(SPEC, seed=SEED) as wb, \
                FeedClient(workers=[wa.addr, wb.addr], spec=SPEC,
                           seed=SEED, prefetch=0, retries=6,
                           backoff_ms=1, timeout_ms=500,
                           deadline_ms=5000, unhealthy_after=100,
                           start_probing=False) as c:
            for k in range(6):
                d, _, _ = c.next_raw()
                assert d.tobytes() == src.read_shard(0, k)[0].tobytes()

    def test_ejection_and_reinstatement(self):
        w = DecodeWorker(SPEC, seed=SEED)
        port = w.port
        w.stop()
        c = FeedClient(workers=[f"127.0.0.1:{port}"], spec=SPEC,
                       seed=SEED, prefetch=0, retries=1, backoff_ms=1,
                       timeout_ms=200, deadline_ms=400, probe_ms=30,
                       probe_timeout_ms=100, unhealthy_after=2,
                       healthy_after=1)
        try:
            deadline = time.time() + 10
            while time.time() < deadline and \
                    c.stats()["ejections"] < 1:
                time.sleep(0.02)
            assert c.stats()["ejections"] >= 1
            w2 = DecodeWorker(SPEC, port=port, seed=SEED).start()
            try:
                c.notify_respawn(0)
                deadline = time.time() + 10
                while time.time() < deadline and \
                        c.stats()["reinstatements"] < 1:
                    time.sleep(0.02)
                st = c.stats()
                assert st["reinstatements"] >= 1
                assert st["respawn_notices"] == 1
                c.next_raw()
                assert c.stats()["remote_batches"] >= 1
            finally:
                w2.stop()
        finally:
            c.close()

    def test_notify_dir_reports_respawns(self, tmp_path, monkeypatch):
        monkeypatch.setenv("MXNET_FEED_NOTIFY_DIR", str(tmp_path))
        (tmp_path / "worker0-attempt1").write_text("")
        (tmp_path / "other").write_text("")
        with DecodeWorker(SPEC, seed=SEED) as w, \
                FeedClient(workers=[w.addr], spec=SPEC, seed=SEED,
                           prefetch=0, probe_ms=20) as c:
            deadline = time.time() + 10
            while time.time() < deadline and \
                    c.stats()["respawn_notices"] < 1:
                time.sleep(0.02)
            time.sleep(0.1)
            assert c.stats()["respawn_notices"] == 1

    @pytest.mark.parametrize("prefetch", [0, 3])
    def test_next_raw_fills_the_given_buffer(self, prefetch):
        src = jds.make_source(SPEC, seed=SEED)
        buf = torch.zeros(4 * 3 * 8 * 8 + 64, dtype=torch.uint8)
        with DecodeWorker(SPEC, seed=SEED) as w, \
                FeedClient(workers=[w.addr], spec=SPEC, seed=SEED,
                           prefetch=prefetch, start_probing=False) as c:
            assert c.dtype == "uint8"
            d, lab, pad = c.next_raw(out=buf)
            assert d.ctypes.data == buf.data_ptr()
            assert d.tobytes() == src.read_shard(0, 0)[0].tobytes()
            assert lab.tobytes() == src.read_shard(0, 0)[1].tobytes()
            assert lab.flags.writeable and pad == 0
            assert buf[4 * 3 * 8 * 8:].sum() == 0

    def test_worker_process_serves_the_reference_shards(self, tmp_path):
        """``python -m mxnet_tpu_torch.io.data_service --worker``: the
        CLI's worker serves the reference source's bytes, and
        ``/metrics`` is Prometheus text."""
        import http.client
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=ROOT, MXNET_TELEMETRY="1")
        env.pop("MXNET_FEED_FAULT", None)
        proc = subprocess.Popen(
            [sys.executable, "-m", "mxnet_tpu_torch.io.data_service",
             "--worker", "--spec", SPEC, "--seed", str(SEED),
             "--port", str(port)], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            c = None
            while time.time() < deadline:
                try:
                    c = FeedClient(workers=[f"127.0.0.1:{port}"],
                                   seed=SEED, prefetch=0,
                                   deadline_ms=500,
                                   start_probing=False)
                    break
                except FeedServiceError:
                    assert proc.poll() is None, proc.stdout.read()
            assert c is not None
            src = jds.make_source(SPEC, seed=SEED)
            with c:
                c.seek(5, epoch=2)
                d, lab, _ = c.next_raw()
                assert d.tobytes() == src.read_shard(2, 5)[0].tobytes()
                assert lab.tobytes() == src.read_shard(2, 5)[1].tobytes()
                assert c.stats()["remote_batches"] == 1
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=10)
            conn.request("GET", "/metrics")
            text = conn.getresponse().read().decode()
            assert "mxtpu_feed_service_worker_batches 1" in text
        finally:
            proc.terminate()
            proc.wait(timeout=30)
        with pytest.raises(SystemExit):
            from mxnet_tpu_torch.io import data_service
            data_service._main(["--spec", SPEC])


# --------------------------------------------------- DataFeed interplay --
class TestDataFeedSeekRollover:
    def _feed(self, n=4):
        batches = [onp.full((2, 3), i, onp.float32) for i in range(n)]
        return DataFeed(batches, depth=0, device="cpu"), batches

    def test_seek_rolls_through_epoch_end(self):
        feed, batches = self._feed(4)
        pos = feed.seek(6)
        assert pos == {"epoch": 1, "batch": 2}, pos
        onp.testing.assert_array_equal(next(feed).numpy(), batches[2])

    def test_seek_absolute_epoch_target(self):
        feed, batches = self._feed(4)
        assert feed.seek(1, epoch=2) == {"epoch": 2, "batch": 1}
        onp.testing.assert_array_equal(next(feed).numpy(), batches[1])

    def test_seek_within_epoch_unchanged(self):
        feed, batches = self._feed(4)
        assert feed.seek(3)["batch"] == 3
        onp.testing.assert_array_equal(next(feed).numpy(), batches[3])

    def test_seek_empty_source_terminates(self):
        feed = DataFeed([], depth=0, device="cpu")
        pos = feed.seek(5)
        assert pos["batch"] == 0

    def test_service_cursor_fast_path(self):
        spec = "synthetic:4x1x2x3:4:16"
        src = jds.make_source(spec, seed=0)
        with DecodeWorker(spec, seed=0) as w:
            c = FeedClient(workers=[w.addr], spec=spec, seed=0,
                           prefetch=2, start_probing=False)
            feed = DataFeed(c, depth=2, device="cpu")
            try:
                pos = feed.seek(4 + 1)
                assert pos == {"epoch": 1, "batch": 1}
                b = next(feed)
                d = b.data[0].numpy()
                rd, rl, _ = src.read_shard(1, 1)
                onp.testing.assert_array_equal(d.astype(onp.uint8), rd)
                assert b.data[0].dtype == torch.float32
                onp.testing.assert_array_equal(b.label[0].numpy(), rl)
                assert feed.position() == {"epoch": 1, "batch": 2}
            finally:
                feed.close()
                c.close()

    @pytest.mark.parametrize("prefetch", [0, 2])
    def test_seek_resumes_the_stream(self, prefetch):
        """Two epochs and a half through ``DataFeed`` (NHWC on the CPU)
        in one run, against a second run ``seek``ed to the middle: the
        same batches from there on."""
        spec = "synthetic:2x3x4x4:5:10"              # 5 shards an epoch
        with DecodeWorker(spec, seed=1) as w:
            def run(start):
                c = FeedClient(workers=[w.addr], spec=spec, seed=1,
                               prefetch=prefetch, start_probing=False)
                feed = DataFeed(c, depth=2, device="cpu", layout="NHWC")
                out = []
                try:
                    if start:
                        feed.seek(start)
                    while len(out) < 12 - start:
                        try:
                            b = next(feed)
                        except StopIteration:
                            feed.reset()
                            continue
                        out.append((b.data[0].numpy().copy(),
                                    b.label[0].numpy().copy()))
                finally:
                    feed.close()
                    c.close()
                return out
            whole, resumed = run(0), run(7)
        assert len(resumed) == 5
        for (a, la), (b, lb) in zip(whole[7:], resumed):
            assert a.shape == (2, 4, 4, 3)
            assert onp.array_equal(a, b) and onp.array_equal(la, lb)

    def test_save_trainer_records_the_client_position(self, tmp_path):
        from mxnet_tpu_torch import checkpoint
        from mxnet_tpu_torch.gluon import Trainer, nn
        net = nn.Dense(3)
        net.initialize(ctx="cpu")
        net(torch.zeros(1, 4))
        tr = Trainer(net.collect_params(), "sgd", {"learning_rate": 0.1})
        with DecodeWorker(SPEC, seed=SEED) as w, \
                FeedClient(workers=[w.addr], spec=SPEC, seed=SEED,
                           prefetch=0, start_probing=False) as c:
            c.seek(3, epoch=2)
            mgr = checkpoint.CheckpointManager(str(tmp_path))
            try:
                mgr.save_trainer(tr, step=1, feed=c, blocking=True)
                _, meta, _ = mgr.restore()
            finally:
                mgr.close()
        assert meta["datafeed"] == {"epoch": 2, "batch": 3}
