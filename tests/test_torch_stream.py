"""Streaming ingestion in the port (``elasticdl_tpu_torch/data/stream.py``,
``master/stream_ingest.py``, the ``stream://`` reader route and the
master's and worker's ``--stream_dir``) on the CPU.

Both packages' ``StreamWriter`` write byte-equal frame files, and each
package's ``FileTailStream`` tails the other's (torn tails included).
The JAX ``tests/test_stream.py`` cases that need no SLO rule run against
the port. The same appended sequence through a JAX and a port ingestor
writes byte-equal journals with equal ``stream_progress`` and an equal
``render()`` (its two clock fields taken out); each package recovers
the other's streaming journal at its committed watermark; and a
streaming port master trains the mnist twin through a worker on the CPU
and fires the watermark eval, as ``TestStreamingMasterAssembly`` does.
"""

import os
import threading
import time

import numpy as np
import pytest

from elasticdl_tpu.data import stream as jstream
from elasticdl_tpu.master import evaluation_service as jes
from elasticdl_tpu.master import journal as jj
from elasticdl_tpu.master import servicer as jsv
from elasticdl_tpu.master import stream_ingest as jingest
from elasticdl_tpu.master import task_dispatcher as jtd
from elasticdl_tpu.observability import registry as jreg
from elasticdl_tpu_torch.common.constants import ReaderType, TaskType
from elasticdl_tpu_torch.common.task import Task
from elasticdl_tpu_torch.data import stream as pstream
from elasticdl_tpu_torch.master import evaluation_service as pes
from elasticdl_tpu_torch.master import journal as pj
from elasticdl_tpu_torch.master import servicer as psv
from elasticdl_tpu_torch.master import stream_ingest as pingest
from elasticdl_tpu_torch.master import task_dispatcher as ptd
from elasticdl_tpu_torch.master.journal import (
    JOURNAL_FILE,
    REPORT,
    SNAPSHOT,
    STREAM,
    MasterJournal,
    apply_stream_record,
    apply_stream_report_record,
    new_stream_state,
    normalize_stream_state,
    read_records,
    recover_master_state,
)
from elasticdl_tpu_torch.observability import registry as preg
from elasticdl_tpu_torch.tools.check_journal import check_journal

JAX = dict(stream=jstream, ingest=jingest, dispatcher=jtd, journal=jj,
           eval=jes, registry=jreg, servicer=jsv)
PORT = dict(stream=pstream, ingest=pingest, dispatcher=ptd, journal=pj,
            eval=pes, registry=preg, servicer=psv)
PKGS = {"jax": JAX, "port": PORT}

FileTailStream = pstream.FileTailStream
StreamDataReader = pstream.StreamDataReader
StreamTruncatedError = pstream.StreamTruncatedError
StreamWriter = pstream.StreamWriter
StreamIngestor = pingest.StreamIngestor
TaskDispatcher = ptd.TaskDispatcher
EvaluationService = pes.EvaluationService
MetricsRegistry = preg.MetricsRegistry

METRICS = {"mean_out": lambda labels, outputs: np.mean(outputs)}
# The render() fields read off the wall clock or the monotonic one.
CLOCK_FIELDS = ("watermark_lag_seconds", "backpressure_seconds")


def write_records(tmp_path, partition="clicks", n=10, start=0):
    writer = StreamWriter(str(tmp_path))
    for i in range(start, start + n):
        writer.append(partition, f"rec-{i}".encode())
    writer.close()


def stream_dispatcher(records_per_task=4, **kw):
    return TaskDispatcher(
        {}, records_per_task=records_per_task, shuffle=False,
        streaming=True, **kw
    )


def drain_one(dispatcher, success=True, err_reason=""):
    task = dispatcher.get(0)
    assert task is not None
    dispatcher.report(task.task_id, success, err_reason=err_reason)
    return task


def seeded_payloads(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.bytes(int(rng.randint(0, 300))) for _ in range(n)]


# ---- frame files: the JAX package's bytes ---------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_both_writers_write_byte_equal_frame_files(tmp_path, seed):
    payloads = seeded_payloads(40, seed)
    stamps = 1.7e9 + np.random.RandomState(seed + 9).rand(40) * 1e3
    files = {}
    for tag, pkg in PKGS.items():
        writer = pkg["stream"].StreamWriter(str(tmp_path / tag))
        for i, payload in enumerate(payloads):
            partition = ("clicks", "views")[i % 2]
            assert writer.append(partition, payload, ts=stamps[i],
                                 fsync=i % 7 == 0) == i // 2
        writer.close()
        files[tag] = {
            name: (tmp_path / tag / name).read_bytes()
            for name in sorted(os.listdir(tmp_path / tag))
        }
    assert sorted(files["port"]) == ["clicks.edlstream", "views.edlstream"]
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("writer_pkg,reader_pkg", [
    ("jax", "port"), ("port", "jax")])
def test_each_package_tails_the_others_stream(tmp_path, writer_pkg,
                                              reader_pkg):
    payloads = seeded_payloads(12, 3)
    writer = PKGS[writer_pkg]["stream"].StreamWriter(str(tmp_path))
    for payload in payloads[:8]:
        writer.append("clicks", payload, ts=1.0e9)
    source = PKGS[reader_pkg]["stream"].FileTailStream(
        str(tmp_path), replay_buffer_records=4)
    assert source.end_offset("clicks") == 8
    # Inside the replay buffer and behind it (a re-read of the file).
    assert source.read("clicks", 4, 8) == payloads[4:8]
    assert source.read("clicks", 0, 8) == payloads[:8]
    for payload in payloads[8:]:
        writer.append("clicks", payload, ts=2.0e9)
    writer.close()
    assert source.end_offset("clicks") == 12
    assert source.read("clicks", 6, 12) == payloads[6:12]
    assert source.append_time("clicks", 11) == 2.0e9
    # A torn tail: a crashed producer's half frame stays invisible to
    # both packages, and the next writer (of either package) overwrites
    # it so its frame starts on a valid boundary.
    path = tmp_path / "clicks.edlstream"
    with open(path, "ab") as fh:
        fh.write(b"\x50\x00\x00\x00\x01")
    for pkg in PKGS.values():
        fresh = pkg["stream"].FileTailStream(str(tmp_path))
        assert fresh.end_offset("clicks") == 12
        assert fresh.read("clicks", 10, 12) == payloads[10:12]
    again = PKGS[reader_pkg]["stream"].StreamWriter(str(tmp_path))
    assert again.append("clicks", b"after-crash", ts=3.0e9) == 12
    again.close()
    for pkg in PKGS.values():
        fresh = pkg["stream"].FileTailStream(str(tmp_path))
        assert fresh.read("clicks", 11, 13) == [payloads[11],
                                                b"after-crash"]


# ---- source (the JAX TestFileTailStream cases) ----------------------------


class TestFileTailStream:
    def test_append_read_roundtrip(self, tmp_path):
        write_records(tmp_path, n=5)
        source = FileTailStream(str(tmp_path))
        assert source.partitions() == ["clicks"]
        assert source.end_offset("clicks") == 5
        assert source.read("clicks", 1, 4) == [
            b"rec-1", b"rec-2", b"rec-3"
        ]

    def test_tail_sees_later_appends(self, tmp_path):
        write_records(tmp_path, n=3)
        source = FileTailStream(str(tmp_path))
        assert source.end_offset("clicks") == 3
        write_records(tmp_path, n=2, start=3)
        assert source.end_offset("clicks") == 5
        assert source.read("clicks", 3, 5) == [b"rec-3", b"rec-4"]

    def test_read_beyond_end_raises(self, tmp_path):
        write_records(tmp_path, n=3)
        source = FileTailStream(str(tmp_path))
        with pytest.raises(StreamTruncatedError):
            source.read("clicks", 2, 7)

    def test_torn_tail_frame_is_invisible(self, tmp_path):
        write_records(tmp_path, n=4)
        stream_file = next(
            str(p) for p in tmp_path.iterdir()
            if p.name.endswith(".edlstream")
        )
        with open(stream_file, "ab") as fh:
            fh.write(b"\x50\x00")
        source = FileTailStream(str(tmp_path))
        assert source.end_offset("clicks") == 4
        assert source.read("clicks", 0, 4)[-1] == b"rec-3"

    def test_append_time_monotone_and_known(self, tmp_path):
        write_records(tmp_path, n=3)
        source = FileTailStream(str(tmp_path))
        times = [source.append_time("clicks", i) for i in range(3)]
        assert all(t > 0 for t in times)
        assert times == sorted(times)

    def test_multiple_partitions_independent(self, tmp_path):
        write_records(tmp_path, "clicks", n=3)
        write_records(tmp_path, "views", n=5)
        source = FileTailStream(str(tmp_path))
        assert sorted(source.partitions()) == ["clicks", "views"]
        assert source.end_offset("clicks") == 3
        assert source.end_offset("views") == 5


class TestStreamDataReader:
    def test_stream_task_reads_offset_range(self, tmp_path):
        write_records(tmp_path, n=6)
        reader = StreamDataReader(stream_dir=str(tmp_path))
        task = Task(shard_name="clicks", start=2, end=5,
                    type=TaskType.TRAINING,
                    extended_config={"stream": True})
        assert list(reader.read_records(task)) == [
            b"rec-2", b"rec-3", b"rec-4"
        ]
        assert reader.create_shards() == {}
        assert reader.metadata.extra.get("stream") is True

    def test_non_stream_task_requires_fallback(self, tmp_path):
        write_records(tmp_path, n=2)
        reader = StreamDataReader(stream_dir=str(tmp_path))
        task = Task(shard_name="e1", start=0, end=2,
                    type=TaskType.EVALUATION)
        with pytest.raises(ValueError, match="fallback"):
            list(reader.read_records(task))

        class Fallback:
            def read_records(self, task):
                yield b"from-fallback"

        routed = StreamDataReader(
            stream_dir=str(tmp_path), fallback=Fallback()
        )
        assert list(routed.read_records(task)) == [b"from-fallback"]

    def test_factory_routes_stream_scheme(self, tmp_path):
        from elasticdl_tpu_torch.data.factory import create_data_reader

        write_records(tmp_path, n=1)
        reader = create_data_reader(
            data_origin=f"stream://{tmp_path}"
        )
        assert isinstance(reader, StreamDataReader)
        reader = create_data_reader(
            data_origin=str(tmp_path), reader_type=ReaderType.STREAM
        )
        assert isinstance(reader, StreamDataReader)


# ---- dispatcher streaming mode --------------------------------------------


class TestStreamingDispatcher:
    def test_create_stream_tasks_splits_and_clips(self):
        d = stream_dispatcher(records_per_task=4)
        assert d.create_stream_tasks("clicks", 0, 10) == 3
        ranges = [
            (t.shard_name, t.start, t.end)
            for t in (d.get(0), d.get(0), d.get(0))
        ]
        assert ranges == [("clicks", 0, 4), ("clicks", 4, 8),
                          ("clicks", 8, 10)]
        assert d.create_stream_tasks("clicks", 0, 10) == 0
        assert d.create_stream_tasks("clicks", 6, 12) == 1
        task = d.get(0)
        assert (task.start, task.end) == (10, 12)
        assert task.extended_config["stream"] is True

    def test_watermark_advances_only_contiguously(self):
        d = stream_dispatcher(records_per_task=4)
        d.create_stream_tasks("clicks", 0, 12)
        t0, t1, t2 = d.get(0), d.get(1), d.get(0)
        d.report(t2.task_id, True)
        progress = d.stream_progress()["clicks"]
        assert progress["committed"] == 0
        assert progress["pending"] == {8: 12}
        d.report(t1.task_id, True)
        assert d.stream_progress()["clicks"]["committed"] == 0
        d.report(t0.task_id, True)
        progress = d.stream_progress()["clicks"]
        assert progress["committed"] == 12
        assert progress["pending"] == {}

    def test_failed_task_does_not_advance_watermark(self):
        d = stream_dispatcher(records_per_task=4)
        d.create_stream_tasks("clicks", 0, 4)
        task = d.get(0)
        d.report(task.task_id, False, err_reason="worker_dead")
        assert d.stream_progress()["clicks"]["committed"] == 0
        retry = d.get(1)
        assert (retry.start, retry.end) == (0, 4)
        d.report(retry.task_id, True)
        assert d.stream_progress()["clicks"]["committed"] == 4

    def test_finished_requires_close_stream(self):
        d = stream_dispatcher(records_per_task=4)
        d.create_stream_tasks("clicks", 0, 4)
        drain_one(d)
        assert not d.finished()
        d.close_stream()
        assert d.finished()

    def test_export_restore_carries_stream_state(self):
        d = stream_dispatcher(records_per_task=4)
        d.create_stream_tasks("clicks", 0, 8)
        drain_one(d)
        state = d.export_state()
        d2 = TaskDispatcher({}, records_per_task=4, shuffle=False)
        d2.restore_state(state)
        assert d2.is_streaming
        progress = d2.stream_progress()["clicks"]
        assert progress["committed"] == 4
        assert progress["next"] == 8

    def test_preempt_leases_requeues_stream_tasks(self):
        d = stream_dispatcher(records_per_task=4)
        d.create_stream_tasks("clicks", 0, 8)
        d.get(0), d.get(1)
        assert d.preempt_leases() == 2
        assert d.stream_progress()["clicks"]["committed"] == 0
        todo, doing = d.queue_depths()
        assert (todo, doing) == (2, 0)
        for _ in range(2):
            drain_one(d)
        assert d.stream_progress()["clicks"]["committed"] == 8


def test_concurrent_refill_never_loses_or_doubles_offsets():
    """``preempt_leases`` + ``recover_tasks`` racing a live refill: every
    offset resolves exactly once and the watermark stays monotone."""
    d = stream_dispatcher(records_per_task=2)
    total = 400
    stop = threading.Event()
    watermarks = []

    def producer():
        cursor = 0
        while cursor < total and not stop.is_set():
            nxt = min(total, cursor + 6)
            d.create_stream_tasks("clicks", cursor, nxt)
            cursor = nxt

    def chaos():
        while not stop.is_set():
            d.preempt_leases()
            d.recover_tasks(1)
            watermarks.append(d.stream_progress()["clicks"]["committed"])

    def worker(worker_id):
        while not stop.is_set():
            task = d.get(worker_id)
            if task is None:
                if d.stream_progress()["clicks"]["committed"] == total:
                    return
                continue
            d.report(task.task_id, True)

    threads = [threading.Thread(target=producer),
               threading.Thread(target=chaos),
               threading.Thread(target=worker, args=(1,)),
               threading.Thread(target=worker, args=(2,))]
    for t in threads:
        t.start()
    try:
        for t in threads[2:]:
            t.join(timeout=60)
    finally:
        stop.set()
    for t in threads:
        t.join(timeout=10)
    progress = d.stream_progress()["clicks"]
    assert progress["committed"] == total
    assert progress["pending"] == {}
    assert all(b >= a for a, b in zip(watermarks, watermarks[1:]))


# ---- journal: exactly-once across failover --------------------------------


def journal_stream_fold(journal_dir):
    state = new_stream_state()
    for _off, _end, record in read_records(
        os.path.join(journal_dir, JOURNAL_FILE)
    ):
        if record["t"] == SNAPSHOT and record.get("stream") is not None:
            state = normalize_stream_state(record["stream"])
        elif record["t"] == STREAM:
            apply_stream_record(state, record)
        elif record["t"] == REPORT:
            apply_stream_report_record(state, record)
    return state


class TestJournaledStream:
    def test_recovery_resumes_from_committed_watermark(self, tmp_path):
        journal_dir = str(tmp_path / "journal")
        journal = MasterJournal(journal_dir)
        journal.open_generation()
        d = stream_dispatcher(records_per_task=4)
        d.attach_journal(journal)
        d.create_stream_tasks("clicks", 0, 12)
        done = drain_one(d)
        leased = d.get(1)
        journal.close()

        j2 = MasterJournal(journal_dir)
        d2 = stream_dispatcher(records_per_task=4)
        stats = recover_master_state(j2, d2)
        assert stats["generation"] >= 1
        progress = d2.stream_progress()["clicks"]
        assert progress["committed"] == done.end
        assert progress["next"] == 12
        assert leased.task_id in d2.doing_tasks_of(1)
        d2.recover_tasks(1)
        while not d2.stream_progress()["clicks"]["committed"] == 12:
            drain_one(d2)
        assert d2.create_stream_tasks("clicks", 0, 12) == 0
        fold = journal_stream_fold(journal_dir)["partitions"]["clicks"]
        assert fold["committed"] == d2.stream_progress()[
            "clicks"]["committed"]
        j2.close()

    def test_cold_fold_matches_live_after_snapshot(self, tmp_path):
        journal_dir = str(tmp_path / "journal")
        journal = MasterJournal(journal_dir, snapshot_every=5)
        journal.open_generation()
        d = stream_dispatcher(records_per_task=2)
        d.attach_journal(journal)
        d.create_stream_tasks("clicks", 0, 10)
        for _ in range(5):
            drain_one(d)
        d.create_stream_tasks("clicks", 10, 14)
        for _ in range(2):
            drain_one(d)
        journal.close()
        fold = journal_stream_fold(journal_dir)["partitions"]["clicks"]
        live = d.stream_progress()["clicks"]
        assert fold["committed"] == live["committed"] == 14
        assert fold["next"] == live["next"] == 14


# ---- ingestor -------------------------------------------------------------


class TestStreamIngestor:
    def test_pump_generates_and_backpressures(self, tmp_path):
        write_records(tmp_path, n=40)
        d = stream_dispatcher(records_per_task=2)
        ingestor = StreamIngestor(
            FileTailStream(str(tmp_path)), d, max_todo=4,
            metrics_registry=MetricsRegistry(),
        )
        ingestor.pump()
        todo, _doing = d.queue_depths()
        assert todo == 4
        summary = ingestor.pump()
        assert summary["backpressured"]
        for _ in range(4):
            drain_one(d)
        ingestor.pump()
        assert ingestor.backpressure_seconds > 0.0
        assert d.stream_progress()["clicks"]["next"] > 8

    def test_render_reports_watermarks_and_lag(self, tmp_path):
        write_records(tmp_path, n=6)
        d = stream_dispatcher(records_per_task=3)
        ingestor = StreamIngestor(
            FileTailStream(str(tmp_path)), d, max_todo=8,
            metrics_registry=MetricsRegistry(),
        )
        ingestor.pump()
        drain_one(d)
        body = ingestor.render()
        part = body["partitions"]["clicks"]
        assert part["end"] == 6
        assert part["committed"] == 3
        assert part["lag_records"] == 3
        assert part["watermark_lag_seconds"] >= 0.0
        assert body["max_todo"] == 8

    def test_watermark_eval_trigger(self, tmp_path):
        write_records(tmp_path, n=8)
        d = TaskDispatcher(
            {}, evaluation_shards={"e1": (0, 4)}, records_per_task=2,
            shuffle=False, streaming=True,
        )
        ev = EvaluationService(d, METRICS)
        ingestor = StreamIngestor(
            FileTailStream(str(tmp_path)), d, max_todo=16,
            eval_service=ev, eval_every_records=4,
            metrics_registry=MetricsRegistry(),
        )
        ingestor.pump()
        for _ in range(2):
            task = d.get(0)
            assert task.type == TaskType.TRAINING
            d.report(task.task_id, True)
        ingestor.pump()
        assert d.count_tasks(TaskType.EVALUATION) == 2
        assert ev.add_watermark_eval_if_needed(4) is False

    def test_eval_marker_seeds_from_recovered_watermark(self, tmp_path):
        write_records(tmp_path, n=8)
        d = TaskDispatcher(
            {}, evaluation_shards={"e1": (0, 4)}, records_per_task=2,
            shuffle=False, streaming=True,
        )
        d.create_stream_tasks("clicks", 0, 8)
        for _ in range(4):
            drain_one(d)
        ev = EvaluationService(d, METRICS)
        StreamIngestor(
            FileTailStream(str(tmp_path)), d, max_todo=16,
            eval_service=ev, eval_every_records=2,
            metrics_registry=MetricsRegistry(),
        )
        assert ev.add_watermark_eval_if_needed(8) is False

    def test_close_retires_the_stream(self, tmp_path):
        write_records(tmp_path, n=4)
        d = stream_dispatcher(records_per_task=2)
        ingestor = StreamIngestor(
            FileTailStream(str(tmp_path)), d, max_todo=8,
            metrics_registry=MetricsRegistry(),
        )
        ingestor.start(interval_secs=0.01)
        deadline = time.monotonic() + 10
        while d.stream_progress().get("clicks", {}).get("next") != 4:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        ingestor.close()
        assert not d.finished()
        drain_one(d), drain_one(d)
        assert d.finished()


# ---- the two packages' ingestors held to each other ------------------------


def ingest_run(pkg, stream_dir, journal_dir, snapshot_every):
    """The scripted ingestion through a journaled servicer: pumps against
    a growing stream with backpressure, out-of-order and failed reports,
    a preemption, a watermark eval round; returns the journal's bytes,
    the progress, the render without its clock fields, the tasks each
    pump generated and the eval results."""
    journal = pkg["journal"].MasterJournal(journal_dir,
                                           snapshot_every=snapshot_every)
    journal.open_generation()
    d = pkg["dispatcher"].TaskDispatcher(
        {}, evaluation_shards={"e1": (0, 4)}, records_per_task=3,
        shuffle=False, streaming=True)
    d.attach_journal(journal)
    ev = pkg["eval"].EvaluationService(d, METRICS)
    ev.attach_journal(journal)
    servicer = pkg["servicer"].MasterServicer(
        d, ev, journal=journal, generation=journal.generation)
    ingestor = pkg["ingest"].StreamIngestor(
        pkg["stream"].FileTailStream(stream_dir), d, max_todo=3,
        eval_service=ev, eval_every_records=9,
        metrics_registry=pkg["registry"].MetricsRegistry(),
        model_version_fn=lambda: 7)

    def lease(worker_id):
        return servicer.get_task({"worker_id": worker_id}).get("task")

    def report(task, err=""):
        servicer.report_task_result({"task_id": task["task_id"],
                                     "worker_id": 0, "err_reason": err})

    generated = [ingestor.pump()["generated"]]
    t0, t1 = lease(0), lease(1)
    report(t1)
    report(t0, "boom")
    generated.append(ingestor.pump()["generated"])
    lease(0)
    d.preempt_leases("preempted: gang released (s)")
    for _ in range(60):
        task = lease(0)
        if task is None or task["task_id"] < 0:
            generated.append(ingestor.pump()["generated"])
            if not generated[-1] and not d.queue_depths()[0]:
                break
            continue
        if task["type"] == TaskType.EVALUATION:
            servicer.report_evaluation_metrics({
                "worker_id": 0, "task_id": task["task_id"],
                "model_outputs": np.arange(
                    task["start"], task["end"], dtype=np.float32),
                "labels": np.zeros(task["end"] - task["start"],
                                   np.int32)})
        report(task)
    render = ingestor.render()
    for part in render["partitions"].values():
        part.pop(CLOCK_FIELDS[0])
    render.pop(CLOCK_FIELDS[1])
    progress = d.stream_progress()
    journal.close()
    with open(os.path.join(journal_dir, "journal.log"), "rb") as fh:
        return (fh.read(), progress, render, generated,
                {str(k): v for k, v in ev.completed_results.items()})


@pytest.mark.parametrize("snapshot_every", [1000, 4])
def test_both_ingestors_journal_byte_equal_records(tmp_path,
                                                   snapshot_every):
    stream_dir = str(tmp_path / "stream")
    writer = StreamWriter(stream_dir)
    for i, payload in enumerate(seeded_payloads(30, 5)):
        writer.append(("clicks", "views")[i % 3 == 0], payload,
                      ts=1.0e9 + i)
    writer.close()
    out = {tag: ingest_run(pkg, stream_dir, str(tmp_path / tag),
                           snapshot_every)
           for tag, pkg in PKGS.items()}
    jax_bytes, jax_progress, jax_render, jax_gen, jax_eval = out["jax"]
    port_bytes, progress, render, generated, results = out["port"]
    kinds = [r["t"] for _o, _e, r in read_records(
        str(tmp_path / "port" / "journal.log"))]
    if snapshot_every == 1000:
        for kind in ("stream", "report", "eval_round"):
            assert kind in kinds
    else:
        assert "snapshot" in kinds
    assert port_bytes == jax_bytes
    assert progress == jax_progress
    assert render == jax_render
    assert generated == jax_gen and generated[0] == 3
    assert results == jax_eval and results
    assert progress["clicks"]["committed"] == 20
    assert progress["views"]["committed"] == 10
    assert check_journal(str(tmp_path / "port")) == []


@pytest.mark.parametrize("writer_pkg,reader_pkg", [
    ("jax", "port"), ("port", "jax")])
def test_each_package_recovers_the_others_streaming_journal(
        tmp_path, writer_pkg, reader_pkg):
    """A streaming control plane of one package dies with a leased range
    and an out-of-order report pending; the other package's recovery
    resumes at the committed watermark, and its ingestor, seeded from
    it, never re-tasks an offset below the watermark."""
    stream_dir = str(tmp_path / "stream")
    write_records(tmp_path / "stream", n=20)
    w, r = PKGS[writer_pkg], PKGS[reader_pkg]
    journal_dir = str(tmp_path / "journal")
    journal = w["journal"].MasterJournal(journal_dir)
    journal.open_generation()
    d = w["dispatcher"].TaskDispatcher(
        {}, evaluation_shards={"e1": (0, 4)}, records_per_task=4,
        shuffle=False, streaming=True)
    d.attach_journal(journal)
    w["ingest"].StreamIngestor(
        w["stream"].FileTailStream(stream_dir), d, max_todo=8,
        metrics_registry=w["registry"].MetricsRegistry()).pump()
    t0, t1, t2 = d.get(0), d.get(1), d.get(0)
    d.report(t0.task_id, True)
    d.report(t2.task_id, True)   # parked: [4, 8) is still leased
    journal.close()

    journal = r["journal"].MasterJournal(journal_dir)
    d2 = r["dispatcher"].TaskDispatcher(
        {}, evaluation_shards={"e1": (0, 4)}, records_per_task=4,
        shuffle=False, streaming=True)
    stats = r["journal"].recover_master_state(journal, d2)
    assert stats["generation"] == 1
    progress = d2.stream_progress()["clicks"]
    assert progress["committed"] == 4 and progress["next"] == 20
    assert t1.task_id in d2.doing_tasks_of(1)
    ev = r["eval"].EvaluationService(d2, METRICS)
    ingestor = r["ingest"].StreamIngestor(
        r["stream"].FileTailStream(stream_dir), d2, max_todo=8,
        eval_service=ev, eval_every_records=4,
        metrics_registry=r["registry"].MetricsRegistry())
    # Seeded from the recovered watermark: 4 committed records fire
    # nothing, and the pump re-offers no range below ``next``.
    assert ingestor.pump()["generated"] == 0
    assert d2.count_tasks(TaskType.EVALUATION) == 0
    d2.recover_tasks(1)
    while True:
        task = d2.get(0)
        if task is None:
            break
        d2.report(task.task_id, True)
    assert d2.stream_progress()["clicks"]["committed"] == 20
    journal.close()
    assert check_journal(journal_dir) == []
    fold = journal_stream_fold(journal_dir)["partitions"]["clicks"]
    assert (fold["committed"], fold["next"]) == (20, 20)


# ---- the port's streaming master on the CPU -------------------------------


def seed_mnist_stream(stream_dir, n, partition="clicks"):
    from elasticdl_tpu_torch.common import tensor_utils

    writer = StreamWriter(str(stream_dir))
    rng = np.random.RandomState(11)
    for _ in range(n):
        label = int(rng.randint(10))
        image = rng.rand(784) * 32.0
        block = 784 // 10
        image[label * block:(label + 1) * block] += 192.0
        writer.append(partition, tensor_utils.dumps({
            "image": image.reshape(28, 28).astype(np.float32),
            "label": label,
        }))
    writer.close()


def test_stream_master_trains_and_fires_watermark_eval(tmp_path):
    """``--stream_dir`` with no ``--training_data`` is a TRAINING job: no
    phantom eval-only round at construction, the worker's fallback
    reader completes the watermark round with real metrics, and the job
    ends when its stream is closed."""
    from elasticdl_tpu_torch.common.args import (
        build_parser,
        parse_worker_args,
    )
    from elasticdl_tpu_torch.master.main import Master
    from elasticdl_tpu_torch.testing.data import (
        create_mnist_record_file,
        model_zoo_dir,
    )
    from elasticdl_tpu_torch.worker.main import build_worker

    model_def = "mnist.mnist_functional.custom_model"
    stream_dir = tmp_path / "stream"
    seed_mnist_stream(stream_dir, 32)
    eval_rec = create_mnist_record_file(str(tmp_path / "e.rec"), 32,
                                        seed=2)
    common = ["--model_zoo", model_zoo_dir(), "--model_def", model_def,
              "--stream_dir", str(stream_dir),
              "--validation_data", eval_rec, "--minibatch_size", "16",
              "--job_name", "stream-assembly"]
    master = Master(build_parser("master").parse_args(common + [
        "--stream_poll_secs", "0.05",
        "--stream_eval_every_records", "16",
        "--master_addr", "localhost:0", "--metrics_port", "0"]))
    assert master.evaluation_service._eval_job is None
    assert master.task_dispatcher.is_streaming
    master.prepare()
    try:
        worker = build_worker(parse_worker_args(common + [
            "--worker_id", "0", "--master_addr",
            f"localhost:{master.port}", "--device", "cpu"]))
        run_thread = threading.Thread(target=worker.run, daemon=True)
        run_thread.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            committed = master.task_dispatcher.stream_progress().get(
                "clicks", {}).get("committed", 0)
            if committed == 32 and (
                    master.evaluation_service.completed_results):
                break
            time.sleep(0.1)
        assert master.task_dispatcher.stream_progress()[
            "clicks"]["committed"] == 32
        results = master.evaluation_service.completed_results
        assert results
        for metrics in results.values():
            assert "accuracy" in metrics
        import json
        import urllib.request

        with urllib.request.urlopen(
                f"http://localhost:{master.metrics_plane.http_port}"
                "/stream") as resp:
            body = json.loads(resp.read())
        assert body["partitions"]["clicks"]["committed"] == 32
        assert body["eval_every_records"] == 16
        assert not master.task_dispatcher.finished()
        master.task_dispatcher.close_stream()
        run_thread.join(timeout=60)
        assert not run_thread.is_alive()
        assert master.task_dispatcher.finished()
    finally:
        master.stop()
