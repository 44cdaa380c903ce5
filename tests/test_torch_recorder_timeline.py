"""The port's recorder and trace timelines against the JAX package's
(``recorder.py``, ``telemetry/timeline.py``).

- ``Recorder``: rotation keeps the capped generations, replay yields
  the live file's events in order and skips torn lines, and both
  packages replay each other's files alike.
- ``DYN_TRACE_FILE``: a hub records to ``<path>.pid<pid>``, and
  ``load_spans(<path>)`` reads the rotated and per-process siblings
  (and skips unrelated ones), as JAX's does.
- ``KvRecorder``: a recording taken from the port's event plane replays
  into the port's and the JAX package's ``KvIndexer`` with equal
  overlap scores.
- ``render_timeline``, ``find_trace``, ``list_traces`` and
  ``transfer_hops`` give JAX's results on the checked-in fixture and on
  hypothesis-drawn multi-instance traces.
"""

import asyncio
import os

from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_exp_tpu import recorder as jrec
from dynamo_exp_tpu import telemetry as J
from dynamo_exp_tpu.kv_router.indexer import KvIndexer as JKvIndexer
from dynamo_exp_tpu_torch import recorder as trec
from dynamo_exp_tpu_torch import telemetry as T
from dynamo_exp_tpu_torch.kv_router.indexer import KvIndexer
from dynamo_exp_tpu_torch.kv_router.protocols import (
    KvCacheEventData,
    RouterEvent,
    kv_events_subject,
)
from dynamo_exp_tpu_torch.runtime.component import DistributedRuntime
from dynamo_exp_tpu_torch.runtime.transports.inproc import InProcDiscovery, InProcRequestPlane

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "anatomy_trace.jsonl")


def test_recorder_rotation_and_replay_match_jax(tmp_path):
    for name, mod in (("jax", jrec), ("torch", trec)):
        path = str(tmp_path / f"{name}.jsonl")
        rec = mod.Recorder(path, max_bytes=200, max_files=2)
        for i in range(20):
            rec.record({"i": i}, ts=float(i))
        rec.close()
        assert os.path.exists(path + ".1") and not os.path.exists(path + ".3")
    for name in ("jax", "torch"):
        for gen in ("", ".1", ".2"):
            path = str(tmp_path / f"{name}.jsonl{gen}")
            assert list(trec.Recorder.replay(path)) == list(jrec.Recorder.replay(path))
    assert [list(trec.Recorder.replay(str(tmp_path / f"torch.jsonl{g}")))
            for g in ("", ".1", ".2")] == [list(jrec.Recorder.replay(str(tmp_path / f"jax.jsonl{g}")))
                                           for g in ("", ".1", ".2")]
    events = [e for _ts, e in trec.Recorder.replay(str(tmp_path / "torch.jsonl"))]
    assert events == sorted(events, key=lambda e: e["i"])


def test_recorder_skips_torn_lines(tmp_path):
    path = str(tmp_path / "events.jsonl")
    rec = trec.Recorder(path)
    rec.record({"ok": 1})
    rec.close()
    with open(path, "a") as f:
        f.write("{torn-write\n")
    assert [e for _, e in trec.Recorder.replay(path)] == [{"ok": 1}]


def test_dyn_trace_file_records_per_process_and_load_spans_reads_the_siblings(
        tmp_path, monkeypatch):
    base = str(tmp_path / "spans.jsonl")
    monkeypatch.setenv("DYN_TRACE_FILE", base)
    hub = T.Telemetry()
    hub.configure_from_env()
    assert hub.trace_file == f"{base}.pid{os.getpid()}"
    hub._recorder.max_bytes = 512  # rotates
    for i in range(12):
        hub.emit(T.Span(stage="decode", trace_id=f"{i:032x}", span_id=f"s{i}",
                        start=float(i), end=i + 0.5, attrs={"generated_tokens": i}))
    hub.configure(None)
    # Another process's file of the same trace file, and unrelated files.
    with open(FIXTURE) as f, open(f"{base}.pid1", "w") as g:
        g.write(f.read())
    for junk in (".1.bak", ".gz", ".pidx"):
        with open(base + junk, "w") as g:
            g.write("{not json\n")
    assert os.path.exists(f"{base}.pid{os.getpid()}.1")
    got = sorted((s.trace_id, s.span_id) for s in T.load_spans([base]))
    want = sorted((s.trace_id, s.span_id) for s in J.load_spans([base]))
    assert got == want and len(got) == 12 + len(J.load_spans([FIXTURE]))


async def test_kv_recorder_replays_into_both_indexers(tmp_path):
    drt = DistributedRuntime(discovery=InProcDiscovery(), request_plane=InProcRequestPlane())
    subject = kv_events_subject("x/components/w")
    path = str(tmp_path / "kv.jsonl")
    kvrec = trec.KvRecorder(trec.Recorder(path))
    await kvrec.start(drt.event_plane, subject)
    tokens = list(range(1, 17))
    live = KvIndexer(block_size=4)
    hashes = live.block_hashes(tokens)
    parent = None
    for worker, upto in ((7, 4), (9, 2)):
        parent = None
        for h in hashes[:upto]:
            ev = RouterEvent(worker_id=worker,
                             data=KvCacheEventData(kind="stored", block_hashes=[h],
                                                   parent_hash=parent))
            await drt.event_plane.publish(subject, ev.to_dict())
            parent = h
    ev = RouterEvent(worker_id=9, data=KvCacheEventData(kind="removed", block_hashes=[hashes[1]]))
    await drt.event_plane.publish(subject, ev.to_dict())
    for _ in range(200):
        if kvrec.recorder.count >= 7:
            break
        await asyncio.sleep(0.01)
    await kvrec.stop()
    idx, jidx = KvIndexer(block_size=4), JKvIndexer(block_size=4)
    assert trec.KvRecorder.replay_into(path, idx) == 7
    assert jrec.KvRecorder.replay_into(path, jidx) == 7
    for probe in (tokens, tokens[:8], tokens[:4]):
        got = idx.find_matches_for_request(probe).scores
        assert got == jidx.find_matches_for_request(probe).scores
    assert idx.find_matches_for_request(tokens).scores == {7: 4, 9: 1}


def _fixture_groups(mod):
    spans = mod.load_spans([FIXTURE])
    out = {}
    for s in spans:
        out.setdefault(s.trace_id, []).append(s)
    return spans, out


def test_fixture_timelines_equal_jax():
    jspans, jg = _fixture_groups(J)
    tspans, tg = _fixture_groups(T)
    assert T.list_traces(tspans) == J.list_traces(jspans)
    for tid in tg:
        assert T.render_timeline(tg[tid]) == J.render_timeline(jg[tid])
        assert T.transfer_hops(tg[tid]) == J.transfer_hops(jg[tid])
    for needle in ("aaaa1111", "req-fixture-2", "nope", ""):
        got = [s.span_id for s in T.find_trace(tspans, needle)]
        assert got == [s.span_id for s in J.find_trace(jspans, needle)]


STAGES = ("http_request", "queue_wait", "prefill", "decode", "kv_transfer_send",
          "kv_transfer_recv", "remote_prefill")


@st.composite
def traces(draw):
    events = []
    for i in range(draw(st.integers(1, 10))):
        a = draw(st.floats(0, 5))
        attrs = draw(st.fixed_dictionaries({}, optional={
            "instance": st.sampled_from(["h:1", "h:2", "other:3"]),
            "request_id": st.just("req-z"), "bytes": st.integers(0, 1 << 28),
            "src": st.sampled_from(["h:1", "h:2"]), "dst": st.sampled_from(["h:1", "h:2"]),
            "pages": st.integers(0, 99)}))
        events.append({"type": "span", "stage": draw(st.sampled_from(STAGES)),
                       "trace_id": "f" * 32, "span_id": f"s{i}",
                       # An earlier span, none, or one whose file was lost
                       # (a span never parents itself).
                       "parent_span_id": draw(st.sampled_from(
                           ["", "lost"] + [f"s{j}" for j in range(i)])),
                       "start": a, "end": a + draw(st.floats(0, 3)), "attrs": attrs})
    return events


@settings(max_examples=80, deadline=None)
@given(traces(), st.integers(10, 60))
def test_drawn_traces_render_as_jax(events, width):
    js = [J.Span.from_event(e) for e in events]
    ts = [T.Span.from_event(e) for e in events]
    assert T.render_timeline(ts, width=width) == J.render_timeline(js, width=width)
    assert T.transfer_hops(ts) == J.transfer_hops(js)
    assert T.list_traces(ts) == J.list_traces(js)
