"""The port's edge admission control (``http/admission.py``) against the
JAX package's, on the CPU.

- The watermark rule (``_resolve_watermark``) and each class's threshold
  equal the JAX ones over a grid of caps and watermarks.
- A hypothesis property: any sequence of acquires (by priority class)
  and releases gives the same admit / 429 / 503 sequence, the same
  in-flight count after every step, and the same ``dynamo_requests_shed_total{priority,code}`` and
  ``dynamo_admission_inflight`` movements on each package's registry.
- ``admit()`` releases on the way out, exceptions included.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from prometheus_client.parser import text_string_to_metric_families

from dynamo_exp_tpu.http import admission as jadm
from dynamo_exp_tpu.telemetry import get_telemetry as jget_telemetry
from dynamo_exp_tpu_torch.http import admission as tadm
from dynamo_exp_tpu_torch.telemetry import get_telemetry


def shed_counts(text: str) -> dict:
    out = {}
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name in ("dynamo_requests_shed_total", "dynamo_admission_inflight"):
                out[(s.name, tuple(sorted(s.labels.items())))] = s.value
    return out


@pytest.mark.parametrize("cap", [1, 2, 3, 4, 7, 10, 64])
def test_watermark_rule_and_thresholds_match_jax(cap):
    for wm in (None, 0, 1, cap // 2, cap - 1, cap, cap + 5):
        assert tadm._resolve_watermark(cap, wm) == jadm._resolve_watermark(cap, wm)
        if wm == 0:
            continue  # run.py maps --shed-watermark 0 to None
        t, j = tadm.AdmissionController(cap, wm), jadm.AdmissionController(cap, wm)
        assert [t.threshold(p) for p in (0, 1, 2)] == [j.threshold(p) for p in (0, 1, 2)]


STEP = st.one_of(
    st.tuples(st.just("acquire"), st.sampled_from([0, 1, 2])),
    st.tuples(st.just("release"), st.just(0)),
)


def _drive(mod, cap, wm, steps):
    ctl = mod.AdmissionController(max_inflight=cap, shed_watermark=wm, retry_after_s=2.0)
    trace = []
    for op, arg in steps:
        if op == "acquire":
            try:
                ctl.acquire(arg)
                trace.append(("admit", ctl.inflight))
            except mod.ServiceOverloadedError as e:
                trace.append((503, ctl.inflight, e.retry_after_s))
            except mod.RequestShedError as e:
                trace.append((429, ctl.inflight, e.retry_after_s))
        else:
            ctl.release()
            trace.append(("release", ctl.inflight))
    return trace, ctl.inflight


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 12), st.one_of(st.none(), st.integers(1, 12)),
       st.lists(STEP, max_size=40))
def test_admit_and_shed_sequence_matches_jax(cap, wm, steps):
    jbefore = shed_counts(jget_telemetry().render().decode())
    tbefore = shed_counts(get_telemetry().render().decode())
    want = _drive(jadm, cap, wm, steps)
    got = _drive(tadm, cap, wm, steps)
    assert got == want
    jafter = shed_counts(jget_telemetry().render().decode())
    tafter = shed_counts(get_telemetry().render().decode())

    def delta(after, before):
        return {k: v - before.get(k, 0.0) for k, v in after.items()
                if k[0] == "dynamo_requests_shed_total" and v != before.get(k, 0.0)}

    assert delta(tafter, tbefore) == delta(jafter, jbefore)
    gauge = ("dynamo_admission_inflight", ())
    if steps:
        assert tafter[gauge] == jafter[gauge] == got[1]


def test_admit_context_releases_on_error():
    ctl = tadm.AdmissionController(max_inflight=2, shed_watermark=1)
    with pytest.raises(RuntimeError):
        with ctl.admit(2):
            assert ctl.inflight == 1
            raise RuntimeError("handler failed")
    assert ctl.inflight == 0
    with ctl.admit(2), pytest.raises(tadm.RequestShedError) as shed:
        with ctl.admit(0):
            pass
    assert shed.value.status == 429 and ctl.inflight == 0
    with pytest.raises(ValueError):
        tadm.AdmissionController(max_inflight=0)
