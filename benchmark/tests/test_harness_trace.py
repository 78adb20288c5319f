"""The trace reduction and the roofline's counts, on hand-made inputs."""

import pytest

from benchmark.harness import roofline, trace


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    ev(trace.CALL, "user_annotation", 0, 100),
    ev("projection base", "user_annotation", 0, 60),
    ev("aten::item", "cpu_op", 40, 15),
    ev("gsm", "user_annotation", 60, 40),
    ev("void ns::panel_factor_kernel<8, true>(float*, int)", "kernel",
       5, 20, tid=7),
    ev("void ns::panel_factor_kernel<16, false>(float*, int)", "kernel",
       20, 10, tid=7),  # overlaps the first: the union counts 5..30
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 70, 10, tid=7),
    ev("other", "kernel", 200, 50, tid=7),  # outside every traced call
]


def test_summary_busy_ranges_ops_and_gaps():
    s = trace.summarize(EVENTS)
    assert s.calls == 1
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(35e-6)  # 5..30 and 70..80
    assert s.range_busy_s["projection base"] == pytest.approx(25e-6)
    assert s.range_busy_s["gsm"] == pytest.approx(10e-6)
    assert s.range_count == {"projection base": 1, "gsm": 1}
    assert dict(s.device_ops) == pytest.approx(
        {"panel_factor_kernel": 30e-6,
         "Memcpy DtoH (Device -> Pageable)": 10e-6})
    # a gap is labelled by what the host did at its middle: 0..5 in
    # "projection base", 30..70 in its aten::item, 80..100 in "gsm"
    assert dict(s.idle_gaps) == pytest.approx(
        {"projection base": 5e-6, "projection base > aten::item": 40e-6,
         "gsm": 20e-6})


def test_summary_without_calls_is_empty():
    assert trace.summarize(EVENTS[1:]).calls == 0


def test_symbol_drops_namespace_templates_and_parameters():
    assert trace.symbol("void (anonymous namespace)::mm_words_kernel<3>"
                        "(float const*)") == "mm_words_kernel"


@pytest.mark.parametrize("n, m, points", [(4, 1, 1), (6, 2, 3), (384, 2,
                                                                 8)])
def test_lu_work_matches_a_hand_count(n, m, points):
    """Per point: Doolittle LU's multiply-adds counted one by one
    (Σ_k (n−k−1)·(1 + 2(n−k−1))), less the ⅔n³ leading term's lower
    order, and 2n² per right-hand side for the two triangular solves."""
    flops, nbytes = roofline.lu_sweep_work(n, m, points)
    assert flops == pytest.approx(points * (2 * n**3 / 3 + 2 * n * n * m))
    exact = sum((n - k - 1) + 2 * (n - k - 1) ** 2 for k in range(n))
    assert exact == pytest.approx(2 * n**3 / 3, rel=2.0 / n)
    assert nbytes == 8 * (3 * n * n + points * n * m)


def test_least_time_names_its_bound():
    t, bound = roofline.least_seconds(989e12, 1.0)
    assert (t, bound) == (pytest.approx(1.0), "operations")
    t, bound = roofline.least_seconds(1.0, 3.35e12)
    assert (t, bound) == (pytest.approx(1.0), "bytes")


def test_the_full_sweeps_roofline_is_operation_bound():
    flops, nbytes = roofline.lu_sweep_work(3411, 2, 100)
    t, bound = roofline.least_seconds(flops, nbytes)
    assert bound == "operations"
    assert t == pytest.approx(2.68e-3, rel=0.01)
