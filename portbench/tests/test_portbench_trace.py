"""The trace's arithmetic on hand-made intervals: the union of device
operations, idle gaps named by the host span they began in, and the
metric readers over them."""

from __future__ import annotations

from portbench import spec
from portbench.drivers import Window
from portbench.run import Run, breakdown
from portbench.trace import DeviceTrace, Spans, names_kernel, short_name


def _trace(ops, start=0, end=100):
    tr = DeviceTrace.__new__(DeviceTrace)
    tr.ops, tr.start_ns, tr.end_ns = ops, start, end
    return tr


def test_busy_is_the_union_of_overlapping_operations():
    tr = _trace([("a", 10, 30), ("b", 20, 40), ("c", 60, 70)])
    assert tr.busy_s() == 40 / 1e9
    assert tr.seconds_by_name() == {"a": 20 / 1e9, "b": 20 / 1e9, "c": 10 / 1e9}


def test_gaps_are_named_by_the_innermost_span():
    tr = _trace([("k", 10, 40), ("k", 60, 70), ("k", 85, 90)])
    spans = Spans()
    spans.add("call", 0, 80)
    spans.add("graph.sync", 35, 65)
    gaps = tr.idle_by_span(spans)
    assert gaps == {"call": 25 / 1e9, "graph.sync": 20 / 1e9, "no span": 10 / 1e9}


def test_kernel_names_match_whole_identifiers():
    full = "void enc_mma_kernel<16, 32, 8>(__nv_bfloat16 const*, float*)"
    assert names_kernel("enc_mma_kernel", full)
    assert not names_kernel("enc1_mma_kernel", full)
    assert not names_kernel("mma_kernel", full)
    assert short_name(full) == "enc_mma_kernel<16, 32, 8>"
    assert short_name("void ns::(anonymous namespace)::k<2>(int)") == "ns::k<2>"
    assert short_name("ns::k(float2 const*, int)") == "ns::k"
    assert short_name("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH (Device -> Pageable)"


def test_readers_over_a_trace():
    from portbench.drivers import offline
    import torch

    cell = spec.cell("vst4-track300")
    shapes = offline.Driver(cell, 1, torch.device("cpu")).unit_shapes()
    ms = 1_000_000
    ops = [("void enc_mma_kernel<1>(int)", 0, 2 * ms),
           ("void at::native::elementwise_kernel<128, 4>(int)", 2 * ms, 5 * ms),
           ("Memcpy DtoD (Device -> Device)", 5 * ms, 6 * ms)]
    w = Window(0.01, [0.01], 1, 0, [], 1, 300.0)
    run = Run(cell, 1.0, w, Spans(), shapes, spec.stages(),
              trace=_trace(ops, 0, 10 * ms), traced=w, traced_spans=Spans())
    read = lambda n: spec.metric_reader(n)(run)
    assert read("model.torch_ops_ms") == 4.0
    assert abs(read("device.idle_pct") - 40.0) < 1e-9
    from portbench import work
    k3 = work.stage_bound_s(spec.stages()["k3_enc"], shapes)
    assert abs(read("hand_kernels_roofline") - 100 * (
        sum(b for s in spec.stages().values()
            if (b := work.stage_bound_s(s, shapes)) is not None)) / 2e-3) < 1e-6
    assert k3 > 0
    b = breakdown(run)
    assert b["device_ops"][0][0].startswith("at::native::elementwise_kernel")
    assert b["idle_gaps"] == [["no span", 4e-3]]
