"""The trace reduction on a hand-made trace."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from cgbench import trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, dev=CPU, thread=1, annotation=False):
    return SimpleNamespace(name=name, device_type=dev, thread=thread,
                           is_async=False, is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def _trace():
    # window 0..100 us; kernels 10-40 and 30-50 overlap (busy 10-50),
    # a copy 70-80; the span's image on the device timeline spans it all
    return [
        ev(trace.SPAN, 0, 100, annotation=True),
        ev(trace.SPAN, 0, 100, dev=CUDA, annotation=True),
        ev("aten::mul", 1, 9),
        ev("cudaLaunchKernel", 2, 4),
        ev("aten::item", 50, 88),
        ev("cudaMemcpyAsync", 55, 85),
        ev("other thread", 0, 100, thread=2),
        ev("k1", 10, 40, dev=CUDA),
        ev("k2", 30, 50, dev=CUDA),
        ev("Memcpy DtoH", 70, 80, dev=CUDA),
        ev("k_outside", 120, 130, dev=CUDA),
    ]


def test_busy_is_the_union_and_the_span_image_is_no_operation():
    out = trace.reduce(_trace())
    assert abs(out["window_s"] - 100e-6) < 1e-15
    assert abs(out["busy_s"] - 50e-6) < 1e-15    # 10-50 and 70-80
    assert out["kernels"] == 2                   # the copy is no kernel
    ops = dict(out["device_ops"])
    assert set(ops) == {"k1", "k2", "Memcpy DtoH"}
    assert abs(ops["k1"] - 30e-6) < 1e-15


def test_gaps_are_named_by_the_innermost_host_op():
    idle = dict(trace.reduce(_trace())["idle_gaps"])
    # gaps 0-10 (mid 5: aten::mul), 50-70 (mid 60: cudaMemcpyAsync inside
    # aten::item), 80-100 (mid 90: aten::item ended at 88, so none)
    assert abs(idle["aten::mul"] - 10e-6) < 1e-15
    assert abs(idle["cudaMemcpyAsync"] - 20e-6) < 1e-15
    assert abs(idle[trace.NO_HOST_OP] - 20e-6) < 1e-15
    assert "other thread" not in idle


def test_nothing_to_read_gives_none():
    assert trace.reduce([ev("aten::mul", 0, 5)]) is None
    assert trace.reduce([ev(trace.SPAN, 0, 100),
                         ev("aten::mul", 1, 5)]) is None


def test_breakdown_keeps_ten_entries_and_names_are_cut():
    evs = [ev(trace.SPAN, 0, 1000)] + [
        ev("k" * 200 + str(i), 10 * i, 10 * i + 5, dev=CUDA)
        for i in range(30)]
    out = trace.reduce(evs)
    assert len(out["device_ops"]) == trace.TOP
    assert all(len(name) <= trace.NAME_CHARS for name, _ in out["device_ops"])
