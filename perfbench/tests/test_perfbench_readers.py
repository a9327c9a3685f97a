"""Each per-layer and end-to-end reader on a small synthetic trace and
window, and the reduction of raw profiler events."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import spec, trace
from perfbench.roofline import counts, launch_bound_s
from perfbench.window import Call, Window

K1 = "void (anonymous namespace)::thomas_warp_kernel<double, 0, false, 24>(double const*)"
K2 = "void (anonymous namespace)::ls_kernel<double>(LSParams<double>)"
K4A = "void (anonymous namespace)::gj_tile_kernel<double, false, 14>(double const*)"
K5 = "void (anonymous namespace)::gj_tile_kernel<double, true, 14>(double const*)"
ADD = "void at::native::elementwise_kernel<128, 2, add>(int)"


class Event:
    def __init__(self, name, start_us, end_us, device=DeviceType.CPU, annotation=False):
        self._n, self._s, self._d = name, start_us * 1000, (end_us - start_us) * 1000
        self._dev, self._a = device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def gpu(name, a, b):
    return Event(name, a, b, DeviceType.CUDA)


EVENTS = [
    Event("perfbench.window", 0, 1000),
    Event("perfbench.draw", 5, 15),
    Event("perfbench.call", 20, 900),
    Event("mcp.residual_bands", 30, 130), Event("mcp.newton_solve", 130, 170),
    Event("mcp.linesearch", 170, 180), Event("mcp.loop_test", 180, 200),
    Event("cudaStreamSynchronize", 190, 199),
    Event("mcp.residual_bands", 300, 400), Event("mcp.newton_solve", 400, 440),
    Event("mcp.newton_solve", 400, 440, DeviceType.CUDA, annotation=True),
    Event("cudaDeviceSynchronize", 950, 990),
    gpu(K1, 150, 160), gpu(K1, 420, 430), gpu(K2, 175, 178), gpu(K4A, 440, 450),
    gpu(K5, 450, 452), gpu(ADD, 150, 155), gpu("Memcpy DtoH (Device -> Pageable)", 910, 920),
    gpu(ADD, 2000, 2010),  # after the window
]
CTX64 = SimpleNamespace(config={"dtype": "float64", "kernel_shapes": {
    "K1": {"T": 10, "b": 20, "shared_bands": True, "fact": "qr"},
    "K2": {"n": 200, "m": 250, "candidates": 15}, "K4a": {"n": 100}}},
    traffic={}, batch=1024, setup_s=12.5)


@pytest.fixture(scope="module")
def tr():
    return trace.reduce(EVENTS)


def read(name, tr, ctx=CTX64):
    return spec.per_layer_reader(name).read(tr, ctx)


def test_reduce(tr):
    assert tr.calls == 1 and tr.window_s == pytest.approx(1e-3)
    assert len(tr.kernels) == 7 and len(tr.launches) == 6
    assert tr.syncs_in_calls == 1  # the synchronize after the call is the harness's
    assert tr.span_count("mcp.newton_solve") == 2  # the device-side mirror is not a span
    assert tr.busy_s() == pytest.approx((10 + 3 + 10 + 10 + 2 + 10) * 1e-6)


def test_step_readers(tr):
    assert read("newton_steps_per_batch", tr) == 2
    assert read("host_syncs_per_step", tr) == 0.5
    assert read("launches_per_step", tr) == 3
    assert read("residual_ms_per_step", tr) == pytest.approx(0.1)
    assert read("newton_ms_per_step", tr) == pytest.approx(0.04)
    assert read("linesearch_ms_per_step", tr) == pytest.approx(0.005)
    assert read("device_idle_share", tr) == pytest.approx(100 * (1 - 45e-3))


def test_roofline_readers(tr):
    k1 = launch_bound_s("K1", 1024, CTX64.config["kernel_shapes"]["K1"], "float64")
    nbytes, flops = counts.thomas_counts(1024, 10, 20, True, itemsize=8)
    assert k1 == max(nbytes / counts.HBM_BYTES_PER_S, flops / 34e12)
    assert read("roofline.K1", tr) == pytest.approx(100 * 2 * k1 / 20e-6)
    k4a = launch_bound_s("K4a", 1024, {"n": 100}, "float64")
    assert read("roofline.K4a", tr) == pytest.approx(100 * k4a / 10e-6)  # K5 left out
    assert read("roofline.K2", tr) > 0


def test_readers_find_nothing_where_nothing_ran():
    empty = trace.reduce([Event("perfbench.window", 0, 10)])
    for name in ("newton_steps_per_batch", "host_syncs_per_step", "launches_per_step",
                 "residual_ms_per_step", "linesearch_ms_per_step", "roofline.K1",
                 "roofline.K4a"):
        assert read(name, empty) is None
    no_shape = SimpleNamespace(config={"dtype": "float32", "kernel_shapes": {}}, batch=8)
    assert read("roofline.K1", trace.reduce(EVENTS), no_shape) is None


def test_breakdown(tr):
    b = trace.breakdown(tr)
    assert b["device_ops"][0][0].startswith("void (anonymous namespace)::thomas_warp_kernel")
    assert b["device_ops"][0][1] == pytest.approx(20e-6)
    gaps = dict(b["idle_gaps"])
    assert len(b["device_ops"]) <= 10 and len(gaps) <= 10
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s())
    # Gaps (us) by the span open at their middle: 0–150 residual, 160–175 and
    # 430–440 newton, 178–420 and 452–910 the call, 920–1000 the window.
    assert gaps == pytest.approx({"mcp.residual_bands": 150e-6, "mcp.newton_solve": 25e-6,
                                  "perfbench.call": 700e-6, "perfbench.window": 80e-6})


def test_host_labels_take_the_innermost_span(tr):
    labels = trace.host_labels(tr.spans, [10e-6, 100e-6, 185e-6, 195e-6, 600e-6, 930e-6])
    assert labels == ["perfbench.draw", "mcp.residual_bands", "mcp.loop_test", "mcp.loop_test",
                      "perfbench.call", "perfbench.window"]


def test_end_to_end_readers():
    calls = [Call(i, t, 0.0, None) for i, t in enumerate([1.0, 3.0, 2.0] + [1.5] * 17)]
    window = Window(calls, 40.0, 40.0, True)
    verdict = SimpleNamespace(certified=8000)
    ctx = SimpleNamespace(setup_s=12.5)
    assert spec.end_to_end_reader("solves_per_s").read(window, verdict, ctx) == 200.0
    assert spec.end_to_end_reader("batch_p95_s").read(window, verdict, ctx) == 2.0
    assert spec.end_to_end_reader("setup_s").read(window, verdict, ctx) == 12.5
