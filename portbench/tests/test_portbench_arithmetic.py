"""The yardstick's arithmetic against hand counts at tiny shapes: the
union of device intervals, kernel time by name, the K10 bytes and their
roofline share, FLOPs of matrix products, the idle share and the share of
the peak, and the comparison's gaps."""

from __future__ import annotations

import types

import pytest
import torch

from portbench import compare, counts, readers, trace


def ev(name, start, end):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(
        start=start, end=end, elapsed_us=lambda: end - start))


def test_busy_us_is_the_union_of_intervals():
    events = [ev("a", 0, 10), ev("b", 5, 15), ev("c", 20, 30), ev("d", 22, 25)]
    assert trace.busy_us(events) == 25.0  # [0, 15] and [20, 30]
    assert trace.busy_us([]) == 0.0


def test_kernel_time_by_name():
    events = [ev("void gather_rows_kernel<4>", 0, 3), ev("reduce_scatter_rows_kernel", 4, 9), ev("gemm", 9, 20)]
    assert trace.kernel_device_us(events, "gather_rows_kernel") == 3
    assert trace.kernel_device_us(events, "rows_kernel") == 8


def test_k10_bytes_and_roofline_by_hand():
    # [2,097,152, 4] f32: 32 MiB read and 32 MiB written a gather
    assert counts.gather_bytes(2_097_152, 4, 4) == 64 * 2**20
    assert counts.reduce_scatter_bytes(2_097_152, 4) == 64 * 2**20
    assert counts.reduce_scatter_bytes(10, 4, m=3) == 4 * 10 * 4 * 4
    # 64 MiB at 3.35 TB/s take 20.03 us: 40.06 us of device time is 50 %
    need = 64 * 2**20 / 3.35e12
    assert counts.roofline_share(64 * 2**20, 2 * need, 3.35e12) == pytest.approx(50.0)
    assert counts.roofline_share(1, 0.0, 3.35e12) is None


def test_k10_roofline_reader_by_hand():
    events = [ev("gather_rows_kernel", 0, 40.0), ev("reduce_scatter_rows_kernel", 50, 90.0)]
    cuda = types.SimpleNamespace(dev_events=events, counters={"all_gather_rows": 2, "reduce_scatter_rows": 1})
    view = types.SimpleNamespace(device_name="NVIDIA H100 80GB HBM3", job=types.SimpleNamespace(k10_shape=(1024, 4)),
                                 cuda=cuda)
    moved = 2 * 2 * 1024 * 4 * 4 + 2 * 1024 * 4 * 4
    assert readers.k10_roofline(view) == pytest.approx(100.0 * moved / 3.35e12 / 80e-6)
    view.device_name = "cpu"
    assert readers.k10_roofline(view) is None  # no published peak: no share


def test_flops_of_matrix_products_by_hand():
    a, b = torch.randn(8, 16), torch.randn(16, 32)
    _, flops = counts.count_flops(lambda: a @ b)
    assert flops == 2 * 8 * 16 * 32
    w = torch.randn(32, 16, requires_grad=True)
    x = torch.randn(8, 16, requires_grad=True)
    # forward 2*8*16*32; backward: the input's and the weight's gradients, as much again each
    _, flops = counts.count_flops(lambda: torch.nn.functional.linear(x, w).sum().backward())
    assert flops == 3 * 2 * 8 * 16 * 32


def test_idle_share_and_mfu_by_hand():
    view = types.SimpleNamespace(cuda=types.SimpleNamespace(busy_us=1.5e6, window_s=2.0), window_s=2.0, units=10,
                                 device_name="NVIDIA H100", job=types.SimpleNamespace(flops_per_unit=67e12 * 0.02))
    assert readers.idle_share(view) == pytest.approx(25.0)
    # 10 units of 1.34 TFLOP in the untraced window's 2 s: 6.7 TFLOP/s, 10 % of 67
    assert readers.mfu(view) == pytest.approx(10.0)
    view.cuda = None
    assert readers.idle_share(view) is None  # no CUDA trace: not read
    view.job = types.SimpleNamespace(flops_per_unit=None)
    assert readers.mfu(view) is None  # nothing counted: not read


def test_window_ms_and_launches():
    cuda = types.SimpleNamespace(units=12,
                                 dev_events=[ev("k", 0, 1), ev("Memcpy HtoD", 1, 2), ev("Memset (Device)", 2, 3)])
    view = types.SimpleNamespace(window_s=3.0, units=12, cuda=cuda)
    assert readers.window_ms(view) == 250.0
    assert readers.kernel_launches(view) == pytest.approx(1 / 12)
    view.units = 0
    assert readers.window_ms(view) is None


def test_training_gaps_by_hand():
    def named(xs):
        return dict(zip("abcd", xs))

    ref = {"losses": [2.0, 1.0], "grad": named([1.0, 3.0, 5.0, 1e-9]), "change": named([0.5, 1.0, 2.0, 7.0])}
    got = {"losses": [2.0, 1.01], "grad": named([1.1, 3.0, 5.0, 1e-9]), "change": named([0.5, 1.0, 2.5, 1e3])}
    out = compare.compare_training(got, ref)
    assert out["loss"] == pytest.approx(0.01)
    # against the larger of the leaf's norm and the median leaf's (2.0): 0.1 / 2.0
    assert out["grad"] == pytest.approx(0.05)
    # the last leaf's gradient is under a thousandth of the median's: left out of the change
    assert out["change"] == pytest.approx(0.5 / 2.0)
    assert compare.compare_training({**got, "losses": [float("nan"), 1.0]}, ref)["loss"] == float("inf")
    # a parameter that one side lacks
    assert compare.compare_training({**got, "grad": named([1.0, 3.0, 5.0])}, ref)["grad"] == float("inf")


def test_frame_gaps_and_judge():
    img = torch.zeros(2, 2, 3).numpy()
    assert compare.compare_frames({3: img + 0.25, 5: img}, {3: img, 5: img}) == {"image": 0.25}
    assert compare.compare_frames({5: img}, {3: img}) == {"image": float("inf")}  # a frame never answered
    ok, rows = compare.judge({"image": 0.25, "loss": 0.0}, {"image": 0.3, "loss": 1e-6})
    assert ok and rows == [("image", 0.25, 0.3), ("loss", 0.0, 1e-6)]
    assert not compare.judge({"image": 0.25}, {"image": 0.3, "loss": 1e-6})[0]  # a limit without its number
    assert not compare.judge({"image": 0.35, "loss": 0.0}, {"image": 0.3, "loss": 1e-6})[0]


def test_body_share_of_a_frame_by_hand(root):
    from portbench import harness

    spans = harness.Spans()
    spans.items = [("body.sequence", 10.0, 10.6), ("body.frame", 10.6, 10.61), ("body.frame", 11.0, 11.03),
                   ("body.sequence", 1.0, 9.0)]  # the last one before the window: not read
    spans.items.append(("body.frame", 12.0, 12.5))  # after the window: not read
    view = types.SimpleNamespace(spans=spans, window_start=10.0, window_end=11.5,
                                 job=types.SimpleNamespace(n_frames=30))
    reader = harness.metric_reader(root, "body_ms.frame")
    # 600 ms of transforms over 30 frames, and 20 ms of posed-body set-up a frame
    assert reader.read(view) == pytest.approx(20.0 + 20.0)
    view.window_start = 20.0
    assert reader.read(view) is None
