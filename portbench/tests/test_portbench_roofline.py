"""The kernels' bounds reproduce the table of PERF.md (the H100's published
peaks; bytes read once and written once)."""
import pytest

from portbench.roofline import k1, k2, k6, k10, k12, k13

H, D = 1024, 63


@pytest.mark.parametrize("got,want", [
    (k1.layer_s(500, H, H, True), 2.46), (k1.layer_s(500, H, H, False), 1.85),
    (k1.layer_s(500, D, H, False), 0.69), (k1.layer_s(1000, H, H, True), 4.30),
    (k2.head_s(500, H, D), 0.73),
    (k13.layer_s(500, H, H, True, False, True), 1.85),
    (k13.layer_s(500, H, H, False, False, True), 1.24),
    (k13.layer_s(500, D, H, False, True, True), 0.83),
    (k10.layer_s(1280, H, H, True, True, True), 6.94),
    (k10.layer_s(1280, H, H, False, True, False), 3.81),
    (k12.hop_s(1280, H, H, True, True), 6.16), (k12.hop_s(1280, H, H, False, False), 3.03),
    (k6.head_s(1000, H, D, False), 1.94),
])
def test_bounds_reproduce_the_table(got, want):
    assert round(got * 1e6, 2) == want


def test_work_scales_the_bound():
    one = dict(rows=500, hidden=H, dim=D, n_blocks=2, forwards=1, em_heads=1)
    many = dict(one, forwards=1000, em_heads=1000)
    assert k1.bound_s(many) == pytest.approx(1000 * k1.bound_s(one))
    assert k1.bound_s(one) * 1e6 == pytest.approx(9.32, abs=0.01)
    assert k2.bound_s(many) == pytest.approx(1000 * k2.bound_s(one))
