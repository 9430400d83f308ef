"""The window's rule, on a fake clock: whole units only, closed by the
first unit that ends at or after ``seconds``."""

import pytest

from portbench.window import Window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_closes_at_the_first_unit_past_the_length():
    clock = Clock()
    closed = []
    w = Window(10.0, clock=clock, on_close=lambda: closed.append(clock.t))
    w.open()
    for dt, parts in ((4.0, 200), (5.9, 200), (3.0, 200), (7.0, 200)):
        clock.t += dt
        w.unit(parts)
    # 4, 9.9 are inside; 12.9 is the first end past 10; 19.9 is outside
    assert w.closed and w.length == pytest.approx(12.9)
    assert w.partitions == 600 and w.units == 3
    assert closed == [pytest.approx(112.9)]


def test_a_unit_ending_exactly_at_the_length_closes_it():
    clock = Clock()
    w = Window(5.0, clock=clock)
    w.open()
    clock.t += 5.0
    assert w.unit(8)
    assert w.length == 5.0 and w.partitions == 8


def test_final_detect_seconds_count_only_inside():
    clock = Clock()
    w = Window(2.0, clock=clock)
    w.open()
    clock.t += 1.0
    w.unit(20, final_detect_s=0.4)
    clock.t += 1.5
    w.unit(20, final_detect_s=0.7)
    clock.t += 1.0
    w.unit(20, final_detect_s=0.9)
    assert w.final_detect_s == pytest.approx(1.1)
    assert w.partitions == 40


def test_unit_before_open_and_length_before_close_raise():
    w = Window(1.0, clock=Clock())
    with pytest.raises(RuntimeError):
        w.unit(1)
    w.open()
    with pytest.raises(RuntimeError):
        w.length
