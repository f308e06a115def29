"""The traffic generator and the open-loop driver: one seed, one schedule;
every seed the same work; latency from the due time, so a stall shows."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from benchmark.drivers import open_loop
from benchmark.harness.stats import percentile
from benchmark.traffic import generator

MIX = {"kind": "open_loop", "sizes": [1, 8]}


def test_schedule_is_deterministic_per_seed():
    a = generator.open_loop(MIX, 3_000_000_001, 4000.0, 5.0, 2048)
    b = generator.open_loop(MIX, 3_000_000_001, 4000.0, 5.0, 2048)
    c = generator.open_loop(MIX, 3_000_000_002, 4000.0, 5.0, 2048)
    for x, y in ((a.due_s, b.due_s), (a.size, b.size), (a.offset, b.offset)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.size, c.size)


def test_every_seed_gets_the_same_work():
    a = generator.open_loop(MIX, 11, 4000.0, 5.0, 2048)
    b = generator.open_loop(MIX, 2**32 + 5, 4000.0, 5.0, 2048)
    assert np.array_equal(np.sort(a.size), np.sort(b.size))
    # the same gaps, each schedule scaled to end just inside the window
    assert np.allclose(np.sort(np.diff(a.due_s)), np.sort(np.diff(b.due_s)), rtol=0.01)
    assert a.images == b.images
    assert abs(a.images / 5.0 - 4000.0) / 4000.0 < 0.01
    assert 0.0 == a.due_s[0] and a.due_s[-1] < 5.0
    assert (a.offset + a.size <= 2048).all()


def test_frames_are_seeded_grey_uint8():
    x = generator.frames(3, (16, 16), 2**33 + 1)
    assert x.dtype == np.uint8 and x.shape == (3, 16, 16, 3)
    assert np.array_equal(x, generator.frames(3, (16, 16), 2**33 + 1))
    assert np.array_equal(x[..., 0], x[..., 2])


class FakeBatcher:
    """Answers each request on a worker thread at once, except for one stall
    of ``stall_s`` when request ``stall_at`` comes in."""

    def __init__(self, stall_at=None, stall_s=0.0):
        self.stall_at, self.stall_s = stall_at, stall_s
        self.items, self.cv, self.n = [], threading.Condition(), 0
        self.t = threading.Thread(target=self._work, daemon=True)
        self.closed = False
        self.t.start()

    def submit(self, images):
        f = Future()
        with self.cv:
            self.items.append((images, f, self.n))
            self.n += 1
            self.cv.notify()
        return f

    def _work(self):
        while True:
            with self.cv:
                while not self.items and not self.closed:
                    self.cv.wait()
                if self.closed and not self.items:
                    return
                images, f, i = self.items.pop(0)
            if i == self.stall_at:
                time.sleep(self.stall_s)
            f.set_result(np.zeros((len(images), 6), np.float32))

    def close(self):
        with self.cv:
            self.closed = True
            self.cv.notify()
        self.t.join(5)


@pytest.mark.parametrize("stall_s", [0.0, 0.5])
def test_a_stall_shows_in_the_tail(stall_s):
    sched = generator.open_loop(MIX, 7, 450.0, 1.0, 64)
    pool = np.zeros((64, 2, 2, 3), np.uint8)
    b = FakeBatcher(stall_at=5, stall_s=stall_s)
    try:
        res = open_loop.window(b, pool, sched, 1.0, 5.0)
    finally:
        b.close()
    assert res["unanswered"] == 0 and res["raised"] == 0
    p95 = percentile(res["latency_s"], 95)
    if stall_s:
        # every request due during the stall waits for it: far more than 5%
        assert p95 >= 0.25
    else:
        assert p95 < 0.2


def test_a_failed_request_misses_every_limit():
    assert percentile([0.01, 0.02, float("inf")], 95) == float("inf")
    assert percentile(list(range(1, 101)), 95) == 95
