"""The card's time of a call, read on the card's own clock.

`device_ms` queues n back-to-back calls behind a spin kernel
(torch.cuda._sleep) that outlasts their enqueueing and brackets them with
CUDA events, so the card runs them without waiting on the host. Where a
wrapper's host cost exceeds its kernels' time, events around the calls alone
read the host; these read the card, and count every kernel and copy of the
call, since the events bracket the stream. Used by `chip_smoke.py` and the
`attention_sources` harness; nothing here runs at import.
"""
from __future__ import annotations

import time

SPIN_CYCLES_PER_S = 2e9  # torch.cuda._sleep's clock, at or above the SM clock


def device_ms(fn, n: int = 10, repeats: int = 1) -> float:
    """The card's time of one fn(): the median over `repeats` runs of n
    calls each. A run whose enqueueing outlasted its spin (a stall of the
    shared host) is not taken: it is run again behind a spin four times as
    long. Raises where four runs outlasted their spins."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    spin_s = max(4 * (time.perf_counter() - t0), 2e-3)
    times, late = [], 0
    while len(times) < repeats:
        spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        spin_ms = spin.elapsed_time(start)
        if enqueue_ms >= spin_ms:
            late += 1
            if late == 4:
                raise RuntimeError(f"device_ms: enqueueing took {enqueue_ms:.3f} ms, the "
                                   f"spin {spin_ms:.3f} ms: the card may have waited on "
                                   "the host")
            spin_s *= 4
            continue
        times.append(start.elapsed_time(end) / n)
    return sorted(times)[len(times) // 2]
