"""The measured window: closed loops over the pool of batches, and the
end-to-end arithmetic taken over all the work and all the time of the
window. The clock and the device's synchronise are arguments, so a test
can drive them."""
from __future__ import annotations

import math
import time
from typing import Callable, List, Sequence


def train_loop(step: Callable, pool: Sequence, first: int, seconds: float,
               sync: Callable[[], None],
               clock: Callable[[], float] = time.perf_counter) -> dict:
    """Steps on pool[first], pool[first + 1], ... (cycling) until
    `seconds` have passed since the start, then a synchronise ends the
    window. {"steps", "seconds"}."""
    sync()
    t0 = clock()
    n = 0
    while clock() - t0 < seconds:
        step(pool[(first + n) % len(pool)])
        n += 1
    sync()
    return {"steps": n, "seconds": clock() - t0}


def request_loop(request: Callable, pool: Sequence, first: int,
                 seconds: float, sync: Callable[[], None],
                 clock: Callable[[], float] = time.perf_counter,
                 keep: bool = True) -> dict:
    """One caller, closed loop: requests on pool[first], ... until
    `seconds` have passed since the start; each timed from its call to its
    result on the host. {"requests", "seconds", "latencies" (s),
    "outputs" [(pool index, result)] when `keep`}."""
    sync()
    t0 = clock()
    lat: List[float] = []
    outputs = []
    while True:
        s = clock()
        if s - t0 >= seconds:
            break
        k = (first + len(lat)) % len(pool)
        out = request(pool[k])
        lat.append(clock() - s)
        if keep:
            outputs.append((k, out))
    return {"requests": len(lat), "seconds": clock() - t0,
            "latencies": lat, "outputs": outputs}


def rate(items: float, seconds: float) -> float:
    return items / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank `q`-th percentile: the smallest value that at
    least q% of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]
