"""Windowed metric logging (a copy of ``cald_tpu/engine/logging.py``, which
the port cannot import: ``cald_tpu.engine`` imports JAX).

Host-only Python; single process.
"""

from __future__ import annotations

import collections
import datetime
import time


class SmoothedValue:
    """Track a series over a sliding window + global average."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: collections.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "\t", print_fn=print):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and total:
                eta = iter_time.global_avg * (total - i)
                meters = self.delimiter.join(
                    f"{name}: {meter}" for name, meter in self.meters.items())
                self.print(self.delimiter.join([
                    header, f"[{i}/{total}]",
                    f"eta: {datetime.timedelta(seconds=int(eta))}",
                    meters, f"time: {iter_time}", f"data: {data_time}"]))
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))}"
                   + (f" ({elapsed / total:.4f} s / it)" if total else ""))
