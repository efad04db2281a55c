"""Reduction of one `torch.profiler` session to what the per-layer metrics read.

A traced run profiles a steady stretch of whole requests or batches inside
its window.  From the session's raw records (the kineto results, not the
Python event tree, which costs tens of microseconds a record):

* the stretch: the benchmark's own `bench.stretch` range on the host;
* every device record (kernel, copy, set) clipped to it: the union of their
  intervals is the card's busy time, its complement the idle gaps;
* device time and record count by kernel name;
* each idle gap of 20 us or more labelled by what the host was doing at
  its midpoint: the innermost of the benchmark's own spans (given in
  `time.monotonic()` seconds) and the profiler's host records that covers
  it; shorter gaps, the card's own launch latency between back-to-back
  kernels, are summed under one label.

A session can lose its first device records once graphs have been
replayed, so the stretch starts behind `PADS` spin kernels that are left
out.  The callers check the records they need against the counts a stretch
must hold.
"""

from __future__ import annotations

import dataclasses
import time

PADS = 64
PAD_KERNEL = "spin_kernel"
STRETCH = "bench.stretch"
UNTRACED = "host: outside every span"
SHORT_GAP_NS = 20_000
SHORT = "device: gaps under 20 us (back-to-back launches)"


@dataclasses.dataclass
class Stretch:
    """What one profiled stretch held."""

    window_s: float
    busy_s: float
    kernels: dict  # device record name -> [count, seconds]
    gaps: dict  # host label -> idle seconds
    device_records: int
    t0: float  # the stretch in time.monotonic() seconds
    t1: float

    def kernel_time(self, names) -> tuple[int, float]:
        """(records, seconds) of the device records whose names contain any of `names` as a word."""
        count, secs = 0, 0.0
        for name, (n, s) in self.kernels.items():
            if any(_has_word(name, w) for w in names):
                count += n
                secs += s
        return count, secs

    def top_ops(self, k: int = 10) -> list:
        """The k device records that took most time: [[name, seconds], ...]."""
        rows = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:k]
        return [[name[:160], s] for name, (_, s) in rows]

    def top_gaps(self, k: int = 10) -> list:
        """The k host labels under which the card idled longest: [[label, seconds], ...]."""
        rows = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:k]
        return [[label[:160], s] for label, s in rows]


def _has_word(name: str, word: str) -> bool:
    i = name.find(word)
    while i >= 0:
        before = name[i - 1] if i > 0 else " "
        j = i + len(word)
        after = name[j] if j < len(name) else " "
        if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
            return True
        i = name.find(word, i + 1)
    return False


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def warm_profiler(torch) -> None:
    """One empty session: the profiler's first start in a process (CUPTI's set-up, seconds
    during which the host stalls) belongs to the run's set-up, not to its window."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        if torch.cuda.is_available():
            torch.cuda._sleep(1)
            torch.cuda.synchronize()


def profile_stretch(torch, body, spans) -> Stretch:
    """Run body() inside a profiler session and reduce the session.

    body() runs whole units of work and returns when the card has finished
    them, and returns the monotonic time from which the session is read
    (None: from its start).  A caller leaves out its first unit so: the
    first graph replay of a session can lose device records.  `spans` is a
    list the caller (and body) fills with (label, monotonic t0, t1) host
    spans.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            for _ in range(PADS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        mono0 = time.monotonic()
        with record_function(STRETCH):
            read_from = body()
        mono1 = time.monotonic()
    host, device, stretch = [], [], None
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if name == STRETCH or getattr(evt, "is_user_annotation", lambda: False)():
            if evt.device_type() != DeviceType.CUDA and name == STRETCH:
                stretch = (evt.start_ns(), evt.end_ns())
            continue  # a range's mirror on the device's timeline is no device work
        if evt.device_type() == DeviceType.CUDA:
            if PAD_KERNEL not in name:
                device.append((evt.start_ns(), evt.end_ns(), name))
        else:
            host.append((evt.start_ns(), evt.end_ns(), name))
    if stretch is None:
        raise RuntimeError(f"the profiler recorded no {STRETCH!r} range")
    s0, s1 = stretch
    offset_ns = s0 - int(mono0 * 1e9)  # kineto time = monotonic ns + offset
    if read_from is not None:
        s0 = max(s0, int(read_from * 1e9) + offset_ns)
        mono0 = read_from
    raw: dict = {}
    busy = []
    for a, b, name in device:
        a, b = max(a, s0), min(b, s1)
        if b <= a:
            continue
        entry = raw.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e9
        busy.append((a, b))
    kernels: dict = {}
    for name, (n, secs) in raw.items():
        entry = kernels.setdefault(torch._C._demangle(name) if len(name) > 1 else name, [0, 0.0])
        entry[0] += n
        entry[1] += secs
    merged = _union(busy)
    busy_ns = sum(b - a for a, b in merged)
    cover = [(int(t0 * 1e9) + offset_ns, int(t1 * 1e9) + offset_ns, label)
             for label, t0, t1 in spans] + host
    cover = [c for c in cover if c[1] >= s0 and c[0] <= s1]
    gaps: dict = {}
    edge = s0
    for a, b in merged + [[s1, s1]]:
        if a - edge >= SHORT_GAP_NS:
            mid = (edge + a) // 2
            inside = [(e - s, label) for s, e, label in cover if s <= mid <= e]
            label = min(inside)[1] if inside else UNTRACED
            gaps[label] = gaps.get(label, 0.0) + (a - edge) / 1e9
        elif a > edge:
            gaps[SHORT] = gaps.get(SHORT, 0.0) + (a - edge) / 1e9
        edge = max(edge, b)
    return Stretch(window_s=(s1 - s0) / 1e9, busy_s=busy_ns / 1e9, kernels=kernels, gaps=gaps,
                   device_records=len(busy), t0=mono0, t1=mono1)
