"""Reduce a ``torch.profiler`` trace of the traced window to what the
per-layer metrics read: the device's kernels (name, interval, the host
ranges that launched them), the union of device activity, the idle gaps
with the host op that was running, and the breakdown line.

The window is the host range ``WINDOW`` that the loop opens around its
traced steps; device activity is clipped to it. Device activity is every
kernel, copy and fill the profiler recorded on the card; a launch is a
kernel (copies and fills are not counted).
"""

from __future__ import annotations

import bisect
from typing import List, NamedTuple, Tuple

WINDOW = "gsbench.window"
#: device events that are not kernel launches
NON_KERNELS = ("Memcpy", "Memset")


class Kernel(NamedTuple):
    name: str
    start_us: float
    end_us: float
    ranges: Tuple[str, ...]  # names of the host ops around its launch


class Trace(NamedTuple):
    kernels: List[Kernel]  # launches, in start order
    busy_s: float  # union of device activity over the window
    window_s: float  # the window's length
    gaps: List[Tuple[str, float]]  # (host op, idle seconds) per gap


def merged(spans):
    """The union of (start, end) spans as sorted disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profiler():
    """A ``torch.profiler.profile`` of the CPU and, with a card, CUDA
    activity; the traced steps run inside it and inside ``window()``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def window():
    """The host range that marks the traced window."""
    import torch

    return torch.profiler.record_function(WINDOW)


def _ancestors(e) -> Tuple[str, ...]:
    names = []
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    return tuple(names)


def reduce_profile(prof) -> Trace:
    """The window's kernels, busy time and idle gaps from a finished
    profile."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    win = [e for e in cpu if e.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0 = min(e.time_range.start for e in win)
    w1 = max(e.time_range.end for e in win)
    # a kernel shares its id with the runtime call that launched it
    # (cudaLaunchKernel and kin), whose parents are the host ops around it
    launches = {e.id: e for e in cpu if e.name.startswith("cu")}
    # host ranges (``record_function``) have device-side mirrors: not work
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans, kernels = [], []
    for e in device:
        a = max(e.time_range.start, w0)
        b = min(e.time_range.end, w1)
        if b <= a:
            continue
        spans.append((a, b))
        if e.name.startswith(NON_KERNELS):
            continue
        parent = launches.get(e.id)
        kernels.append(Kernel(e.name, e.time_range.start, e.time_range.end,
                              _ancestors(parent)))
    kernels.sort(key=lambda k: k.start_us)
    busy_iv = merged(spans)
    busy = sum(b - a for a, b in busy_iv)
    # idle gaps inside the window, labelled by the innermost host op that
    # was running at the gap's start (runtime API calls skipped)
    gaps, t = [], w0
    for a, b in busy_iv:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted((e for e in cpu if not e.name.startswith("cu")
                   and e.name != WINDOW),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    labelled = []
    for a, b in gaps:
        i = bisect.bisect_right(starts, a)
        label = "(no host op)"
        # the latest-starting op that still runs at the gap's start
        for e in reversed(host[max(0, i - 400):i]):
            if e.time_range.end > a:
                label = e.name
                break
        labelled.append((label, (b - a) / 1e6))
    return Trace(kernels, busy / 1e6, (w1 - w0) / 1e6, labelled)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each at most ``top`` entries, in seconds."""
    ops = {}
    for k in tr.kernels:
        ops[k.name] = ops.get(k.name, 0.0) + (k.end_us - k.start_us) / 1e6
    gaps = {}
    for name, s in tr.gaps:
        gaps[name] = gaps.get(name, 0.0) + s
    return {
        "device_ops": [[n, s] for n, s in
                       sorted(ops.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, s] for n, s in
                      sorted(gaps.items(), key=lambda x: -x[1])[:top]],
    }


def kernel_ms(tr: Trace, match) -> float:
    """Summed device milliseconds of the kernels whose record satisfies
    ``match``."""
    return sum(k.end_us - k.start_us for k in tr.kernels if match(k)) / 1e3

