"""Observability: structured timers + jax profiler traces.

The reference instruments with ad-hoc std::chrono prints (per-train-call ms,
tracking/mapping medians — SURVEY.md §5) and itself recommends Nsight for
real numbers (ref nerf_model.cu:1660). Here: a Timer registry with the same
console counters plus median/mean summaries, a context manager around
jax.profiler for real device traces, and `scope_times`, which reduces such
a trace to device time per `jax.named_scope` (models/nerf.py names
"encode" and "mlp").
"""

from __future__ import annotations

import contextlib
import re
import statistics
import time
from collections import defaultdict


class Timers:
    """Named wall-clock spans with median/mean summaries (host-side; device
    work must be synced by the caller with jax.block_until_ready)."""

    def __init__(self):
        self.records: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.records[name].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            out[name] = {
                "count": len(vals),
                "mean_ms": 1e3 * statistics.fmean(vals),
                "median_ms": 1e3 * statistics.median(vals),
                "total_s": sum(vals),
            }
        return out

    def report(self) -> str:
        # mirrors the reference's "median tracking time / mean tracking time"
        # console style (ref mono_tum.cc:120-122)
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name}: median {s['median_ms']:.2f} ms | mean "
                f"{s['mean_ms']:.2f} ms | n={s['count']}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace around a block (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_paths(hlo_text: str) -> dict[str, list[str]]:
    """Optimized HLO text -> {instruction name: op_name paths}. A fusion's
    paths are its own plus those of every instruction it calls, so a
    kernel named after the fusion maps back to the scopes it fused."""
    comp_paths: dict[str, list[str]] = defaultdict(list)
    own: dict[str, tuple[list[str], list[str]]] = {}
    comp = None
    for line in hlo_text.splitlines():
        s = line.strip()
        head = s.split("(", 1)[0]
        if s.endswith("{") and " = " not in head:
            comp = head.replace("ENTRY", "").strip().lstrip("%").strip()
            continue
        if " = " not in head:
            continue
        name = head.split(" = ", 1)[0].replace("ROOT", "").strip().lstrip("%")
        paths = _OP_NAME.findall(s)
        if comp is not None:
            comp_paths[comp].extend(paths)
        own[name] = (paths, _CALLS.findall(s))
    return {name: paths + [p for c in calls for p in comp_paths.get(c, [])]
            for name, (paths, calls) in own.items()}


def _union_ns(intervals: list[tuple[int, int]]) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def scope_times(xplane_path: str, hlo_texts: list[str],
                scopes: tuple[str, ...] = ("encode", "mlp"),
                plane_prefix: str = "/device:GPU", top: int = 30) -> dict:
    """Device time per named scope from a jax.profiler trace.

    Counts the events that carry an `hlo_op` stat on planes whose name
    starts with `plane_prefix`; an event belongs to the first scope whose
    name is a path component of one of its op_name paths (a fusion of two
    scopes counts for the first), else to "other". Returns kernel ns per
    scope and in total, the window from the first start to the last end,
    the busy ns (union of the kernel intervals), and the `top` HLO ops by
    device time with their scope, so the attribution can be read."""
    import jax

    paths: dict[str, list[str]] = {}
    for text in hlo_texts:
        paths.update(hlo_op_paths(text))
    pats = [re.compile(r"(^|[/(])" + re.escape(sc) + r"($|[/)])")
            for sc in scopes]
    per = dict.fromkeys(scopes + ("other",), 0)
    by_op: dict[str, list] = {}
    lines: dict[str, int] = defaultdict(int)
    intervals = []
    data = jax.profiler.ProfileData.from_file(xplane_path)
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats) if ev.stats else {}
                op = stats.get("hlo_op")
                if not op:
                    continue
                lines[line.name] += 1
                dur = int(ev.duration_ns)
                start = int(ev.start_ns)
                intervals.append((start, start + dur))
                if op not in by_op:
                    hit = "other"
                    for sc, pat in zip(scopes, pats):
                        if any(pat.search(p) for p in paths.get(op, [])):
                            hit = sc
                            break
                    by_op[op] = [0, 0, hit, ev.name, paths.get(op, [])[:2]]
                by_op[op][0] += dur
                by_op[op][1] += 1
                per[by_op[op][2]] += dur
    total = sum(per.values())
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
              if intervals else 0)
    ranked = sorted(by_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernel_ns": per, "total_kernel_ns": total, "window_ns": window,
            "busy_ns": _union_ns(intervals), "n_events": len(intervals),
            "lines": dict(lines),
            "top_ops": [{"hlo_op": op, "ns": v[0], "count": v[1],
                         "scope": v[2], "kernel": v[3], "paths": v[4]}
                        for op, v in ranked]}
