"""Reduce a jax.profiler trace to per-op device time on the GPU.

Reads the newest `*.xplane.pb` under a trace directory with
jax.profiler.ProfileData and keeps the GPU's device planes (names
"/device:GPU:<n>"). Op times come from the "XLA Ops" line when the plane
has one, else from every stream line that is not a module or step line.
Busy time is the union of those op intervals; the idle share is 1 - busy
over the window from the first op start to the last op end.
"""

from __future__ import annotations

import glob
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class DeviceTimes:
    op_ms: dict = field(default_factory=lambda: defaultdict(float))
    op_calls: dict = field(default_factory=lambda: defaultdict(int))
    line_ms: dict = field(default_factory=lambda: defaultdict(float))
    busy_ms: float = 0.0
    window_ms: float = 0.0

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_ms / self.window_ms if self.window_ms else 0.0


def device_times(trace_dir: str) -> DeviceTimes:
    import jax

    files = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not files:
        raise SystemExit(f"no trace written under {trace_dir}")
    prof = jax.profiler.ProfileData.from_file(files[-1])
    out, spans = DeviceTimes(), []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        op_lines = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines
            if "Module" not in ln.name and "Step" not in ln.name
        ]
        for ln in lines:
            for ev in ln.events:
                out.line_ms[f"{plane.name} | {ln.name}"] += ev.duration_ns / 1e6
        for ln in op_lines:
            for ev in ln.events:
                out.op_ms[ev.name] += ev.duration_ns / 1e6
                out.op_calls[ev.name] += 1
                spans.append((ev.start_ns, ev.end_ns))
    if not spans:
        raise SystemExit("no GPU device events in the trace")
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    out.busy_ms = (busy + cur_e - cur_s) / 1e6
    out.window_ms = (spans[-1][1] - spans[0][0]) / 1e6
    return out


def print_table(t: DeviceTimes, reps: int, top: int = 30) -> None:
    """Markdown table of the top ops, per repetition."""
    total = sum(t.op_ms.values())
    for name, ms in sorted(t.line_ms.items()):
        print(f"# line {name}: {ms / reps:.3f} ms/rep")
    print(
        f"# device op time {total / reps:.3f} ms/rep; busy "
        f"{t.busy_ms / reps:.3f} ms/rep of a {t.window_ms / reps:.3f} ms/rep "
        f"window (idle share {t.idle_share:.3f})"
    )
    print("| op | ms/rep | calls/rep | % |")
    print("|---|---|---|---|")
    for name, ms in sorted(t.op_ms.items(), key=lambda kv: -kv[1])[:top]:
        print(
            f"| {name[:90]} | {ms / reps:8.4f} | {t.op_calls[name] // reps} |"
            f" {100 * ms / max(total, 1e-9):5.1f} |"
        )
