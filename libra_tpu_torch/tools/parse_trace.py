"""Sum the device time of each kernel in torch.profiler chrome traces.

    python -m libra_tpu_torch.tools.parse_trace DIR

Reads every ``*.json`` trace under DIR (``profile_{prefill,decode,train}``
write them) and prints, per trace, the kernels' summed device time, then
each kernel's summed time and count, the TOP largest first. A trace with no
device kernels (a CPU run) lists its host operators instead.
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path
from typing import Dict, List, Tuple

KERNEL_CATS = ("kernel",)          # the card's kernels (CUPTI)
HOST_CATS = ("cpu_op",)            # torch operators on the host
TOP = 40                           # kernels listed a trace


def summarize(path) -> Tuple[str, float, List[Tuple[str, float, int]]]:
    """(category, total ms, [(name, ms, count)] of the TOP largest) of one
    trace: its kernels, or its host operators when it has none."""
    events = json.loads(Path(path).read_text())
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    for cat, cats in (("kernel", KERNEL_CATS), ("cpu_op", HOST_CATS)):
        total: Dict[str, float] = collections.Counter()
        count: Dict[str, int] = collections.Counter()
        for ev in events:
            if ev.get("ph") == "X" and ev.get("cat") in cats:
                total[ev["name"]] += float(ev.get("dur", 0.0)) / 1e3   # us -> ms
                count[ev["name"]] += 1
        if total:
            rows = [(n, ms, count[n]) for n, ms in total.most_common(TOP)]
            return cat, sum(total.values()), rows
    return "none", 0.0, []


def main(argv=None) -> None:
    parser = argparse.ArgumentParser("libra_tpu_torch trace summary")
    parser.add_argument("trace_dir")
    args = parser.parse_args(argv)
    paths = sorted(Path(args.trace_dir).rglob("*.json"))
    print("trace files:", [str(p) for p in paths])
    for path in paths:
        cat, total, rows = summarize(path)
        if not rows:
            continue
        what = "device kernels" if cat == "kernel" else "host operators (no device kernels)"
        print(f"\n== {path.name}: {what}, total {total:.3f} ms ==")
        for name, ms, n in rows:
            print(f"  {ms:9.3f} ms  x{n:<6} {name[:110]}")


if __name__ == "__main__":
    main()
