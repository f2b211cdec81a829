"""What the decode templates' variant tools share
(``decode_attention_variants``, ``int4_exp_variants``).

A variant is a kernel's CUDA source with a few constants or lines changed
by text substitution, written beside copies of the headers it includes
and built on its own. ``TRACE_DECL`` adds a ``%globaltimer`` stamp macro
``TS(i)`` (thread 0 of each block writes stamp i of the block) and a C
function ``set_trace`` that points it at a device buffer; ``stamps`` sets
that buffer, ``report`` prints what the stamps of the last call say.
Timing: ``cuda_ms``, device time between CUDA events over n calls queued
behind a sleep on the device, median of reps.
"""

from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
from pathlib import Path

import torch

from libra_tpu_torch.ops import _build

TRACE_DECL = r'''
__device__ unsigned long long* g_trace;
extern "C" int set_trace(void* p) { return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }
#define TS(i) do { if ({cond}threadIdx.x == 0) { unsigned long long t_; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
  const size_t b_ = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x; \
  g_trace[b_ * {n} + (i)] = t_; } } while (0)
'''


def sub(s: str, old: str, new: str) -> str:
    """s with its first `old` replaced by `new`; raises if it has none."""
    if old not in s:
        raise ValueError(f"the source has no {old!r}")
    return s.replace(old, new, 1)


def set_const(s: str, name: str, value: int) -> str:
    """s with ``constexpr int name = ...;`` set to value."""
    s2 = re.sub(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", s, count=1)
    if s2 == s and f"constexpr int {name} = {value};" not in s:
        raise ValueError(f"the source has no constant {name}")
    return s2


def add_trace(s: str, include: str, n: int, marks, cond: str = "") -> str:
    """s with the stamp macro after its line `include` (n stamps a block,
    taken where `cond` holds) and a stamp at each (anchor, stamp, after)
    of marks: the stamp's text goes after the anchor or before it."""
    decl = TRACE_DECL.replace("{cond}", f"{cond} && " if cond else "").replace("{n}", str(n))
    s = sub(s, include, include + decl)
    for anchor, stamp, after in marks:
        s = sub(s, anchor, anchor + stamp if after else stamp + anchor)
    return s


def source(src: Path, name: str, edit, out: Path) -> Path:
    """Write variant `name` of src (edits joined by '+', each applied by
    edit(text, part)) into out/<name>, beside copies of the csrc headers
    it includes (with quotes, followed recursively)."""
    text = src.read_text()
    for part in name.split("+"):
        text = edit(text, part)
    d = out / name.replace("+", "_")
    d.mkdir(parents=True, exist_ok=True)
    todo, seen = [text], set()
    while todo:
        for h in re.findall(r'^\s*#\s*include\s+"([^"]+)"', todo.pop(), re.MULTILINE):
            if h not in seen:
                seen.add(h)
                todo.append((_build.CSRC / h).read_text())
                (d / h).write_text(todo[-1])
    path = d / src.name
    path.write_text(text)
    return path


def ptxas(lib: Path, kernel: str) -> list:
    """(entry name, registers, spill store bytes) of each entry of the
    build whose name holds `kernel`, from ptxas' report in the log beside
    the library."""
    out = []
    for e in lib.with_suffix(".log").read_text().split("Compiling entry function")[1:]:
        head = e.splitlines()[0].strip(" '")
        if kernel in head:
            out.append((head, int(re.search(r"Used (\d+) registers", e).group(1)),
                        int(re.search(r"(\d+) bytes spill stores", e).group(1))))
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 20, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def stamps(path: Path, blocks: int, n: int, device) -> torch.Tensor:
    """A zeroed (blocks, n) int64 buffer on the device, which the variant
    built from `path` (with ``add_trace``) stamps from then on."""
    lib = ctypes.CDLL(str(_build.build(path)))
    lib.set_trace.argtypes, lib.set_trace.restype = [ctypes.c_void_p], ctypes.c_int
    st = torch.zeros((blocks, n), dtype=torch.int64, device=device)
    if lib.set_trace(st.data_ptr()) != 0:
        raise RuntimeError("set_trace failed")
    return st


def report(st: torch.Tensor, phases, label: str) -> None:
    """The stamps of the last call (after a synchronize): the median of
    each phase (stamp i to i + 1) over the blocks, when blocks start and
    end, and how many are alive at each tenth of the span."""
    st = st.cpu()
    st = st[st[:, 0] > 0]
    t = (st - st[:, 0].min()).double() / 1e3                     # us
    med = [statistics.median((t[:, i + 1] - t[:, i]).tolist()) for i in range(len(phases))]
    span = t[:, -1].max().item()

    def quant(v):
        v = sorted(v.tolist())
        return " ".join(f"{v[min(len(v) - 1, int(f * len(v)))]:.2f}" for f in (0, .25, .5, .75, 1))

    alive = [int(((t[:, 0] <= p) & (t[:, -1] >= p)).sum())
             for p in (span * k / 10 for k in range(11))]
    print(f"  {label} trace: span {span:.2f} us, {len(st)} blocks; median us: "
          + ", ".join(f"{p} {m:.2f}" for p, m in zip(phases, med)))
    print(f"    starts (0 .25 .5 .75 1): {quant(t[:, 0])}; ends: {quant(t[:, -1])}; "
          f"alive at 0, 10, ..., 100% of the span: {alive}")
