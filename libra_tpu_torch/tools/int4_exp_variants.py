"""Experiment: variants of the int4 experiment's decode template, W4A8 mode.

Each variant is the CUDA source ``csrc/int4_exp.cu`` with a constant
changed by text substitution, built on its own into the package's build
directory; each runs E (the W4A8 function) and C through the source's
entries ``int4_exp_a8`` and ``int4_exp``, held against the plain versions
(1e-4 of max|ref|) and timed at the experiment's shape (K = 4096, O =
11008, G = 128, M = 4) on the 8 layers of a stacked buffer in turn, so
each call reads its 23.9 MB from device memory.

  kept     the source as it is (2 blocks an SM, 2 load batches in flight)
  sm3      3 blocks an SM (the register cap 80)
  nbuf3    3 load batches in flight a warp
  <v>+trace  variant <v> with a %globaltimer stamp at each phase of each
           block of the W4A8 mode (thread 0): start, x staged and its
           maxima taken, the cluster's maxima in, x quantized, the first
           tile's K loop done, its cluster barrier passed, the block's end.
           Prints the median time of each phase over the blocks, when
           blocks start and end, and how many are alive over the span.

The text edits, the stamps and the timing are ``tools/variants``'s.
Timing: ``variants.cuda_ms`` (20 calls behind a sleep on the device,
median of 5). Run on the card:

    python -m libra_tpu_torch.tools.int4_exp_variants [variants]
"""

from __future__ import annotations

import itertools
import re
import sys
from pathlib import Path

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops import int4_exp as E
from libra_tpu_torch.tools import variants as V
from libra_tpu_torch.tools.variants import cuda_ms

OUT = _build.BUILD_DIR / "variants"
K, O, L, G, M = 4096, 11008, 8, 128, 4
TOL = 1e-4
DEFAULT = ["kept", "sm3", "nbuf3", "kept", "kept+trace"]
PHASES = ["x staged, maxima", "cluster's maxima", "x quantized", "first tile's K loop",
          "first tile's barrier", "other tiles"]
STAMPS = len(PHASES) + 1
MAX_BLOCKS = 2048


def _edit(s: str, name: str) -> str:
    if name == "kept":
        return s
    if name == "sm3":
        return V.set_const(s, "BLOCKS_PER_SM", 3)
    if name == "nbuf3":
        return V.set_const(s, "NBUF", 3)
    if name == "trace":
        marks = [
            ('asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n',
             "  TS(0);\n", True),
            ('    asm volatile("barrier.cluster.arrive.aligned;\\n" ::: "memory");\n',
             "    TS(1);\n", False),
            ('asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");'
             '   // every block has started\n', "  TS(2);\n", True),
            ("  // this thread's x: row g, k 8 t", "  TS(3);\n", False),
            ("    // this lane's sums into shared memory", "    if (tile == blockIdx.x) TS(4);\n",
             False),
            ("    cluster.sync();\n", "    if (tile == blockIdx.x) TS(5);\n", True),
            ("  // Nothing reads or writes another block's shared memory", "  TS(6);\n", False)]
        return V.add_trace(s, '#include "split_k.cuh"\n', STAMPS, marks, cond="A8")
    raise ValueError(f"unknown variant {name!r}")


def source(name: str) -> Path:
    """Write variant `name` ('+'-joined edits) beside its headers."""
    return V.source(E.SOURCE, name, _edit, OUT / "int4_exp")


def kernels(path: Path):
    """E (int4_exp_a8, bp 8) and C (int4_exp, mode 1) of the variant's
    library, as (name, fn(x, li), plain(x, li))."""
    def e(x, packed, scales, li):
        return E._run("E", path, "int4_exp_a8", E._ARGTYPES_A8, x, packed, scales, li, G,
                      E.BP, E.BP, 1, 0)

    def c(x, packed, scales, li):
        return E._run("C", path, "int4_exp", E._ARGTYPES, x, packed, scales, li, G, E.BP, 1, 0)
    return [("E", e, E.int4_exp_a8_plain), ("C", c, E.int4_exp_c_plain)]


def trace(path: Path, fn, x, packed, scales, label: str) -> None:
    """Stamps of the last of the calls on all 8 layers
    (``variants.report``)."""
    st = V.stamps(path, MAX_BLOCKS, STAMPS, x.device)
    for li in range(L):
        fn(x, packed, scales, li)
    torch.cuda.synchronize()
    V.report(st, PHASES, label)


def main(names) -> dict:
    names = list(names) or DEFAULT
    card = V.card()
    dev = torch.device("cuda", 0)
    paths = {n: source(n) for n in dict.fromkeys(names)}
    for n, lib in zip(paths, _build.build_all(paths.values())):
        regs = [(re.search(r"decode_kernelILi(\d+)ELi(\d)E", e).groups(), r, spill)
                for e, r, spill in V.ptxas(lib, "int4_exp_decode_kernel")]
        print(f"{n}: decode kernels ((MT, mode), registers, spill store bytes): {regs} [{card}]")
    g = torch.Generator(device=dev).manual_seed(6)
    packed = torch.randint(-128, 128, (L, K // 2, O), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand((L, K // G, O), generator=g, device=dev) * 2e-2
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    times = {}
    for run, n in enumerate(names):
        for kname, fn, plain in kernels(paths[n]):
            label = f"{n} {kname} M={M} K={K} O={O} G={G}"
            if "trace" in n:
                if kname == "E":
                    trace(paths[n], fn, x, packed, scales, label)
                continue
            want = plain(x, packed, scales, 1, G)
            err = (fn(x, packed, scales, 1) - want).abs().max().item()
            tol = TOL * want.abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{label}: max_abs_err {err} over {tol}")
            turn = itertools.cycle(range(L))
            ms = cuda_ms(lambda: fn(x, packed, scales, next(turn)))
            times[f"{run} {label}"] = ms
            print(f"{label}: {ms:.4f} ms, max_abs_err {err:.3g} (tol {tol:.3g}) [{card}]")
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
