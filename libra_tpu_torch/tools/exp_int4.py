"""Experiment: int4 weight streaming at decode on the card.

The port of the JAX package's ``tools/exp_int4.py``: a (4096, 11008)
decode matvec (4 rows of x) against STACKED (L = 8) group-int4 weights
with a rotating layer index. One layer is 23.9 MB, so 8 of them are far
beyond the 50 MB L2 and every call reads its weights from device memory.
Each row checks its output against x @ its own dequantized weights
(relative error under 0.05 of max|ref|), then prints its device time and
effective rate over the packed int4 bytes:

  PROD, PROD8        the port's int4_matmul kernel (B5), weight-only and
                     W4A8, on a layer view of the stacked buffer;
  D, D16             ops.int4_exp.int4_exp_d: weights dequantized to bf16
                     before the products, the +8 low-nibble bias taken off
                     by a correction over the group sums of x; the unpack
                     in 32- or 16-bit integers;
  C                  ops.int4_exp.int4_exp_c: the fp32 group scale on each
                     group's fp32 sum;
  int8               the int8_matmul kernel (B2) on per-column int8
                     weights, for comparison (rate over the int8 bytes);
  E                  ops.int4_exp.int4_exp_e: W4A8 (x quantized per row to
                     int8, exact integer group sums, the fp32 group scale on
                     each), the bytes unpacked in the int8 domain;
  H8                 ops.int4_exp.int4_exp_a8, body "h": the same function,
                     the bytes widened to int32 before the unpack;
  F8, F32R, FM8      body "f": only the low nibble unpacked, xo * q1 taken
                     as (xo * b - xo * u0) / 16 from the raw byte b; x
                     padded to 8 rows, to 32 (a (32, O) result), and with
                     the mask in the int8 domain;
  P<G>, P<G>a        B5 at group sizes 256, 512 and 2048;
  PAD, PADa, PADG<G> B5 with O padded to 11264 (W4A8 at G = 256, 512 for
                     PADG).

Timing: device time between CUDA events, n1 = 48 and n2 = 448 calls queued
behind a sleep on the device that outlasts the host's queuing, best of 3,
two-point difference. Run on the card:

    python -m libra_tpu_torch.tools.exp_int4 [variants]   # default: all
"""

from __future__ import annotations

import math
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from libra_tpu_torch.ops.int4_exp import int4_exp_a8, int4_exp_c, int4_exp_d, int4_exp_e
from libra_tpu_torch.ops.int4_matmul import dequant_int4, int4_matmul, pack_int4
from libra_tpu_torch.ops.int8_matmul import int8_matmul
from libra_tpu_torch.quantization import quantize_array

K, O, L = 4096, 11008, 8
GROUP = 128
PAD_TO = 1024          # PAD rows: O rounded up to a multiple (11008 -> 11264)
REJECT = 0.05          # relative error of a row that fails its numerics
ROWS = ("prod", "prod8", "d", "c", "int8", "e", "h8", "f8", "f32r", "fm8", "p256",
        "p256a", "p512", "p512a", "p2048", "p2048a", "pada", "pad", "padg256",
        "padg512", "d16")
# the W4A8 rows after E: (the script's name, body, bp, i8mask)
A8_ROWS = {"h8": ("H w4a8 i32-unpack bp8", "h", 8, False),
           "f8": ("F raw-byte 3dot bp8", "f", 8, False),
           "f32r": ("F raw-byte 3dot bp32", "f", 32, False),
           "fm8": ("F raw-byte 3dot bp8 i8mask", "f", 8, True)}
# the production kernel's other rows: (group, W4A8, O padded)
PROD_ROWS = {"p256": (256, False, False), "p256a": (256, True, False),
             "p512": (512, False, False), "p512a": (512, True, False),
             "p2048": (2048, False, False), "p2048a": (2048, True, False),
             "pada": (GROUP, True, True), "pad": (GROUP, False, True),
             "padg256": (256, True, True), "padg512": (512, True, True)}

Fn = Callable[[torch.Tensor, int], torch.Tensor]


def select(argv: Sequence[str]) -> list:
    """The rows that argv names (case-insensitive), in the experiment's
    order; all of them for an empty argv."""
    only = {a.lower() for a in argv}
    unknown = sorted(only - set(ROWS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; the rows are {list(ROWS)}")
    return [r for r in ROWS if not only or r in only]


@dataclass
class Inputs:
    W: torch.Tensor          # (L, K, O) fp32
    x: torch.Tensor          # (4, K) bf16
    packed: torch.Tensor     # (L, K/2, O) int8, group GROUP
    scales: torch.Tensor     # (L, K/GROUP, O) fp32
    yref: torch.Tensor       # x @ layer 0's dequantized weights, fp32
    yscale: float


def reference(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              group: int, cols: int):
    """x @ layer 0 of the stacked weights, dequantized in fp32, on the
    first `cols` columns; and the scale the relative error divides by."""
    y = x.float() @ dequant_int4(packed[0], scales[0], group)[:, :cols]
    return y, max(y.abs().max().item(), 1e-6)


def make_inputs(K: int = K, O: int = O, L: int = L, device="cuda",
                seed: int = 0) -> Inputs:
    """The experiment's inputs from numpy's RandomState(seed): W as L
    successive randn(K, O) * 0.02 layers (the same numbers as one
    randn(L, K, O)), then x = randn(4, K) in bf16. Each layer goes to the
    device on its own, so the host holds one layer at a time; the packing
    runs on the device."""
    rng = np.random.RandomState(seed)
    W = torch.empty((L, K, O), dtype=torch.float32, device=device)
    for li in range(L):
        W[li] = torch.from_numpy(rng.randn(K, O).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.randn(4, K).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
    packed, scales = pack_int4(W, group=GROUP)
    yref, yscale = reference(x, packed, scales, GROUP, O)
    return Inputs(W, x, packed, scales, yref, yscale)


def _queued_seconds(fn: Fn, x: torch.Tensor, n: int, layers: int,
                    cycles: int) -> Optional[float]:
    """Device seconds of n calls queued behind a sleep of `cycles`; None
    where the host took longer to queue them than the sleep lasted (the
    device may then have waited on the host)."""
    sleep, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    torch.cuda.synchronize()
    sleep.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for i in range(n):
        fn(x, i % layers)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if host_ms >= sleep.elapsed_time(start):
        return None
    return start.elapsed_time(end) / 1e3


def timed(fn: Fn, x: torch.Tensor, layers: int = L, n1: int = 48,
          n2: int = 448) -> float:
    """Device seconds of one call of fn(x, layer), the layer rotating over
    `layers`: best of 3 runs of n1 and of n2 calls, two-point difference
    (the fixed cost of a run cancels). The sleep ahead of each run starts
    near 30 ms and doubles until it covers the host's queuing."""
    cycles = 50_000_000

    def run(n):
        nonlocal cycles
        best = math.inf
        for _ in range(3):
            while (sec := _queued_seconds(fn, x, n, layers, cycles)) is None:
                if cycles >= 1_600_000_000:
                    raise RuntimeError("timed: the host queues slower than "
                                       "a 1 s sleep covers")
                cycles *= 2
            best = min(best, sec)
        return best

    run(n1), run(n2)                     # warm-up
    return (run(n2) - run(n1)) / (n2 - n1)


def report(name: str, sec: float, nbytes: int) -> None:
    print(f"{name}: {sec * 1e3:.4f} ms  {nbytes / sec / 1e9:.0f} GB/s effective",
          flush=True)


def run_case(name: str, build: Callable[[], Fn], x: torch.Tensor,
             yref: torch.Tensor, yscale: float, nbytes: int, layers: int,
             timer=timed) -> dict:
    """Build the row's fn, hold its layer-0 output against yref (raises
    past REJECT), time it, print both; returns the error and ms."""
    fn = build()
    y = fn(x, 0).float()[:x.shape[0], :yref.shape[1]]
    err = (y - yref).abs().max().item() / yscale
    print(f"{name} rel err {err:.2e}", flush=True)
    if not err <= REJECT:
        raise AssertionError(f"{name} REJECTED (numerics): rel err {err:.3g}")
    sec = timer(fn, x, layers)
    report(name, sec, nbytes)
    return dict(err=err, ms=sec * 1e3)


def build_d(inp: Inputs, wdt: torch.dtype = torch.int32) -> Fn:
    return lambda xx, li: int4_exp_d(xx, inp.packed, inp.scales, li, GROUP, wdt)


def build_c(inp: Inputs) -> Fn:
    return lambda xx, li: int4_exp_c(xx, inp.packed, inp.scales, li, GROUP)


def build_e(inp: Inputs) -> Fn:
    return lambda xx, li: int4_exp_e(xx, inp.packed, inp.scales, li, GROUP)


def build_h(inp: Inputs, bp: int = 8, i8mask: bool = False) -> Fn:
    return lambda xx, li: int4_exp_a8(xx, inp.packed, inp.scales, li, GROUP, "h", bp,
                                      i8mask)


def build_f(inp: Inputs, bp: int = 8, i8mask: bool = False) -> Fn:
    return lambda xx, li: int4_exp_a8(xx, inp.packed, inp.scales, li, GROUP, "f", bp,
                                      i8mask)


def _prod(pk: torch.Tensor, sc: torch.Tensor, g: int, a8: bool) -> Fn:
    return lambda xx, li: int4_matmul(xx, pk[li], sc[li], group=g, a8=a8)


def prod_g(inp: Inputs, g: int, a8: bool):
    """The production kernel on the weights packed at group size g."""
    pk, sc = pack_int4(inp.W, group=g)
    return pk, sc, _prod(pk, sc, g, a8)


def prod_pad(inp: Inputs, a8: bool, g: int = GROUP):
    """The production kernel with O zero-padded to a multiple of PAD_TO."""
    O_ = inp.W.shape[-1]
    Wp = torch.nn.functional.pad(inp.W, (0, -(-O_ // PAD_TO) * PAD_TO - O_))
    pk, sc = pack_int4(Wp, group=g)
    del Wp
    return pk, sc, _prod(pk, sc, g, a8)


def main(argv: Optional[Sequence[str]] = None, device="cuda", K: int = K,
         O: int = O, L: int = L, timer=timed) -> Dict[str, dict]:
    """Run the rows argv names (default: sys.argv[1:]; empty: all) and
    return each one's relative error and ms."""
    rows = select(sys.argv[1:] if argv is None else argv)
    inp = make_inputs(K, O, L, device)
    x, int4_bytes = inp.x, K * O // 2
    out = {}

    def case(row, name, build, yref=inp.yref, yscale=inp.yscale, nbytes=int4_bytes):
        out[row] = run_case(name, build, x, yref, yscale, nbytes, L, timer)

    for row in rows:
        if row in ("prod", "prod8"):
            a8 = row == "prod8"
            case(row, f"PROD {'w4a8' if a8 else 'weight-only'} stacked",
                 lambda: _prod(inp.packed, inp.scales, GROUP, a8))
        elif row in ("d", "d16"):
            wdt = torch.int16 if row == "d16" else torch.int32
            case(row, f"{row.upper()} signed-byte shift+mask i{wdt.itemsize * 8}",
                 lambda: build_d(inp, wdt))
        elif row == "c":
            case(row, "C unrolled groupdot", lambda: build_c(inp))
        elif row == "int8":
            q8 = quantize_array(inp.W, axis=-2)
            yref8 = x.float() @ (q8.q[0].float() * q8.scale[0])
            case(row, "int8 kernel ref",
                 lambda: (lambda xx, li: int8_matmul(xx, q8.q[li], q8.scale[li])),
                 yref8, max(yref8.abs().max().item(), 1e-6), K * O)
            del q8
        elif row == "e":
            case(row, "E w4a8 s8xs8 MXU dots", lambda: build_e(inp))
        elif row in A8_ROWS:
            name, body, bp, i8mask = A8_ROWS[row]
            build = build_h if body == "h" else build_f
            case(row, name, lambda: build(inp, bp, i8mask))
        else:
            # the P and PAD rows: a reference from the row's own group
            # size (against G = 128's, a G = 256 output would measure the
            # quantization's drift, ~0.1 relative, not the kernel)
            g, a8, pad = PROD_ROWS[row]
            pk, sc, fn = prod_pad(inp, a8, g) if pad else prod_g(inp, g, a8)
            yref, yscale = reference(x, pk, sc, g, O)
            mode = "w4a8" if a8 else "weight-only"
            name = (f"{row.upper()} {mode} O={pk.shape[-1]} G={g}" if pad
                    else f"P{g}{'a' if a8 else ''} prod {mode} G={g}")
            case(row, name, lambda: fn, yref, yscale)
            del pk, sc, fn
    return out


if __name__ == "__main__":
    main()
