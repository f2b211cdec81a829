"""Experiment: variants of the rows template (``csrc/rows_mma.cuh``), the
B2 and B5 kernels' template for 8 < M <= 160 rows of x.

Each variant is B5's and B2's sources (``csrc/int4_matmul.cu``,
``csrc/int8_matmul.cu``) with the template's header written into them and
a constant or a line changed by text substitution, built on its own into
the package's build directory. Each runs the three weight modes (int8,
int4 weight-only, int4 W4A8) at the split prompt pass's rows, M = 128 on
4096 -> 11008 (G = 128, a zero row of x), through the sources' own entry
points, held against the plain versions (``chip_smoke.check``: bf16
rounding of the output) and timed on the 8 layers of a stacked buffer in
turn, so each call reads its weights from device memory; with the split
the launch picks (cluster size KS, clusters resident), ptxas' registers
and spills and the SASS instructions (cuobjdump) of the rows kernels.

  kept       the sources as they are
  ks2, ks4, ks8  the split of K forced to KS blocks a cluster
  ns4        a ring of 4 stage slots (int4 only: B2's 4 slots and its
             receive buffers exceed the shared memory at KS = 8)
  skip       a branch around each n8 tile's products past M (the first
             version; the kept one multiplies the zero rows of x there, so
             the unrolled units are straight-line code)
  u1         the stage's 4 units in a loop that is not unrolled
  <v>+trace  variant <v> with a %globaltimer stamp at each phase of each
             block (thread 0): start, the first stage in shared memory,
             the second one in, the second one's products done, the
             first tile's K loop done, its cluster reduction and epilogue
             done, the block's end. Prints the median time of
             each phase over the blocks, when blocks start and end, and
             how many are alive over the span.

The text edits, the stamps and the timing are ``tools/variants``'s.
Timing: ``variants.cuda_ms`` (20 calls behind a sleep on the device,
median of 5). Run on the card:

    python -m libra_tpu_torch.tools.rows_variants [variants]
"""

from __future__ import annotations

import ctypes
import itertools
import re
import sys
from pathlib import Path

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops import int4_matmul as I4
from libra_tpu_torch.ops import int8_matmul as I8
from libra_tpu_torch.tools import variants as V
from libra_tpu_torch.tools.variants import cuda_ms

OUT = _build.BUILD_DIR / "variants"
HEADER = _build.CSRC / "rows_mma.cuh"
M, K, F, L, G = 128, 4096, 11008, 8, 128
DEFAULT = ["kept", "skip", "ks2", "ks8", "ns4", "u1", "kept", "kept+trace"]
MODES = ("int8", "int4", "int4 a8")
PHASES = ["first stage in", "stage 0 and the wait for stage 1", "stage 1",
          "the first tile's other stages", "first tile's reduction", "other tiles"]
STAMPS = len(PHASES) + 1
MAX_BLOCKS = 2048
_SPLIT = (ctypes.c_int,) * 3 + (ctypes.POINTER(ctypes.c_int),) * 2


def _edit(s: str, name: str) -> str:
    if name == "kept":
        return s
    ks = re.fullmatch(r"ks(\d)", name)
    if ks:   # every other split costs more than any
        return V.sub(s, "  if (e == cudaSuccess) *cost = ",
                     f"  if (e == cudaSuccess && KS != {ks.group(1)}) *cost = 1LL << 40;\n"
                     f"  else if (e == cudaSuccess) *cost = ")
    if name == "ns4":
        return V.set_const(s, "NS", 4)
    if name == "skip":      # a branch around each n8 tile's products past M
        s2 = re.sub(r"(\n(\s*)for \(int j = 0; j < NJ; \+\+j\) \{)(?=\n\s*const uint[24] xv)",
                    r"\1\n\2  if (j >= nj) break;", s)
        if s2 == s:
            raise ValueError("the source has no n8 tile loop")
        return s2
    if name == "u1":        # the stage's units in a loop, not unrolled
        return V.sub(s, "#pragma unroll\n    for (int u = 0; u < UNITS; ++u) {",
                     "#pragma unroll 1\n    for (int u = 0; u < UNITS; ++u) {")
    if name == "trace":
        marks = [
            ("  cluster_arrive();   // this block has started", "  TS(0);\n", False),
            ("    __syncthreads();   // item it is in place, and item it - 1's slot is free\n",
             "    if (it == 0) TS(1);\n    if (it == 1) TS(2);\n", True),
            ("    if (ks == ns - 1) {\n", "    if (it == 1) TS(3);\n", False),
            ("      finish_tile<Mode, KS>(", "      if (it == ns - 1) TS(4);\n", False),
            ("it + 1 < total);\n", "      if (it == ns - 1) TS(5);\n", True),
            ("  // No block reads or writes another's shared memory after its last",
             "  TS(6);\n", False),
        ]
        return V.add_trace(s, '#include "split_k.cuh"\n', STAMPS, marks)
    raise ValueError(f"unknown variant part {name!r}")


def source(src: Path, name: str) -> Path:
    """Variant `name` of src (a source that includes the rows template),
    with the header's text in place of its include line."""
    def edit(text: str, part: str) -> str:
        if '#include "rows_mma.cuh"\n' in text:
            text = V.sub(text, '#include "rows_mma.cuh"\n', HEADER.read_text())
        return _edit(text, part)
    return V.source(src, name, edit, OUT)


def kernels(i4: Path, i8: Path, stream: int):
    """The three modes' calls of a variant's builds: fn(x, layer) -> out."""
    f8 = _build.function(i8, "int8_matmul", I8._ARGTYPES)
    f4 = _build.function(i4, "int4_matmul", I4._ARGTYPES)
    ws_fn = _build.function(i4, "int4_matmul_workspace", I4._WS_ARGTYPES)

    def int8(x, w):
        out = torch.empty((x.shape[0], w["q"].shape[1]), dtype=x.dtype, device=x.device)
        _build.check_launch(I8._launch(f8, x, w["q"], w["s"], out, stream), "int8_matmul")
        return out

    def int4(a8):
        def call(x, w):
            out = torch.empty((x.shape[0], w["p"].shape[1]), dtype=x.dtype, device=x.device)
            n = ws_fn(x.shape[0], x.shape[1], G, int(a8))
            ws = torch.empty(n, dtype=torch.uint8, device=x.device) if n else None
            _build.check_launch(I4._launch(f4, x, w["p"], w["s4"], out, G, a8, ws, stream),
                                "int4_matmul")
            return out
        return call
    return {"int8": int8, "int4": int4(False), "int4 a8": int4(True)}


def split_of(lib_src: Path, mode: str) -> tuple:
    """(KS, clusters resident) the variant's launch picks for the rows."""
    ks, n = ctypes.c_int(0), ctypes.c_int(0)
    if mode == "int8":
        e = _build.function(lib_src, "int8_matmul_rows_split", _SPLIT)(M, K, F, ks, n)
    else:
        fn = _build.function(lib_src, "int4_matmul_rows_split",
                             (ctypes.c_int,) * 4 + (ctypes.POINTER(ctypes.c_int),) * 2)
        e = fn(M, K, F, int(mode == "int4 a8"), ks, n)
    if e != 0:
        raise RuntimeError(f"rows_split failed: CUDA error {e}")
    return ks.value, n.value


def main(names) -> dict:
    from chip_smoke import check, sass_mix
    card = V.card()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    layers = [dict(q=torch.randint(-127, 128, (K, F), generator=g, device=dev, dtype=torch.int8),
                   s=torch.rand((1, F), generator=g, device=dev) * 2e-3,
                   p=torch.randint(-128, 128, (K // 2, F), generator=g, device=dev,
                                   dtype=torch.int8),
                   s4=torch.rand((K // G, F), generator=g, device=dev) * 2e-2)
              for _ in range(L)]
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    x[3] = 0
    w0 = layers[0]
    want = {"int8": I8.int8_matmul_plain(x.float(), w0["q"], w0["s"]),
            "int4": I4.int4_matmul_plain(x.float(), w0["p"], w0["s4"], G),
            "int4 a8": I4.int4_matmul_plain(x.float(), w0["p"], w0["s4"], G, a8=True)}
    paths = {n: (source(I4.SOURCE, n), source(I8.SOURCE, n)) for n in dict.fromkeys(names)}
    _build.build_all([p for pair in paths.values() for p in pair])
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for name in names:
        i4, i8 = paths[name]
        for path in (i4, i8):
            lib = _build.build(path)
            sizes = {e: mix["all"] for e, mix in sass_mix(lib).items() if "rows_kernel" in e}
            print(f"{name} {path.stem}: " + "; ".join(
                f"{e.split('rows4Mode')[-1][:12]} {r} registers, {sp} B spilled, "
                f"{sizes.get(e.split(chr(39))[0], 0)} SASS instructions"
                for e, r, sp in V.ptxas(lib, "rows_kernel")) + f" [{card}]")
        calls = kernels(i4, i8, stream)
        for mode in MODES:
            if name.startswith("ns4") and mode == "int8":
                continue
            fn = calls[mode]
            lib_src = i4 if mode != "int8" else i8
            if name.endswith("+trace"):   # the stamps' buffer before the first call
                st = V.stamps(lib_src, MAX_BLOCKS, STAMPS, dev)
            got = fn(x, w0)
            torch.cuda.synchronize()
            label = f"{name} {mode} M={M} {K}->{F}"
            err = check(label, got, want[mode], card)
            ks, n = split_of(lib_src, mode)
            turn = itertools.cycle(layers)
            ms = cuda_ms(lambda: fn(x, next(turn)))
            print(f"{label}: {ms:.4f} ms, KS = {ks}, {n} clusters resident [{card}]")
            out[(name, mode)] = dict(ms=ms, err=err, ks=ks, clusters=n)
            if name.endswith("+trace"):
                st.zero_()
                fn(x, w0)
                torch.cuda.synchronize()
                V.report(st, PHASES, f"{name} {mode}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:] or DEFAULT)
