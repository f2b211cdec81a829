"""Experiment: variants of the int8 decode-attention kernel's decode and
wide templates.

Each variant is the CUDA source ``csrc/decode_attention.cu`` with a few
constants or lines changed by text substitution, built on its own into the
package's build directory; each is held against the plain version (bf16 q)
and timed, bridge on and off, on layer views of a stacked (2, ...) cache
that rotate so each call reads its cache from device memory (two bridged
layers exceed the 50 MB L2): a decode-template variant at B = 4, H = 32,
S = 674 (610 + 64), N = 1 and 8; a wide-template variant (its name starts
with "w") at a chat turn's delta, N = 64 query rows at slots 672 onward of
S = 1024, keys past them masked; "kept" at both.

  kept     the source as it is
  first    the template's first version: clusters of 8, 6-unit passes, no
           register cap
  r4       clusters of 4, 6-unit passes, no register cap
  p3       clusters of 8, 3-unit passes, no register cap
  vlate    clusters of 8, 6-unit passes, no register cap, one stage buffer:
           V fetched only once the scores are taken
  r4p3     clusters of 4, 3-unit passes, no register cap
  <v>+trace  variant <v> with a %globaltimer stamp at each phase of each
           block (thread 0): the median time of each phase, when blocks
           start and end, and how many are alive over the kernel's span
  w8       the wide template with clusters of 8
  w3       the wide template with a third stage buffer
  <v>+wtrace  variant <v> with the stamps in the wide template's phases

Timing: ``variants.cuda_ms`` (20 calls behind a sleep on the device,
median of 5); the share printed is of the bound on every slot's bytes
(``chip_smoke.py`` counts only the needed slots). Run on the card:

    python -m libra_tpu_torch.tools.decode_attention_variants [variants]
"""

from __future__ import annotations

import ctypes
import itertools
import sys
from pathlib import Path

import torch

from libra_tpu_torch.ops import _build
from libra_tpu_torch.ops import decode_attention as DA
from libra_tpu_torch.tools import variants as V
from libra_tpu_torch.tools.variants import cuda_ms, sub

OUT = _build.BUILD_DIR / "variants"
HBM_BPS = 3.35e12        # H100 SXM, NVIDIA's data sheet
B, H, D, L = 4, 32, 128, 2
DEFAULT = ["kept", "first", "r4", "p3", "vlate", "r4p3", "kept+trace"]
# (N, S, first query slot) of each template's cases
CASES = {"decode": [(1, 674, 610), (8, 674, 610)], "wide": [(64, 1024, 672)]}
PHASES = ["K landed", "scores", "max exchange", "sums and P", "V landed", "values",
          "merge send + sync", "merge"]
WIDE_PHASES = ["K landed", "scores", "max exchange", "sums exchange", "P", "V landed",
               "values", "merge send + sync", "merge"]


def _consts(s: str, ranks: int, units: int, cap: int) -> str:
    s = V.set_const(s, "RANKS", ranks)
    s = V.set_const(s, "PASS_UNITS", units)
    return V.set_const(s, "BLOCKS_PER_SM", cap)


def _wide(s: str, name: str, value: int) -> str:
    """s with the wide template's ``constexpr int name`` set to value."""
    a = s.index("namespace wide {")
    z = s.index("}  // namespace wide")
    return s[:a] + V.set_const(s[a:z], name, value) + s[z:]


def _edit(s: str, name: str) -> str:
    if name == "kept":
        return s
    if name == "w8":
        return _wide(s, "RANKS", 8)
    if name == "w3":
        return _wide(s, "NSTAGE", 3)
    if name in ("first", "r4", "p3", "r4p3"):
        return _consts(s, 4 if name.startswith("r4") else 8, 3 if name.endswith("p3") else 6, 1)
    if name == "vlate":
        s = _consts(s, 8, 6, 1)
        s = sub(s, "m.ss = 2 * m.buf;", "m.ss = m.buf;")
        for old in ("base + (st & 1) * L.buf", "base + (p & 1) * L.buf",
                    "base + ((npass + p) & 1) * L.buf"):
            s = sub(s, old, "base")
        s = sub(s, "    fetch(0);\n    fetch(1);\n", "    fetch(0);\n")
        s = sub(s, "fetch(p + 2);", "fetch(p + 1);")
        s = sub(s, "fetch(npass + p + 2);", "fetch(npass + p + 1);")
        return s.replace("fmma::cp_wait<1>();", "fmma::cp_wait<0>();")
    if name == "trace":
        marks = [
            ('asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n\n',
             "TS(0);\n"),
            ("    const uint32_t buf = base + (p & 1) * L.buf;\n", "if (p == 0) TS(1);\n"),
            ("  // --- softmax:", "TS(2);\n"),
            ("  float e2[2];", "TS(3);\n"),
            ("  // --- values: warp w", "TS(4);\n"),
            ("    const uint32_t buf = base + ((npass + p) & 1) * L.buf;\n",
             "if (p == 0) TS(5);\n"),
            ("  // --- merge:", "TS(6);\n"),
            ("#pragma unroll\n  for (int i = tid; i < ROWS * OUT_COLS;", "TS(7);\n"),
            ("  // Every remote write precedes", "TS(8);\n")]
        return V.add_trace(s, '#include "flash_mma.cuh"\n', 9,
                           [(a, st, a.endswith("\n")) for a, st in marks])
    if name == "wtrace":
        marks = [
            ("  float* recv = Ss;                                      "
             "// [rank][row][OUT_COLS], last\n", "TS(0);\n"),
            ("    const uint32_t kbuf = (p % NSTAGE) * L.buf;\n", "if (p == 0) TS(1);\n"),
            ("  // --- softmax: warp w takes rows SROWS w", "TS(2);\n"),
            ("  float es[SROWS];", "TS(3);\n"),
            ("  // p = bf16((e / L) * vs), p_b", "TS(4);\n"),
            ("  // --- values: warp (wr, c) takes its rows", "TS(5);\n"),
            ("    const uint32_t vbuf = ((npass + p) % NSTAGE) * L.buf;\n",
             "if (p == 0) TS(6);\n"),
            ("  // --- merge: this lane holds out[row][32 c + 8 t", "TS(7);\n"),
            ("  for (int i = tid; i < N * OUT_COLS; i += THREADS) {", "TS(8);\n"),
            ("OUT_COLS * rank + col] = __float2bfloat16(o);\n  }\n", "TS(9);\n")]
        return V.add_trace(s, '#include "flash_mma.cuh"\n', 10,
                           [(a, st, a.endswith("\n")) for a, st in marks])
    raise ValueError(f"unknown variant {name!r}")


def source(name: str) -> Path:
    """Write variant `name` ('+'-joined edits) beside its headers."""
    return V.source(DA.SOURCE, name, _edit, OUT / "decode_attention")


def templates(name: str) -> list:
    """The templates variant `name` changes (and is timed or traced on)."""
    base = name.split("+")[0]
    if "wtrace" in name or (base.startswith("w") and base != "wtrace"):
        return ["wide"]
    return ["decode"] if "trace" in name or base != "kept" else ["decode", "wide"]


def inputs(N: int, S: int, NQ: int, bridge: bool, g: torch.Generator, dev):
    """A cache of S slots in L stacked layers; the N query rows at slots
    NQ onward, keys past them masked, batch 2 left-padded by 3, mixed
    query flags, image keys at slots 8..585."""
    bufs = [(torch.randint(-127, 128, (L, B, H, S, D), generator=g, device=dev, dtype=torch.int8),
             torch.rand((L, B, H, S), generator=g, device=dev) * 0.03 + 1e-3)
            for _ in range(4 if bridge else 2)]
    q = torch.randn((B, N, H, D), generator=g, device=dev).to(torch.bfloat16)
    flag_q = torch.zeros((B, N), dtype=torch.bool, device=dev)
    flag_q[:, ::2] = True
    flag_kv = torch.zeros((B, S), dtype=torch.bool, device=dev)
    flag_kv[:, 8:586] = True
    keep = torch.arange(S, device=dev)[None, None, :] <= (NQ + torch.arange(N, device=dev))[:, None]
    keep = keep.expand(B, N, S).clone()
    keep[2, :, :3] = False
    bias = torch.where(keep, 0.0, -2.0 ** 30).float()
    names = ["kq", "ks", "vq", "vs", "kbq", "kbs", "vbq", "vbs"]
    layers = [dict(zip(names, [t[l] for pair in bufs for t in pair])) for l in range(L)]
    return q, layers, dict(flag_q=flag_q, kv_flag=flag_kv, bias=bias)


def launch(fn, q, layer: dict, masks: dict) -> torch.Tensor:
    fq, fk, bias = DA._flags_bias(q, layer["kq"].shape[2], masks["flag_q"], masks["kv_flag"],
                                  masks["bias"])
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.check_launch(DA._launch(fn, q, layer["kq"], layer["ks"], layer["vq"], layer["vs"],
                                   layer.get("kbq"), layer.get("kbs"), layer.get("vbq"),
                                   layer.get("vbs"), fq, fk, bias, out, _build.stream(q)),
                        "int8_decode_attention variant")
    return out


def trace(path: Path, fn, q, layers, masks, label: str, phases) -> None:
    """Stamps of the last of 6 calls (``variants.report``)."""
    st = V.stamps(path, 8 * H * B, len(phases) + 1, q.device)
    for _ in range(3):
        for layer in layers:
            launch(fn, q, layer, masks)
    torch.cuda.synchronize()
    V.report(st, phases, label)


def main(names) -> dict:
    names = list(names) or DEFAULT
    card = V.card()
    dev = torch.device("cuda", 0)
    paths = {n: source(n) for n in names}
    for n, lib in zip(names, _build.build_all(paths.values())):
        for tpl, kernel, query in (("decode", "attn_decode_kernel", "clusters"),
                                   ("wide", "attn_wide_kernel", "wide_clusters")):
            if tpl not in templates(n):
                continue
            S = CASES[tpl][0][1]
            regs = [(r, spill) for _, r, spill in V.ptxas(lib, kernel)]
            clusters = _build.function(paths[n], f"int8_decode_attention_{query}",
                                       (ctypes.c_int, ctypes.c_int))
            print(f"{n} {tpl}: (registers, spill bytes) (no bridge, bridge) {regs}; clusters "
                  f"at once at S={S}: bridge {clusters(S, 1)}, no bridge {clusters(S, 0)} "
                  f"[{card}]")
    g = torch.Generator(device=dev).manual_seed(7)
    times = {}
    for tpl, cases in CASES.items():
        todo = [n for n in names if tpl in templates(n)]
        for (N, S, NQ), bridge in itertools.product(cases, (True, False)):
            if not todo:
                break
            q, layers, masks = inputs(N, S, NQ, bridge, g, dev)
            want = DA.int8_decode_attention_plain(q, **layers[1], **masks,
                                                  out_dtype=torch.float32)
            tol = want.abs().max().item() * 2.0 ** -8 + 1e-4
            nbytes = sum(t.numel() * t.element_size()
                         for t in (q, *layers[1].values(), *masks.values(), q))
            bound = nbytes / HBM_BPS * 1e3
            for n in todo:
                fn = _build.function(paths[n], "int8_decode_attention", DA._ARGTYPES)
                label = f"{n} N={N} bridge={bridge} S={S}"
                if "trace" in n:
                    trace(paths[n], fn, q, layers, masks, label,
                          WIDE_PHASES if tpl == "wide" else PHASES)
                    continue
                err = (launch(fn, q, layers[1], masks).float() - want).abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"{label}: max_abs_err {err} over {tol}")
                turn = itertools.cycle(layers)
                ms = cuda_ms(lambda: launch(fn, q, next(turn), masks))
                times[label] = ms
                print(f"{label}: {ms:.4f} ms ({bound / ms:.1%} of the {bound:.4f} ms bound "
                      f"on every slot's bytes), max_abs_err {err:.3g} (tol {tol:.3g}) "
                      f"[{card}]")
            del q, layers, masks, want
            torch.cuda.empty_cache()
    return times


if __name__ == "__main__":
    main(sys.argv[1:])
