"""The int4 decode-matvec experiment's kernels: the weight-only D and C,
and the W4A8 function of E, H and F.

Each computes y = x @ W for the rows of x (at most 8, the result zero
past them, over BP = 8 rows, or 32 for the experiment's F32R) against
one layer of a stacked group-int4 buffer, with the layer picked by
index. They compute what the experiment's Pallas TPU kernels compute
(``tools/exp_int4.py::main``):

* D (``build_d``): the weights dequantized to bf16 before the products.
  With s_hat = bf16(s), each byte gives bf16(u0 * s_hat) and
  bf16(q1 * s_hat), both rounded to nearest even; their products with
  the bf16 x are summed in fp32; the +8 low-nibble bias comes off as
  8 * sum_g bf16(cg[m, g]) * s_hat[g, o], where cg[m, g] is the fp32
  sum of x's even columns in group g.
* C (``build_c``): per group g, (sum xe * u0 + sum xo * q1) in fp32,
  times the fp32 scale s[g, o], accumulated; then 8 * sum_g cg[m, g] *
  s[g, o] off, all in fp32.

The byte layout is `int4_matmul.pack_int4`'s: byte r of a column holds
u0 = q[2r] + 8 in its low nibble and q[2r + 1] in its high nibble
(arithmetic shift of the signed byte).

On a CUDA tensor the four wrappers launch the hand-written Hopper kernels
of ``csrc/int4_exp.cu``, or raise; on a CPU tensor they run
`int4_exp_d_plain`, `int4_exp_c_plain` and `int4_exp_a8_plain`. Each of
the two functions (D and C; the W4A8 function of E, H and F) has two
templates, and a C function decides between them from the operands
(``int4_exp_template``, ``int4_exp_a8_template``; `int4_exp_template` and
`int4_exp_a8_template` name the choice): the decode template (split-K
clusters on the tensor cores: D and C as bf16 pairs of nibbles on
``mma.sync`` m16n8k16, W4A8 as u8 nibbles against the int8 x on
m16n8k32) for G % 32 == 0 with aligned operands (W4A8 also G <= 4096),
every call of the experiment; the chunked template for the rest, which
is also exported alone (``int4_exp_chunked``, ``int4_exp_a8_chunked``).
It is a choice by shape: a build or launch failure raises.

The W4A8 rows' options `i8mask` and `body` (and D's `wdt`) pick the
chunked template's unpack and select nothing on the decode template. The
card's integer registers are 32 bits wide, so the int8-domain and the
int32-widened unpack are the same word operations there; F's saving,
never unpacking the high nibble, buys nothing where the high nibble costs
one LOP3 a word, and F's raw byte would need a third product. The result
does not depend on them.
"""

from __future__ import annotations

import ctypes

import torch

from libra_tpu_torch.ops import _build

SOURCE = _build.CSRC / "int4_exp.cu"
BP = 8              # rows of the result: x padded to 8, as the TPU blocks are
BPS = (BP, 32)      # the W4A8 rows' padded row counts (F32R: 32)
MAX_GROUPS = 256    # K / group: the kernel keeps the group sums of x on chip
# x, packed, scales, out (pointer, row stride); M, K, F, G
_TENSORS = (ctypes.c_void_p, ctypes.c_longlong) * 4 + (ctypes.c_int,) * 4
_ARGTYPES = _TENSORS + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)      # mode, w16
_ARGTYPES_A8 = _TENSORS + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)   # bp, i8mask, low_only
# x, packed, scales (pointer, row stride); M, K, F, G
_TEMPLATE_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong) * 3 + (ctypes.c_int,) * 4
_TEMPLATE_ARGTYPES_A8 = _TEMPLATE_ARGTYPES + (ctypes.c_int,)         # bp
WDTS = (torch.int32, torch.int16)
BODIES = ("h", "f")


def _prep(x: torch.Tensor, packed: torch.Tensor, group: int):
    """x padded to BP rows in fp32, its even and odd columns, the fp32
    group sums of the even columns (BP, K/group), and the layer's nibbles
    (u0, q1), each (K/2, O) in fp32."""
    K = x.shape[-1]
    xp = torch.zeros((BP, K), dtype=torch.float32, device=x.device)
    xp[:x.shape[0]] = x.float()
    xe, xo = xp[:, 0::2], xp[:, 1::2]
    cg = xe.reshape(BP, K // group, group // 2).sum(dim=-1)
    w = packed.to(torch.int32)                 # sign-extends the byte
    return xe, xo, cg, (w & 15).float(), (w >> 4).float()


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def int4_exp_d_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                     li: int, group: int = 128) -> torch.Tensor:
    """D's function in plain torch on layer `li`: (BP, O) fp32. The
    products u0 * s_hat and q1 * s_hat are exact in fp32, so rounding them
    to bf16 is D's rounding to nearest even."""
    xe, xo, cg, u0, q1 = _prep(x, packed[li], group)
    s_hat = _round_bf16(scales[li].float())
    s_rows = torch.repeat_interleave(s_hat, group // 2, dim=0)    # (K/2, O)
    acc = xe @ _round_bf16(u0 * s_rows) + xo @ _round_bf16(q1 * s_rows)
    return acc - 8.0 * (_round_bf16(cg) @ s_hat)


def int4_exp_c_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                     li: int, group: int = 128) -> torch.Tensor:
    """C's function in plain torch on layer `li`: (BP, O) fp32."""
    xe, xo, cg, u0, q1 = _prep(x, packed[li], group)
    s = scales[li].float()
    G, gh, O = s.shape[0], group // 2, s.shape[1]

    def by_group(t):
        return t.reshape(-1, G, gh).transpose(0, 1)              # (G, BP, gh)

    sums = (torch.bmm(by_group(xe), u0.reshape(G, gh, O))
            + torch.bmm(by_group(xo), q1.reshape(G, gh, O)))      # (G, BP, O)
    return (sums * s[:, None, :]).sum(dim=0) - 8.0 * (cg @ s)


def quantize_rows(x: torch.Tensor, bp: int = BP):
    """x padded to bp rows and quantized per row as the W4A8 kernels do:
    (xq, the exact integers clip(rint(x / xs), -127, 127) in fp32, rounding
    half to even; xs (bp, 1), the row's absmax / 127, or 1 for a zero row)."""
    xp = torch.zeros((bp, x.shape[-1]), dtype=torch.float32, device=x.device)
    xp[:x.shape[0]] = x.float()
    amax = xp.abs().amax(dim=1, keepdim=True)
    xs = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(xp / xs), -127, 127), xs


def int4_exp_a8_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      li: int, group: int = 128, bp: int = BP) -> torch.Tensor:
    """The W4A8 function of E, H and F in plain torch on layer `li`:
    (bp, O) fp32. x padded to bp rows is quantized to exact integers in
    fp32 (`quantize_rows`); each group's sum of products of integers is
    then exact in fp32 (|d| <= group / 2 * 127 * 23 < 2^24 for group <
    11,000)."""
    xq, xs = quantize_rows(x, bp)
    xe, xo = xq[:, 0::2], xq[:, 1::2]
    w = packed[li].to(torch.int32)                 # sign-extends the byte
    s = scales[li].float()
    G, gh, O = s.shape[0], group // 2, s.shape[1]

    def by_group(t):
        return t.reshape(bp, G, gh).transpose(0, 1)              # (G, bp, gh)

    d = (torch.bmm(by_group(xe), (w & 15).float().reshape(G, gh, O))
         + torch.bmm(by_group(xo), (w >> 4).float().reshape(G, gh, O)))  # (G, bp, O)
    cg = by_group(xe).sum(dim=-1).t()                               # (bp, G)
    return ((d * s[:, None, :]).sum(dim=0) - 8.0 * (cg @ s)) * xs


def _check(name, x, packed, scales, li, group, bp=BP):
    if x.dim() != 2 or packed.dim() != 3 or scales.dim() != 3 or group % 2:
        raise ValueError(f"{name}: takes x (M, K), packed (L, K/2, O) and "
                         f"scales (L, K/group, O) with an even group, not x "
                         f"{tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, group {group}")
    if bp not in BPS:
        raise ValueError(f"{name}: bp must be one of {BPS}, not {bp}")
    (M, K), (L, Kh, O) = x.shape, packed.shape
    if (K != 2 * Kh or K % group or tuple(scales.shape) != (L, K // group, O)
            or not 1 <= M <= BP or K // group > MAX_GROUPS or O % 4):
        raise ValueError(f"{name}: unsupported shapes x {tuple(x.shape)}, packed "
                         f"{tuple(packed.shape)}, scales {tuple(scales.shape)}, "
                         f"group {group} (M <= {BP}, K/group <= {MAX_GROUPS}, "
                         f"O % 4 == 0)")
    if not 0 <= li < L:
        raise ValueError(f"{name}: layer {li} of {L}")
    if x.dtype != torch.bfloat16 or packed.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes bfloat16 x, int8 packed and "
                        f"float32 scales, not {x.dtype}, {packed.dtype}, "
                        f"{scales.dtype}")
    if packed.device != x.device or scales.device != x.device:
        raise ValueError(f"{name}: all inputs must be on one device")
    if x.stride(1) != 1 or not packed.is_contiguous() or not scales.is_contiguous():
        raise ValueError(f"{name}: x needs a unit-stride K, packed and scales "
                         f"must be contiguous")
    if packed.data_ptr() % 4:
        raise ValueError(f"{name}: the kernel reads packed 4 bytes at a time; "
                         f"it must start 4-byte aligned")


def _run(name, source, entry, argtypes, x, packed, scales, li, group, bp, *flags):
    """Launch `entry` of `source` on layer `li` into a new (bp, O) fp32
    result; `flags` are the entry's trailing int arguments."""
    _check(name, x, packed, scales, li, group, bp)
    p, s = packed[li], scales[li]
    O = p.shape[1]
    out = torch.empty((bp, O), dtype=torch.float32, device=x.device)
    fn = _build.function(source, entry, argtypes)
    status = fn(x.data_ptr(), x.stride(0), p.data_ptr(), p.stride(0),
                s.data_ptr(), s.stride(0), out.data_ptr(), out.stride(0),
                x.shape[0], x.shape[1], O, group, *flags, _build.stream(x))
    _build.check_launch(status, name)
    return out


def _template(name, entry, argtypes, x, packed, scales, li, group, bp, *extra) -> str:
    _check(name, x, packed, scales, li, group, bp)
    p, s = packed[li], scales[li]
    fn = _build.function(SOURCE, entry, argtypes)
    return "decode" if fn(x.data_ptr(), x.stride(0), p.data_ptr(), p.stride(0),
                          s.data_ptr(), s.stride(0), x.shape[0], x.shape[1],
                          p.shape[1], group, *extra) else "chunked"


def int4_exp_template(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      li: int, group: int = 128) -> str:
    """The template `int4_exp_d` and `int4_exp_c` launch on these CUDA
    operands, as the C function ``int4_exp_template`` decides it: "decode"
    or "chunked"."""
    return _template("int4_exp_template", "int4_exp_template", _TEMPLATE_ARGTYPES, x,
                     packed, scales, li, group, BP)


def int4_exp_a8_template(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         li: int, group: int = 128, bp: int = BP) -> str:
    """The template `int4_exp_e` and `int4_exp_a8` launch on these CUDA
    operands with `bp` result rows, as the C function
    ``int4_exp_a8_template`` decides it: "decode" or "chunked"."""
    return _template("int4_exp_a8_template", "int4_exp_a8_template", _TEMPLATE_ARGTYPES_A8,
                     x, packed, scales, li, group, bp, bp)


def int4_exp_d(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               li: int, group: int = 128, wdt: torch.dtype = torch.int32) -> torch.Tensor:
    """D on layer `li` of the stacked packed (L, K/2, O) int8 and scales
    (L, K/group, O) fp32: x (M <= 8, K) -> (BP, O) fp32, rows >= M zero.
    `wdt` (int32 or int16) is the width the kernel unpacks the bytes in;
    the result does not depend on it. CPU tensors take the plain version.
    CUDA tensors launch the kernel and add one to `int4_exp_d.launches`."""
    if wdt not in WDTS:
        raise ValueError(f"int4_exp_d: wdt must be one of {WDTS}, not {wdt}")
    if x.device.type == "cpu":
        return int4_exp_d_plain(x, packed, scales, li, group)
    if x.device.type != "cuda":
        raise ValueError(f"int4_exp_d: no kernel for {x.device}")
    out = _run("int4_exp_d", SOURCE, "int4_exp", _ARGTYPES, x, packed, scales, li,
               group, BP, 0, int(wdt == torch.int16))
    int4_exp_d.launches += 1
    return out


def int4_exp_c(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               li: int, group: int = 128) -> torch.Tensor:
    """C on layer `li`, with int4_exp_d's arguments and result. CPU tensors
    take the plain version. CUDA tensors launch the kernel and add one to
    `int4_exp_c.launches`."""
    if x.device.type == "cpu":
        return int4_exp_c_plain(x, packed, scales, li, group)
    if x.device.type != "cuda":
        raise ValueError(f"int4_exp_c: no kernel for {x.device}")
    out = _run("int4_exp_c", SOURCE, "int4_exp", _ARGTYPES, x, packed, scales, li,
               group, BP, 1, 0)
    int4_exp_c.launches += 1
    return out


def int4_exp_e(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               li: int, group: int = 128) -> torch.Tensor:
    """E (``build_e``) on layer `li`: the W4A8 function with the unpack on
    the int8 bytes; x (M <= 8, K) -> (BP, O) fp32, rows >= M zero. CPU
    tensors take the plain version. CUDA tensors launch the kernel and add
    one to `int4_exp_e.launches`."""
    if x.device.type == "cpu":
        return int4_exp_a8_plain(x, packed, scales, li, group)
    if x.device.type != "cuda":
        raise ValueError(f"int4_exp_e: no kernel for {x.device}")
    out = _run("int4_exp_e", SOURCE, "int4_exp_a8", _ARGTYPES_A8, x, packed, scales,
               li, group, BP, BP, 1, 0)
    int4_exp_e.launches += 1
    return out


def int4_exp_a8(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                li: int, group: int = 128, body: str = "h", bp: int = BP,
                i8mask: bool = False) -> torch.Tensor:
    """``_a8_fn`` on layer `li` with the body ``build_h`` ("h": both
    nibbles, from bytes widened to int32) or ``build_f`` ("f": the low
    nibble only), x padded to `bp` (8 or 32) rows; `i8mask` unpacks on
    the int8 bytes instead. `body` and `i8mask` pick the chunked
    template's unpack; the decode template takes neither. x (M <= 8, K) ->
    (bp, O) fp32, rows >= M zero; the result depends on none of the three
    options but bp. CPU tensors
    take the plain version. CUDA tensors launch the kernel and add one to
    `int4_exp_a8.launches`."""
    if body not in BODIES:
        raise ValueError(f"int4_exp_a8: body must be one of {BODIES}, not {body!r}")
    if bp not in BPS:
        raise ValueError(f"int4_exp_a8: bp must be one of {BPS}, not {bp}")
    if x.device.type == "cpu":
        return int4_exp_a8_plain(x, packed, scales, li, group, bp)
    if x.device.type != "cuda":
        raise ValueError(f"int4_exp_a8: no kernel for {x.device}")
    out = _run("int4_exp_a8", SOURCE, "int4_exp_a8", _ARGTYPES_A8, x, packed, scales,
               li, group, bp, bp, int(i8mask), int(body == "f"))
    int4_exp_a8.launches += 1
    return out


int4_exp_d.launches = 0
int4_exp_c.launches = 0
int4_exp_e.launches = 0
int4_exp_a8.launches = 0
