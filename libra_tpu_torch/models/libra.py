"""Libra decoder: LLaMA backbone with a decoupled (routed) vision system.

The PyTorch counterpart of ``libra_tpu/models/libra.py`` for inference:

* modality routing is dense dual-path compute selected by the vision flag
  (ops/routed.py);
* the K/V bridge is a cross-modality mask in attention (ops/attention.py);
  the prompt pass runs it through the flash kernel (ops/flash_bridge.py);
* a Python loop over the stacked layer leaves replaces ``lax.scan``;
* the bf16 KV cache is a preallocated sequence-major (L, B, S, H, d) buffer
  written in place; the int8 cache (``init_cache(quantized=True)``) is
  head-major (L, B, H, S, d) with (L, B, H, S) fp32 scales, and decode
  steps read it through the int8 decode-attention kernel
  (ops/decode_attention.py). The cache's index is a host int (every row
  in lockstep) or a (B,) tensor on the device, one timeline per row (the
  serving engine's slots, serving.py).

Training adds per-layer rematerialisation (``forward(remat=...)``:
``torch.utils.checkpoint``, full or selective on the named big dots),
train-time dropout at the reference's sites (``forward(dropout_key=...)``;
each mask a function of its key's integers, ops/routed.py) and the
multi-codebook loss.

The fused-pixels prompt pass (generation.py) passes ``text_span``
(``text_span_maps``): every row holds one full image block, so the
full-rank language projections run on the T = N - 578 text rows only.

Parameters are nested dicts of tensors with the JAX tree's key names,
layer leaves stacked on axis 0 and weights stored for ``x @ W``.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from libra_tpu_torch.config import LibraConfig
from libra_tpu_torch.ops.attention import BIG_NEG, bridged_attention, causal_bias
from libra_tpu_torch.ops.decode_attention import (decode_kernel_applicable,
                                                  int8_decode_attention)
from libra_tpu_torch.ops.flash_bridge import flash_bridged_attention
from libra_tpu_torch.ops.norm import rms_norm
from libra_tpu_torch.ops.qlinear import qdot
from libra_tpu_torch.ops.rope import apply_rope, apply_rope_2d, rope_cos_sin
from libra_tpu_torch.ops.routed import (DropoutKey, fold, gather_rows,
                                        low_rank_linear, routed_dropout,
                                        routed_linear, routed_low_rank,
                                        select_by_flag, split_merge)
from libra_tpu_torch.quantization import QuantizedArray

Params = Dict[str, Any]


def dropout_enabled(cfg: LibraConfig) -> bool:
    """True when any of the reference's pdrop fields is nonzero: the train
    step then derives a dropout key for the forward."""
    return any(r > 0.0 for r in (cfg.resid_pdrop, cfg.attn_pdrop,
                                 cfg.embd_pdrop, cfg.vision_embd_pdrop,
                                 cfg.vision_resid_pdrop))


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, std, dtype, device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def _low_rank(gen, L, d_in, d_bottleneck, d_out, std, dtype, device,
              zero_b: bool) -> Params:
    wa = _normal(gen, (L, d_in, d_bottleneck), std, dtype, device)
    wb = (torch.zeros((L, d_bottleneck, d_out), dtype=dtype, device=device)
          if zero_b else _normal(gen, (L, d_bottleneck, d_out), std, dtype, device))
    return {"wa": wa, "wb": wb}


def init_layer_params(gen: torch.Generator, cfg: LibraConfig,
                      device) -> Params:
    """All layers' params, each leaf stacked on a leading layer axis."""
    L = cfg.num_hidden_layers
    D, I = cfg.hidden_size, cfg.intermediate_size
    Db, Ib = D // cfg.vision_down_ratio, I // cfg.vision_down_ratio
    r, std, pd = cfg.bridge_rank, cfg.initializer_range, cfg.params_dtype
    zero_b = cfg.addition_mode

    def dense(d_in, d_out):
        return _normal(gen, (L, d_in, d_out), std, pd, device)

    def low(d_in, d_b, d_out, zero):
        return _low_rank(gen, L, d_in, d_b, d_out, std, pd, device, zero)

    attn = {
        "q_proj": dense(D, D), "k_proj": dense(D, D),
        "v_proj": dense(D, D), "o_proj": dense(D, D),
        "vision_q": low(D, Db, D, zero_b), "vision_k": low(D, Db, D, zero_b),
        "vision_v": low(D, Db, D, zero_b), "vision_o": low(D, Db, D, zero_b),
    }
    if cfg.use_bridge:
        # bridge B-weights start at zero, as in the reference's rank mode
        attn.update({name: low(D, r, D, True) for name in (
            "k_bridge_lang", "k_bridge_vis", "v_bridge_lang", "v_bridge_vis")})
    mlp = {
        "gate_proj": dense(D, I), "up_proj": dense(D, I), "down_proj": dense(I, D),
        "vision_gate": low(D, Ib, I, zero_b), "vision_up": low(D, Ib, I, zero_b),
        "vision_down": low(I, Db, D, zero_b),
    }
    ones = lambda: torch.ones((L, D), dtype=pd, device=device)  # noqa: E731
    return {
        "attn": attn,
        "mlp": mlp,
        "input_layernorm": ones(),
        "post_attention_layernorm": ones(),
        "vision_input_layernorm": ones(),
        "vision_post_attention_layernorm": ones(),
    }


def init_params(gen: torch.Generator, cfg: LibraConfig, device="cuda") -> Params:
    """Random-init parameter tree with the JAX tree's key paths and shapes.
    `gen` must live on `device`. In 2D prediction mode the vision heads
    take 2 * D inputs and vision_hidden_placeholder is drawn last, after
    every draw a 1D tree makes."""
    D, V = cfg.hidden_size, cfg.vocab_size
    Q, Vv = cfg.vision_codebook_num, cfg.vision_vocab_size
    S = cfg.contiguous_signal_size
    std, pd = cfg.initializer_range, cfg.params_dtype

    def normal(shape):
        return _normal(gen, shape, std, pd, device)

    params: Params = {
        "embed_tokens": normal((V, D)),
        "vision_embed_tokens": normal((Q, Vv, D // Q)),
        "layers": init_layer_params(gen, cfg, device),
        "norm": torch.ones((D,), dtype=pd, device=device),
        "vision_norm": torch.ones((D,), dtype=pd, device=device),
        "lm_head": normal((D, V)),
        "vision_lm_head": normal((Q, 2 * D if cfg.vision_prediction_mode == "2d"
                                  else D, Vv)),
    }
    if cfg.concat_signals:
        params["signal_proj"] = normal((S + D, D))
        if cfg.norm_signals:
            params["signal_norm"] = torch.ones((S + D,), dtype=pd, device=device)
    else:
        params["signal_proj"] = normal((S, D))
    if cfg.use_vision_position_embedding:
        params["vision_position_embedding"] = normal(
            (cfg.max_vision_token_length, D))
    if cfg.vision_prediction_mode == "2d":
        params["vision_hidden_placeholder"] = normal((D,))
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Bridged KV cache. k/v/kb/vb: (num_layers, B, max_len, H, head_dim)
    tensors, or head-major QuantizedArrays (q (num_layers, B, H, max_len,
    head_dim) int8, scale (num_layers, B, H, max_len) fp32); kb/vb None
    without the bridge; flag: (B, max_len) vision flags of the cached
    tokens. index: tokens already written -- a host int (all rows in
    lockstep: the Generator's decode), or a (B,) int64 tensor on the
    cache's device for PER-SLOT timelines (the serving engine: each slot
    owns positions [0, index_b) of its own row and recycles
    independently). A per-row write of N tokens starts at index_b clamped
    to [0, max_len - N], as XLA's dynamic_update_slice clamps its start."""
    k: Any
    v: Any
    kb: Optional[Any]
    vb: Optional[Any]
    flag: torch.Tensor
    index: Union[int, torch.Tensor]


def init_cache(cfg: LibraConfig, batch: int, max_len: int,
               device="cuda", quantized: bool = False) -> KVCache:
    """A zeroed cache in the compute dtype, or with quantized=True int8
    K/V with per-(token, head) scales: half the bytes to hold and to read
    each decode step. The int8 buffers are head-major, so the decode
    kernel reads each (batch, head)'s keys as one contiguous run."""
    L, H, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim

    def z():
        if quantized:
            return QuantizedArray(
                torch.zeros((L, batch, H, max_len, d), dtype=torch.int8,
                            device=device),
                torch.zeros((L, batch, H, max_len), dtype=torch.float32,
                            device=device))
        return torch.zeros((L, batch, max_len, H, d), dtype=cfg.compute_dtype,
                           device=device)

    return KVCache(k=z(), v=z(),
                   kb=z() if cfg.use_bridge else None,
                   vb=z() if cfg.use_bridge else None,
                   flag=torch.zeros((batch, max_len), dtype=torch.bool,
                                    device=device),
                   index=0)


class RowSlots(NamedTuple):
    """Where a per-row write of N tokens lands: rows (B, 1) and positions
    (B, N), for one advanced-index write per buffer."""
    rows: torch.Tensor
    pos: torch.Tensor


def row_slots(index: torch.Tensor, S: int, N: int) -> RowSlots:
    """The write slots of N tokens at a per-row index (B,) into rows of S:
    each start clamped to [0, S - N], XLA's rule for dynamic_update_slice,
    so that a row whose index ran past the end (an idle serving slot keeps
    decoding until a refill resets it) rewrites its last N positions
    instead of indexing out of range. Computed on the index's device, with
    no host read."""
    start = index.clamp(0, S - N)
    rows = torch.arange(index.shape[0], device=index.device)[:, None]
    return RowSlots(rows, start[:, None] + torch.arange(N, device=index.device))


def _write_seq(buf: torch.Tensor, new: torch.Tensor, index,
               slots: Optional[RowSlots] = None) -> torch.Tensor:
    """Write `new` (B, N, ...) into `buf` (B, S, ...) at sequence offset
    `index`, in place; returns `buf`. index: a host int (the same offset
    for every row) or a (B,) tensor of per-row offsets, clamped as
    row_slots says (`slots`: row_slots' result, when the caller has it)."""
    if isinstance(index, torch.Tensor):
        rows, pos = slots or row_slots(index, buf.shape[1], new.shape[1])
        buf[rows, pos] = new.to(buf.dtype)
        return buf
    buf[:, index:index + new.shape[1]] = new.to(buf.dtype)
    return buf


def _write_cache(buf, new: torch.Tensor, layer_idx: int, index,
                 slots: Optional[RowSlots] = None):
    """Write one layer's new K/V (B, N, H, d) into the stacked cache at
    layer `layer_idx`, sequence offset `index`, in place; returns `buf`.
    index: a host int, or a (B,) tensor of per-row offsets (clamped as
    row_slots says; `slots` is its result when the caller has it), written
    as ONE advanced-index write per buffer, not a loop over the rows.
    A quantized buffer takes int8 values with one scale per (token, head):
    absmax / 127, rounded to nearest even and clipped to +-127; its q and
    scale are head-major, so a per-row write goes through their (B, S, H)
    transposed views."""
    N = new.shape[1]
    if isinstance(buf, QuantizedArray):
        nf = new.float()
        a = nf.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(a > 0, a, 1.0) / 127.0
        q = torch.round(nf / scale).clamp_(-127, 127).to(torch.int8)
        if isinstance(index, torch.Tensor):
            rows, pos = slots or row_slots(index, buf.q.shape[3], N)
            buf.q[layer_idx].transpose(1, 2)[rows, pos] = q
            buf.scale[layer_idx].transpose(1, 2)[rows, pos] = scale[..., 0]
            return buf
        buf.q[layer_idx, :, :, index:index + N] = q.transpose(1, 2)
        buf.scale[layer_idx, :, :, index:index + N] = scale[..., 0].transpose(1, 2)
        return buf
    if isinstance(index, torch.Tensor):
        rows, pos = slots or row_slots(index, buf.shape[2], N)
        buf[layer_idx][rows, pos] = new.to(buf.dtype)
        return buf
    buf[layer_idx, :, index:index + N] = new.to(buf.dtype)
    return buf


def _write_cache_row(buf, new: torch.Tensor, layer_idx: int, row: torch.Tensor,
                     offset: torch.Tensor, write: Optional[torch.Tensor] = None):
    """Write one row's K/V block new (1, C, H, d) into the stacked cache at
    [layer_idx, row, offset:offset + C], in place; returns `buf`. The
    serving engine's merged chunk writes its prompt segment so: one
    indexed write per buffer. row and offset are (1,) tensors on the
    device, clamped as XLA clamps dynamic_update_slice's start (row to
    [0, B - 1], offset to [0, S - C]); nothing here reads them on the
    host. A quantized buffer takes _write_cache's int8 values and scales
    through the head-major buffers' transposed views.

    write (a bool tensor, or None for always): where False, the write is a
    value-masked no-op, the old block read back and written again. The
    merged chunk's parked iterations point at the just-finished row's
    decode positions, whose decode-token K/V of the same layer a blind
    write would clobber."""
    C = new.shape[1]
    q_buf = buf.q if isinstance(buf, QuantizedArray) else buf
    B, S = q_buf.shape[1], q_buf.shape[3 if isinstance(buf, QuantizedArray) else 2]
    rows = row.clamp(0, B - 1)[:, None]
    pos = offset.clamp(0, S - C)[:, None] + torch.arange(C, device=offset.device)

    def put(view, val):          # view (B, S, ...), val (1, C, ...)
        if write is not None:
            val = torch.where(write, val, view[rows, pos])
        view[rows, pos] = val

    if isinstance(buf, QuantizedArray):
        nf = new.float()
        a = nf.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(a > 0, a, 1.0) / 127.0
        q = torch.round(nf / scale).clamp_(-127, 127).to(torch.int8)
        put(buf.q[layer_idx].transpose(1, 2), q)
        put(buf.scale[layer_idx].transpose(1, 2), scale[..., 0])
        return buf
    put(buf[layer_idx], new.to(buf.dtype))
    return buf


def _read_cache(view, dtype: torch.dtype) -> torch.Tensor:
    """One layer's cache as a sequence-major (B, S, H, d) tensor: a bf16
    view as it is; a quantized head-major view dequantized in `dtype`
    (q and scale each cast first, as in JAX) and transposed."""
    if isinstance(view, QuantizedArray):
        return (view.q.to(dtype) * view.scale.to(dtype)[..., None]).transpose(1, 2)
    return view


# ---------------------------------------------------------------------------
# Embeddings and positions
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: LibraConfig, input_ids: torch.Tensor,
                 vision_flag: torch.Tensor,
                 contiguous_signal: Optional[torch.Tensor],
                 vision_indices: Optional[torch.Tensor],
                 lang_only: bool = False) -> torch.Tensor:
    """Multi-codebook embedding + continuous-signal fusion. input_ids:
    (Q, B, N) combined-vocab ids (vision ids carry the +vocab_size offset).
    lang_only skips the vision embedding chain (text-only decode)."""
    V, Vv = cfg.vocab_size, cfg.vision_vocab_size
    cd = cfg.compute_dtype

    text_emb = params["embed_tokens"][input_ids[0].clamp(0, V - 1)].to(cd)
    if lang_only:
        return text_emb

    vis_ids = (input_ids - V).clamp(0, Vv - 1)                    # (Q,B,N)
    vis_emb = torch.cat(
        [params["vision_embed_tokens"][q][vis_ids[q]].to(cd)
         for q in range(cfg.vision_codebook_num)], dim=-1)          # (B,N,D)

    if cfg.use_vision_position_embedding:
        vpe = params["vision_position_embedding"][
            vision_indices.clamp(0, cfg.max_vision_token_length - 1)]
        vis_emb = vis_emb + vpe.to(cd)

    if cfg.concat_signals:
        B, N = text_emb.shape[:2]
        if contiguous_signal is None:
            sig = torch.zeros((B, N, cfg.contiguous_signal_size), dtype=cd,
                              device=text_emb.device)
        else:
            sig = contiguous_signal.to(cd)
        cat = torch.cat([vis_emb, sig], dim=-1)
        if cfg.norm_signals:
            cat = rms_norm(cat, params["signal_norm"], cfg.rms_norm_eps)
        vis_emb = qdot(cat, params["signal_proj"])

    h = select_by_flag(vision_flag, vis_emb, text_emb)
    if not cfg.concat_signals and contiguous_signal is not None:
        # additive mode applies the signal at ALL positions
        h = h + qdot(contiguous_signal.to(cd), params["signal_proj"])
    return h


def position_ids_from_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """cumsum(mask) - 1, with pad positions set to 1."""
    pos = torch.cumsum(attention_mask.long(), dim=-1) - 1
    return torch.where(attention_mask == 0, torch.ones_like(pos), pos)


def make_2d_pos_offset(cfg: LibraConfig, device=None) -> torch.Tensor:
    """The (max_vision_token_length + 1, 2) offset table of 2D RoPE,
    indexed by vision index: BOI -> (0, 0), grid cell (i, j) -> its
    1-indexed (row, col), EOI and text -> (0, 0)."""
    R = cfg.image_feature_resolution
    i = torch.arange(1, R + 1, device=device)
    grid = torch.stack([i[:, None].expand(R, R), i[None, :].expand(R, R)],
                       dim=-1).reshape(-1, 2)
    zeros = lambda n: torch.zeros((n, 2), dtype=torch.int64, device=device)  # noqa: E731
    return torch.cat([zeros(1), grid, zeros(2)])


def rope_inc(cfg: LibraConfig, vi: torch.Tensor) -> torch.Tensor:
    """The 2D-RoPE base counter's step at a token of vision index vi: 1 on
    text and BOI, R + 1 on EOI, 0 inside an image."""
    Mv = cfg.max_vision_token_length
    inc = ((vi == Mv) | (vi == 0)).long()
    return torch.where(vi == Mv - 1, cfg.image_feature_resolution + 1, inc)


def rope_positions(cfg: LibraConfig, base: torch.Tensor,
                   vi: torch.Tensor) -> torch.Tensor:
    """Position ids from per-token counters base (B, N) at vision indices
    vi (B, N): base itself with 1D RoPE; with 2D RoPE (B, 2, N), base plus
    the token's (row, col) offset (make_2d_pos_offset)."""
    return _with_offsets(cfg, base, vi) if cfg.use_2d_rope else base


def _with_offsets(cfg: LibraConfig, base: torch.Tensor,
                  vi: torch.Tensor) -> torch.Tensor:
    tab = make_2d_pos_offset(cfg, base.device)
    off = tab[vi.clamp(0, cfg.max_vision_token_length)]            # (B, N, 2)
    return (base[..., None] + off).transpose(1, 2)


def get_2d_position_ids(cfg: LibraConfig, vision_indices: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """2D-RoPE position ids (B, 2, N): the base counter advances by
    rope_inc (masked tokens by 0) and starts at 0; in-image tokens add
    their (row, col) offset; masked tokens are pinned to 1."""
    step = rope_inc(cfg, vision_indices)
    if attention_mask is not None:
        # EOI keeps its R + 1 step even where masked, as the reference's
        step = torch.where((attention_mask == 0)
                           & (vision_indices != cfg.max_vision_token_length - 1),
                           0, step)
    pos = _with_offsets(cfg, torch.cumsum(step, dim=-1) - 1, vision_indices)
    if attention_mask is not None:
        pos = torch.where((attention_mask == 0)[:, None], 1, pos)
    return pos


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------

# The decoder layer's named matmul regions: the routed q/k/v/o projections
# and the six MLP dots (language gate/up/down and their low-rank vision
# twins), the tags JAX's forward puts on them with checkpoint_name.
BIG_DOT_NAMES = ("attn_q", "attn_k", "attn_v", "attn_o",
                 "mlp_gate", "mlp_up", "mlp_down",
                 "mlp_vgate", "mlp_vup", "mlp_vdown")

_CKPT_NAME: contextvars.ContextVar = contextvars.ContextVar(
    "libra_torch_ckpt_name", default=None)
# True only while a layer runs under a named policy ("big_dots",
# "names:..."), in its forward and in its recompute
_NAMING: contextvars.ContextVar = contextvars.ContextVar(
    "libra_torch_ckpt_naming", default=False)
_UNNAMED = contextlib.nullcontext()
# matmuls with no batch dims: what "dots" and the names policies may save
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def checkpoint_name(name: str):
    """Name the matmuls run inside the block for the selective remat
    policies: under "big_dots" or "names:..." their outputs are saved for
    the backward instead of recomputed. JAX tags the region's result
    (checkpoint_name); PyTorch's recompute re-runs every op whose output
    was not saved, so the policy saves the region's matmul outputs, and
    the result follows from them by cheap elementwise ops (the routed
    select). Outside a named policy (serving, no remat, "full", "dots")
    it is a shared no-op context."""
    return _named(name) if _NAMING.get() else _UNNAMED


@contextlib.contextmanager
def _named(name: str):
    token = _CKPT_NAME.set(name)
    try:
        yield
    finally:
        _CKPT_NAME.reset(token)


def _naming_on(fn):
    """fn with checkpoint_name's tags live while it runs."""
    def run(*args):
        token = _NAMING.set(True)
        try:
            return fn(*args)
        finally:
            _NAMING.reset(token)
    return run


def _save_dots(names):
    """A selective-checkpoint policy: save the outputs of matmuls run
    inside a region named in `names` (every matmul when names is None)."""
    def policy(ctx, func, *args, **kwargs):
        if func in _DOTS and (names is None or _CKPT_NAME.get() in names):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)


def _remat_context_fn(remat):
    """forward()'s remat argument -> (None, False) for no remat, or (the
    context_fn of a per-layer torch.utils.checkpoint, whether its policy
    reads checkpoint_name's tags): True/"full" saves the layer input only
    (the backward re-runs the layer); "dots" saves every matmul output;
    "big_dots" the matmul outputs of the BIG_DOT_NAMES regions;
    "names:a,b,..." those of a subset of BIG_DOT_NAMES."""
    if not remat:
        return None, False
    if remat is True or remat == "full":
        return noop_context_fn, False
    if remat == "dots":
        return _save_dots(None), False
    if remat == "big_dots":
        return _save_dots(frozenset(BIG_DOT_NAMES)), True
    if isinstance(remat, str) and remat.startswith("names:"):
        names = tuple(remat[len("names:"):].split(","))
        unknown = set(names) - set(BIG_DOT_NAMES)
        if unknown:
            raise ValueError(f"unknown remat names {sorted(unknown)}; "
                             f"available: {BIG_DOT_NAMES}")
        return _save_dots(frozenset(names)), True
    raise ValueError(f"remat must be falsy, True, 'full', 'dots', "
                     f"'big_dots' or 'names:...' -- got {remat!r}")


# ---------------------------------------------------------------------------
# Decoder layer
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, D = x.shape
    return x.reshape(B, N, num_heads, D // num_heads)


def _attention(p: Params, cfg: LibraConfig, h: torch.Tensor,
               flag: torch.Tensor, cos, sin, position_ids, bias, kv_flag,
               cache_slice, attn_impl: str = "plain",
               dropout_key: Optional[DropoutKey] = None,
               text_span=None,
               lang_only: bool = False) -> Tuple[torch.Tensor, Any]:
    """Routed attention with bridge; h is the routed-normed input.

    dropout_key: this layer's attention stream: attn_pdrop on the
    probabilities (which takes the plain attention: the flash kernels never
    hold the probabilities) and the resid rates on o's two paths.

    attn_impl: "plain" (ops/attention.py) or "flash" (the prompt-pass
    kernel, ops/flash_bridge.py). text_span: the split prompt pass's row
    maps; the q, k, v and o language projections run on the text rows
    only (ops/routed.py::routed_linear). lang_only (cached decode only)
    skips the vision projections and the new tokens' bridge K/V, whose
    cache slots are never read (cross is zero for text-query/text-key
    pairs).
    cache_slice: None or {"bufs": stacked cache buffers, "layer": this
    layer's index, "index": the sequence write offset (an int, or a (B,)
    tensor of per-row offsets), "slots": row_slots' result for a per-row
    index, else None}; the buffers are written in place. Returns
    (attn_out (B, N, D), bufs)."""
    H = cfg.num_attention_heads
    a = p["attn"]
    attn_key, o_key = fold(dropout_key, 0), fold(dropout_key, 1)
    attn_drop_on = attn_key is not None and cfg.attn_pdrop > 0.0
    if lang_only and cache_slice is None:
        raise ValueError("lang_only is a cached-decode mode")

    def rproj(name):
        with checkpoint_name("attn_" + name[0]):
            if lang_only:
                return qdot(h, a[name])
            vp = a["vision_" + name[0]]
            return routed_linear(h, flag, a[name], vp["wa"], vp["wb"],
                                 cfg.addition_mode, text_span=text_span)

    rope = apply_rope_2d if cfg.use_2d_rope else apply_rope
    q = rope(_split_heads(rproj("q_proj"), H), cos, sin, position_ids)
    k = rope(_split_heads(rproj("k_proj"), H), cos, sin, position_ids)
    v = _split_heads(rproj("v_proj"), H)

    kb = vb = None
    if cfg.use_bridge and not lang_only:
        kb = _split_heads(routed_low_rank(
            h, flag, a["k_bridge_lang"]["wa"], a["k_bridge_lang"]["wb"],
            a["k_bridge_vis"]["wa"], a["k_bridge_vis"]["wb"]), H)
        vb = _split_heads(routed_low_rank(
            h, flag, a["v_bridge_lang"]["wa"], a["v_bridge_lang"]["wb"],
            a["v_bridge_vis"]["wa"], a["v_bridge_vis"]["wb"]), H)
        kb = rope(kb, cos, sin, position_ids)  # rope is linear: rope(K+Kb)

    bufs = out = None
    if cache_slice is not None:
        li, idx = cache_slice["layer"], cache_slice["index"]
        bufs, slots = cache_slice["bufs"], cache_slice["slots"]
        # keys span the whole cache; unwritten slots are masked by `bias`
        _write_cache(bufs["k"], k, li, idx, slots)
        _write_cache(bufs["v"], v, li, idx, slots)
        if cfg.use_bridge and not lang_only:
            _write_cache(bufs["kb"], kb, li, idx, slots)
            _write_cache(bufs["vb"], vb, li, idx, slots)
        ck, cv = bufs["k"][li], bufs["v"][li]
        ckb, cvb = (bufs["kb"][li], bufs["vb"][li]) if cfg.use_bridge else (None, None)
        if attn_key is None and decode_kernel_applicable(ck, q.shape[1],
                                                         cfg.head_dim):
            # the int8 cache's decode steps: raw int8 layer views, the
            # scales folded into scores and probabilities
            bridge = {} if ckb is None else dict(kbq=ckb.q, kbs=ckb.scale,
                                                 vbq=cvb.q, vbs=cvb.scale)
            out = int8_decode_attention(q, ck.q, ck.scale, cv.q, cv.scale,
                                        flag_q=flag, kv_flag=kv_flag,
                                        bias=bias[:, 0], **bridge)
        else:
            # the prompt pass (and any step the kernel does not take)
            # attends over the cache as written: with an int8 cache, the
            # dequantized keys and values, not the fresh ones
            k, v = _read_cache(ck, q.dtype), _read_cache(cv, q.dtype)
            if ckb is not None:
                kb, vb = _read_cache(ckb, q.dtype), _read_cache(cvb, q.dtype)

    if out is None and attn_impl == "flash" and not attn_drop_on:
        out = flash_bridged_attention(q, k, v, kb, vb, flag, kv_flag, bias)
    elif out is None:
        out = bridged_attention(q, k, v, kb, vb, flag, kv_flag, bias,
                                dropout=(attn_key, cfg.attn_pdrop))
    out = out.reshape(h.shape[0], h.shape[1], cfg.hidden_size)
    with checkpoint_name("attn_o"):
        if lang_only:
            return qdot(out, a["o_proj"]), bufs
        vo = a["vision_o"]
        return routed_linear(out, flag, a["o_proj"], vo["wa"], vo["wb"],
                             cfg.addition_mode,
                             dropout=(o_key, cfg.resid_pdrop,
                                      cfg.vision_resid_pdrop),
                             text_span=text_span), bufs


def _mlp(p: Params, cfg: LibraConfig, h: torch.Tensor, flag: torch.Tensor,
         dropout_key: Optional[DropoutKey] = None,
         text_span=None, lang_only: bool = False) -> torch.Tensor:
    """Routed SwiGLU MLP; routes strictly even in addition_mode. With
    text_span the language SwiGLU (the layer's largest matmuls) runs on
    the gathered text rows only; strict routing makes that exact in every
    mode. dropout_key: the post-down dropout at each position's modality
    rate (after the merge: strict routing makes that the per-path
    dropout); a key turns text_span off, as in libra_tpu."""
    m = p["mlp"]

    def dot(name, x, *w):
        with checkpoint_name(name):
            return qdot(x, w[0]) if len(w) == 1 else low_rank_linear(x, *w)

    def lang_mlp(x):
        return dot("mlp_down", F.silu(dot("mlp_gate", x, m["gate_proj"]))
                   * dot("mlp_up", x, m["up_proj"]), m["down_proj"])

    if lang_only:
        return lang_mlp(h)
    gate_v = dot("mlp_vgate", h, m["vision_gate"]["wa"], m["vision_gate"]["wb"])
    up_v = dot("mlp_vup", h, m["vision_up"]["wa"], m["vision_up"]["wb"])
    vis = dot("mlp_vdown", F.silu(gate_v) * up_v, m["vision_down"]["wa"],
              m["vision_down"]["wb"])
    if text_span is not None and dropout_key is None:
        src, inv = text_span
        out = split_merge(flag, vis, lang_mlp(gather_rows(h, src)), inv)
    else:
        out = select_by_flag(flag, vis, lang_mlp(h))
    return routed_dropout(dropout_key, out, flag, cfg.vision_resid_pdrop,
                          cfg.resid_pdrop)


def decoder_layer(p: Params, cfg: LibraConfig, h: torch.Tensor,
                  flag: torch.Tensor, cos, sin, position_ids, bias, kv_flag,
                  cache_slice, attn_impl: str = "plain",
                  dropout_key: Optional[DropoutKey] = None,
                  text_span=None,
                  lang_only: bool = False) -> Tuple[torch.Tensor, Any]:
    """One pre-norm decoder layer with separate vision RMSNorms;
    dropout_key is the layer's stream, split into an attention and an MLP
    stream."""
    eps = cfg.rms_norm_eps

    def routed_norm(x, name):
        if lang_only:
            return rms_norm(x, p[name], eps)
        return select_by_flag(flag, rms_norm(x, p["vision_" + name], eps),
                              rms_norm(x, p[name], eps))

    attn_out, bufs = _attention(p, cfg, routed_norm(h, "input_layernorm"),
                                flag, cos, sin, position_ids, bias, kv_flag,
                                cache_slice, attn_impl,
                                dropout_key=fold(dropout_key, 0),
                                text_span=text_span, lang_only=lang_only)
    h = h + attn_out
    h = h + _mlp(p, cfg, routed_norm(h, "post_attention_layernorm"), flag,
                 dropout_key=fold(dropout_key, 1), text_span=text_span,
                 lang_only=lang_only)
    return h, bufs


def text_span_maps(cfg: LibraConfig, img_start: torch.Tensor, N: int):
    """Row maps of the modality-split prompt pass (ops/routed.py).

    Where every row carries exactly one full image block of
    Mv = max_vision_token_length tokens starting at img_start[b] (the
    fused-pixels prompt pass, generation.py), the other positions of row b
    are [0, img_start) and [img_start + Mv, N): T = N - Mv of them, the
    same for every row. Returns (src (B, T), inv (B, N)), computed on
    img_start's device with no host read:
      src[b, j] = the j-th non-vision position of row b;
      inv[b, n] = the index into src of position n (clipped junk at
                  vision positions, which the flag selects away).
    Left padding is fine: pad positions are non-vision, src covers them,
    and their outputs are masked downstream either way. None when N == Mv
    (no text rows)."""
    Mv = cfg.max_vision_token_length
    T = N - Mv
    if T <= 0:
        return None
    start = img_start.long()[:, None]
    j = torch.arange(T, device=start.device)[None, :]
    src = j + Mv * (j >= start)
    n = torch.arange(N, device=start.device)[None, :]
    inv = (n - Mv * (n >= start + Mv)).clamp(0, T - 1)
    return src, inv


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

class ModelOutput(NamedTuple):
    hidden_states: torch.Tensor     # (B, N, D), routed final norm applied
    cache: Optional[KVCache]


def _layer(layers: Params, i: int) -> Params:
    """Layer i's view of the stacked layer leaves (no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def forward(params: Params, cfg: LibraConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor, vision_indices: torch.Tensor,
            contiguous_signal: Optional[torch.Tensor] = None,
            position_ids: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None,
            attn_impl: str = "plain",
            lang_only: bool = False, remat=False,
            text_span=None,
            dropout_key: Optional[DropoutKey] = None) -> ModelOutput:
    """Backbone forward.

    input_ids: (Q, B, N) combined-vocab ids. attention_mask: (B, N) without
    a cache, or (B, max_cache_len) with one (unwritten slots 0).
    vision_indices: (B, N) in [0, max_vision_token_length]; the maximum
    means text. With a cache, its buffers are updated in place and the
    returned cache's index is advanced by N. The index is a host int (all
    rows in lockstep) or a (B,) tensor (per-slot timelines, KVCache): then
    row b's queries sit at [index_b, index_b + N), the causal mask is per
    row, (B, 1, N, S), and the writes clamp their start to S - N (the mask
    does not: a row past the end is an idle slot, whose output nobody
    reads). Nothing here reads the index on the host. lang_only: text-only cached
    decode of prompts that end in text (exact: the vision vocab is -inf at
    text positions, so such a sequence never re-enters vision).
    text_span: text_span_maps' row maps, with or without a cache: the
    language projections run on the text rows only (the Generator's
    fused-pixels prompt pass passes them).

    remat (training, no cache): False = none; True or "full" = each layer
    under torch.utils.checkpoint (non-reentrant), the backward re-running
    it from its input; "dots", "big_dots" or "names:a,b" = selective
    checkpointing that saves every matmul output, or those of the named
    regions (BIG_DOT_NAMES), and recomputes the rest.

    dropout_key (training): a tuple of Python ints (ops/routed.py), JAX's
    dropout_rng; None, or a config with every rate 0, is the eval forward.
    The embedding takes the stream (key, 0), layer i (key, 1, i): each
    mask is drawn inside the layer from its integers, so a remat
    recompute redraws the same masks."""
    context_fn, named = _remat_context_fn(remat)
    if context_fn is not None and cache is not None:
        raise ValueError("remat is a training option; it takes no cache")
    flag = vision_indices < cfg.max_vision_token_length
    B, N = flag.shape
    device = flag.device
    if not dropout_enabled(cfg):
        dropout_key = None
    h = embed_inputs(params, cfg, input_ids, flag, contiguous_signal,
                     vision_indices, lang_only=lang_only)
    # routed embedding dropout
    h = routed_dropout(fold(dropout_key, 0), h, flag, cfg.vision_embd_pdrop,
                       cfg.embd_pdrop)

    if cache is None:
        rope_len = max(cfg.max_position_embeddings, N)
        kv_flag = flag
        bias = causal_bias(attention_mask, N, N)
        if position_ids is None:
            position_ids = (get_2d_position_ids(cfg, vision_indices, attention_mask)
                            if cfg.use_2d_rope
                            else position_ids_from_mask(attention_mask))
    else:
        S = cache.flag.shape[1]
        rope_len = max(cfg.max_position_embeddings, S)
        per_row = isinstance(cache.index, torch.Tensor)
        slots = row_slots(cache.index, S, N) if per_row else None
        kv_flag = _write_seq(cache.flag, flag, cache.index, slots)
        # queries occupy slots [index, index + N); keys are the whole buffer.
        # index may be per row (B,): each serving slot has its own timeline
        start = cache.index[:, None] if per_row else cache.index
        q_slots = start + torch.arange(N, device=device)            # (N,) | (B, N)
        causal = torch.arange(S, device=device) <= q_slots[..., None]  # (N, S) | (B, N, S)
        if causal.dim() == 2:
            causal = causal[None]
        keep = causal[:, None] & attention_mask.bool()[:, None, None, :]
        bias = torch.where(keep, 0.0, BIG_NEG).float()
        if position_ids is None:
            raise ValueError("position_ids must be provided when using a cache")

    cos, sin = rope_cos_sin(rope_len, cfg.head_dim, cfg.rope_theta, device=device)

    bufs = None
    if cache is not None:
        bufs = {"k": cache.k, "v": cache.v}
        if cfg.use_bridge:
            bufs.update({"kb": cache.kb, "vb": cache.vb})
    for i in range(cfg.num_hidden_layers):
        cache_slice = (None if cache is None
                       else {"bufs": bufs, "layer": i, "index": cache.index,
                             "slots": slots})
        layer = functools.partial(decoder_layer, _layer(params["layers"], i),
                                  cfg, dropout_key=fold(dropout_key, 1, i))
        if context_fn is not None:
            run = lambda x, fn=layer: fn(x, flag, cos, sin, position_ids, bias,
                                         kv_flag, None, attn_impl,
                                         text_span=text_span)[0]
            h = checkpoint(_naming_on(run) if named else run, h,
                           use_reentrant=False, context_fn=context_fn)
            continue
        h, _ = layer(h, flag, cos, sin, position_ids, bias, kv_flag,
                     cache_slice, attn_impl, text_span=text_span,
                     lang_only=lang_only)
    new_cache = None if cache is None else cache._replace(
        flag=kv_flag, index=cache.index + N)

    eps = cfg.rms_norm_eps
    if lang_only:
        h = rms_norm(h, params["norm"], eps)
    else:
        h = select_by_flag(flag, rms_norm(h, params["vision_norm"], eps),
                           rms_norm(h, params["norm"], eps))
    return ModelOutput(hidden_states=h, cache=new_cache)


# ---------------------------------------------------------------------------
# Heads / logits / loss
# ---------------------------------------------------------------------------

def compute_text_logits(params: Params, h: torch.Tensor) -> torch.Tensor:
    return qdot(h, params["lm_head"])


def compute_vision_logits(params: Params, h: torch.Tensor) -> torch.Tensor:
    """(Q, B, N, Vv) from the per-codebook vision heads (1d mode)."""
    return torch.einsum("bnd,qdv->qbnv", h, params["vision_lm_head"].to(h.dtype))


def compute_vision_logits_2d(params: Params, cfg: LibraConfig, h: torch.Tensor,
                             vision_indices: torch.Tensor,
                             h_up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, B, N, Vv) through the 2D heads (2 * D inputs), in the masked-shift
    form of the reference's augmented (R + 1) x (R + 1) map. Image blocks
    are contiguous runs, so the entry at vision index i (predicting grid
    cell c = i for i <= Mv - 3, row-major over R columns) reads:
      * up(c) = h[t - (R - 1)] when c >= R, else the placeholder (h_up,
        when given, is that hidden: the decode ring's oldest row);
      * left(c) = h[t] when c == 0 (BOI) or c % R != 0, else the placeholder;
      * entries at i in {Mv - 2, Mv - 1} take (h[t], placeholder), the
        reference's flipped order.
    Returns the einsum of those 2 * D inputs with the heads."""
    R, Mv = cfg.image_feature_resolution, cfg.max_vision_token_length
    vi = vision_indices
    ph = params["vision_hidden_placeholder"].to(h.dtype).expand(h.shape)
    if h_up is None:
        h_up = F.pad(h, (0, 0, R - 1, 0))[:, :h.shape[1]]
    grid = vi <= Mv - 3                                  # entries 0 .. R*R - 1
    up_valid = (grid & (vi >= R))[..., None]
    left_valid = (grid & ((vi == 0) | (vi % R != 0)))[..., None]
    up = torch.where(up_valid, h_up.to(h.dtype), ph)
    left = torch.where(left_valid, h, ph)
    tail = (vi >= Mv - 2)[..., None]                     # pre-EOI and EOI
    inp = torch.cat([torch.where(tail, h, up), torch.where(tail, ph, left)], dim=-1)
    return torch.einsum("bnd,qdv->qbnv", inp, params["vision_lm_head"].to(h.dtype))


def assemble_logits(cfg: LibraConfig, text_logits: torch.Tensor,
                    vision_logits: torch.Tensor,
                    flag: torch.Tensor) -> torch.Tensor:
    """(Q, B, N, V + Vv) combined fp32 logits with -inf on the wrong
    modality's slice."""
    Q = cfg.vision_codebook_num
    # -inf as a scalar operand: a host tensor would be copied to the card,
    # and that copy waits for the stream in every decode step
    neg = float("-inf")
    tl = torch.where(flag[..., None], neg, text_logits.float())
    vl = torch.where(flag[None, ..., None], vision_logits.float(), neg)
    return torch.cat([tl[None].expand((Q,) + tl.shape), vl], dim=-1)


def multicodebook_loss_terms(cfg: LibraConfig, text_logits: torch.Tensor,
                             vision_logits: torch.Tensor, flag: torch.Tensor,
                             labels: torch.Tensor, unified: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unnormalised per-codebook CE terms: (nll_sums (Q,) fp32,
    valid_counts (Q,)); the loss is mean_q(nll_q / max(valid_q, 1)), and
    gradient accumulation normalises by the group's totals instead.

    labels (Q, B, N): combined-vocab ids, -100 = ignore; logits[t] predict
    labels[t + 1]. The combined softmax is never built: a text position's
    reduces to the text slice, a vision position's to the vision slice, and
    a label of the other modality gets the logit BIG_NEG (the reference
    would give -inf). unified=True: one softmax over both slices at every
    position."""
    V = cfg.vocab_size
    tl = text_logits.float()
    vl = vision_logits.float()
    lse_text = torch.logsumexp(tl, dim=-1)            # (B, N)
    lse_vis = torch.logsumexp(vl, dim=-1)             # (Q, B, N)
    shift_flag = flag[:, :-1]
    nll_sums, valid_counts = [], []
    for q in range(cfg.vision_codebook_num):
        lab = labels[q][:, 1:]                         # (B, N - 1)
        valid = lab != -100
        lab_safe = torch.where(valid, lab, 0)
        is_text_label = lab_safe < V
        t_gather = tl[:, :-1].gather(
            -1, lab_safe.clamp(0, V - 1)[..., None])[..., 0]
        v_gather = vl[q][:, :-1].gather(
            -1, (lab_safe - V).clamp(0, cfg.vision_vocab_size - 1)[..., None])[..., 0]
        if unified:
            logit = torch.where(is_text_label, t_gather, v_gather)
            lse = torch.logaddexp(lse_text[:, :-1], lse_vis[q][:, :-1])
        else:
            logit = torch.where(shift_flag, v_gather, t_gather)
            modality_ok = torch.where(shift_flag, ~is_text_label, is_text_label)
            logit = torch.where(modality_ok, logit, BIG_NEG)
            lse = torch.where(shift_flag, lse_vis[q][:, :-1], lse_text[:, :-1])
        nll = (lse - logit) * valid
        nll_sums.append(nll.sum())
        valid_counts.append(valid.sum())
    return torch.stack(nll_sums), torch.stack(valid_counts)


def multicodebook_loss(cfg: LibraConfig, text_logits: torch.Tensor,
                       vision_logits: torch.Tensor, flag: torch.Tensor,
                       labels: torch.Tensor, unified: bool = False) -> torch.Tensor:
    """Per-codebook shifted CE over the combined vocab, averaged over the
    codebooks (see multicodebook_loss_terms)."""
    nll, valid = multicodebook_loss_terms(cfg, text_logits, vision_logits,
                                          flag, labels, unified)
    return (nll / valid.clamp_min(1)).mean()


def force_eoi_newline(cfg: LibraConfig, logits: torch.Tensor,
                      last_vision_indices: torch.Tensor) -> torch.Tensor:
    """After <EOI> (vision_index == max_vision_token_length - 1) force the
    next token to be the newline. logits: (Q, B, Vc); finite stand-ins
    for +-inf keep a downstream softmax NaN-free."""
    eoi = last_vision_indices == cfg.max_vision_token_length - 1
    forced = torch.full_like(logits, -1e30)
    forced[..., cfg.newline_token_id] = 1e30
    return torch.where(eoi[None, :, None], forced, logits)
