"""Batched device evaluator for lowered graphs.

Evaluates a ``LoweredGraph`` over a batch of Monte-Carlo samples as a
sequence of level-synchronous vector ops under ``jax.jit``:

- weights buffer ``w``: [num_slots, batch] — slot-major so a gather reads
  whole contiguous rows of ``batch`` samples
- Sum level: ``segment_sum(w[src] * f, seg)`` with sorted segments
- Prod level (per arity k): elementwise product of k gathered rows
- Power level (per exponent n): ``integer_pow`` (safe for negative bases)

The Python loop over levels unrolls at trace time: graph structure is
static, only leaf values are traced.  The reference's per-sample scalar
interpreter/compiler (eval.jl, backend/static.jl) is replaced wholesale by
this data-parallel design.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .lowering import LoweredGraph, lower
from ..computational_graph.graph import Graph


def _take(w, idx):
    """Row gather without the bounds-clamp op: all index tables are built
    host-side from slot assignments and are in bounds by construction."""
    return w.at[idx].get(mode="promise_in_bounds")


def _compensated_reduce(block: jnp.ndarray) -> jnp.ndarray:
    """Kahan-compensated sum over axis 0 (SURVEY §7.3 item 4).

    XLA preserves floating-point evaluation order (no unsafe reassociation),
    so the running-compensation recurrence survives compilation.  Roughly
    4x the arithmetic of a plain reduce; accuracy approaches f64 for f32
    storage.
    """
    s = block[0]
    c = jnp.zeros_like(s)
    for i in range(1, block.shape[0]):
        y = block[i] - c
        t = s + y
        c = (t - s) - y
        s = t
    return s


def _eval_levels(lowered: LoweredGraph, w: jnp.ndarray,
                 acc_dtype=None, compensated: bool = False,
                 chunk_rows: int = 512) -> jnp.ndarray:
    """Run all levels, returning the filled weight buffer [num_slots, batch].

    ``acc_dtype`` (optional) widens arithmetic: gathered rows are upcast,
    the op computes in ``acc_dtype``, and the block is stored back at
    ``w.dtype`` (e.g. a half-width bf16 buffer with f32 accumulation).

    ``compensated`` switches every bucket reduction to Kahan summation —
    the production path for f32 storage on graphs deep enough that plain
    f32 drifts (order >= 5).
    """
    a = acc_dtype or w.dtype
    reduce0 = _compensated_reduce if compensated else (
        lambda b: jnp.sum(b, axis=0))
    for li, level in enumerate(lowered.levels):
      # named scopes attach tf_op metadata so jax.profiler traces attribute
      # device time to (level, bucket shape) — see benchmarks/profile_pass.py
      with jax.named_scope(f"gL{li:02d}"):
        if level.sums is not None:
            s = level.sums
            with jax.named_scope("csr"):
                contrib = _take(w, s.edge_src).astype(a) * s.edge_factor[:, None].astype(a)
                block = jax.ops.segment_sum(contrib, s.edge_seg, num_segments=s.count,
                                            indices_are_sorted=True)
                w = jax.lax.dynamic_update_slice_in_dim(w, block.astype(w.dtype), s.start, axis=0)
        for sb in level.sum_buckets:
            # dense gather + reduce over the padded fan-in axis (no scatter)
            with jax.named_scope(f"sb{sb.arity}"):
                block = reduce0(_take(w, sb.idx).astype(a) * sb.fac[:, :, None].astype(a))
                w = jax.lax.dynamic_update_slice_in_dim(w, block.astype(w.dtype), sb.start, axis=0)
        for fb in level.fused:
            # uniform sum-of-products: out[c] = sum_a fac[a,c] * prod_k w[idx[k,a,c]]
            # one row gather per operand position; very large buckets
            # split into column chunks of ``chunk_rows`` rows.
            with jax.named_scope(f"fb{fb.arity}x{fb.n_op}"):
                for c0 in range(0, fb.count, chunk_rows):
                    idx = fb.idx[..., c0:c0 + chunk_rows]
                    fac = fb.fac[..., c0:c0 + chunk_rows]
                    block = _take(w, idx[0]).astype(a) * fac[:, :, None].astype(a)
                    for k in range(1, fb.n_op):
                        block = block * _take(w, idx[k]).astype(a)
                    block = reduce0(block)
                    w = jax.lax.dynamic_update_slice_in_dim(
                        w, block.astype(w.dtype), fb.start + c0, axis=0)
        for p in level.prods:
            with jax.named_scope(f"prod{p.arity}"):
                block = _take(w, p.idx[0]).astype(a)
                for k in range(1, p.arity):
                    block = block * _take(w, p.idx[k]).astype(a)
                block = block * p.factor[:, None].astype(a)
                w = jax.lax.dynamic_update_slice_in_dim(w, block.astype(w.dtype), p.start, axis=0)
        for pw in level.pows:
            with jax.named_scope(f"pow{pw.n}"):
                block = jax.lax.integer_pow(_take(w, pw.src).astype(a), pw.n) * pw.factor[:, None].astype(a)
                w = jax.lax.dynamic_update_slice_in_dim(w, block.astype(w.dtype), pw.start, axis=0)
    return w


def _eval_levels_tile(lowered: LoweredGraph, w: jnp.ndarray,
                      acc_dtype=None, compensated: bool = False,
                      unroll_max: int = 8, split_count: int = 64,
                      chunk_rows: int = 256) -> jnp.ndarray:
    """Tile-row variant of ``_eval_levels``: ``w`` is [num_slots, nsub, 128].

    Each graph row is reshaped to ``batch // 128`` rows of 128 samples.
    Buckets with at least ``split_count`` rows and arity <= ``unroll_max``
    unroll the term sum into per-(operand, term) row gathers whose
    multiply-adds fuse into the slot update; smaller buckets gather once
    per operand position and unroll the term sum as slice-adds.  Requires
    sum_mode='fused' lowering.
    """
    a = acc_dtype or w.dtype
    for li, level in enumerate(lowered.levels):
      if level.sums is not None or level.sum_buckets or level.prods:
          raise ValueError("tile layout requires sum_mode='fused' lowering")
      with jax.named_scope(f"gL{li:02d}"):
        for fb in level.fused:
            with jax.named_scope(f"fb{fb.arity}x{fb.n_op}"):
                for c0 in range(0, fb.count, chunk_rows):
                    idx = fb.idx[..., c0:c0 + chunk_rows]
                    fac = fb.fac[..., c0:c0 + chunk_rows]
                    if fb.count >= split_count and fb.arity <= unroll_max:
                        def term(t):
                            part = _take(w, idx[0, t]).astype(a) \
                                * fac[t][:, None, None].astype(a)
                            for k in range(1, fb.n_op):
                                part = part * _take(w, idx[k, t]).astype(a)
                            return part
                    else:
                        gs = [_take(w, idx[k]).astype(a)
                              for k in range(fb.n_op)]

                        def term(t):
                            part = gs[0][t] * fac[t][:, None, None].astype(a)
                            for k in range(1, fb.n_op):
                                part = part * gs[k][t]
                            return part
                    blk = term(0)
                    comp = jnp.zeros_like(blk) if compensated else None
                    for t in range(1, fb.arity):
                        part = term(t)
                        if compensated:
                            y = part - comp
                            tsum = blk + y
                            comp = (tsum - blk) - y
                            blk = tsum
                        else:
                            blk = blk + part
                    w = jax.lax.dynamic_update_slice_in_dim(
                        w, blk.astype(w.dtype), fb.start + c0, axis=0)
        for pw in level.pows:
            with jax.named_scope(f"pow{pw.n}"):
                blk = jax.lax.integer_pow(_take(w, pw.src).astype(a), pw.n) \
                    * pw.factor[:, None, None].astype(a)
                w = jax.lax.dynamic_update_slice_in_dim(
                    w, blk.astype(w.dtype), pw.start, axis=0)
    return w


def resolve_layout(layout: str) -> str:
    """The weight-buffer layout ('flat' or 'tile') that ``layout`` names.

    'auto' is 'flat' on every platform: on an H100 80GB HBM3 (400 W power
    limit) the MC loop at order-4 Gamma4, batch 2048, f32 ran at ~1.41M
    samples/s flat against ~1.36M tile, flat ahead in every alternated run.
    """
    if layout not in ("auto", "flat", "tile"):
        raise ValueError(f"unknown layout {layout!r}")
    return "flat" if layout == "auto" else layout


def make_evaluator(lowered: LoweredGraph, *, dtype=None, jit: bool = True,
                   return_all: bool = False, acc_dtype=None,
                   compensated: bool = False, layout: str = "auto",
                   chunk_rows: Optional[int] = None):
    """Build ``f(leaf_values[num_leaves, batch]) -> roots[num_roots, batch]``.

    ``leaf_values`` covers the non-constant leaf slots (0..nl-1); constant
    slots are appended internally.  With ``return_all`` the full weight
    buffer is returned (used by lowering-equivalence tests).

    ``dtype``/``acc_dtype`` are generic: e.g. ``dtype=jnp.bfloat16,
    acc_dtype=jnp.float32`` gives a half-width weight buffer with f32
    accumulation.  This is a low-level capability only (~1% storage error,
    flat layout).

    ``layout``: 'flat' keeps the weight buffer [num_slots, batch];
    'tile' reshapes it to [num_slots, batch//128, 128] (see
    ``_eval_levels_tile``); 'auto' (default) is ``resolve_layout``'s
    choice.  Results are identical up to summation order.
    """
    if dtype is None:
        from .dtypes import default_device_dtype
        dtype = default_device_dtype()
    num_slots = lowered.num_slots
    nl_total = lowered.num_leaves
    n_const = len(lowered.const_slots)
    nl_input = nl_total - n_const
    const_values = jnp.asarray(lowered.const_values, dtype)
    root_slots = jnp.asarray(lowered.root_slots)
    fused_only = all(lvl.sums is None and not lvl.sum_buckets and not lvl.prods
                     for lvl in lowered.levels)
    tile_layout = resolve_layout(layout) == "tile"
    if tile_layout and not fused_only:
        raise ValueError("layout='tile' requires sum_mode='fused' lowering")

    def _tile_ok(batch: int) -> bool:
        if not tile_layout:
            return False
        # explicit request: reject unsupported configs loudly instead of
        # silently falling back
        if jnp.dtype(dtype).itemsize != 4:
            raise ValueError(
                "layout='tile' supports 4-byte dtypes only (the tile-row "
                f"buffer assumes the f32 (8, 128) tile); got {dtype}")
        if batch % 256 != 0:
            raise ValueError("layout='tile' needs batch % 256 == 0")
        return True

    def evaluate(leaf_values: jnp.ndarray) -> jnp.ndarray:
        leaf_values = jnp.asarray(leaf_values, dtype)
        if leaf_values.ndim == 1:
            leaf_values = leaf_values[:, None]
        if leaf_values.ndim == 3:
            # pre-tiled [nl, nsub, 128] input (a tile-layout leaf evaluator)
            if leaf_values.shape[2] != 128 or not fused_only:
                raise ValueError("3-D leaf input must be [nl, nsub, 128] "
                                 "for a fused-mode lowering")
            batch = leaf_values.shape[1] * 128
            tile = True
        else:
            batch = leaf_values.shape[1]
            tile = _tile_ok(batch)
        if tile:
            nsub = batch // 128
            leaf_values = leaf_values.reshape(nl_input, nsub, 128)
            w = jnp.zeros((num_slots, nsub, 128), dtype)
        else:
            w = jnp.zeros((num_slots, batch), dtype)
        w = jax.lax.dynamic_update_slice_in_dim(w, leaf_values, 0, axis=0)
        if n_const:
            cv = jnp.broadcast_to(
                const_values.reshape((n_const,) + (1,) * (w.ndim - 1)),
                (n_const,) + w.shape[1:])
            w = jax.lax.dynamic_update_slice_in_dim(w, cv, nl_input, axis=0)
        # bucket-chunk size: rows per gather block of a large bucket.
        # Untuned on the GPU: 256 for the tile layout, 512 for flat.
        if tile:
            w = _eval_levels_tile(lowered, w, acc_dtype, compensated,
                                  chunk_rows=chunk_rows or 256)
        else:
            w = _eval_levels(lowered, w, acc_dtype, compensated,
                             chunk_rows=chunk_rows or 512)
        if return_all:
            return w.reshape(num_slots, batch) if tile else w
        out = w[root_slots]
        if tile:
            out = out.reshape(len(lowered.root_slots), batch)
        return out.astype(acc_dtype) if acc_dtype is not None else out

    return jax.jit(evaluate) if jit else evaluate


def evaluate_graphs(roots: Sequence[Graph], leaf_values,
                    leafmap: Optional[Dict[int, int]] = None, *,
                    dtype=None):
    """One-shot convenience: lower + evaluate ``roots`` on ``leaf_values``.

    ``leaf_values``: [num_leaves] or [num_leaves, batch], indexed by
    ``leafmap`` (or by lowering's first-visit leaf order when absent — in
    that case pass values for leaves in ``lowered.leaf_uid_to_slot`` order).
    """
    lowered = lower(roots, leafmap)
    f = make_evaluator(lowered, dtype=dtype)
    return np.asarray(f(jnp.asarray(leaf_values)))
