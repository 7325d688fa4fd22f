"""Memory-partitioned (graph-sharded) evaluation across a device mesh.

For DAGs too large to evaluate per chip at full batch (BASELINE config 5),
the slot space itself is partitioned: device d owns the leaf-block shard
plus an equal chunk of every bucket's output rows, so the per-device weight
buffer is ~``live_slots / n`` rows — NOT a replica of the full buffer.
Per topological level:

1. every device gathers, from its *local* buffer, the rows it owns among
   the union of slots read at this level (its send block, padded to the
   per-level maximum H_l);
2. ``all_gather`` over the ``graph`` mesh axis assembles the level's halo
   buffer ``[n*H_l, batch]`` — exactly the level's boundary activations.
   The exchange is split in two: rows produced at the *immediately
   preceding* level ride a "late" gather that the level must wait for,
   while rows produced earlier ride an "early" gather emitted BEFORE the
   previous level's compute, so XLA's async collective scheduler can
   overlap it with that compute (SURVEY §7.3-7);
3. each device computes its chunk of every bucket reading only from the
   halo (operand indices are remapped host-side to halo positions) and
   writes the chunk at its local offset.

Per-device slot reuse: ownership of global slots is
single-assignment (the lowering must use ``reuse_slots=False``), but each
device recycles its *local* rows with the same lifetime-based
contiguous-interval allocator the single-chip lowering uses, once the last
level reading a row has run.  Local layouts therefore differ per device;
all per-device tables (send indices, output offsets) are stacked over the
device axis and dynamic-indexed under ``shard_map``.  This reconciles the
two memory mechanisms: per-device rows ~ live_slots/n.

Ownership balancing: bucket rows can be assigned to devices contiguously
(``ks // chunk``) or round-robin (``ks % n``); the planner computes both
and keeps whichever produces less total halo padding (halo rows are padded
to the worst-owner count per level).

Root rows are assembled with one final exchange.  Composes with batch-axis
data parallelism on a 2-D (graph x batch) mesh.  Works for
``sum_mode='fused'`` (the production mode) and ``'bucketed'``.

No reference counterpart (the reference is single-process,
/root/reference/src/computational_graph/eval.jl); this is the multi-device
scale-out the brief adds (SURVEY §5.8b, §7.3-7).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.lowering import LoweredGraph, TILE_ROWS, _pad_to

GRAPH_AXIS = "graph"


@dataclass
class _ShardedGroup:
    """One bucket of one level, chunked across devices.

    Index arrays are already remapped to halo positions and reshaped so
    axis -2 is the device axis (each device dynamic-indexes its chunk).
    """
    kind: str                 # 'sum' | 'fused' | 'prod' | 'pow'
    local_off: np.ndarray     # [n] per-device output offset in local buffer
    chunk: int                # output rows per device
    idx: np.ndarray           # sum: [A, n, chunk]; fused: [K, A, n, chunk];
                              # prod: [A, n, chunk]; pow: [n, chunk]
    fac: np.ndarray           # sum/fused: [A, n, chunk]; prod/pow: [n, chunk]
    pow_n: int = 0


@dataclass
class _LevelSched:
    early_send: np.ndarray    # [n, He] local rows for the EARLY halo
    late_send: np.ndarray     # [n, Hl] local rows for the LATE halo
    groups: List[_ShardedGroup]
    early_rows: int           # n * He
    late_rows: int            # n * Hl
    read_rows: int            # true union size (pre-padding)


@dataclass
class ShardStats:
    """Memory/communication footprint of a graph-sharded plan."""
    n_dev: int
    full_slots: int           # slots of the unsharded (reuse_slots=False) buffer
    local_slots: int          # per-device buffer rows (max over devices)
    halo_rows_per_level: List[int]     # early + late, per level (+ roots)
    read_rows_per_level: List[int]
    early_rows_per_level: List[int] = field(default_factory=list)
    interleaved: bool = False

    def halo_bytes_per_sample(self, itemsize: int = 4) -> int:
        """Bytes received per device per batch element over a full pass."""
        return sum(self.halo_rows_per_level) * itemsize

    @property
    def halo_pad_overhead(self) -> float:
        """Exchanged rows / true boundary rows (1.0 = no padding waste)."""
        return sum(self.halo_rows_per_level) / max(sum(self.read_rows_per_level), 1)

    @property
    def early_share(self) -> float:
        """Fraction of halo rows on the EARLY (compute-overlapped) gather."""
        tot = sum(self.halo_rows_per_level)
        return sum(self.early_rows_per_level) / max(tot, 1)


class _LocalPool:
    """Per-device contiguous-interval first-fit allocator (local rows)."""

    def __init__(self, top: int):
        self.top = top
        self.intervals: List[List[int]] = []
        self.pending: List[int] = []

    def free(self, slots) -> None:
        self.pending.extend(slots)

    def _merge(self) -> None:
        if not self.pending:
            return
        ivs = self.intervals + [[p, p + 1] for p in self.pending]
        self.pending = []
        ivs.sort()
        merged: List[List[int]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1][1] = e
            else:
                merged.append([s, e])
        self.intervals = merged

    def alloc(self, count: int, align: int = 1) -> int:
        self._merge()
        for k, (s, e) in enumerate(self.intervals):
            s_al = _pad_to(s, align)
            if e - s_al >= count:
                if s_al > s:
                    self.intervals[k] = [s, s_al]
                    if e > s_al + count:
                        self.intervals.insert(k + 1, [s_al + count, e])
                elif e - s == count:
                    del self.intervals[k]
                else:
                    self.intervals[k][0] = s + count
                return s_al
        s = _pad_to(self.top, align)
        if s > self.top:
            self.intervals.append([self.top, s])
            self.intervals.sort()
        self.top = s + count
        return s


def _collect_groups(lowered: LoweredGraph):
    """[(level, kind, plan)] in evaluation order."""
    if any(lvl.sums is not None for lvl in lowered.levels):
        raise ValueError(
            "graph-sharded evaluation requires sum_mode='bucketed' or 'fused' "
            "(csr segment-sums scatter across the slot partition)")
    out = []
    for li, lvl in enumerate(lowered.levels):
        plans = ([("sum", sb) for sb in lvl.sum_buckets]
                 + [("fused", fb) for fb in lvl.fused]
                 + [("prod", p) for p in lvl.prods]
                 + [("pow", pw) for pw in lvl.pows])
        for kind, plan in plans:
            out.append((li, kind, plan))
    return out


def _reads_of(kind: str, plan) -> np.ndarray:
    if kind in ("sum", "fused", "prod"):
        return np.asarray(plan.idx).ravel()
    return np.asarray(plan.src).ravel()


def _plan(lowered: LoweredGraph, n_dev: int, *, interleave: bool = False,
          local_reuse: bool = True) -> Tuple[List[_LevelSched], ShardStats,
                                             np.ndarray, np.ndarray, int]:
    """Host-side planner: ownership map, per-device local layouts (with
    lifetime-based reuse), per-level split halo schedules, root plan.

    Returns (levels, stats, root_send_idx[n, Hr], root_pos[R], leaf_chunk).
    """
    num_slots = lowered.num_slots
    nl = lowered.num_leaves
    n_levels = len(lowered.levels)
    leaf_chunk = _pad_to(nl, n_dev) // n_dev

    groups = _collect_groups(lowered)

    # ---- ownership (global slot -> device, chunk position)
    owner = np.full(num_slots, -1, np.int32)
    chunk_pos = np.full(num_slots, -1, np.int32)   # position within the chunk
    write_level = np.full(num_slots, -1, np.int32)  # level producing the slot
    s = np.arange(nl)
    owner[s] = s // leaf_chunk                      # leaves: contiguous (input
    chunk_pos[s] = s % leaf_chunk                   # sharding is contiguous)
    write_level[s] = -1

    meta = []  # per group: (level, kind, plan, chunk)
    for li, kind, plan in groups:
        count, start = plan.count, plan.start
        chunk = _pad_to(count, n_dev) // n_dev
        ks = np.arange(count)
        if (owner[start + ks] != -1).any():
            raise ValueError(
                "slot ownership conflict: lower with reuse_slots=False "
                "for graph-sharded evaluation")
        if interleave:
            owner[start + ks] = ks % n_dev
            chunk_pos[start + ks] = ks // n_dev
        else:
            owner[start + ks] = ks // chunk
            chunk_pos[start + ks] = ks % chunk
        write_level[start + ks] = li
        meta.append((li, kind, plan, chunk))

    # ---- lifetimes: last level (or root epoch) reading each global slot
    ROOT_EPOCH = n_levels
    last_read = np.full(num_slots, -1, np.int32)
    for li, kind, plan in groups:
        rd = np.unique(_reads_of(kind, plan))
        last_read[rd] = np.maximum(last_read[rd], li)
    roots = np.asarray(lowered.root_slots)
    last_read[roots] = ROOT_EPOCH

    # ---- per-device local layout with lifetime reuse
    local = np.full((n_dev, num_slots), -1, np.int32)
    local_offs: Dict[int, np.ndarray] = {}
    for d in range(n_dev):
        mine = s[owner[s] == d]
        local[d, mine] = chunk_pos[mine]            # leaf rows pinned at 0..
    if local_reuse:
        pools = [_LocalPool(leaf_chunk) for _ in range(n_dev)]
        # free queue: level -> per-device list of local rows
        free_at: List[List[List[int]]] = [
            [[] for _ in range(n_dev)] for _ in range(n_levels + 1)]
        cur_level = 0
        for gi, (li, kind, plan, chunk) in enumerate(meta):
            while cur_level < li:
                for d in range(n_dev):
                    pools[d].free(free_at[cur_level][d])
                cur_level += 1
            count, start = plan.count, plan.start
            gslots = start + np.arange(count)
            offs = np.zeros(n_dev, np.int32)
            for d in range(n_dev):
                off = pools[d].alloc(chunk, TILE_ROWS)
                offs[d] = off
                mine = gslots[owner[gslots] == d]
                local[d, mine] = off + chunk_pos[mine]
                for g in mine:
                    lr = last_read[g]
                    if lr < ROOT_EPOCH:
                        free_at[max(lr, li)][d].append(local[d, g])
                # chunk-padding rows (no global slot) free immediately
                used = set(chunk_pos[mine].tolist())
                free_at[li][d].extend(off + p for p in range(chunk)
                                      if p not in used)
            local_offs[gi] = offs
        local_top = max(p.top for p in pools) if pools else leaf_chunk
    else:
        local_top = leaf_chunk
        for gi, (li, kind, plan, chunk) in enumerate(meta):
            # TILE_ROWS-align each group's offset so layout='tile' writes
            # whole sublane tiles in this branch too
            local_top = _pad_to(local_top, TILE_ROWS)
            count, start = plan.count, plan.start
            gslots = start + np.arange(count)
            for d in range(n_dev):
                mine = gslots[owner[gslots] == d]
                local[d, mine] = local_top + chunk_pos[mine]
            local_offs[gi] = np.full(n_dev, local_top, np.int32)
            local_top += chunk

    # ---- halo schedules (early/late split)
    def halo_schedule(read_slots: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
        """(send_idx[n, H], pos[num_slots], n*H) for a set of read global
        slots: pos[s] = position of row s in the gathered halo."""
        own = owner[read_slots]
        counts = np.bincount(own, minlength=n_dev)
        H = max(int(counts.max()), 1) if len(read_slots) else 1
        send_idx = np.zeros((n_dev, H), np.int32)
        pos = np.full(num_slots, 0, np.int32)
        for d in range(n_dev):
            mine = read_slots[own == d]
            send_idx[d, :len(mine)] = local[d, mine]
            pos[mine] = d * H + np.arange(len(mine))
        return send_idx, pos, n_dev * H

    levels: List[_LevelSched] = []
    halo_rows_per_level: List[int] = []
    early_rows_per_level: List[int] = []
    read_rows_per_level: List[int] = []
    by_level: List[List[Tuple[int, str, object, int]]] = [[] for _ in range(n_levels)]
    for gi, (li, kind, plan, chunk) in enumerate(meta):
        by_level[li].append((gi, kind, plan, chunk))

    for li in range(n_levels):
        lvl_groups = by_level[li]
        reads = [_reads_of(kind, plan) for _, kind, plan, _ in lvl_groups]
        read_slots = (np.unique(np.concatenate(reads)) if reads
                      else np.zeros(0, np.int64))
        # EARLY: produced strictly before the previous level (or leaves) —
        # exchangeable while level li-1 computes.  LATE: produced at li-1.
        late_mask = write_level[read_slots] == li - 1
        early_slots = read_slots[~late_mask]
        late_slots = read_slots[late_mask]
        early_send, early_pos, early_rows = halo_schedule(early_slots)
        late_send, late_pos, late_rows = halo_schedule(late_slots)
        # combined halo = [early | late]: late positions shift by early_rows
        pos = early_pos.copy()
        pos[late_slots] = late_pos[late_slots] + early_rows

        sched_groups: List[_ShardedGroup] = []
        for gi, kind, plan, chunk in lvl_groups:
            count_p = chunk * n_dev

            def pad_cols(a: np.ndarray, fill=0) -> np.ndarray:
                """Pad the trailing (node) axis to count_p, then split it
                into [n_dev, chunk] (device-major or interleaved to match
                the ownership layout)."""
                out = np.full(a.shape[:-1] + (count_p,), fill, a.dtype)
                out[..., :a.shape[-1]] = a
                if interleave:
                    return out.reshape(
                        a.shape[:-1] + (chunk, n_dev)).swapaxes(-1, -2)
                return out.reshape(a.shape[:-1] + (n_dev, chunk))

            offs = local_offs[gi]
            if kind == "sum":
                sched_groups.append(_ShardedGroup(
                    "sum", offs, chunk, pad_cols(pos[plan.idx]),
                    pad_cols(plan.fac, 0)))
            elif kind == "fused":
                sched_groups.append(_ShardedGroup(
                    "fused", offs, chunk, pad_cols(pos[plan.idx]),
                    pad_cols(plan.fac, 0)))
            elif kind == "prod":
                sched_groups.append(_ShardedGroup(
                    "prod", offs, chunk, pad_cols(pos[plan.idx]),
                    pad_cols(plan.factor, 0)))
            else:
                sched_groups.append(_ShardedGroup(
                    "pow", offs, chunk, pad_cols(pos[plan.src]),
                    pad_cols(plan.factor, 0), pow_n=plan.n))
        levels.append(_LevelSched(early_send, late_send, sched_groups,
                                  early_rows, late_rows, len(read_slots)))
        halo_rows_per_level.append(early_rows + late_rows)
        early_rows_per_level.append(early_rows)
        read_rows_per_level.append(len(read_slots))

    root_send_idx, root_pos_map, root_halo = halo_schedule(roots)
    root_pos = root_pos_map[roots]
    halo_rows_per_level.append(root_halo)
    early_rows_per_level.append(0)
    read_rows_per_level.append(len(np.unique(roots)))

    stats = ShardStats(n_dev, num_slots, local_top, halo_rows_per_level,
                       read_rows_per_level, early_rows_per_level, interleave)
    return levels, stats, root_send_idx, root_pos, leaf_chunk


def _resolve_plan(lowered: LoweredGraph, n_dev: int,
                  interleave: Optional[bool], local_reuse: bool):
    """Plan both ownership layouts when ``interleave`` is None and keep the
    one with less total halo traffic."""
    if interleave is None:
        plans = [_plan(lowered, n_dev, interleave=i, local_reuse=local_reuse)
                 for i in (False, True)]
        plans.sort(key=lambda p: sum(p[1].halo_rows_per_level))
        return plans[0]
    return _plan(lowered, n_dev, interleave=interleave,
                 local_reuse=local_reuse)


def _make_device_eval(levels, stats, root_send_idx, root_pos, dtype,
                      graph_axis: str, layout: str = "flat"):
    """Per-device evaluation body shared by the sharded evaluator and the
    sharded MC step: ``device_fn(leaf_block [leaf_chunk, b]) -> roots``."""
    root_pos_j = jnp.asarray(root_pos)
    # device-constant tables (stacked over the device axis; each device
    # dynamic-indexes its own slice under shard_map)
    early_tabs = [jnp.asarray(lv.early_send) for lv in levels]
    late_tabs = [jnp.asarray(lv.late_send) for lv in levels]
    root_send_tab = jnp.asarray(root_send_idx)

    def device_fn(leaf_block):
        """leaf_block: [leaf_chunk, batch] — this device's leaf rows.

        With ``layout='tile'`` the local buffer and halos are kept in the
        tile-row form [rows, batch//128, 128], as in the single-device
        tile evaluator (ops.evaluator._eval_levels_tile).
        """
        d = jax.lax.axis_index(graph_axis)
        batch = leaf_block.shape[1]
        tile = layout == "tile"
        if tile:
            if batch % 256:
                raise ValueError("layout='tile' needs per-device batch "
                                 "% 256 == 0")
            nsub = batch // 128
            leaf_block = leaf_block.reshape(leaf_block.shape[0], nsub, 128)
            w = jnp.zeros((stats.local_slots, nsub, 128), dtype)
        else:
            w = jnp.zeros((stats.local_slots, batch), dtype)
        w = jax.lax.dynamic_update_slice_in_dim(
            w, leaf_block.astype(dtype), 0, axis=0)
        exp1 = (None, None) if tile else (None,)

        def gather_halo(tab):
            send = jax.lax.dynamic_index_in_dim(tab, d, axis=0, keepdims=False)
            return jax.lax.all_gather(w[send], graph_axis, axis=0, tiled=True)

        # EARLY halo of level l is emitted before level l-1's compute, so
        # the collective overlaps that level's work (async scheduling).
        early_halo = gather_halo(early_tabs[0]) if levels else None
        for lev_i, lv in enumerate(levels):
            with jax.named_scope(f"sL{lev_i:02d}"):
                late_halo = gather_halo(late_tabs[lev_i])
                next_early = (gather_halo(early_tabs[lev_i + 1])
                              if lev_i + 1 < len(levels) else None)
                halo = jnp.concatenate([early_halo, late_halo], axis=0)
                w_new = w
                for g in lv.groups:
                    idx = jax.lax.dynamic_index_in_dim(
                        jnp.asarray(g.idx), d, axis=-2, keepdims=False)
                    fac = jax.lax.dynamic_index_in_dim(
                        jnp.asarray(g.fac, dtype), d, axis=-2, keepdims=False)
                    if g.kind == "sum":
                        blk = jnp.sum(halo[idx] * fac[(...,) + exp1], axis=0)
                    elif g.kind == "fused":
                        # unrolled term sum (same rationale as the tile
                        # single-chip path: slice-adds beat multiply_reduce)
                        blk = None
                        for t in range(idx.shape[1]):
                            part = halo[idx[0, t]] * fac[(t,) + (...,) + exp1]
                            for k in range(1, idx.shape[0]):
                                part = part * halo[idx[k, t]]
                            blk = part if blk is None else blk + part
                    elif g.kind == "prod":
                        blk = halo[idx[0]]
                        for a in range(1, idx.shape[0]):
                            blk = blk * halo[idx[a]]
                        blk = blk * fac[(...,) + exp1]
                    else:
                        blk = jax.lax.integer_pow(halo[idx], g.pow_n) \
                            * fac[(...,) + exp1]
                    off = jax.lax.dynamic_index_in_dim(
                        jnp.asarray(g.local_off), d, axis=0, keepdims=False)
                    w_new = jax.lax.dynamic_update_slice_in_dim(
                        w_new, blk.astype(dtype), off, axis=0)
                w = w_new
                early_halo = next_early

        root_send = jax.lax.dynamic_index_in_dim(
            root_send_tab, d, axis=0, keepdims=False)
        root_halo = jax.lax.all_gather(w[root_send], graph_axis,
                                       axis=0, tiled=True)
        roots_blk = root_halo[root_pos_j]
        if tile:
            roots_blk = roots_blk.reshape(len(root_pos), batch)
        return roots_blk                                          # [R, batch]

    return device_fn


def lower_sharded_best(roots, leafmap, n_dev: int, *, sum_mode: str = "fused",
                       cse: bool = True, interleave: Optional[bool] = None,
                       local_reuse: bool = True, **lower_kw):
    """Lower ``roots`` for graph sharding with the level schedule that
    minimizes the per-device footprint on an ``n_dev`` mesh.

    Neither schedule dominates for the sharded planner either (counted on
    the host: ALAP wins orders 3-4, ASAP wins order 5 — 6,658 vs 5,781
    local slots and 4% less halo at n=8), so the generate-once
    workflow lowers under BOTH and keeps the plan with fewer local slots
    (halo rows break ties).  Returns ``(lowered, schedule)``; pass the
    lowering to ``make_graph_sharded_evaluator``/``make_graph_sharded_mc_step``.
    """
    from ..ops.lowering import lower

    best = None
    for sched in ("alap", "asap"):
        low = lower(roots, leafmap, sum_mode=sum_mode, cse=cse,
                    reuse_slots=False, schedule=sched, **lower_kw)
        _, stats, *_ = _resolve_plan(low, n_dev, interleave, local_reuse)
        key = (stats.local_slots, sum(stats.halo_rows_per_level))
        if best is None or key < best[0]:
            best = (key, low, sched)
    return best[1], best[2]


def make_graph_sharded_evaluator(lowered: LoweredGraph, mesh: Mesh, *,
                                 graph_axis: str = GRAPH_AXIS,
                                 batch_axis: Optional[str] = None,
                                 dtype=None, local_reuse: bool = True,
                                 interleave: Optional[bool] = None,
                                 layout: str = "flat"):
    """Build ``f(leaf_values[num_leaves, batch]) -> roots[R, batch]`` with a
    slot-partitioned weight buffer: per-device memory is
    ``stats.local_slots`` rows (~``live_slots / n`` with the default
    per-device reuse) plus transient per-level halo buffers.  The returned
    function carries the planner's footprint as ``.stats``.

    ``interleave=None`` plans both ownership layouts and keeps the one with
    less total halo traffic.
    """
    if dtype is None:
        from ..ops.dtypes import default_device_dtype
        dtype = default_device_dtype()

    n_dev = mesh.shape[graph_axis]
    levels, stats, root_send_idx, root_pos, leaf_chunk = _resolve_plan(
        lowered, n_dev, interleave, local_reuse)

    nl_total = lowered.num_leaves
    n_const = len(lowered.const_slots)
    const_values = np.asarray(lowered.const_values)

    device_fn = _make_device_eval(levels, stats, root_send_idx, root_pos,
                                  dtype, graph_axis, layout)
    sharded = jax.shard_map(device_fn, mesh=mesh,
                            in_specs=(P(graph_axis, batch_axis),),
                            out_specs=P(None, batch_axis), check_vma=False)

    leaf_rows_padded = leaf_chunk * n_dev

    def evaluate(leaf_values):
        leaf_values = jnp.asarray(leaf_values, dtype)
        if leaf_values.ndim == 1:
            leaf_values = leaf_values[:, None]
        batch = leaf_values.shape[1]
        blocks = [leaf_values]
        if n_const:
            blocks.append(jnp.broadcast_to(
                jnp.asarray(const_values, dtype)[:, None], (n_const, batch)))
        pad = leaf_rows_padded - nl_total
        if pad:
            blocks.append(jnp.zeros((pad, batch), dtype))
        full = jnp.concatenate(blocks, axis=0) if len(blocks) > 1 else blocks[0]
        return sharded(full)

    class _Sharded:
        """Callable wrapper carrying the planner footprint as ``.stats``."""

        def __init__(self, fn, stats):
            self._fn = fn
            self.stats = stats

        def __call__(self, leaf_values):
            return self._fn(leaf_values)

    return _Sharded(jax.jit(evaluate), stats)


def make_graph_sharded_mc_step(lowered: LoweredGraph, tables, mesh: Mesh, *,
                               beta: float, kF: float, lam: float,
                               graph_axis: str = GRAPH_AXIS,
                               batch_axis: str = "batch",
                               dtype=None, local_reuse: bool = True,
                               interleave: Optional[bool] = None,
                               layout: str = "flat",
                               interaction_convention: str = "lambda_power"):
    """The BASELINE-config-5 production shape: one Monte-Carlo estimation
    step with the graph memory-partitioned over ``graph_axis`` AND samples
    data-parallel over ``batch_axis``, everything on device under one jit.

    Per (graph-rank g, batch-rank b) device and loop iteration: draw the
    batch shard's samples (PRNG folded by batch rank and iteration — the
    same samples across graph ranks, as the slot partition requires),
    evaluate the leaf physics, slice this device's leaf rows, run the
    halo-exchanged leveled evaluation, and accumulate root sums; the final
    estimator means reduce with one pmean over the batch axis.

    Returns ``step(key, batch_per_device, iters) -> means[R]`` plus the
    planner footprint as ``.stats``.  No reference counterpart (the
    reference MC driver is a single-process scalar loop,
    /root/reference/example/benchmark.jl:39-87).
    """
    from ..ops.leaf_eval import make_leaf_evaluator

    if dtype is None:
        from ..ops.dtypes import default_device_dtype
        dtype = default_device_dtype()

    n_graph = mesh.shape[graph_axis]
    levels, stats, root_send_idx, root_pos, leaf_chunk = _resolve_plan(
        lowered, n_graph, interleave, local_reuse)
    device_eval = _make_device_eval(levels, stats, root_send_idx, root_pos,
                                    dtype, graph_axis, layout)

    nl_total = lowered.num_leaves
    n_const = len(lowered.const_slots)
    nl_input = nl_total - n_const
    const_values = np.asarray(lowered.const_values)
    leaf_rows_padded = leaf_chunk * n_graph
    leaf_fn = make_leaf_evaluator(tables, beta=beta, kF=kF, lam=lam,
                                  dtype=dtype, layout="flat",
                                  interaction_convention=interaction_convention)
    max_loop = tables.loop_basis.shape[1]
    num_tau = int(max(tables.tau_in.max(), tables.tau_out.max()))
    n_roots = len(lowered.root_slots)

    from functools import lru_cache

    # bounded: each entry pins a full compiled sharded executable; a shape
    # sweep should not accumulate them indefinitely
    @lru_cache(maxsize=8)
    def _build(batch_per_device: int, iters: int):
        """Construct + jit the sharded program once per (batch, iters)
        shape: rebuilding it per call would retrace and recompile it."""
        def device_fn(key):
            d = jax.lax.axis_index(graph_axis)
            b = jax.lax.axis_index(batch_axis)

            def body(i, acc):
                k = jax.random.fold_in(jax.random.fold_in(key[0], b), i)
                k1, k2 = jax.random.split(k)
                vk = jax.random.normal(
                    k1, (3, max_loop, batch_per_device), dtype)
                vt = jax.random.uniform(
                    k2, (num_tau, batch_per_device), dtype) * beta
                lv = leaf_fn(vk, vt)                 # [nl_input, bpd]
                blocks = [lv]
                if n_const:
                    blocks.append(jnp.broadcast_to(
                        jnp.asarray(const_values, dtype)[:, None],
                        (n_const, batch_per_device)))
                pad = leaf_rows_padded - nl_total
                if pad:
                    blocks.append(jnp.zeros((pad, batch_per_device), dtype))
                full = (jnp.concatenate(blocks, axis=0)
                        if len(blocks) > 1 else blocks[0])
                leaf_block = jax.lax.dynamic_slice_in_dim(
                    full, d * leaf_chunk, leaf_chunk, axis=0)
                roots = device_eval(leaf_block)      # [R, bpd]
                return acc + jnp.sum(roots, axis=1)

            tot = jax.lax.fori_loop(0, iters, body,
                                    jnp.zeros((n_roots,), dtype))
            mean = tot / (iters * batch_per_device)
            return jax.lax.pmean(mean, batch_axis)

        return jax.jit(jax.shard_map(device_fn, mesh=mesh, in_specs=(P(None),),
                                     out_specs=P(), check_vma=False))

    def step(key, batch_per_device: int, iters: int):
        keys = jnp.broadcast_to(key, (1,) + key.shape)
        return _build(int(batch_per_device), int(iters))(keys)

    step.stats = stats
    return step
