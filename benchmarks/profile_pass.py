"""Per-phase device-time attribution of the production MC pass.

Runs the default bench configuration (order-4 Gamma4, fused lowering, the
on-device MC loop of ``benchmarks/_mc_bench.py`` at batch 2048, f32) under
``jax.profiler.trace`` on an NVIDIA GPU and aggregates the durations of the
GPU device plane's events by pipeline phase.

A GPU trace names each kernel or copy by its HLO instruction (``hlo_op``;
kernels replayed from a CUDA graph carry ``hlo_op == "command_buffer"`` and
the instruction's name, dots turned to underscores, as the event name).
The compiled module's HLO text maps each instruction to the ``op_name``
metadata that the named scopes of the evaluator, leaf kernels and MC loop
write:

- prng      : per-iteration threefry sampling (vk, vt)
- loops     : LoopPool matmul + |q|^2
- leaf      : physics kernels per (type, derivative order), ``leafG*/V*``
- graph     : graph-eval level NN (``gLNN``), by bucket shape
- accum     : root accumulation
- other     : copies, loop control, anything unattributed

It also reports the device idle share of the traced window: one minus the
union of the module's event intervals over the span from its first event's
start to its last event's end.

Usage: python benchmarks/profile_pass.py [order] [batch] [iters] [--levels]
Writes the aggregate table to stdout; per-level detail with --levels.  The
trace is kept under ``$TMPDIR``; its directory is printed.
"""
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from _mc_bench import make_mc_chunk  # noqa: E402

MODULE = "jit_mc_chunk"
PHASES = ["prng", "loops", "leaf", "graph", "accum", "other"]
PHASE_RES = [
    ("prng", re.compile(r"/prng/")),
    ("loops", re.compile(r"/loops/")),
    ("leaf", re.compile(r"/leaf[GV]\d+/")),
    ("graph", re.compile(r"/gL\d+/")),
    ("accum", re.compile(r"/accum/")),
]
LEVEL_RE = re.compile(r"/(gL\d+)/(?:([a-z]+[\dx]*)/)?")
LEAF_RE = re.compile(r"/(leaf[GV]\d+)/")
HLO_LINE_RE = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*?op_name="([^"]*)"',
    re.M)


def build_mc_chunk(order: int, batch: int, iters: int):
    import jax.numpy as jnp

    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  Ver4Diag, vertex4)
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.backends.compile import compile_evaluator

    dtype = jnp.float32
    para = DiagPara(type=Ver4Diag, innerLoopNum=order, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    df = vertex4(para)
    roots = [row["diagram"] for row in df]
    optimize_inplace(roots, level=1)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                 beta=0.5, kF=1.919, lam=1.0, dtype=dtype)
    # the bench protocol's own MC loop (benchmarks/_mc_bench.py)
    mc_chunk = make_mc_chunk(compiled.fn, n_loop=para.totalLoopNum,
                             num_tau=para.totalTauNum, batch=batch,
                             n_roots=len(compiled.lowered.root_slots),
                             dtype=dtype, iters=iters, beta=0.5)
    return mc_chunk, compiled


def device_events(trace: dict, module: str = MODULE):
    """Complete events of the GPU device planes (processes named
    ``/device:GPU:<n>``, every stream) that belong to HLO ``module``."""
    ev = trace["traceEvents"]
    dev_pids = {e["pid"] for e in ev if e.get("ph") == "M"
                and e.get("name") == "process_name"
                and e["args"].get("name", "").startswith("/device:GPU:")}
    return [e for e in ev if e.get("ph") == "X" and e.get("pid") in dev_pids
            and e.get("args", {}).get("hlo_module") == module]


def hlo_op_names(hlo_text: str) -> dict:
    """HLO instruction name -> ``op_name`` metadata (named-scope path)."""
    return dict(HLO_LINE_RE.findall(hlo_text))


def event_op_name(e: dict, op_names: dict) -> str:
    """The named-scope path of the instruction a device event ran."""
    inst = e.get("args", {}).get("hlo_op", "")
    if inst not in op_names:
        # a kernel replayed from a command buffer: its own name is the
        # instruction's, with the last '.' written as '_'
        inst = re.sub(r"_(\d+)$", r".\1", e.get("name", ""))
    return op_names.get(inst, "")


def attribute(events, op_names: dict):
    """Sum event durations (us) and counts by phase, by level/bucket or leaf
    group, and by event name for the unattributed rest."""
    by_phase = defaultdict(lambda: [0.0, 0])
    by_level = defaultdict(lambda: [0.0, 0])
    by_op = defaultdict(lambda: [0.0, 0])
    for e in events:
        path = event_op_name(e, op_names)
        dur = e.get("dur", 0.0)
        phase = next((n for n, rx in PHASE_RES if rx.search(path)), "other")
        by_phase[phase][0] += dur
        by_phase[phase][1] += 1
        if phase == "other":
            k = e.get("name", "?")
            by_op[k][0] += dur
            by_op[k][1] += 1
        m = LEVEL_RE.search(path) or LEAF_RE.search(path)
        if m:
            key = "/".join(g for g in m.groups() if g)
            by_level[key][0] += dur
            by_level[key][1] += 1
    return by_phase, by_level, by_op


def idle_share(events) -> float:
    """1 - (union of event intervals) / (first start .. last end)."""
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    return 1.0 - busy / window if window > 0 else 0.0


def collect_trace(trace_dir: str):
    """Device events of the newest ``*.trace.json.gz`` under ``trace_dir``."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**/*.trace.json.gz"),
                             recursive=True))
    with gzip.open(paths[-1]) as fh:
        return device_events(json.load(fh))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    show_levels = "--levels" in sys.argv
    order = int(args[0]) if len(args) > 0 else 4
    batch = int(args[1]) if len(args) > 1 else 2048
    iters = int(args[2]) if len(args) > 2 else 20

    import jax

    from feynmandiagram.utils.device import (enable_compile_cache,
                                             require_gpu_or_exit)

    require_gpu_or_exit("profile_pass")
    enable_compile_cache()

    mc_chunk, compiled = build_mc_chunk(order, batch, iters)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    step = mc_chunk.lower(key).compile()
    op_names = hlo_op_names(step.as_text())
    jax.block_until_ready(step(key))
    print(f"# compile+warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    t0 = time.perf_counter()
    jax.block_until_ready(step(jax.random.PRNGKey(1)))
    wall = time.perf_counter() - t0

    trace_dir = tempfile.mkdtemp(prefix="fd_prof_")
    print(f"# trace {trace_dir}", file=sys.stderr)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(step(jax.random.PRNGKey(2)))

    events = collect_trace(trace_dir)
    if not events:
        raise SystemExit(f"no GPU events of {MODULE} in the trace under "
                         f"{trace_dir}")
    by_phase, by_level, by_op = attribute(events, op_names)
    total_us = sum(v[0] for v in by_phase.values())
    print(f"# order={order} batch={batch} iters={iters} "
          f"slots={compiled.lowered.num_slots} edges={compiled.lowered.num_edges} "
          f"levels={len(compiled.lowered.levels)}")
    print(f"# wall(untraced) {wall*1e3:.2f} ms; device busy total "
          f"{total_us/1e3:.2f} ms; per pass {total_us/iters:.0f} us "
          f"({batch*iters/wall:.0f} samples/s untraced); "
          f"{len(events)/iters:.1f} device events per pass; "
          f"device idle share of the traced window {idle_share(events):.3f}")
    print(f"{'phase':<8} {'us/pass':>9} {'%':>6} {'ops/pass':>9}")
    for name in PHASES:
        if name not in by_phase:
            continue
        dur, cnt = by_phase[name]
        print(f"{name:<8} {dur/iters:>9.1f} {100*dur/total_us:>5.1f}% "
              f"{cnt/iters:>9.1f}")
    if show_levels:
        print("\n# per level/bucket (us/pass):")
        for k in sorted(by_level):
            dur, cnt = by_level[k]
            print(f"{k:<24} {dur/iters:>9.1f} {cnt/iters:>7.1f}")
    print("\n# top unattributed ops (us/pass):")
    for k, (dur, cnt) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"{k:<32} {dur/iters:>9.1f} {cnt/iters:>7.1f}")


if __name__ == "__main__":
    main()
