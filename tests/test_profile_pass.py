"""The GPU trace reduction of benchmarks/profile_pass.py, on a small trace in
the layout a GPU trace has: a ``/device:GPU:0`` process whose stream events
name their HLO instruction (``hlo_op``), or, for kernels replayed from a
CUDA graph, carry ``hlo_op == "command_buffer"`` and the instruction's name
with its last '.' written as '_'."""
import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))

import profile_pass  # noqa: E402


def _gpu_trace(events):
    meta = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 7,
         "args": {"name": "/host:CPU"}},
    ]
    return {"traceEvents": meta + events}


def _ev(ts, dur, name, hlo_op, pid=1, module=profile_pass.MODULE):
    return {"ph": "X", "pid": pid, "tid": 13, "ts": ts, "dur": dur,
            "name": name, "args": {"hlo_module": module, "hlo_op": hlo_op,
                                   "tf_op": "XlaModule:"}}


HLO = """
  %wrapped_gather.13 = f32[96,2048]{1,0} fusion(%p), kind=kLoop, calls=%c, metadata={op_name="jit(mc_chunk)/while/body/closed_call/jit(fn)/gL03/fb4x2/gather" source_file="x.py" source_line=1}
  %loop_reduce_fusion.2 = f32[96,2048]{1,0} fusion(%q), kind=kInput, metadata={op_name="jit(mc_chunk)/while/body/closed_call/jit(fn)/leafG0/exp"}
  ROOT %rng.1 = u32[2]{0} fusion(%k), kind=kLoop, metadata={op_name="jit(mc_chunk)/while/body/prng/threefry2x32"}
"""


def test_reduction_attributes_gpu_events():
    names = profile_pass.hlo_op_names(HLO)
    assert names["wrapped_gather.13"].endswith("/gL03/fb4x2/gather")
    trace = _gpu_trace([
        _ev(0.0, 2.0, "wrapped_gather_13", "command_buffer"),
        _ev(3.0, 4.0, "loop_reduce_fusion_2", "loop_reduce_fusion.2"),
        _ev(8.0, 1.0, "rng_1", "rng.1"),
        _ev(9.0, 1.0, "MemcpyD2D", "copy.108"),
        _ev(0.0, 50.0, "other_module", "copy.1", module="jit_other"),
        _ev(0.0, 50.0, "host", "copy.1", pid=7),
    ])
    events = profile_pass.device_events(trace)
    assert len(events) == 4
    by_phase, by_level, by_op = profile_pass.attribute(events, names)
    assert by_phase["graph"] == [2.0, 1]
    assert by_phase["leaf"] == [4.0, 1]
    assert by_phase["prng"] == [1.0, 1]
    assert by_phase["other"] == [1.0, 1]
    assert by_level["gL03/fb4x2"] == [2.0, 1]
    assert by_level["leafG0"] == [4.0, 1]
    assert set(by_op) == {"MemcpyD2D"}
    # busy 0-2, 3-7, 8-10 of the window 0-10
    assert profile_pass.idle_share(events) == pytest.approx(0.2)


def test_hlo_op_names_of_a_compiled_mc_loop():
    """The compiled MC loop's HLO text carries the named scopes the
    reduction reads."""
    from feynmandiagram.backends.compile import compile_evaluator
    from feynmandiagram.computational_graph import optimize_inplace
    from feynmandiagram.frontends import ChargeCharge, Instant, NoHartree
    from feynmandiagram.frontends.parquet import (DiagPara, Interaction,
                                                  Ver4Diag, vertex4)

    para = DiagPara(type=Ver4Diag, innerLoopNum=1, hasTau=True,
                    filter=(NoHartree,),
                    interaction=(Interaction(ChargeCharge, Instant),))
    roots = [row["diagram"] for row in vertex4(para)]
    optimize_inplace(roots, level=1)
    compiled = compile_evaluator(roots, max_loop_num=para.totalLoopNum,
                                 beta=0.5, kF=1.919, lam=1.0,
                                 dtype=jnp.float32)
    chunk = profile_pass.make_mc_chunk(
        compiled.fn, n_loop=para.totalLoopNum, num_tau=para.totalTauNum,
        batch=128, n_roots=len(compiled.lowered.root_slots),
        dtype=jnp.float32, iters=2)
    text = chunk.lower(jax.random.PRNGKey(0)).compile().as_text()
    paths = set(profile_pass.hlo_op_names(text).values())
    for scope in ("/prng/", "/loops/", "/gL00/", "/accum/"):
        assert any(scope in p for p in paths), scope
