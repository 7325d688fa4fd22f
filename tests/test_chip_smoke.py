"""chip_smoke.py's phases at small orders on the CPU, and its GPU guard.

The full-size run is ``python chip_smoke.py`` (one card) and
``python chip_smoke.py --four`` (four cards) on a GPU machine; the test
marked ``chip`` runs the one-card script there, in a child process, since
the test process itself keeps JAX on the CPU.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from feynmandiagram.utils.device import REPO_ROOT, gpu_name_and_power_limit


@pytest.fixture(scope="module")
def roots_o2():
    return chip_smoke.build_roots(2)[:2]


@pytest.fixture
def gpu_host():
    """Skip unless nvidia-smi finds a GPU on this host."""
    try:
        return gpu_name_and_power_limit()
    except (OSError, subprocess.SubprocessError):
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


@pytest.mark.parametrize("order", [2, 3])
def test_correctness_phases_match_host(order):
    """Phases (a)-(c): leaf f32 vs numpy f64, roots f32/f64 vs eval_graph."""
    roots, para, _ = chip_smoke.build_roots(order)
    errs = chip_smoke.check_correctness(roots, para, batch=256, n_host=4)
    assert errs["leaf_f32_rel_per_log"] <= chip_smoke.LEAF_RTOL
    assert errs["root_f32_vs_host"] <= chip_smoke.ROOT_F32_TOL
    assert errs["root_f64_vs_host_violation"] <= 1.0
    assert errs["root_f32_vs_f64"] <= chip_smoke.ROOT_F32_TOL


def test_four_device_paths_match_single_device(roots_o2):
    """--four's phase on 4 of the 8 virtual CPU devices: both multi-device
    MC steps agree with the single-device estimator and sit on 4 devices."""
    roots, para = roots_o2
    out = chip_smoke.check_four(roots, para, jax.devices()[4:8], bpd=16,
                                iters=2)
    assert set(out) == {"sample_axis", "graph_sharded"}
    assert max(out.values()) <= chip_smoke.MESH_TOL


def test_correctness_phase_rejects_wrong_leaves(roots_o2, monkeypatch):
    """A leaf phase off by a TF32-sized error fails phase (a)."""
    roots, para = roots_o2
    compiled32 = chip_smoke.compile_f(roots, para, np.float32)
    good = compiled32.leaf_fn
    compiled32.leaf_fn = lambda vk, vt: good(vk, vt) * (1 + 1e-3)
    with pytest.raises(AssertionError):
        chip_smoke.check_correctness(roots, para, batch=128, n_host=2,
                                     compiled32=compiled32)


def test_refuses_cpu(capsys):
    """On a CPU the script exits non-zero, names the missing GPU and prints
    no ok line."""
    with pytest.raises(SystemExit) as exit_info:
        chip_smoke.main([])
    out, err = capsys.readouterr()
    assert exit_info.value.code == 2
    assert "no GPU" in err
    assert '"ok"' not in out


@pytest.mark.chip
def test_one_card_smoke_on_gpu(gpu_host):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_ENABLE_X64", "XLA_FLAGS")}
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO_ROOT,
                         env=env, capture_output=True, text=True, timeout=1500)
    assert run.returncode == 0, run.stderr[-4000:]
    last = json.loads(run.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
