"""Nothing the benchmark runs loads JAX, the JAX package or the repo-root
scripts that belong to it, and nothing under ``benchmark/`` reads them."""

import os
import re
import subprocess
import sys

from harness import common

TINY = os.path.dirname(os.path.abspath(__file__))


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "sparsebev_tpu_torch_fake", sys)
    assert "sparsebev_tpu_torch_fake" not in common.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "sparsebev_tpu.models", sys)
    assert "sparsebev_tpu.models" in common.forbidden_loaded()


def test_a_cell_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); import tiny; "
            "tiny.run_tiny('vov99.stream', seconds=0.2); "
            "from harness import common; "
            "print('FOUND', common.forbidden_loaded())" % TINY)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FOUND []" in out.stdout


def test_no_benchmark_file_reads_the_jax_side():
    pat = re.compile(r"\b(import\s+(jax|flax|sparsebev_tpu|bench|chip_smoke|"
                     r"tools)\b|from\s+(jax|flax|sparsebev_tpu|bench|"
                     r"chip_smoke|tools)[\s.]|bench\.py|chip_smoke\.py|"
                     r"BENCH_r)")
    for dirpath, _, files in os.walk(common.BENCH_DIR):
        for fn in files:
            if fn.endswith(".py") and fn != os.path.basename(__file__):
                with open(os.path.join(dirpath, fn)) as f:
                    text = f.read()
                assert not pat.search(text), os.path.join(dirpath, fn)
