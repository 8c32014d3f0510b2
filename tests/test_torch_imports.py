"""The port stands alone: no module of ``sparsebev_tpu_torch`` and nothing
``chip_smoke.py`` loads imports ``jax`` or the JAX package (nor, outside
the viz tools' ``main``, matplotlib), no module calls
a library attention in place of its own kernel, and the smoke script refuses
to run (printing no result) without a card or without the package beside
it."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sparsebev_tpu_torch")
# matches jax/flax and the JAX package, never the bare prefix of the port
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|flax|sparsebev_tpu)(\.|\s|$)")


def _port_modules():
    names = ["sparsebev_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="sparsebev_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "PYTHONSTARTUP")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_modules_import_without_jax():
    mods = _port_modules()
    assert "sparsebev_tpu_torch.ops.msmv_sampling" in mods
    assert "sparsebev_tpu_torch.inference" in mods
    for op in ("msmv_onehot", "mixing", "msmv_epilogue", "autograd_guard"):
        assert f"sparsebev_tpu_torch.ops.{op}" in mods
    # the training slice
    for mod in ("models.augment", "bbox.match_costs", "losses.focal",
                "losses.l1", "losses.matching", "losses.target",
                "losses.denoising", "train.optim", "train.step"):
        assert f"sparsebev_tpu_torch.{mod}" in mods
    # the training loop: its own copies of the JAX package's pure-Python
    # helpers (registry, logging), checkpoints, hooks and the runner
    for mod in ("registry", "utils.logging", "utils.checkpoint_io",
                "train.hooks", "train.runner"):
        assert f"sparsebev_tpu_torch.{mod}" in mods
    # the host data path, the evaluator and the two CLIs
    for mod in ("data", "data.box3d", "data.synthetic", "data.fastloader",
                "data.pipelines", "data.dataset", "data.loader", "builder",
                "evaluation", "evaluation.results", "evaluation.metrics",
                "evaluation.loop", "tools", "tools.train", "tools.val",
                "tools.fp8_drift"):
        assert f"sparsebev_tpu_torch.{mod}" in mods
    # the EVA02 backbone, its attention op and its product op
    for mod in ("models.eva02", "ops.eva_attention", "ops.eva_linear"):
        assert f"sparsebev_tpu_torch.{mod}" in mods
    # data and query parallelism
    for mod in ("parallel", "parallel.mesh", "parallel.query_parallel"):
        assert f"sparsebev_tpu_torch.{mod}" in mods
    # the side tools: the FPS CLI, the decoder dumps and the viz tools, the
    # parity dry run and the loader bench
    for mod in ("tools.timing", "utils.dump", "tools.viz_sample_points",
                "tools.viz_bbox_predictions", "tools.parity",
                "tools.loader_bench"):
        assert f"sparsebev_tpu_torch.{mod}" in mods
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'flax', 'jaxlib'))\n"
        "             or m == 'sparsebev_tpu'\n"
        "             or m.startswith('sparsebev_tpu.'))\n"
        "print('BAD', bad)\n"
        # the viz tools import matplotlib in their main only
        "print('MPL', 'matplotlib' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=_clean_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
    assert "MPL False" in out.stdout, out.stdout


def test_port_sources_name_no_jax_import():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    bad = []
    for path in files:
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                if _FORBIDDEN.match(line):
                    bad.append(f"{os.path.relpath(path, REPO)}:{i}: {line}")
    assert not bad, "".join(bad)


def test_port_never_names_a_library_attention():
    """The EVA02 attention is the port's own kernel
    (``csrc/eva_attention.cu``): no source of the package names
    ``scaled_dot_product_attention`` (``chip_smoke.py`` times it only as a
    yardstick)."""
    bad = []
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if f.endswith((".py", ".cu")):
                with open(os.path.join(d, f)) as fh:
                    if "scaled_dot_product_attention" in fh.read():
                        bad.append(os.path.relpath(os.path.join(d, f), REPO))
    assert not bad, bad


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=REPO,
                         env=_clean_env(), timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "FAIL" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=_clean_env(), timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "sparsebev_tpu_torch" in out.stderr


@pytest.mark.parametrize("src", ["msmv_pack", "msmv_pack_pair",
                                 "msmv_sample", "msmv_sample_bwd",
                                 "msmv_onehot", "mixing", "tap_fold",
                                 "eva_attention", "eva_linear"])
def test_cuda_sources_declare_their_tpu_kernel_and_bound(src):
    """Each kernel source notes the TPU function it replaces, its bound and
    its design, and exports the C entry its wrapper binds."""
    with open(os.path.join(PKG, "csrc", f"{src}.cu")) as fh:
        text = fh.read()
    if src == "eva_attention":
        # an XLA op of the JAX model (jax.nn.dot_product_attention), not a
        # Pallas kernel
        assert "Replaces: sparsebev_tpu/models/eva02.py" in text
        assert "int eva_attention_forward(" in text
        # the forward, and the backward's D, dK / dV and dQ kernels
        assert "int eva_attention_backward(" in text
        assert text.count("__global__") == 4
        # both products on the tensor cores in TF32, K / V by cp.async
        assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in text
        assert "cp.async.cg.shared.global" in text
    elif src == "eva_linear":
        # the XLA dots of the JAX trunk's Linear layers, not a Pallas kernel
        assert "Replaces: no Pallas kernel" in text
        assert "sparsebev_tpu/models/eva02.py:144-148" in text
        assert "int eva_linear_forward(" in text
        assert text.count("__global__") == 1
        # TF32 wgmma fed by TMA, or by cp.async pieces where TMA cannot go
        assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in text
        assert "cp.async.bulk.tensor" in text and "cp.async.ca" in text
    else:
        assert "Replaces: sparsebev_tpu/ops/" in text
    assert "Bound:" in text and "Design:" in text
    assert f"{src}_error_string" in text
    assert "return cudaGetLastError()" in text.replace("(int)", "")
    if src == "msmv_onehot":
        # both entries: every level in one launch, and one level
        for entry in ("msmv_onehot_sample_levels(",
                      "msmv_onehot_sample_level("):
            assert f"int {entry}" in text
        assert text.count("__global__") == 2
    if src == "msmv_sample_bwd":
        assert "int msmv_sample_backward(" in text
        assert "_msmv_yfold_bwd" in text and "atomicAdd" in text
    if src in ("msmv_pack", "msmv_pack_pair"):
        # forward and adjoint entries, one kernel each
        assert f"int {src}_level(" in text
        assert f"int {src}_level_bwd(" in text
        assert text.count("__global__") == 2
        assert "_bwd (:" in text            # the JAX adjoint it replaces
    if src in ("msmv_sample", "msmv_sample_bwd", "msmv_onehot", "mixing",
               "eva_attention", "eva_linear"):
        # the kernels redesigned for the H100 stay hand-written: no library
        # GEMM takes their place
        assert "cublas" not in text.lower()
        assert not re.search(r"#include\s*[<\"]cutlass/gemm/device/", text)


def test_every_cuda_source_is_covered_and_built_by_the_smoke_run():
    """The sources under ``csrc/`` are exactly those this file checks and
    ``chip_smoke.py`` builds."""
    sources = sorted(f[:-3] for f in os.listdir(os.path.join(PKG, "csrc"))
                     if f.endswith(".cu"))
    assert sources == sorted(["msmv_pack", "msmv_pack_pair", "msmv_sample",
                              "msmv_sample_bwd", "msmv_onehot", "mixing",
                              "tap_fold", "eva_attention", "eva_linear"])
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = fh.read()
    for src in sources:
        assert f'"{src}"' in smoke, src
