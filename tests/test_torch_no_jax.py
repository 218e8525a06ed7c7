"""The port runs where there is no JAX: importing ``hiddenpose_tpu_torch``
and every module of its ported paths, in a fresh interpreter, leaves
``jax``, ``flax`` and the JAX package ``hiddenpose_tpu`` out of
``sys.modules`` (and cv2, grain, orbax, tensorflow and matplotlib, which
the GPU host lacks); and ``chip_smoke.py`` refuses to run (non-zero exit,
no result line) on a host without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401  (caps this worker's CPU threads)

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "hiddenpose_tpu_torch",
    "hiddenpose_tpu_torch.config",
    "hiddenpose_tpu_torch.data.synthetic",
    "hiddenpose_tpu_torch.data.native_loader",
    "hiddenpose_tpu_torch.data.preprocess",
    "hiddenpose_tpu_torch.data.dataset",
    "hiddenpose_tpu_torch.data.device_prefetch",
    "hiddenpose_tpu_torch.data.targets",
    "hiddenpose_tpu_torch.ops.psf",
    "hiddenpose_tpu_torch.ops.lct",
    "hiddenpose_tpu_torch.ops.normalize",
    "hiddenpose_tpu_torch.ops.softargmax",
    "hiddenpose_tpu_torch.ops.kernels",
    "hiddenpose_tpu_torch.ops.kernels.conv3p",
    "hiddenpose_tpu_torch.ops.kernels.conv3mxu",
    "hiddenpose_tpu_torch.ops.kernels.stem_conv",
    "hiddenpose_tpu_torch.ops.kernels.phase_pool",
    "hiddenpose_tpu_torch.ops.kernels.pool2p",
    "hiddenpose_tpu_torch.ops.kernels.attn",
    "hiddenpose_tpu_torch.ops.kernels.probes",
    "hiddenpose_tpu_torch.losses",
    "hiddenpose_tpu_torch.models.blocks",
    "hiddenpose_tpu_torch.models.unet3d",
    "hiddenpose_tpu_torch.models.posenet3d",
    "hiddenpose_tpu_torch.models.posenet2d",
    "hiddenpose_tpu_torch.models.tokenpose",
    "hiddenpose_tpu_torch.models.nlospose",
    "hiddenpose_tpu_torch.models.rotary",
    "hiddenpose_tpu_torch.models.sformer",
    "hiddenpose_tpu_torch.models.timesformer",
    "hiddenpose_tpu_torch.train.optim",
    "hiddenpose_tpu_torch.train.state",
    "hiddenpose_tpu_torch.train.step",
    "hiddenpose_tpu_torch.train.alt_steps",
    "hiddenpose_tpu_torch.train.checkpoint",
    "hiddenpose_tpu_torch.train.pretrain",
    "hiddenpose_tpu_torch.train.loop",
    "hiddenpose_tpu_torch.eval",
    "hiddenpose_tpu_torch.eval.metrics",
    "hiddenpose_tpu_torch.eval.harness",
    "hiddenpose_tpu_torch.cli",
    "hiddenpose_tpu_torch.cli.train",
    "hiddenpose_tpu_torch.cli.test",
    "hiddenpose_tpu_torch.serve",
    "hiddenpose_tpu_torch.utils.jax_bridge",
    "hiddenpose_tpu_torch.utils.peaked",
    "hiddenpose_tpu_torch.utils.meters",
    "hiddenpose_tpu_torch.utils.logging",
    "hiddenpose_tpu_torch.models.deepvoxels",
    "hiddenpose_tpu_torch.ops.wave",
    "hiddenpose_tpu_torch.ops.resample",
    "hiddenpose_tpu_torch.ops.lct_reference",
    "hiddenpose_tpu_torch.viz",
    "hiddenpose_tpu_torch.viz.visualizer",
    "hiddenpose_tpu_torch.viz.heatmap3d",
    "hiddenpose_tpu_torch.parallel",
    "hiddenpose_tpu_torch.parallel.mesh",
    "hiddenpose_tpu_torch.parallel.distributed",
    "hiddenpose_tpu_torch.parallel.sharding_rules",
    "hiddenpose_tpu_torch.utils.remat",
    "hiddenpose_tpu_torch.graft_entry",
]
# packages the GPU host does not have, which the JAX package's data, log
# and checkpoint modules use: the port names none of them, except that the
# figures (viz/) import matplotlib inside the functions that draw, as the
# JAX package's do, and their callers treat a figure as best-effort
ABSENT_ON_THE_GPU_HOST = ("cv2", "grain", "orbax", "tensorflow",
                          "matplotlib")
LAZY_IN = {"matplotlib": "hiddenpose_tpu_torch/viz/"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'hiddenpose_tpu')\n"
        f"             + {ABSENT_ON_THE_GPU_HOST!r})\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"jax modules loaded: {out.stdout}"


@pytest.mark.parametrize("where", ["hiddenpose_tpu_torch", "chip_smoke.py",
                                   "scripts/torch_stage_profile.py",
                                   "scripts/torch_diag_stem_paired.py",
                                   "scripts/torch_time_attention_spread.py"])
def test_no_import_statement_names_jax(where):
    """Also the imports inside functions, which a module import does not
    run: none names jax, flax or the JAX package (nor a package the GPU
    host lacks, but for ``LAZY_IN``'s inside a function of its files)."""
    path = ROOT / where
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    bad = []
    for f in files:
        rel = str(f.relative_to(ROOT))
        tree = ast.parse(f.read_text(), str(f))
        # an import is lazy only where a function's body holds it: one at
        # module level under ``try:`` or ``if`` runs at import time
        in_function = {id(n) for fn in ast.walk(tree)
                       if isinstance(fn, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                       for n in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            lazy = id(node) in in_function
            bad += [f"{rel}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "hiddenpose_tpu")
                    + ABSENT_ON_THE_GPU_HOST
                    and (not lazy or not rel.startswith(
                        LAZY_IN.get(n.split(".")[0], "\0")))]
    assert len(files) > 0 and not bad, bad


def test_chip_smoke_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the script would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    # no result: neither the kernels' JSON line nor the final ok line
    assert not any(line.lstrip().startswith("{")
                   for line in out.stdout.splitlines()), out.stdout


def test_probe_script_fails_without_gpu():
    """Unlike the TPU script it ports, the probe script exits non-zero when
    it cannot run."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the script would run for real")
    out = subprocess.run(
        [sys.executable, "scripts/torch_diag_stem_paired.py"], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "diag done" not in out.stdout
