"""The port runs where there is no JAX: importing ``hiddenpose_tpu_torch``
and every module of its inference path and train step, in a fresh interpreter, leaves
``jax``, ``flax`` and the JAX package ``hiddenpose_tpu`` out of
``sys.modules``; and ``chip_smoke.py`` refuses to run (non-zero exit, no
result line) on a host without a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "hiddenpose_tpu_torch",
    "hiddenpose_tpu_torch.config",
    "hiddenpose_tpu_torch.data.synthetic",
    "hiddenpose_tpu_torch.ops.psf",
    "hiddenpose_tpu_torch.ops.lct",
    "hiddenpose_tpu_torch.ops.normalize",
    "hiddenpose_tpu_torch.ops.softargmax",
    "hiddenpose_tpu_torch.ops.kernels",
    "hiddenpose_tpu_torch.ops.kernels.pool2p",
    "hiddenpose_tpu_torch.losses",
    "hiddenpose_tpu_torch.models.blocks",
    "hiddenpose_tpu_torch.models.unet3d",
    "hiddenpose_tpu_torch.models.posenet3d",
    "hiddenpose_tpu_torch.models.nlospose",
    "hiddenpose_tpu_torch.train.optim",
    "hiddenpose_tpu_torch.train.state",
    "hiddenpose_tpu_torch.train.step",
    "hiddenpose_tpu_torch.serve",
    "hiddenpose_tpu_torch.utils.jax_bridge",
    "hiddenpose_tpu_torch.utils.peaked",
]


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
        "             ('jax', 'jaxlib', 'flax', 'hiddenpose_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"jax modules loaded: {out.stdout}"


@pytest.mark.parametrize("where", ["hiddenpose_tpu_torch", "chip_smoke.py",
                                   "scripts/torch_stage_profile.py"])
def test_no_import_statement_names_jax(where):
    """Also the imports inside functions, which a module import does not
    run: none names jax, flax or the JAX package."""
    path = ROOT / where
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                           "hiddenpose_tpu")]
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
