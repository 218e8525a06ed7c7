"""The spread of the bf16 NlosPose forward's end-to-end differences over
weight seeds and batches, on one GPU.

    python3 scripts/torch_bf16_spread.py [--seeds 1 2 3]

Run from the root of a checkout on a host with an NVIDIA GPU.  For each
seed of ``chip_smoke.py``'s peaked t128 weights, ``chip_smoke.bf16_e2e``
on the first ``chip_smoke.BF16_E2E_CAPTURES`` of its captures in batches
of 2: the bf16 forward with its kernels against its plain versions, and
both against a float32 model on the same weights and bf16-valued
captures (heatmap RMS and largest differences, joint distances), with the
float32 heatmaps rounded once to bf16 beside them.  ``chip_smoke.py``
phase 9's ``BF16_*`` limits are set from these readings: it prints one
line a batch, one a seed, and the largest reading of each metric over
all batches, and writes them to ``chiprun_out/torch_bf16_spread.json``.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the smoke run's weights, captures, checks)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = ap.parse_args()
    # deterministic cuBLAS needs its workspace fixed before the first call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = chip_smoke.smi_line()
    cfg, caps = chip_smoke.t128_captures(chip_smoke.BF16_E2E_CAPTURES)
    runs = {}
    for seed in args.seeds:
        r = chip_smoke.bf16_e2e(dev, cfg, chip_smoke.t128_weights(cfg, seed),
                                caps)
        for i, row in enumerate(r["batches"]):
            print(f"[seed {seed} batch {i}] "
                  + json.dumps({k: float(f"{v:.4e}") for k, v in row.items()}),
                  flush=True)
        print(f"[seed {seed} all] "
              + json.dumps({k: float(f"{v:.4e}") for k, v in r["all"].items()})
              + f"; heatmaps bf16 and finite: {r['heatmaps_bf16_finite']}",
              flush=True)
        runs[seed] = r
    rows = [row for r in runs.values() for row in r["batches"]]
    largest = {k: max(row[k] for row in rows) for k in rows[0]}
    least = {k: min(row[k] for row in rows) for k in rows[0]}
    print("[largest of one batch] " + json.dumps(
        {k: float(f"{v:.4e}") for k, v in largest.items()}), flush=True)
    print("[least of one batch] " + json.dumps(
        {k: float(f"{v:.4e}") for k, v in least.items()}), flush=True)
    print(smi, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "torch_bf16_spread.json").write_text(json.dumps(dict(
        device=smi, seeds=args.seeds, runs=runs, largest=largest,
        least=least), indent=1))
    return 0 if all(r["heatmaps_bf16_finite"] for r in runs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
