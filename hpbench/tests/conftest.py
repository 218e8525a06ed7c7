"""Helpers of the benchmark's CPU tests: the configurations at a small
size (every ratio of the t128 preset at ``size``^3)."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small(cfg: dict, size: int) -> dict:
    c = copy.deepcopy(cfg)
    m = c["model"]
    m.update(bin_len=0.01 * (512 // size), time_size=size,
             image_size=[size, size], grid_dim=size,
             heatmap_size=[size // 2] * 3)
    return c


@pytest.fixture
def config():
    def load(name: str, size: int = 16) -> dict:
        path = ROOT / "hpbench" / "configs" / f"{name}.json"
        return small(json.loads(path.read_text()), size)
    return load
