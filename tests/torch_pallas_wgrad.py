"""The JAX package's Pallas wgrad (``conv3_planes_wgrad`` in interpret mode)
of a set of cases, in a process of its own, for
``tests/test_torch_train_kernels_wgrad.py``.

    python tests/torch_pallas_wgrad.py IN.npz OUT.npz

``IN`` holds ``x<i>`` and ``dz<i>`` for each case ``i`` and ``pad_modes``;
``OUT`` gets ``dk<i>_<pad_mode>`` and ``db<i>_<pad_mode>``.  Imports JAX
and the JAX package, not torch; runs on the CPU.
"""

from __future__ import annotations

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from hiddenpose_tpu.ops.pallas.conv3p import conv3_planes_wgrad  # noqa: E402


def main(src: str, dst: str) -> None:
    cases = np.load(src)
    out = {}
    i = 0
    while f"x{i}" in cases.files:
        x, dz = jnp.asarray(cases[f"x{i}"]), jnp.asarray(cases[f"dz{i}"])
        for pad_mode in cases["pad_modes"]:
            dk, db = conv3_planes_wgrad(x, dz, pad_mode=str(pad_mode),
                                        interpret=True)
            out[f"dk{i}_{pad_mode}"] = np.asarray(dk)
            out[f"db{i}_{pad_mode}"] = np.asarray(db)
        i += 1
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
