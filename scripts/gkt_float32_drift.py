#!/usr/bin/env python3
"""How far the JAX package's own float32 FedGKT rounds drift from its
float64 ones, at tests/test_torch_split.py's configuration.

    JAX_PLATFORMS=cpu python3 scripts/gkt_float32_drift.py

Runs the JAX FedGKTSim (edge GKTClientResNet(num_blocks=1, width=8),
server GKTServerResNet(blocks_per_stage=(1, 1, 1), widths=(4, 8, 8)), 3
clients of 40, 30 and 26 random 16x16x3 images, batch 8, SGD lr 0.05
with momentum 0.5) for two rounds from one start, once in float32 and
once under ``jax.enable_x64`` in float64, and prints one JSON line a
round: the largest difference over the server's variables and over the
edge stack. CPU only; the port is not involved. It is why the parity
test holds FedGKT in float64 on both sides.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import fedml_tpu.config as jc  # noqa: E402
from fedml_tpu.algorithms import split as JS  # noqa: E402
from fedml_tpu.data import federated as jfd  # noqa: E402
from fedml_tpu.models import gkt as JG  # noqa: E402
from tests.test_torch_split import f64, host, image_data, tiny_cfg  # noqa


def sim():
    return JS.FedGKTSim(
        JG.GKTClientResNet(num_classes=10, num_blocks=1, width=8),
        JG.GKTServerResNet(num_classes=10, blocks_per_stage=(1, 1, 1),
                           widths=(4, 8, 8)),
        image_data(jfd), tiny_cfg(jc))


def max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def main() -> int:
    s32 = sim()
    start = host(s32.init())
    state, rounds32 = jax.tree.map(jnp.asarray, start), []
    for _ in range(2):
        state, _ = s32.run_round(state)
        rounds32.append(host(state))
    s64 = sim()
    with jax.enable_x64(True):
        state = f64(start)
        for r in range(2):
            state, _ = s64.run_round(state)
            got = host(state)
            print(json.dumps({
                "round": r + 1, "device": "cpu",
                "server_max_abs_f32_vs_f64": max_diff(
                    rounds32[r].server_vars, got.server_vars),
                "edge_max_abs_f32_vs_f64": max_diff(
                    rounds32[r].client_stack, got.client_stack)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
