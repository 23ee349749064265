#!/usr/bin/env python3
"""The band between the port's bulk round and the stacked rounds on
ResNet-8's batch statistics, on the CPU.

    python3 scripts/bulk_bn_band.py

One round of all 4 clients of ResNet-8 (width 4, 16x16x3, SGD with
momentum), the JAX package's cohort and batch orders replayed, as in
tests/test_torch_bulk.py::test_resnet8_batch_stats_bulk_against_stacked:
prints, for the port's bulk round in blocks of 2 against the port's
stacked round, against the JAX package's stacked round, and the port's
stacked against the JAX package's, the largest absolute and relative
difference over every parameter and statistic, with the leaf that has
it. It imports the JAX package and the tests' helpers: a parity tool for
the CPU, not a part of the port.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)

    import fedml_tpu.config as jc
    import fedml_tpu_torch.config as tc
    from fedml_tpu.algorithms import fedavg as jfed
    from fedml_tpu.core import compress as JC
    from fedml_tpu.models.base import FedModel as JaxFedModel
    from fedml_tpu_torch.algorithms import fedavg as tfed
    from fedml_tpu_torch.convert import vision_state_dict
    from tests.test_torch_byzantine import _replay
    from tests.test_torch_resnet_fedavg import B, COUNTS, _data
    from tests.test_torch_vision import RES_SHAPE, flax_resnet8

    flax_net, variables, model, params = flax_resnet8(seed=2)
    jdata, tdata = _data()

    def cfg(m, **fed):
        return m.ExperimentConfig(
            data=m.DataConfig(num_clients=len(COUNTS), batch_size=B),
            model=m.ModelConfig(name="resnet8", input_shape=RES_SHAPE),
            train=m.TrainConfig(lr=0.1, momentum=0.5, epochs=1),
            fed=m.FedConfig(num_rounds=1, clients_per_round=len(COUNTS),
                            **fed), seed=3)

    jsim = jfed.FedAvgSim(JaxFedModel(flax_net, RES_SHAPE,
                                      has_batch_stats=True), jdata, cfg(jc))
    sampler, batch_orders, _ = _replay(jsim, JC.CompressionSpec())
    jstate = jsim.init()._replace(variables=jax.tree.map(jnp.asarray,
                                                         variables))
    jnew, _ = jsim.run_round(jstate)
    want = vision_state_dict(jax.device_get(jnew.variables), "ResNetCIFAR")
    got = {}
    for block in (0, 2):
        tsim = tfed.FedAvgSim(model, tdata, cfg(tc, client_block_size=block),
                              device="cpu", sampler=sampler,
                              batch_orders=batch_orders)
        state = tsim.init()._replace(variables=params)
        got[block] = tsim.run_round(state)[0].variables

    def band(a, b):
        abs_err = {k: float(np.max(np.abs(a[k].numpy() - b[k].numpy())))
                   for k in b}
        rel_err = {k: float(np.max(np.abs(a[k].numpy() - b[k].numpy())
                                   / (np.abs(b[k].numpy()) + 1e-30)))
                   for k in b}
        ka, kr = max(abs_err, key=abs_err.get), max(rel_err, key=rel_err.get)
        return {"max_abs": abs_err[ka], "at": ka, "max_rel": rel_err[kr],
                "rel_at": kr}

    print(json.dumps({"bulk_vs_stacked": band(got[2], got[0]),
                      "bulk_vs_jax_stacked": band(got[2], want),
                      "stacked_vs_jax_stacked": band(got[0], want)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
