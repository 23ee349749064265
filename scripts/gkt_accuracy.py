#!/usr/bin/env python3
"""FedGKT's composed test accuracy in the JAX package and in the port, in
float32 on the CPU, from one start with the same draws.

    JAX_PLATFORMS=cpu python3 scripts/gkt_accuracy.py [--rounds 3]
        [--dataset_r 0.25] [--blocks 2]

The configuration is phase 19 (a)'s of chip_smoke.py cut in scale: the
``resnet8_56`` edge at its width, fake_cifar10 (hetero 0.5, 10 clients,
batch 32, lr 0.03), with ``dataset_r`` of the set and a server of
``blocks`` Bottlenecks a stage (phase 19 runs 6) at widths 16/32/64. The
port starts from the JAX package's initial weights (convert.py) and
replays its edge and server batch orders. Prints one JSON line a round:
each side's composed test accuracy (client 0's edge, then the server),
the accuracy of client 0's own edge classifier, which tells a server that
has not learned from an edge that has not, and the port's composed
accuracy with BatchNorm on each test batch's own statistics in place of
the running ones (which move at flax's momentum 0.99).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import fedml_tpu.config as jc  # noqa: E402
import fedml_tpu_torch.config as tc  # noqa: E402
from fedml_tpu.algorithms import split as JS  # noqa: E402
from fedml_tpu.core import random as JR  # noqa: E402
from fedml_tpu.data import load_dataset as j_load  # noqa: E402
from fedml_tpu.models import gkt as JG  # noqa: E402
from fedml_tpu_torch.algorithms import split as TS  # noqa: E402
from fedml_tpu_torch.convert import gkt_state_dict  # noqa: E402
from fedml_tpu_torch.data import load_dataset as t_load  # noqa: E402
from fedml_tpu_torch.models import gkt as TG  # noqa: E402
from tests.test_torch_split import fed_model, host, ordered  # noqa: E402

K, SHAPE = 10, (32, 32, 3)


def config(m, dataset_r: float):
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_cifar10", num_clients=10,
                          partition_method="hetero", partition_alpha=0.5,
                          batch_size=32, dataset_r=dataset_r, seed=0),
        model=m.ModelConfig(name="resnet56", num_classes=K,
                            input_shape=SHAPE),
        train=m.TrainConfig(lr=0.03, epochs=1),
        fed=m.FedConfig(algorithm="fedgkt", clients_per_round=10),
        seed=0)


def edge_accuracy(predict, x, y) -> float:
    correct = 0
    for s in range(0, len(y), 256):
        correct += int((np.asarray(predict(x[s:s + 256])).argmax(-1)
                        == np.asarray(y[s:s + 256])).sum())
    return correct / max(len(y), 1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dataset_r", type=float, default=0.25)
    ap.add_argument("--blocks", type=int, default=2)
    args = ap.parse_args()
    blocks = (args.blocks,) * 3
    torch.set_num_threads(4)
    jcfg = config(jc, args.dataset_r)
    jsim = JS.FedGKTSim(JG.GKTClientResNet(num_classes=K),
                        JG.GKTServerResNet(num_classes=K,
                                           blocks_per_stage=blocks),
                        j_load(jcfg.data), jcfg)
    mask = np.asarray(jsim.arrays.mask)
    max_n, root = jsim.max_n, jsim.root_key

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(root, r), c)
        return [torch.from_numpy(ordered(jax.random.fold_in(ckey, e),
                                         mask[c], max_n))
                for e in range(jcfg.train.epochs)]

    def server_orders(r, e, c):
        skey = jax.random.fold_in(JR.round_key(root, r), 0x5EAF)
        key = jax.random.fold_in(jax.random.fold_in(skey, e), c)
        return torch.from_numpy(ordered(key, mask[c], max_n))

    tcfg = config(tc, args.dataset_r)
    tsim = TS.FedGKTSim(
        fed_model(lambda: TG.GKTClientResNet(K), SHAPE),
        fed_model(lambda: TG.GKTServerResNet(K, blocks),
                  SHAPE[:2] + (TG.EDGE_WIDTH,)),
        t_load(tcfg.data), tcfg, "cpu", batch_orders=batch_orders,
        server_orders=server_orders)
    start = host(jsim.init())
    server = gkt_state_dict(start.server_vars)
    tstate = tsim.init()._replace(
        client_stack=gkt_state_dict(start.client_stack, lead=1),
        server_vars=server,
        server_opt_state=tsim.server_update.opt.init(
            {k: v for k, v in server.items()
             if k not in tsim.server_model.stat_names}))
    jstate = jax.tree.map(jnp.asarray, start)
    xt, yt = np.array(jsim.arrays.test_x), np.array(jsim.arrays.test_y)
    for r in range(args.rounds):
        jstate, _ = jsim.run_round(jstate)
        tstate, _ = tsim.run_round(tstate)
        j_edge = jax.tree.map(lambda s: s[0], jstate.client_stack)
        t_edge = {k: v[0] for k, v in tstate.client_stack.items()}
        with torch.no_grad():
            t_edge_acc = edge_accuracy(
                lambda x: tsim.client_model.apply_eval(
                    t_edge, torch.from_numpy(x))[1].numpy(), xt, yt)
            t_batch_acc = edge_accuracy(
                lambda x: tsim.server_model.apply_train(
                    tstate.server_vars, tsim.client_model.apply_train(
                        t_edge, torch.from_numpy(x))[0][0])[0].numpy(),
                xt, yt)
        print(json.dumps({
            "round": r + 1, "device": "cpu", "dtype": "float32",
            "dataset_r": args.dataset_r, "server_blocks": list(blocks),
            "jax_test_acc": jsim.evaluate(jstate)["test_acc"],
            "port_test_acc": tsim.evaluate(tstate)["test_acc"],
            "jax_edge0_acc": edge_accuracy(
                lambda x: jsim._client_apply_eval(j_edge, x)[1], xt, yt),
            "port_edge0_acc": t_edge_acc,
            "port_test_acc_batch_stats": t_batch_acc}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
