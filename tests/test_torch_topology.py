"""The topologies in the port against the JAX package: the topology
managers' mixing matrices and the procedural stream bit for bit, two
hierarchical rounds (2 groups, 2 inner rounds), two decentralized rounds
of DSGD and of push-sum (push-sum on a directed topology, so its push
weights move), and the online sims' losses, regret, parameters and
logged rows (N 8, T 100; DSGD, push-sum, push-sum on the time-varying
topology), each with the JAX sim's batch orders replayed; then the
harness builds every new name on the CPU and the UCI streams raise.
Logistic regression on ``fake_mnist`` (8 clients, hetero 0.5, so the
lanes run in size-sorted groups with gated padding steps), float32 at
rtol 1e-4, atol 1e-5."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import decentralized as JD
from fedml_tpu.algorithms import hierarchical as JH
from fedml_tpu.core import random as JR
from fedml_tpu.core import topology as JT
from fedml_tpu.data import streaming as JS
from fedml_tpu.data.loaders import load_dataset as jax_load_dataset
from fedml_tpu.metrics.sink import MetricsSink as JaxSink
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms import decentralized as TD
from fedml_tpu_torch.algorithms import hierarchical as TH
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.core import topology as TT
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data import streaming as TS
from fedml_tpu_torch.experiments.harness import Experiment, build_sim
from fedml_tpu_torch.metrics import MetricsSink
from fedml_tpu_torch.models import create_model
from tests.test_torch_gan import close, lane_orders
from tests.torch_threads import one_torch_thread  # noqa: F401

BAND = dict(rtol=1e-4, atol=1e-5)
N = 8


def _cfg(m, **fed):
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=N,
                          batch_size=32, partition_method="hetero",
                          partition_alpha=0.5, dataset_r=0.25),
        model=m.ModelConfig(name="lr", num_classes=10,
                            input_shape=(28, 28, 1)),
        train=m.TrainConfig(lr=0.05, momentum=0.5, epochs=1),
        fed=m.FedConfig(num_rounds=2, **fed), seed=3)


def _lr_vars(variables, lead=0):
    return vision_state_dict(jax.device_get(variables),
                             "LogisticRegression", lead)


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_topologies_match_jax_bit_for_bit(kind):
    if kind == "symmetric":
        args = dict(n=9, neighbor_num=4, extra_links=3, seed=5)
        want = JT.SymmetricTopologyManager(**args)
        got = TT.SymmetricTopologyManager(**args)
    else:
        args = dict(n=9, neighbor_num=4, out_drop=2, seed=5)
        want = JT.AsymmetricTopologyManager(**args)
        got = TT.AsymmetricTopologyManager(**args)
    assert np.array_equal(got.mixing_matrix(), want.mixing_matrix())
    for node in range(9):
        assert (got.get_in_neighbor_idx_list(node)
                == want.get_in_neighbor_idx_list(node))
        assert (got.get_out_neighbor_idx_list(node)
                == want.get_out_neighbor_idx_list(node))


@pytest.mark.parametrize("beta", [0.0, 0.25])
def test_stream_matches_jax_bit_for_bit(beta):
    want = JS.make_susy_like_stream(N, 100, beta=beta, seed=2)
    got = TS.make_susy_like_stream(N, 100, beta=beta, seed=2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_two_hierarchical_rounds_match_jax():
    jcfg = _cfg(jc)
    jsim = JH.HierarchicalFedAvg(jax_create_model(jcfg.model),
                                 jax_load_dataset(jcfg.data), jcfg,
                                 num_groups=2, group_comm_round=2)
    max_n = jsim.arrays.max_client_samples

    def batch_orders(r, g, inner, c):  # fold_in(rkey, g), then inner, c
        gkey = jax.random.fold_in(JR.round_key(jsim.root_key, r), g)
        ckey = JR.client_key(jax.random.fold_in(gkey, inner), c)
        return [torch.from_numpy(o) for o in lane_orders(
            ckey, jsim.arrays.mask[c], 1, max_n)]

    tcfg = _cfg(tc)
    tsim = TH.HierarchicalFedAvg(create_model(tcfg.model, "cpu"),
                                 load_dataset(tcfg.data), tcfg, "cpu",
                                 num_groups=2, group_comm_round=2,
                                 batch_orders=batch_orders)
    assert np.array_equal(tsim.grouping, np.asarray(jsim.grouping))
    jstate = jsim.init()
    tstate = tsim.init()._replace(variables=_lr_vars(jstate.variables))
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        for k in ("train_loss", "train_acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **BAND)
    assert tstate.round == int(jstate.round) == 2
    want = _lr_vars(jstate.variables)
    for k in want:
        close(tstate.variables[k], want[k].numpy(), BAND, k)
    jev, tev = jsim.evaluate_global(jstate), tsim.evaluate_global(tstate)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(tev[k], jev[k], **BAND)


@pytest.mark.parametrize("method", ["dsgd", "pushsum"])
def test_two_decentralized_rounds_match_jax(method):
    # push-sum on a directed topology: its columns do not sum to 1, so
    # the push weights move
    jtopo = ttopo = None
    if method == "pushsum":
        jtopo = JT.AsymmetricTopologyManager(N, neighbor_num=4, seed=1)
        ttopo = TT.AsymmetricTopologyManager(N, neighbor_num=4, seed=1)
    jcfg = _cfg(jc)
    jsim = JD.DecentralizedSim(jax_create_model(jcfg.model),
                               jax_load_dataset(jcfg.data), jcfg,
                               topology=jtopo, method=method)
    max_n = jsim.arrays.max_client_samples

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.from_numpy(o) for o in lane_orders(
            ckey, jsim.arrays.mask[c], 1, max_n)]

    tcfg = _cfg(tc)
    tsim = TD.DecentralizedSim(create_model(tcfg.model, "cpu"),
                               load_dataset(tcfg.data), tcfg, "cpu",
                               topology=ttopo, method=method,
                               batch_orders=batch_orders)
    jstate = jsim.init()
    tstate = tsim.init()._replace(
        stacked_vars=_lr_vars(jstate.stacked_vars, lead=1))
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        for k in ("train_loss", "train_acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **BAND)
    close(tstate.push_weights, jstate.push_weights, BAND, "push_weights")
    if method == "pushsum":
        assert not np.allclose(np.asarray(jstate.push_weights), 1.0)
    want = _lr_vars(jstate.stacked_vars, lead=1)
    assert set(want) == set(tstate.stacked_vars)
    for k, v in want.items():
        close(tstate.stacked_vars[k], v.numpy(), BAND, k)
    jev = jsim.evaluate_consensus(jstate)
    tev = tsim.evaluate_consensus(tstate)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(tev[k], jev[k], **BAND)
    np.testing.assert_allclose(tsim.consensus_distance(tstate),
                               jsim.consensus_distance(jstate), **BAND)


@pytest.mark.parametrize("method,time_varying", [
    ("dsgd", False), ("pushsum", False), ("pushsum", True)])
def test_online_sims_match_jax(method, time_varying):
    xs, ys = TS.make_susy_like_stream(N, 100, beta=0.25, seed=0)
    kw = dict(method=method, lr=0.1, weight_decay=1e-3,
              time_varying=time_varying, seed=4)
    jsink, tsink = JaxSink(), MetricsSink()
    want = JD.OnlineDecentralizedSim(xs, ys, **kw).run(jsink, log_every=25)
    tsim = TD.OnlineDecentralizedSim(xs, ys, device="cpu", **kw)
    got = tsim.run(tsink, log_every=25)
    close(got["losses"], want["losses"], BAND, "losses")
    close(got["regret"], want["regret"], BAND, "regret")
    for g, w in zip(got["params"], want["params"]):
        close(g, w, BAND, "params")
    np.testing.assert_allclose(got["final_regret"], want["final_regret"],
                               **BAND)
    assert got["regret"][-1] < got["regret"][9]
    strip = [[{k: v for k, v in row.items() if k != "_ts"}
              for row in sink.history] for sink in (tsink, jsink)]
    assert [sorted(r) for r in strip[0]] == [sorted(r) for r in strip[1]]
    for a, b in zip(*strip):
        assert a["round"] == b["round"]
        np.testing.assert_allclose(a["regret"], b["regret"], **BAND)
    # a second run replays the same buffers
    again = tsim.run()
    assert torch.equal(again["losses"], got["losses"])


def test_harness_builds_every_new_name(tmp_path):
    sims = {"hierarchical": TH.HierarchicalFedAvg,
            "decentralized_dsgd": TD.DecentralizedSim,
            "decentralized_pushsum": TD.DecentralizedSim,
            "dol_dsgd": TD.OnlineDecentralizedSim,
            "dol_pushsum": TD.OnlineDecentralizedSim}
    for algo, cls in sims.items():
        cfg = _cfg(tc, algorithm=algo)
        sim = build_sim(cfg, "cpu")
        assert isinstance(sim, cls), algo
        if algo.startswith("decentralized"):
            assert sim.method == algo.split("_")[1]
        if algo.startswith("dol_"):
            assert (sim.n, sim.t) == (N, cfg.fed.num_rounds)
    # the fedseg alias is FedAvg with the dataset's segmentation task
    seg = tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_seg", num_clients=4,
                           batch_size=8),
        model=tc.ModelConfig(name="deeplab", num_classes=4,
                             input_shape=(32, 32, 3),
                             extra=(("encoder_features", (8, 16)),)),
        fed=tc.FedConfig(algorithm="fedseg", clients_per_round=2))
    assert build_sim(seg, "cpu").task.name == "segmentation"
    # the UCI streams read data on disk (tests/test_torch_natural_data.py
    # holds them against the JAX package's): a missing file raises
    for name, file in (("susy", "SUSY.csv"), ("ro", "datatraining.txt")):
        cfg = _cfg(tc, algorithm="dol_dsgd")
        cfg = cfg.__class__(**{**cfg.__dict__, "data": tc.DataConfig(
            dataset=name, num_clients=N, data_dir=str(tmp_path))})
        with pytest.raises(FileNotFoundError, match=file):
            build_sim(cfg, "cpu")
    # one repetition through the harness: the decentralized sim's
    # evaluation is its consensus model's; the online sim logs its regret
    for algo in ("decentralized_dsgd", "dol_pushsum"):
        cfg = tc.ExperimentConfig(**{**_cfg(tc, algorithm=algo).__dict__,
                                     "out_dir": str(tmp_path),
                                     "run_name": algo})
        summary = Experiment(cfg, device="cpu").run()[0]
        rows = [json.loads(line) for line in open(os.path.join(
            tmp_path, f"{algo}_rep0", "metrics.jsonl"))]
        if algo == "dol_pushsum":
            assert "final_regret" in summary and rows[-1]["round"] == 1
        else:
            assert len(rows) == 2 and "test_acc" in rows[-1]
            assert np.isfinite(summary["test_loss"])
