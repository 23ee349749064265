"""Split learning in the port against the JAX package: the split models'
forwards (train mode with its new batch statistics, and eval mode) on
flax weights carried across by ``fedml_tpu_torch/convert.py``; one and
two rounds of FedGKT (an edge ``GKTClientResNet(num_blocks=1, width=8)``,
a server ``GKTServerResNet(blocks_per_stage=(1, 1, 1), widths=(4, 8,
8))``; in float64 on both sides, its float32 server being
ill-conditioned) and of SplitNN (convs 8/16, hidden 32) on 16x16x3 inputs, 3
clients of uneven size, with the JAX sims' batch orders (FedGKT's edge
and server orders, SplitNN's ring orders) replayed through the hooks;
three epochs of vertical FL on the harness's ``fake_vfl`` with its
accuracy and AUC; ``load_torch_gkt_state`` on a checkpoint written here;
the two vertical readers bit for bit on tiny files; and the harness
building every name of the JAX registry on the CPU. Float32 at rtol
1e-4, atol 1e-5 (the forwards at rtol 1e-5, atol 1e-6). The JAX runs are
module-scoped."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import split as JS
from fedml_tpu.core import random as JR
from fedml_tpu.data import federated as jfd
from fedml_tpu.data import vertical as JV
from fedml_tpu.experiments import harness as jh
from fedml_tpu.models import gkt as JG
from fedml_tpu_torch.algorithms import split as TS
from fedml_tpu_torch.convert import gkt_state_dict, vision_state_dict
from fedml_tpu_torch.data import federated as tfd
from fedml_tpu_torch.data import vertical as TV
from fedml_tpu_torch.experiments.harness import Experiment, build_sim
from fedml_tpu_torch.models import gkt as TG
from fedml_tpu_torch.models.base import FedModel, weightless
from tests.test_torch_gan import close
from tests.torch_threads import one_torch_thread  # noqa: F401

BAND = dict(rtol=1e-4, atol=1e-5)
FWD = dict(rtol=1e-5, atol=1e-6)
SHAPE = (16, 16, 3)
K = 10
SIZES = (40, 30, 26)  # uneven clients: partial and padding batches
B = 8


def image_data(m, sizes=SIZES, n_test=32, seed=0):
    """``m``'s FederatedData of random 16x16x3 images and labels from a
    numpy seed, client ``i`` owning ``sizes[i]`` samples (the same maps on
    both sides)."""
    rng = np.random.default_rng(seed)
    n = sum(sizes)
    x = rng.normal(size=(n,) + SHAPE).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.int32)
    xt = rng.normal(size=(n_test,) + SHAPE).astype(np.float32)
    yt = rng.integers(0, K, n_test).astype(np.int32)
    perm = rng.permutation(n)
    bounds = np.cumsum((0,) + tuple(sizes))
    train = {i: np.sort(perm[bounds[i]:bounds[i + 1]])
             for i in range(len(sizes))}
    test = {i: np.arange(n_test)[i::len(sizes)] for i in range(len(sizes))}
    return m.FederatedData(x, y, xt, yt, train, test, K)


def tiny_cfg(m, **train):
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=len(SIZES),
                          batch_size=B, seed=0),
        model=m.ModelConfig(name="lr", num_classes=K, input_shape=SHAPE),
        train=m.TrainConfig(**{"lr": 0.05, "momentum": 0.5, "epochs": 1,
                               **train}),
        fed=m.FedConfig(num_rounds=2, clients_per_round=len(SIZES)),
        seed=0)


def ordered(key, mask_row, max_n):
    """``permutation(key, max_n)``, the real samples stably first."""
    perm = np.asarray(jax.random.permutation(key, max_n))
    return perm[np.argsort(1.0 - np.asarray(mask_row)[perm], kind="stable")]


def fed_model(module_fn, shape):
    return FedModel(weightless(module_fn), tuple(shape), torch.device("cpu"))


def host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


MODELS = {
    # name: (flax module, the port's module, input shape, converter)
    "gkt_client": (lambda: JG.GKTClientResNet(num_blocks=1, width=8),
                   lambda: TG.GKTClientResNet(K, 1, 8), SHAPE,
                   gkt_state_dict),
    "gkt_server": (lambda: JG.GKTServerResNet(blocks_per_stage=(1, 1, 1),
                                              widths=(4, 8, 8)),
                   lambda: TG.GKTServerResNet(K, (1, 1, 1), (4, 8, 8), 8),
                   (16, 16, 8), gkt_state_dict),
    "split_client": (lambda: JG.SplitClientNet(features=(8, 16)),
                     lambda: TG.SplitClientNet((8, 16)), SHAPE,
                     lambda v: vision_state_dict(v, "SplitClientNet")),
    "split_server": (lambda: JG.SplitServerNet(hidden=32),
                     lambda: TG.SplitServerNet(256, K, 32), (4, 4, 16),
                     lambda v: vision_state_dict(v, "SplitServerNet")),
    "vfl_local": (lambda: JG.VFLLocalModel(out_dim=8, hidden=16),
                  lambda: TG.VFLLocalModel(12, 8, 16), (12,),
                  lambda v: vision_state_dict(v, "VFLLocalModel")),
    "vfl_dense": (lambda: JG.VFLDenseModel(), lambda: TG.VFLDenseModel(8),
                  (8,), lambda v: vision_state_dict(v, "VFLDenseModel")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_split_model_forwards_match_jax(name):
    jmod, tmod, shape, conv = MODELS[name]
    x = np.random.default_rng(1).normal(size=(4,) + shape).astype(np.float32)
    jm = jmod()
    v = jm.init({"params": jax.random.key(2)}, jnp.asarray(x), train=False)
    model = fed_model(tmod, shape)
    tv = conv(host(v))
    fresh = model.init(torch.Generator().manual_seed(0))
    assert {k: t.shape for k, t in fresh.items()} == {
        k: t.shape for k, t in tv.items()}
    outs = [(jm.apply(v, jnp.asarray(x), train=False),
             model.apply_eval(tv, torch.tensor(x)))]
    if "batch_stats" in v:
        jt, mut = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        tt, new = model.apply_train(tv, torch.tensor(x))
        outs.append((jt, tt))
        for k, want in conv(host(mut)).items():
            close(new[k], want.numpy(), FWD, k)
    for want, got in outs:
        for a, b in zip(jax.tree.leaves(want),
                        got if isinstance(got, tuple) else (got,)):
            close(b, np.asarray(a), FWD, name)


# ---------------------------------------------------------------------------
# FedGKT
# ---------------------------------------------------------------------------


def f64(tree):
    """A JAX tree's floating leaves as float64 (under ``enable_x64``)."""
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        tree)


def double(tree):
    return {k: v.double() for k, v in tree.items()}


@pytest.fixture(scope="module")
def gkt_runs():
    """Two rounds of the JAX FedGKTSim and of the port's from the same
    start, their draws replayed; the states after each round. Both run in
    float64: the server's float32 steps on these small BatchNorms are
    ill-conditioned (the JAX package's own float32 server lands 1.2e-3
    from its float64 one after a round: scripts/gkt_float32_drift.py)."""
    jcfg = tiny_cfg(jc)
    jsim = JS.FedGKTSim(JG.GKTClientResNet(num_classes=K, num_blocks=1,
                                           width=8),
                        JG.GKTServerResNet(num_classes=K,
                                           blocks_per_stage=(1, 1, 1),
                                           widths=(4, 8, 8)),
                        image_data(jfd), jcfg)
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

    tcfg = tiny_cfg(tc)
    tsim = TS.FedGKTSim(fed_model(lambda: TG.GKTClientResNet(K, 1, 8), SHAPE),
                        fed_model(lambda: TG.GKTServerResNet(
                            K, (1, 1, 1), (4, 8, 8), 8), (16, 16, 8)),
                        image_data(tfd), tcfg, "cpu",
                        batch_orders=batch_orders,
                        server_orders=server_orders)
    for name in ("x", "test_x"):
        setattr(tsim.arrays, name, getattr(tsim.arrays, name).double())
    start = host(jsim.init())
    tstate = tsim.init()
    server = double(gkt_state_dict(start.server_vars))
    tstate = tstate._replace(
        client_stack=double(gkt_state_dict(start.client_stack, lead=1)),
        server_vars=server,
        server_opt_state=tsim.server_update.opt.init(
            {k: v for k, v in server.items()
             if k not in tsim.server_model.stat_names}),
        server_logits=tstate.server_logits.double())
    out = []
    with jax.enable_x64(True):
        jstate = f64(start)
        for _ in range(2):
            jstate, _ = jsim.run_round(jstate)
            tstate, _ = tsim.run_round(tstate)
            out.append((host(jstate), tstate, jsim.evaluate(jstate),
                        tsim.evaluate(tstate)))
    return out, tsim


@pytest.mark.parametrize("rounds", [1, 2])
def test_fedgkt_rounds_match_jax(gkt_runs, rounds):
    runs, tsim = gkt_runs
    jstate, tstate, jev, tev = runs[rounds - 1]
    assert tstate.round == rounds and tstate.has_server_logits
    want = gkt_state_dict(jstate.client_stack, lead=1)
    assert set(want) == set(tstate.client_stack)
    for k, v in want.items():
        close(tstate.client_stack[k], v.numpy(), BAND, f"edge {k}")
    for k, v in gkt_state_dict(jstate.server_vars).items():
        close(tstate.server_vars[k], v.numpy(), BAND, f"server {k}")
    close(tstate.server_logits, jstate.server_logits, BAND, "logits")
    assert abs(tev["test_acc"] - jev["test_acc"]) <= 1 / 32
    # every client trains every round; the server steps each client's
    # real batches once an epoch
    assert tsim.last_steps["server"] == sum(-(-n // B) for n in SIZES)


# ---------------------------------------------------------------------------
# SplitNN
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def splitnn_runs():
    jcfg = tiny_cfg(jc)
    jsim = JS.SplitNNSim(JG.SplitClientNet(features=(8, 16)),
                         JG.SplitServerNet(num_classes=K, hidden=32),
                         image_data(jfd), jcfg)
    mask = np.asarray(jsim.arrays.mask)

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.from_numpy(ordered(ckey, mask[c], jsim.max_n))]

    tsim = TS.SplitNNSim(
        fed_model(lambda: TG.SplitClientNet((8, 16)), SHAPE),
        fed_model(lambda: TG.SplitServerNet(256, K, 32), (256,)),
        image_data(tfd), tiny_cfg(tc), "cpu", batch_orders=batch_orders)
    jstate = jsim.init()
    tstate = tsim.init()._replace(
        client_stack=vision_state_dict(host(jstate.client_stack),
                                       "SplitClientNet", lead=1),
        server_vars=vision_state_dict(host(jstate.server_vars),
                                      "SplitServerNet"))
    out = []
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        out.append((host(jstate), host(jm), tstate, tm,
                    jsim.evaluate(jstate), tsim.evaluate(tstate)))
    return out


@pytest.mark.parametrize("rounds", [1, 2])
def test_splitnn_rounds_match_jax(splitnn_runs, rounds):
    jstate, jm, tstate, tm, jev, tev = splitnn_runs[rounds - 1]
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **BAND)
    want = vision_state_dict(jstate.client_stack, "SplitClientNet", lead=1)
    for k, v in want.items():
        close(tstate.client_stack[k], v.numpy(), BAND, f"client {k}")
    for k, v in vision_state_dict(jstate.server_vars,
                                  "SplitServerNet").items():
        close(tstate.server_vars[k], v.numpy(), BAND, f"server {k}")
    assert abs(tev["test_acc"] - jev["test_acc"]) <= 1 / 32


# ---------------------------------------------------------------------------
# vertical FL
# ---------------------------------------------------------------------------


def vfl_cfg(m):
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_vfl", batch_size=64, seed=3),
        train=m.TrainConfig(lr=0.1, momentum=0.5),
        fed=m.FedConfig(algorithm="vfl"), seed=0)


def test_vfl_epochs_match_jax():
    jsim = jh.build_sim(vfl_cfg(jc))
    tsim = build_sim(vfl_cfg(tc), "cpu")
    # the harness's fake_vfl set, bit for bit
    for name in ("x_train", "y_train", "x_test", "y_test"):
        assert np.array_equal(getattr(tsim, name).numpy(),
                              np.asarray(getattr(jsim, name))), name
    assert tsim.splits == [tuple(s) for s in jsim.splits]
    jstate = jsim.init()
    pv = tuple((vision_state_dict(host(lv), "VFLLocalModel"),
                vision_state_dict(host(dv), "VFLDenseModel"))
               for lv, dv in jstate.party_vars)
    tstate = tsim.init()._replace(party_vars=pv)
    losses = []
    for _ in range(3):
        jstate, jl = jsim.run_epoch(jstate)
        tstate, tl = tsim.run_epoch(tstate)
        np.testing.assert_allclose(tl, jl, **BAND)
        losses.append(tl)
    assert tstate.step == int(jstate.step) == 3 * (512 // 64)
    assert losses[-1] < losses[0]
    for (tl, td), (jl, jd) in zip(tstate.party_vars, host(jstate.party_vars)):
        for got, want, arch in ((tl, jl, "VFLLocalModel"),
                                (td, jd, "VFLDenseModel")):
            for k, v in vision_state_dict(want, arch).items():
                close(got[k], v.numpy(), BAND, k)
    jev, tev = jsim.evaluate(jstate), tsim.evaluate(tstate)
    assert tev["test_acc"] == jev["test_acc"]
    np.testing.assert_allclose(tev["test_auc"], jev["test_auc"], **BAND)
    assert tev["test_auc"] > 0.5


# ---------------------------------------------------------------------------
# the reference's checkpoint
# ---------------------------------------------------------------------------


def _reference_names(port_name: str) -> str:
    """A port variable's name in the reference's torch ResNet."""
    parts = port_name.split(".")
    if parts[0].startswith("layer"):
        i, b = parts[0][len("layer"):].split("_")
        rest = parts[1:]
        if rest[0] == "downsample_conv":
            rest = ["downsample", "0"] + rest[1:]
        elif rest[0] == "downsample_bn":
            rest = ["downsample", "1"] + rest[1:]
        parts = [f"layer{i}", b] + rest
    return ".".join(parts)


@pytest.mark.parametrize("side", ["client", "server"])
def test_load_torch_gkt_state_matches_jax(tmp_path, side):
    jmod, tmod, shape, _ = MODELS[f"gkt_{side}"]
    v = jmod().init({"params": jax.random.key(0)}, jnp.zeros((1,) + shape),
                    train=False)
    model = fed_model(tmod, shape)
    gen = torch.Generator().manual_seed(5)
    sd = {f"module.{_reference_names(k)}": torch.randn(t.shape, generator=gen)
          for k, t in model.init(gen).items()}
    # a key the checkpoint lacks keeps its value
    del sd["module.layer1.0.conv2.weight"]
    path = os.path.join(tmp_path, "best.pth")
    torch.save({"state_dict": sd}, path)
    want = gkt_state_dict(host(JG.load_torch_gkt_state(path, v, side)))
    start = gkt_state_dict(host(v))
    got = TG.load_torch_gkt_state(path, start, side)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["layer1_0.conv2.weight"],
                       start["layer1_0.conv2.weight"])
    assert not torch.equal(got["fc.weight"], start["fc.weight"])


# ---------------------------------------------------------------------------
# the vertical readers
# ---------------------------------------------------------------------------


def _nus_wide(root, rng):
    labels = ["buildings", "grass", "animal", "water", "person"]
    for split, n in (("Train", 12), ("Test", 8)):
        lab = np.zeros((n, len(labels)), np.int64)
        lab[np.arange(n), rng.integers(0, len(labels), n)] = 1
        lab[0] = 0  # no concept: dropped
        lab[1, :2] = 1  # two concepts: dropped
        d = os.path.join(root, "Groundtruth", "TrainTestLabels")
        os.makedirs(d, exist_ok=True)
        for j, name in enumerate(labels):
            np.savetxt(os.path.join(d, f"Labels_{name}_{split}.txt"),
                       lab[:, j], fmt="%d")
        d = os.path.join(root, "Low_Level_Features")
        os.makedirs(d, exist_ok=True)
        for part, width in (("CH", 3), ("EDH", 2)):
            np.savetxt(os.path.join(d, f"{split}_Normalized_{part}.dat"),
                       rng.normal(size=(n, width)), fmt="%.6f")
        d = os.path.join(root, "NUS_WID_Tags")
        os.makedirs(d, exist_ok=True)
        np.savetxt(os.path.join(d, f"{split}_Tags1k.dat"),
                   rng.integers(0, 2, (n, 4)), fmt="%d", delimiter="\t")


def _loan_csv(path, rng):
    cols = JV.PARTY_A_FEATS + JV.PARTY_B_FEATS + ["loan_status"]
    cats = {"grade": list("ABCDEFG"), "emp_length": ["", "1 year",
                                                     "10+ years"],
            "home_ownership": ["RENT", "OWN"], "verification_status": [
                "Verified", "Not Verified"], "term": [" 36 months",
                                                      " 60 months"],
            "initial_list_status": ["w", "f"], "purpose": ["car", "other"],
            "application_type": ["Individual"], "disbursement_method": [
                "Cash"], "loan_status": ["Fully Paid", "Charged Off"]}
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(20):
            row = []
            for c in cols:
                if c in cats:
                    row.append(cats[c][rng.integers(len(cats[c]))])
                elif c == "revol_util":
                    row.append(f"{rng.uniform(0, 99):.1f}%")
                else:
                    row.append("" if i == 3 else f"{rng.normal():.4f}")
            f.write(",".join(row) + "\n")


@pytest.mark.parametrize("reader", ["nus_wide", "lending_club"])
def test_vertical_readers_match_jax_bit_for_bit(tmp_path, reader):
    rng = np.random.default_rng(0)
    if reader == "nus_wide":
        _nus_wide(str(tmp_path), rng)
        want = JV.load_nus_wide_two_party(str(tmp_path),
                                          binary_positive="person")
        got = TV.load_nus_wide_two_party(str(tmp_path),
                                         binary_positive="person")
    else:
        path = os.path.join(tmp_path, "loan.csv")
        _loan_csv(path, rng)
        want = JV.load_lending_club_two_party(path, test_fraction=0.25)
        got = TV.load_lending_club_two_party(path, test_fraction=0.25)
    assert got["splits"] == want["splits"]
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


# every name of the JAX registry and the class it builds, in both packages
SIMS = {
    **{name: "FedAvgSim" for name in (
        "fedavg", "fedopt", "fedprox", "fednova", "fedavg_robust",
        "fedavg_multiclient", "fedseg")},
    "decentralized_dsgd": "DecentralizedSim",
    "decentralized_pushsum": "DecentralizedSim",
    "dol_dsgd": "OnlineDecentralizedSim",
    "dol_pushsum": "OnlineDecentralizedSim",
    "hierarchical": "HierarchicalFedAvg",
    "fedgan": "FedGANSim", "fedgdkd": "FedGDKDSim", "feddtg": "FedDTGSim",
    "fedssgan": "FedSSGANSim", "feduagan": "FedUAGANSim",
    "fedmd": "FedMDSim", "fd_faug": "FDSim", "fedarjun": "FedArjunSim",
    "fedgkt": "FedGKTSim", "splitnn": "SplitNNSim", "vfl": "VFLSim",
    "classical_vertical_fl": "VFLSim",
    "turboaggregate": "SecureFedAvgSim", "fednas": "FedNASSim",
    "baseline": "BaselineSim", "centralized": "CentralizedTrainer",
}


def harness_cfg(algorithm, **kw):
    return tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", num_clients=4,
                           batch_size=8, dataset_r=0.02,
                           partition_method="hetero"),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        train=tc.TrainConfig(lr=0.05),
        fed=tc.FedConfig(algorithm=algorithm, num_rounds=2,
                         clients_per_round=2, eval_every=1), **kw)


def test_registry_covers_the_jax_names():
    assert set(SIMS) == set(jh.ALGORITHMS)


@pytest.mark.parametrize("algorithm", sorted(SIMS))
def test_harness_builds_every_jax_name(algorithm):
    sim = build_sim(harness_cfg(algorithm), "cpu")
    assert type(sim).__name__ == SIMS[algorithm]


def test_unknown_algorithm_raises_value_error():
    with pytest.raises(ValueError, match="unknown algorithm: nope"):
        build_sim(harness_cfg("nope"), "cpu")


@pytest.mark.parametrize("algorithm", ["splitnn", "vfl", "turboaggregate",
                                       "centralized"])
def test_harness_drives_each_protocol(tmp_path, algorithm):
    """One repetition through the harness's round loop: SplitNN evaluates
    through ``evaluate``, VFL's round is an epoch, the secure FedAvg and
    the centralized trainer take the round index."""
    cfg = harness_cfg(algorithm, out_dir=str(tmp_path), run_name=algorithm)
    summary = Experiment(cfg, device="cpu").run()[0]
    rows = [json.loads(line) for line in open(os.path.join(
        tmp_path, f"{algorithm}_rep0", "metrics.jsonl"))]
    assert [r["round"] for r in rows] == [0, 1]
    assert 0.0 <= summary["test_acc"] <= 1.0
    assert np.isfinite(summary["train_loss"])
