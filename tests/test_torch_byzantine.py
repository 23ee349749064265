"""The defended, attacked and compressed round: the port's adversaries
(fedml_tpu_torch/core/adversary.py) against the JAX package's, whole
FedAvgSim rounds against the JAX FedAvgSim with every random draw
replayed, and the port alone reproducing the JAX suite's behaviour
(tests/test_byzantine.py): each defense stays near the clean run while
the undefended mean is steered away.

Bands: the member choices and the elementwise attacks bit for bit,
collude's rtol 1e-6 / atol 2.5e-7 (its norm is a float32 sum; one ulp
at the values' magnitude of 2, after the global values are added back);
three simulated
rounds at rtol 2e-5 / atol 2e-6, the band of the port's other sim-level
parity tests (float32 sums reassociate)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms.base import _padded_perm
from fedml_tpu.core import adversary as JA
from fedml_tpu.core import compress as JC
from fedml_tpu.core import random as JR
from fedml_tpu.core import robust as JRobust
from fedml_tpu.core import tree as JT
from fedml_tpu.data.loaders import load_dataset as jax_load_dataset
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.core import adversary as A
from fedml_tpu_torch.core import random as R
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import create_model
from tests.torch_threads import one_torch_thread  # noqa: F401

SIM_TOL = dict(rtol=2e-5, atol=2e-6)
SHAPES = {"a": (3, 4), "b": (5,)}  # sorted: both packages' leaf order


# -- the adversaries -----------------------------------------------------------


def _jax_draws(policy):
    """A :data:`fedml_tpu_torch.core.random.Draws` giving the JAX
    package's adversary draws for a tree of SHAPES (one key per leaf,
    split in sorted-key order)."""

    def draws(stream, r, slots, shapes):
        rk = JA._round_key(policy, r)
        keys = ([jax.random.fold_in(rk, c) for c in slots]
                if stream == "gauss" else [rk])
        rows = []
        for key in keys:
            leaf_keys = jax.random.split(key, len(shapes))
            rows.append({k: np.asarray(jax.random.normal(kk, shapes[k]))
                         for k, kk in zip(sorted(shapes), leaf_keys)})
        return {k: torch.from_numpy(np.stack([row[k] for row in rows]))
                for k in shapes}

    return draws


@pytest.mark.parametrize("mode", A.MODES)
def test_attacks_match_jax(mode):
    policy = tc.AdversaryPolicy(mode=mode, ranks=(1, 3), scale=3.0,
                                noise_stddev=0.5, seed=4)
    jpolicy = JA.AdversaryPolicy(mode=mode, ranks=(1, 3), scale=3.0,
                                 noise_stddev=0.5, seed=4)
    rng = np.random.default_rng(0)
    stacked = {k: rng.standard_normal((4,) + s).astype(np.float32)
               for k, s in SHAPES.items()}
    cohort = [7, 2, 5, 0]
    draws = _jax_draws(jpolicy)
    got = A.corrupt_stacked_deltas(
        policy, {k: torch.from_numpy(v) for k, v in stacked.items()},
        cohort, lambda s, slots, shapes: draws(s, 2, slots, shapes))
    want = JA.corrupt_stacked_deltas(
        jpolicy, {k: jnp.asarray(v) for k, v in stacked.items()}, 2,
        jnp.asarray(cohort))
    band = dict(rtol=1e-6, atol=2.5e-7) if mode == "collude" else dict(
        rtol=0, atol=0)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **band)
    # a deployed adversary corrupts its own result the same way
    glob = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    new = {k: glob[k] + stacked[k][0] for k in SHAPES}
    got = A.corrupt_client_vars(
        policy, {k: torch.from_numpy(v) for k, v in glob.items()},
        {**{k: torch.from_numpy(v) for k, v in new.items()},
         "stat": torch.ones(2)}, ("stat",), 7,
        lambda s, slots, shapes: draws(s, 2, slots, shapes))
    want = JA.corrupt_client_vars(
        jpolicy, {"params": glob}, {"params": new,
                                    "batch_stats": {"stat": np.ones(2)}},
        2, 7)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want["params"][k]), **band)
    assert torch.equal(got["stat"], torch.ones(2))


def test_member_choice_matches_jax():
    for seed in range(5):
        for pop, n, base in ((10, 3, 0), (100, 30, 0), (4, 6, 1)):
            kw = dict(mode="zero", num_adversaries=n, seed=seed)
            got = tc.AdversaryPolicy(**kw).member_ids(pop, base)
            want = JA.AdversaryPolicy(**kw).member_ids(pop, base)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    kw = dict(mode="gauss", ranks=(5, 2, 5))
    np.testing.assert_array_equal(tc.AdversaryPolicy(**kw).member_ids(8),
                                  [2, 5])
    assert tc.AdversaryPolicy(**kw).is_member(5, 8)
    with pytest.raises(ValueError, match="outside"):
        tc.AdversaryPolicy(**kw).member_ids(4)
    # no mode, or nobody: disabled, as in the JAX package
    assert not tc.AdversaryPolicy(mode="zero").enabled()
    assert not tc.AdversaryPolicy(num_adversaries=3).enabled()
    assert tc.AdversaryPolicy().member_ids(10).size == 0
    with pytest.raises(ValueError, match="adversary mode"):
        tc.AdversaryPolicy(mode="flip")
    with pytest.raises(ValueError, match="num_adversaries"):
        tc.AdversaryPolicy(num_adversaries=-1)
    policy = tc.AdversaryPolicy(mode="zero", num_adversaries=3, seed=7)
    cohort = [0, 3, 5, 9, 1]
    np.testing.assert_array_equal(
        A.cohort_mask(policy, cohort, 10).numpy(),
        np.asarray(JA.cohort_mask(JA.AdversaryPolicy(
            mode="zero", num_adversaries=3, seed=7), jnp.asarray(cohort), 10)))


def test_config_round_trips_the_adversary():
    cfg = tc.ExperimentConfig(adversary=tc.AdversaryPolicy(
        mode="gauss", ranks=(3, 1), seed=2, scale=4.0))
    back = tc.ExperimentConfig.from_dict(dataclasses.asdict(cfg))
    assert back == cfg and back.adversary.ranks == (3, 1)
    import json
    back = tc.ExperimentConfig.from_dict(json.loads(cfg.to_json()))
    assert back.adversary.ranks == (3, 1)


def test_device_draws_are_seeded_by_their_coordinates():
    draws = R.DeviceDraws({"gauss": 3, "quant": 3}, "cpu")
    shapes = {"w": (2, 3), "b": (4,)}
    one = draws("gauss", 1, [5, 8], shapes)
    assert one["w"].shape == (2, 2, 3) and one["b"].shape == (2, 4)
    # a slot's draw depends on its own coordinates alone
    again = draws("gauss", 1, [8], shapes)
    assert torch.equal(again["w"][0], one["w"][1])
    assert not torch.equal(draws("gauss", 2, [5], shapes)["w"][0],
                           one["w"][0])
    u = draws("quant", 1, [5], shapes)["b"]
    assert torch.all((u >= 0) & (u < 1))


# -- whole rounds against the JAX FedAvgSim ------------------------------------


LR_LEAVES = (("bias", "linear.bias"), ("kernel", "linear.weight"))


def _replay(jsim, jspec):
    """The JAX FedAvgSim's draws for round r, as the port's hooks want
    them: the cohort, the batch orders, and each stream of
    :data:`fedml_tpu_torch.core.random.Draws` (the lr model's two leaves:
    the kernel is the transpose of the port's weight)."""
    policy = jsim.cfg.adversary
    max_n = jsim.arrays.max_client_samples

    def sampler(r, n, k):
        key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
        return torch.tensor(np.asarray(JR.sample_clients(key, n, k)))

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(ckey, e), jsim.arrays.mask[c], max_n)))
            for e in range(jsim.cfg.train.epochs)]

    def draws(stream, r, slots, shapes):
        rkey = JR.round_key(jsim.root_key, r)
        keys = {"noise": lambda: [jax.random.fold_in(rkey, 1)],
                "quant": lambda: [JC.slot_key(jspec, rkey, s)
                                  for s in slots],
                "gauss": lambda: [jax.random.fold_in(
                    JA._round_key(policy, r), c) for c in slots],
                "collude": lambda: [JA._round_key(policy, r)]}[stream]()
        draw = jax.random.uniform if stream == "quant" else \
            jax.random.normal
        out = {name: [] for _, name in LR_LEAVES}
        for key in keys:
            for (_, name), k in zip(LR_LEAVES, jax.random.split(key, 2)):
                shape = shapes[name]
                flip = len(shape) == 2
                x = np.asarray(draw(k, shape[::-1] if flip else shape))
                out[name].append(x.T if flip else x)
        return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()
                if k in shapes}

    return sampler, batch_orders, draws


def _cfg(m, method="mean", mode="none", compress="none", num_clients=8,
         cohort=6, rounds=3, ranks=(), f=2, **fed):
    adversary = (m.AdversaryPolicy if m is tc else JA.AdversaryPolicy)(
        mode=mode, num_adversaries=0 if ranks else 2, ranks=ranks, seed=3,
        noise_stddev=0.5)
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=num_clients,
                          batch_size=32, seed=0),
        model=m.ModelConfig(name="lr", num_classes=10,
                            input_shape=(28, 28, 1)),
        train=m.TrainConfig(lr=0.1, epochs=1, cohort_groups=1),
        fed=m.FedConfig(num_rounds=rounds, clients_per_round=cohort,
                        eval_every=rounds, robust_method=method,
                        robust_num_adversaries=f, robust_trim_frac=0.2,
                        compress=compress, compress_topk_frac=0.05, **fed),
        adversary=adversary, seed=0)


@functools.lru_cache(maxsize=None)
def _datasets(num_clients=8):
    """fake_mnist for both packages (bitwise the same data), made once."""
    return (jax_load_dataset(_cfg(jc, num_clients=num_clients).data),
            load_dataset(_cfg(tc, num_clients=num_clients).data))


def _sims(**kw):
    """A JAX and a port FedAvgSim of ``_cfg(**kw)``, the port replaying
    the JAX one's draws, both from the JAX sim's initial state."""
    jcfg, tcfg = _cfg(jc, **kw), _cfg(tc, **kw)
    jdata, tdata = _datasets()
    jsim = jfed.FedAvgSim(jax_create_model(jcfg.model), jdata, jcfg)
    sampler, batch_orders, draws = _replay(
        jsim, JC.CompressionSpec.from_fed(jcfg.fed, seed=jcfg.seed))
    tsim = tfed.FedAvgSim(create_model(tcfg.model, "cpu"), tdata, tcfg,
                          device="cpu", sampler=sampler,
                          batch_orders=batch_orders, draws=draws)
    jstate = jsim.init()
    return jsim, tsim, jstate, tsim.init()._replace(
        variables=_to_port(jstate.variables))


def _unoptimized(fn):
    """``fn`` jitted, compiled at its first call without LLVM's
    optimizations: a small reference program run three times, where the
    optimizer would take longer than the runs (and would contract
    products into FMAs the port does not make)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)

    return call


def _to_port(variables):
    return vision_state_dict(jax.device_get(variables), "LogisticRegression")


def _to_jax_stacked(stacked):
    """The port's stacked lr variables as the JAX package's."""
    return {"params": {"Dense_0": {
        "bias": jnp.asarray(stacked["linear.bias"].numpy()),
        "kernel": jnp.asarray(stacked["linear.weight"].numpy()
                              .swapaxes(1, 2))}}}


def _to_port_stacked(stacked):
    """The JAX package's stacked lr variables as the port's."""
    dense = jax.device_get(stacked)["params"]["Dense_0"]
    return {"linear.weight": torch.from_numpy(
        np.ascontiguousarray(np.swapaxes(dense["kernel"], 1, 2))),
        "linear.bias": torch.from_numpy(np.asarray(dense["bias"]))}


def _assert_vars_close(got, jax_vars, err=""):
    want = _to_port(jax_vars)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   **SIM_TOL, err_msg=f"{err} {k}")


# Every rule under each of three attacks, clip and noise on, and each
# codec. Six pairs run free, the JAX FedAvgSim's whole rounds against the
# port's (each rule once, each attack twice); the other twelve run the
# port's rounds against the JAX FedAvgSim's own steps after the local
# updates, from the same local results and state (one JAX compile of the
# local update fewer each), three of them compressed (a compressed run
# cannot run free: see test_rounds_after_locals_match_jax)
FREE = [("mean", "gauss"), ("median", "collude"),
        ("trimmed_mean", "sign_flip"), ("krum", "gauss"),
        ("multikrum", "collude"), ("fltrust", "sign_flip")]
CODECS = {("krum", "sign_flip"): "topk_int8", ("median", "gauss"): "int8",
          ("fltrust", "collude"): "topk"}
AFTER_LOCALS = [(method, mode, CODECS.get((method, mode), "none"))
                for method in tfed.robust.DefensePipeline.METHODS
                for mode in ("sign_flip", "gauss", "collude")
                if (method, mode) not in FREE]


@pytest.mark.parametrize("method,mode", FREE)
def test_rounds_match_jax(method, mode):
    """3 rounds of 6 of 8 clients on fake_mnist (lr), 2 seeded
    adversaries, clip 2 and noise 1e-3: the port's parameters and train
    metrics against the JAX FedAvgSim's round (``_round``, the program
    its ``run_round`` compiles), with its cohorts, batch orders, noise
    and adversary draws replayed."""
    jsim, tsim, jstate, tstate = _sims(method=method, mode=mode,
                                       robust_norm_clip=2.0,
                                       robust_noise_stddev=1e-3)
    jround = _unoptimized(jsim._round)
    for _ in range(3):
        jstate, jm = jround(jstate, jsim.arrays)
        tstate, tm = tsim.run_round(tstate)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       **SIM_TOL, err_msg=k)
    _assert_vars_close(tstate.variables, jstate.variables)


@pytest.mark.parametrize("method,mode,compress", AFTER_LOCALS)
def test_rounds_after_locals_match_jax(method, mode, compress):
    """3 rounds, each the port's whole round against the JAX FedAvgSim's
    own steps after the local updates (``_inject_adversaries``,
    ``_wire_roundtrip``, ``_screen_nonfinite``, ``server_update``, in
    ``_round``'s order) on the port's local results, from the same state
    and error-feedback residual, the cohorts, adversary, noise and
    quantizer draws replayed: the new parameters, the new residual and
    its norm in SIM_TOL. The payloads are held bit for bit in
    tests/test_torch_compress.py.

    A compressed run cannot be held elementwise running free: an ulp of
    difference in local training flips a quantizer code or a top-k
    boundary, one quantization step apart (on this configuration 2
    elements after two rounds; a round later topk_int8's scale moves
    every kept value of the leaf), so each round starts from the JAX
    side's state and residual."""
    jsim, tsim, jstate, tstate = _sims(method=method, mode=mode,
                                       compress=compress,
                                       robust_norm_clip=2.0,
                                       robust_noise_stddev=1e-3)
    cfg = jsim.cfg
    jres = (JC.zero_residual(jstate.variables, cfg.fed.clients_per_round)
            if compress != "none" else None)
    seen = {}
    port_locals = tsim._locals

    def recording_locals(state, cohort=None):
        seen["cohort"] = cohort
        seen["out"] = port_locals(state, cohort)
        return seen["out"]

    tsim._locals = recording_locals

    @_unoptimized
    def after_locals(jstate, jstacked, n_k, cohort, jres):
        rkey = JR.round_key(jsim.root_key, jstate.round)
        jstacked = jsim._inject_adversaries(jstate, jsim.arrays, jstacked,
                                            cohort)
        if jres is not None:
            jstacked, jres = jsim._wire_roundtrip(jstate, jstacked, jres,
                                                  rkey, None)
        jstacked, n_k, rejected = jsim._screen_nonfinite(jstate, jstacked,
                                                         n_k)
        return jfed.server_update(
            cfg.fed, cfg.train, jsim.steps_per_epoch, jsim.batch_size,
            jstate, jstacked, n_k, rkey, jfed.local_reducer()), jres, \
            rejected

    for r in range(3):
        # the same state and residual on both sides
        tstate = tstate._replace(variables=_to_port(jstate.variables))
        if r and jres is not None:
            tsim.ef_residual = _to_port_stacked(jres)
        tstate, tm = tsim.run_round(tstate)
        stacked, n_k, _ = seen["out"]
        jstate, jres, rejected = after_locals(
            jstate, _to_jax_stacked(stacked), jnp.asarray(n_k.numpy()),
            jnp.asarray(seen["cohort"], jnp.int32), jres)
        _assert_vars_close(tstate.variables, jstate.variables,
                           f"round {r}")
        assert float(tm["nonfinite_rejected"]) == float(rejected)
        if jres is None:
            assert "compress_residual_norm" not in tm
            continue
        want = _to_port_stacked(jres)
        for k in want:
            np.testing.assert_allclose(
                tsim.ef_residual[k].numpy(), want[k].numpy(), **SIM_TOL,
                err_msg=f"round {r} residual {k}")
        np.testing.assert_allclose(float(tm["compress_residual_norm"]),
                                   float(JT.tree_l2_norm(jres)), **SIM_TOL)


def test_defended_settings_construct_and_refusals_match_jax():
    """Every rule, codec and attack constructs; the JAX package's
    refusals are the port's."""
    data = load_dataset(tc.DataConfig(dataset="fake_mnist", num_clients=4))
    model = create_model(tc.ModelConfig(name="lr"), "cpu")
    for method in ("median", "trimmed_mean", "krum", "multikrum", "fltrust"):
        tfed.FedAvgSim(model, data, _cfg(tc, method=method), device="cpu")
    for compress in ("int8", "topk", "topk_int8"):
        tfed.FedAvgSim(model, data, _cfg(tc, compress=compress),
                       device="cpu")
    for mode in A.MODES:
        sim = tfed.FedAvgSim(model, data, _cfg(tc, mode=mode),
                             device="cpu")
        assert sim.cfg.adversary.enabled()
    tfed.FedAvgSim(model, data, _cfg(tc, robust_norm_clip=1.0,
                                     robust_noise_stddev=0.1,
                                     algorithm="fednova"), device="cpu")
    # fednova with a reducing rule: the JAX sim refuses it at
    # construction, a multikrum that keeps everyone in its pipeline
    jcfg = _cfg(jc, method="krum", algorithm="fednova")
    with pytest.raises(ValueError, match="fednova"):
        jfed.FedAvgSim(jax_create_model(jcfg.model),
                       jax_load_dataset(jcfg.data), jcfg)
    with pytest.raises(ValueError, match="fednova"):
        tfed.FedAvgSim(model, data, _cfg(tc, method="krum",
                                         algorithm="fednova"), device="cpu")
    with pytest.raises(ValueError, match="multikrum"):
        JRobust.DefensePipeline.from_fed(_cfg(jc, method="multikrum",
                                              f=0).fed)
    with pytest.raises(ValueError, match="multikrum"):
        tfed.FedAvgSim(model, data, _cfg(tc, method="multikrum", f=0),
                       device="cpu")


# -- the port alone: defenses hold where the mean is steered away --------------


SCENARIOS = {
    # 1 of 4 clients sign-flips its delta, boosted 10x
    "signflip_1of4": (4, dict(mode="sign_flip", ranks=(0,), scale=10.0)),
    # 2 of 8 sign-flip, boosted 50x
    "boostflip_2of8": (8, dict(mode="sign_flip", ranks=(1, 5), scale=50.0)),
}
_LOSSES: dict = {}


def _port_loss(num_clients, policy=None, method="mean", f=0, rounds=4):
    cfg = _cfg(tc, method=method, num_clients=num_clients,
               cohort=num_clients, rounds=rounds, f=f)
    cfg = dataclasses.replace(cfg, adversary=policy or tc.AdversaryPolicy())
    sim = tfed.FedAvgSim(create_model(cfg.model, "cpu"),
                         load_dataset(cfg.data), cfg, device="cpu")
    state = sim.init()
    for _ in range(rounds):
        state, m = sim.run_round(state)
    assert all(torch.isfinite(v).all() for v in state.variables.values())
    return float(m["train_loss"])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("defense", ["krum", "multikrum", "fltrust",
                                     "median"])
def test_defended_run_stays_near_clean_while_mean_diverges(scenario,
                                                           defense):
    """The JAX suite's scenarios and bars, over 4 rounds (its 6 cost
    time and change nothing: the undefended mean's loss is above 100 by
    round 4 in both scenarios, every defense within 0.005 of clean)."""
    nc, adv = SCENARIOS[scenario]
    policy = tc.AdversaryPolicy(**adv)
    if scenario not in _LOSSES:
        _LOSSES[scenario] = (_port_loss(nc), _port_loss(nc, policy))
    clean, attacked = _LOSSES[scenario]
    defended = _port_loss(nc, policy, defense, f=len(policy.ranks))
    assert attacked > clean + 1.0, (clean, attacked)
    assert defended < clean + 0.05, (defense, clean, defended, attacked)


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--defense", "krum", "--defense_num_adversaries", "3",
     "--adversary_mode", "sign_flip", "--adversary_num", "30",
     "--compress", "topk_int8"],
    ["--robust_method", "trimmed_mean", "--defense_trim_frac", "0.3",
     "--robust_norm_clip", "1.5", "--robust_noise_stddev", "0.01",
     "--adversary_mode", "gauss", "--adversary_ranks", "4", "2",
     "--adversary_noise", "0.2", "--adversary_seed", "9",
     "--compress", "int8", "--compress_topk_frac", "0.05"],
    ["--robust_method", "median", "--defense", "multikrum",
     "--defense_multikrum_m", "4", "--adversary_mode", "collude",
     "--adversary_num", "2", "--adversary_scale", "3.0"],
])
def test_cli_parses_the_defense_flags_as_jax(flags):
    """Each new flag lands in the same FedConfig and AdversaryPolicy
    fields, with the same values, as the JAX CLI's."""
    from fedml_tpu.experiments import run as jcli
    from fedml_tpu_torch.experiments import run as tcli

    argv = ["--algorithm", "fedavg", "--dataset", "fake_cifar10",
            "--model", "resnet56", "--client_num_in_total", "100"] + flags
    tcfg, _ = tcli.parse_args(argv)
    jcfg, _ = jcli.parse_args(argv)
    for f in dataclasses.fields(tc.FedConfig):
        assert getattr(tcfg.fed, f.name) == getattr(jcfg.fed, f.name), f.name
    for f in dataclasses.fields(tc.AdversaryPolicy):
        assert getattr(tcfg.adversary, f.name) == \
            getattr(jcfg.adversary, f.name), f.name


def test_cli_refuses_what_the_jax_cli_refuses():
    from fedml_tpu_torch.experiments import run as tcli

    for argv in (["--defense", "multikrum"],
                 ["--algorithm", "fednova", "--defense", "krum"],
                 ["--compress", "topk", "--compress_topk_frac", "0"]):
        with pytest.raises(SystemExit):
            tcli.parse_args(argv)
