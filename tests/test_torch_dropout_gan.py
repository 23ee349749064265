"""Dropout where the JAX package takes a dropout rng, in the port against
the JAX package: the distillation update of a classifier with dropout,
two FedGDKD rounds over ``cnn`` (CNN_DropOut) with a drift-corrected new
joiner, two FedDTG rounds over a ``cnn`` classifier beside the ACGAN
discriminator (dropout 0.25), and FedAvg over ``cnn`` in the bulk engine
(``client_block_size=2``, a partial block of sentinel ids) against the
JAX package's bulk round and the port's own stacked round.

The JAX sims' cohorts, batch orders, draws and dropout masks are
replayed through the port's hooks (:class:`MaskReplay`): each call's
dropout key is derived as the JAX package derives it and its masks are
captured from flax (``tests/test_torch_gan_family.py`` and
``tests/test_torch_distill.py`` ``mask_capture``): an adversarial step's
three calls from ``split(fold_in(fold_in(client key, epoch), step))``
(FedDTG's classifier: G's key, then the split of the fifth), a
distillation step's from ``fold_in(fold_in(key, epoch), step)`` under the
client's distillation key (salt 0xAD, and 0xD1F7 for the drift
correction). Weights cross with ``fedml_tpu_torch/convert.py``.

The band is the JAX package's GAN band (rtol 1e-4, atol 1e-5), the one
``tests/test_torch_distill.py`` holds the stacked FedAvg round over
``cnn`` in; the bulk round against the port's stacked round is held at
the reference's bulk band (rtol 2e-5, atol 1e-7, ``tests/test_bulk.py``).
FedDTG and FedAvg run in float32. The distillation of ``cnn`` (the KD
case, and FedGDKD's rounds, which distill twice a round) runs in float64
on both sides (``jax.enable_x64``, the port's data and variables
float64): its weight gradients are small sums of large terms of both
signs, and the JAX package's float32 distillation on the CPU lands
outside the band from the float64 result on the same masks. The port's
float32 distillation is held against its own float64 on the same masks
(the KD case)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms import gan_core as JG
from fedml_tpu.algorithms import gan_family as JF
from fedml_tpu.core import random as JR
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms import gan_core as TG
from fedml_tpu_torch.algorithms.gan_family import FedDTGSim, FedGDKDSim
from fedml_tpu_torch.convert import (
    acgan_state_dict,
    generator_state_dict,
    vision_state_dict,
)
from fedml_tpu_torch.models import create_model
from tests import test_torch_distill as DI
from tests import test_torch_gan_family as GF
from tests.test_torch_gan import close, close_vars, to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

ROUND = dict(rtol=1e-4, atol=1e-5)
# the reference's bulk-vs-stacked band (tests/test_bulk.py)
STACKED_TOL = dict(rtol=2e-5, atol=1e-7)
K, B, SHAPE = 10, 8, (28, 28, 1)
# the JAX package's distillation key salts: the leave-one-out
# distillation's and the drift correction's
KD_SALTS = {"dropout_kd": 0xAD, "dropout_drift": 0xD1F7}


class MaskReplay(GF.Replay):
    """:class:`tests.test_torch_gan_family.Replay` (cohorts, batch orders,
    noise, fake labels, the distillation set's noise, the adversarial
    steps' masks) with the classifiers' streams: ``capture_of(stream,
    tag)`` is the mask capture of the model a stream draws for (``tag``:
    the bucket of a scoped stream, ``"<stream>@<bucket>"``), and the
    distillation streams' step keys are under ``kd_key(stream, r, c)``."""

    def __init__(self, jsim, n_split, capture_of, kd_key):
        super().__init__(jsim, n_split, None)
        self.capture_of, self.kd_key = capture_of, kd_key

    def draws(self, stream, r, slots, shapes):
        base, _, tag = stream.partition("@")
        lead = next(iter(shapes.values()))[:2]
        if base in KD_SALTS:
            keys = jnp.stack([DI._step_keys(
                self.kd_key(base, r, c), jnp.arange(lead[0]),
                jnp.arange(lead[1])).reshape(-1) for c in slots]).reshape(-1)
            return DI.to_port_masks(self.capture_of(base, tag)(keys),
                                    (len(slots), *lead))
        if base == "dropout_cls":  # FedDTG's classifier: G's key, split(k3)
            keys = jnp.stack([self.client(r, c, *lead)[3]
                              for c in slots]).reshape(-1)
            return DI.to_port_masks(self.capture_of(base, tag)(keys),
                                    (len(slots), *lead, 3))
        if base == "dropout":
            self.capture = self.capture_of(base, tag)
        return super().draws(base, r, slots, shapes)


def client_kd_key(jsim):
    """The FedGDKD and FedDTG sims' distillation keys: the client key
    folded with the phase's salt."""
    return lambda stream, r, c: DI.fold(JR.client_key(JR.round_key(
        jsim.root_key, r), c), KD_SALTS[stream])


def dropout_cfg(m, algo):
    cfg = GF.tiny_cfg(m, algo)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, name="cnn"))


@pytest.fixture(scope="module")
def data():
    return DI.datasets(dropout_cfg(jc, "fedgdkd"), dropout_cfg(tc, "fedgdkd"))


@pytest.fixture(scope="module")
def cnn_capture():
    return DI.mask_capture(jax_create_model(jc.ModelConfig(
        name="cnn", num_classes=K, input_shape=SHAPE)).module)


def test_kd_update_with_masks_matches_jax(cnn_capture):
    """Two lanes of cnn, two distillation epochs of two steps from
    different starts and teachers: each step's masks replayed from the
    JAX package's key, the classifiers and the loss sums within the band,
    in float64."""
    jcfg = dropout_cfg(jc, "fedgdkd")
    gan = dataclasses.replace(jcfg.gan, kd_epochs=2)
    jmodel = jax_create_model(jcfg.model)
    disc = JG.DiscHandle.from_fed_model(jmodel)
    assert disc.has_dropout
    kd = jax.vmap(JG.build_kd_update(disc, jcfg.train, gan, 16, B),
                  in_axes=(0, None, None, 0, 0))
    rng = np.random.default_rng(0)
    synth_x = rng.uniform(-1, 1, (16,) + SHAPE)
    synth_y = np.arange(16) % K
    teachers = rng.standard_normal((2, 16, K))
    start = DI.stacked_vars(jmodel.module, 2)
    keys = jnp.stack([jax.random.key(5), jax.random.key(6)])
    with jax.enable_x64(True):
        want, jsums = to_numpy(kd(DI.f64(start), synth_x, synth_y,
                                  teachers, keys))
        masks = DI.to_port_masks(cnn_capture(jnp.stack([DI._step_keys(
            k, jnp.arange(2), jnp.arange(2)).reshape(-1) for k in keys])
            .reshape(-1)), (2, 2, 2))
    tcfg = dropout_cfg(tc, "fedgdkd")
    upd = TG.KDUpdate(create_model(tcfg.model, "cpu"), tcfg.train,
                      dataclasses.replace(tcfg.gan, kd_epochs=2), 16, B,
                      False)
    got, sums = upd(DI.double(DI.port_vars(start, lead=1)),
                    torch.tensor(synth_x), torch.tensor(synth_y),
                    torch.tensor(teachers), masks)
    close_vars(got, DI.port_vars(want, lead=1), ROUND, "distilled")
    for k in ("kd_loss_sum", "dist_loss_sum", "batches"):
        close(sums[k], jsums[k], ROUND, k)
    got32, _ = upd(DI.port_vars(start, lead=1), torch.tensor(synth_x).float(),
                   torch.tensor(synth_y), torch.tensor(teachers).float(),
                   masks)
    close_vars(got32, {k: v.float() for k, v in got.items()}, ROUND,
               "float32 against float64")


def check_rounds(jsim, jstate, tsim, state, arch, checks, x64=False):
    """Two rounds of both sims from the same state (with ``x64``, in
    float64: the JAX sim under ``jax.enable_x64``, whose draws the port
    replays there too); after each, the generator, the classifiers (the
    unsampled ones bit for bit as they were) and ``checks(state,
    jstate)`` within the band."""
    for r in range(2):
        before = state.cls_stack
        with jax.enable_x64(x64):
            jstate, jm = jsim.run_round(jstate)
            jstate, jm = jax.device_get((jstate, jm))  # the next round
            state, tm = tsim.run_round(state)          # donates its state
        v = to_numpy(jstate)
        close_vars(state.gen_vars, generator_state_dict(v.gen_vars), ROUND,
                   f"round {r} generator")
        close_vars(state.cls_stack, vision_state_dict(v.cls_stack, arch,
                                                      lead=1), ROUND,
                   f"round {r} classifiers")
        checks(state, v)
        assert set(tm) == set(jm)
        for k in jm:
            close(tm[k], jm[k], ROUND, k)
        cohort = np.asarray(tsim.sampler(r, 4, 2))
        idle = np.setdiff1d(np.arange(4), cohort)
        for k, leaf in state.cls_stack.items():
            assert torch.equal(leaf[idle], before[k][idle]), k
    return jstate, state


def test_fedgdkd_cnn_two_rounds_match_jax(data, cnn_capture):
    """FedGDKD whose classifier is CNN_DropOut, in float64: round 1's
    cohort has a client that was not in
    round 0's, which the drift correction distills under its own
    masks."""
    jdata, tdata = data
    jcfg, tcfg = dropout_cfg(jc, "fedgdkd"), dropout_cfg(tc, "fedgdkd")
    jgen, tgen = GF.gen_pair()
    jsim = JF.FedGDKDSim(jgen, jax_create_model(jcfg.model), jdata, jcfg)
    replay = MaskReplay(jsim, 4, lambda stream, tag: cnn_capture,
                        client_kd_key(jsim))
    tsim = FedGDKDSim(tgen, create_model(tcfg.model, "cpu"), tdata, tcfg,
                      "cpu", sampler=replay.sampler,
                      batch_orders=replay.batch_orders, draws=replay.draws)
    jstate = jax.device_get(jax.jit(jsim.init)())
    v = to_numpy(jstate)
    state = tsim.init()._replace(
        gen_vars=DI.double(generator_state_dict(v.gen_vars)),
        cls_stack=DI.double(vision_state_dict(v.cls_stack, "CNNDropOut",
                                              lead=1)))
    DI.to_float64(tsim)
    drifted = []

    def checks(state, v):
        drifted.append(tsim.last_drift)
        close(state.prev_teacher, v.prev_teacher, ROUND, "teacher")

    with jax.enable_x64(True):
        jstate = DI.f64(jstate)
    check_rounds(jsim, jstate, tsim, state, "CNNDropOut", checks, x64=True)
    assert drifted == [0, 1], drifted


def test_feddtg_cnn_two_rounds_match_jax(data, cnn_capture):
    """FedDTG whose classifier is CNN_DropOut beside the ACGAN
    discriminator: both models' masks in every call of a step, the
    classifier's also in its distillation; every client's accuracy after
    round 2."""
    jdata, tdata = data
    jcfg, tcfg = dropout_cfg(jc, "feddtg"), dropout_cfg(tc, "feddtg")
    jgen, tgen = GF.gen_pair()
    jd, td = GF.jax_disc(), GF.port_disc()
    jsim = JF.FedDTGSim(jgen, jd, jax_create_model(jcfg.model), jdata, jcfg)
    jstate = jax.device_get(jax.jit(jsim.init)())
    disc_capture = GF.mask_capture(jd.module, jstate.disc_vars, True)
    replay = MaskReplay(
        jsim, 5, lambda stream, tag: disc_capture if stream == "dropout"
        else cnn_capture, client_kd_key(jsim))
    tsim = FedDTGSim(tgen, td, create_model(tcfg.model, "cpu"), tdata, tcfg,
                     "cpu", sampler=replay.sampler,
                     batch_orders=replay.batch_orders, draws=replay.draws)
    v = to_numpy(jstate)
    state = tsim.init()._replace(
        gen_vars=generator_state_dict(v.gen_vars),
        disc_vars=acgan_state_dict(v.disc_vars),
        cls_stack=vision_state_dict(v.cls_stack, "CNNDropOut", lead=1))

    def checks(state, v):
        close_vars(state.disc_vars, acgan_state_dict(v.disc_vars), ROUND,
                   "discriminator")

    jstate, state = check_rounds(jsim, jstate, tsim, state, "CNNDropOut",
                                 checks)
    jev, tev = jsim.evaluate_clients(jstate), tsim.evaluate_clients(state)
    np.testing.assert_allclose(tev["per_client_acc"], jev["per_client_acc"],
                               atol=1e-6)


def test_fedavg_cnn_bulk_matches_jax_and_stacked(data, cnn_capture):
    """FedAvg over cnn, 3 of 4 clients a round in blocks of 2 (the second
    block a live client and a sentinel id): two bulk rounds against the
    JAX package's bulk rounds, and against the port's stacked rounds on
    the same masks."""
    jdata, tdata = data

    def cfg(m, block):
        base = DI.tiny_cfg(m)
        return dataclasses.replace(base, fed=dataclasses.replace(
            base.fed, clients_per_round=3, client_block_size=block))

    jsim = jfed.FedAvgSim(jax_create_model(cfg(jc, 2).model), jdata,
                          cfg(jc, 2))
    assert jsim._bulk.enabled()
    replay = DI.Replay(jsim, cnn_capture, {"local": DI.replay_ckey(jsim)},
                       {"dropout": DI.replay_ckey(jsim)})
    host_ids = []

    def draws(stream, r, slots, shapes):
        host_ids.append(list(slots))
        return replay.draws(stream, r, slots, shapes)

    sims = [tfed.FedAvgSim(create_model(cfg(tc, block).model, "cpu"), tdata,
                           cfg(tc, block), "cpu", sampler=replay.sampler,
                           batch_orders=lambda r, c: replay.batch_orders(
                               r, c), draws=draws) for block in (2, 0)]
    jstate = jsim.init()
    start = sims[0].init()._replace(variables=DI.port_vars(
        jax.device_get(jstate.variables)))
    bulk, stacked = (DI.two_rounds(sim, start) for sim in sims)
    want = DI.two_rounds(jsim, jstate)
    assert sims[0].last_groups == [(2, sims[0].last_groups[0][1]),
                                   (2, sims[0].last_groups[1][1])]
    # the sentinel lane reads client 0 and draws its masks by that id
    assert any(len(ids) == 2 and 0 in ids for ids in host_ids[:2]), host_ids
    for (bs, bm), (ss, sm), (js, jm) in zip(bulk, stacked, want):
        close_vars(bs.variables, DI.port_vars(js.variables), ROUND, "bulk")
        close(bm["train_loss"], jm["train_loss"], ROUND, "train_loss")
        for k, v in ss.variables.items():
            np.testing.assert_allclose(bs.variables[k].numpy(), v.numpy(),
                                       **STACKED_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# faults C6 and C7
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fed", [dict(peft="lora"),
                                 dict(peft_personalize=True)])
def test_dropout_under_peft_raises_the_jax_value_error(data, fed):
    """C6: a dropout model under PEFT reaches the PEFT checks and raises
    the JAX package's ``ValueError``: personalization needs LoRA (word for
    word); LoRA needs the TransformerLM's projections (the same targets,
    the model's name and the advice; the JAX message names flax's
    ``Dense`` layers, the port's does not)."""
    jdata, tdata = data
    jcfg, tcfg = (dataclasses.replace(c, fed=dataclasses.replace(c.fed,
                                                                **fed))
                  for c in (DI.tiny_cfg(jc), DI.tiny_cfg(tc)))
    with pytest.raises(ValueError) as jerr:
        jfed.FedAvgSim(jax_create_model(jcfg.model), jdata, jcfg)
    with pytest.raises(ValueError) as terr:
        tfed.FedAvgSim(create_model(tcfg.model, "cpu"), tdata, tcfg, "cpu")
    if "peft" not in fed:
        assert str(terr.value) == str(jerr.value)
        return
    for part in ("peft='lora' targets the TransformerLM's named",
                 "'mlp_down']); CNNDropOut has no such contract",
                 "use --model transformer/transformer_lm"):
        assert part in str(jerr.value) and part in str(terr.value), part


def test_jax_config_json_loads():
    """C7: the JAX package's default config.json loads into the port's
    config, equal to its default, and the port writes it back key for
    key; so does a harness-style config with every section set."""
    blob = json.loads(jc.ExperimentConfig().to_json())
    cfg = tc.ExperimentConfig.from_dict(blob)
    assert cfg == tc.ExperimentConfig()
    assert json.loads(cfg.to_json()) == blob
    jcfg = DI.tiny_cfg(jc, "fedgdkd")
    blob = json.loads(jcfg.to_json())
    assert json.loads(tc.ExperimentConfig.from_dict(blob).to_json()) == blob


@pytest.mark.parametrize("path,value,item", [
    ("fed.shard_aggregation", True, "item 15"),
    ("fed.async_buffer_k", 4, "item 13b"),
    ("fed.staleness_fn", "const", "item 13b"),
    ("fed.staleness_alpha", 1.0, "item 13b"),
    ("mesh.client_axis_size", 2, "item 15"),
    ("mesh.data_axis_name", "batch", "item 15"),
])
def test_unported_config_fields_raise(data, path, value, item):
    """C7: a JAX config.json with a setting the port does not run yet
    loads, and FedAvg, the GAN family and the distillation family refuse
    it by name with ``NotImplementedError`` naming its ROADMAP item. The
    async settings (item 13b) are ported (core/async_agg.py): they load
    and every sim accepts them and, as the JAX simulators do, ignores
    them."""
    from fedml_tpu_torch.algorithms.distill import FDSim

    section, field = path.split(".")
    jcfg = DI.tiny_cfg(jc, "fedgdkd")
    jcfg = dataclasses.replace(jcfg, **{section: dataclasses.replace(
        getattr(jcfg, section), **{field: value})})
    cfg = tc.ExperimentConfig.from_dict(json.loads(jcfg.to_json()))
    assert getattr(getattr(cfg, section), field) == value
    tdata = data[1]
    model = create_model(cfg.model, "cpu")
    _, tgen = GF.gen_pair()
    for build in (lambda: tfed.FedAvgSim(model, tdata, cfg, "cpu"),
                  lambda: FedGDKDSim(tgen, model, tdata, cfg, "cpu"),
                  lambda: FDSim(model, tdata, cfg, "cpu")):
        if item == "item 13b":
            build()
            continue
        with pytest.raises(NotImplementedError,
                           match=rf"{section}.*ROADMAP: Queue A {item}\b"):
            build()
