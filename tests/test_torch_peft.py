"""The port's PEFT (fedml_tpu_torch/peft) against the JAX package's
(fedml_tpu/peft) at a tiny shape: 1 layer, 2 heads, embed 16, vocab 128
+ 4. Weights cross through the converter, and the JAX package's cohorts
and batch orders are replayed through the port's hooks.

What is held, in tiers: LoRALinear against LoRADense; round 0 computes
what the base model does, bit for bit, and injection leaves the base
draws as they were; the partition's split and merge, and its names
against the JAX package's paths; the adapter-only local update against
the JAX package's and against a masked full step; aggregated and
personalized rounds against the JAX package's, the frozen leaves bit
for bit at init and the private adapters never leaving their bank row;
the compositions (codec, bulk, fused blocks, elastic buckets, the
checkpoint composite); the refusals; the dataset; the wire bytes."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
from fedml_tpu import peft as JPF
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms.base import _padded_perm
from fedml_tpu.algorithms.base import build_local_update as jax_local_update
from fedml_tpu.algorithms.base import make_task as jax_make_task
from fedml_tpu.core import random as JR
from fedml_tpu.core.compress import CompressionSpec as JaxCompressionSpec
from fedml_tpu.core.compress import wire_ratio as jax_wire_ratio
from fedml_tpu.data.natural import (
    synthetic_stackoverflow_nwp as jax_stackoverflow,
)
from fedml_tpu.models import create_model as jax_create_model
import fedml_tpu_torch.config as tc
from fedml_tpu_torch import peft as PF
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.algorithms.base import build_local_update, make_task
from fedml_tpu_torch.convert import transformer_state_dict
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data.federated import arrays_and_batch
from fedml_tpu_torch.data.natural import synthetic_stackoverflow_nwp
from fedml_tpu_torch.experiments.harness import Experiment
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.peft import personal as PP
from fedml_tpu_torch.utils import checkpoint as CK
from tests.torch_threads import one_torch_thread  # noqa: F401

VOCAB = 128
EXTRA = (("embed_dim", 16), ("max_len", 32), ("num_heads", 2),
         ("num_layers", 1), ("vocab_size", VOCAB + 4))
# float32 training over several steps on both sides: sums reassociate and
# the differences compound step to step (tests/test_torch_fedavg.py)
TOL = dict(atol=1e-4, rtol=1e-4)
# two programs of the same arithmetic in one framework (a masked full
# step; the bulk engine's flat partials against the stacked mean)
TIGHT = dict(atol=1e-7, rtol=2e-5)


def _model_cfg(m, **extra):
    return m.ModelConfig(name="transformer_lm", num_classes=VOCAB + 4,
                         input_shape=(20,),
                         extra=tuple(sorted({**dict(EXTRA),
                                             **extra}.items())))


def _cfg(m, num_clients=8, cohort=4, train=None, **fed):
    fed.setdefault("eval_every", 10**9)
    fed.setdefault("peft", "lora")
    fed.setdefault("lora_rank", 2)
    fed.setdefault("lora_alpha", 4.0)
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="synthetic_stackoverflow_nwp",
                          num_clients=num_clients, batch_size=8, seed=0),
        model=_model_cfg(m), train=m.TrainConfig(**(train or dict(lr=0.1))),
        fed=m.FedConfig(num_rounds=4, clients_per_round=cohort, **fed),
        seed=0)


def _data(make, num_clients=8):
    # few sentences a client: max_n stays one or two batches
    return make(num_clients=num_clients, vocab_size=VOCAB, seed=0,
                sentences_low=4, sentences_high=8)


def _sim(cfg, **kw):
    return tfed.FedAvgSim(create_model(cfg.model, "cpu"),
                          _data(synthetic_stackoverflow_nwp,
                                cfg.data.num_clients), cfg, device="cpu",
                          **kw)


def _run(sim, rounds, state=None):
    state = sim.init() if state is None else state
    metrics = []
    for _ in range(rounds):
        state, m = sim.run_round(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _same(a: dict, b: dict, what=""):
    assert list(a) == list(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), \
            f"{what} {k}"


def _close(got: dict, want: dict, band=TOL, what=""):
    assert set(got) == set(want), (what, sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   **band, err_msg=f"{what} {k}")


def _port(tree) -> dict:
    """JAX params (a flax tree, leaves maybe with leading rows) to the
    port's names and layout."""
    return transformer_state_dict({"params": jax.device_get(tree)})


def _frozen(sim, state):
    return sim.peft.part.frozen(state.variables)


# ---------------------------------------------------------------------------
# injection and round 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
def test_lora_linear_matches_lora_dense(bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    dense = JPF.LoRADense(features=7, rank=3, alpha=6.0, use_bias=bias)
    params = jax.device_get(dense.init(jax.random.key(1), x)["params"])
    # a trained branch: lora_b away from its zero init
    params["lora_b"] = rng.standard_normal((3, 7)).astype(np.float32)
    if bias:
        params["bias"] = rng.standard_normal(7).astype(np.float32)
    want = np.asarray(dense.apply({"params": params}, x))
    lin = PF.LoRALinear(12, 7, bias, rank=3, alpha=6.0)
    state = {k.split(".", 1)[1]: v
             for k, v in _port({"p": params}).items()}
    assert set(state) == ({"weight", "lora_a", "lora_b", "bias"}
                          if bias else {"weight", "lora_a", "lora_b"})
    assert state["lora_a"].shape == (3, 12) and state["lora_b"].shape == (
        7, 3)
    got = torch.func.functional_call(lin, state, (torch.from_numpy(x),))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                               rtol=1e-6)


def test_round0_byte_identity_and_base_draws_unchanged():
    """Every target injected: each base leaf draws what the base model
    draws from the same generator, the adapters come after, and the
    forward is the base model's bit for bit (lora_b is zero)."""
    base = create_model(_model_cfg(tc), "cpu")
    lora = PF.apply_lora(base, PF.LoRASpec(rank=2, alpha=4.0,
                                           targets=PF.LORA_TARGETS))
    vb = base.init(torch.Generator().manual_seed(7))
    vl = lora.init(torch.Generator().manual_seed(7))
    _same(PF.private_partition().frozen(vl), vb, "base draws")
    adapters = PF.private_partition().trainable(vl)
    assert len(adapters) == 2 * len(PF.LORA_TARGETS)
    assert all(torch.all(v == 0) for k, v in adapters.items()
               if k.endswith("lora_b"))
    # the variables keep the module order, adapters beside their layer
    assert list(vl)[list(vl).index("blocks.0.q_proj.weight") + 1] == \
        "blocks.0.q_proj.lora_a"
    tokens = torch.randint(0, VOCAB + 4, (3, 20),
                           generator=torch.Generator().manual_seed(1))
    lb, ll = base.apply_eval(vb, tokens), lora.apply_eval(vl, tokens)
    assert torch.equal(lb.view(torch.int32), ll.view(torch.int32))
    # and the simulation's round-0 evaluation is the base model's
    cfg = _cfg(tc)
    base_cfg = dataclasses.replace(cfg, fed=dataclasses.replace(
        cfg.fed, peft="none"))
    assert _sim(cfg).evaluate_global(_sim(cfg).init()) == \
        _sim(base_cfg).evaluate_global(_sim(base_cfg).init())


def test_injection_targets_and_refusals():
    base = create_model(_model_cfg(tc), "cpu")
    for targets in (("q_proj",), PF.LORA_TARGETS):
        names = PF.apply_lora(base, PF.LoRASpec(targets=targets)).init(
            torch.Generator().manual_seed(0))
        for t in PF.LORA_TARGETS:
            assert (f"blocks.0.{t}.lora_a" in names) == (t in targets)
    # the head is never injected: LoRA's targets are the block's
    assert PF.adapter_partition().select("lm_head.weight")
    with pytest.raises(ValueError, match="lora_rank"):
        PF.LoRASpec(rank=0)
    with pytest.raises(ValueError, match="lora_alpha"):
        PF.LoRASpec(alpha=0.0)
    for bad in (("bogus",), ()):
        with pytest.raises(ValueError, match="lora_targets"):
            PF.LoRASpec(targets=bad)
    with pytest.raises(ValueError, match="peft"):
        PF.LoRASpec.from_fed(tc.FedConfig(peft="prefix_tuning"))
    assert PF.LoRASpec.from_fed(tc.FedConfig()) is None
    lr = create_model(tc.ModelConfig(name="lr", num_classes=10,
                                     input_shape=(28, 28, 1)), "cpu")
    with pytest.raises(ValueError, match="TransformerLM"):
        PF.apply_lora(lr, PF.LoRASpec())
    with pytest.raises(ValueError, match="transformer"):
        PF.check_model_supported("resnet56")


# ---------------------------------------------------------------------------
# the partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("personalized", [False, True])
def test_partition_names_match_jax_paths(personalized):
    """Split and merge are inverse, a collision raises, and each split
    selects the names the converter gives the JAX package's selected
    paths."""
    spec = dict(rank=2, alpha=4.0, targets=("q_proj", "v_proj", "mlp_up"))
    jlora = JPF.apply_lora(jax_create_model(_model_cfg(jc)),
                           JPF.LoRASpec(**spec))
    shapes = jax.eval_shape(jlora.init, jax.random.key(0))["params"]
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jplan = JPF.PeftPlan(part=JPF.adapter_partition(),
                         personalized=personalized)
    tlora = PF.apply_lora(create_model(_model_cfg(tc), "cpu"),
                          PF.LoRASpec(**spec))
    variables = tlora.init(torch.Generator().manual_seed(0))
    plan = PF.PeftPlan(part=PF.adapter_partition(),
                       personalized=personalized)
    assert set(variables) == set(_port(jparams))
    for tpart, jpart in ((plan.part, jplan.part),
                         (plan.agg_part, jplan.agg_part),
                         (plan.private, jplan.private)):
        tr, fr = tpart.trainable(variables), tpart.frozen(variables)
        assert set(tr) == set(_port(jpart.trainable(jparams)))
        assert set(fr) == set(_port(jpart.frozen(jparams)))
        merged = tpart.merge(tr, fr)
        assert merged.keys() == variables.keys()
        assert all(merged[k] is variables[k] for k in variables)
        assert sum(tpart.mask(variables).values()) == len(tr)
        with pytest.raises(ValueError, match="collision"):
            tpart.merge(tr, variables)
    assert plan.counts(variables) == tuple(
        sum(v.numel() for v in part.values())
        for part in (plan.part.trainable(variables),
                     plan.part.frozen(variables)))


# ---------------------------------------------------------------------------
# the adapter-only local update
# ---------------------------------------------------------------------------


def _local_rig(train):
    """The LoRA model of both packages, the arrays, and the JAX
    package's init as the port's variables."""
    spec = dict(rank=2, alpha=4.0, targets=("q_proj", "v_proj"))
    jmodel = JPF.apply_lora(jax_create_model(_model_cfg(jc)),
                            JPF.LoRASpec(**spec))
    tmodel = PF.apply_lora(create_model(_model_cfg(tc), "cpu"),
                           PF.LoRASpec(**spec))
    dcfg = tc.DataConfig(batch_size=8)
    jdata = _data(jax_stackoverflow)
    ja = jdata.to_arrays(pad_multiple=8)
    ta, bs = arrays_and_batch(_data(synthetic_stackoverflow_nwp), dcfg,
                              "cpu")
    variables = jax.jit(jmodel.init)(jax.random.key(0))
    # lora_b off zero, so the branch has a gradient into lora_a too
    b_key = jax.random.key(9)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (0.1 * jax.random.normal(b_key, v.shape)
                      if p[-1].key == "lora_b" else v), variables)
    return jmodel, tmodel, ja, ta, bs, variables, train


@pytest.mark.parametrize("train", [
    # momentum, weight decay, clip and FedProx (over the merged tree)
    dict(optimizer="sgd", lr=0.1, momentum=0.9, weight_decay=1e-3,
         clip_norm=1.0, prox_mu=0.1, epochs=2),
    dict(optimizer="adam", lr=1e-3, weight_decay=1e-2, epochs=1),
])
def test_adapter_only_local_update_matches_jax(train):
    jmodel, tmodel, ja, ta, bs, variables, train = _local_rig(train)
    max_n = ja.max_client_samples
    jlu = jax.jit(jax_local_update(
        jmodel, jax_make_task("nwp"), jc.TrainConfig(**train), bs, max_n,
        partition=JPF.adapter_partition()))
    tlu = build_local_update(tmodel, make_task("nwp"),
                             tc.TrainConfig(**train), bs, max_n,
                             partition=PF.adapter_partition())
    rng = jax.random.key(5)
    want, n_k, msums = jlu(variables, ja.idx[0], ja.mask[0], ja.x, ja.y, rng)
    orders = [torch.tensor(np.asarray(_padded_perm(
        jax.random.fold_in(rng, e), ja.mask[0], max_n)))
        for e in range(train["epochs"])]
    start = _port(variables["params"])
    got, t_n_k, t_sums = tlu(start, ta.idx[0], ta.mask[0], ta.x, ta.y,
                             orders=orders)
    # the client returns the trainable leaves only, in the band
    assert list(got) == list(PF.adapter_partition().trainable(start))
    _close(got, _port(want["params"]))
    assert float(t_n_k) == float(n_k)
    for k in msums:
        np.testing.assert_allclose(float(t_sums[k]), float(msums[k]), **TOL)


def test_adapter_only_update_is_a_masked_full_step():
    """Plain SGD: the partitioned update equals full-tree gradients with
    the frozen leaves' updates masked off, step by step."""
    _, tmodel, ja, ta, bs, variables, _ = _local_rig(None)
    max_n = ta.max_client_samples
    train = tc.TrainConfig(lr=0.1, epochs=1)
    part = PF.adapter_partition()
    task = make_task("nwp")
    tlu = build_local_update(tmodel, task, train, bs, max_n, partition=part)
    params = _port(variables["params"])
    order = torch.arange(max_n)  # the real samples come first already
    got, _, _ = tlu(params, ta.idx[0], ta.mask[0], ta.x, ta.y,
                    orders=[order])

    def loss(p, x_b, y_b, w_b):
        sums = task.metric_sums(tmodel.apply_eval(p, x_b), y_b, w_b)
        return sums["loss_sum"] / torch.clamp(sums["w_sum"], min=1.0)

    for s in range(max_n // bs):
        take = order[s * bs:(s + 1) * bs]
        b_idx, w_b = ta.idx[0][take].long(), ta.mask[0][take]
        if w_b.sum() == 0:
            continue
        grads = torch.func.grad(loss)(params, ta.x[b_idx], ta.y[b_idx], w_b)
        params = {k: v - 0.1 * grads[k] if part.select(k) else v
                  for k, v in params.items()}
    _close(got, part.trainable(params), TIGHT)


# ---------------------------------------------------------------------------
# rounds against the JAX package
# ---------------------------------------------------------------------------


def _pair(personalized=False, cohort=4, train=None, **fed):
    """A JAX sim and a port sim of one config, the port's draws replayed
    from the JAX package's and both starting from the JAX init."""
    jdata = _data(jax_stackoverflow)
    tdata = _data(synthetic_stackoverflow_nwp)
    jcfg = _cfg(jc, cohort=cohort, train=train,
                peft_personalize=personalized, **fed)
    tcfg = _cfg(tc, cohort=cohort, train=train,
                peft_personalize=personalized, **fed)
    jsim = jfed.FedAvgSim(jax_create_model(jcfg.model), jdata, jcfg)
    max_n = jsim.arrays.max_client_samples

    def sampler(r, n, k):
        key = jax.random.fold_in(JR.round_key(jsim.root_key, r), 0)
        return torch.tensor(np.asarray(JR.sample_clients(key, n, k)))

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.tensor(np.asarray(_padded_perm(
            jax.random.fold_in(ckey, e), jsim.arrays.mask[c], max_n)))
            for e in range(tcfg.train.epochs)]

    tsim = tfed.FedAvgSim(create_model(tcfg.model, "cpu"), tdata, tcfg,
                          device="cpu", sampler=sampler,
                          batch_orders=batch_orders)
    # FedAvgSim.init's state, the model's init jitted (op by op, flax's
    # init costs seconds on one core)
    variables = jax.jit(jsim.model.init)(
        jax.random.fold_in(jsim.root_key, 0x7FFFFFFF))
    agg = jsim._peft.agg_part.trainable(variables["params"])
    jstate = jfed.ServerState(
        variables, jfed.make_server_optimizer("sgd", 1.0, 0.0).init(agg),
        jax.tree.map(jnp.zeros_like, agg), jnp.asarray(0, jnp.int32))
    tstate = tsim.init()._replace(variables=_port(variables["params"]))
    return jsim, jstate, tsim, tstate, sampler


def test_two_aggregated_rounds_match_jax():
    jsim, jstate, tsim, tstate, _ = _pair()
    frozen0 = _frozen(tsim, tstate)
    for _ in range(2):
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        for k in ("train_loss", "train_acc"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    want = _port(jstate.variables["params"])
    agg = tsim.peft.agg_part
    _close(agg.trainable(tstate.variables), agg.trainable(want),
           what="trainable")
    # the frozen leaves are the init's tensors, untouched
    frozen = _frozen(tsim, tstate)
    assert all(frozen[k] is frozen0[k] for k in frozen0)
    # the server's optimizer state and momentum: the trainable names only
    assert list(tstate.momentum) == list(agg.trainable(tstate.variables))
    jev, tev = jsim.evaluate_global(jstate), tsim.evaluate_global(tstate)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(tev[k], jev[k], **TOL)


@pytest.mark.parametrize("train", [
    None,
    # FedProx pulls each client's adapters toward its own bank row
    dict(lr=0.1, momentum=0.5, prox_mu=0.1, epochs=2),
])
def test_two_personalized_rounds_match_jax_and_do_not_leak(train):
    jsim, jstate, tsim, tstate, sampler = _pair(personalized=True, cohort=3,
                                                train=train)
    plan = tsim.peft
    assert tsim.adapter_bank is None  # made at the first round
    server_adapters = plan.private.trainable(tstate.variables)
    frozen0 = _frozen(tsim, tstate)
    bank = PP.init_bank(plan, tstate.variables, 8)
    sampled = set()
    for r in range(2):
        before = bank
        jstate, jm = jsim.run_round(jstate)
        tstate, tm = tsim.run_round(tstate)
        np.testing.assert_allclose(float(tm["train_loss"]),
                                   float(jm["train_loss"]), **TOL)
        bank = {k: v.clone() for k, v in tsim.adapter_bank.rows.items()}
        cohort = set(sampler(r, 8, 3).tolist())
        sampled |= cohort
        for c in range(8):
            same = all(torch.equal(before[k][c], bank[k][c]) for k in bank)
            assert same == (c not in cohort), (r, c)
    # the shared head and every bank row in the band of the JAX package's
    want = _port(jstate.variables["params"])
    _close(plan.agg_part.trainable(tstate.variables),
           plan.agg_part.trainable(want), what="head")
    _close(bank, _port(jsim._adapter_bank), what="bank")
    # no leak: the server's adapters and the frozen base are at init
    _same(plan.private.trainable(tstate.variables), server_adapters,
          "server adapters")
    _same(_frozen(tsim, tstate), frozen0, "frozen base")
    a, b = sorted(sampled)[:2]
    assert any(not torch.equal(v[a], v[b]) for v in bank.values())
    # a client's own model, with its row, is not the global one
    mine = PP.personal_variables(plan, tstate.variables, bank, a)
    assert list(mine) == list(tstate.variables)
    assert any(not torch.equal(mine[k], tstate.variables[k])
               for k in bank)
    assert "adapter" in tsim.bank_state()


# ---------------------------------------------------------------------------
# compositions (the port against itself)
# ---------------------------------------------------------------------------


def test_codec_residual_is_adapter_sized():
    sim = _sim(_cfg(tc, compress="topk_int8", compress_topk_frac=0.25))
    state = sim.init()
    frozen0 = _frozen(sim, state)
    state, metrics = _run(sim, 3, state)
    assert all(np.isfinite(m["train_loss"]) for m in metrics)
    _same(_frozen(sim, state), frozen0, "frozen base under the codec")
    agg = sim.peft.agg_part.trainable(state.variables)
    assert list(sim.ef_residual) == list(agg)
    for k, r in sim.ef_residual.items():
        assert r.shape == (4,) + agg[k].shape
    # the codec's ratio is over the adapters and the head
    assert sim.counters["peft.wire_ratio"] > sim.counters[
        "compress.ratio"] > 1.0


@pytest.mark.parametrize("personalized", [False, True])
def test_bulk_matches_stacked(personalized):
    ref_sim = _sim(_cfg(tc, peft_personalize=personalized))
    ref, m_ref = _run(ref_sim, 2)
    sim = _sim(_cfg(tc, peft_personalize=personalized, client_block_size=3))
    state = sim.init()
    frozen0 = _frozen(sim, state)
    state, m_bulk = _run(sim, 2, state)
    _close(state.variables, ref.variables, TIGHT)
    for a, b in zip(m_ref, m_bulk):
        assert b["train_loss"] == pytest.approx(a["train_loss"], rel=2e-5)
    _same(_frozen(sim, state), frozen0, "frozen base under bulk")
    if personalized:
        # 4 clients in 2 blocks of 3 a round: the padded slot writes no row
        _close(sim.adapter_bank.rows, ref_sim.adapter_bank.rows, TIGHT)
        assert sim.counters["bank.scatters"] == 4


@pytest.mark.parametrize("personalized", [False, True])
def test_fused_blocks_equal_per_round(personalized):
    cfg = _cfg(tc, peft_personalize=personalized, fuse_rounds=2)
    ref_sim = _sim(cfg)
    ref, m_ref = _run(ref_sim, 4)
    sim = _sim(cfg)
    state = sim.init()
    losses = []
    for _ in range(2):
        state, m = sim.run_block(state, 2)
        losses += m["train_loss"].tolist()
    _same(state.variables, ref.variables, "fused")
    assert losses == [m["train_loss"] for m in m_ref]
    if personalized:
        _same(sim.adapter_bank.rows, ref_sim.adapter_bank.rows, "bank")


@pytest.mark.parametrize("personalized", [False, True])
def test_elastic_churn_is_cache_hits(personalized):
    sim = _sim(_cfg(tc, peft_personalize=personalized, elastic_buckets=True))
    state = sim.init()
    frozen0 = _frozen(sim, state)
    state, _ = sim.run_round(state)
    for n in (2, 3, 4):
        before = ({k: v.clone() for k, v in sim.adapter_bank.rows.items()}
                  if personalized else None)
        sim.set_cohort_size(n)
        state, m = sim.run_round(state)
        assert np.isfinite(float(m["train_loss"]))
        if personalized:
            # the dead slots' clients keep their rows
            dead = sim._slot_ids(state.round - 1, 4)[n:]
            for c in dead.tolist():
                assert all(torch.equal(before[k][c],
                                       sim.adapter_bank.rows[k][c])
                           for k in before)
    assert sim.counters["elastic.compile_cache_misses"] == 1
    assert sim.counters["elastic.compile_cache_hits"] == 3
    _same(_frozen(sim, state), frozen0, "frozen base under churn")


def test_checkpoint_composite_restores_the_adapter_bank(tmp_path):
    cfg = _cfg(tc, peft_personalize=True, client_block_size=2)
    sim = _sim(cfg)
    state, _ = _run(sim, 2)
    assert set(sim.bank_state()) == {"adapter"}
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"))
    Experiment._save_state(ckpt, sim, 1, state)
    raw, _ = ckpt.restore_raw()
    assert set(raw) == {"server", "bank"}
    fresh = _sim(cfg)
    restored, nxt = Experiment._restore_state(ckpt, fresh, fresh.init())
    assert nxt == 2
    _same(restored.variables, state.variables, "state")
    _same(fresh.adapter_bank.rows, sim.adapter_bank.rows, "bank")
    for _ in range(2):
        state, _ = sim.run_round(state)
        restored, _ = fresh.run_round(restored)
    _same(restored.variables, state.variables, "resumed state")
    _same(fresh.adapter_bank.rows, sim.adapter_bank.rows, "resumed bank")


def test_bank_helpers_match_jax():
    """init_bank, gather_rows, scatter_rows, bank_bytes and
    personal_variables against the JAX package's on one converted tree."""
    from fedml_tpu.peft import personal as JPP

    spec = dict(rank=2, alpha=4.0, targets=("q_proj", "v_proj"))
    jmodel = JPF.apply_lora(jax_create_model(_model_cfg(jc)),
                            JPF.LoRASpec(**spec))
    jparams = jax.jit(jmodel.init)(jax.random.key(0))["params"]
    jplan = JPF.PeftPlan(part=JPF.adapter_partition(), personalized=True)
    plan = PF.PeftPlan(part=PF.adapter_partition(), personalized=True)
    variables = _port(jparams)
    bank = PP.init_bank(plan, variables, 5)
    jbank = JPP.init_bank(jplan, jparams, 5)
    _same(bank, _port(jbank), "init_bank")
    assert PP.bank_bytes(bank) == JPP.bank_bytes(jbank)
    rows = {k: v + 1.0 for k, v in PP.gather_rows(
        bank, torch.tensor([3, 1])).items()}
    jrows = jax.tree.map(lambda v: v + 1.0,
                         JPP.gather_rows(jbank, jnp.asarray([3, 1])))
    _same(rows, _port(jrows), "gather_rows")
    bank = PP.scatter_rows(bank, torch.tensor([3, 1]), rows)
    jbank = JPP.scatter_rows(jbank, jnp.asarray([3, 1]), jrows)
    _same(bank, _port(jbank), "scatter_rows")
    mine = PP.personal_variables(plan, variables, bank, 3)
    want = _port(JPP.personal_variables(jplan, {"params": jparams}, jbank,
                                        3)["params"])
    assert list(mine) == list(variables)
    _same({k: mine[k] for k in want}, want, "personal_variables")


def test_bank_survives_an_init_snapshot():
    sim = _sim(_cfg(tc, cohort=3, peft_personalize=True))
    _run(sim, 1)
    trained = {k: v.clone() for k, v in sim.adapter_bank.rows.items()}
    sim.init()
    _same(sim.adapter_bank.rows, trained, "bank after init()")


# ---------------------------------------------------------------------------
# refusals, the CLI and the config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fed,err", [
    (dict(peft_personalize=True, compress="int8"), "compress"),
    (dict(peft_personalize=True, robust_method="krum"), "robust_method"),
    (dict(peft="none", peft_personalize=True), "peft_personalize"),
    (dict(peft="prefix"), "peft must be"),
])
def test_rejection_table(fed, err):
    with pytest.raises(ValueError, match=err):
        _sim(_cfg(tc, **fed))


def test_personalize_with_adversary_and_non_transformer_raise():
    cfg = dataclasses.replace(
        _cfg(tc, peft_personalize=True),
        adversary=tc.AdversaryPolicy(mode="sign_flip", ranks=(0,)))
    with pytest.raises(ValueError, match="adversary"):
        _sim(cfg)
    lr = tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", num_clients=4,
                           batch_size=8),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        fed=tc.FedConfig(clients_per_round=2, peft="lora"))
    with pytest.raises(ValueError, match="TransformerLM"):
        tfed.FedAvgSim(create_model(lr.model, "cpu"), load_dataset(lr.data),
                       lr, device="cpu")


def test_parse_time_rejections(capsys):
    from fedml_tpu_torch.experiments.run import parse_args

    base = ["--algorithm", "fedavg", "--dataset",
            "synthetic_stackoverflow_nwp", "--model", "transformer_lm"]
    for bad in (["--peft", "lora", "--lora_rank", "0"],
                ["--peft", "lora", "--lora_targets", "nope"],
                ["--algorithm", "fedmd", "--peft", "lora"],
                ["--model", "lr", "--peft", "lora"],
                ["--peft", "lora", "--peft_personalize", "--compress",
                 "int8"],
                ["--peft_personalize"]):
        with pytest.raises(SystemExit):
            parse_args(base + bad)
    cfg, _ = parse_args(base + ["--peft", "lora", "--lora_rank", "8",
                                "--lora_targets", "q_proj", "mlp_up",
                                "--peft_personalize", "--elastic",
                                "--checkpoint_every", "5"])
    assert cfg.fed.peft == "lora" and cfg.fed.lora_rank == 8
    assert cfg.fed.lora_targets == ("q_proj", "mlp_up")
    assert cfg.fed.peft_personalize and cfg.checkpoint_every == 5
    capsys.readouterr()
    parse_args(base + ["--lora_rank", "8"])
    assert "inert without peft='lora'" in capsys.readouterr().err


def test_config_json_roundtrip():
    cfg = _cfg(tc, lora_targets=("q_proj", "mlp_down"),
               peft_personalize=True)
    back = tc.ExperimentConfig.from_dict(json.loads(cfg.to_json()))
    assert back == cfg and isinstance(back.fed.lora_targets, tuple)
    # the JAX package reads the port's file
    jback = jc.ExperimentConfig.from_dict(json.loads(cfg.to_json()))
    assert jback.fed.lora_targets == ("q_proj", "mlp_down")
    assert (jback.fed.lora_rank, jback.fed.lora_alpha) == (2, 4.0)
    defaults = tc.FedConfig()
    jdefaults = jc.FedConfig()
    for name in ("peft", "lora_rank", "lora_alpha", "lora_targets",
                 "peft_personalize"):
        assert getattr(defaults, name) == getattr(jdefaults, name)


@pytest.mark.parametrize("personalize", [False, True])
def test_cli_runs_lora(tmp_path, capsys, personalize):
    from fedml_tpu_torch.experiments.run import main

    args = ["--algorithm", "fedavg", "--dataset",
            "synthetic_stackoverflow_nwp", "--model", "transformer_lm",
            "--num_classes", "10004", "--input_shape", "20",
            "--client_num_in_total", "4", "--client_num_per_round", "2",
            "--comm_round", "1", "--batch_size", "8", "--peft", "lora",
            "--out_dir", str(tmp_path), "--device", "cpu"]
    assert main(args + (["--peft_personalize"] if personalize else [])) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(summary["test_loss"])
    written = json.loads((tmp_path / "run_rep0" / "config.json").read_text())
    assert written["fed"]["peft"] == "lora"
    assert written["fed"]["peft_personalize"] == personalize


# ---------------------------------------------------------------------------
# the dataset, the wire bytes and the kernel's head dim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(num_clients=6, vocab_size=500, seed=3),
                                dict(num_clients=4, seed=1)])
def test_synthetic_stackoverflow_matches_jax_bitwise(kw):
    got, want = synthetic_stackoverflow_nwp(**kw), jax_stackoverflow(**kw)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("train_idx_map", "test_idx_map"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[c], b[c]) for c in a)
    assert (got.num_classes, got.task) == (want.num_classes, want.task)
    # the loader's name dispatches to it, with the 10,000-word vocabulary
    loaded = load_dataset(tc.DataConfig(dataset="synthetic_stackoverflow_nwp",
                                        num_clients=4, seed=1))
    assert loaded.num_classes == 10004
    np.testing.assert_array_equal(
        loaded.x_train, jax_stackoverflow(num_clients=4, seed=1).x_train)


def test_wire_bytes_and_compound_ratio_equal_jax():
    """The bench's LoRA shape (embed 64, 2 layers, vocab 2004, rank 8 on
    q and v): the port's analytic wire records equal the JAX package's
    arithmetic on the JAX package's tree."""
    from chip_smoke import lora_wire_records

    extra = dict(vocab_size=2004, embed_dim=64, num_layers=2, num_heads=4)
    spec = dict(rank=8, alpha=16.0, targets=("q_proj", "v_proj"))
    jlora = JPF.apply_lora(jax_create_model(_model_cfg(jc, **extra)),
                           JPF.LoRASpec(**spec))
    shapes = jax.eval_shape(jlora.init, jax.random.key(0))["params"]
    jparams = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    jplan = JPF.PeftPlan(part=JPF.adapter_partition())
    jcspec = JaxCompressionSpec(method="topk_int8", topk_frac=0.01)
    full_mb = jplan.full_wire_bytes(jparams) / 1e6
    lora_mb = (jplan.adapter_wire_bytes(jparams) / jax_wire_ratio(
        jcspec, jplan.agg_part.trainable(jparams))) / 1e6
    want = {
        "wire_mb_per_round_16c_transformer_full": round(16 * full_mb, 4),
        "wire_mb_per_round_16c_transformer_lora": round(16 * lora_mb, 4),
        "lora_wire_reduction_x": round(
            JPF.compound_wire_ratio(jplan, jcspec, jparams), 1),
    }
    tmodel = PF.apply_lora(create_model(_model_cfg(tc, **extra), "cpu"),
                           PF.LoRASpec(**spec))
    variables = tmodel.init(torch.Generator().manual_seed(0))
    plan = PF.PeftPlan(part=PF.adapter_partition())
    got = {r["metric"]: r["value"]
           for r in lora_wire_records(plan, variables)}
    assert got == want
    assert got["lora_wire_reduction_x"] >= 100.0
    assert plan.full_wire_bytes(variables) == jplan.full_wire_bytes(jparams)
    assert plan.adapter_wire_bytes(variables) == jplan.adapter_wire_bytes(
        jparams)
    assert PF.compound_wire_ratio(plan, None, variables) == \
        JPF.compound_wire_ratio(jplan, None, jparams)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_flash_head_dim_16_matches_jax_kernel(causal):
    """The LoRA path's heads (D = 16): the kernel's plain version against
    the Pallas kernel in interpret mode, T = 20 in one ragged block."""
    from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
    from fedml_tpu_torch.ops.flash_attention import flash_attention_reference

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((3, 20, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                causal=causal, block_q=20, block_k=20,
                                interpret=True))
    got = flash_attention_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
