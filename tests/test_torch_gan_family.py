"""The rest of the GAN family in the port against the JAX package: the
ACGAN discriminator's forwards, the acgan losses and gradient reversal,
the acgan cohort update and its padding step, and two rounds each of
FedGAN, FedDTG, FedSSGAN and FedUAGAN; the CLI's resume of FedDTG and
FedUAGAN bit for bit.

The JAX discriminator runs at dropout 0.25, as in production. Its masks
are replayed into the port: each call's dropout key is derived as the
JAX package derives it, and the discriminator is run under
``flax.linen.intercept_methods`` with an interceptor that draws each
``nn.Dropout``'s key by ``make_rng("dropout")`` (the draw flax makes
itself), records ``bernoulli(key, 1 - rate, shape)`` and calls on with
that key: the masks flax applies, since a mask depends only on its key
and shape. Weights cross with ``fedml_tpu_torch/convert.py``."""

import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import gan_core as JG
from fedml_tpu.algorithms import gan_family as JF
from fedml_tpu.algorithms import sgan as JS
from fedml_tpu.core import random as JR
from fedml_tpu.data.loaders import make_fake_image_dataset as jax_fake_images
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models import gan as jgan
from fedml_tpu_torch.algorithms import gan_core as TG
from fedml_tpu_torch.algorithms.base import lane_batches
from fedml_tpu_torch.algorithms.gan_family import (
    FedDTGSim,
    FedGANSim,
    reverse_grad,
)
from fedml_tpu_torch.algorithms.sgan import FedSSGANSim, FedUAGANSim
from fedml_tpu_torch.convert import (
    acgan_state_dict,
    generator_state_dict,
    vision_state_dict,
)
from fedml_tpu_torch.data.federated import arrays_and_batch
from fedml_tpu_torch.data.loaders import make_fake_image_dataset
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.gan import (
    acgan_discriminator,
    generator_from_config,
)
from tests.test_torch_gan import (
    close,
    close_vars,
    flat,
    lane_orders,
    synth_noise,
    to_numpy,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)  # float32 forwards
MATH = dict(rtol=1e-6, atol=1e-6)
# the JAX package's own band between its fused and vmapped GAN updates
ROUND = dict(rtol=1e-4, atol=1e-5)
NZ, NGF, B, K = 16, 8, 8, 10
SHAPE = (28, 28, 1)
FEATURES = (8, 16)  # the JAX package's own GAN tests' discriminator
ALGOS = ("fedgan", "feddtg", "fedssgan", "feduagan")
# FedSSGAN's generator adam runs at a small lr: at GanConfig's 1e-3 one
# element of 12,544 in round 1's pyramid.l1.weight lands 5.5e-5 off the
# JAX package (band use 1.26) while every other leaf stays within 0.0072
# of the band; with sgd, or adam at 1e-5, the worst leaf uses 0.0019 of
# it. Adam's first step is lr * g / (|g| + eps): a near-zero gradient's
# rounding moves it by up to lr (the repo's adam parity tests run at a
# small lr for that reason)
GEN_LR = {"fedssgan": 1e-5}


def tiny_cfg(m, algo="fedgan", **train):
    """4 clients of uneven size (hetero), 2 a round, cnn_small as FedDTG's
    classifier, the JAX side on its vmapped path."""
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=4,
                          partition_method="hetero", partition_alpha=0.3,
                          batch_size=B, seed=0),
        model=m.ModelConfig(name="cnn_small", num_classes=K,
                            input_shape=SHAPE),
        train=m.TrainConfig(lr=0.05, cohort_fused=False,
                            **{"epochs": 1, **train}),
        fed=m.FedConfig(algorithm=algo, num_rounds=2, clients_per_round=2,
                        eval_every=1),
        gan=m.GanConfig(nz=NZ, ngf=NGF, distillation_size=16, kd_epochs=1,
                        gen_lr=GEN_LR.get(algo, 1e-3)),
        seed=1)


def jax_disc(validity=True):
    return JG.DiscHandle(
        module=jgan.ACGANDiscriminator(num_classes=K, features=FEATURES),
        has_validity_head=validity)


def disc_flax_vars(module, validity):
    """Random flax variables of the discriminator from numpy, as
    ``tests/test_torch_gan.py`` ``flax_vars`` makes them (no compile)."""
    extra = {"discriminator": True} if validity else {}
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.key(0), jnp.zeros((1,) + SHAPE), train=False, **extra))
    rng = np.random.default_rng(0)

    def leaf(k, shape):
        if k == "var":
            return rng.uniform(0.5, 1.5, shape)
        std = np.prod(shape[:-1]) ** -0.5 if k == "kernel" else 0.3
        return std * rng.standard_normal(shape)

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict)
                else leaf(k, v.shape).astype(np.float32)
                for k, v in tree.items()}

    return fill({k: dict(v) for k, v in shapes.items()})


def port_disc(validity=True):
    return acgan_discriminator(K, SHAPE, FEATURES,
                               validity_head=validity, device="cpu")


# ---------------------------------------------------------------------------
# the JAX package's dropout masks
# ---------------------------------------------------------------------------


def mask_capture(module, variables, validity, batch=B):
    """``masks(keys [n]) -> [site masks [n, batch, H, W, C]]``: the masks
    of one train-mode call of the flax discriminator per key (a key is
    the call's ``rngs={"dropout": key}``), jitted and vmapped."""
    extra = {"discriminator": True} if validity else {}

    def one(rng):
        recorded = []

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if (isinstance(mod, nn.Dropout) and context.method_name
                    == "__call__" and not mod.deterministic):
                key = mod.make_rng("dropout")
                recorded.append(jax.random.bernoulli(key, 1.0 - mod.rate,
                                                     args[0].shape))
                return next_fun(*args, rng=key, **kwargs)
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(interceptor):
            module.apply(variables, jnp.zeros((batch,) + SHAPE), train=True,
                         rngs={"dropout": rng}, mutable=["batch_stats"],
                         **extra)
        return recorded

    return jax.jit(jax.vmap(one))


def to_port_masks(site_masks, lead):
    """JAX site masks ``[prod(lead) * ..., B, H, W, C]`` to the port's
    ``{d<i>: [*lead, B, H, W, C]}`` bool tensors."""
    return {f"d{i}": torch.tensor(np.asarray(m).reshape(
        tuple(lead) + m.shape[1:])) for i, m in enumerate(site_masks)}


@jax.jit
def _step_keys(ckey, es, ss):
    """Epoch e, step s of a client: fold_in(fold_in(ckey, e), s)."""
    return jax.vmap(lambda e: jax.vmap(lambda s: jax.random.fold_in(
        jax.random.fold_in(ckey, e), s))(ss))(es)


def step_draws(ckey, epochs, steps, n_split):
    """A client's noise, fake labels and three dropout keys a step (G's
    call, then the D step's two, from the split of the fourth key), as
    ``build_gan_local_update`` (``n_split`` 4) and FedDTG's update (5)
    derive them."""
    skeys = _step_keys(ckey, jnp.arange(epochs), jnp.arange(steps))
    return _split_draws(skeys.reshape(-1), n_split)


@jax.jit
def _split4(skeys):
    return _split_any(skeys, 4)


@jax.jit
def _split5(skeys):
    return _split_any(skeys, 5)


def _split_any(skeys, n):
    def one(k):
        ks = jax.random.split(k, n)
        d1, d2 = jax.random.split(ks[3])
        return (jax.random.normal(ks[0], (B, NZ)),
                jax.random.randint(ks[1], (B,), 0, K),
                jnp.stack([ks[2], d1, d2]))

    return jax.vmap(one)(skeys)


def _split_draws(skeys, n_split):
    return (_split4 if n_split == 4 else _split5)(skeys)


class Replay:
    """The port's hooks, replaying a JAX sim's cohorts, batch orders and
    draws, the dropout masks included (FedGAN, FedSSGAN and FedDTG)."""

    def __init__(self, jsim, n_split, capture):
        self.jsim, self.n_split, self.capture = jsim, n_split, capture
        self.epochs = jsim.cfg.train.epochs
        self.max_n = jsim.arrays.max_client_samples

    def rkey(self, r):
        return JR.round_key(self.jsim.root_key, r)

    def sampler(self, r, n, k):
        return torch.tensor(np.asarray(JR.sample_clients(
            jax.random.fold_in(self.rkey(r), 0), n, k)))

    def batch_orders(self, r, c):
        return list(torch.tensor(lane_orders(
            JR.client_key(self.rkey(r), c), self.jsim.arrays.mask[c],
            self.epochs, self.max_n)))

    def client(self, r, c, epochs, steps):
        return step_draws(JR.client_key(self.rkey(r), c), epochs, steps,
                          self.n_split)

    def draws(self, stream, r, slots, shapes):
        if stream == "synth":
            (n_batches, _, _), = shapes.values()
            return {"z": torch.tensor(synth_noise(self.rkey(r),
                                                  n_batches))[None]}
        lead = next(iter(shapes.values()))[:2]
        drawn = [self.client(r, c, *lead) for c in slots]
        if stream == "dropout":
            keys = jnp.stack([d[2] for d in drawn]).reshape(-1)
            return to_port_masks(self.capture(keys),
                                 (len(slots), *lead, 3))
        which = 0 if stream == "gan_z" else 1
        name, = shapes
        return {name: torch.tensor(np.stack([
            np.asarray(d[which]).reshape(lead + d[which].shape[1:])
            for d in drawn]))}


class UAReplay:
    """FedUAGAN's hooks: each client's step subsets, the round's two
    batches of noise and labels, and each step's two dropout keys
    (``split(fold_in(ckey, 1000 + s))``: real, then fakes)."""

    def __init__(self, jsim, capture):
        self.jsim, self.capture = jsim, capture
        self.max_n = jsim.arrays.max_client_samples

    def rkey(self, r):
        return JR.round_key(self.jsim.root_key, r)

    def batch_orders(self, r, c):
        ck = JR.client_key(self.rkey(r), c)
        return torch.tensor(np.stack([np.asarray(jax.random.permutation(
            jax.random.fold_in(ck, s), self.max_n))[:B]
            for s in range(self.max_n // B)]))

    def draws(self, stream, r, slots, shapes):
        rk = self.rkey(r)
        gen = self.jsim.gen
        if stream == "gan_z":
            return {"z": torch.tensor(np.stack([np.asarray(
                gen.sample_noise(jax.random.fold_in(rk, i), B))
                for i in (1, 3)]))[None]}
        if stream == "gan_labels":
            return {"labels": torch.tensor(np.stack([np.asarray(
                gen.sample_labels(jax.random.fold_in(rk, i), B))
                for i in (2, 4)]))[None]}
        assert stream == "dropout", stream
        steps = next(iter(shapes.values()))[0]
        keys = jnp.stack([jnp.stack(jax.random.split(jax.random.fold_in(
            JR.client_key(rk, c), 1000 + s))) for c in slots
            for s in range(steps)]).reshape(-1)
        return to_port_masks(self.capture(keys), (len(slots), steps, 2))


# ---------------------------------------------------------------------------
# forwards and math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("validity", [True, False],
                         ids=["validity_head", "no_head"])
def test_acgan_discriminator_matches_flax(validity):
    """Eval mode (running statistics, no dropout) and train mode (the JAX
    package's masks replayed; the batch statistics of the dropped
    activations at momentum 0.99), with and without the validity head;
    the default widths at 28x28 have dropout sites of 11,456 values."""
    module = jgan.ACGANDiscriminator(num_classes=K, features=FEATURES)
    extra = {"discriminator": True} if validity else {}
    variables = disc_flax_vars(module, validity)
    disc = port_disc(validity)
    ours = acgan_state_dict(variables)
    assert set(ours) == set(disc.init(torch.Generator().manual_seed(0)))
    assert ("disc_out.weight" in ours) == validity
    x = np.random.default_rng(1).standard_normal((6,) + SHAPE)
    x = x.astype(np.float32)
    tx = torch.tensor(x)
    want = module.apply(variables, x, train=False, **extra)
    got = disc.apply_eval(ours, tx, validity=validity)
    for g, w in zip(*(o if validity else (o,) for o in (got, want))):
        close(g, w, FWD)
    rng = jax.random.key(7)
    want, mutated = module.apply(variables, x, train=True,
                                 rngs={"dropout": rng},
                                 mutable=["batch_stats"], **extra)
    masks = to_port_masks(mask_capture(module, variables, validity, 6)(
        rng[None]), (1,))
    masks = {k: v[0] for k, v in masks.items()}
    assert 0.6 < np.mean([m.float().mean() for m in masks.values()]) < 0.9
    got, new_vars = disc.apply_train(ours, tx, masks, validity=validity)
    for g, w in zip(*(o if validity else (o,) for o in (got, want))):
        close(g, w, FWD)
    stats = acgan_state_dict({"batch_stats": to_numpy(mutated)[
        "batch_stats"]})
    close_vars({k: new_vars[k] for k in stats}, stats, FWD, "statistics")
    full = acgan_discriminator(K, device="cpu").module
    assert sum(np.prod(s) for s in full.mask_shapes().values()) == 11456


def test_acgan_losses_and_reverse_grad_match_jax():
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((8, K)).astype(np.float32) * 3
            for _ in range(2))
    va, vb = (rng.standard_normal((8, 1)).astype(np.float32) * 3
              for _ in range(2))
    la, lb = (rng.integers(0, K, 8).astype(np.int32) for _ in range(2))
    w = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.float32)
    lab = np.array([1, 0, 1, 1, 0, 0, 1, 1], np.float32) * w
    T = torch.tensor
    for target in (0.0, 0.9, 1.0):
        close(TG.bce_logits(T(va), target, T(w)),
              JG._bce_logits(va, jnp.full(8, target), w), MATH)
    close(TG.generator_loss_acgan(T(a), T(va), T(la), T(w)),
          JG.generator_loss_acgan(a, va, la, w), MATH)
    close(TG.discriminator_loss_acgan(T(a), T(va), T(la), T(b), T(vb),
                                      T(lb), T(w)),
          JG.discriminator_loss_acgan(a, va, la, b, vb, lb, w), MATH)
    # FedSSGAN's D loss: the real CE over the labelled rows only
    logz_f = jax.nn.logsumexp(a, -1)
    logz_r = jax.nn.logsumexp(b, -1)
    want = 0.5 * (JG._ce(a, la, w) + JG._masked_mean(
        jax.nn.softplus(logz_f), w)) + 0.5 * (JG._ce(b, lb, lab)
                                              + JG._masked_mean(
        -logz_r + jax.nn.softplus(logz_r), w))
    close(TG.discriminator_loss_ssgan(T(a), T(la), T(b), T(lb), T(w),
                                      T(lab)), want, MATH)
    # reverse_grad: the identity forward, the gradient negated, under
    # grad inside vmap, as the JAX package's custom_vjp
    x = rng.standard_normal((3, 5)).astype(np.float32)
    c = rng.standard_normal(5).astype(np.float32)
    close(reverse_grad(T(x)), x, MATH)

    def t_loss(row):
        return torch.sum(torch.sin(reverse_grad(row * 2.0)) * T(c))

    def j_loss(row):
        return jnp.sum(jnp.sin(JF.reverse_grad(row * 2.0)) * c)

    got = torch.func.vmap(torch.func.grad(t_loss))(T(x))
    want = jax.vmap(jax.grad(j_loss))(x)
    close(got, want, MATH)
    plain = jax.vmap(jax.grad(lambda r: jnp.sum(jnp.sin(r * 2.0) * c)))(x)
    close(got, -plain, MATH)


# ---------------------------------------------------------------------------
# the acgan cohort update
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    jcfg, tcfg = tiny_cfg(jc), tiny_cfg(tc)
    jdata = jax_fake_images("mnist", jcfg.data, n_train=96, n_test=32)
    tdata = make_fake_image_dataset("mnist", tcfg.data, n_train=96,
                                    n_test=32)
    np.testing.assert_array_equal(jdata.x_train, tdata.x_train)
    return jdata, tdata


def gen_pair():
    cfg = tc.GanConfig(nz=NZ, ngf=NGF)
    return (jgan.generator_from_config(cfg, K, 28, 1),
            generator_from_config(cfg, K, 28, 1, device="cpu"))


@pytest.fixture(scope="module")
def gan_world(data):
    """The JAX FedGAN sim, its initial state converted, and its mask
    capture."""
    jdata, tdata = data
    jgen, tgen = gen_pair()
    jsim = JF.FedGANSim(jgen, jax_disc(), jdata, tiny_cfg(jc))
    jstate = jax.jit(jsim.init)()
    v = to_numpy(jstate)
    capture = mask_capture(jsim.disc.module, jstate.disc_vars, True)
    return jsim, jstate, tgen, generator_state_dict(v.gen_vars), \
        acgan_state_dict(v.disc_vars), capture


def test_acgan_cohort_update_matches_jax(gan_world, data):
    """Two lanes of unequal size, 2 epochs, the global (G, D) broadcast to
    both: the smaller lane steps on padding in its last steps of each
    epoch (gated no-ops)."""
    jsim, jstate, tgen, g0, d0, capture = gan_world
    cfg = tiny_cfg(jc, epochs=2)
    a = jsim.arrays
    lanes = np.array([0, 1])
    counts = np.asarray(a.counts)[lanes]
    steps = -(-int(counts.max()) // B)
    assert -(-int(counts.min()) // B) < steps, counts
    max_n = a.max_client_samples
    update = jax.jit(jax.vmap(JG.build_gan_local_update(
        jsim.gen, jsim.disc, cfg.train, cfg.gan, B, max_n, mode="acgan"),
        in_axes=(None, None, 0, 0, None, None, 0)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(5), i))(
        jnp.asarray(lanes))
    jg, jd, jn, jsums = to_numpy(update(
        jstate.gen_vars, jstate.disc_vars, a.idx[lanes], a.mask[lanes],
        a.x, a.y, keys))

    tcfg = tiny_cfg(tc, epochs=2)
    disc = port_disc()
    tupd = TG.GanCohortUpdate(tgen, disc, tcfg.train, tcfg.gan, B,
                              graphed=False, mode="acgan", shared_disc=True)
    ta = arrays_and_batch(data[1], tcfg.data, "cpu")[0]
    rows = torch.tensor(lanes)
    drawn = [step_draws(k, 2, steps, 4) for k in keys]
    masks = to_port_masks(capture(jnp.stack([d[2] for d in drawn]
                                            ).reshape(-1)),
                          (2, 2, steps, 3))
    orders = np.stack([lane_orders(k, a.mask[c], 2, max_n)
                       for k, c in zip(keys, lanes)])
    lead = (2, steps)
    tg, td, tn, tsums = tupd(
        g0, d0, ta.idx[rows], ta.mask[rows], ta.x, ta.y,
        torch.tensor(orders).long(),
        torch.tensor(np.stack([np.asarray(d[0]).reshape(lead + (B, NZ))
                               for d in drawn])),
        torch.tensor(np.stack([np.asarray(d[1]).reshape(lead + (B,))
                               for d in drawn])).long(), steps, masks)
    close_vars(tg, generator_state_dict(jg, lead=1), ROUND, "generator")
    close_vars(td, acgan_state_dict(jd, lead=1), ROUND, "discriminator")
    close(tn, jn, MATH)
    for k in jsums:
        close(tsums[k], jsums[k], ROUND, k)
    np.testing.assert_array_equal(tsums["batches"].numpy(),
                                  2 * -(-counts // B))


def test_acgan_step_on_padding_is_a_no_op(gan_world, data):
    """One acgan step where lane 1's batch is all padding: lane 1's
    generator, discriminator, both optimizer states (adam's step count)
    and sums stay bit for bit; lane 0's move."""
    _, _, tgen, g0, d0, _ = gan_world
    cfg = tiny_cfg(tc)
    disc = port_disc()
    upd = TG.GanCohortUpdate(tgen, disc, cfg.train, cfg.gan, B,
                             graphed=False, mode="acgan", shared_disc=True)
    carry = upd.init_carry(g0, d0, 2)
    a = arrays_and_batch(data[1], cfg.data, "cpu")[0]
    max_n = a.max_client_samples
    orders = torch.arange(max_n).expand(2, 1, max_n)
    (b_idx, w_b), = lane_batches(a.idx[:2], a.mask[:2], orders, 1, 1, B)
    w_b = w_b * torch.tensor([[1.0], [0.0]])
    gen = torch.Generator().manual_seed(0)
    masks = {k: torch.rand((2, 3, B) + s, generator=gen) < 0.75
             for k, s in disc.module.mask_shapes().items()}
    out = upd.step(carry, a.x, a.y, b_idx, w_b,
                   torch.randn(2, B, NZ, generator=gen),
                   torch.randint(0, K, (2, B), generator=gen), masks)
    assert out["g_opt"]["count"].tolist() == [1.0, 0.0]
    for part in ("g_params", "g_stats", "g_opt", "d_params", "d_stats",
                 "d_opt", "sums"):
        flat_new, flat_old = flat(out[part]), flat(carry[part])
        for k, v in flat_new.items():
            assert torch.equal(v[1], flat_old[k][1]), (part, k)
    for part in ("g_params", "d_params", "d_stats"):
        assert any(not torch.equal(v[0], carry[part][k][0])
                   for k, v in out[part].items()), part


# ---------------------------------------------------------------------------
# two rounds of each sim
# ---------------------------------------------------------------------------


def build_pair(algo, data):
    """The JAX sim and the port's, on the same data, with the replay
    hooks, and the JAX sim's initial state."""
    jdata, tdata = data
    jcfg, tcfg = tiny_cfg(jc, algo), tiny_cfg(tc, algo)
    jgen, tgen = gen_pair()
    validity = algo != "fedssgan"
    jd, td = jax_disc(validity), port_disc(validity)
    if algo == "fedgan":
        jsim = JF.FedGANSim(jgen, jd, jdata, jcfg)
    elif algo == "feddtg":
        jsim = JF.FedDTGSim(jgen, jd, jax_create_model(jcfg.model), jdata,
                            jcfg)
    elif algo == "fedssgan":
        jsim = JS.FedSSGANSim(jgen, jd, jdata, jcfg)
    else:
        jsim = JS.FedUAGANSim(jgen, jd, jdata, jcfg)
    jstate = jax.jit(jsim.init)()
    stack = jstate.disc_stack if algo == "feduagan" else jstate.disc_vars
    one = jax.tree.map(lambda s: s[0], stack) if algo == "feduagan" \
        else stack
    capture = mask_capture(jd.module, one, validity)
    if algo == "feduagan":
        replay = UAReplay(jsim, capture)
        tsim = FedUAGANSim(tgen, td, tdata, tcfg, "cpu",
                           batch_orders=replay.batch_orders,
                           draws=replay.draws)
    else:
        replay = Replay(jsim, 5 if algo == "feddtg" else 4, capture)
        hooks = dict(sampler=replay.sampler,
                     batch_orders=replay.batch_orders, draws=replay.draws)
        if algo == "fedgan":
            tsim = FedGANSim(tgen, td, tdata, tcfg, "cpu", **hooks)
        elif algo == "feddtg":
            tsim = FedDTGSim(tgen, td, create_model(tcfg.model, "cpu"),
                             tdata, tcfg, "cpu", **hooks)
        else:
            tsim = FedSSGANSim(tgen, td, tdata, tcfg, "cpu", **hooks,
                               labelled=torch.tensor(np.asarray(
                                   jsim.labelled)))
    return jsim, jstate, tsim


def port_state(algo, tsim, jstate):
    v = to_numpy(jstate)
    init = tsim.init()
    if algo == "feduagan":
        return init._replace(gen_vars=generator_state_dict(v.gen_vars),
                             disc_stack=acgan_state_dict(v.disc_stack,
                                                         lead=1))
    state = init._replace(gen_vars=generator_state_dict(v.gen_vars),
                          disc_vars=acgan_state_dict(v.disc_vars))
    if algo == "feddtg":
        state = state._replace(cls_stack=vision_state_dict(
            v.cls_stack, "CNNParameterised", lead=1))
    return state


def check_state(algo, state, jstate, r):
    v = to_numpy(jstate)
    close_vars(state.gen_vars, generator_state_dict(v.gen_vars), ROUND,
               f"round {r} generator")
    if algo == "feduagan":
        close_vars(state.disc_stack, acgan_state_dict(v.disc_stack, lead=1),
                   ROUND, f"round {r} discriminators")
        adam = v.gen_opt_state[0]
        assert int(state.gen_opt_state["count"]) == int(adam.count) == r + 1
        for part in ("mu", "nu"):
            close_vars(state.gen_opt_state[part], generator_state_dict(
                {"params": getattr(adam, part)}), ROUND,
                f"round {r} generator adam {part}")
        return
    close_vars(state.disc_vars, acgan_state_dict(v.disc_vars), ROUND,
               f"round {r} discriminator")
    if algo == "feddtg":
        close_vars(state.cls_stack, vision_state_dict(
            v.cls_stack, "CNNParameterised", lead=1), ROUND,
            f"round {r} classifiers")


@pytest.mark.parametrize("algo", ALGOS)
def test_two_rounds_match_jax(algo, data):
    """Two rounds from the JAX sim's initial state, its cohorts, batch
    orders, noise, labels and dropout masks replayed: every variable of
    the state and every metric within the band. Round 0's cohort has a
    client smaller than the other (a group that pads). FedDTG: the
    classifiers of the clients a round did not sample stay bit for bit,
    and every client's accuracy matches; FedSSGAN: the confidence-
    filtered synthetic set; FedGAN and FedUAGAN: the image grid."""
    jsim, jstate, tsim = build_pair(algo, data)
    state = port_state(algo, tsim, jstate)
    for r in range(2):
        before = state
        jstate, jm = jsim.run_round(jstate)
        state, tm = tsim.run_round(state)
        check_state(algo, state, jstate, r)
        assert set(tm) == set(jm), (tm, jm)
        for k in jm:
            close(tm[k], jm[k], ROUND, k)
        if algo == "feduagan":
            assert tsim.last_groups == [(4, tsim.steps_per_epoch)]
            continue
        n, steps = tsim.last_groups[0]
        counts = np.asarray(jsim.arrays.counts)[np.asarray(
            tsim.sampler(r, 4, 2))]
        assert n == 2 and steps == -(-int(counts.max()) // B)
        if r == 0:
            assert counts.min() < counts.max(), counts
        if algo == "feddtg":
            cohort = np.asarray(tsim.sampler(r, 4, 2))
            idle = np.setdiff1d(np.arange(4), cohort)
            for k, leaf in state.cls_stack.items():
                assert torch.equal(leaf[idle], before.cls_stack[k][idle]), k
    if algo == "feddtg":
        jev, tev = jsim.evaluate_clients(jstate), tsim.evaluate_clients(
            state)
        np.testing.assert_allclose(tev["per_client_acc"],
                                   jev["per_client_acc"], atol=1e-6)
        np.testing.assert_allclose(tev["test_loss"], jev["test_loss"],
                                   **ROUND)
    if algo == "fedssgan":
        k = jax.random.key(3)
        z = np.asarray(jsim.gen.sample_noise(k, 32))
        gl = np.asarray(jsim.gen.sample_labels(jax.random.fold_in(k, 1),
                                               32))
        # the threshold between the middle two confidences, so that half
        # the rows are kept and none sits on it
        imgs = jsim.gen.apply_eval(jstate.gen_vars, z, gl)
        conf = np.sort(np.asarray(jax.nn.softmax(jsim.disc.apply_eval(
            jstate.disc_vars, imgs), -1)).max(-1))
        for sim in (jsim, tsim):
            sim.cfg = dataclasses.replace(sim.cfg, gan=dataclasses.replace(
                sim.cfg.gan, pseudo_label_threshold=float(
                    (conf[15] + conf[16]) / 2)))
        jx, jp, jk = to_numpy(jsim.generate_synthetic_dataset(jstate, 32,
                                                              seed=3))
        tx, tp, tk = tsim.generate_synthetic_dataset(
            state, 32, z=torch.tensor(z), labels=torch.tensor(gl).long())
        close(tx, jx, ROUND)
        np.testing.assert_array_equal(tp.numpy(), jp)
        np.testing.assert_array_equal(tk.numpy(), jk)
        assert jk.sum() == 16, jk
    if algo in ("fedgan", "feduagan"):
        z = np.asarray(jsim.gen.sample_noise(jax.random.key(0), 12))
        close(tsim.sample_images(state, 12, z=torch.tensor(z)),
              jsim.sample_images(jstate, 12), ROUND)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["feddtg", "feduagan"])
def test_cli_resumes_bit_for_bit(algo, tmp_path):
    """--algorithm feddtg (three models, a classifier bank) and feduagan
    (a discriminator bank of every client, the generator's optimizer
    across rounds), on a tenth of fake_mnist (``dataset_r`` from
    --config) over 8 clients: three rounds straight, and two rounds then
    the same command for three, which resumes after round 1; the last
    checkpoints are equal bit for bit."""
    from fedml_tpu_torch.experiments import run as cli

    conf = tmp_path / "cfg.json"
    conf.write_text(json.dumps({"gan": {"nz": NZ, "ngf": NGF,
                                        "distillation_size": 16,
                                        "kd_epochs": 1},
                                "data": {"dataset_r": 0.1}}))

    def argv(out, rounds):
        return ["--algorithm", algo, "--dataset", "fake_mnist",
                "--model", "cnn_small", "--num_classes", str(K),
                "--input_shape", "28", "28", "1", "--client_num_in_total",
                "8", "--client_num_per_round", "2", "--comm_round",
                str(rounds), "--batch_size", "32", "--config", str(conf),
                "--checkpoint_every", "1", "--out_dir", str(out),
                "--device", "cpu"]

    cli.main(argv(tmp_path / "a", 3))
    cli.main(argv(tmp_path / "b", 2))
    cli.main(argv(tmp_path / "b", 3))
    rows = [json.loads(line) for line in
            (tmp_path / "b" / "run_rep0" / "metrics.jsonl").open()]
    assert {"resumed_from": 2} in [{k: v for k, v in row.items()
                                    if k != "_ts"} for row in rows]
    assert [row["round"] for row in rows if "round" in row] == [0, 1, 2]
    final = [torch.load(p / "run_rep0" / "ckpt" / "round_00000002.pt",
                        weights_only=True) for p in (tmp_path / "a",
                                                     tmp_path / "b")]
    flat_a, flat_b = flat(final[0]), flat(final[1])
    assert flat_a.keys() == flat_b.keys()
    for k, v in flat_a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, flat_b[k]), k
        else:
            assert v == flat_b[k], k
    assert final[0]["round"] == 3
    keys = set(final[0])
    assert {"gen_vars", "round"} <= keys
    assert ("cls_stack" in keys) == (algo == "feddtg")
    assert ("gen_opt_state" in keys) == (algo == "feduagan")
