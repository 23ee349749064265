"""FedGDKD in the port against the JAX package: the generators, the
transposed convolution and the parameterised CNNs forward; the ssgan
losses, soft_target and the leave-one-out teacher; the adversarial cohort
update, the distillation set and the distillation update; two whole
rounds with a drift-corrected new joiner. Weights cross with
``fedml_tpu_torch/convert.py``; the JAX package's cohorts, batch orders
and draws are replayed through the port's hooks (``FedGDKDSim(sampler=,
batch_orders=, draws=)``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import gan_core as JG
from fedml_tpu.algorithms import kd as JKD
from fedml_tpu.algorithms.gan_family import FedGDKDSim as JaxFedGDKDSim
from fedml_tpu.core import random as JR
from fedml_tpu.data.loaders import make_fake_image_dataset as jax_fake_images
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models import gan as jgan
from fedml_tpu_torch.algorithms import gan_core as TG
from fedml_tpu_torch.algorithms.base import lane_batches
from fedml_tpu_torch.algorithms.gan_family import FedGDKDSim
from fedml_tpu_torch.algorithms.kd import soft_target
from fedml_tpu_torch.convert import generator_state_dict, vision_state_dict
from fedml_tpu_torch.data.loaders import make_fake_image_dataset
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.gan import ConvTranspose2d, generator_from_config
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-6)  # float32 forwards
MATH = dict(rtol=1e-6, atol=1e-6)
# the JAX package's own band between its fused and vmapped GAN updates
# (tests/test_gan_family.py)
ROUND = dict(rtol=1e-4, atol=1e-5)
NZ, NGF, B, K = 16, 8, 8, 10
SHAPE = (28, 28, 1)


def tiny_cfg(m, **train):
    """tests/test_gan_family.py's tiny FedGDKD configuration on cnn_small,
    4 clients of uneven size (hetero), 2 a round; the JAX side on its
    vmapped path (cohort_fused=False), the port's only one."""
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=4,
                          partition_method="hetero", partition_alpha=0.3,
                          batch_size=B, seed=0),
        model=m.ModelConfig(name="cnn_small", num_classes=K,
                            input_shape=SHAPE),
        train=m.TrainConfig(lr=0.05, cohort_fused=False,
                            **{"epochs": 1, **train}),
        fed=m.FedConfig(num_rounds=2, clients_per_round=2, eval_every=1),
        gan=m.GanConfig(nz=NZ, ngf=NGF, distillation_size=16, kd_epochs=1),
        seed=1)


def flax_vars(module, *args, seed=0):
    """Random flax variables for ``module`` from numpy: the tree from
    ``jax.eval_shape`` of its init (no compile); kernels with std
    1/sqrt(fan_in), running variances in [0.5, 1.5], the rest std 0.3."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                                train=False))
    rng = np.random.default_rng(seed)

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


def close(got: torch.Tensor, want, band, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **band)


def close_vars(got: dict, want: dict, band, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        close(got[k], want[k].numpy(), band, f"{what} {k}")


def to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def flat(tree, prefix=""):
    """A nested dict as one dict of dotted names."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------


def test_transposed_conv_matches_lax_and_flipped_conv_transpose():
    """Flax's SAME transposed conv (fractionally strided, kernel [kh, kw,
    in, out] unflipped, pads (2, 2) at k 4, s 2) equals the port's
    ConvTranspose2d, F.conv_transpose2d(stride 2, padding 1) with the
    kernel flipped in both spatial dims and laid out [in, out, kh, kw]."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 7, 5)).astype(np.float32)
    kern = rng.standard_normal((4, 4, 5, 6)).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(kern), (2, 2),
                                  "SAME",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    weight = torch.tensor(np.ascontiguousarray(
        np.flip(kern.transpose(2, 3, 0, 1), (2, 3))))
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    direct = F.conv_transpose2d(xt, weight, stride=2, padding=1)
    conv = ConvTranspose2d(5, 6, 4, 2)
    with torch.no_grad():
        conv.weight.copy_(weight)
        ours = conv(xt)
    assert ours.shape == (3, 6, 14, 14)
    close(direct.permute(0, 2, 3, 1), want, FWD)
    close(ours.permute(0, 2, 3, 1), want, FWD)
    # and the JAX package's own module, through the converter's flip
    mod = jgan.ConvTranspose2D(6, (4, 4), strides=(2, 2), use_bias=False)
    flax_out = mod.apply({"params": {"kernel": kern}}, jnp.asarray(x))
    close(ours.permute(0, 2, 3, 1), flax_out, FWD)


@pytest.mark.parametrize("conditional", [True, False],
                         ids=["conditional", "unconditional"])
@pytest.mark.parametrize("img_size", [28, 32])
def test_generator_forwards_match_flax(conditional, img_size):
    """Train mode (the images and the BatchNorm statistics at flax's
    momentum 0.99) and eval mode (the running statistics)."""
    cfg = tc.GanConfig(nz=NZ, ngf=NGF)
    if conditional:
        module = jgan.ConditionalImageGenerator(K, img_size, 3, NZ, NGF)
        args = (jnp.zeros((1, NZ)), jnp.zeros((1,), jnp.int32))
    else:
        module = jgan.ImageGenerator(img_size, 3, NZ, NGF)
        args = (jnp.zeros((1, NZ)),)
    variables = flax_vars(module, *args)
    gen = generator_from_config(cfg, K, img_size, 3, conditional, "cpu")
    ours = generator_state_dict(variables)
    assert set(ours) == set(gen.init(torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    z = rng.standard_normal((6, NZ)).astype(np.float32)
    labels = rng.integers(0, K, 6).astype(np.int32)
    jargs = (z, labels) if conditional else (z,)
    targs = (torch.tensor(z), torch.tensor(labels).long()
             if conditional else None)
    imgs, mutated = module.apply(variables, *jargs, train=True,
                                 mutable=["batch_stats"])
    timgs, new_vars = gen.apply_train(ours, *targs)
    assert timgs.shape == (6, img_size, img_size, 3)
    close(timgs, imgs, FWD)
    want = generator_state_dict({"batch_stats": to_numpy(mutated)[
        "batch_stats"]})
    close_vars({k: new_vars[k] for k in want}, want, FWD, "statistics")
    close(gen.apply_eval(ours, *targs),
          module.apply(variables, *jargs, train=False), FWD)


@pytest.mark.parametrize("name", ["cnn_small", "cnn_medium", "cnn_large"])
def test_parameterised_cnns_match_flax(name):
    mcfg = dict(name=name, num_classes=K, input_shape=SHAPE)
    jmodel = jax_create_model(jc.ModelConfig(**mcfg))
    variables = flax_vars(jmodel.module, jnp.zeros((1,) + SHAPE))
    model = create_model(tc.ModelConfig(**mcfg), "cpu")
    ours = vision_state_dict(variables, "CNNParameterised")
    assert set(ours) == set(model.init(torch.Generator().manual_seed(0)))
    x = np.random.default_rng(2).standard_normal((5,) + SHAPE)
    x = x.astype(np.float32)
    close(model.apply_eval(ours, torch.tensor(x)),
          jmodel.module.apply(variables, x, train=False), FWD)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------


def test_losses_soft_target_and_teacher_match_jax():
    rng = np.random.default_rng(3)
    a, b, t = (rng.standard_normal((8, K)).astype(np.float32) * 3
               for _ in range(3))
    la, lb = (rng.integers(0, K, 8).astype(np.int32) for _ in range(2))
    w = np.array([1, 1, 1, 0, 1, 0, 1, 1], np.float32)
    T = torch.tensor
    close(TG.generator_loss_ssgan(T(a), T(la), T(w)),
          JG.generator_loss_ssgan(a, la, w), MATH)
    close(TG.discriminator_loss_ssgan(T(a), T(la), T(b), T(lb), T(w)),
          JG.discriminator_loss_ssgan(a, la, b, lb, w), MATH)
    close(soft_target(T(a), T(t), 4.0), JKD.soft_target(a, t, 4.0), MATH)
    logits = rng.standard_normal((3, 16, K)).astype(np.float32)
    want = (jnp.sum(logits, 0)[None] - logits) / max(3 - 1, 1)
    close(TG.leave_one_out_teacher(T(logits)), want, MATH)
    one = logits[:1]
    close(TG.leave_one_out_teacher(T(one)),
          (jnp.sum(one, 0)[None] - one) / max(1 - 1, 1), MATH)


# ---------------------------------------------------------------------------
# the JAX package's draws, replayed
# ---------------------------------------------------------------------------


@jax.jit
def _lane_draws(ckey, es, ss):
    """A client's adversarial draws (gan_core.build_gan_local_update):
    epoch e, step s -> fold_in(fold_in(ckey, e), s), split in 4; z from
    the first key, the fake labels from the second."""
    def one(e, s):
        kz, kl, _, _ = jax.random.split(
            jax.random.fold_in(jax.random.fold_in(ckey, e), s), 4)
        return (jax.random.normal(kz, (B, NZ)),
                jax.random.randint(kl, (B,), 0, K))

    return jax.vmap(lambda e: jax.vmap(lambda s: one(e, s))(ss))(es)


def lane_draws(ckey, epochs, steps):
    z, labels = _lane_draws(ckey, jnp.arange(epochs), jnp.arange(steps))
    return np.asarray(z), np.asarray(labels)


def lane_orders(ckey, mask_row, epochs, max_n):
    """A client's epoch orders: permutation(fold_in(ckey, e)), the real
    samples stably first."""
    out = []
    for e in range(epochs):
        perm = np.asarray(jax.random.permutation(
            jax.random.fold_in(ckey, e), max_n))
        out.append(perm[np.argsort(1.0 - np.asarray(mask_row)[perm],
                                   kind="stable")])
    return np.stack(out)


def synth_noise(rkey, n_batches):
    rng = jax.random.fold_in(rkey, 0x5EED)
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(rng, i), (B, NZ))) for i in range(n_batches)])


class Replay:
    """The port's hooks, replaying a JAX FedGDKDSim's cohorts, batch orders
    and draws."""

    def __init__(self, jsim):
        self.jsim = jsim
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

    def draws(self, stream, r, slots, shapes):
        if stream == "synth":
            (n_batches, _, _), = shapes.values()
            return {"z": torch.tensor(synth_noise(self.rkey(r),
                                                  n_batches))[None]}
        epochs, steps = next(iter(shapes.values()))[:2]
        drawn = [lane_draws(JR.client_key(self.rkey(r), c), epochs, steps)
                 for c in slots]
        which = 0 if stream == "gan_z" else 1
        name, = shapes
        return {name: torch.tensor(np.stack([d[which] for d in drawn]))}


# ---------------------------------------------------------------------------
# the components and two rounds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """The JAX sim at the tiny configuration, its initial state, and the
    port's sim on the same data with the replay hooks (built once)."""
    jcfg, tcfg = tiny_cfg(jc), tiny_cfg(tc)
    jdata = jax_fake_images("mnist", jcfg.data, n_train=96, n_test=32)
    tdata = make_fake_image_dataset("mnist", tcfg.data, n_train=96,
                                    n_test=32)
    np.testing.assert_array_equal(jdata.x_train, tdata.x_train)
    jgen = jgan.generator_from_config(jcfg.gan, K, 28, 1)
    jsim = JaxFedGDKDSim(jgen, jax_create_model(jcfg.model), jdata, jcfg)
    assert jsim.cohort_gan is None and jsim.cohort_kd is None  # vmapped
    replay = Replay(jsim)
    tsim = FedGDKDSim(
        generator_from_config(tcfg.gan, K, 28, 1, device="cpu"),
        create_model(tcfg.model, "cpu"), tdata, tcfg, device="cpu",
        sampler=replay.sampler, batch_orders=replay.batch_orders,
        draws=replay.draws)
    jstate = jax.jit(jsim.init)()
    return jcfg, jsim, jstate, tsim


def port_state(tsim, jstate):
    """The JAX state converted: the generator, the [N, ...] bank."""
    v = to_numpy(jstate)
    return tsim.init()._replace(
        gen_vars=generator_state_dict(v.gen_vars),
        cls_stack=vision_state_dict(v.cls_stack, "CNNParameterised", lead=1))


def test_gan_cohort_update_matches_jax(world):
    """Two lanes of unequal size, 2 epochs: the smaller lane steps on
    padding (a gated no-op) in its group's last step of each epoch."""
    jcfg, jsim, jstate, tsim = world
    cfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train,
                                                              epochs=2))
    a = jsim.arrays
    lanes = np.array([0, 1])
    counts = np.asarray(a.counts)[lanes]
    steps = -(-int(counts.max()) // B)
    assert -(-int(counts.min()) // B) < steps, counts  # padding steps
    max_n = a.max_client_samples
    update = jax.jit(jax.vmap(JG.build_gan_local_update(
        jsim.gen, jsim.disc, cfg.train, cfg.gan, B, max_n),
        in_axes=(None, 0, 0, 0, None, None, 0)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(5), i))(
        jnp.asarray(lanes))
    cls = jax.tree.map(lambda s: s[lanes], jstate.cls_stack)
    jg, jd, jn, jsums = to_numpy(update(
        jstate.gen_vars, cls, a.idx[lanes], a.mask[lanes], a.x, a.y, keys))

    tcfg = tiny_cfg(tc, epochs=2)
    tupd = TG.GanCohortUpdate(tsim.gen, tsim.classifier, tcfg.train,
                              tcfg.gan, B, graphed=False)
    ta, rows = tsim.arrays, torch.tensor(lanes)
    drawn = [lane_draws(k, 2, steps) for k in keys]
    orders = np.stack([lane_orders(k, a.mask[c], 2, max_n)
                       for k, c in zip(keys, lanes)])
    st = port_state(tsim, jstate)
    tg, td, tn, tsums = tupd(
        st.gen_vars, {k: v[rows] for k, v in st.cls_stack.items()},
        ta.idx[rows], ta.mask[rows], ta.x, ta.y,
        torch.tensor(orders).long(), torch.tensor(np.stack([d[0] for d in drawn])),
        torch.tensor(np.stack([d[1] for d in drawn])).long(), steps)
    close_vars(tg, generator_state_dict(jg, lead=1), ROUND, "generator")
    close_vars(td, vision_state_dict(jd, "CNNParameterised", lead=1), ROUND,
               "classifier")
    close(tn, jn, MATH)
    for k in jsums:
        close(tsums[k], jsums[k], ROUND, k)
    # the JAX lanes stop at their own ceil(n_k / B); the port's smaller
    # lane took the group's steps, the extra ones gated
    np.testing.assert_array_equal(tsums["batches"].numpy(),
                                  2 * -(-counts // B))


def test_gan_step_on_padding_is_a_no_op(world):
    """One step where lane 1's batch is all padding: lane 1's generator,
    classifier, both optimizer states (adam's step count) and sums stay
    bit for bit; lane 0's move."""
    _, _, jstate, tsim = world
    st = port_state(tsim, jstate)
    upd = tsim.gan_update
    cls = {k: v[:2] for k, v in st.cls_stack.items()}
    carry = upd.init_carry(st.gen_vars, cls)
    a = tsim.arrays
    orders = torch.arange(tsim.max_n).expand(2, 1, tsim.max_n)
    (b_idx, w_b), = lane_batches(a.idx[:2], a.mask[:2], orders, 1, 1, B)
    w_b = w_b * torch.tensor([[1.0], [0.0]])
    gen = torch.Generator().manual_seed(0)
    out = upd.step(carry, a.x, a.y, b_idx, w_b,
                   torch.randn(2, B, NZ, generator=gen),
                   torch.randint(0, K, (2, B), generator=gen))
    assert out["g_opt"]["count"].tolist() == [1.0, 0.0]
    for part in ("g_params", "g_stats", "d_params", "g_opt", "sums"):
        flat_new, flat_old = flat(out[part]), flat(carry[part])
        for k, v in flat_new.items():
            assert torch.equal(v[1], flat_old[k][1]), (part, k)
    assert not torch.equal(out["g_params"]["pyramid.l1.weight"][0],
                           carry["g_params"]["pyramid.l1.weight"][0])


@pytest.fixture(scope="module")
def synth(world):
    """The distillation set of the initial generator, both sides."""
    jcfg, jsim, jstate, tsim = world
    rkey = jax.random.key(11)
    jx, jy = to_numpy(jax.jit(jsim.generate)(
        jstate.gen_vars, jax.random.fold_in(rkey, 0x5EED)))
    st = port_state(tsim, jstate)
    tx, ty = tsim.generate(st.gen_vars, torch.tensor(synth_noise(rkey, 2)))
    return jx, jy, tx, ty


def test_dataset_generator_matches_jax(synth):
    jx, jy, tx, ty = synth
    assert tx.shape == (16,) + SHAPE
    close(tx, jx, FWD)
    np.testing.assert_array_equal(ty.numpy(), jy)


def test_kd_update_matches_jax(world, synth):
    jcfg, jsim, jstate, tsim = world
    jx, jy, tx, ty = synth
    teachers = np.random.default_rng(4).standard_normal((2, 16, K))
    teachers = teachers.astype(np.float32) * 2
    cls = jax.tree.map(lambda s: s[:2], jstate.cls_stack)
    kd = jax.jit(jax.vmap(jsim.kd_update, in_axes=(0, None, None, 0, 0)))
    jvars, jl = to_numpy(kd(cls, jx, jy, teachers,
                            jax.random.split(jax.random.key(0), 2)))
    st = port_state(tsim, jstate)
    tvars, tl = tsim.kd_update({k: v[:2] for k, v in st.cls_stack.items()},
                               tx, ty, torch.tensor(teachers))
    close_vars(tvars, vision_state_dict(jvars, "CNNParameterised", lead=1),
               ROUND, "classifier")
    for k in jl:
        close(tl[k], jl[k], ROUND, k)


def test_two_rounds_match_jax(world):
    """Round 0 samples 2 of 4 clients; round 1's cohort has a client
    that was not in round 0's, which the drift correction distills. The
    generator, every classifier, the distillation set, the teacher and
    the losses within the band; the classifiers of the clients a round
    did not sample stay bit for bit."""
    _, jsim, jstate, tsim = world
    state = port_state(tsim, jstate)
    drifted = []
    for r in range(2):
        before = state.cls_stack
        jstate, jm = jsim.run_round(jstate)
        state, tm = tsim.run_round(state)
        drifted.append(tsim.last_drift)
        v = to_numpy(jstate)
        close_vars(state.gen_vars, generator_state_dict(v.gen_vars), ROUND,
                   f"round {r} generator")
        close_vars(state.cls_stack, vision_state_dict(
            v.cls_stack, "CNNParameterised", lead=1), ROUND,
            f"round {r} classifiers")
        close(state.prev_synth_x, v.prev_synth_x, ROUND)
        np.testing.assert_array_equal(state.prev_synth_y.numpy(),
                                      v.prev_synth_y)
        close(state.prev_teacher, v.prev_teacher, ROUND)
        np.testing.assert_array_equal(state.prev_sampled.numpy(),
                                      v.prev_sampled)
        for k in ("g_loss", "d_loss", "kd_loss"):
            close(tm[k], jm[k], ROUND, k)
        idle = np.flatnonzero(~state.prev_sampled.numpy())
        for k, leaf in state.cls_stack.items():
            assert torch.equal(leaf[idle], before[k][idle]), k
    assert drifted == [0, 1], drifted
    assert tsim.counters["fedgdkd.drift_corrected"] == 1
    jev, tev = jsim.evaluate_clients(jstate), tsim.evaluate_clients(state)
    np.testing.assert_allclose(tev["per_client_acc"], jev["per_client_acc"],
                               atol=1e-6)
    np.testing.assert_allclose(tev["test_loss"], jev["test_loss"], **ROUND)


# ---------------------------------------------------------------------------
# refusals, the config, the CLI
# ---------------------------------------------------------------------------


def test_refusals_name_their_items():
    """What is still refused names its ROADMAP item: the other algorithm
    families (13). Dropout (item 13c) is ported: FedGDKD and FedDTG build
    a classifier with dropout, each of its phases on a mask stream of its
    own, and the bulk engine builds ``cnn``; a dropout model under PEFT
    gets the JAX package's ``ValueError`` (LoRA needs the TransformerLM's
    projections, personalization needs LoRA). The acgan mode and the rest
    of the GAN family (item 13a) are ported, so build_sim returns each of
    them on the CPU."""
    cfg = tiny_cfg(tc)
    gen = generator_from_config(cfg.gan, K, 28, 1, device="cpu")
    model = create_model(cfg.model, "cpu")
    upd = TG.GanCohortUpdate(gen, model, cfg.train, cfg.gan, B, False,
                             mode="acgan")
    assert upd.mode == "acgan"
    from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
    from fedml_tpu_torch.algorithms.gan_family import FedDTGSim, FedGANSim
    from fedml_tpu_torch.algorithms.sgan import FedSSGANSim, FedUAGANSim
    from fedml_tpu_torch.experiments.harness import build_sim
    from fedml_tpu_torch.models.gan import acgan_discriminator

    dropped = create_model(tc.ModelConfig(name="cnn_medium", num_classes=K,
                                          input_shape=SHAPE,
                                          extra=(("dropout", 0.25),)), "cpu")
    assert dropped.has_dropout
    data = make_fake_image_dataset("mnist", cfg.data, n_train=96, n_test=32)
    gdkd = FedGDKDSim(gen, dropped, data, cfg, "cpu")
    assert set(gdkd.mask_sites) == {"dropout", "dropout_kd", "dropout_drift"}
    assert gdkd.mask_sites["dropout_kd"] == dropped.mask_sites
    dtg = FedDTGSim(gen, acgan_discriminator(K, SHAPE, (8, 16), device="cpu"),
                    dropped, data, cfg, "cpu")
    assert set(dtg.mask_sites) == {"dropout", "dropout_cls", "dropout_kd"}
    assert dtg.mask_sites["dropout_cls"] == dropped.mask_sites
    cnn = create_model(tc.ModelConfig(name="cnn", num_classes=K,
                                      input_shape=SHAPE), "cpu")
    bulk = FedAvgSim(cnn, data, dataclasses.replace(
        cfg, fed=dataclasses.replace(cfg.fed, client_block_size=2)), "cpu")
    assert bulk.model.has_dropout and bulk._bulk.enabled()
    for fed, match in ((dict(peft="lora"), "TransformerLM"),
                       (dict(peft_personalize=True), "requires peft='lora'")):
        peft = dataclasses.replace(cfg, fed=dataclasses.replace(cfg.fed,
                                                                **fed))
        with pytest.raises(ValueError, match=match):
            FedAvgSim(cnn, data, peft, "cpu")

    def with_algo(algo):
        return dataclasses.replace(cfg, fed=dataclasses.replace(
            cfg.fed, algorithm=algo))

    with pytest.raises(ValueError, match="unknown algorithm"):
        build_sim(with_algo("fedgkt2"), "cpu")
    for algo, kind in (("fedgan", FedGANSim), ("feddtg", FedDTGSim),
                       ("fedssgan", FedSSGANSim),
                       ("feduagan", FedUAGANSim)):
        sim = build_sim(with_algo(algo), "cpu")
        assert type(sim) is kind and sim.device.type == "cpu", algo
        assert isinstance(sim.counters, dict), algo


def test_cnn_custom_takes_its_widths():
    model = create_model(tc.ModelConfig(
        name="cnn_custom", num_classes=K, input_shape=SHAPE,
        extra=(("convs", (4, 6)), ("denses", (12, 7)))), "cpu")
    v = model.init(torch.Generator().manual_seed(0))
    assert v["convs.1.weight"].shape == (6, 4, 3, 3)
    assert v["fc2.weight"].shape == (7, 12) and v["head.weight"].shape == (
        K, 7)
    assert model.apply_eval(v, torch.zeros((2,) + SHAPE)).shape == (2, K)


def test_gan_config_round_trips_to_both_packages():
    cfg = dataclasses.replace(tiny_cfg(tc), gan=tc.GanConfig(
        nz=32, ngf=16, gen_optimizer="sgd", kd_alpha=0.5, kd_epochs=3,
        kd_temperature=2.0, distillation_size=64))
    blob = json.loads(cfg.to_json())
    assert tc.ExperimentConfig.from_dict(blob) == cfg
    assert jc.ExperimentConfig.from_dict(blob).gan == jc.GanConfig(
        **dataclasses.asdict(cfg.gan))
    assert {f.name for f in dataclasses.fields(tc.GanConfig)} == {
        f.name for f in dataclasses.fields(jc.GanConfig)}


def test_cli_fedgdkd_checkpoint_resumes_bit_for_bit(tmp_path):
    """--algorithm fedgdkd with the GAN settings from --config: three
    rounds straight, and two rounds then the same command for three,
    which resumes after round 1; the last checkpoints are equal bit for
    bit."""
    from fedml_tpu_torch.experiments import run as cli

    conf = tmp_path / "cfg.json"
    conf.write_text(json.dumps({"gan": {"nz": NZ, "ngf": NGF,
                                        "distillation_size": 16,
                                        "kd_epochs": 1}}))

    def argv(out, rounds):
        return ["--algorithm", "fedgdkd", "--dataset", "fake_mnist",
                "--model", "cnn_small", "--num_classes", str(K),
                "--input_shape", "28", "28", "1", "--client_num_in_total",
                "40", "--client_num_per_round", "2", "--comm_round",
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
