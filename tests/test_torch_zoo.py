"""The rest of the model zoo, its two tasks, its two procedural sets, the
segmentation evaluator and the fedseg alias in the port against the JAX
package: every new model's train-mode forward (with its new batch
statistics), eval-mode forward and one local SGD step, on flax weights
carried across by ``fedml_tpu_torch/convert.py``, at small widths
(``mobilenet_v3`` at ``width_mult`` 0.25, ``efficientnet-b0`` at 32x32,
``deeplab`` with ``encoder_features`` (8, 16) as in
``tests/test_fedseg.py``); the tag and segmentation sums on the same
logits; ``fake_stackoverflow_lr`` and ``fake_seg`` bit for bit;
``SegEvaluator``; one fedseg round with the JAX sim's cohort and batch
orders replayed. Float32 at rtol 1e-4, atol 1e-5, except EfficientNet:
its random-init BatchNorm at batch 4 is ill-conditioned in float32 (the
JAX package's own float32 train-mode logits are 5.5e-5 off its float64
ones, outside the band), so both packages run it in float64
(``jax.enable_x64``, float64 variables and inputs, compute type
"float64") at the same band. Each model's JAX side is one jitted
function, run once for the module."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.algorithms import fedavg as jfed
from fedml_tpu.algorithms.base import build_local_update as jax_local_update
from fedml_tpu.algorithms.base import make_task as jax_make_task
from fedml_tpu.core import random as JR
from fedml_tpu.data.loaders import load_dataset as jax_load_dataset
from fedml_tpu.metrics.segmentation import SegEvaluator as JaxSegEvaluator
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.ops.cohort_conv import _resolve_padding
from fedml_tpu_torch.algorithms.base import build_local_update, make_task
from fedml_tpu_torch.algorithms.base import finalize_sums
from fedml_tpu_torch.convert import vision_state_dict
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.experiments.harness import build_sim
from fedml_tpu_torch.metrics.segmentation import SegEvaluator
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.vision import same_padding
from tests.test_torch_gan import close, flax_vars, lane_orders
from tests.torch_threads import one_torch_thread  # noqa: F401

BAND = dict(rtol=1e-4, atol=1e-5)
B = 4
LR = 0.1
# name -> (input shape, classes, extra, task, the port's class)
ZOO = {
    "vgg11": ((32, 32, 3), 10, (), "classification", "VGG"),
    "mobilenet_v3": ((32, 32, 3), 10, (("width_mult", 0.25),),
                     "classification", "MobileNetV3"),
    "efficientnet-b0": ((32, 32, 3), 10, (), "classification",
                        "EfficientNet"),
    "lenet": ((28, 28, 1), 10, (), "classification", "LeNet"),
    "tag_lr": ((1000,), 50, (), "tag_prediction", "TagLogisticRegression"),
    "deeplab": ((32, 32, 3), 4, (("encoder_features", (8, 16)),),
                "segmentation", "DeepLabLite"),
}
# held in float64 on both sides (see the module's docstring)
X64 = {"efficientnet-b0"}


def _dtype(name):
    return "float64" if name in X64 else "float32"


def _inputs(name):
    shape, k, _, task, _ = ZOO[name]
    rng = np.random.default_rng(1)
    if task == "tag_prediction":
        x = (rng.random((B,) + shape) < 0.05).astype(np.float32)
        y = (rng.random((B, k)) < 0.1).astype(np.float32)
    else:
        x = rng.standard_normal((B,) + shape).astype(np.float32)
        y_shape = (B,) + shape[:2] if task == "segmentation" else (B,)
        y = rng.integers(0, k, y_shape).astype(np.int32)
    return x, y


def _model_cfg(m, name):
    shape, k, extra, _, _ = ZOO[name]
    return m.ModelConfig(name=name, num_classes=k, input_shape=shape,
                         extra=extra)


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """The flax variables, and in one jitted call: the train-mode logits
    and new batch statistics, the eval-mode logits, one local SGD step of
    a client holding the whole batch, and its batch order."""
    shape, _, _, task, _ = ZOO[name]
    model = jax_create_model(_model_cfg(jc, name))
    variables = flax_vars(model.module, jnp.zeros((1,) + shape))
    x, y = _inputs(name)
    lu = jax_local_update(model, jax_make_task(task), jc.TrainConfig(
        lr=LR, epochs=1, compute_dtype=_dtype(name)), B, B)
    key = jax.random.key(3)

    def run(v, x, y):
        if "batch_stats" in v:
            train, mutated = model.module.apply(v, x, train=True,
                                                mutable=["batch_stats"])
            stats = mutated["batch_stats"]
        else:
            train, stats = model.module.apply(v, x, train=True), {}
        evals = model.module.apply(v, x, train=False)
        stepped, _, sums = lu(v, jnp.arange(B, dtype=jnp.int32),
                              jnp.ones(B), x, y, key)
        return train, stats, evals, stepped, sums

    with (jax.enable_x64(True) if name in X64
          else contextlib.nullcontext()):
        dtype = jnp.dtype(_dtype(name))
        args = (jax.tree.map(lambda a: jnp.asarray(a, dtype), variables),
                jnp.asarray(x, dtype), jnp.asarray(y))
        # LLVM's expensive passes off: about half the compile time, the
        # same results bit for bit (EfficientNet-B0 in float64: 19.8 s
        # against 11.0 s on one core)
        out = jax.device_get(jax.jit(run).lower(*args).compile(
            compiler_options={"xla_llvm_disable_expensive_passes": True})(
            *args))
    order = lane_orders(key, np.ones(B), 1, B)
    return variables, out, order


def _port(name):
    """The port's model, the flax variables converted (float64 for a
    model of ``X64``) and the inputs."""
    variables = jax_run(name)[0]
    model = create_model(_model_cfg(tc, name), "cpu")
    dtype = getattr(torch, _dtype(name))
    x, y = (torch.from_numpy(a) for a in _inputs(name))
    return (model, {k: v.to(dtype) for k, v in vision_state_dict(
        variables, ZOO[name][4]).items()}, x.to(dtype), y)


def _flax_as_port(name, tree):
    """A flax subtree (params or stats) under the port's names."""
    return vision_state_dict(tree, ZOO[name][4])


@pytest.mark.parametrize("size", [4, 5, 8, 9])
def test_dilated_same_padding_matches_jax(size):
    """SAME padding of a dilated kernel (DeepLab's ASPP) pads for the
    effective kernel (k - 1) * r + 1, the low side getting total // 2."""
    for k, s, r in ((3, 1, 1), (3, 1, 2), (3, 1, 4), (3, 2, 2), (5, 2, 3)):
        want = _resolve_padding("SAME", (size, size), (k, k), (s, s),
                                (r, r))
        assert same_padding((size, size), (k, k), (s, s), (r, r)) == want


@pytest.mark.parametrize("name", list(ZOO))
def test_forward_matches_flax(name):
    model, tvars, x, _ = _port(name)
    _, (train, stats, evals, _, _), _ = jax_run(name)
    fresh = model.init(torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in fresh.items()} == {
        k: v.shape for k, v in tvars.items()}
    got, new_vars = model.apply_train(tvars, x)
    close(got, train, BAND, f"{name} train")
    if stats:
        want = _flax_as_port(name, {"batch_stats": stats})
        assert set(want) == set(model.stat_names)
        for k in model.stat_names:
            close(new_vars[k], want[k].numpy(), BAND, k)
    else:
        assert not model.stat_names
    close(model.apply_eval(tvars, x), evals, BAND, f"{name} eval")


@pytest.mark.parametrize("name", list(ZOO))
def test_local_step_matches_jax(name):
    model, tvars, x, y = _port(name)
    _, (_, _, _, stepped, sums), order = jax_run(name)
    task = ZOO[name][3]
    lu = build_local_update(model, make_task(task), tc.TrainConfig(
        lr=LR, epochs=1, compute_dtype=_dtype(name)), B, B)
    got, n_k, t_sums = lu(tvars, torch.arange(B, dtype=torch.int32),
                          torch.ones(B), x, y, [torch.from_numpy(order[0])])
    assert float(n_k) == B
    want = _flax_as_port(name, stepped)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k].numpy(), BAND, f"{name} {k}")
    for k in sums:
        np.testing.assert_allclose(float(t_sums[k]), float(sums[k]), **BAND)


def _task_sums(task, seed):
    rng = np.random.default_rng(seed)
    if task == "tag_prediction":
        logits = rng.standard_normal((6, 12)).astype(np.float32) * 2
        logits[1] = -30.0  # a row that predicts no tag
        y = (rng.random((6, 12)) < 0.3).astype(np.float32)
    else:
        logits = rng.standard_normal((6, 5, 7, 3)).astype(np.float32)
        y = rng.integers(0, 3, (6, 5, 7)).astype(np.int32)
    w = np.array([1, 0, 1, 1, 0.5, 1], np.float32)
    return logits, y, w


@pytest.mark.parametrize("task", ["tag_prediction", "segmentation"])
def test_task_sums_match_jax(task):
    logits, y, w = _task_sums(task, 0)
    want = jax_make_task(task).metric_sums(jnp.asarray(logits),
                                           jnp.asarray(y), jnp.asarray(w))
    got = make_task(task).metric_sums(torch.from_numpy(logits),
                                      torch.from_numpy(y),
                                      torch.from_numpy(w))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    if task == "tag_prediction":
        # no predicted tag at all: the count is 0 and the clamp applies
        zero = make_task(task).metric_sums(
            torch.full((2, 12), -30.0), torch.from_numpy(y[:2]),
            torch.ones(2))
        assert float(zero["count"]) == 0.0
        assert float(finalize_sums(zero)["acc"]) == 0.0


@pytest.mark.parametrize("dataset,method", [
    ("fake_stackoverflow_lr", "homo"), ("fake_seg", "hetero"),
    ("fake_pascal_voc", "homo"), ("fake_coco_seg", "homo")])
def test_fake_sets_match_jax_bit_for_bit(dataset, method):
    kw = dict(dataset=dataset, num_clients=5, partition_method=method,
              partition_alpha=0.5, seed=2)
    want = jax_load_dataset(jc.DataConfig(**kw))
    got = load_dataset(tc.DataConfig(**kw))
    assert got.task == want.task and got.num_classes == want.num_classes
    for f in ("x_train", "y_train", "x_test", "y_test"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("train_idx_map", "test_idx_map"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a), f


def test_seg_evaluator_matches_jax():
    rng = np.random.default_rng(4)
    want, got = JaxSegEvaluator(4), SegEvaluator(4)
    for _ in range(3):
        gt = rng.integers(0, 4, (3, 9, 9)).astype(np.int32)
        gt[0, :2] = 255  # ignored pixels
        pred = rng.integers(0, 4, (3, 9, 9)).astype(np.int32)
        want.add_batch(jnp.asarray(gt), jnp.asarray(pred))
        got.add_batch(torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_array_equal(got.confusion, want.confusion)
    for metric in ("pixel_accuracy", "pixel_accuracy_class", "mean_iou",
                   "fw_iou"):
        assert getattr(got, metric)() == getattr(want, metric)(), metric
    got.reset()
    assert got.confusion.sum() == 0


def test_fedseg_round_matches_jax():
    kw = dict(
        data=dict(dataset="fake_seg", num_clients=4, batch_size=8,
                  dataset_r=0.25, seed=0),
        model=dict(name="deeplab", num_classes=4, input_shape=(32, 32, 3),
                   extra=(("encoder_features", (8, 16)),)),
        train=dict(lr=0.05, epochs=1),
        fed=dict(algorithm="fedseg", num_rounds=1, clients_per_round=4))

    def cfg(m):
        return m.ExperimentConfig(data=m.DataConfig(**kw["data"]),
                                  model=m.ModelConfig(**kw["model"]),
                                  train=m.TrainConfig(**kw["train"]),
                                  fed=m.FedConfig(**kw["fed"]), seed=1)

    from fedml_tpu.experiments.harness import build_sim as jax_build_sim

    jsim = jax_build_sim(cfg(jc))
    max_n = jsim.arrays.max_client_samples

    def batch_orders(r, c):
        ckey = JR.client_key(JR.round_key(jsim.root_key, r), c)
        return [torch.from_numpy(o) for o in lane_orders(
            ckey, jsim.arrays.mask[c], 1, max_n)]

    tsim = build_sim(cfg(tc), "cpu")
    assert tsim.task.name == "segmentation"
    tsim.batch_orders = batch_orders
    tsim.sampler = lambda r, n, k: torch.arange(n)
    variables = flax_vars(jsim.model.module, jnp.zeros((1, 32, 32, 3)))
    jopt = jfed.make_server_optimizer("sgd", 1.0, 0.0)
    jvars = jax.tree.map(jnp.asarray, variables)
    jstate = jfed.ServerState(jvars, jopt.init(jvars["params"]),
                              jax.tree.map(jnp.zeros_like, jvars["params"]),
                              jnp.asarray(0, jnp.int32))
    tstate = tsim.init()._replace(
        variables=vision_state_dict(variables, "DeepLabLite"))
    jstate, jm = jsim.run_round(jstate)
    tstate, tm = tsim.run_round(tstate)
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **BAND)
    want = vision_state_dict(jax.device_get(jstate.variables), "DeepLabLite")
    for k in want:
        close(tstate.variables[k], want[k].numpy(), BAND, k)
    jev, tev = jsim.evaluate_global(jstate), tsim.evaluate_global(tstate)
    for k in ("loss", "acc"):
        np.testing.assert_allclose(tev[k], jev[k], **BAND)
    seg = SegEvaluator(4)
    seg.add_model(tsim.model, tstate.variables, tsim.arrays.test_x,
                  tsim.arrays.test_y)
    assert seg.confusion.sum() == tsim.arrays.test_y.numel()


def test_zoo_refusals_match_jax():
    for m, make in ((jc, jax_create_model), (tc, create_model)):
        cfg = m.ModelConfig(name="efficientnet-b9", num_classes=10,
                            input_shape=(32, 32, 3))
        with pytest.raises(ValueError, match="efficientnet-b0 .. "
                                             "efficientnet-b7"):
            make(cfg) if m is jc else make(cfg, "cpu")
