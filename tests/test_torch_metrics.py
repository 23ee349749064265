"""The port's per-client metrics (metrics/observability.py) and FID
(metrics/fid.py) against the JAX package's, with weights converted and
the JAX package's random starts and batch orders replayed. Bands: the
per-client losses and accuracies rtol 1e-5, atol 1e-6 (float32 forwards
in another batching), the confusion counts, label tables, grids and the
FID math exact; the embeds' features rtol 1e-4, atol 1e-5 (float32
convolutions; the trained embed after 4 adam steps at fit's lr)."""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.config import DataConfig as JaxDataConfig
from fedml_tpu.config import ModelConfig as JaxModelConfig
from fedml_tpu.data import load_dataset as jax_load_dataset
from fedml_tpu.data.federated import FederatedData as JaxFederatedData
from fedml_tpu.metrics import fid as JF
from fedml_tpu.metrics import observability as JO
from fedml_tpu.metrics.sink import MetricsSink as JaxSink
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.config import DataConfig, ModelConfig
from fedml_tpu_torch.convert import fid_embed_state_dict, vision_state_dict
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data.federated import FederatedData
from fedml_tpu_torch.metrics import MetricsSink
from fedml_tpu_torch.metrics import fid as TF
from fedml_tpu_torch.metrics import observability as TO
from fedml_tpu_torch.models import create_model
from tests.torch_threads import one_torch_thread  # noqa: F401

EVAL = dict(rtol=1e-5, atol=1e-6)
EMBED = dict(rtol=1e-4, atol=1e-5)
K = 5
COUNTS = (9, 3, 0, 6)  # client 2 has no train rows


def _data(shape=(8, 8, 3), seed=0):
    """The same arrays in both packages' containers: uneven clients, one
    empty, a test split that overlaps between clients."""
    rng = np.random.default_rng(seed)
    n = sum(COUNTS)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.int32)
    xt = rng.standard_normal((7,) + shape).astype(np.float32)
    yt = rng.integers(0, K, 7).astype(np.int32)
    starts = np.cumsum((0,) + COUNTS)
    tr = {i: np.arange(starts[i], starts[i + 1]) for i in range(4)}
    te = {0: np.arange(0, 4), 1: np.arange(2, 7), 2: np.arange(1, 3),
          3: np.arange(5, 7)}
    args = (x, y, xt, yt, tr, te, K)
    return JaxFederatedData(*args), FederatedData(*args)


MODELS = {  # name: (input shape, the converter's arch)
    "lr": ((8, 8, 3), "LogisticRegression"),
    "cnn": ((12, 12, 1), "CNNDropOut"),
    "resnet8": ((8, 8, 3), "ResNetCIFAR"),
}


def _models(name, seed=1):
    shape, arch = MODELS[name]
    kw = dict(name=name, num_classes=K, input_shape=shape)
    jmodel = jax_create_model(JaxModelConfig(**kw))
    variables = jax.jit(jmodel.init)(jax.random.key(seed))
    if name == "resnet8":  # running statistics away from their start
        variables = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 * jnp.abs(jax.random.normal(
                jax.random.key(len(str(p))), v.shape))
            if "batch_stats" in str(p[0]) else v, variables)
    return (jmodel, variables, create_model(ModelConfig(**kw), "cpu"),
            vision_state_dict(jax.device_get(variables), arch))


def _assert_eval_equal(got, want):
    for k in ("acc", "loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **EVAL)
    np.testing.assert_array_equal(got["count"].numpy(),
                                  np.asarray(want["count"]))
    np.testing.assert_array_equal(got["confusion"].numpy(),
                                  np.asarray(want["confusion"]))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_per_client_eval_matches_jax(name):
    jdata, tdata = _data(MODELS[name][0])
    ja, ta = jdata.to_arrays(), tdata.to_arrays(device="cpu")
    jmodel, jvars, tmodel, tvars = _models(name)
    jev = JO.build_per_client_eval(jmodel, K, batch_size=4)
    tev = TO.build_per_client_eval(tmodel, K, batch_size=4)
    for split in (("x", "y", "idx", "mask"),
                  ("test_x", "test_y", "test_idx", "test_mask")):
        want = jev(jvars, *(getattr(ja, f) for f in split))
        got = tev(tvars, *(getattr(ta, f) for f in split))
        _assert_eval_equal(got, want)
        # every real row lands in exactly one confusion cell
        assert got["confusion"].sum() == getattr(ta, split[3]).sum()


def test_stacked_per_client_eval_matches_jax():
    """Per-client models: the variables' leading client axis."""
    jdata, tdata = _data()
    ja, ta = jdata.to_arrays(), tdata.to_arrays(device="cpu")
    jmodel, _, tmodel, _ = _models("lr")
    stack = jax.vmap(jmodel.init)(jax.random.split(jax.random.key(4), 4))
    tstack = vision_state_dict(jax.device_get(stack), "LogisticRegression",
                               lead=1)
    want = JO.build_per_client_eval(jmodel, K, stacked=True)(
        stack, ja.x, ja.y, ja.idx, ja.mask)
    got = TO.build_per_client_eval(tmodel, K, stacked=True)(
        tstack, ta.x, ta.y, ta.idx, ta.mask)
    _assert_eval_equal(got, want)


def test_confusion_matrix_matches_jax():
    rng = np.random.default_rng(2)
    y, pred = rng.integers(0, K, 30), rng.integers(0, K, 30)
    w = (rng.random(30) < 0.7).astype(np.float32)
    for weights in (None, w):
        want = JO.confusion_matrix(jnp.asarray(pred), jnp.asarray(y), K,
                                   None if weights is None
                                   else jnp.asarray(weights))
        got = TO.confusion_matrix(torch.tensor(pred), torch.tensor(y), K,
                                  None if weights is None
                                  else torch.tensor(weights))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dataset", ["fake_mnist", "fake_stackoverflow_lr"])
def test_label_distribution_matches_jax(dataset):
    """Single-label and multi-hot (the label mass a class)."""
    kw = dict(dataset=dataset, num_clients=5, seed=2)
    want = JO.label_distribution(
        jax_load_dataset(JaxDataConfig(**kw)).to_arrays())
    got = TO.label_distribution(
        load_dataset(DataConfig(**kw)).to_arrays(device="cpu"))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_log_per_client_observability_matches_jax(tmp_path):
    jdata, tdata = _data()
    ja, ta = jdata.to_arrays(), tdata.to_arrays(device="cpu")
    jmodel, jvars, tmodel, tvars = _models("resnet8")
    want = JO.log_per_client_observability(
        JaxSink(str(tmp_path / "j.jsonl")), jmodel, jvars, ja, 3, prefix="p/")
    sink = MetricsSink(str(tmp_path / "t.jsonl"))
    got = TO.log_per_client_observability(sink, tmodel, tvars, ta, 3,
                                          prefix="p/")
    assert list(got) == list(want) and sink.history[-1]["round"] == 3
    for k, v in want.items():
        if k.endswith(("confusion_test", "label_distribution")):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, err_msg=k, **EVAL)
    short = TO.log_per_client_observability(sink, tmodel, tvars, ta, 4,
                                            include_confusion=False)
    assert "confusion_test" not in short and "Client 3/Test/Loss" in short


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------


class _JaxRandomNet(nn.Module):
    """The JAX package's random embed, ``fedml_tpu/metrics/fid.py``
    ``_RandomConvEmbed``: its variables are flax's draw from the seed."""
    dim: int = 64

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Conv(32, (3, 3), strides=(2, 2))(x))
        h = nn.relu(nn.Conv(64, (3, 3), strides=(2, 2))(h))
        return nn.Dense(self.dim)(jnp.mean(h, axis=(1, 2)))


class _JaxTrainedNet(nn.Module):
    """``TrainedCNNEmbed.fit``'s network."""
    dim: int
    k: int

    @nn.compact
    def __call__(self, x):
        h = nn.relu(nn.Conv(32, (3, 3), strides=(2, 2))(x))
        h = nn.relu(nn.Conv(64, (3, 3), strides=(2, 2))(h))
        feat = nn.Dense(self.dim, name="feat")(jnp.mean(h, axis=(1, 2)))
        return feat, nn.Dense(self.k, name="cls")(nn.relu(feat))


def _images(n, hw=12, c=3, seed=5):
    rng = np.random.default_rng(seed)
    return rng.random((n, hw, hw, c)).astype(np.float32)


def test_fid_math_matches_jax():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((50, 6))
    b = rng.standard_normal((40, 6)) * 1.3 + 0.2
    for f in (a, b, a[:, :1]):
        for g, w in zip(TF.activation_statistics(f),
                        JF.activation_statistics(f)):
            np.testing.assert_array_equal(g, w)
    stats = [*TF.activation_statistics(a), *TF.activation_statistics(b)]
    assert TF.frechet_distance(*stats) == JF.frechet_distance(*stats) > 0
    same = [*TF.activation_statistics(a), *TF.activation_statistics(a)]
    assert TF.frechet_distance(*same) == JF.frechet_distance(*same)
    assert TF.frechet_distance(*same) < 1e-9


def test_random_embed_on_jax_start_matches_jax():
    x = _images(10)
    jvars = _JaxRandomNet(16).init(jax.random.key(3), jnp.zeros((1, 12, 12,
                                                                  3)))
    want = np.asarray(JF._RandomConvEmbed(dim=16, seed=3)(jnp.asarray(x)))
    embed = TF.RandomConvEmbed(dim=16, device="cpu",
                               start=fid_embed_state_dict(jvars))
    got = embed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **EMBED)
    # the default: the port's own seeded draw (a stated divergence), the
    # same on every call
    a = TF.RandomConvEmbed(dim=16, seed=3, device="cpu")
    b = TF.RandomConvEmbed(dim=16, seed=3, device="cpu")
    assert torch.equal(a(torch.from_numpy(x)), b(torch.from_numpy(x)))
    assert set(a.variables) == set(embed.variables)


def test_trained_embed_on_jax_start_and_orders_matches_jax():
    x = _images(40, c=1)
    y = np.random.default_rng(7).integers(0, 3, 40)
    kw = dict(num_classes=3, dim=8, epochs=2, batch_size=16, seed=2)
    want = JF.TrainedCNNEmbed.fit(x, y, **kw)(x[:12])
    key = jax.random.key(2)
    start = _JaxTrainedNet(8, 3).init(key, jnp.asarray(x[:1]))

    def perms(e, n):
        return torch.tensor(np.asarray(jax.random.permutation(
            jax.random.fold_in(key, e + 1), n)))

    got = TF.TrainedCNNEmbed.fit(x, y, device="cpu",
                                 start=fid_embed_state_dict(start),
                                 perms=perms, **kw)
    np.testing.assert_allclose(got(torch.from_numpy(x[:12])).numpy(),
                               want, **EMBED)
    # the start moved: the embed trained
    moved = TF.TrainedCNNEmbed.fit(x, y, device="cpu", **kw)
    unmoved = TF.TrainedCNNEmbed.fit(x, y, device="cpu",
                                     **{**kw, "epochs": 0})
    assert not torch.equal(moved.variables["feat.weight"],
                           unmoved.variables["feat.weight"])


def test_sample_grid_is_the_jax_grid():
    for n in (64, 10):
        imgs = _images(n, hw=4)
        np.testing.assert_array_equal(TF.sample_grid(imgs),
                                      JF.sample_grid(imgs))
    imgs = _images(6, hw=3, c=1)
    np.testing.assert_array_equal(TF.sample_grid(imgs, 2, 3),
                                  JF.sample_grid(imgs, 2, 3))


class _Tiny(torch.nn.Module):
    def forward(self, x):
        return torch.nn.functional.avg_pool2d(x, 4) * 2.0 + 1.0


def test_torchscript_embed_matches_jax(tmp_path):
    path = str(tmp_path / "embed.pt")
    torch.jit.script(_Tiny()).save(path)
    for c in (1, 3):
        x = _images(5, hw=6, c=c)
        want = JF.TorchScriptEmbed(path, input_hw=8)(x)
        got = TF.TorchScriptEmbed(path, input_hw=8, device="cpu")(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_make_fid_scorer_precedence(tmp_path, monkeypatch):
    path = str(tmp_path / "embed.pt")
    torch.jit.script(_Tiny()).save(path)
    monkeypatch.delenv("FEDML_TPU_INCEPTION", raising=False)
    x, y = _images(16), np.arange(16) % 2
    s = TF.make_fid_scorer(path, train_data=(x, y), device="cpu")
    assert isinstance(s.embed_fn, TF.TorchScriptEmbed)
    monkeypatch.setenv("FEDML_TPU_INCEPTION", path)
    s = TF.make_fid_scorer(train_data=(x, y), device="cpu")
    assert isinstance(s.embed_fn, TF.TorchScriptEmbed)
    monkeypatch.delenv("FEDML_TPU_INCEPTION")
    s = TF.make_fid_scorer(train_data=(x, y), device="cpu")
    assert isinstance(s.embed_fn, TF.TrainedCNNEmbed)
    s = TF.make_fid_scorer(device="cpu", batch_size=7)
    assert isinstance(s.embed_fn, TF.RandomConvEmbed) and s.batch_size == 7
    missing = str(tmp_path / "nope.pt")
    with pytest.raises(FileNotFoundError) as terr:
        TF.make_fid_scorer(missing, train_data=(x, y), device="cpu")
    with pytest.raises(FileNotFoundError) as jerr:
        JF.make_fid_scorer(missing)
    assert str(terr.value) == str(jerr.value)
    monkeypatch.setenv("FEDML_TPU_INCEPTION", missing)
    with pytest.raises(FileNotFoundError, match="nope.pt"):
        TF.make_fid_scorer(device="cpu")


class _StubSim:
    """What ``log_gan_round`` reads of a GAN sim: ``sample_images``,
    ``arrays.test_x`` and the device."""

    def __init__(self, fake, real, as_torch):
        self.fake = fake
        self.device = torch.device("cpu")
        self.arrays = type("A", (), {"test_x": torch.from_numpy(real)
                                     if as_torch else jnp.asarray(real)})
        self.as_torch = as_torch

    def sample_images(self, state, n, seed=0):
        out = self.fake[:n] + 0.01 * seed
        return torch.from_numpy(out) if self.as_torch else jnp.asarray(out)


def test_log_gan_round_matches_jax(tmp_path):
    fake, real = _images(64, hw=4, seed=8), _images(300, hw=4, seed=9)

    def flat(x):
        return np.asarray(x).reshape(len(x), -1)[:, :6]

    records = []
    for pkg, sink_cls, as_torch in ((TF, MetricsSink, True),
                                    (JF, JaxSink, False)):
        d = tmp_path / ("t" if as_torch else "j")
        sink = sink_cls(str(d / "m.jsonl"))
        rec = pkg.log_gan_round(sink, _StubSim(fake, real, as_torch), None,
                                2, scorer=pkg.FIDScorer(flat, 32, **(
                                    {"device": "cpu"} if as_torch else {})),
                                extra={"g_loss": 1.5})
        records.append(rec)
    got, want = records
    assert set(got) == set(want)
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-6)
    assert got["fid"] > 0 and got["g_loss"] == 1.5
    assert os.path.basename(got["sample_grid"]) == "gan_samples_r00002.npy"
    np.testing.assert_array_equal(np.load(got["sample_grid"]),
                                  np.load(want["sample_grid"]))
