"""The port's offline loaders and config against the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest

from fedml_tpu.config import DataConfig as JaxDataConfig
from fedml_tpu.config import ExperimentConfig as JaxExperimentConfig
from fedml_tpu.config import FedConfig as JaxFedConfig
from fedml_tpu.config import ModelConfig as JaxModelConfig
from fedml_tpu.config import TrainConfig as JaxTrainConfig
from fedml_tpu.data import partition as jax_partition
from fedml_tpu.data.loaders import load_dataset as jax_load_dataset
from fedml_tpu.data.loaders import (
    make_fake_image_dataset as jax_make_fake_image_dataset,
)
from fedml_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    ModelConfig,
    TrainConfig,
)
from fedml_tpu_torch.data import load_dataset, make_fake_image_dataset
from fedml_tpu_torch.data import partition
from fedml_tpu_torch.data.loaders import IMAGE_SPECS

FIELDS = ("x", "y", "idx", "mask", "counts", "test_x", "test_y", "test_idx",
          "test_mask")


@pytest.mark.parametrize("dataset", ["fake_shakespeare",
                                     "fake_stackoverflow_nwp"])
def test_fake_text_arrays_bitwise_equal(dataset):
    kw = dict(dataset=dataset, num_clients=7, batch_size=32, seed=3)
    ref = jax_load_dataset(JaxDataConfig(**kw)).to_arrays(pad_multiple=32)
    got = load_dataset(DataConfig(**kw)).to_arrays(pad_multiple=32,
                                                   device="cpu")
    _assert_arrays_equal(got, ref)


@pytest.mark.parametrize("dataset", ["synthetic", "synthetic_1_1",
                                     "synthetic_0.5_0.5"])
def test_synthetic_arrays_bitwise_equal(dataset):
    """LEAF's synthetic(alpha, beta) by name, the bulk bench's data."""
    kw = dict(dataset=dataset, num_clients=12, batch_size=8, seed=4)
    ref = jax_load_dataset(JaxDataConfig(**kw))
    got = load_dataset(DataConfig(**kw))
    for k, v in ref.train_idx_map.items():
        np.testing.assert_array_equal(got.train_idx_map[k], v)
        np.testing.assert_array_equal(got.test_idx_map[k],
                                      ref.test_idx_map[k])
        assert got.test_idx_map[k].dtype == ref.test_idx_map[k].dtype
    _assert_arrays_equal(got.to_arrays(pad_multiple=8, device="cpu"),
                         ref.to_arrays(pad_multiple=8))


def test_make_synthetic_bitwise_equal():
    """The bank bench's shards (16-32 samples a client)."""
    from fedml_tpu.data.loaders import make_synthetic as jax_make_synthetic
    from fedml_tpu_torch.data import make_synthetic

    kw = dict(alpha=0.5, beta=1.0, samples_low=16, samples_high=32, seed=2)
    ref = jax_make_synthetic(30, **kw).to_arrays(pad_multiple=8)
    got = make_synthetic(30, **kw).to_arrays(pad_multiple=8, device="cpu")
    assert got.max_client_samples == 32
    _assert_arrays_equal(got, ref)


def test_unported_dataset_raises(tmp_path):
    # the readers of files on disk are ported (tests/test_torch_natural_
    # data.py): a missing file raises FileNotFoundError naming where it
    # was looked for, and a name neither package has raises ValueError
    with pytest.raises(FileNotFoundError, match=str(tmp_path)):
        load_dataset(DataConfig(dataset="cifar10", data_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset(DataConfig(dataset="cifar11"))
    # the StackOverflow stand-in came with PEFT (ROADMAP item 12): it is
    # dispatched before the synthetic_<alpha>_<beta> family, not parsed as
    # one (tests/test_torch_peft.py holds it bitwise against the JAX
    # package's)
    data = load_dataset(DataConfig(dataset="synthetic_stackoverflow_nwp",
                                   num_clients=3))
    assert (data.task, data.num_classes, data.num_clients) == ("nwp", 10004,
                                                               3)


def _assert_arrays_equal(got, ref):
    assert got.num_classes == ref.num_classes
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)


@pytest.mark.parametrize("method,alpha,r", [
    ("homo", 0.5, 1.0), ("hetero", 0.1, 1.0), ("hetero", 0.5, 1.0),
    ("hetero", 5.0, 1.0), ("hetero", 0.5, 0.3), ("homo", 0.5, 0.3),
])
def test_partitions_bitwise_equal(method, alpha, r):
    """Train partitions (with the min-size retry loop at small alpha), the
    per-label test split and the class histograms."""
    y = np.random.default_rng(7).integers(0, 10, 3000).astype(np.int32)
    want = jax_partition.partition_indices_train(
        y, 10, method, 20, alpha, r, np.random.default_rng(1))
    got = partition.partition_indices_train(
        y, 10, method, 20, alpha, r, np.random.default_rng(1))
    assert got.keys() == want.keys()
    for c in want:
        assert got[c].dtype == want[c].dtype
        np.testing.assert_array_equal(got[c], want[c])
    assert min(len(v) for v in got.values()) >= partition.MIN_PARTITION_SIZE
    assert (partition.record_class_counts(y, got)
            == jax_partition.record_class_counts(y, want))
    t_want = jax_partition.partition_indices_test(y[:500], 10, 20)
    t_got = partition.partition_indices_test(y[:500], 10, 20)
    for c in t_want:
        np.testing.assert_array_equal(t_got[c], t_want[c])


@pytest.mark.parametrize("name", sorted(IMAGE_SPECS))
def test_fake_image_arrays_bitwise_equal(name):
    """Every fake image set at a small size, hetero: NHWC float32 images,
    int32 labels, the padded index maps."""
    kw = dict(dataset=f"fake_{name}", num_clients=6, batch_size=16, seed=2,
              partition_method="hetero", partition_alpha=0.5)
    ref = jax_make_fake_image_dataset(name, JaxDataConfig(**kw), 300, 60)
    got = make_fake_image_dataset(name, DataConfig(**kw), 300, 60)
    _assert_arrays_equal(got.to_arrays(pad_multiple=16, device="cpu"),
                         ref.to_arrays(pad_multiple=16))


def test_headline_cifar10_partition_bitwise_equal():
    """The headline configuration's data through load_dataset: fake_cifar10,
    100 clients, hetero alpha 0.5, batch 32."""
    kw = dict(dataset="fake_cifar10", num_clients=100, batch_size=32,
              partition_method="hetero", partition_alpha=0.5, seed=0)
    ref = jax_load_dataset(JaxDataConfig(**kw)).to_arrays(pad_multiple=32)
    got = load_dataset(DataConfig(**kw)).to_arrays(pad_multiple=32,
                                                   device="cpu")
    assert tuple(got.x.shape) == (6000, 32, 32, 3)
    _assert_arrays_equal(got, ref)


def test_bench_config_round_trips_through_both_packages():
    """bench.py's headline TrainConfig (bf16, scan_unroll, cohort_groups)
    written by the JAX package reads into the port and back unchanged."""
    jax_cfg = JaxExperimentConfig(
        data=JaxDataConfig(dataset="fake_cifar10", num_clients=100,
                           partition_method="hetero", batch_size=32),
        model=JaxModelConfig(name="resnet56", num_classes=10,
                             input_shape=(32, 32, 3)),
        train=JaxTrainConfig(lr=0.03, epochs=1, compute_dtype="bfloat16",
                             scan_unroll=64, cohort_groups=5,
                             cohort_fused=False),
        fed=JaxFedConfig(num_rounds=1000, clients_per_round=10))
    d = json.loads(jax_cfg.to_json())
    default = ExperimentConfig()
    ours = {sec: {f: d[sec][f] for f in dataclasses.asdict(
        getattr(default, sec))} for sec in ("data", "model", "train", "fed")}
    cfg = ExperimentConfig.from_dict(ours)
    assert cfg.train == TrainConfig(lr=0.03, epochs=1,
                                    compute_dtype="bfloat16", scan_unroll=64,
                                    cohort_groups=5, cohort_fused=False)
    back = JaxExperimentConfig.from_dict(json.loads(cfg.to_json()))
    assert back.train == jax_cfg.train


def test_config_json_round_trip_and_read_by_jax():
    cfg = ExperimentConfig(
        data=DataConfig(dataset="fake_shakespeare", num_clients=20),
        model=ModelConfig(name="transformer_lm", num_classes=90,
                          input_shape=(80,), extra=(("num_layers", 2),)),
        train=TrainConfig(lr=0.5, momentum=0.9),
        fed=FedConfig(num_rounds=3, gmf=0.5),
        seed=7,
    )
    d = json.loads(cfg.to_json())
    assert ExperimentConfig.from_dict(d) == cfg
    # the same file drives the JAX package, with the same values
    jax_cfg = JaxExperimentConfig.from_dict(d)
    for section in ("data", "model", "train", "fed"):
        ours = dataclasses.asdict(getattr(cfg, section))
        theirs = dataclasses.asdict(getattr(jax_cfg, section))
        assert {k: theirs[k] for k in ours} == ours, section
