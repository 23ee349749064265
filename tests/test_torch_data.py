"""The port's offline loaders and config against the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest

from fedml_tpu.config import DataConfig as JaxDataConfig
from fedml_tpu.config import ExperimentConfig as JaxExperimentConfig
from fedml_tpu.data.loaders import load_dataset as jax_load_dataset
from fedml_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    ModelConfig,
    TrainConfig,
)
from fedml_tpu_torch.data import load_dataset

FIELDS = ("x", "y", "idx", "mask", "counts", "test_x", "test_y", "test_idx",
          "test_mask")


@pytest.mark.parametrize("dataset", ["fake_shakespeare",
                                     "fake_stackoverflow_nwp"])
def test_fake_text_arrays_bitwise_equal(dataset):
    kw = dict(dataset=dataset, num_clients=7, batch_size=32, seed=3)
    ref = jax_load_dataset(JaxDataConfig(**kw)).to_arrays(pad_multiple=32)
    got = load_dataset(DataConfig(**kw)).to_arrays(pad_multiple=32,
                                                   device="cpu")
    assert got.num_classes == ref.num_classes
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f).numpy()
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)


def test_unported_dataset_raises():
    with pytest.raises(ValueError, match="not ported"):
        load_dataset(DataConfig(dataset="fake_cifar10"))


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
