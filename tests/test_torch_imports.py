"""The port stands alone: it imports neither JAX (nor flax, optax) nor the
JAX package, and its entry points run on the CPU only when asked."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
from fedml_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    FedConfig,
    ModelConfig,
)
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.models import create_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")
SOURCES = sorted((ROOT / "fedml_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_round.py",
    ROOT / "scripts" / "resnet_parity_spread.py",
    ROOT / "scripts" / "time_torch_flash.py",
    ROOT / "scripts" / "cohort_band_loop.py"]


def _forbidden(module: str) -> bool:
    # "fedml_tpu_torch" shares a prefix with "fedml_tpu": compare the
    # first dotted component, not the string prefix
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_forbidden_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_import_and_forward_load_no_jax():
    script = """
import importlib, pkgutil, sys, torch
import fedml_tpu_torch
names = [m.name for m in pkgutil.walk_packages(fedml_tpu_torch.__path__,
                                               "fedml_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the defended round's, the bulk engine's, the harness's, the s2d
# models' and PEFT's modules are among them
assert {"fedml_tpu_torch.core.robust", "fedml_tpu_torch.core.adversary",
        "fedml_tpu_torch.core.compress", "fedml_tpu_torch.core.random",
        "fedml_tpu_torch.core.bulk", "fedml_tpu_torch.core.elastic",
        "fedml_tpu_torch.core.statebank",
        "fedml_tpu_torch.core.streamdef", "fedml_tpu_torch.core.fuse",
        "fedml_tpu_torch.utils.checkpoint",
        "fedml_tpu_torch.experiments.harness",
        "fedml_tpu_torch.models.s2d_exact", "fedml_tpu_torch.peft",
        "fedml_tpu_torch.peft.lora", "fedml_tpu_torch.peft.partition",
        "fedml_tpu_torch.peft.personal",
        "fedml_tpu_torch.data.natural", "fedml_tpu_torch.models.gan",
        "fedml_tpu_torch.algorithms.kd", "fedml_tpu_torch.algorithms.gan_core",
        "fedml_tpu_torch.algorithms.gan_family",
        "fedml_tpu_torch.algorithms.sgan"} <= set(names), names
from fedml_tpu_torch.config import ModelConfig
from fedml_tpu_torch.models import create_model
model = create_model(ModelConfig(name="transformer_lm", num_classes=37,
                                 input_shape=(16,)), device="cpu")
params = model.init(torch.Generator().manual_seed(0))
logits = model.apply_eval(params, torch.zeros(2, 16, dtype=torch.int32))
assert logits.shape == (2, 16, 37)
from fedml_tpu_torch.peft import LoRASpec, apply_lora
lora = apply_lora(model, LoRASpec())
params = lora.init(torch.Generator().manual_seed(0))
assert "blocks.0.q_proj.lora_a" in params
logits = lora.apply_eval(params, torch.zeros(2, 16, dtype=torch.int32))
assert logits.shape == (2, 16, 37)
model = create_model(ModelConfig(name="resnet8", num_classes=10,
                                 input_shape=(16, 16, 3)), device="cpu")
variables = model.init(torch.Generator().manual_seed(0))
logits, new_vars = model.apply_train(variables, torch.zeros(2, 16, 16, 3))
assert logits.shape == (2, 10) and set(new_vars) == set(variables)
for name, shape in (("resnet8_gn", (16, 16, 3)), ("char_lstm", (12,)),
                    ("resnet8_s2d", (16, 16, 3)),
                    ("resnet8_s2d_exact", (16, 16, 3))):
    model = create_model(ModelConfig(name=name, num_classes=90,
                                     input_shape=shape), device="cpu")
    variables = model.init(torch.Generator().manual_seed(0))
    x = torch.zeros((2,) + shape, dtype=model.input_dtype)
    assert model.apply_train(variables, x)[0].shape[-1] in (10, 90)
from fedml_tpu_torch.config import GanConfig
from fedml_tpu_torch.models.gan import generator_from_config
gen = generator_from_config(GanConfig(nz=8, ngf=4), 10, 28, 1, device="cpu")
gvars = gen.init(torch.Generator().manual_seed(0))
imgs = gen.apply_eval(gvars, torch.zeros(2, 8), gen.balanced_labels(2))
model = create_model(ModelConfig(name="cnn_medium", num_classes=10,
                                 input_shape=(28, 28, 1)), device="cpu")
variables = model.init(torch.Generator().manual_seed(0))
assert model.apply_eval(variables, imgs).shape == (2, 10)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "fedml_tpu")))
"""
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mcfg = ModelConfig(name="transformer_lm", num_classes=90,
                       input_shape=(80,))
    data = load_dataset(DataConfig(dataset="fake_shakespeare",
                                   num_clients=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(mcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.to_arrays()
    for fed in (FedConfig(), FedConfig(peft="lora", peft_personalize=True)):
        cfg = ExperimentConfig(model=mcfg, fed=fed)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FedAvgSim(create_model(mcfg, device="cpu"), data, cfg)
    assert create_model(mcfg, device="cpu").device.type == "cpu"


def test_cli_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from fedml_tpu_torch.experiments import run as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--algorithm", "fedavg", "--dataset", "fake_cifar10", "--model",
            "resnet8", "--input_shape", "32", "32", "3",
            "--client_num_in_total", "4"]
    cfg, args = cli.parse_args(argv)
    assert args.device == "cuda" and cfg.model.name == "resnet8"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)


def test_harness_needs_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    from fedml_tpu_torch.experiments.harness import Experiment, build_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=4),
        model=ModelConfig(name="lr", num_classes=10,
                          input_shape=(28, 28, 1)),
        out_dir=str(tmp_path), checkpoint_every=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sim(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Experiment(cfg).run()
    assert list(tmp_path.iterdir()) == []  # nothing written
    assert build_sim(cfg, "cpu").device.type == "cpu"


def test_fedgdkd_needs_cuda_unless_asked_for_cpu(monkeypatch):
    from fedml_tpu_torch.experiments.harness import build_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=4),
        model=ModelConfig(name="cnn_small", num_classes=10,
                          input_shape=(28, 28, 1)),
        fed=FedConfig(algorithm="fedgdkd"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sim(cfg)
    assert build_sim(cfg, "cpu").device.type == "cpu"


@pytest.mark.parametrize("algo", ["fedgan", "feddtg", "fedssgan",
                                  "feduagan"])
def test_gan_family_needs_cuda_unless_asked_for_cpu(monkeypatch, algo):
    from fedml_tpu_torch.experiments.harness import build_sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ExperimentConfig(
        data=DataConfig(dataset="fake_mnist", num_clients=4),
        model=ModelConfig(name="cnn_small", num_classes=10,
                          input_shape=(28, 28, 1)),
        fed=FedConfig(algorithm=algo))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sim(cfg)
    sim = build_sim(cfg, "cpu")
    assert sim.device.type == "cpu" and sim.gen.model.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("gen_optimizer", ["adam", "sgd"])
def test_fedgdkd_rounds_on_the_card_match_the_cpu(gen_optimizer):
    """chip_smoke.py phase 13 (c): two FedGDKD rounds at the CPU parity
    test's tiny configuration on the card (graph replays) and on the CPU
    (eager), from the same variables and draws; the check raises unless
    every leaf is within its band, or within the CPU's own spread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = chip_smoke.fedgdkd_card_vs_cpu("cuda", gen_optimizer)
    assert report["drift_corrected"] > 0, report


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["fedgan", "feddtg", "fedssgan",
                                  "feduagan"])
def test_gan_family_rounds_on_the_card_match_the_cpu(algo):
    """chip_smoke.py phase 14 (c): two rounds at the CPU parity test's
    configuration on the card (graph replays) and on the CPU (eager),
    from the same variables, draws and dropout masks; the check raises
    unless every leaf is within its band, or within the CPU's own
    spread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = chip_smoke.gan_family_card_vs_cpu(algo, "cuda")
    assert len(report["rounds"]) == 2, report
