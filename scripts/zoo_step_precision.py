#!/usr/bin/env python3
"""Where MobileNetV3's float32 local step on the card leaves the CPU's.

    python3 scripts/zoo_step_precision.py

At chip_smoke.py phase 18 (f)'s inputs (the zoo's steps draw their
inputs in TINY_ZOO's order from one seeded generator), one local SGD step
of ``mobilenet_v3`` at width 0.25: every variable of the step on the CPU
and on the card, in float32 and float64, against the CPU's float64; the
train-mode logits of both devices in float32; the card's step in float32
with cuDNN off; the card's step with one conv at a time computed in
float64 (the rest float32); and isolated convolutions of the model's
shapes, card float32 against CPU float64. Needs the card; prints one
JSON line a measurement, each with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from fedml_tpu_torch.algorithms.base import (  # noqa: E402
    build_local_update,
    make_task,
)
from fedml_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.models.vision import Conv2d, same_padding  # noqa: E402

NAME = "mobilenet_v3"


def phase_inputs():
    """mobilenet_v3's step inputs as chip_smoke's topo_card_vs_cpu draws
    them (the models before it in TINY_ZOO draw first)."""
    rng = torch.Generator().manual_seed(1)
    for name, (shape, k, extra, task) in cs.TINY_ZOO.items():
        x = torch.randn((4,) + shape, generator=rng)
        if task == "tag_prediction":
            x = (x > 1.5).float()
            y = (torch.rand((4, k), generator=rng) < 0.1).float()
        else:
            y_shape = (4,) + shape[:2] if task == "segmentation" else (4,)
            y = torch.randint(0, k, y_shape, generator=rng,
                              dtype=torch.int32)
        if name == NAME:
            return ModelConfig(name=name, num_classes=k, input_shape=shape,
                               extra=extra), task, x, y
    raise KeyError(NAME)


def step(mcfg, task, x, y, device, dtype, model=None):
    """chip_smoke's ``zoo_step`` (one SGD step at lr 0.1 from the seeded
    initial variables), on ``model`` when one is given."""
    tcfg = TrainConfig(lr=0.1, epochs=1,
                       compute_dtype=str(dtype).split(".")[1])
    if model is None:
        run, start = cs.zoo_step(mcfg, task, tcfg, dtype, x.to(dtype), y,
                                 device)
        return run(start)
    lu = build_local_update(model, make_task(task), tcfg, 4, 4)
    start = {k: v.to(device, dtype) for k, v in model.init(
        torch.Generator().manual_seed(0)).items()}
    out, _, _ = lu(start, torch.arange(4, dtype=torch.int32, device=device),
                   torch.ones(4, device=device), x.to(device, dtype),
                   y.to(device), [torch.arange(4, device=device)])
    return {k: v.cpu() for k, v in out.items()}


def max_err(got, ref) -> float:
    return max((got[k].double() - ref[k]).abs().max().item() for k in ref)


def widened_forward(wide: str, names: dict):
    """Conv2d.forward with the conv named ``wide`` computed in float64
    (cuDNN off for it) and cast back."""
    base = Conv2d.forward

    def forward(self, x):
        if names.get(self) != wide:
            return base(self, x)
        (top, bottom), (left, right) = same_padding(
            x.shape[2:], self.kernel_size, self.stride, self.dilation)
        xp = F.pad(x.double(), (left, right, top, bottom))
        with torch.backends.cudnn.flags(enabled=False):
            return F.conv2d(xp, self.weight.double(), None, self.stride, 0,
                            self.dilation, self.groups).to(x.dtype)

    return forward


def main() -> int:
    if not torch.cuda.is_available():
        print("zoo_step_precision: no CUDA device", file=sys.stderr)
        return 1
    card = cs.environment()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mcfg, task, x, y = phase_inputs()
    ref = step(mcfg, task, x, y, "cpu", torch.float64)
    errs = {f"{dev}_{str(dt).split('.')[1]}": max_err(
        step(mcfg, task, x, y, dev, dt), ref)
        for dev in ("cpu", "cuda") for dt in (torch.float32, torch.float64)}
    with torch.backends.cudnn.flags(enabled=False):
        errs["cuda_float32_cudnn_off"] = max_err(
            step(mcfg, task, x, y, "cuda", torch.float32), ref)
    print(json.dumps({"step_vs_cpu_float64": errs, "device": card}),
          flush=True)

    logits = {}
    for dev in ("cpu", "cuda"):
        model = create_model(mcfg, dev)
        variables = {k: v.to(dev) for k, v in model.init(
            torch.Generator().manual_seed(0)).items()}
        logits[dev] = model.apply_train(variables, x.to(dev))[0].cpu()
    print(json.dumps({"train_logits_card_vs_cpu": (
        logits["cuda"] - logits["cpu"]).abs().max().item(), "device": card}),
        flush=True)

    module = create_model(mcfg, "cpu").module
    convs = [n for n, m in module.named_modules() if isinstance(m, Conv2d)]
    widened = {}
    base = Conv2d.forward
    for wide in convs:
        model = create_model(mcfg, "cuda")
        names = {m: n for n, m in model.module.named_modules()}
        Conv2d.forward = widened_forward(wide, names)
        try:
            widened[wide] = max_err(
                step(mcfg, task, x, y, "cuda", torch.float32, model), ref)
        finally:
            Conv2d.forward = base
    print(json.dumps({"step_with_one_conv_in_float64": widened,
                      "device": card}), flush=True)

    gen = torch.Generator().manual_seed(0)
    isolated = {}
    for name, m in module.named_modules():
        if not isinstance(m, Conv2d) or name not in ("stem", "blocks.0.dw",
                                                     "blocks.2.project"):
            continue
        size = {"stem": 32, "blocks.0.dw": 16, "blocks.2.project": 4}[name]
        xi = torch.randn((4, m.in_channels, size, size), generator=gen,
                         dtype=torch.float64)
        w = torch.randn(m.weight.shape, generator=gen, dtype=torch.float64)

        def grads(dev, dt, xi=xi, w=w, m=m):
            xx = xi.to(dev, dt).contiguous(
                memory_format=torch.channels_last).requires_grad_()
            ww = w.to(dev, dt).requires_grad_()
            out = F.conv2d(xx, ww, None, m.stride, m.kernel_size[0] // 2,
                           1, m.groups)
            go = torch.ones_like(out)
            return [t.double().cpu()
                    for t in torch.autograd.grad(out, (xx, ww), go)]

        rel = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(grads("cuda", torch.float32),
                               grads("cpu", torch.float64))]
        isolated[name] = {"dx_rel": rel[0], "dw_rel": rel[1]}
    print(json.dumps({"isolated_conv_grads_card_f32_vs_cpu_f64": isolated,
                      "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
