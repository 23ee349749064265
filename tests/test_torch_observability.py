"""The observability planes of the port (fedml_tpu_torch/core/tracing.py,
telemetry.py, perf.py, memscope.py, slo.py, export.py, anatomy.py) held
against the JAX package's on the same inputs, on the CPU.

- **Breakdown**: the JAX package's synthetic capture events, each also
  written as a torch Chrome-trace event and read back through the port's
  loader, give the same breakdown dicts exactly; a real CPU capture of a
  round has device ops inside its window.
- **Registry**, **OpenMetrics**, **SLO**, **anatomy**, **perf monitor**:
  the same calls (and clocks) give equal snapshots, text, gauges,
  transitions and ring entries (percentiles at rel 1e-12).
- **FLOPs**: ``useful_round_cost`` of the port's simulation against the
  JAX package's at ``tests/test_perf.py``'s tiny configuration: rel 0.01
  for lr, rel 0.10 for cnn_fedavg and resnet8 (XLA's count adds its
  elementwise work); the in-input convolution formula against a hand
  count; the count linear in the cohort.
- **Vocabulary**: one tiny FedAvg run on each package with every plane
  on writes the same metric names, but for the JAX package's XLA-only
  ``mem.program.*`` fields and ``mem.donation_*``.
- **Off is inert** and **the CLI**: the planes change no result, bit for
  bit, and record nothing when off; the CLI's flags write the artifacts
  and serve the listener.
"""

import dataclasses
import json
import math
import urllib.request

import numpy as np
import pytest
import torch

import fedml_tpu.config as jc
import fedml_tpu_torch.config as tc
from fedml_tpu.core import anatomy as JA
from fedml_tpu.core import export as JE
from fedml_tpu.core import perf as JP
from fedml_tpu.core import slo as JS
from fedml_tpu.core import telemetry as JT
from fedml_tpu_torch.algorithms.fedavg import FedAvgSim
from fedml_tpu_torch.core import anatomy as A
from fedml_tpu_torch.core import export as E
from fedml_tpu_torch.core import memscope as M
from fedml_tpu_torch.core import perf as P
from fedml_tpu_torch.core import slo as S
from fedml_tpu_torch.core import telemetry as T
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.experiments import run as cli
from fedml_tpu_torch.metrics import MetricsSink
from fedml_tpu_torch.models import create_model
from tests.test_export import strict_parse
from tests.torch_threads import one_torch_thread  # noqa: F401

# the FLOP count's bands against XLA's (XLA adds a little elementwise
# work to the products and convolutions that FlopCounterMode counts)
FLOP_BANDS = {"lr": 0.01, "cnn_fedavg": 0.10, "resnet8": 0.10}
PCT_RTOL = 1e-12


@pytest.fixture(autouse=True)
def planes_off():
    """Every test starts and ends with both packages' planes off."""
    yield
    T.shutdown()
    JT.shutdown()


# ---------------------------------------------------------------------------
# the device-time breakdown
# ---------------------------------------------------------------------------


def _jev(name, ts, dur, pid=1, process="/device:TPU:0", tid=0, args=None):
    return {"name": name, "pid": pid, "tid": tid, "ts": float(ts),
            "dur": float(dur), "process": process, "args": args or {}}


def _tev(name, ts, dur, cat, pid=4242, tid=0, args=None):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": float(ts), "dur": float(dur), "args": args or {}}


def _kernel(name, ts, dur, stream=7, cat="kernel"):
    return _tev(name, ts, dur, cat, pid=0, tid=stream,
                args={"device": 0, "stream": stream})


_META = [{"ph": "M", "name": "process_name", "pid": 4242,
          "args": {"name": "python3"}},
         {"ph": "M", "name": "process_name", "pid": 0,
          "args": {"name": "GPU 0"}}]

# (the JAX package's synthetic events, tests/test_perf.py; the same
# events in torch's Chrome-trace form: a kernel for an XLA fusion, an
# NCCL kernel for a collective, a memcpy for a copy, a CUDA runtime wait
# for a host await, top-level CPU operators for the CPU backend's ops)
BREAKDOWN_CASES = {
    "four_way_split": (
        [_jev("fusion.1", 0, 40), _jev("all-reduce.2", 40, 20),
         _jev("copy-start.3", 60, 10),
         _jev("ThreadpoolListener::Record", 0, 90, pid=9,
              process="/host:CPU")],
        [_kernel("void fusion_kernel<float>()", 0, 40),
         _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 40, 20),
         _kernel("Memcpy DtoD (Device -> Device)", 60, 10,
                 cat="gpu_memcpy"),
         _tev("ThreadpoolListener::Record", 0, 90, "python_function")],
        100e-6),
    "parallel_lanes": (
        [_jev("all-reduce.1", 0, 10, tid=1), _jev("copy.2", 0, 10, tid=2),
         _jev("fusion.3", 0, 10, tid=3)],
        [_kernel("ncclDevKernel_AllReduce_Sum_f32", 0, 10, stream=1),
         _kernel("Memset (Device)", 0, 10, stream=2, cat="gpu_memset"),
         _kernel("elementwise_kernel", 0, 10, stream=3)],
        20e-6),
    "union": (
        [_jev("fusion.1", 0, 50), _jev("dot.2", 25, 50)],
        [_kernel("fusion_kernel", 0, 50, stream=7),
         _kernel("sm90_xmma_gemm_bf16", 25, 50, stream=8)],
        100e-6),
    "cpu_ops_and_host_block": (
        [_jev("dot.3", 0, 30, pid=7, process="/host:CPU",
              args={"hlo_op": "dot.3"}),
         _jev("reduce.8", 10, 30, pid=7, process="/host:CPU",
              args={"hlo_op": "reduce.8"}),
         _jev("TfrtCpuBuffer::Await", 20, 40, pid=7, process="/host:CPU"),
         _jev("ParseArguments", 0, 5, pid=7, process="/host:CPU")],
        [_tev("aten::mm", 0, 30, "cpu_op", tid=1),
         _tev("aten::sum", 10, 30, "cpu_op", tid=2),
         _tev("cudaStreamSynchronize", 20, 40, "cuda_runtime", tid=3),
         _tev("ProfilerStep#0", 0, 5, "user_annotation", tid=3)],
        100e-6),
    "empty": ([], [], 1e-3),
}


@pytest.mark.parametrize("case", sorted(BREAKDOWN_CASES))
def test_breakdown_matches_jax(case):
    jax_events, torch_events, window = BREAKDOWN_CASES[case]
    want = JP.device_time_breakdown(jax_events, window_s=window)
    events = P.normalize_trace({"traceEvents": _META + torch_events})
    assert P.device_time_breakdown(events, window_s=window) == want


def test_loader_reads_a_written_trace(tmp_path):
    """``load_trace_events`` finds ``*.pt.trace.json`` (plain or gzip)
    under a capture directory, as ``export_chrome_trace`` writes it."""
    import gzip

    _, torch_events, window = BREAKDOWN_CASES["four_way_split"]
    d = tmp_path / "round0"
    d.mkdir()
    with gzip.open(d / "rank0.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": _META + torch_events}, f)
    events = P.load_trace_events(str(tmp_path))
    assert len(events) == 4
    assert {e["process"] for e in events} == {"/device:GPU:0", "python3"}
    assert P.device_time_breakdown(events, window)["collective_s"] == \
        pytest.approx(20e-6)
    # only a thread's top-level operators are ops: a nested one is not
    ops = P.normalize_trace({"traceEvents": [
        _tev("aten::linear", 0, 30, "cpu_op"),
        _tev("aten::addmm", 2, 10, "cpu_op"),
        _tev("aten::relu", 30, 5, "cpu_op")]})
    assert [P.OP_ARG in e["args"] for e in ops] == [True, False, True]


def _tiny_cfg(m, model="lr", cpr=2, rounds=2, **fed):
    """tests/test_perf.py's ``_tiny_sim`` configuration, in either
    package's config classes."""
    return m.ExperimentConfig(
        data=m.DataConfig(dataset="fake_mnist", num_clients=4,
                          batch_size=16, seed=0),
        model=m.ModelConfig(name=model, num_classes=10,
                            input_shape=(28, 28, 1)),
        train=m.TrainConfig(lr=0.1, epochs=1),
        fed=m.FedConfig(num_rounds=rounds, clients_per_round=cpr,
                        eval_every=10**9, **fed),
        seed=0)


def _port_sim(cfg):
    return FedAvgSim(create_model(cfg.model, "cpu"), load_dataset(cfg.data),
                     cfg, device="cpu")


def _jax_sim(cfg):
    from fedml_tpu.algorithms.fedavg import FedAvgSim as JaxSim
    from fedml_tpu.data.loaders import load_dataset as jax_load
    from fedml_tpu.models import create_model as jax_model

    return JaxSim(jax_model(cfg.model), jax_load(cfg.data), cfg)


def test_round_profiler_real_cpu_capture(tmp_path):
    """A torch.profiler window around one CPU round: the breakdown has
    the round's top-level operators inside its window; the budget of one
    window leaves the second round uncaptured."""
    T.configure(telemetry_dir=str(tmp_path / "t"), trace=False)
    sim = _port_sim(_tiny_cfg(tc))
    state = sim.init()
    prof = P.RoundProfiler(1, str(tmp_path), tag="rank0")
    for r in range(2):
        prof.start_round(r)
        state, m = sim.run_round(state)
        assert math.isfinite(float(m["train_loss"]))
        prof.end_round(r)
    data = json.load(open(prof.finish()))
    (bd,) = data["rounds"]
    assert bd["round"] == 0 and bd["device_planes"] is False
    assert bd["n_device_ops"] > 0, bd
    assert 0 < bd["device_busy_s"] <= bd["window_s"]
    rdir = tmp_path / "torch_profile" / "round0"
    assert json.load(open(rdir / "capture.json"))["round"] == 0
    assert (rdir / "rank0.pt.trace.json").exists()
    assert "perf.profile.compute_frac" in T.METRICS.snapshot()["gauges"]
    assert [e["kind"] for e in T.RECORDER.events()] == [
        "mem_program", "perf_profile"]  # round 0 built the step program


# ---------------------------------------------------------------------------
# the registry, OpenMetrics, the SLO engine, the anatomy ring, the monitor
# ---------------------------------------------------------------------------


def _feed(reg, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(400):
        v = float(rng.lognormal(-3, 3))
        kind = i % 5
        if kind == 0:
            reg.inc(f"c.{i % 7}", float(rng.integers(1, 5)))
        elif kind == 1:
            reg.gauge(f"g.{i % 3}", v)
        elif kind == 2:
            reg.gauge_labeled("fam", f"peer{i % 11}", v)
        else:
            reg.observe(f"h.{i % 4}", v)
    for v in (0.0, 1e-9, 3e9, 2.0 ** -20, 2.0 ** 20, 7.25, 7.25):
        reg.observe("h.edges", v)
    reg.observe("h.one", 0.3)


def _assert_snapshots_equal(got, want):
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert set(got["histograms"]) == set(want["histograms"])
    for name, h in want["histograms"].items():
        g = got["histograms"][name]
        for k, v in h.items():
            if k in ("p50", "p95", "p99"):
                assert g[k] == pytest.approx(v, rel=PCT_RTOL), (name, k)
            else:
                assert g[k] == v, (name, k)


def test_registry_snapshot_matches_jax():
    got, want = T.MetricsRegistry(label_cap=4), JT.MetricsRegistry(
        label_cap=4)
    _feed(got)
    _feed(want)
    _assert_snapshots_equal(got.snapshot(), want.snapshot())
    assert got.counter("telemetry.label_overflow") > 0
    for h in want.snapshot()["histograms"].values():
        for q in ((0.5,), (0.1, 0.9, 0.999)):
            p = T.percentiles_from_histogram(h, q)
            j = JT.percentiles_from_histogram(h, q)
            assert p.keys() == j.keys()
            for k in j:
                assert p[k] == pytest.approx(j[k], rel=PCT_RTOL)
    off = T.MetricsRegistry(enabled=False)
    _feed(off)
    assert off.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


def test_openmetrics_text_matches_jax_and_parses():
    got, want = T.MetricsRegistry(label_cap=4), JT.MetricsRegistry(
        label_cap=4)
    _feed(got, seed=1)
    _feed(want, seed=1)
    snap = want.snapshot()
    text = E.render_openmetrics(snap)
    assert text == JE.render_openmetrics(snap)
    assert E.render_openmetrics(got.snapshot()) == text
    parsed = strict_parse(text)
    assert parsed["types"]["h_edges"] == "histogram"


SLO_SPECS = ("perf.round_wall_s:p99<0.5@10s", "perf.round_wall_s:mean<0.4@5s",
             "perf.round_wall_s:max<1.0@20s", "queue.depth:value<3@5s",
             "errors:rate<0.2@10s", "perf.round_wall_s:p50>0.01@1m")


def _slo_timeline(registry, engine):
    rng = np.random.default_rng(3)
    for t in range(60):
        slow = 20 <= t < 32
        for _ in range(3):
            registry.observe("perf.round_wall_s",
                             float(rng.uniform(0.6, 2.0) if slow
                                   else rng.uniform(0.05, 0.3)))
        registry.gauge("queue.depth", float(t % 6))
        if 25 <= t < 40:
            registry.inc("errors", 2.0)
        engine.tick(now=1000.0 + t)


def test_slo_engine_matches_jax():
    regs = T.MetricsRegistry(), JT.MetricsRegistry()
    recs = T.FlightRecorder(enabled=True), JT.FlightRecorder(enabled=True)
    specs = S.parse_specs(SLO_SPECS, scope="job"), JS.parse_specs(
        SLO_SPECS, scope="job")
    assert [s.slug for s in specs[0]] == [s.slug for s in specs[1]]
    engines = (S.SloEngine(specs[0], regs[0], recorder=recs[0]),
               JS.SloEngine(specs[1], regs[1], recorder=recs[1]))
    seen = ([], [])
    for eng, out in zip(engines, seen):
        eng.add_transition_listener(
            lambda spec, b, v, out=out: out.append((spec.slug, b, v)))
        _slo_timeline(eng._registry, eng)
    _assert_snapshots_equal(regs[0].snapshot(), regs[1].snapshot())
    assert seen[0] == seen[1] and seen[0]

    def events(rec):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in list(rec._ring)]

    assert events(recs[0]) == events(recs[1])
    assert engines[0].verdicts() == engines[1].verdicts()
    with pytest.raises(ValueError, match="malformed --slo"):
        S.SloSpec.parse("perf.round_wall_s<2")


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _anatomy_feed(anat, clock):
    anat.begin_round(0, path="stacked")
    clock.t += 0.25
    anat.phase("local", 0.2)
    anat.phase("eval", 0.01)
    anat.phase("local", 0.015)
    anat.end_round()
    anat.begin_round(1, path="fused", rounds=4)
    anat.phase("local", 1.5)
    anat.end_round(wall_s=2.0)
    anat.amend_last("eval", 0.3)
    anat.begin_round(5, path="bulk")
    clock.t += 0.125
    anat.end_round()
    anat.end_round()  # nothing open: nothing recorded
    for bad in (lambda: anat.phase("nope", 1.0),
                lambda: anat.amend_last("nope", 1.0)):
        with pytest.raises(ValueError, match="unknown anatomy phase"):
            bad()


def test_anatomy_ring_matches_jax(monkeypatch):
    import time

    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(time, "time", clock)
    T.configure(trace=False)
    JT.configure(trace=False)
    rings = []
    for cls in (A.RoundAnatomy, JA.RoundAnatomy):
        anat = cls(ring_capacity=2)
        anat.enabled = True
        clock.t = 100.0
        _anatomy_feed(anat, clock)
        rings.append(anat.tracez(rank=3))
    assert rings[0] == rings[1]
    assert len(rings[0]["entries"]) == 2 and rings[0]["rounds"] == 3
    for e in rings[0]["entries"]:
        assert sum(e["phases"].values()) == pytest.approx(e["wall_s"],
                                                          abs=1e-12)
    _assert_snapshots_equal(T.METRICS.snapshot(), JT.METRICS.snapshot())
    off = A.RoundAnatomy()
    off.begin_round(0)
    off.phase("nope", 1.0)  # off: not even checked
    assert off.end_round() is None and off.tracez()["entries"] == []


MONITOR_FEED = [("round", 30.0), ("round", 0.5), ("round", 0.4),
                ("block", 2.0, 4, False), ("block", 9.0, 4, True),
                ("round", 0.0), ("block", 0.3, 3, False),
                ("round", 2e-5), ("round", 0.25)]


@pytest.mark.parametrize("flops,peak", [(1e9, 1e12), (None, 1e12),
                                        (5e6, 1e12)])
def test_perf_monitor_matches_jax(tmp_path, flops, peak):
    T.configure(trace=False)
    JT.configure(trace=False)
    T.RECORDER.enabled = JT.RECORDER.enabled = True
    mons = (P.PerfMonitor(flops_per_round=flops, peak_flops=peak),
            JP.PerfMonitor(flops_per_round=flops, peak_flops=peak))
    for mon in mons:
        for item in MONITOR_FEED:
            if item[0] == "round":
                mon.note_round(item[1])
            else:
                mon.note_block(item[1], item[2], compiled=item[3])
    _assert_snapshots_equal(T.METRICS.snapshot(), JT.METRICS.snapshot())
    assert (mons[0].rounds, mons[0].mfu, mons[0]._flagged) == \
        (mons[1].rounds, mons[1].mfu, mons[1]._flagged)

    def events(rec):
        return [{k: v for k, v in e.items() if k not in ("ts", "note")}
                for e in list(rec._ring)]

    assert events(T.RECORDER) == events(JT.RECORDER)


def test_peaks_name_the_h100():
    assert P.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert P.PEAKS["NVIDIA H100 80GB HBM3"][2] == 80e9
    assert P.device_peak_flops("unknown card") is None


# ---------------------------------------------------------------------------
# the round's FLOPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(FLOP_BANDS))
def test_useful_round_cost_matches_jax(model):
    got = P.useful_round_cost(_port_sim(_tiny_cfg(tc, model)))
    want = JP.useful_round_cost(_jax_sim(_tiny_cfg(jc, model)))
    print(f"{model}: port / JAX = {got / want:.4f}")
    assert got == pytest.approx(want, rel=FLOP_BANDS[model])
    # linear in the cohort (one cached step count)
    assert P.useful_round_cost(_port_sim(_tiny_cfg(tc, model, cpr=4))) \
        == 2 * got


def _hand_taps(size, k, stride, lo, out):
    return sum(1 for o in range(out) for j in range(k)
               if 0 <= o * stride + j - lo < size)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_formula_counts_taps_inside_the_input(stride):
    """One 5x5 SAME convolution of the port (``models/vision.py``
    ``Conv2d``) on 14x14, forward and both gradients: at stride 1 its
    padding is the convolution's own (2 a side), at stride 2 an ``F.pad``
    of (1, 2). Each of the three products pairs the taps inside the input
    only: 64 of 70 a dim at stride 1, 32 of 35 at stride 2."""
    from torch.utils.flop_counter import FlopCounterMode

    from fedml_tpu_torch.models.vision import Conv2d, same_padding

    b, cin, cout, size = 3, 4, 6, 14
    conv = Conv2d(cin, cout, 5, stride=stride)
    (lo, _), _ = same_padding((size, size), (5, 5), (stride, stride))
    out = -(-size // stride)
    taps = _hand_taps(size, 5, stride, lo, out) ** 2
    assert taps == {1: 64 ** 2, 2: 32 ** 2}[stride]
    x = torch.zeros(b, cin, size, size, requires_grad=True)
    with FlopCounterMode(display=False,
                         custom_mapping=P._ConvTaps().mapping()) as fm:
        conv(x).sum().backward()
    assert fm.get_total_flops() == 3 * 2 * b * cout * cin * taps
    with FlopCounterMode(display=False) as full:
        conv(x).sum().backward()
    assert full.get_total_flops() == 3 * 2 * b * cout * cin * (
        5 * out) ** 2


# ---------------------------------------------------------------------------
# the vocabulary, inertness and the CLI
# ---------------------------------------------------------------------------

SLO = "perf.round_wall_s:p99<10@60s"


def _names(snap) -> set:
    return {n for kind in ("counters", "gauges", "histograms")
            for n in snap[kind]}


def test_metric_vocabulary_matches_jax(tmp_path):
    """The same tiny run on each package, with a profiled round, the
    anatomy plane, an SLO and the memory monitor on."""
    names = []
    for pkg, tel, anat, mk in ((tc, T, A, _port_sim),
                               (jc, JT, JA, _jax_sim)):
        cfg = _tiny_cfg(pkg, rounds=3, profile_rounds=1)
        cfg = dataclasses.replace(cfg, out_dir=str(tmp_path / pkg.__name__))
        tel.configure(telemetry_dir=str(tmp_path / pkg.__name__ / "t"),
                      slos=(SLO,))
        anat.configure(anatomy=True)
        mk(cfg).run()
        tel.slo_engine().tick()
        names.append(_names(tel.METRICS.snapshot()))
        tel.shutdown()
    port, jax_names = names
    xla_only = {n for n in jax_names
                if n.startswith(("mem.program.", "mem.donation_"))}
    assert xla_only
    assert port == jax_names - xla_only, (sorted(port ^ jax_names))


def _rows(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "_ts"}
                for line in f]


def test_planes_are_inert(tmp_path):
    """A 3-round CPU run with every plane on (a profiled round, anatomy,
    an SLO, the listener, the breach profiler armed by the headroom)
    equals the run with every plane off bit for bit, in its final
    variables and its metrics rows; off, nothing is recorded."""
    def run(tag, **fed):
        cfg = dataclasses.replace(_tiny_cfg(tc, rounds=3, **fed),
                                  out_dir=str(tmp_path))
        sink = MetricsSink(path=str(tmp_path / tag / "metrics.jsonl"))
        state = _port_sim(cfg).run(metrics_sink=sink)
        sink.close()
        return state, _rows(sink.path)

    off_state, off_rows = run("off")
    assert T.METRICS.snapshot() == {"counters": {}, "gauges": {},
                                    "histograms": {}}
    assert A.ANATOMY.tracez()["entries"] == [] and T.TRACER is None
    assert T.RECORDER.events() == [] and not (tmp_path / "run").exists()
    T.configure(telemetry_dir=str(tmp_path / "t"), slos=(SLO,),
                metrics_port=0, metrics_host="127.0.0.1")
    A.configure(anatomy=True, profile_on_breach=True)
    on_state, on_rows = run("on", profile_rounds=1, mem_headroom_warn=1e-9)
    kinds = [e["kind"] for e in T.RECORDER.events()]
    assert kinds.count("mem_headroom") == 1 and "breach_profile" in kinds
    assert len(A.ANATOMY.tracez()["entries"]) == 3
    assert on_rows == off_rows
    for k, v in off_state.variables.items():
        assert torch.equal(v, on_state.variables[k]), k


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


def test_cli_observability_flags(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--algorithm", "fedavg", "--dataset", "fake_mnist", "--model",
            "lr", "--client_num_in_total", "4", "--client_num_per_round",
            "2", "--comm_round", "3", "--batch_size", "16", "--device",
            "cpu", "--out_dir", str(tmp_path / "runs")]
    tdir = tmp_path / "telemetry"
    assert cli.main(base + [
        "--run_name", "on", "--profile_rounds", "1", "--anatomy",
        "--metrics_port", "0", "--metrics_host", "127.0.0.1", "--slo", SLO,
        "--telemetry_dir", str(tdir)]) == 0
    port = json.load(open(tdir / "export_rank0.json"))["port"]
    assert strict_parse(_get(port, "/metrics"))["types"][
        "perf_round_wall_s"] == "histogram"
    status = json.loads(_get(port, "/statusz"))
    assert status["run"] == {"round": 2, "num_rounds": 3,
                             "run_name": "on_rep0"}
    assert status["memory"]["source"] == "rss"
    tracez = json.loads(_get(port, "/tracez"))
    assert len(tracez["entries"]) == 3
    T.shutdown()  # the exit flush: the trace and the SLO verdicts
    perf = json.load(open(tdir / "perf_rank0.json"))
    assert len(perf["rounds"]) == 1 and perf["flops_per_round"] > 0
    assert json.load(open(tdir / "slo_rank0.json"))["slos"][0]["ok"]
    spans = [e["name"] for e in json.load(open(tdir / "trace_rank0.json"))[
        "events"]]
    assert spans.count("sim_round") == 3 and spans.count("sim_run") == 1
    hists = json.load(open(tmp_path / "runs" / "on_rep0" / "summary.json"))[
        "telemetry_histograms"]
    assert hists["perf.round_wall_s"]["count"] == 2  # round 0 is warm-up
    assert cli.main(base + ["--run_name", "off"]) == 0
    assert _rows(tmp_path / "runs" / "on_rep0" / "metrics.jsonl") == \
        _rows(tmp_path / "runs" / "off_rep0" / "metrics.jsonl")
    assert "telemetry_histograms" not in json.load(
        open(tmp_path / "runs" / "off_rep0" / "summary.json"))
    with pytest.raises(SystemExit, match="needs an armed breach source"):
        cli.parse_args(base + ["--profile_on_breach"])
    with pytest.raises(SystemExit, match="malformed --slo"):
        cli.parse_args(base + ["--slo", "perf.round_wall_s<2"])
    with pytest.raises(SystemExit, match="mem_headroom_warn"):
        cli.parse_args(base + ["--mem_headroom_warn", "1.5"])


def test_memory_monitor_on_the_cpu(tmp_path):
    """A simulation on the CPU reads the process's RSS, marked as such;
    the headroom event fires once; a program's record holds only its
    measured fields."""
    T.configure(telemetry_dir=str(tmp_path), trace=False)
    M.MONITOR.attach("cpu", 1e-9)
    for _ in range(3):
        sample = M.MONITOR.sample(tag="t")
    assert sample["source"] == "rss" and sample["bytes_in_use"] > 0
    g = T.METRICS.snapshot()["gauges"]
    assert g["mem.source_rss"] == 1.0 and "mem.bytes_in_use.rss" in g
    assert [e["kind"] for e in T.RECORDER.events()].count(
        "mem_headroom") == 1
    rec = M.note_program("step", (2, "abc"), compile_s=0.5,
                         argument_bytes=10, temp_bytes=0)
    assert set(rec) >= {"argument_bytes", "temp_bytes", "compile_s"}
    assert "output_bytes" not in rec
    g = T.METRICS.snapshot()["gauges"]
    assert g["mem.program.step.2.abc.argument_bytes"] == 10.0
    assert "mem.program.step.2.abc.output_bytes" not in g
    status = E.status_snapshot()["memory"]
    assert "step.2.abc" in status["programs"]
    with pytest.raises(ValueError, match="unknown program fields"):
        M.note_program("step", 1, generated_code_bytes=0)


def test_breach_profiler_windows(tmp_path):
    """A breach arms one window; the round loop opens it once the round
    profiler has no window left to take and closes it ``window_s`` later;
    triggers past an armed or open window, within the cooldown or past
    the cap are skipped and counted."""
    T.configure(telemetry_dir=str(tmp_path), trace=False)
    clock = _Clock()
    bp = A.BreachProfiler(str(tmp_path / "profiles"), window_s=1.0,
                          max_captures=2, cooldown_s=10.0, clock=clock)
    rounds = P.RoundProfiler(1, str(tmp_path))
    path = bp.on_breach("slo_x", value=3.0)
    assert path.endswith("breach_1_slo_x") and bp.active
    assert bp.on_breach("mem_headroom") is None  # one armed at a time
    bp.poll(rounds)  # the round profiler still wants its window
    assert "profile.active" not in T.METRICS.snapshot()["gauges"]
    rounds.start_round(0)
    rounds.end_round(0)
    bp.poll(rounds)  # opens
    torch.ones(3).sum()
    clock.t += 0.5
    bp.poll(rounds)  # too early to close
    clock.t += 0.5
    bp.poll(rounds)  # closes
    assert (tmp_path / "profiles" / "breach_1_slo_x" /
            "rank0.pt.trace.json").exists()
    clock.t += 5.0
    assert bp.on_breach("slo_y") is None  # cooldown
    clock.t += 10.0
    assert bp.on_breach("slo_z") is not None
    bp.close()  # drops the armed window
    assert not bp.active
    clock.t += 100.0
    assert bp.on_breach("slo_w") is None  # the cap of 2 is spent
    kinds = [e["kind"] for e in T.RECORDER.events()]
    assert kinds.count("breach_profile") == 1
    assert kinds.count("breach_profile_done") == 1
    assert kinds.count("breach_profile_skipped") == 3
    c = T.METRICS.snapshot()["counters"]
    assert c["profile.captures"] == 2 and c["profile.skipped"] == 3
    with pytest.raises(ValueError, match="profile_window_s"):
        A.BreachProfiler(str(tmp_path), window_s=0)
