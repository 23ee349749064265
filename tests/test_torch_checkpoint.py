"""Round checkpoints and resume (fedml_tpu_torch/utils/checkpoint.py and
fedml_tpu_torch/experiments/harness.py), the port's counterparts of the
JAX package's ``tests/test_support.py`` (resume at round 4),
``tests/test_recovery.py`` (resumed rows stamped) and
``tests/test_statebank.py`` (banks in the composite) tests.

Every comparison is bit for bit: a checkpoint holds the exact tensors,
and a resumed run replays the uninterrupted one's cohorts, batch orders
and draws, which depend on (seed, round, client) only."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

import fedml_tpu_torch.config as tc
from fedml_tpu_torch.algorithms import fedavg as tfed
from fedml_tpu_torch.experiments.harness import Experiment, build_sim
from fedml_tpu_torch.utils import checkpoint as CK
from tests.test_torch_fuse import _same
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cfg(tmp_path, rounds, run_name="ckpt_run", every=2, eval_every=100,
         **fed):
    return tc.ExperimentConfig(
        data=tc.DataConfig(dataset="fake_mnist", num_clients=8,
                           batch_size=16, seed=0),
        model=tc.ModelConfig(name="lr", num_classes=10,
                             input_shape=(28, 28, 1)),
        train=tc.TrainConfig(lr=0.1, epochs=1),
        fed=tc.FedConfig(num_rounds=rounds, clients_per_round=4,
                         eval_every=eval_every, **fed),
        seed=0, run_name=run_name, out_dir=str(tmp_path),
        checkpoint_every=every)


def _rows(tmp_path, run_name="ckpt_run"):
    path = tmp_path / f"{run_name}_rep0" / "metrics.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _run(cfg):
    return Experiment(cfg, device="cpu").run()


def test_roundtrip_keeps_the_round_and_adams_count(tmp_path):
    """A ServerState with server adam after two rounds: variables, the
    optimizer's moments and count, momentum and the round come back
    bit for bit, on the template's device and types."""
    cfg = _cfg(tmp_path, 2, server_optimizer="adam", server_lr=0.01)
    sim = build_sim(cfg, "cpu")
    state = sim.init()
    for _ in range(2):
        state, _ = sim.run_round(state)
    assert float(state.opt_state["count"]) == 2.0
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"))
    ckpt.save(1, state)
    restored, nxt = ckpt.restore_or(sim.init())
    assert nxt == 2 and ckpt.latest_round() == 1
    assert isinstance(restored, tfed.ServerState) and restored.round == 2
    _same(restored._asdict(), state._asdict())
    # what is written: contiguous CPU tensors that own their storage
    blob = CK.to_savable(state)
    assert blob["round"] == 2
    assert blob["opt_state"]["count"].shape == ()
    # a {"server", "bank"} composite read against the bare state gives
    # its server part
    ckpt.save(3, {"server": state, "bank": {"b": {"w": torch.ones(2)}}})
    restored, nxt = ckpt.restore_or(sim.init())
    assert nxt == 4
    _same(restored._asdict(), state._asdict())


def test_a_view_saves_its_own_elements_only(tmp_path):
    """``torch.save`` of a view writes its whole storage: a column view
    of a large flat buffer, saved through ``to_savable``, loads as a
    tensor of its own size."""
    flat = torch.arange(4000.0).reshape(40, 100)
    state = {"col": flat[:, 3:5], "row": flat[7]}
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"))
    ckpt.save(0, state)
    raw, _ = ckpt.restore_raw()
    for k, v in state.items():
        assert torch.equal(raw[k], v)
        assert raw[k].untyped_storage().nbytes() == v.numel() * 4, k
    assert os.path.getsize(ckpt._path(0)) < 4000


def test_keep_prunes_the_oldest(tmp_path):
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"), keep=2)
    for r in range(5):
        ckpt.save(r, {"w": torch.full((3,), float(r))})
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_00000003.pt",
                                                   "round_00000004.pt"]
    raw, nxt = ckpt.restore_raw()
    assert nxt == 5 and torch.equal(raw["w"], torch.full((3,), 4.0))
    with pytest.raises(ValueError):
        CK.RoundCheckpointer(str(tmp_path / "ck"), keep=0)


def test_a_torn_temporary_file_is_ignored(tmp_path, monkeypatch):
    """A save killed halfway leaves a temporary file, never a complete
    checkpoint's name: the last complete checkpoint is what restores, and
    a save that raises removes its temporary file."""
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"))
    ckpt.save(1, {"w": torch.ones(4)})
    (tmp_path / "ck" / ".tmp-torn.pt").write_bytes(b"PK\x03\x04 torn")
    (tmp_path / "ck" / "notes.txt").write_text("not a checkpoint")
    assert ckpt.latest_round() == 1
    raw, nxt = ckpt.restore_raw()
    assert nxt == 2 and torch.equal(raw["w"], torch.ones(4))

    def torn_save(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(CK.torch, "save", torn_save)
    with pytest.raises(OSError):
        ckpt.save(2, {"w": torch.zeros(4)})
    assert ckpt.latest_round() == 1
    assert sorted(os.listdir(tmp_path / "ck")) == [
        ".tmp-torn.pt", "notes.txt", "round_00000001.pt"]


def test_harness_resumes_at_round_4(tmp_path):
    """4 rounds with a checkpoint every 2, then the same run asked for 8:
    it resumes at round 4 (the JAX package's
    ``test_experiment_checkpoint_resume``), logging each round once."""
    _run(_cfg(tmp_path, 4))
    summaries = _run(_cfg(tmp_path, 8))
    assert summaries[0]["run_name"] == "ckpt_run_rep0"
    rows = _rows(tmp_path)
    assert [r["round"] for r in rows if "round" in r] == list(range(8))
    assert [r["resumed_from"] for r in rows if "resumed_from" in r] == [4]
    assert CK.RoundCheckpointer(
        str(tmp_path / "ckpt_run_rep0" / "ckpt")).latest_round() == 7


def test_resumed_rows_are_stamped(tmp_path):
    """The JAX package's ``test_harness_resume_stamps_rows``: a run of 2
    rounds, then 4: the fresh rows 0-1, the resumed rows 2-3."""
    _run(_cfg(tmp_path, 2, "resume_stamp"))
    _run(_cfg(tmp_path, 4, "resume_stamp"))
    rows = [r for r in _rows(tmp_path, "resume_stamp")]
    fresh = [r["round"] for r in rows if "round" in r
             and not r.get("resumed")]
    resumed = [r["round"] for r in rows if r.get("resumed")]
    assert fresh == [0, 1] and resumed == [2, 3]
    assert any(r.get("resumed_from") == 2 for r in rows)


def _final(tmp_path, run_name):
    ckpt = CK.RoundCheckpointer(str(tmp_path / f"{run_name}_rep0" / "ckpt"))
    return ckpt.restore_raw()


@pytest.mark.parametrize("fuse", [1, 2])
def test_resumed_equals_uninterrupted_bitwise(tmp_path, fuse):
    """8 rounds straight against 5 then a resume to 8 (checkpoints every
    2 and after the last round; evaluation every 3, so fused blocks also
    end there): the final checkpoints are equal bit for bit, and so are the
    records of the rounds after the resume. With fuse 2 both go through
    the harness's fused loop."""
    def cfg(rounds, name):
        return _cfg(tmp_path, rounds, name, eval_every=3, fuse_rounds=fuse)

    _run(cfg(8, "straight"))
    _run(cfg(5, "resumed"))
    _run(cfg(8, "resumed"))
    want, got = _final(tmp_path, "straight"), _final(tmp_path, "resumed")
    assert got[1] == want[1] == 8
    _same(got[0], want[0])

    def by_round(name, stamped):
        return {r["round"]: {k: v for k, v in r.items()
                             if k not in ("_ts", "resumed")}
                for r in _rows(tmp_path, name)
                if "round" in r and bool(r.get("resumed")) == stamped}

    after = by_round("resumed", True)
    # the 5-round run checkpoints its last round, 4
    assert sorted(after) == [5, 6, 7]
    straight = by_round("straight", False)
    assert after == {r: straight[r] for r in after}


@pytest.mark.parametrize("alias", ["fedavg_robust", "fedavg_multiclient"])
def test_fedavg_aliases_run_fedavgs_rounds(tmp_path, alias):
    """The JAX package's registry maps fedavg_robust and
    fedavg_multiclient to FedAvgSim running fedavg: with the same flags
    (a defense and seeded adversaries) they run fedavg's rounds, bit for
    bit."""
    import dataclasses

    cfg = dataclasses.replace(
        _cfg(tmp_path, 2, robust_method="median", robust_norm_clip=5.0),
        adversary=tc.AdversaryPolicy(mode="sign_flip", num_adversaries=2))
    runs = {}
    for algorithm in ("fedavg", alias):
        sim = build_sim(dataclasses.replace(cfg, fed=dataclasses.replace(
            cfg.fed, algorithm=algorithm)), "cpu")
        assert sim.cfg.fed.algorithm == "fedavg"
        state = sim.init()
        for _ in range(2):
            state, _ = sim.run_round(state)
        runs[algorithm] = state
    _same(runs[alias]._asdict(), runs["fedavg"]._asdict())


def test_bulk_ef_bank_rides_the_composite(tmp_path):
    """The bulk engine's client-keyed residual bank is saved in the
    ``{"server", "bank"}`` composite and restores bit for bit into a
    fresh sim; a run resumed from it ends as the uninterrupted one."""
    kw = dict(client_block_size=2, compress="int8")
    cfg = _cfg(tmp_path, 4, **kw)
    sim = build_sim(cfg, "cpu")
    state = sim.init()
    for _ in range(2):
        state, _ = sim.run_round(state)
    assert set(sim.bank_state()) == {"ef_residual"}
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"))
    Experiment._save_state(ckpt, sim, 1, state)
    raw, _ = ckpt.restore_raw()
    assert set(raw) == {"server", "bank"}
    fresh = build_sim(cfg, "cpu")
    restored, nxt = Experiment._restore_state(ckpt, fresh, fresh.init())
    assert nxt == 2
    _same(restored._asdict(), state._asdict())
    _same(fresh.ef_bank.rows, sim.ef_bank.rows)
    for _ in range(2):
        state, _ = sim.run_round(state)
        restored, _ = fresh.run_round(restored)
    _same(restored.variables, state.variables)
    _same(fresh.ef_bank.rows, sim.ef_bank.rows)


def test_bare_checkpoint_restores_with_fresh_banks(tmp_path):
    """A checkpoint of the bare state (no bank) restores the server
    state; the bank is made fresh at the next round, which runs."""
    cfg = _cfg(tmp_path, 2, client_block_size=2, compress="int8")
    sim = build_sim(cfg, "cpu")
    state, _ = sim.run_round(sim.init())
    ckpt = CK.RoundCheckpointer(str(tmp_path / "ck"))
    ckpt.save(0, state)
    fresh = build_sim(cfg, "cpu")
    restored, nxt = Experiment._restore_state(ckpt, fresh, fresh.init())
    assert nxt == 1 and fresh.ef_bank is None
    _same(restored.variables, state.variables)
    _, m = fresh.run_round(restored)
    assert fresh.ef_bank is not None and torch.isfinite(m["train_loss"])


# the children on one torch thread each, as this module's tests
CHILD_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}
CLI = [sys.executable, "-m", "fedml_tpu_torch.experiments.run",
       "--algorithm", "fedavg", "--dataset", "fake_mnist", "--model", "lr",
       "--num_classes", "10", "--input_shape", "28", "28", "1",
       "--client_num_in_total", "10", "--client_num_per_round", "4",
       "--comm_round", "10", "--batch_size", "32", "--checkpoint_every", "2",
       "--device", "cpu"]


def test_sigkilled_cli_run_resumes_bitwise(tmp_path):
    """The CLI on the CPU, 10 rounds with a checkpoint every 2, SIGKILLed
    once the checkpoint of round 3 exists and run again: metrics.jsonl
    holds every round, each round from 4 on in a row stamped
    ``resumed``, and the final checkpoint equals an uninterrupted CLI
    run's bit for bit."""
    killed = tmp_path / "killed"
    proc = subprocess.Popen(CLI + ["--out_dir", str(killed)], cwd=ROOT,
                            env=CHILD_ENV, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    mark = killed / "run_rep0" / "ckpt" / "round_00000003.pt"
    deadline = time.monotonic() + 120
    try:
        while not mark.exists():
            assert proc.poll() is None, proc.stderr.read().decode()
            assert time.monotonic() < deadline, "no checkpoint of round 3"
            time.sleep(0.001)
        proc.send_signal(signal.SIGKILL)
        assert proc.wait(timeout=60) == -signal.SIGKILL
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        proc.stderr.close()
    for out in (killed, tmp_path / "straight"):
        subprocess.run(CLI + ["--out_dir", str(out)], cwd=ROOT, env=CHILD_ENV,
                       check=True, capture_output=True, timeout=120)
    rows = _rows(killed, "run")
    assert {r["round"] for r in rows if "round" in r} == set(range(10))
    resumed_from = [r["resumed_from"] for r in rows if "resumed_from" in r]
    assert len(resumed_from) == 1 and resumed_from[0] >= 4
    assert {r["round"] for r in rows if r.get("resumed")} == set(
        range(resumed_from[0], 10))
    want, got = _final(tmp_path / "straight", "run"), _final(killed, "run")
    assert got[1] == want[1] == 10
    _same(got[0], want[0])
