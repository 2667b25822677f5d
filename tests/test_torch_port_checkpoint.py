"""The port's checkpoints (flexflow_tpu_torch/runtime/checkpoint.py,
integrity.py, retry.py) on the CPU: tests/test_checkpoint_integrity.py's
and tests/test_retry.py's spec run on the port, and the layout held
against the JAX package's:

- the manager's round trip, the integrity manifest and each leaf file
  byte-equal to what the JAX CheckpointManager writes for the same arrays;
- corruption detection (a bit flip, a zero-length leaf, a missing leaf, an
  unparseable keys.json, dtype drift), the fallback and quarantine bounded
  by retention, concurrent writers of one step, the legacy layouts, the
  retry backoff, the async writer's failure surfacing at the next
  boundary, and orbax refused;
- across packages: the JAX CheckpointManager.save and FFModel.save_checkpoint
  restore in the port with every leaf bit-equal, and the port's in the JAX
  package; one Adam step from the restored state then agrees within the
  f32 tolerance of tests/test_torch_port_fused.py (rtol 1e-5, atol 1e-6);
  each package's fit(resume=True) refuses the other's fit-loop snapshot
  (the RNG streams differ: a jax.random key against a torch.Generator).

The JAX package picks orbax where it is installed; its save_checkpoint
takes no backend, so the tests hide orbax from it (as on a host without
orbax) to get the npz layout both packages share."""

import json
import os
import random
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import core as jcore
from flexflow_tpu.runtime import checkpoint as jckpt
from flexflow_tpu.runtime import integrity as jinteg
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.runtime import integrity as integ
from flexflow_tpu_torch.runtime.checkpoint import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointManager,
    TrainingCheckpointer,
    _flatten,
)
from flexflow_tpu_torch.runtime.integrity import (
    build_manifest,
    leaf_digest,
    parse_keys_json,
    verify_and_load_leaves,
)
from flexflow_tpu_torch.runtime.retry import RetryPolicy, with_retry
from flexflow_tpu_torch.runtime.supervisor import BackgroundFault, FaultChannel

RTOL, ATOL = 1e-5, 1e-6


def _tree(seed=0):
    rs = np.random.RandomState(seed)
    return {"w": rs.randn(4, 3).astype(np.float32), "b": rs.randn(3).astype(np.float32)}


def _save_steps(tmp_path, steps=(4, 8, 12)):
    mgr = CheckpointManager(str(tmp_path), backend="npz")
    for s in steps:
        mgr.save(s, _tree(s), {"step": np.int32(s)})
    return mgr


@pytest.fixture
def no_orbax(monkeypatch):
    """The JAX CheckpointManager as on a host without orbax: npz."""
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


# --- the manager and its manifest ---------------------------------------------


def test_save_writes_integrity_manifest(tmp_path):
    mgr = _save_steps(tmp_path, steps=(1,))
    payload = json.loads((tmp_path / "step_1" / "keys.json").read_text())
    assert payload["integrity"] == 1
    keys, leaves = parse_keys_json(payload)
    assert keys == sorted(keys) == ["opt_state/step", "params/b", "params/w"]
    for key in keys:
        assert set(leaves[key]) == {"crc32", "dtype", "shape", "nbytes"}
    step, params, opt, extra = mgr.restore()
    assert step == 1 and extra == {}
    assert np.array_equal(params["w"], _tree(1)["w"]) and int(opt["step"]) == 1
    assert mgr.last_restore_report["verified"] is True
    assert mgr.last_restore_report["quarantined"] == []


def test_tensors_save_as_their_values(tmp_path):
    """Leaves given as tensors are written as the arrays of their values,
    and a template's dtypes and key paths are checked on restore."""
    mgr = CheckpointManager(str(tmp_path))
    params = {k: torch.from_numpy(v) for k, v in _tree(3).items()}
    mgr.save(5, params, {"step": torch.tensor(5, dtype=torch.int32)})
    step, got, opt, _ = mgr.restore(template={"params": params})
    assert step == 5 and all(np.array_equal(got[k], _tree(3)[k]) for k in got)
    assert opt["step"].dtype == np.int32
    with pytest.raises(CheckpointError, match="missing paths"):
        mgr.restore(template={"params": dict(params, extra=params["b"])})
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(6, {"w": torch.zeros(2, dtype=torch.bfloat16)})


def test_leaf_digest_detects_single_bit_flip():
    a = np.arange(12, dtype=np.float32)
    b = a.copy()
    b.view(np.uint8)[0] ^= 1
    assert leaf_digest(b)["crc32"] != leaf_digest(a)["crc32"]


def test_verify_and_load_round_trip(tmp_path):
    flat = {"a/x": np.ones(3, np.float32), "b": np.zeros(2, np.int32)}
    order = sorted(flat)
    for i, key in enumerate(order):
        np.save(tmp_path / f"arr_{i}.npy", flat[key])
    (tmp_path / "keys.json").write_text(json.dumps(build_manifest(order, flat)))
    got, verified = verify_and_load_leaves(str(tmp_path))
    assert verified and set(got) == set(flat)
    assert np.array_equal(got["a/x"], flat["a/x"])


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint8", "bool"])
def test_manifest_is_the_jax_manifest(dtype):
    rs = np.random.RandomState(1)
    flat = {"params/n1": (rs.randn(5, 7) * 9).astype(dtype), "opt_state/step": np.int32(3),
            "params/n0": (rs.randn(0, 2)).astype(dtype), "opt_state/m/n1": rs.randn(2).astype(dtype)}
    order = sorted(flat)
    assert json.dumps(build_manifest(order, flat)) == json.dumps(
        jinteg.build_manifest(order, flat))


def test_files_are_byte_equal_to_the_jax_managers(tmp_path, no_orbax):
    """One state through both managers: keys.json, meta.json and every
    arr_i.npy are the same bytes."""
    rs = np.random.RandomState(2)
    params = {f"n{i}": rs.randn(3, i + 1).astype(np.float32) for i in range(4)}
    opt = {"m": {k: v * 0.5 for k, v in params.items()},
           "v": {k: v * v for k, v in params.items()}, "step": np.int32(7)}
    CheckpointManager(str(tmp_path / "port")).save(7, params, opt, extra={"seed": 0})
    jm = jckpt.CheckpointManager(str(tmp_path / "jax"))
    assert jm.backend == "npz"
    jm.save(7, params, opt, extra={"seed": 0})
    port, want = tmp_path / "port" / "step_7", tmp_path / "jax" / "step_7"
    assert sorted(os.listdir(port)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        assert (port / name).read_bytes() == (want / name).read_bytes(), name


# --- corruption, fallback and quarantine ---------------------------------------


def _flip_last_byte(path):
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))


def _drift_dtype(d):
    payload = json.loads((d / "keys.json").read_text())
    key0 = payload["keys"][0]
    np.save(d / "arr_0.npy", np.zeros(payload["leaves"][key0]["shape"], np.float64))


CORRUPTIONS = {
    "bit_flip": (lambda d: _flip_last_byte(d / "arr_2.npy"), "crc32"),
    "zero_length_leaf": (lambda d: (d / "arr_0.npy").write_bytes(b""), "zero-length"),
    "missing_leaf": (lambda d: os.remove(d / "arr_1.npy"), "missing array file"),
    "unparseable_keys_json": (lambda d: (d / "keys.json").write_text("{not json"), "keys.json"),
    "dtype_drift": (_drift_dtype, "dtype"),
}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_corruption_is_detected_on_an_explicit_step(tmp_path, kind):
    """An explicitly requested corrupt step raises, naming why, and stays
    where it is (not quarantined)."""
    mgr = _save_steps(tmp_path, steps=(12,))
    corrupt, why = CORRUPTIONS[kind]
    corrupt(tmp_path / "step_12")
    with pytest.raises(CheckpointCorruptError, match=why) as ei:
        mgr.restore(step=12)
    assert ei.value.step == 12
    assert (tmp_path / "step_12").exists()


def test_latest_corrupt_falls_back_and_quarantines(tmp_path):
    mgr = _save_steps(tmp_path, steps=(4, 8, 12))
    (tmp_path / "step_12" / "arr_0.npy").write_bytes(b"")
    step, params, _, _ = mgr.restore()
    assert step == 8 and np.array_equal(params["w"], _tree(8)["w"])
    report = mgr.last_restore_report
    assert report["restored_step"] == 8 and [q["step"] for q in report["quarantined"]] == [12]
    assert (tmp_path / "step_12.corrupt").exists()
    assert mgr.all_steps() == [4, 8] and mgr.latest_step() == 8


def test_walks_past_multiple_corrupt_steps(tmp_path):
    mgr = _save_steps(tmp_path, steps=(4, 8, 12))
    for s in (8, 12):
        (tmp_path / f"step_{s}" / "arr_0.npy").write_bytes(b"x")
    step, _, _, _ = mgr.restore()
    assert step == 4
    assert [q["step"] for q in mgr.last_restore_report["quarantined"]] == [12, 8]


def test_all_corrupt_raises_structured_error(tmp_path):
    mgr = _save_steps(tmp_path, steps=(4, 8))
    for s in (4, 8):
        (tmp_path / f"step_{s}" / "arr_0.npy").write_bytes(b"")
    with pytest.raises(CheckpointError, match="survived integrity") as ei:
        mgr.restore()
    assert not isinstance(ei.value, CheckpointCorruptError)
    assert "8" in str(ei.value) and "4" in str(ei.value)


def test_corrupt_quarantine_bounded_by_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 4):
        (tmp_path / f"step_{s}.corrupt").mkdir()
    mgr.save(5, _tree())
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".corrupt")) == [
        "step_3.corrupt", "step_4.corrupt"]


# --- concurrent writers and legacy layouts -------------------------------------


def test_two_leftover_tmps_of_dead_writers_are_collected(tmp_path):
    proc = subprocess.Popen(["true"])
    proc.wait()  # a pid that no longer exists
    mgr = CheckpointManager(str(tmp_path))
    for name in ("step_9.tmp", f"step_9.tmp.{proc.pid}_0", f"step_9.tmp.{proc.pid}_1"):
        (tmp_path / name).mkdir()
    assert mgr.all_steps() == []
    mgr.save(1, _tree())
    assert sorted(os.listdir(tmp_path)) == ["step_1"]


def test_live_foreign_writer_tmp_not_reaped(tmp_path):
    proc = subprocess.Popen([sys.executable, "-c", "input()"], stdin=subprocess.PIPE)
    try:
        foreign = tmp_path / f"step_9.tmp.{proc.pid}_0"
        foreign.mkdir()
        CheckpointManager(str(tmp_path)).save(1, _tree())
        assert foreign.exists(), "reaped a live writer's tmp"
    finally:
        proc.communicate(input=b"\n", timeout=30)


def test_concurrent_same_step_saves_do_not_collide(tmp_path):
    managers = [CheckpointManager(str(tmp_path)) for _ in range(2)]
    errs = []

    def save(mgr, seed):
        try:
            mgr.save(7, _tree(seed))
        except Exception as e:  # noqa: BLE001 - the test collects
            errs.append(e)

    threads = [threading.Thread(target=save, args=(m, i)) for i, m in enumerate(managers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errs == []
    step, params, _, _ = managers[0].restore()
    assert step == 7 and managers[0].last_restore_report["verified"] is True
    assert any(np.array_equal(params["w"], _tree(i)["w"]) for i in (0, 1))


def test_legacy_state_npz_restores_with_one_warning(tmp_path, capsys):
    integ._LEGACY_WARNED.clear()
    d = tmp_path / "step_3"
    d.mkdir()
    np.savez(d / "state.npz", **_flatten({"params": _tree()}))
    (d / "meta.json").write_text(json.dumps({"step": 3, "backend": "npz", "extra": {}}))
    mgr = CheckpointManager(str(tmp_path))
    step, params, _, _ = mgr.restore()
    assert step == 3 and np.array_equal(params["w"], _tree()["w"])
    assert mgr.last_restore_report["legacy"] is True
    assert mgr.last_restore_report["verified"] is False
    assert capsys.readouterr().err.count("verified-as-legacy") == 1
    mgr.restore()
    assert capsys.readouterr().err.count("verified-as-legacy") == 0


def test_legacy_list_keys_json_restores_with_warning(tmp_path, capsys):
    integ._LEGACY_WARNED.clear()
    mgr = _save_steps(tmp_path, steps=(2,))
    kj = tmp_path / "step_2" / "keys.json"
    kj.write_text(json.dumps(json.loads(kj.read_text())["keys"]))
    step, params, _, _ = mgr.restore()
    assert step == 2 and np.array_equal(params["w"], _tree(2)["w"])
    assert mgr.last_restore_report["legacy"] is True
    assert "verified-as-legacy" in capsys.readouterr().err


# --- retry (tests/test_retry.py's spec) ----------------------------------------


class FlakyFS:
    """Raises for the first `fail_n` calls, then succeeds."""

    def __init__(self, fail_n, exc=OSError):
        self.fail_n, self.exc, self.calls = fail_n, exc, 0

    def op(self, value="ok"):
        self.calls += 1
        if self.calls <= self.fail_n:
            raise self.exc(f"transient #{self.calls}")
        return value


def test_retry_succeeds_after_transient_failures():
    fs, sleeps = FlakyFS(2), []
    out = with_retry(fs.op, "committed", policy=RetryPolicy(attempts=4, base_delay_s=0.01),
                     rng=random.Random(0), sleep=sleeps.append)
    assert (out, fs.calls, len(sleeps)) == ("committed", 3, 2)


def test_retry_exhausted_attempts_raise_original_error():
    fs, sleeps = FlakyFS(10), []
    with pytest.raises(OSError, match="transient #3"):
        with_retry(fs.op, policy=RetryPolicy(attempts=3), rng=random.Random(0),
                   sleep=sleeps.append)
    assert fs.calls == 3 and len(sleeps) == 2


def test_retry_non_retryable_exception_propagates_immediately():
    fs = FlakyFS(5, exc=ValueError)
    with pytest.raises(ValueError):
        with_retry(fs.op, policy=RetryPolicy(attempts=5), sleep=lambda s: None)
    assert fs.calls == 1


def test_retry_backoff_is_exponential_with_bounded_jitter():
    policy = RetryPolicy(attempts=5, base_delay_s=0.1, max_delay_s=0.5, jitter=0.5)
    rng = random.Random(7)
    for i, raw in enumerate([0.1, 0.2, 0.4, 0.5]):
        assert raw <= policy.delay(i, rng) < raw * 1.5 + 1e-9


def test_retry_on_retry_fires_per_absorbed_transient(capsys):
    fs, seen = FlakyFS(2), []
    with_retry(fs.op, policy=RetryPolicy(attempts=4), sleep=lambda s: None,
               on_retry=lambda attempt, exc: seen.append((attempt, str(exc))))
    assert seen == [(0, "transient #1"), (1, "transient #2")]
    with_retry(FlakyFS(1).op, policy=RetryPolicy(attempts=4), sleep=lambda s: None,
               description="checkpoint commit")
    err = capsys.readouterr().err
    assert err.count("checkpoint commit") == 1 and "transient #1" in err


def test_checkpoint_meta_read_retries(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"w": np.ones((2, 2), np.float32)})
    real_open, fails = open, {"n": 2}

    def flaky_open(path, *a, **kw):
        if str(path).endswith("meta.json") and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient meta read")
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", flaky_open)
    monkeypatch.setattr("time.sleep", lambda s: None)
    step, params, _, _ = mgr.restore()
    assert step == 3 and np.allclose(params["w"], 1.0) and fails["n"] == 0


# --- the async writer and orbax --------------------------------------------------


def test_async_writer_failure_surfaces_at_the_next_boundary(tmp_path, monkeypatch):
    """A commit that fails on the writer thread is posted to the channel
    and raised at the next `due` as a BackgroundFault naming the writer;
    a good snapshot before it is committed."""
    channel = FaultChannel()
    ckpt = TrainingCheckpointer(str(tmp_path), every_n_steps=2, fault_channel=channel)
    gen = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.ones(3)}, "opt_state": {"step": torch.tensor(2, dtype=torch.int32)}}
    ckpt.snapshot(2, state, gen, 0, 2)
    ckpt.writer.wait()
    monkeypatch.setattr(ckpt.manager, "write_host_state",
                        lambda *a, **k: (_ for _ in ()).throw(OSError("disk gone")))
    ckpt.snapshot(4, state, gen, 0, 4)
    ckpt.writer._queue.join()
    with pytest.raises(BackgroundFault, match="checkpoint_writer") as ei:
        ckpt.due(4, 6)
    assert isinstance(ei.value.original, OSError)
    ckpt.finalize()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    assert [s["step"] for s in ckpt.stats] == [2]


def test_orbax_is_refused(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        CheckpointManager(str(tmp_path), backend="orbax")
    m = tcore.FFModel(tcore.FFConfig(batch_size=8, checkpoint_backend="orbax"), device="cpu")
    m.dense(m.create_tensor([8, 4], name="x"), 2)
    with pytest.raises(ValueError, match="orbax"):
        m.compile(tcore.SGDOptimizer(lr=0.1))


def test_a_step_orbax_wrote_raises_naming_it(tmp_path):
    d = tmp_path / "step_3"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps({"step": 3, "backend": "orbax", "extra": {}}))
    with pytest.raises(CheckpointError, match="orbax"):
        CheckpointManager(str(tmp_path)).restore()
    assert (tmp_path / "step_3").exists()  # not quarantined: it is not corrupt


# --- across packages -------------------------------------------------------------

BATCH = 16


def _mlp(pkg, **cfg):
    """tests/test_torch_port_fused.py's model without Dropout, Adam."""
    kw = {"device": "cpu"} if pkg is tcore else {}
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, seed=0, print_freq=0, max_devices=1, **cfg),
                    **kw)
    x = m.create_tensor([BATCH, 32], name="x")
    h = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    logits = m.dense(h, 10, use_bias=False, name="head")
    m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)
    return m


def _data(n=4 * BATCH, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 32).astype(np.float32), rs.randint(0, 10, n)


def _flat_numpy(params, opt_state):
    return {k: np.asarray(v) for k, v in _flatten({"params": params,
                                                   "opt_state": opt_state}).items()}


def _assert_bit_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_a_jax_manager_save_restores_in_the_port(tmp_path, no_orbax):
    jm = _mlp(jcore)
    jm.fit(*_data(), epochs=1, verbose=False)
    want = _flat_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                       jax.tree_util.tree_map(np.asarray, jm.opt_state))
    jckpt.CheckpointManager(str(tmp_path)).save(4, jm.params, jm.opt_state)
    step, params, opt, _ = CheckpointManager(str(tmp_path)).restore()
    assert step == 4
    _assert_bit_equal(_flat_numpy(params, opt), want)


def test_the_port_manager_save_restores_in_the_jax_package(tmp_path, no_orbax):
    tm = _mlp(tcore)
    tm.fit(*_data(), epochs=1, verbose=False)
    want = _flat_numpy(tm.params, tm.opt_state)
    CheckpointManager(str(tmp_path)).save(4, tm.params, tm.opt_state)
    step, params, opt, _ = jckpt.CheckpointManager(str(tmp_path)).restore()
    assert step == 4
    _assert_bit_equal(_flat_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  jax.tree_util.tree_map(np.asarray, opt)), want)


def _one_step_agrees(jm, tm):
    """One more Adam step on the same batch in both packages: parameters
    and moments within the fused tests' f32 tolerance."""
    x, y = _data(BATCH, seed=5)
    jm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    tm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    got = _flat_numpy(tm.params, tm.opt_state)
    want = _flat_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                       jax.tree_util.tree_map(np.asarray, jm.opt_state))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_a_jax_ffmodel_checkpoint_loads_into_the_port_ffmodel(tmp_path, no_orbax):
    jm = _mlp(jcore)
    jm.fit(*_data(), epochs=1, verbose=False)
    jm.save_checkpoint(str(tmp_path))
    want = _flat_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                       jax.tree_util.tree_map(np.asarray, jm.opt_state))
    tm = _mlp(tcore)
    assert tm.load_checkpoint(str(tmp_path)) == jm._step_count == 4
    assert tm._step_count == 4
    _assert_bit_equal(_flat_numpy(tm.params, tm.opt_state), want)
    _one_step_agrees(jm, tm)


def test_a_port_ffmodel_checkpoint_loads_into_the_jax_ffmodel(tmp_path):
    tm = _mlp(tcore)
    tm.fit(*_data(), epochs=1, verbose=False)
    tm.save_checkpoint(str(tmp_path))
    meta = json.loads((tmp_path / "step_4" / "meta.json").read_text())
    assert meta == {"step": 4, "backend": "npz", "extra": {"seed": 0}}
    want = _flat_numpy(tm.params, tm.opt_state)
    jm = _mlp(jcore)
    assert jm.load_checkpoint(str(tmp_path)) == 4
    _assert_bit_equal(_flat_numpy(jax.tree_util.tree_map(np.asarray, jm.params),
                                  jax.tree_util.tree_map(np.asarray, jm.opt_state)), want)
    _one_step_agrees(jm, tm)


def test_the_port_refuses_a_jax_fit_loop_snapshot(tmp_path):
    jm = _mlp(jcore, checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=2,
              checkpoint_backend="npz")
    jm.fit(*_data(), epochs=1, verbose=False)
    assert "rng" in json.loads((tmp_path / "step_4" / "meta.json").read_text())["extra"]
    tm = _mlp(tcore)
    with pytest.raises(CheckpointError, match="RNG stream"):
        tm.fit(*_data(), epochs=1, verbose=False, checkpoint_dir=str(tmp_path), resume=True)
    # its params, optimizer state and step still load
    assert tm.load_checkpoint(str(tmp_path)) == 4


def test_the_jax_package_refuses_a_port_fit_loop_snapshot(tmp_path):
    tm = _mlp(tcore, checkpoint_dir=str(tmp_path), checkpoint_every_n_steps=2)
    tm.fit(*_data(), epochs=1, verbose=False)
    extra = json.loads((tmp_path / "step_4" / "meta.json").read_text())["extra"]
    assert "rng" not in extra and len(extra["torch_rng"]) == 5056
    jc = jckpt.TrainingCheckpointer(str(tmp_path), backend="npz", sync=True)
    with pytest.raises(jckpt.CheckpointError, match="no resume metadata"):
        jc.resume_state()
    jm = _mlp(jcore)
    assert jm.load_checkpoint(str(tmp_path)) == 4
