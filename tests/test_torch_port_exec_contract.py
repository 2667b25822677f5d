"""The port's execution contract (flexflow_tpu_torch/analysis/
step_program.py, exec_contract.py: DET001, DET002, DON001, DON002) on the
CPU:

- the fingerprint of one compile is bitwise the same in two processes;
  a changed loss, optimizer constant or compute dtype changes it, while
  batch growth changes the `program_key` and is `program_changed`, never
  DET002;
- a mid-fit batch-growth recompile re-anchors the contract beside the
  checkpoints, so a model at the grown batch resumes with `match: true`;
- over 2 gloo ranks, a recording that fails on one rank ends both ranks'
  compiles with an error (no hang, no swallowed failure);
- a tampered record gives DET002 on fit(resume=True); a record the JAX
  package wrote (the checkpoint layouts are one) gives `match: None` and
  re-anchors, never DET002; fit writes `exec_contract.json` with the JAX
  record's fields, `torch_version` for `jax_version`;
- the recorded step leaves the live parameters, optimizer state and
  generator bitwise as they were, and its state is updated in place (no
  DON finding), with no nondeterministic op (no DET001);
- DET001 fires on a step holding an `index_add_`, and not on a
  scatter-add with one index per row; DON001 on a state leaf handed back
  in a new storage; COMM004 on an `.item()` inside the step, and not on
  the host staging of a collective's transport;
- ServingProgram.exec_contract: prefill and a decode window with the KV
  cache updated in place (no DON finding) on the JAX package's
  ServingLMConfig widths.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.analysis.exec_contract import (
    analyze_step_program,
    compare_contract_records,
    exec_diagnostics,
    read_contract_record,
)
from flexflow_tpu_torch.analysis.step_program import record_program
from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel, SGDOptimizer

REPO = Path(__file__).resolve().parent.parent


def _model(batch=8, lr=0.01, loss="sparse_categorical_crossentropy", dtype=None, **cfg):
    m = FFModel(FFConfig(batch_size=batch, seed=0, print_freq=0, **cfg), device="cpu")
    x = m.create_tensor([batch, 16], name="x")
    t = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    m.dense(t, 4, use_bias=False, name="out")
    m.compile(AdamOptimizer(alpha=lr), loss, metrics=["accuracy"], compute_dtype=dtype)
    return m


def _data(n=32):
    rs = np.random.RandomState(0)
    return rs.randn(n, 16).astype(np.float32), rs.randint(0, 4, n).astype(np.int32)


def _record(m):
    return m._exec_contract_record()


FINGERPRINT = textwrap.dedent(
    """
    import sys
    sys.path.insert(0, "tests")
    from test_torch_port_exec_contract import _model
    print(_model()._exec_contract_record()["program_fingerprint"])
    """
)


def test_two_processes_give_bitwise_the_same_fingerprint():
    outs = [subprocess.run([sys.executable, "-c", FINGERPRINT], cwd=REPO, capture_output=True,
                           text=True, timeout=120) for _ in range(2)]
    for o in outs:
        assert o.returncode == 0, o.stderr
    a, b = (o.stdout.strip().splitlines()[-1] for o in outs)
    assert a == b == _record(_model())["program_fingerprint"] and len(a) == 64


@pytest.mark.parametrize("change", ["loss", "optimizer_constant", "dtype"])
def test_a_changed_definition_changes_the_fingerprint(change):
    base = _record(_model())
    other = _record({"loss": lambda: _model(loss="categorical_crossentropy"),
                     "optimizer_constant": lambda: _model(lr=0.02),
                     "dtype": lambda: _model(dtype=torch.float64)}[change]())
    assert other["program_fingerprint"] != base["program_fingerprint"]
    check, diag = compare_contract_records(base, other)
    if other["program_key"] == base["program_key"]:
        assert check["match"] is False and diag.rule_id == "DET002"


def test_batch_growth_is_a_changed_program_not_det002():
    check, diag = compare_contract_records(_record(_model(batch=8)), _record(_model(batch=16)))
    assert check["program_changed"] is True and check["match"] is None and diag is None


def test_fit_writes_the_contract_and_resume_checks_it(tmp_path):
    xs, ys = _data()
    m = _model()
    m.fit(xs, ys, epochs=1, shuffle=False, verbose=False, checkpoint_dir=str(tmp_path),
          checkpoint_every_n_steps=2)
    rec = read_contract_record(str(tmp_path))
    assert set(rec) == {"schema", "program_fingerprint", "hlo_fingerprint", "program_key",
                        "torch_version"}
    m2 = _model()
    m2.fit(xs, ys, epochs=2, shuffle=False, verbose=False, checkpoint_dir=str(tmp_path),
           resume=True)
    assert m2.exec_resume_check["match"] is True


def test_a_mid_fit_recompile_re_anchors_the_contract(tmp_path):
    """Batch growth through fit(recompile_state=...) rewrites the contract
    beside the checkpoints: a model built at the grown batch resumes with
    match: true."""
    from flexflow_tpu_torch.runtime.recompile import RecompileState

    xs, ys = _data()
    m = _model()
    grow = RecompileState(lambda ff: ff._step_count >= 2 and ff.config.batch_size == 8,
                          lambda ff: setattr(ff.config, "batch_size", 16))
    m.fit(xs, ys, epochs=2, shuffle=False, verbose=False, checkpoint_dir=str(tmp_path),
          checkpoint_every_n_steps=2, recompile_state=grow)
    assert grow.recompilations == 1 and m._step_count == 4
    assert read_contract_record(str(tmp_path)) == _record(m)
    m2 = _model(batch=16)
    m2.fit(xs, ys, epochs=3, shuffle=False, verbose=False, checkpoint_dir=str(tmp_path),
           resume=True)
    assert m2.exec_resume_check["match"] is True and m2._step_count == 6


def test_a_tampered_contract_gives_det002(tmp_path, capsys):
    xs, ys = _data()
    _model().fit(xs, ys, epochs=1, shuffle=False, verbose=False, checkpoint_dir=str(tmp_path),
                 checkpoint_every_n_steps=2)
    path = tmp_path / "exec_contract.json"
    rec = json.loads(path.read_text())
    rec["program_fingerprint"] = "0" * 64
    path.write_text(json.dumps(rec))
    m = _model()
    m.fit(xs, ys, epochs=2, shuffle=False, verbose=False, checkpoint_dir=str(tmp_path),
          resume=True)
    assert m.exec_resume_check["match"] is False
    assert m.exec_resume_check["diagnostic"]["rule_id"] == "DET002"
    assert "DET002" in capsys.readouterr().out


def test_a_contract_the_jax_package_wrote_never_gives_det002(tmp_path):
    """A directory holding the JAX FFModel's contract (either package
    resumes the other's npz checkpoints): the port finds a contract of
    another runtime (`match: None`) and re-anchors it to its own program."""
    import shutil

    import flexflow_tpu.core as jcore
    from flexflow_tpu.analysis.exec_contract import read_contract_record as j_read

    xs, ys = _data()
    jm = jcore.FFModel(jcore.FFConfig(batch_size=8, seed=0, print_freq=0,
                                      checkpoint_backend="npz"))
    x = jm.create_tensor([8, 16], name="x")
    jm.dense(jm.relu(jm.dense(x, 32, use_bias=False, name="fc1")), 4, use_bias=False,
             name="out")
    jm.compile(jcore.AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy",
               metrics=["accuracy"])
    jdir = tmp_path / "jax"
    jm.fit(xs, ys, epochs=1, shuffle=False, verbose=False, checkpoint_dir=str(jdir),
           checkpoint_every_n_steps=2)
    jax_rec = j_read(str(jdir))
    assert "jax_version" in jax_rec
    check, diag = compare_contract_records(jax_rec, _record(_model()))
    assert check["match"] is None and diag is None
    pdir = tmp_path / "port"
    _model().fit(xs, ys, epochs=1, shuffle=False, verbose=False, checkpoint_dir=str(pdir),
                 checkpoint_every_n_steps=2)
    shutil.copy(jdir / "exec_contract.json", pdir / "exec_contract.json")
    m = _model()
    m.fit(xs, ys, epochs=2, shuffle=False, verbose=False, checkpoint_dir=str(pdir),
          resume=True)
    assert m.exec_resume_check["match"] is None and m.exec_resume_check["re_anchored"]
    assert "diagnostic" not in m.exec_resume_check
    assert read_contract_record(str(pdir)) == _record(m)


def test_the_recorded_step_leaves_the_live_state_bitwise_and_updates_in_place():
    from flexflow_tpu_torch.analysis.step_program import record_step

    m = _model()
    m.fit(*_data(), epochs=1, shuffle=False, verbose=False)
    params = {k: v.clone() for k, v in m.params.items()}
    opt = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
           for k, v in m.opt_state.items()}
    rng = torch.random.get_rng_state()
    prog = record_step(m.instance, m.params, m.opt_state, m.loss_attrs,
                       label_dtype=m._label_dtype)
    assert all(torch.equal(params[k], m.params[k]) for k in params)
    assert torch.equal(opt["step"], m.opt_state["step"])
    for slot in ("m", "v"):
        assert all(torch.equal(opt[slot][k], m.opt_state[slot][k]) for k in opt[slot])
    assert torch.equal(rng, torch.random.get_rng_state())
    a = analyze_step_program(prog)
    assert exec_diagnostics(a) == [] and a.donation_coverage == 1.0
    assert len(a.donation) == 2 + 2 * 2 + 1  # params, Adam's m and v, the step count


def _program(run, state=None):
    state = state or {"params": {"w": torch.zeros(32, 32)}}
    return record_program(run, state, tuple(state), ["w"], {})


def test_det001_on_an_index_add_not_on_a_unique_scatter_add():
    def atomic(st):
        w = st["params"]["w"]
        w.index_add_(0, torch.tensor([0, 0, 1]), torch.ones(3, 32))
        return st

    def unique(st):
        w = st["params"]["w"]
        w.scatter_add_(1, torch.zeros(32, 1, dtype=torch.long), torch.ones(32, 1))
        return st

    got = [d.rule_id for d in exec_diagnostics(analyze_step_program(_program(atomic)))]
    assert got == ["DET001"]
    assert exec_diagnostics(analyze_step_program(_program(unique))) == []


def test_don001_on_a_leaf_handed_back_in_a_new_storage():
    prog = _program(lambda st: {"params": {"w": st["params"]["w"] * 2}})
    assert [d.rule_id for d in exec_diagnostics(analyze_step_program(prog))] == ["DON001"]
    prog = _program(lambda st: {"params": {}})
    a = analyze_step_program(prog)
    assert [d.rule_id for d in exec_diagnostics(a)] == ["DON002"]


def test_comm004_on_a_host_read_not_on_a_collectives_transport():
    from flexflow_tpu_torch.analysis.comm_analysis import (
        comm_diagnostics,
        cross_check_comm,
        extract_collectives,
    )
    from flexflow_tpu_torch.parallel import census

    def reads(st):
        st["params"]["w"].add_(1)
        float(st["params"]["w"].sum())
        return st

    def staged(st):
        with census.transport():
            st["params"]["w"].sum().item()
        return st

    for run, want in ((reads, ["COMM004"]), (staged, [])):
        a = cross_check_comm([], extract_collectives(_program(run)))
        assert [d.rule_id for d in comm_diagnostics(a)] == want


def test_serving_contract_updates_the_cache_in_place():
    from flexflow_tpu_torch.analysis.memory_accounting import ServingMemorySpec
    from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
    from flexflow_tpu_torch.serving import ServingLMConfig, ServingProgram, build_serving_lm

    pcg = pcg_from_computation_graph(build_serving_lm(ServingLMConfig(), 4, 8)[0])
    prog = ServingProgram(pcg, ServingMemorySpec(max_concurrent_seqs=4, max_seq_len=24),
                          device="cpu")
    out = prog.exec_contract(window_steps=4)
    assert set(out) == {"prefill", "decode"}
    for analysis, diags in out.values():
        assert diags == []
        assert analysis.donation and all(r.aliased for r in analysis.donation)
        assert {r.arg for r in analysis.donation} == {"cache"}
    assert out["prefill"][0].program_key != out["decode"][0].program_key


FAILING_RANK = textwrap.dedent(
    """
    import os, sys
    import torch
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.analysis import step_program
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu", timeout_s=30)
    if rank == 1:
        def fail(*a, **k):
            raise RuntimeError("planted recording failure")

        step_program.record_step = fail
    m = core.FFModel(core.FFConfig(batch_size=16, seed=0, print_freq=0, search_budget=2,
                                   max_devices=2), device="cpu")
    x = m.create_tensor([16, 32], name="x")
    h = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    m.dense(h, 10, use_bias=False, name="head")
    m.compile(core.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy")
    print("compiled", m.search_provenance.get("exec"))
    """
)


def test_a_recording_that_fails_on_one_rank_ends_every_ranks_compile(tmp_path):
    """Over ranks the recorded step's collectives are the group's: a rank
    whose recording fails raises, and the other rank's compile ends with
    an error of its own instead of hanging or pairing its step's
    collectives with the next check's broadcast. Each rank is joined
    within 120 s (the group's timeout is 30 s)."""
    procs = [subprocess.Popen([sys.executable, "-c", FAILING_RANK, str(r), str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode != 0 for p in procs] == [True, True], outs
    assert "planted recording failure" in outs[1][1]
    assert not any("compiled" in out for out, _ in outs)
