"""Checkpoints and bitwise resume over ranks: the port's FFModel on 2 gloo
processes over a `file://` store, data parallel and under the forced
tensor-parallel plan (search_budget=2, force_strategy_seed
"dp1xtp2xsp1"), an MLP with Dropout (32 -> 64 relu -> Dropout 0.1 -> 16,
batch 16, Adam(1e-2)), two epochs of 8 steps, windows of 4:

- a run killed by FF_TPU_FAULT_STEP after step 10 and resumed by a new
  FFModel on the same ranks ends bitwise equal to the uninterrupted run on
  every rank: every step's loss, the parameters and both Adam moments (the
  plan's gathered over the ranks);
- rank 0 alone writes (only it holds a writer, and the others' snapshots
  are no-ops), and the plan's state is gathered on the training thread;
- the last 2-rank checkpoint (save_checkpoint, every rank calling)
  restores into a single-device port FFModel and into the JAX FFModel
  (max_devices=1) with every parameter and moment bitwise the ranks'
  final state: the plan's checkpoint is keyed by the model graph's
  weights;
- Dropout over ranks draws the one-device masks: the ranks' final
  parameters are one device's fit within 1e-3 of how far each moved.

The ranks launch once per session (test_torch_port_once.py)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from flexflow_tpu import core as jcore
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.runtime.chaos import final_state
from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager, _flatten
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
BATCH = 16
STEPS = 16
CASES = {
    "dp": dict(only_data_parallel=True),
    "plan": dict(search_budget=2, force_strategy_seed="dp1xtp2xsp1"),
}


def build(pkg, device=None, **cfg):
    """The MLP, in either package."""
    kw = {} if device is None else dict(device=device)
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, seed=0, print_freq=0, **cfg), **kw)
    x = m.create_tensor([BATCH, 32], name="x")
    h = m.dropout(m.relu(m.dense(x, 64, use_bias=False, name="fc1")), 0.1)
    m.dense(h, 16, use_bias=False, name="head")
    m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def data():
    rs = np.random.RandomState(0)
    return rs.randn(BATCH * 8, 32).astype(np.float32), rs.randint(0, 16, BATCH * 8)


# One rank; argv: rank, work dir.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.runtime.chaos import final_state, states_bitwise
    from flexflow_tpu_torch.runtime.fault import SimulatedFault

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "build.py")).read())  # build, data, BATCH, CASES: the test's
    x, y = data()


    def losses_of(m):
        out, multi = {}, m.instance.multi_train_step

        def recorded(*a, **k):
            res = multi(*a, **k)
            for i, v in enumerate(res[3].tolist()):
                out[m._step_count + i + 1] = v
            return res

        m.instance.multi_train_step = recorded
        return out


    def run(case, cdir, init=None, **fit):
        m = build(core, device="cpu", steps_per_dispatch=4, checkpoint_dir=cdir,
                  checkpoint_every_n_steps=4, **CASES[case])
        if init is not None:
            m.save_checkpoint(init)  # the state the compile drew, at step 0
        losses = losses_of(m)
        try:
            m.fit(x, y, epochs=2, shuffle=True, verbose=False, **fit)
            outcome = "completed"
        except SimulatedFault:
            outcome = "SimulatedFault"
        return m, losses, outcome


    res = {}
    for case in CASES:
        d = os.path.join(work, case)
        ref, ref_losses, _ = run(case, os.path.join(d, "ref"), init=os.path.join(d, "init"))
        os.environ["FF_TPU_FAULT_STEP"] = "10"
        killed, first, outcome = run(case, os.path.join(d, "killed"))
        del os.environ["FF_TPU_FAULT_STEP"]
        writes = [killed.checkpointer.writer is not None, len(killed.checkpointer.stats)]
        resumed, second, _ = run(case, os.path.join(d, "killed"), resume=True)
        state = final_state(resumed)
        bitwise = states_bitwise(state, final_state(ref))
        resumed.save_checkpoint(os.path.join(d, "final"))
        if rank == 0:
            np.savez(os.path.join(d, "final_state.npz"),
                     **{"params/" + k: v for k, v in state[0].items()},
                     **{f"opt/{i}": v for i, v in enumerate(state[1])})
        res[case] = dict(outcome=outcome, writes=writes, bitwise=list(bitwise),
                         kind=type(resumed.instance).__name__,
                         ref_losses=ref_losses, first=first, second=second,
                         steps=resumed._step_count)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    """
)


def _runs(work: Path):
    import inspect

    (work / "build.py").write_text(
        "BATCH = {}\nCASES = {!r}\n".format(BATCH, CASES) + inspect.getsource(build)
        + inspect.getsource(data))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "FF_TPU_FAULT_STEP", "FF_TPU_FAULT_SPEC")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    errors = []
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=300)
        if p.returncode != 0:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(RANKS)]
    out = {"ranks": ranks}
    for case in CASES:
        d = work / case
        z = np.load(d / "final_state.npz")
        out[case] = dict(
            final={k: z[k] for k in z.files},
            steps={name: CheckpointManager(str(d / name)).all_steps()
                   for name in ("ref", "killed", "final")},
            final_dir=str(d / "final"), init_dir=str(d / "init"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "resume_ranks", _runs)


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_over_ranks_is_bitwise(runs, case):
    for rank in runs["ranks"]:
        r = rank[case]
        assert r["kind"] == ("DataParallelTrainingInstance" if case == "dp"
                             else "DistributedTrainingInstance")
        assert r["outcome"] == "SimulatedFault" and r["steps"] == STEPS
        assert r["bitwise"] == [True, True]
        ref = {int(k): v for k, v in r["ref_losses"].items()}
        first = {int(k): v for k, v in r["first"].items()}
        second = {int(k): v for k, v in r["second"].items()}
        assert max(first) == 12 and sorted(second) == list(range(13, STEPS + 1))
        assert {**first, **second} == ref
    # the ranks trained one run: the same losses everywhere
    assert runs["ranks"][0][case]["ref_losses"] == runs["ranks"][1][case]["ref_losses"]


@pytest.mark.parametrize("case", list(CASES))
def test_rank_0_alone_writes(runs, case):
    (w0, n0), (w1, n1) = (rank[case]["writes"] for rank in runs["ranks"])
    assert (w0, w1) == (True, False)
    assert n0 == 3 and n1 == 0  # the snapshots at steps 4, 8 and 12 before the kill
    assert runs[case]["steps"]["killed"][-1] == STEPS
    assert runs[case]["steps"]["final"] == [STEPS]


def _want(runs, case):
    return {k: v for k, v in runs[case]["final"].items()}


@pytest.mark.parametrize("case", list(CASES))
def test_the_ranks_checkpoint_restores_into_one_device(runs, case):
    m = build(tcore, device="cpu", max_devices=1)
    assert m.load_checkpoint(runs[case]["final_dir"]) == STEPS
    params, opt = final_state(m)
    want = _want(runs, case)
    assert {f"params/{k}" for k in params} == {k for k in want if k.startswith("params/")}
    for k, v in params.items():
        assert np.array_equal(v, want[f"params/{k}"]), k
    for i, v in enumerate(opt):
        assert np.array_equal(v, want[f"opt/{i}"]), i


@pytest.mark.parametrize("case", list(CASES))
def test_the_ranks_checkpoint_restores_into_the_jax_ffmodel(runs, case):
    jm = build(jcore, max_devices=1)
    assert jm.load_checkpoint(runs[case]["final_dir"]) == STEPS
    got = {k: np.asarray(v) for k, v in _flatten(
        {"params": jax.tree_util.tree_map(np.asarray, jm.params),
         "opt_state": jax.tree_util.tree_map(np.asarray, jm.opt_state)}).items()}
    want = _want(runs, case)
    for k, v in got.items():
        if k.startswith("params/"):
            assert np.array_equal(v, want[k]), k
    opt = [got[k] for k in sorted(got) if k.startswith("opt_state/")]
    for i, v in enumerate(opt):
        assert np.array_equal(v, want[f"opt/{i}"]), i


@pytest.mark.parametrize("case", list(CASES))
def test_the_ranks_train_as_one_device_does(runs, case):
    """Dropout over ranks draws the one-device masks (the data-parallel
    ranks cut the global masks to their rows, a plan's ranks their
    pieces): from the ranks' initial state (their step-0 checkpoint, a
    plan's initialized by its own weight keys), one device's fit ends
    within 1e-3 of how far each parameter moved of the ranks' final
    parameters (tests/test_torch_port_buckets.py's bound; the gradients
    are summed in another order)."""
    m = build(tcore, device="cpu", max_devices=1, steps_per_dispatch=4)
    assert m.load_checkpoint(runs[case]["init_dir"]) == 0  # the ranks' initial state
    init, _ = final_state(m)
    m.fit(*data(), epochs=2, shuffle=True, verbose=False)
    got, want = _want(runs, case), final_state(m)[0]
    for k, v in want.items():
        moved = np.linalg.norm(v - init[k])
        assert np.linalg.norm(got[f"params/{k}"] - v) <= 1e-3 * moved, k
