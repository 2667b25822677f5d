"""The fused step window over several ranks (A7 item 9), with
tests/test_fused_dispatch.py::TestFusedParity as the spec:
FFModel.fit(steps_per_dispatch=K) at K = 1, 4 and 8 over 2 gloo processes,
data parallel (tests/test_torch_port_fused.py's model: 32 -> 32 relu -> 10,
batch 16) and searched (search_budget=2: the MLP of
tests/test_torch_port_ffmodel_ranks.py whose winner is tensor parallel,
batch 64), six batches an epoch, so K = 4 runs a window of 4 and a tail
window of 2 and K = 8 one tail window of 6, two shuffled epochs, Adam:

- the port's fit at each K against the JAX FFModel compiled for 2 virtual
  CPU devices (max_devices=2) at the same K, from the same numpy
  parameters: the loss metric within rtol 1e-5, atol 1e-6
  (tests/test_torch_port_fused.py's f32 tolerances) and counts exact; the
  data-parallel parameters within those tolerances too, the searched
  plan's within 1e-5 relative in norm (tests/test_torch_port_ffmodel_ranks
  .py's searched tolerance: its tensor-parallel partial sums meet in
  another order than GSPMD's, which Adam's normalized steps carry into
  single elements);
- the port's K = 4 and K = 8 bitwise equal to its K = 1 on every rank
  (parameters and every step's loss; the metric sums are folded a window
  at a time, so they agree to f32 roundoff), one window call a window,
  whose losses are its steps', each reported `captured: False` (on the
  CPU, as under gloo on a card, no graph holds the window);
- each rank's windows hold only its rows of every batch: the rows of the
  JAX window's shard on the rank's device, tail window and reshuffle
  included."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flexflow_tpu import core as jcore
from flexflow_tpu.core.dataloader import BatchIterator as JaxBatchIterator
from flexflow_tpu.core.dataloader import WindowedBatchIterator as JaxWindowedBatchIterator
from flexflow_tpu_torch.core.dataloader import BatchIterator, WindowedBatchIterator
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
KS = (1, 4, 8)
STEPS_PER_EPOCH = 6
EPOCHS = 2
RTOL, ATOL = 1e-5, 1e-6
CASES = {
    "dp": dict(batch=16, features=32, classes=10, cfg=dict(only_data_parallel=True)),
    "searched": dict(batch=64, features=256, classes=16, cfg=dict(search_budget=2)),
}


def _build(pkg, case: dict, k: int, device=None):
    c = dict(CASES[case]) if isinstance(case, str) else case
    kw = {} if device is None else {"device": device}
    m = pkg.FFModel(pkg.FFConfig(batch_size=c["batch"], seed=0, steps_per_dispatch=k,
                                 print_freq=0, max_devices=2, **c["cfg"]), **kw)
    x = m.create_tensor([c["batch"], c["features"]], name="x")
    hidden = 32 if c["features"] == 32 else 2048
    h = m.relu(m.dense(x, hidden, use_bias=False, name="fc1"))
    m.dense(h, c["classes"], use_bias=False, name="head")
    m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
              metrics=["accuracy", "sparse_categorical_crossentropy"])
    return m


def _data(case: str):
    c = CASES[case]
    rs = np.random.RandomState(3)
    n = c["batch"] * STEPS_PER_EPOCH
    return rs.randn(n, c["features"]).astype(np.float32), rs.randint(0, c["classes"], n)


WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "build.py")).read())
    out = {}
    for case in CASES:
        data = np.load(os.path.join(work, case + ".npz"))
        for k in KS:
            m = _build(core, case, k, device="cpu")
            ffmodel_state_from_numpy(m, {n: data[n] for n in data.files if n.startswith("n")})
            windows, losses = [], []
            multi, step = m.instance.multi_train_step, m.instance.train_step

            def counted(*a, **kw):
                res = multi(*a, **kw)
                windows.append(dict(m.instance.last_window, losses=res[3].tolist()))
                return res

            def stepped(*a, **kw):
                res = step(*a, **kw)
                losses.append(float(res[2]))
                return res

            m.instance.multi_train_step, m.instance.train_step = counted, stepped
            perf = m.fit(x=data["xs"], y=data["ys"], epochs=EPOCHS, shuffle=True, verbose=False)
            params = {n: m.get_parameter_by_name(n).get_weights(m).tolist()
                      for n in ("fc1.weight0", "head.weight0")}
            out[f"{case}_{k}"] = dict(perf=vars(perf), params=params, windows=windows,
                                      losses=losses, kind=type(m.instance).__name__,
                                      degrees=(m.search_provenance or {}).get("parallel_degrees"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    """
)


class _JaxPkg:
    FFModel, FFConfig, AdamOptimizer = jcore.FFModel, jcore.FFConfig, jcore.AdamOptimizer


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "fused_ranks", _runs)


def _runs(work):
    import inspect

    jax_runs = {}
    for case in CASES:
        xs, ys = _data(case)
        init = None
        for k in KS:
            m = _build(_JaxPkg, case, k)
            if init is None:
                init = {n: np.array(v) for n, v in m.params.items()}
                np.savez(work / f"{case}.npz", xs=xs, ys=ys, **init)
            perf = m.fit(x=xs, y=ys, epochs=EPOCHS, shuffle=True, verbose=False)
            g = getattr(m.instance, "pcg", m.cg)
            params = {g.layer_attrs(n).name: np.asarray(m.params[f"n{n.idx}"])
                      for n in g.topological_ordering()
                      if g.layer_attrs(n).name in ("fc1.weight0", "head.weight0")}
            jax_runs[f"{case}_{k}"] = dict(perf=vars(perf), params=params,
                                           kind=type(m.instance).__name__)
    (work / "build.py").write_text(
        f"CASES = {CASES!r}\nKS = {KS!r}\nEPOCHS = {EPOCHS}\n" + inspect.getsource(_build))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    port = [json.loads((work / f"rank{r}.json").read_text()) for r in range(RANKS)]
    return dict(jax=jax_runs, port=port)


RUNS = [f"{case}_{k}" for case in CASES for k in KS]


@pytest.mark.parametrize("run", RUNS)
def test_fit_matches_the_jax_fused_fit(runs, run):
    want = runs["jax"][run]
    for rank in runs["port"]:
        got = rank[run]
        assert got["perf"]["train_all"] == want["perf"]["train_all"]
        assert got["perf"]["train_correct"] == want["perf"]["train_correct"]
        np.testing.assert_allclose(got["perf"]["sparse_cce_loss"], want["perf"]["sparse_cce_loss"],
                                   rtol=RTOL, atol=ATOL)
        for name, w in want["params"].items():
            if run.startswith("dp"):
                np.testing.assert_allclose(np.asarray(got["params"][name]), w, rtol=RTOL,
                                           atol=ATOL, err_msg=name)
            else:
                assert np.linalg.norm(np.asarray(got["params"][name]) - w) <= \
                    RTOL * np.linalg.norm(w), name


@pytest.mark.parametrize("case", CASES)
def test_trainers_are_the_jax_packages(runs, case):
    kinds = {"dp": "DataParallelTrainingInstance", "searched": "DistributedTrainingInstance"}
    for k in KS:
        assert runs["jax"][f"{case}_{k}"]["kind"] == kinds[case]
        for rank in runs["port"]:
            assert rank[f"{case}_{k}"]["kind"] == kinds[case]
    if case == "searched":  # tensor parallel, not the serial plan
        assert runs["port"][0]["searched_1"]["degrees"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [4, 8])
def test_windows_are_bitwise_the_per_step_fit(runs, case, k):
    for rank in runs["port"]:
        want, got = rank[f"{case}_1"], rank[f"{case}_{k}"]
        assert got["params"] == want["params"]
        assert got["losses"] == want["losses"] and len(got["losses"]) == STEPS_PER_EPOCH * EPOCHS
        assert [v for w in got["windows"] for v in w["losses"]] == got["losses"]
        for key in ("train_all", "train_correct"):
            assert got["perf"][key] == want["perf"][key]
        np.testing.assert_allclose(got["perf"]["sparse_cce_loss"],
                                   want["perf"]["sparse_cce_loss"], rtol=RTOL)
        assert want["windows"] == []
        lengths = [min(k, STEPS_PER_EPOCH), STEPS_PER_EPOCH - k] if k < STEPS_PER_EPOCH else \
            [STEPS_PER_EPOCH]
        assert [w["steps"] for w in got["windows"]] == lengths * EPOCHS
        assert not any(w["captured"] for w in got["windows"])


@pytest.mark.parametrize("window", [4, 8])
def test_rank_windows_hold_the_jax_shard_rows(window):
    """Each rank's windows (BatchIterator blocks) against the JAX windowed
    iterator under the 2-device batch sharding, shard by shard."""
    devices = jax.devices()[:RANKS]
    mesh = Mesh(np.asarray(devices), ("data",))
    xs, ys = _data("dp")
    batch = CASES["dp"]["batch"]
    data = NamedSharding(mesh, P("data"))
    jit = JaxBatchIterator({"x": xs}, ys.astype(np.int32), batch, input_shardings={"x": data},
                           label_sharding=data, shuffle=True, seed=5)
    jwins = [list(JaxWindowedBatchIterator(jit, window)) for _ in range(EPOCHS)]
    half = batch // RANKS
    for r, device in enumerate(devices):
        rows = (r * half, (r + 1) * half)
        tit = BatchIterator({"x": xs}, ys.astype(np.int32), batch, device="cpu", shuffle=True,
                            seed=5, blocks={"x": rows}, label_block=rows)
        tw = WindowedBatchIterator(tit, window)
        for epoch in range(EPOCHS):
            twins = list(tw)
            assert [w[2] for w in twins] == [w[3] for w in jwins[epoch]]
            for (tin, tlab, k), (jin, jlab, _, _) in zip(twins, jwins[epoch]):
                for got, arr in ((tin["x"], jin["x"]), (tlab, jlab)):
                    (shard,) = [s for s in arr.addressable_shards if s.device == device]
                    assert tuple(got.shape[:2]) == (k, half)
                    np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
        tw.close()
