"""FFModel over several ranks (flexflow_tpu_torch.core with A7 items 2 and
4): the port's FFModel on 2 gloo processes over a `file://` store against
the JAX FFModel compiled for 2 virtual CPU devices, as the spec of
tests/test_ffmodel_api.py's TestMultiDevice and searched-compile tests:

- a data-parallel fit (only_data_parallel) of the spec's MLP gives JAX's
  PerfMetrics counts and parameters;
- a searched compile (search_budget=2) of an MLP whose winner at 2 devices
  is tensor parallel finds the JAX FFModel's winner (the same
  parallel_degree_summary and estimated cost) and trains to its metric
  sums and parameters;
- the strategy the JAX FFModel exports imports into the port and trains
  the same; the strategy the port exports (rank 0) is the same JSON
  document, and imports back into the JAX FFModel;
- in-process, over a group of one rank: the device count cut as the JAX
  package cuts it, a count other than the group's size refused, and the
  search's unported flags refused naming their item.

Each port model starts from the JAX model's numpy parameters
(interop.ffmodel_state_from_numpy). Tolerances: metric sums rtol 1e-5,
counts exact, parameters within 1e-5 relative (SGD, 2 or 5 epochs)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from flexflow_tpu.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu.op_attrs.activation import Activation

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _build(pkg, cfg: dict, searched: bool, device=None):
    """The spec's data-parallel MLP (32 -> 16 relu -> 4), or the searched
    one (256 -> 2048 relu -> 16, no bias: tensor parallel at 2 devices)."""
    m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
    if searched:
        x = m.create_tensor([cfg["batch_size"], 256], name="x")
        t = m.relu(m.dense(x, 2048, use_bias=False, name="fc1"))
        m.dense(t, 16, use_bias=False, name="out")
    else:
        x = m.create_tensor([16, 32], name="x")
        t = m.dense(x, 16, activation=pkg.Activation.RELU, name="fc1")
        m.dense(t, 4, name="out")
    m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=METRICS)
    return m


CASES = {
    "dp": dict(cfg=dict(batch_size=16, print_freq=0, max_devices=2, only_data_parallel=True),
               searched=False, epochs=5, samples=(64, 32, 4)),
    "searched": dict(cfg=dict(batch_size=64, print_freq=0, max_devices=2, search_budget=2),
                     searched=True, epochs=2, samples=(128, 256, 16)),
    "imported": dict(cfg=dict(batch_size=64, print_freq=0, max_devices=2, search_budget=2),
                     searched=True, epochs=2, samples=(128, 256, 16)),
}

# One rank; argv: rank, work dir. Each case in turn on one process group.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.core import ffmodel
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
    from flexflow_tpu_torch.op_attrs.activation import Activation
    from flexflow_tpu_torch.parallel import init_file_group

    core.Activation = Activation
    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "build.py")).read())  # defines _build, as the test's
    for name, case in json.load(open(os.path.join(work, "cases.json"))).items():
        data = np.load(os.path.join(work, f"{name}.npz"))
        m = _build(core, case["cfg"], case["searched"], device="cpu")
        ffmodel_state_from_numpy(m, {k: data[k] for k in data.files if k.startswith("n")})
        perf = m.fit(x=data["xs"], y=data["ys"], epochs=case["epochs"], shuffle=False,
                     verbose=False)
        names = [m.cg.layer_attrs(n).name for n in m.cg.topological_ordering()
                 if m.cg.layer_attrs(n).name and ".weight" in m.cg.layer_attrs(n).name]
        params = {n: m.get_parameter_by_name(n).get_weights(m) for n in names}
        np.savez(os.path.join(work, f"{name}_rank{rank}.npz"),
                 perf=json.dumps(vars(perf), default=float), kind=type(m.instance).__name__,
                 prov=json.dumps(m.search_provenance), **params)
    dist.destroy_process_group()
    """
)


def _weights(m):
    """The JAX model's weights by layer name (a searched plan's by its
    PCG's, which the JAX FFModel's get_weights does not read)."""
    g = getattr(m.instance, "pcg", m.cg)
    return {g.layer_attrs(n).name: np.asarray(m.params[f"n{n.idx}"])
            for n in g.topological_ordering()
            if g.layer_attrs(n).name and ".weight" in g.layer_attrs(n).name}


class _JaxPkg:
    FFModel, FFConfig, SGDOptimizer, Activation = FFModel, FFConfig, SGDOptimizer, Activation


def _jax_case(name, case, work):
    cfg = dict(case["cfg"])
    if name == "searched":
        cfg["export_strategy_file"] = str(work / "jax_strategy.json")
    if name == "imported":
        cfg["import_strategy_file"] = str(work / "jax_strategy.json")
    m = _build(_JaxPkg, cfg, case["searched"])
    init = {k: np.array(v) for k, v in m.params.items()}
    n, f, classes = case["samples"]
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(n, f).astype(np.float32), rs.randint(0, classes, n)
    perf = m.fit(x=xs, y=ys, epochs=case["epochs"], shuffle=False, verbose=False)
    np.savez(work / f"{name}.npz", xs=xs, ys=ys, **init)
    return dict(perf=vars(perf), weights=_weights(m), init=init, xs=xs, ys=ys,
                prov=m.search_provenance, kind=type(m.instance).__name__)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import inspect

    work = tmp_path_factory.mktemp("ffmodel_ranks")
    jax_runs = {name: _jax_case(name, case, work) for name, case in CASES.items()}
    port_cases = {k: dict(v) for k, v in CASES.items()}
    port_cases["searched"]["cfg"] = dict(CASES["searched"]["cfg"],
                                         export_strategy_file=str(work / "port_strategy.json"))
    port_cases["imported"]["cfg"] = dict(CASES["imported"]["cfg"],
                                         import_strategy_file=str(work / "jax_strategy.json"))
    (work / "cases.json").write_text(json.dumps(port_cases))
    (work / "build.py").write_text(f"METRICS = {METRICS!r}\n" + inspect.getsource(_build))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    port = {}
    for name in CASES:
        port[name] = []
        for r in range(RANKS):
            z = dict(np.load(work / f"{name}_rank{r}.npz"))
            port[name].append(dict(perf=json.loads(str(z.pop("perf"))), kind=str(z.pop("kind")),
                                   prov=json.loads(str(z.pop("prov"))), weights=z))
    return dict(jax=jax_runs, port=port, work=work)


def _same_training(want, got):
    for key in ("train_all", "train_correct"):
        assert got["perf"][key] == want["perf"][key], key
    np.testing.assert_allclose(got["perf"]["sparse_cce_loss"], want["perf"]["sparse_cce_loss"],
                               rtol=1e-5)
    assert got["weights"].keys() == want["weights"].keys()
    for k, w in want["weights"].items():
        assert np.linalg.norm(got["weights"][k] - w) <= 1e-5 * np.linalg.norm(w), k


def test_data_parallel_fit_gives_the_jax_counts_and_parameters(runs):
    want = runs["jax"]["dp"]
    assert want["perf"]["train_all"] == 64 * 5
    for got in runs["port"]["dp"]:
        assert got["kind"] == "DataParallelTrainingInstance"
        _same_training(want, got)


def test_searched_compile_finds_the_jax_winner(runs):
    want = runs["jax"]["searched"]["prov"]
    assert want["parallel_degrees"]  # tensor parallel, not the serial plan
    for got in runs["port"]["searched"]:
        assert got["kind"] == "DistributedTrainingInstance"
        assert got["prov"]["parallel_degrees"] == want["parallel_degrees"]
        assert np.isclose(got["prov"]["estimated_ms"], want["estimated_ms"], rtol=1e-9)


def test_searched_compile_trains_to_the_jax_losses(runs):
    for got in runs["port"]["searched"]:
        _same_training(runs["jax"]["searched"], got)


def test_a_strategy_the_jax_package_exports_trains_in_the_port(runs):
    prov = runs["port"]["imported"][0]["prov"]
    assert prov["search_algorithm"] == "imported_strategy"
    assert prov["verify"] == runs["jax"]["imported"]["prov"]["verify"]
    for got in runs["port"]["imported"]:
        _same_training(runs["jax"]["imported"], got)


def test_a_strategy_the_port_exports_imports_into_the_jax_package(runs):
    work = runs["work"]
    port_doc = json.loads((work / "port_strategy.json").read_text())
    assert port_doc == json.loads((work / "jax_strategy.json").read_text())
    case = CASES["imported"]
    m = _build(_JaxPkg, dict(case["cfg"], import_strategy_file=str(work / "port_strategy.json")),
               True)
    want = runs["jax"]["imported"]
    # the same plan from the same seed: the same initial parameters
    assert {k: np.asarray(v).tolist() for k, v in m.params.items()} == {
        k: v.tolist() for k, v in want["init"].items()}
    perf = m.fit(x=want["xs"], y=want["ys"], epochs=case["epochs"], shuffle=False, verbose=False)
    _same_training(want, dict(perf=vars(perf), weights=_weights(m)))


@pytest.fixture
def one_rank_group(tmp_path):
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel import init_file_group

    init_file_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _port_model(**cfg):
    from flexflow_tpu_torch import core

    m = core.FFModel(core.FFConfig(**cfg), device="cpu")
    x = m.create_tensor([6, 32], name="x")
    m.dense(m.relu(m.dense(x, 16, use_bias=False, name="fc1")), 4, use_bias=False, name="out")
    return m, core


def test_the_devices_of_a_compile_are_the_groups_ranks(one_rank_group, monkeypatch):
    """As the JAX package cuts the count: max_devices, then the largest
    count that divides the batch; a count other than the group's size
    raises, and a group of one compiles for one device."""
    import torch.distributed as dist

    m, core = _port_model(batch_size=6)
    m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
    assert type(m.instance).__name__ == "ModelTrainingInstance"
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    m, core = _port_model(batch_size=6)  # 4 ranks, batch 6: a compile over 3
    with pytest.raises(ValueError, match="spans 3 devices .* the process group has 4 ranks"):
        m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
    m, core = _port_model(batch_size=6, max_devices=2)
    with pytest.raises(ValueError, match="spans 2 devices .* has 4 ranks"):
        m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")


@pytest.mark.parametrize("flag,item", [(dict(hbm_gb=16.0), None),
                                       (dict(cost_store="store"), None),
                                       (dict(search_algorithm="mcmc", perform_fusion=True),
                                        None),
                                       (dict(pipeline=True), None),
                                       (dict(overlap=True), None)])
def test_unported_search_flags_raise_naming_their_item(one_rank_group, tmp_path, flag, item):
    """An unported flag is checked before the search runs, on the plan's
    first compile step. The cost store, MCMC and the overlap pricing (A6
    part 2), the pipeline seeds (A10) and the memory budget (A13) now
    search: a searched compile on the group of one rank records them in its
    provenance (the stores and searches against the JAX package:
    tests/test_torch_port_cost_store.py, test_torch_port_mcmc.py,
    test_torch_port_overlap.py, test_torch_port_pipeline.py,
    test_torch_port_verify.py); one device has no stage to cut, so the
    pipelined compile is flat there.""" 
    if "cost_store" in flag:  # measured on the host, so the search writes its leaves
        flag = dict(cost_store=str(tmp_path), cost_model="measured")
    m, _ = _port_model(batch_size=6, search_budget=2, **flag)
    if item is not None:
        with pytest.raises(NotImplementedError, match=item):
            m._compile_searched(m._last_output, 2, None)
        return
    inst = m._compile_searched(m._last_output, 1, None)
    assert type(inst).__name__ == "DistributedTrainingInstance"
    sp = m.search_provenance
    assert sp["search_algorithm"] == flag.get("search_algorithm", "unity")
    if "hbm_gb" in flag:
        assert sp["memory"]["hbm_gb"] == 16.0 and sp["verify"]["clean"]
    if "cost_store" in flag:
        assert sp["cost_db"]["device_kind"] == "cpu:cpu" and sp["cost_db"]["op_misses"] > 0
        assert (tmp_path / "cost_db.json").exists()
    if "overlap" in flag:
        assert sp["overlap"]["enabled"] and sp["overlap"]["priced"]
