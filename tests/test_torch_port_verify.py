"""The port's PCG verifier and memory verification (flexflow_tpu_torch/
analysis/pcg_verify.py, memory_analysis.py) against the JAX package's:

- each broken PCG of tests/test_static_analysis.py::TestVerifierNegativePaths,
  built in both packages from one builder, gives the same diagnostics:
  rule id, severity, node and tensor, in order (PCG001-PCG007, MV001-MV004,
  the clean branch mappings);
- the pipeline rules PCG009-PCG011 and the overlap annotation rule PCG008
  on the same stage-partitioned and annotated PCGs;
- the memory analysis's per-device peaks and MEM verdicts of the small
  flagship's seeds, mapped and on the full mesh, equal;
- FFModel's searched compile on 2 gloo ranks at an `hbm_gb` that prunes
  the serial plan, against the JAX FFModel on 2 virtual CPU devices: the
  same winner, the same search_provenance["verify"] and the same
  predicted peaks in ["memory"], and the records the JAX compile makes
  (["comm"], ["exec"]) present, clean;
- FF_TPU_VERIFY=1 verifies every candidate inside apply_substitution.

Tolerance: the diagnostics and the byte counts are exact."""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _ns(root):
    """The classes the builders take, from package `root`."""
    mods = [importlib.import_module(f"{root}.{m}") for m in (
        "op_attrs.ops", "op_attrs.parallel_tensor_shape", "op_attrs.tensor_shape",
        "op_attrs.datatype", "pcg.machine_view", "pcg.parallel_computation_graph", "pcg")]
    ns = types.SimpleNamespace()
    for m in mods:
        for k in dir(m):
            if not k.startswith("_"):
                setattr(ns, k, getattr(m, k))
    ns.verify = importlib.import_module(f"{root}.analysis.pcg_verify")
    ns.mem = importlib.import_module(f"{root}.analysis.memory_analysis")
    ns.root = root
    return ns


J, T = _ns("flexflow_tpu"), _ns("flexflow_tpu_torch")


def pts(ns, dims, degrees=None, sum_degree=1, dtype=None):
    degrees = degrees or [1] * len(dims)
    return ns.ParallelTensorShape(
        ns.ParallelTensorDims(tuple(ns.ShardParallelDim(s, d) for s, d in zip(dims, degrees)),
                              sum_degree, 1),
        dtype or ns.DataType.FLOAT)


def add(ns, g, attrs, ins, shapes, name=None):
    _, outs = g.add_node(ns.ParallelLayerAttrs(attrs, name), ins,
                         [ns.ParallelTensorAttrs(s) for s in shapes])
    return outs[0] if len(outs) == 1 else outs


def _view(ns, start_dev, *dims):
    return ns.MachineView(ns.MachineSpaceCoordinate(0, start_dev), tuple(
        ns.MachineViewDimension(s, ns.ProjectionType.INTRA_NODE) for s in dims))


# -- the broken PCGs, one builder for both packages ---------------------------


def pcg001(ns):
    bad = ns.ShardParallelDim.__new__(ns.ShardParallelDim)
    object.__setattr__(bad, "size", 7)
    object.__setattr__(bad, "degree", 2)
    g = ns.ParallelComputationGraph()
    add(ns, g, ns.InputAttrs(ns.TensorShape((14,))), [],
        [ns.ParallelTensorShape(ns.ParallelTensorDims((bad,), 1, 1), ns.DataType.FLOAT)], "x")
    return g, None, None


def pcg002(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((16, 16))), [], [pts(ns, [16, 16])], "x")
    r = add(ns, g, ns.RepartitionAttrs(0, 3), [x], [pts(ns, [16, 16])])
    add(ns, g, ns.ElementUnaryAttrs(ns.ElementUnaryOpType.RELU), [r], [pts(ns, [16, 16])])
    return g, None, None


def pcg003(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((16, 16))), [], [pts(ns, [16, 16])], "x")
    r = add(ns, g, ns.RepartitionAttrs(0, 2), [x], [pts(ns, [16, 16], [2, 1])])
    add(ns, g, ns.CombineAttrs(0, 2), [r], [pts(ns, [16, 16], [2, 1])])
    return g, None, None


def pcg004(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((8, 8))), [], [pts(ns, [8, 8])], "x")
    add(ns, g, ns.ElementUnaryAttrs(ns.ElementUnaryOpType.RELU), [x],
        [pts(ns, [8, 8], dtype=ns.DataType.BFLOAT16)])
    return g, None, None


def pcg005(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((16, 16))), [], [pts(ns, [16, 16])], "x")
    w = add(ns, g, ns.WeightAttrs(ns.TensorShape((16, 8))), [], [pts(ns, [16, 8])], "w")
    rx = add(ns, g, ns.RepartitionAttrs(-1, 2), [x], [pts(ns, [16, 16], [1, 2])])
    rw = add(ns, g, ns.RepartitionAttrs(0, 2), [w], [pts(ns, [16, 8], [2, 1])])
    add(ns, g, ns.LinearAttrs(out_channels=8, use_bias=False), [rx, rw],
        [pts(ns, [16, 8], sum_degree=2)])
    return g, None, None


def pcg006(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((16, 16))), [], [pts(ns, [16, 16])], "x")
    add(ns, g, ns.ElementUnaryAttrs(ns.ElementUnaryOpType.RELU), [x], [pts(ns, [16, 16])])
    add(ns, g, ns.RepartitionAttrs(0, 2), [x], [pts(ns, [16, 16], [2, 1])])
    return g, None, None


def pcg007(ns):
    b = ns.ComputationGraphBuilder()
    x = b.create_input([8, 8], name="x")
    a = b.relu(x, name="a")
    bb = b.gelu(x, name="b")
    c = b.relu(a, name="c")
    d = b.add(a, bb, name="d")
    b.add(c, d, name="e")
    return ns.pcg_from_computation_graph(b.graph), None, None


def _branch(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((16, 16))), [], [pts(ns, [16, 16])], "x")
    vals = {}
    for tag, op in (("a", ns.ElementUnaryOpType.RELU), ("b", ns.ElementUnaryOpType.GELU)):
        r = add(ns, g, ns.RepartitionAttrs(0, 2), [x], [pts(ns, [16, 16], [2, 1])], f"r{tag}")
        u = add(ns, g, ns.ElementUnaryAttrs(op), [r], [pts(ns, [16, 16], [2, 1])], tag)
        vals[tag] = add(ns, g, ns.CombineAttrs(0, 2), [u], [pts(ns, [16, 16])], f"c{tag}")
    add(ns, g, ns.ElementBinaryAttrs(ns.ElementBinaryOpType.ADD), [vals["a"], vals["b"]],
        [pts(ns, [16, 16])], "add")
    return g


def _branch_mapping(ns, g, a_start=0, b_start=2, a_stride=1):
    mapping = {}
    for n in g.nodes:
        name = g.layer_attrs(n).name or ""
        shape = g.tensor_shape(g.outputs_of(n)[0])
        degree2 = any(d.degree == 2 for d in shape.dims.shard_dims)
        start = {"a": a_start, "b": b_start}.get(name[-1:], 0)
        stride = a_stride if name.endswith("a") else 1
        mapping[n] = _view(ns, start, stride) if degree2 else _view(ns, start, 1)
    return mapping


def _spec4(ns):
    return ns.MachineSpecification(1, 1, 4, 25.0, 400.0)


def mv001(ns):
    g = _branch(ns)
    mapping = _branch_mapping(ns, g)
    (bad,) = [n for n in g.nodes if g.layer_attrs(n).name == "add"]
    mapping[bad] = _view(ns, 0, 1, 1)
    return g, _spec4(ns), mapping


def mv002(ns):
    g = _branch(ns)
    return g, _spec4(ns), _branch_mapping(ns, g, a_stride=4)


def mv003(ns):
    g = _branch(ns)
    return g, _spec4(ns), _branch_mapping(ns, g, a_start=0, b_start=1)


def mv004(ns):
    g = ns.ParallelComputationGraph()
    x = add(ns, g, ns.InputAttrs(ns.TensorShape((16, 16))), [], [pts(ns, [16, 16])], "x")
    r = add(ns, g, ns.RepartitionAttrs(1, 2), [x], [pts(ns, [16, 16], [1, 2])], "r")
    u = add(ns, g, ns.ElementUnaryAttrs(ns.ElementUnaryOpType.RELU), [r],
            [pts(ns, [16, 16], [1, 2])], "u")
    add(ns, g, ns.CombineAttrs(1, 2), [u], [pts(ns, [16, 16])], "c")
    inter = ns.MachineView(ns.MachineSpaceCoordinate(0, 0),
                           (ns.MachineViewDimension(1, ns.ProjectionType.INTER_NODE),))
    mapping = {}
    for n in g.nodes:
        shape = g.tensor_shape(g.outputs_of(n)[0])
        sharded = any(d.degree == 2 for d in shape.dims.shard_dims)
        mapping[n] = inter if sharded else _view(ns, 0, 1)
    return g, ns.MachineSpecification(2, 1, 2, 2.0, 25.0), mapping


def disjoint(ns):
    g = _branch(ns)
    return g, _spec4(ns), _branch_mapping(ns, g)


def colocated(ns):
    g = _branch(ns)
    return g, _spec4(ns), _branch_mapping(ns, g, a_start=0, b_start=0)


def pipeline(ns):
    """An MLP trunk's pp2m4 x dp2 seed: PCG009-PCG011 on 2 and 4 devices
    (2 stages of degree 2 fit 4 devices, not 2)."""
    from importlib import import_module

    unity = import_module(f"{ns.root}.compiler.unity_algorithm")
    b = ns.ComputationGraphBuilder()
    h = b.create_input([16, 32], name="x")
    for i in range(4):
        h = b.relu(b.dense(h, 32, use_bias=False, name=f"fc{i}"))
    pcg = ns.pcg_from_computation_graph(b.graph)
    return unity.pipeline_seed(pcg, 2, 4, 2), ns.MachineSpecification(1, 1, 2, 25.0, 400.0), None


def _key(d):
    return (d.rule_id, d.severity.value, d.node, d.tensor)


CASES = [pcg001, pcg002, pcg003, pcg004, pcg005, pcg006, pcg007, mv001, mv002, mv003, mv004,
         disjoint, colocated]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_broken_pcgs_give_the_jax_diagnostics(case):
    jg, js, jm = case(J)
    tg, ts, tm = case(T)
    want = [_key(d) for d in J.verify.verify_pcg(jg, js, jm, check_sp=case is not pcg001)]
    got = [_key(d) for d in T.verify.verify_pcg(tg, ts, tm, check_sp=case is not pcg001)]
    assert got == want
    errors = {d[0] for d in got if d[1] == "error"}
    if case in (disjoint, colocated):
        assert not errors
    else:
        assert case.__name__.upper() in errors, got


def test_pipeline_rules_give_the_jax_diagnostics():
    jg, js, _ = pipeline(J)
    tg, ts, _ = pipeline(T)
    rules = []
    for spec_j, spec_t in ((js, ts), (J.MachineSpecification(1, 1, 4, 25.0, 400.0),
                                      T.MachineSpecification(1, 1, 4, 25.0, 400.0))):
        want = [_key(d) for d in J.verify.verify_pcg(jg, spec_j)]
        got = [_key(d) for d in T.verify.verify_pcg(tg, spec_t)]
        assert got == want
        rules.append({d[0] for d in got})
    assert rules == [{"PCG011"}, set()]  # 2 stages of degree 2 fit 4 devices, not 2


def test_overlap_annotations_give_the_jax_diagnostics():
    """PCG008 on the tp2 flagship: each Combine and Reduction annotated
    with both kinds (the right one clean, the wrong one an error), and a
    node that is not in the PCG."""
    import bench
    from flexflow_tpu.compiler.unity_algorithm import tensor_parallel_seed as jtp
    from flexflow_tpu_torch.compiler.unity_algorithm import tensor_parallel_seed as ttp
    from flexflow_tpu_torch.models import build_flagship_pcg

    small = dict(batch=4, seq=16, embed=32, heads=2, layers=1, vocab=64)
    jg, tg = jtp(bench.build_flagship_pcg(**small), 2), ttp(build_flagship_pcg(**small), 2)
    plan = {}
    for n in sorted(tg.nodes, key=lambda n: n.idx):
        kind = type(tg.op_attrs(n)).__name__
        if kind in ("CombineAttrs", "ReductionAttrs"):
            plan[n.idx] = "ag_matmul" if len(plan) % 2 else "matmul_rs"
    plan[10_000] = "ag_matmul"
    plan[0] = "bogus"
    want = [_key(d) for d in J.verify.verify_overlap_plan(jg, plan)]
    got = [_key(d) for d in T.verify.verify_overlap_plan(tg, plan)]
    assert got == want and got


@pytest.mark.parametrize("seed", ["dp2", "tp2", "dp2xtp2"])
@pytest.mark.parametrize("mapped", [False, True])
def test_memory_peaks_and_verdicts_are_the_jax_packages(seed, mapped):
    """The small flagship's seeds: the per-device peaks (mapped on the DP's
    views, or on the full mesh) and the MEM verdicts at a capacity between
    the smallest and the largest peak."""
    import bench
    from flexflow_tpu.compiler import unity_algorithm as JU
    from flexflow_tpu.compiler.machine_mapping.get_optimal_machine_mapping import (
        MachineMappingCache as JCache,
    )
    from flexflow_tpu_torch.compiler import unity_algorithm as TU
    from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
        MachineMappingCache as TCache,
    )
    from flexflow_tpu_torch.models import build_flagship_pcg
    from test_torch_port_search import _estimators

    small = dict(batch=8, seq=32, embed=64, heads=2, layers=2, vocab=128)
    n = 4 if seed == "dp2xtp2" else 2
    out = []
    for U, build, Cache, ns in ((JU, bench.build_flagship_pcg, JCache, J),
                                (TU, build_flagship_pcg, TCache, T)):
        pcg = build(**small)
        if "tp2" in seed:
            pcg = U.tensor_parallel_seed(pcg, 2)
        if "dp2" in seed:
            pcg = U.data_parallel_seed(pcg, 2)
        spec = ns.MachineSpecification(1, 1, n, 25.0, 400.0)
        mapping = None
        if mapped:
            ctx = _estimators(n)[3 if ns is J else 1]
            mapping = U.evaluate_pcg(pcg, ctx, spec, Cache()).machine_mapping
        a = ns.mem.analyze_memory(pcg, spec, mapping, optimizer_state_slots=2)
        peaks = a.peak_by_device()
        cap = (min(peaks.values()) + max(peaks.values())) / 2 or 1.0
        _, diags = ns.mem.verify_memory(pcg, spec, mapping, hbm_bytes=cap,
                                        optimizer_state_slots=2)
        out.append((dict(peaks), [_key(d) for d in diags]))
    assert out[1] == out[0]


def test_ff_tpu_verify_checks_each_candidate(monkeypatch):
    """FF_TPU_VERIFY=1: every candidate apply_substitution builds is
    verified; a sound rule's candidates pass, and a verifier finding
    raises ValueError (the search's "rewrite rejected"), as the JAX
    package's."""
    from flexflow_tpu_torch.analysis import pcg_verify
    from flexflow_tpu_torch.analysis.diagnostics import error
    from flexflow_tpu_torch.analysis.rule_audit import registered_rules_for_grid
    from flexflow_tpu_torch.models import build_flagship_pcg
    from flexflow_tpu_torch.substitutions import substitution as S
    from flexflow_tpu_torch.substitutions.pcg_pattern import find_pattern_matches

    monkeypatch.setenv("FF_TPU_VERIFY", "1")
    pcg = build_flagship_pcg(batch=4, seq=16, embed=32, heads=2, layers=1, vocab=64)
    first = None
    for sub in registered_rules_for_grid(2):
        for match in find_pattern_matches(sub.pattern, pcg)[:1]:
            S.apply_substitution(pcg, sub, match)
            first = first or (sub, match)
    assert first is not None
    calls = []
    monkeypatch.setattr(pcg_verify, "verify_pcg_structure",
                        lambda g: calls.append(g) or [error("PCG003", "planted")])
    with pytest.raises(ValueError, match="FF_TPU_VERIFY: substitution"):
        S.apply_substitution(pcg, *first)
    assert len(calls) == 1


# -- FFModel's searched compile over 2 ranks ----------------------------------

BUILD = textwrap.dedent(
    """
    def _build(pkg, cfg, device=None):
        m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
        x = m.create_tensor([cfg["batch_size"], 256], name="x")
        t = m.relu(m.dense(x, 2048, use_bias=False, name="fc1"))
        m.dense(t, 16, use_bias=False, name="out")
        m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        return m
    """
)
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "build.py")).read())
    cfg = json.load(open(os.path.join(work, "cfg.json")))
    m = _build(core, cfg, device="cpu")
    json.dump(m.search_provenance, open(os.path.join(work, f"prov{rank}.json"), "w"),
              default=str)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def budgeted(tmp_path_factory):
    """(JAX provenance, the port's ranks' provenances) of the searched
    compile at an hbm_gb that prunes the serial plan."""
    from flexflow_tpu import core as jcore

    exec(BUILD, globals())
    work = tmp_path_factory.mktemp("verify_ranks")
    # the serial plan's per-device step peak on 2 devices (SGD, no slots):
    # ~4.6 MiB; a budget of 3.5 MiB prunes it and admits the tp2 winner
    cfg = dict(batch_size=64, print_freq=0, max_devices=2, search_budget=2,
               hbm_gb=3.5 / 1024)
    jm = _build(jcore, cfg)  # noqa: F821 (defined by BUILD)
    (work / "build.py").write_text(BUILD)
    (work / "cfg.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    return jm.search_provenance, [json.loads((work / f"prov{r}.json").read_text())
                                  for r in range(2)]


def test_budgeted_compile_finds_the_jax_winner(budgeted):
    want, ranks = budgeted
    assert want["parallel_degrees"]  # the budget pruned the serial plan
    for got in ranks:
        assert got["parallel_degrees"] == want["parallel_degrees"]
        assert np.isclose(got["estimated_ms"], want["estimated_ms"], rtol=1e-9)


def test_budgeted_compile_records_the_jax_verify_and_memory(budgeted):
    want, ranks = budgeted
    for got in ranks:
        assert got["verify"] == want["verify"]
        for key in ("predicted_peak_bytes_per_device", "predicted_peak_bytes_full_mesh",
                    "capacity_bytes", "hbm_gb", "optimizer_state_slots", "steps_per_dispatch"):
            assert got["memory"][key] == want["memory"][key], key


def test_budgeted_compile_records_comm_and_exec(budgeted):
    """The port records what the JAX compile records on every searched
    winner (exec always; comm's predictions always, its census here too):
    the same edges predicted, the census matched with no COMM001/COMM002,
    and an execution contract with no DET/DON finding, the same on both
    ranks."""
    want, ranks = budgeted
    assert ranks[0]["comm"] == ranks[1]["comm"]
    got = ranks[0]["comm"]
    assert [e["node"] for e in got["edges"]] == [e["node"] for e in want["comm"]["edges"]]
    assert [e["predicted_bytes"] for e in got["edges"]] == \
        [e["predicted_bytes"] for e in want["comm"]["edges"]]
    assert got["verify"]["clean"] and got["num_collectives"] > 0
    for r in ranks:
        ex = r["exec"]
        assert ex["verify"]["clean"] and ex["program_fingerprint"]
        assert ex["donation_coverage"] == 1.0 and not ex["determinism_findings"]
    assert ranks[0]["exec"]["program_fingerprint"] == ranks[1]["exec"]["program_fingerprint"]
    assert set(want["exec"]) - {"hlo_fingerprint"} <= set(ranks[0]["exec"]) | {"exec"}
