"""Cost attribution and the roofline report of the port (flexflow_tpu_torch/
observability/cost_attribution.py, roofline.py) against the JAX package's,
on the CPU:

- analytic_op_costs on the small flagship and the spec MLP equals the JAX
  package's exactly (keys, names, op types, flops, bytes);
- attribute_costs and roofline_report with program=None, from the same
  per-op milliseconds (and from none: the analytic weights) and step time,
  agree within 1e-9;
- step_cost_analysis answers None (no compiled program to ask), and
  measure_per_op_ms times every compute op of the graph;
- classify_op and the H100's constants."""

import numpy as np
import pytest

from flexflow_tpu.core import FFConfig as JConfig, FFModel as JModel
from bench import build_flagship_cg as jax_flagship
from flexflow_tpu.observability import cost_attribution as jca, roofline as jrl
from flexflow_tpu_torch.core import FFConfig, FFModel
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.observability import cost_attribution as tca, roofline as trl

SMALL = dict(batch=2, seq=128, embed=256, heads=2, layers=2, vocab=512)


def _mlp(pkg_model, pkg_config, **kw):
    m = pkg_model(pkg_config(batch_size=16), **kw)
    x = m.create_tensor([16, 32], name="x")
    m.dense(m.relu(m.dense(x, 64, name="fc1")), 10, name="head")
    return m.cg


def _graphs():
    (tcg, _), (jcg, _) = build_flagship_cg(**SMALL), jax_flagship(**SMALL)
    yield "flagship", getattr(tcg, "graph", tcg), getattr(jcg, "graph", jcg)
    yield "mlp", _mlp(FFModel, FFConfig, device="cpu"), _mlp(JModel, JConfig)


@pytest.mark.parametrize("which", ["flagship", "mlp"])
def test_analytic_op_costs_are_the_jax_packages(which):
    (_, tcg, jcg), = [g for g in _graphs() if g[0] == which]
    got, want = tca.analytic_op_costs(tcg), jca.analytic_op_costs(jcg)
    assert [vars(o) for o in got] == [vars(o) for o in want]
    assert sum(o.flops for o in got) > 0


@pytest.mark.parametrize("measured", [True, False])
def test_attribution_and_roofline_match_the_jax_packages(measured):
    (_, tcg, jcg), = [g for g in _graphs() if g[0] == "flagship"]
    rs = np.random.RandomState(0)
    t_nodes = [n for n in tcg.topological_ordering()]
    j_nodes = [n for n in jcg.topological_ordering()]
    ms = {n.idx: float(rs.uniform(0.01, 2.0)) for n in t_nodes}
    per_t = {n: ms[n.idx] for n in t_nodes} if measured else None
    per_j = {n: ms[n.idx] for n in j_nodes} if measured else None
    got = tca.attribute_costs(tcg, 37.5, per_op_ms=per_t, program=None)
    want = jca.attribute_costs(jcg, 37.5, per_op_ms=per_j, program=None)
    for key in ("step_ms", "attributed_ms", "raw_total_ms", "scale"):
        assert getattr(got, key) == pytest.approx(getattr(want, key), rel=1e-9, abs=1e-12)
    assert (got.source, got.ms_source, got.flops_source, got.bytes_source) == (
        want.source, want.ms_source, want.flops_source, want.bytes_source)
    for g, w in zip(got.ops, want.ops):
        assert (g.key, g.name, g.op_type, g.flops, g.bytes) == (
            w.key, w.name, w.op_type, w.flops, w.bytes)
        assert g.measured_ms == pytest.approx(w.measured_ms, rel=1e-9, abs=1e-12)
    rt = trl.roofline_report(got, trl.H100_PEAK_FLOPS, trl.H100_HBM_GBPS, top_n=5)
    rj = jrl.roofline_report(want, trl.H100_PEAK_FLOPS, trl.H100_HBM_GBPS, top_n=5)
    assert rt.keys() == rj.keys()
    for key in rt:
        if isinstance(rt[key], float):
            assert rt[key] == pytest.approx(rj[key], rel=1e-9, abs=1e-12), key
        elif key != "ops":
            assert rt[key] == rj[key], key
    assert [(o["name"], o["bound"]) for o in rt["ops"]] == [
        (o["name"], o["bound"]) for o in rj["ops"]]


def test_step_cost_analysis_is_none_and_per_op_ms_times_every_op():
    (_, tcg, _), = [g for g in _graphs() if g[0] == "mlp"]
    assert tca.step_cost_analysis(lambda x: x, 1.0) is None
    logit = [o for n in tcg.topological_ordering() for o in tcg.outputs_of(n)][-1]
    per_op = tca.measure_per_op_ms(
        tcg, {"x": np.random.RandomState(0).randn(16, 32).astype(np.float32)}, logit,
        device="cpu")
    ops = {o.key for o in tca.analytic_op_costs(tcg)}
    assert {f"n{n.idx}" for n in per_op} == ops and all(v >= 0 for v in per_op.values())
    att = tca.attribute_costs(tcg, 1.0, per_op_ms=per_op)
    assert att.attributed_ms == pytest.approx(1.0) and att.ms_source == "measured"


@pytest.mark.parametrize("args", [(1e9, 1e6, 1.0), (1e12, 1e3, 1e-5), (1e6, 1e9, 0.5),
                                  (1e6, 1e3, 50.0)])
def test_classify_op_is_the_jax_packages(args):
    assert trl.classify_op(*args, 989e12, 3350.0) == jrl.classify_op(*args, 989e12, 3350.0)


def test_the_machine_constants_are_the_h100s_or_a_calibrations():
    from flexflow_tpu_torch.compiler.calibration import MachineCalibration

    assert trl.machine_constants() == {"peak_flops": 989e12, "hbm_gbps": 3350.0,
                                       "source": "h100_datasheet"}
    cal = MachineCalibration("cuda", 1, 7e14, 3000.0)
    assert trl.machine_constants(cal) == {"peak_flops": 7e14, "hbm_gbps": 3000.0,
                                          "source": "calibration"}
