"""The port's plan-transition verifier (flexflow_tpu_torch/analysis/
transition_analysis.py, TRN001-TRN004) against the JAX package's, on the
plan pairs of tests/test_transition.py built in both packages: the same
verdict, rules tripped, leaves (orphaned, created, drifted, moved), bulk
and streamed migration peaks and the whole summary record but the
movement-store keys, which name each package's device kind and link class,
and carry_remap's RNG line, which names each package's generator; TRN004 on a
recorded step that updates its state out of place; and FFModel.recompile's
transition records (an identity recompile swappable, batch growth TRN003
recorded without raising, preserve_resume raising TransitionError) against
the JAX FFModel's. Exact comparison (byte counts are integers)."""

import importlib

import pytest
import torch

PKGS = ("flexflow_tpu", "flexflow_tpu_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


RNG_REMAP = {"flexflow_tpu": "threefry key carried verbatim (same per-step fold schedule)",
             "flexflow_tpu_torch": "torch.Generator state carried verbatim "
                                   "(same per-step draw schedule)"}


def _named_rng(rec, pkg):
    """The record with carry_remap's RNG line checked against its package's
    generator and replaced by one word, so the rest compares exactly."""
    remap = dict(rec["carry_remap"])
    if "rng" in remap:
        assert remap["rng"] == RNG_REMAP[pkg]
        remap["rng"] = "carried"
    return dict(rec, carry_remap=remap)


def _mlp(pkg, batch=16, width=64, drop_fc2=False):
    b = _m(pkg, "pcg").ComputationGraphBuilder()
    x = b.create_input([batch, 32], name="x")
    h = b.relu(b.dense(x, width, use_bias=False, name="fc1"))
    if not drop_fc2:
        b.dense(h, 32, use_bias=False, name="fc2")
    return _m(pkg, "pcg.parallel_computation_graph").pcg_from_computation_graph(b.graph)


def _linear(pkg):
    b = _m(pkg, "pcg").ComputationGraphBuilder()
    b.dense(b.create_input([16, 32], name="x"), 64, use_bias=False, name="fc1")
    return _m(pkg, "pcg.parallel_computation_graph").pcg_from_computation_graph(b.graph)


def _spec(pkg):
    return _m(pkg, "pcg.machine_view").MachineSpecification(1, 1, 8, 25.0, 400.0)


def _mapped_seed(pkg, pcg, label):
    C = _m(pkg, "compiler")
    spec = _spec(pkg)
    est = (C.AnalyticTPUCostEstimator(spec) if pkg == "flexflow_tpu"
           else C.AnalyticGPUCostEstimator(spec, 197e12, 820.0))
    ctx = C.MachineMappingContext(est, C.make_default_allowed_machine_views())
    seed = dict(_m(pkg, "compiler.unity_algorithm").enumerate_seeds(pcg, 8))[label]
    r = C.evaluate_pcg(seed, ctx, spec, C.MachineMappingCache())
    return r.pcg, r.machine_mapping


def _pair(pkg, case):
    if case == "orphaned":
        return (_mlp(pkg), None, _mlp(pkg, drop_fc2=True), None), {}
    if case == "created":
        return (_mlp(pkg, drop_fc2=True), None, _mlp(pkg), None), {}
    if case == "drifted":
        return (_mlp(pkg, width=64), None, _mlp(pkg, width=48), None), {}
    if case == "over_memory":
        return (_mlp(pkg), None, _mlp(pkg), None), dict(hbm_bytes=1024.0)
    if case == "batch_schedule":
        return (_mlp(pkg, batch=16), None, _mlp(pkg, batch=32), None), {}
    if case == "restacking":
        return (_mlp(pkg), None, _mlp(pkg), None), dict(steps_per_dispatch=1,
                                                        steps_per_dispatch_new=4)
    old = _mapped_seed(pkg, _linear(pkg), "dp8xtp1xsp1")
    new = _mapped_seed(pkg, _linear(pkg), "dp2xtp4xsp1")
    hbm = 16 * 2**30 if case == "dp8_to_tp4" else 30000.0
    return (*old, *new), dict(machine_spec=_spec(pkg), hbm_bytes=hbm)


CASES = ["orphaned", "created", "drifted", "over_memory", "batch_schedule", "restacking",
         "dp8_to_tp4", "dp8_to_tp4_tight"]
EXPECT = {"orphaned": ["TRN001"], "created": ["TRN001"], "drifted": ["TRN001"],
          "over_memory": ["TRN002"], "batch_schedule": ["TRN003"], "restacking": [],
          "dp8_to_tp4": [], "dp8_to_tp4_tight": ["TRN002"]}


@pytest.mark.parametrize("case", CASES)
def test_transition_records_are_the_jax_packages(case):
    out = []
    for pkg in PKGS:
        ta = _m(pkg, "analysis.transition_analysis")
        args, kw = _pair(pkg, case)
        a, diags = ta.verify_transition(*args, **kw)
        rec = ta.transition_summary_json(a)
        keys = [leaf.pop("movement_key") for leaf in rec["per_leaf"]]
        out.append((_named_rng(rec, pkg), [(d.rule_id, d.severity.value, d.message) for d in diags], keys))
    assert out[1][:2] == out[0][:2]
    # the movement-store keys name each package's device kind and links
    # (JAX: "...|cpu:cpu|ici"; the port: "...|cpu:cpu|nvlink")
    for jkey, tkey in zip(out[0][2], out[1][2]):
        assert (jkey is None) == (tkey is None)
        if tkey is not None:
            assert tkey.endswith("|nvlink") and jkey.endswith("|ici")
    assert out[1][0]["rules_tripped"] == EXPECT[case]


def test_dp8_to_tp4_migration_peaks_are_the_hand_computed_ones():
    ta = _m("flexflow_tpu_torch", "analysis.transition_analysis")
    args, kw = _pair("flexflow_tpu_torch", "dp8_to_tp4")
    a, _ = ta.verify_transition(*args, **kw)
    (leaf,) = a.leaves
    assert (leaf.src_piece_bytes, leaf.dst_piece_bytes, leaf.moved_bytes) == (8192, 2048, 24576)
    assert (a.bulk_peak_bytes, a.streamed_peak_bytes) == (30720, 55296)
    assert a.migration_verdict == "bulk" and a.verdict == "swappable"


def test_trn004_on_a_step_that_updates_its_state_out_of_place():
    """The new plan's recorded step hands back new tensors for its state:
    DON001 inside, TRN004 on the transition."""
    from flexflow_tpu_torch.analysis.step_program import record_program
    from flexflow_tpu_torch.analysis.transition_analysis import verify_transition

    state = {"params": {"w": torch.zeros(64, 64)}, "opt_state": {"m": {"w": torch.zeros(64, 64)}}}

    def run(st):
        return {"params": {"w": st["params"]["w"] + 1}, "opt_state": st["opt_state"]}

    prog = record_program(run, state, ("params", "opt_state"), ["w:f32"], {})
    a, diags = verify_transition(_mlp("flexflow_tpu_torch"), None, _mlp("flexflow_tpu_torch"),
                                 None, lowered_new=prog)
    assert a.exec_verified and a.rules_tripped == ["TRN004"]
    assert "DON001" in next(d.message for d in diags if d.rule_id == "TRN004")


def _small_model(pkg, batch=8):
    core = _m(pkg, "core")
    m = core.FFModel(core.FFConfig(batch_size=batch, epochs=1, seed=0, print_freq=0),
                     **({"device": "cpu"} if pkg.endswith("torch") else {}))
    x = m.create_tensor([batch, 16], name="x")
    t = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    m.dense(t, 4, use_bias=False, name="out")
    m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=["accuracy"])
    return m


@pytest.mark.parametrize("case", ["identity", "batch_growth"])
def test_recompile_records_the_jax_transition(case):
    recs = []
    for pkg in PKGS:
        m = _small_model(pkg)
        if case == "batch_growth":
            m.config.batch_size = 16
        m.recompile()
        recs.append(_named_rng(m.search_provenance["transition"], pkg))
    assert recs[1] == recs[0]
    assert recs[1]["rules_tripped"] == ([] if case == "identity" else ["TRN003"])


def test_preserve_resume_raises_the_named_rule_before_the_state_moves():
    from flexflow_tpu_torch.analysis.transition_analysis import TransitionError

    m = _small_model("flexflow_tpu_torch")
    m.config.batch_size = 16
    with pytest.raises(TransitionError) as ei:
        m.recompile(preserve_resume=True)
    assert ei.value.rules == ["TRN003"] and "TRN003" in str(ei.value)
