"""The port's substitution soundness audit (flexflow_tpu_torch/analysis/
rule_audit.py, RULE001-RULE003) against the JAX package's: every rule of
both registries (`registered_rules_for_grid`: the parallelization rules at
each divisor degree, the pipeline stage rules, the fusion rules) audited in
both packages gives the same name, status, matches checked and
diagnostics (rule id, severity, message); an interface-breaking rule is
rejected alike; and the port's ffcheck --audit-rules / --all-templates
exit 0 in-process. Exact comparison."""

import pytest

from flexflow_tpu.analysis import rule_audit as J
from flexflow_tpu_torch.analysis import rule_audit as T


def _verdicts(mod, grid):
    results, _ = mod.audit_rules(mod.registered_rules_for_grid(grid))
    return [(r.name, r.status, r.matches_checked,
             [(d.rule_id, d.severity.value, d.message) for d in r.diagnostics])
            for r in results]


@pytest.mark.parametrize("grid", [2, 4, 8])
def test_every_rule_gets_the_jax_verdict(grid):
    want, got = _verdicts(J, grid), _verdicts(T, grid)
    assert got == want
    assert all(status == "ok" for _, status, _, _ in got)


def test_the_registry_holds_the_pipeline_stage_rules():
    names = [s.name for s in T.registered_rules_for_grid(8)]
    assert names == [s.name for s in J.registered_rules_for_grid(8)]
    assert any("stage" in n for n in names)


def _broken(pkg):
    """Linear -> Linear(Repartition(a), Replicate(w)) with no closing
    Combine: the output stays sharded (tests/test_static_analysis.py's)."""
    import importlib

    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    OperatorType = m("op_attrs.core").OperatorType
    ops = m("op_attrs.ops")
    OAP = m("substitutions.operator_pattern").OperatorAttributePattern
    og_mod = m("substitutions.output_graph")
    p = m("substitutions.pcg_pattern").PCGPattern()
    TAP = m("substitutions.tensor_pattern").TensorAttributePattern
    a = p.add_input(TAP.dim_divisible_by(0, 2))
    w = p.add_input()
    node, (y,) = p.add_operator(OAP.for_op_type(OperatorType.LINEAR, use_bias=False), [a, w])
    og = og_mod.OutputGraphExpr()
    oa, ow = og.add_input(), og.add_input()
    _, (ap,) = og.add_operator(og_mod.AttrConstant(ops.RepartitionAttrs(0, 2)), [oa])
    _, (wr,) = og.add_operator(og_mod.AttrConstant(ops.ReplicateAttrs(2)), [ow])
    _, (oy,) = og.add_operator(og_mod.CopyAttrsFromMatched(node), [ap, wr])
    Sub = m("substitutions.substitution").Substitution
    return Sub("broken_no_combine", p, og, ((a, oa), (w, ow)), ((y, oy),))


def test_an_interface_breaking_rule_is_rejected_alike():
    want = J.audit_substitution(_broken("flexflow_tpu"))
    got = T.audit_substitution(_broken("flexflow_tpu_torch"))
    assert (got.status, [d.rule_id for d in got.diagnostics]) == \
        (want.status, [d.rule_id for d in want.diagnostics]) == ("unsound", ["RULE002"])


@pytest.mark.parametrize("flags", [["--audit-rules"], ["--all-templates"],
                                   ["--all-templates", "--devices-per-node", "4"]])
def test_ffcheck_audits_and_templates_exit_zero(flags, capsys):
    from flexflow_tpu_torch import ffcheck

    assert ffcheck.main(flags) == 0
    assert "0 error(s)" in capsys.readouterr().out
