"""Render one legacy substitution rule as a graphviz dot document (port of
bin/substitution_to_dot.py).

Reference: bin/substitution-to-dot/substitution_to_dot.cc — same
`<json-file> <rule-name>` CLI; src (pattern) ops on the left cluster, dst
(rewrite) ops on the right, tensors as edges labelled opId:tsId.

Usage:
  python -m flexflow_tpu_torch.tools.substitution_to_dot rules.json taso_rule_0
"""

import sys

from flexflow_tpu_torch.substitutions.legacy_rules import load_rule_collection_from_path


def rule_to_dot(rule) -> str:
    lines = ["digraph substitution {", "  rankdir=LR;"]

    def emit(ops, side):
        lines.append(f"  subgraph cluster_{side} {{")
        lines.append(f'    label="{side}Op";')
        for i, op in enumerate(ops):
            para = ", ".join(f"{p.key}={p.value}" for p in op.para)
            label = op.op_type + (f"\\n{para}" if para else "")
            lines.append(f'    {side}{i} [label="{label}"];')
        lines.append("  }")
        for i, op in enumerate(ops):
            for t in op.input:
                if t.opId < 0:
                    gi = f"{side}_in{-t.opId}"
                    lines.append(
                        f'  {gi} [label="input {t.opId}" shape=box];'
                    )
                    lines.append(f"  {gi} -> {side}{i};")
                else:
                    lines.append(
                        f'  {side}{t.opId} -> {side}{i} '
                        f'[label="ts{t.tsId}"];'
                    )

    emit(rule.srcOp, "src")
    emit(rule.dstOp, "dst")
    for m in rule.mappedOutput:
        lines.append(
            f"  src{m.srcOpId} -> dst{m.dstOpId} "
            f'[style=dashed label="out {m.srcTsId}->{m.dstTsId}"];'
        )
    lines.append("}")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print("Usage: python -m flexflow_tpu_torch.tools.substitution_to_dot "
              "<json-file> <rule-name>", file=sys.stderr)
        return 1
    json_path, rule_name = argv
    collection = load_rule_collection_from_path(json_path)
    for rule in collection.rules:
        if rule.name == rule_name:
            print(rule_to_dot(rule))
            return 0
    print(f"Could not find rule with name {rule_name}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
