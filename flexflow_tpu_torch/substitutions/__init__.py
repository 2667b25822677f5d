"""PCG rewrite engine: patterns, matcher, substitution application (copy of
flexflow_tpu/substitutions without the JAX package's native matcher), with
the fusion rules (fusion_rules.py) and the legacy TASO-JSON loader
(legacy_rules.py).

Equivalent of reference lib/substitutions (SURVEY.md §2.5):
declarative attribute patterns over an open dataflow graph, subgraph-isomorphism
matching, and substitution application with fresh ids + full shape
re-inference. Also the programmatically generated parallelization rule set
(partition/combine/replicate/reduction introduction around Linear/MHA/Conv &
friends) that seeds the Unity search — the reference loads equivalent rules
from legacy TASO-style JSON (lib/substitution-generator).
"""

from flexflow_tpu_torch.substitutions.operator_pattern import (
    OperatorAttributeKey,
    ConstraintType,
    OperatorAttributeConstraint,
    OperatorAttributePattern,
    op_attrs_satisfy_pattern,
)
from flexflow_tpu_torch.substitutions.tensor_pattern import (
    TensorAttributeKey,
    TensorAttributeConstraint,
    TensorAttributePattern,
    tensor_attrs_satisfy_pattern,
)
from flexflow_tpu_torch.substitutions.pcg_pattern import (
    PCGPattern,
    PatternMatch,
    find_pattern_matches,
)
from flexflow_tpu_torch.substitutions.output_graph import (
    AttrConstant,
    CopyAttrsFromMatched,
    OutputGraphExpr,
)
from flexflow_tpu_torch.substitutions.substitution import (
    Substitution,
    apply_substitution,
    is_valid_match_for_substitution,
)
from flexflow_tpu_torch.substitutions.rules import (
    data_parallel_linear_rule,
    tensor_parallel_linear_rule,
    reduction_parallel_linear_rule,
    head_parallel_attention_rule,
    data_parallel_op_rule,
    combine_reduction_cancel_rules,
    generate_parallelization_rules,
)
