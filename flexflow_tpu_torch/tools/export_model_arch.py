"""Export a model-zoo computation graph as JSON, optionally with its
series-parallel decomposition or a dot rendering (port of
bin/export_model_arch.py, over the port's models/, utils/graph and the
machine-mapping problem tree).

Reference: bin/export-model-arch/src/export_model_arch.cc — same positional
model argument and --sp-decomposition / --dot / --preprocessed-dot flags
(the reference's debugging surface for the compiler's SP machinery).

Usage:
  python -m flexflow_tpu_torch.tools.export_model_arch transformer
  python -m flexflow_tpu_torch.tools.export_model_arch split_test --sp-decomposition
  python -m flexflow_tpu_torch.tools.export_model_arch bert --dot
"""

import argparse
import json
import sys

from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _augment_source_layers
from flexflow_tpu_torch.models import (
    BertConfig,
    InceptionV3Config,
    get_bert_computation_graph,
    get_candle_uno_computation_graph,
    get_default_candle_uno_config,
    get_default_transformer_config,
    get_inception_v3_computation_graph,
    get_split_test_computation_graph,
    get_transformer_computation_graph,
)
from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.pcg import ComputationGraphBuilder
from flexflow_tpu_torch.pcg.file_format import computation_graph_to_json
from flexflow_tpu_torch.utils.graph import Node
from flexflow_tpu_torch.utils.graph.algorithms import get_transitive_reduction
from flexflow_tpu_torch.utils.graph.series_parallel import (
    ParallelSplit,
    SeriesSplit,
    get_series_parallel_decomposition,
    sp_tree_sort_key,
)

MODEL_OPTIONS = (
    "transformer",
    "inception_v3",
    "candle_uno",
    "bert",
    "split_test",
    "single_operator",
)


def get_model_computation_graph(name: str):
    if name == "transformer":
        return get_transformer_computation_graph(get_default_transformer_config())
    if name == "inception_v3":
        return get_inception_v3_computation_graph(InceptionV3Config())
    if name == "candle_uno":
        return get_candle_uno_computation_graph(get_default_candle_uno_config())
    if name == "bert":
        return get_bert_computation_graph(BertConfig())
    if name == "split_test":
        return get_split_test_computation_graph(batch_size=8)
    if name == "single_operator":
        # reference export_model_arch.cc get_single_operator_computation_graph
        b = ComputationGraphBuilder()
        x = b.create_input([8, 16, 12], name="input")
        b.dense(
            x, 16, activation=Activation.RELU, use_bias=True,
            name="my_example_operator",
        )
        return b.graph
    raise SystemExit(f"Unknown model name: {name}")


def sp_decomposition_json(cg):
    """Nested {series: [...]} / {parallel: [...]} / node-index tree
    (reference JsonSPModelExport's V1BinarySPDecomposition)."""
    # same preprocessing as the compile stack (problem_tree.py): raw
    # transitive reduction first, then the reference's weight/input-layer
    # all-to-all augmentation
    sp = get_series_parallel_decomposition(
        get_transitive_reduction(cg.digraph())
    )
    if sp is None:
        sp = get_series_parallel_decomposition(
            get_transitive_reduction(_augment_source_layers(cg))
        )
    if sp is None:
        raise SystemExit(
            "Failed to generate series-parallel decomposition of "
            "computation graph."
        )

    def render(t):
        if isinstance(t, Node):
            return t.idx
        if isinstance(t, SeriesSplit):
            return {"series": [render(c) for c in t.children]}
        assert isinstance(t, ParallelSplit)
        return {
            "parallel": [
                render(c) for c in sorted(t.children, key=sp_tree_sort_key)
            ]
        }

    return render(sp)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", choices=MODEL_OPTIONS)
    p.add_argument(
        "--sp-decomposition",
        action="store_true",
        help="also output a series parallel decomposition of the model's "
        "computation graph",
    )
    p.add_argument(
        "--dot",
        action="store_true",
        help="output a dot representation of the model's computation graph",
    )
    p.add_argument(
        "--preprocessed-dot",
        action="store_true",
        help="output a dot representation of the model's computation graph "
        "preprocessed to help check series-parallel structure",
    )
    args = p.parse_args(argv)

    cg = get_model_computation_graph(args.model)

    if args.dot or args.preprocessed_dot:
        print(cg.as_dot())
        return 0

    doc = {"computation_graph": json.loads(computation_graph_to_json(cg))}
    if args.sp_decomposition:
        doc["sp_decomposition"] = sp_decomposition_json(cg)
    print(json.dumps(doc, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
