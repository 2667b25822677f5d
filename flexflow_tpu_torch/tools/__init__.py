"""Command-line tools over the port (ports of tools/cost_db.py,
tools/ffreport.py and bin/*.py), each run as

    python -m flexflow_tpu_torch.tools.<name> [arguments]

and each with a `main(argv)` that returns its exit code:

- cost_db: stats, verify and prune of a persistent cost store (no torch
  import);
- ffreport: the report of one run from its metrics directory;
- export_model_arch: a model-zoo graph as JSON, its series-parallel
  decomposition, or dot;
- substitution_to_dot: one legacy substitution rule as dot;
- protobuf_to_json: a legacy TASO rule collection from protobuf to JSON;
- arg_parser: FFConfig's command-line flags parsed and dumped as JSON.
"""
