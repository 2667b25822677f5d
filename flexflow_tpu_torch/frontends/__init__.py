"""Model import frontends (port of flexflow_tpu/frontends; reference layer
10, SURVEY.md §1):

- torch_model: torch.fx tracing -> FFModel graph, and the JSON-lines IR
  (.ffir) files either package reads (reference
  python/flexflow/torch/model.py)
- keras_model: Keras-style Sequential/Model API (reference
  python/flexflow/keras/), keras_datasets its cache-only loaders
- onnx_model: ONNX graph import (reference python/flexflow/onnx/), through
  onnx_protobuf's wire-format reader where the `onnx` package is absent
"""
