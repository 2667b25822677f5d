"""ONNX frontend (port of flexflow_tpu/frontends/onnx_model.py).

Reference: python/flexflow/onnx/model.py (ONNXModel: walk
onnx.ModelProto.graph.node, map each op_type to FFModel layer calls, with a
MatMul+Add -> Dense fusion pre-pass). Loading a real .onnx file works with
OR without the `onnx` package: when it is absent the serialized ModelProto
is decoded by the built-in wire-format reader
(frontends/onnx_protobuf.py). The op mapping itself is pure graph-walking
and also accepts any duck-typed model carrying the same node/initializer
structure (nodes may carry a plain ``attrs`` dict instead of protobuf
attributes, and initializers a numpy ``array`` — the programmatic
importers use this form directly).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Sequence

import numpy as np

from flexflow_tpu_torch.op_attrs.ops import PoolOp


class _FusedDense:
    """Synthetic node for the MatMul+Add(bias) fusion pre-pass."""

    op_type = "FusedDense"

    def __init__(self, x, w, b, out, name):
        self.input = [x, w, b]
        self.weight = w
        self.bias = b
        self.output = [out]
        self.name = name
        self.attrs: Dict = {}


class ONNXModel:
    """Maps an onnx graph onto an FFModel (reference flexflow.onnx.model)."""

    SUPPORTED = (
        "Gemm MatMul Conv Relu Sigmoid Tanh Elu Exp Log Softmax MaxPool "
        "AveragePool GlobalAveragePool Flatten Reshape Transpose Concat "
        "Split Add Sub Mul Div Dropout Identity LayerNormalization "
        "BatchNormalization Gather Pad Cast Unsqueeze Constant Range"
    ).split()

    def __init__(self, model_or_path) -> None:
        if isinstance(model_or_path, str):
            try:
                import onnx
            except ImportError:
                # the `onnx` package is absent: decode the protobuf wire
                # format directly (frontends/onnx_protobuf.py) — same
                # duck-typed result the programmatic importers produce
                from flexflow_tpu_torch.frontends.onnx_protobuf import (
                    load_onnx_file,
                )

                self.onnx = None
                self.model = load_onnx_file(model_or_path)
                return
            self.onnx = onnx
            self.model = onnx.load(model_or_path)
        else:
            # ModelProto (onnx installed) or a duck-typed equivalent
            try:
                import onnx
            except ImportError:
                onnx = None
            self.onnx = onnx
            self.model = model_or_path

    # -- helpers -----------------------------------------------------------

    def _attrs(self, node) -> Dict:
        plain = getattr(node, "attrs", None)
        if plain is not None:  # duck-typed graph: attributes pre-converted
            return dict(plain)
        out = {}
        for a in node.attribute:
            v = self.onnx.helper.get_attribute_value(a)
            # the wire-format reader yields str for STRING/STRINGS; decode
            # the onnx package's bytes so both paths agree
            if isinstance(v, bytes):
                v = v.decode(errors="replace")
            elif isinstance(v, list) and v and isinstance(v[0], bytes):
                v = [s.decode(errors="replace") for s in v]
            out[a.name] = v
        return out

    def _initializer_names(self):
        return {t.name for t in self.model.graph.initializer}

    def _fuse_matmul_add(self, nodes):
        """Reference _fusion (model.py:303-349): a MatMul whose (sole) use
        is an Add against an initializer is a Dense with bias."""
        weights = self._initializer_names()
        # a MatMul whose output is itself a graph output must survive the
        # fusion un-renamed, or that output name vanishes from env
        graph_outputs = {o.name for o in self.model.graph.output}
        out = []
        skip = set()
        by_input: Dict[str, List] = {}
        for n in nodes:
            for i in n.input:
                by_input.setdefault(i, []).append(n)
        for n in nodes:
            if id(n) in skip:
                continue
            if (
                n.op_type == "MatMul"
                and n.input[1] in weights
                and n.output[0] not in graph_outputs
            ):
                uses = by_input.get(n.output[0], [])
                if len(uses) == 1 and uses[0].op_type == "Add":
                    add = uses[0]
                    other = (
                        add.input[1]
                        if add.input[0] == n.output[0]
                        else add.input[0]
                    )
                    if other in weights:
                        out.append(
                            _FusedDense(
                                n.input[0], n.input[1], other,
                                add.output[0],
                                getattr(n, "name", "") or add.output[0],
                            )
                        )
                        skip.add(id(add))
                        continue
            out.append(n)
        return out

    # -- import ------------------------------------------------------------

    def apply(self, ffmodel, input_tensors: Sequence) -> List:
        """Build the onnx graph into ffmodel; returns output tensors."""
        g = self.model.graph
        weights = self._initializer_names()
        graph_inputs = [i.name for i in g.input if i.name not in weights]
        assert len(graph_inputs) == len(input_tensors), (
            f"graph has inputs {graph_inputs}"
        )
        env: Dict[str, object] = dict(zip(graph_inputs, input_tensors))
        self._consts: Dict[str, object] = {}

        for node in self._fuse_matmul_add(list(g.node)):
            op = node.op_type
            a = self._attrs(node)
            ins = [env[i] for i in node.input if i in env]
            name = getattr(node, "name", "") or node.output[0]
            if not ins and op not in ("Constant", "Range"):
                # every other supported op reads ins[0]; a node fed only by
                # Constant outputs / initializers would IndexError below
                raise ValueError(
                    f"onnx {op} node {name}: none of its inputs "
                    f"{list(node.input)} resolved to a built tensor (fed by "
                    "a Constant/initializer?); this graph shape is "
                    "unsupported — fold the constant into a weight or use "
                    "the torch.fx frontend"
                )
            if op == "FusedDense":
                wshape = self._init_shape(node.weight)
                t = ffmodel.dense(
                    ins[0], int(wshape[-1]), use_bias=True, name=name
                )
            elif op in ("Gemm", "MatMul"):
                # weight initializer shape gives out_dim
                wname = node.input[1]
                wshape = self._init_shape(wname)
                out_dim = wshape[0] if a.get("transB") else wshape[-1]
                use_bias = len(node.input) > 2
                t = ffmodel.dense(ins[0], int(out_dim), use_bias=use_bias,
                                  name=name)
            elif op == "Conv":
                wshape = self._init_shape(node.input[1])
                k = a.get("kernel_shape", wshape[2:])
                s = a.get("strides", [1, 1])
                pads = a.get("pads", [0, 0, 0, 0])
                t = ffmodel.conv2d(
                    ins[0], int(wshape[0]), int(k[0]), int(k[1]), int(s[0]),
                    int(s[1]), int(pads[0]), int(pads[1]),
                    groups=int(a.get("group", 1)),
                    use_bias=len(node.input) > 2, name=name,
                )
            elif op in ("MaxPool", "AveragePool"):
                k = a["kernel_shape"]
                s = a.get("strides", k)
                pads = a.get("pads", [0, 0, 0, 0])
                t = ffmodel.pool2d(
                    ins[0], int(k[0]), int(k[1]), int(s[0]), int(s[1]),
                    int(pads[0]), int(pads[1]),
                    pool_type=PoolOp.MAX if op == "MaxPool" else PoolOp.AVG,
                    name=name,
                )
            elif op == "GlobalAveragePool":
                t = ffmodel.mean(ins[0], [2, 3], keepdims=True, name=name)
            elif op == "Flatten":
                t = ffmodel.flat(ins[0], name=name)
            elif op == "Reshape":
                shape = a.get("shape") or self._const_ints(node.input[1])
                t = ffmodel.reshape(ins[0], [int(s) for s in shape], name=name)
            elif op == "Transpose":
                t = ffmodel.transpose(ins[0], [int(p) for p in a["perm"]],
                                      name=name)
            elif op == "Concat":
                t = ffmodel.concat(ins, int(a["axis"]), name=name)
            elif op == "Softmax":
                t = ffmodel.softmax(ins[0], axis=int(a.get("axis", -1)),
                                    name=name)
            elif op in ("Relu", "Sigmoid", "Tanh", "Elu", "Exp", "Log",
                        "Identity"):
                t = getattr(ffmodel, op.lower())(ins[0], name=name)
            elif op == "Dropout":
                t = ffmodel.dropout(ins[0], float(a.get("ratio", 0.5)),
                                    name=name)
            elif op in ("Add", "Sub", "Mul", "Div"):
                if len(ins) == 2:
                    fn = {"Add": ffmodel.add, "Sub": ffmodel.subtract,
                          "Mul": ffmodel.multiply, "Div": ffmodel.divide}[op]
                    t = fn(ins[0], ins[1], name=name)
                else:
                    # one operand is an initializer: only scalar constants
                    # lower cleanly (to scalar_* ops); reject the rest loudly
                    const_name = next(
                        i for i in node.input if i not in env)
                    cval = self._const_array(const_name)
                    if cval.size != 1:
                        raise ValueError(
                            f"onnx {op} with non-scalar initializer operand "
                            f"{const_name} (shape {list(cval.shape)}) is not "
                            "supported; fold it into a weight or use the "
                            "torch.fx frontend"
                        )
                    c = float(cval.reshape(()))
                    # Sub/Div are not commutative: Sub(c, x) = c - x, not
                    # x - c. Add/Mul don't care which operand was constant.
                    const_first = node.input[0] == const_name
                    if op == "Sub" and const_first:
                        t = ffmodel.scalar_add(
                            ffmodel.scalar_multiply(
                                ins[0], -1.0, name=f"{name}_neg"
                            ),
                            c, name=name,
                        )
                    elif op == "Div" and const_first:
                        raise ValueError(
                            f"onnx Div node {name} with a constant dividend "
                            f"({const_name} / tensor) has no scalar-op "
                            "lowering; use the torch.fx frontend"
                        )
                    else:
                        sfn = {"Add": ffmodel.scalar_add,
                               "Sub": ffmodel.scalar_sub,
                               "Mul": ffmodel.scalar_multiply,
                               "Div": ffmodel.scalar_true_divide}[op]
                        t = sfn(ins[0], c, name=name)
            elif op == "Split":
                axis = int(a.get("axis", 0))
                sizes = a.get("split") or (
                    self._const_ints(node.input[1])
                    if len(node.input) > 1 else None
                )
                if sizes is None:
                    raise ValueError(
                        "onnx Split without explicit sizes is unsupported"
                    )
                parts = ffmodel.split(
                    ins[0], [int(s) for s in sizes], axis, name=name)
                for out_name, part in zip(node.output, parts):
                    env[out_name] = part
                continue
            elif op == "LayerNormalization":
                t = ffmodel.layer_norm(
                    ins[0], axes=[int(a.get("axis", -1))],
                    eps=float(a.get("epsilon", 1e-5)), name=name,
                )
            elif op == "BatchNormalization":
                t = ffmodel.batch_norm(ins[0], relu=False, name=name)
            elif op == "Gather":
                wshape = self._init_shape(node.input[0])
                t = ffmodel.embedding(ins[0], int(wshape[0]), int(wshape[1]),
                                      name=name)
            elif op == "Pad":
                pads = a.get("pads") or (
                    self._const_ints(node.input[1])
                    if len(node.input) > 1
                    else []
                )
                if any(int(p) for p in pads):
                    # the reference passes ALL pads through with a warning
                    # (model.py:229-233, 'pass-through pad'); only the
                    # harmless zero-pad passes silently here
                    warnings.warn(
                        f"onnx Pad {name} with nonzero pads {list(pads)} is "
                        "passed through (reference parity); fold padding "
                        "into the consuming conv/pool instead"
                    )
                t = ins[0]
            elif op == "Cast":
                # kept as identity at graph level (reference model.py:248-252);
                # compute dtype is governed by compile(compute_dtype=...)
                t = ins[0]
            elif op == "Unsqueeze":
                axes = a.get("axes") or self._const_ints(node.input[1])
                dims = list(ins[0].dims)
                # axes are positions in the OUTPUT rank (onnx spec);
                # normalize against it before inserting
                out_rank = len(dims) + len(axes)
                norm = sorted(
                    int(x) if int(x) >= 0 else int(x) + out_rank
                    for x in axes
                )
                for ax in norm:
                    dims.insert(ax, 1)
                t = ffmodel.reshape(ins[0], dims, name=name)
            elif op == "Constant":
                val = a["value"]
                # from a real ModelProto the attribute is a TensorProto;
                # duck-typed graphs carry arrays directly
                if self.onnx is not None and not isinstance(
                    val, (int, float, list, tuple, np.ndarray)
                ):
                    val = self.onnx.numpy_helper.to_array(val)
                self._consts[node.output[0]] = np.asarray(val)
                continue
            elif op == "Range":
                # constant-input ranges materialize (position ids); anything
                # runtime-dependent is out of scope, as in the reference
                # (model.py:279-285 passes through with a warning)
                try:
                    s0, s1, s2 = (
                        float(self._const_array(i).reshape(()))
                        for i in node.input
                    )
                except KeyError:
                    warnings.warn(
                        f"onnx Range {name} with non-constant bounds is "
                        "passed through (reference parity)"
                    )
                    if ins:
                        # never store None: a missing env entry lets the
                        # unresolved-input guard raise cleanly downstream
                        env[node.output[0]] = ins[0]
                    continue
                self._consts[node.output[0]] = np.arange(s0, s1, s2)
                continue
            else:
                raise ValueError(
                    f"unsupported onnx op {op}; supported: {self.SUPPORTED}"
                )
            env[node.output[0]] = t
        return [env[o.name] for o in g.output]

    def _init_shape(self, name: str):
        for t in self.model.graph.initializer:
            if t.name == name:
                arr = getattr(t, "array", None)
                return list(arr.shape) if arr is not None else list(t.dims)
        raise KeyError(f"initializer {name} not found")

    def _const_ints(self, name: str):
        return [int(x) for x in self._const_array(name).reshape(-1)]

    def _const_array(self, name: str):
        hit = getattr(self, "_consts", {}).get(name)
        if hit is not None:
            return hit
        for t in self.model.graph.initializer:
            if t.name == name:
                arr = getattr(t, "array", None)
                if arr is not None:  # duck-typed initializer
                    return arr
                return self.onnx.numpy_helper.to_array(t)
        raise KeyError(f"constant {name} not found")
