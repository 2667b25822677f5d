"""PyTorch frontend: torch.fx symbolic trace -> FFModel graph (port of
flexflow_tpu/frontends/torch_model.py).

Reference: python/flexflow/torch/model.py:43-2607 — `torch.fx.symbolic_trace`
produces a node list; each fx node maps to an IR line (`.ffir` file) or
directly to FFModel layer calls (`PyTorchModel.apply`, :2408). Same flow
here, with a dispatch table instead of the reference's 50+ Node subclasses,
a JSON-lines IR file format (byte for byte the JAX package's, so either
package reads the other's files), and weight transfer so imported models
are numerically aligned with the torch originals.

What the reference behaviour leaves out, in both packages: fx records the
unpacking of `nn.MultiheadAttention`'s `(out, weights)` tuple as
`operator.getitem`, which no IR op maps, so tracing such a module raises
`ValueError: unsupported torch function: getitem`; an IR file's
`multihead_attention` line (`PyTorchModel.from_file(...).apply_ir`) builds
the attention. `transfer_weights` copies Linear, Conv2d, Embedding and
affine LayerNorm parameters and not `nn.MultiheadAttention`'s, and the IR's
attention is bias-free where torch's default has a bias.

Usage:
    pt = PyTorchModel(torch_module)
    tensors = pt.torch_to_ff(ffmodel, [input_tensor, ...])
    pt.transfer_weights(ffmodel)  # after ffmodel.compile(...)
    # or: torch_to_flexflow(torch_module, "model.ffir"); then
    #     PyTorchModel.from_file("model.ffir").apply_ir(ffmodel, inputs)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.fx
import torch.nn as nn

from flexflow_tpu_torch.op_attrs.ops import PoolOp


# ---------------------------------------------------------------------------
# IR: one JSON object per line {name, op, inputs, attrs}
# ---------------------------------------------------------------------------


class IRLine:
    def __init__(self, name: str, op: str, inputs: List[str], attrs: Dict):
        self.name = name
        self.op = op
        self.inputs = inputs
        self.attrs = attrs

    def dumps(self) -> str:
        return json.dumps(
            {"name": self.name, "op": self.op, "inputs": self.inputs,
             "attrs": self.attrs}
        )

    @staticmethod
    def loads(s: str) -> "IRLine":
        d = json.loads(s)
        return IRLine(d["name"], d["op"], d["inputs"], d["attrs"])


# ---------------------------------------------------------------------------
# fx -> IR
# ---------------------------------------------------------------------------


def _module_ir(name: str, mod, inputs: List[str]) -> IRLine:
    """Map a call_module fx node to an IR line."""
    if isinstance(mod, nn.Linear):
        return IRLine(name, "linear", inputs, {
            "out_dim": mod.out_features, "use_bias": mod.bias is not None,
        })
    if isinstance(mod, nn.Conv2d):
        assert mod.padding_mode == "zeros", "only zero padding supported"
        return IRLine(name, "conv2d", inputs, {
            "out_channels": mod.out_channels,
            "kernel": list(mod.kernel_size), "stride": list(mod.stride),
            "padding": list(mod.padding), "groups": mod.groups,
            "use_bias": mod.bias is not None,
        })
    if isinstance(mod, nn.MaxPool2d) or isinstance(mod, nn.AvgPool2d):
        k = mod.kernel_size
        s = mod.stride if mod.stride is not None else k
        p = mod.padding
        as2 = lambda v: [v, v] if isinstance(v, int) else list(v)
        return IRLine(name, "pool2d", inputs, {
            "kernel": as2(k), "stride": as2(s), "padding": as2(p),
            "pool_type": "MAX" if isinstance(mod, nn.MaxPool2d) else "AVG",
        })
    if isinstance(mod, nn.BatchNorm2d):
        return IRLine(name, "batch_norm", inputs, {"relu": False})
    if isinstance(mod, nn.LayerNorm):
        return IRLine(name, "layer_norm", inputs, {
            "axes": list(range(-len(mod.normalized_shape), 0)),
            "elementwise_affine": mod.elementwise_affine,
            "eps": mod.eps,
        })
    if isinstance(mod, nn.Embedding):
        return IRLine(name, "embedding", inputs, {
            "num_entries": mod.num_embeddings, "out_dim": mod.embedding_dim,
        })
    if isinstance(mod, nn.MultiheadAttention):
        assert mod.batch_first, (
            "only batch_first=True MultiheadAttention is supported"
        )
        return IRLine(name, "multihead_attention", inputs, {
            "embed_dim": mod.embed_dim, "num_heads": mod.num_heads,
        })
    if isinstance(mod, nn.Dropout):
        return IRLine(name, "dropout", inputs, {"rate": mod.p})
    if isinstance(mod, nn.Flatten):
        assert mod.start_dim == 1, "only start_dim=1 flatten supported"
        return IRLine(name, "flat", inputs, {})
    if isinstance(mod, nn.Softmax):
        return IRLine(name, "softmax", inputs, {"axis": mod.dim})
    if isinstance(mod, nn.ReLU):
        return IRLine(name, "relu", inputs, {})
    if isinstance(mod, nn.GELU):
        return IRLine(name, "gelu", inputs, {})
    if isinstance(mod, nn.Sigmoid):
        return IRLine(name, "sigmoid", inputs, {})
    if isinstance(mod, nn.Tanh):
        return IRLine(name, "tanh", inputs, {})
    if isinstance(mod, nn.Identity):
        return IRLine(name, "identity", inputs, {})
    if isinstance(mod, nn.Sequential):
        raise ValueError("fx should have inlined Sequential")
    raise ValueError(f"unsupported torch module: {type(mod).__name__}")


_FUNCTION_OPS = {
    "add": "add", "sub": "subtract", "mul": "multiply",
    "truediv": "divide", "relu": "relu", "gelu": "gelu",
    "sigmoid": "sigmoid", "tanh": "tanh", "exp": "exp", "sin": "sin",
    "cos": "cos", "softmax": "softmax", "flatten": "flat", "cat": "concat",
    "matmul": "batch_matmul", "bmm": "batch_matmul",
}


def _function_ir(name: str, fn, args, kwargs, env) -> IRLine:
    fname = getattr(fn, "__name__", str(fn))
    if fn in (torch.add,) or fname == "add":
        if isinstance(args[1], (int, float)):
            return IRLine(name, "scalar_add", [env[args[0]]],
                          {"scalar": float(args[1])})
        return IRLine(name, "add", [env[args[0]], env[args[1]]], {})
    if fn in (torch.sub,) or fname == "sub":
        if isinstance(args[1], (int, float)):
            return IRLine(name, "scalar_sub", [env[args[0]]],
                          {"scalar": float(args[1])})
        return IRLine(name, "subtract", [env[args[0]], env[args[1]]], {})
    if fn in (torch.mul,) or fname == "mul":
        if isinstance(args[1], (int, float)):
            return IRLine(name, "scalar_multiply", [env[args[0]]],
                          {"scalar": float(args[1])})
        return IRLine(name, "multiply", [env[args[0]], env[args[1]]], {})
    if fname == "truediv":
        if isinstance(args[1], (int, float)):
            return IRLine(name, "scalar_true_divide", [env[args[0]]],
                          {"scalar": float(args[1])})
        return IRLine(name, "divide", [env[args[0]], env[args[1]]], {})
    if fname == "flatten" or fn is torch.flatten:
        return IRLine(name, "flat", [env[args[0]]], {})
    if fname == "cat" or fn is torch.cat:
        ts = args[0]
        axis = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        return IRLine(name, "concat", [env[t] for t in ts], {"axis": axis})
    if fname in ("matmul", "bmm"):
        return IRLine(name, "batch_matmul", [env[args[0]], env[args[1]]], {})
    if fname == "softmax":
        axis = kwargs.get("dim", args[1] if len(args) > 1 else -1)
        return IRLine(name, "softmax", [env[args[0]]], {"axis": axis})
    if fname in ("relu", "gelu", "sigmoid", "tanh", "exp", "sin", "cos"):
        return IRLine(name, fname, [env[args[0]]], {})
    raise ValueError(f"unsupported torch function: {fname}")


_METHOD_OPS = {"relu", "sigmoid", "tanh", "exp", "flatten", "reshape", "view",
               "transpose", "softmax", "contiguous"}


def _method_ir(name: str, method: str, args, kwargs, env) -> IRLine:
    if method in ("reshape", "view"):
        shape = [int(s) for s in args[1:]]
        return IRLine(name, "reshape", [env[args[0]]], {"shape": shape})
    if method == "transpose":
        return IRLine(name, "transpose_dims", [env[args[0]]],
                      {"dim0": int(args[1]), "dim1": int(args[2])})
    if method == "flatten":
        return IRLine(name, "flat", [env[args[0]]], {})
    if method == "contiguous":
        return IRLine(name, "identity", [env[args[0]]], {})
    if method == "softmax":
        axis = kwargs.get("dim", args[1] if len(args) > 1 else -1)
        return IRLine(name, "softmax", [env[args[0]]], {"axis": axis})
    if method in ("relu", "sigmoid", "tanh", "exp"):
        return IRLine(name, method, [env[args[0]]], {})
    raise ValueError(f"unsupported tensor method: {method}")


def trace_to_ir(module, input_names: Optional[Sequence[str]] = None) -> List[IRLine]:
    """fx-trace a torch module into IR lines (reference torch_to_flexflow)."""
    traced = torch.fx.symbolic_trace(module)
    lines: List[IRLine] = []
    env: Dict[object, str] = {}  # fx node -> IR tensor name
    n_inputs = 0
    mods = dict(traced.named_modules())
    for node in traced.graph.nodes:
        if node.op == "placeholder":
            name = (
                input_names[n_inputs]
                if input_names and n_inputs < len(input_names)
                else node.name
            )
            lines.append(IRLine(name, "input", [], {}))
            env[node] = name
            n_inputs += 1
        elif node.op == "call_module":
            ir = _module_ir(node.name, mods[node.target],
                            [env[a] for a in node.args])
            ir.attrs["module_path"] = node.target
            lines.append(ir)
            env[node] = node.name
        elif node.op == "call_function":
            lines.append(_function_ir(node.name, node.target, node.args,
                                      node.kwargs, env))
            env[node] = node.name
        elif node.op == "call_method":
            lines.append(_method_ir(node.name, node.target, node.args,
                                    node.kwargs, env))
            env[node] = node.name
        elif node.op == "output":
            out = node.args[0]
            outs = out if isinstance(out, (tuple, list)) else [out]
            lines.append(IRLine("output", "output",
                                [env[o] for o in outs], {}))
        elif node.op == "get_attr":
            raise ValueError(
                f"get_attr nodes (free tensors like {node.target}) are not "
                "supported; register them as buffers inside a module"
            )
    return lines


def torch_to_flexflow(module, path: str,
                      input_names: Optional[Sequence[str]] = None) -> None:
    """Export a torch module as a .ffir file (reference fx.torch_to_flexflow,
    README.md:29-33)."""
    lines = trace_to_ir(module, input_names)
    with open(path, "w") as f:
        for l in lines:
            f.write(l.dumps() + "\n")


# ---------------------------------------------------------------------------
# IR -> FFModel
# ---------------------------------------------------------------------------


def apply_ir(ffmodel, lines: List[IRLine], input_tensors: Sequence) -> List:
    """Build the IR into an FFModel; returns the output tensors
    (reference PyTorchModel.apply / string_to_ff)."""
    env: Dict[str, object] = {}
    n_in = 0
    outputs: List = []
    for l in lines:
        if l.op == "input":
            assert n_in < len(input_tensors), "not enough input tensors"
            env[l.name] = input_tensors[n_in]
            n_in += 1
            continue
        if l.op == "output":
            outputs = [env[i] for i in l.inputs]
            continue
        ins = [env[i] for i in l.inputs]
        a = l.attrs
        if l.op == "linear":
            t = ffmodel.dense(ins[0], a["out_dim"], use_bias=a["use_bias"],
                              name=l.name)
        elif l.op == "conv2d":
            t = ffmodel.conv2d(
                ins[0], a["out_channels"], a["kernel"][0], a["kernel"][1],
                a["stride"][0], a["stride"][1], a["padding"][0],
                a["padding"][1], groups=a["groups"], use_bias=a["use_bias"],
                name=l.name,
            )
        elif l.op == "pool2d":
            t = ffmodel.pool2d(
                ins[0], a["kernel"][0], a["kernel"][1], a["stride"][0],
                a["stride"][1], a["padding"][0], a["padding"][1],
                pool_type=PoolOp[a["pool_type"]], name=l.name,
            )
        elif l.op == "batch_norm":
            t = ffmodel.batch_norm(ins[0], relu=a.get("relu", False),
                                   name=l.name)
        elif l.op == "layer_norm":
            t = ffmodel.layer_norm(
                ins[0], axes=a["axes"],
                elementwise_affine=a["elementwise_affine"], eps=a["eps"],
                name=l.name,
            )
        elif l.op == "embedding":
            t = ffmodel.embedding(ins[0], a["num_entries"], a["out_dim"],
                                  name=l.name)
        elif l.op == "multihead_attention":
            q = ins[0]
            k = ins[1] if len(ins) > 1 else q
            v = ins[2] if len(ins) > 2 else k
            t = ffmodel.multihead_attention(
                q, k, v, a["embed_dim"], a["num_heads"], name=l.name
            )
        elif l.op == "dropout":
            t = ffmodel.dropout(ins[0], a["rate"], name=l.name)
        elif l.op == "flat":
            t = ffmodel.flat(ins[0], name=l.name)
        elif l.op == "softmax":
            t = ffmodel.softmax(ins[0], axis=a.get("axis", -1), name=l.name)
        elif l.op == "concat":
            t = ffmodel.concat(ins, a["axis"], name=l.name)
        elif l.op == "reshape":
            t = ffmodel.reshape(ins[0], a["shape"], name=l.name)
        elif l.op == "transpose_dims":
            rank = len(ins[0].dims)
            perm = list(range(rank))
            d0, d1 = a["dim0"] % rank, a["dim1"] % rank
            perm[d0], perm[d1] = perm[d1], perm[d0]
            t = ffmodel.transpose(ins[0], perm, name=l.name)
        elif l.op == "batch_matmul":
            t = ffmodel.batch_matmul(ins[0], ins[1], name=l.name)
        elif l.op in ("add", "subtract", "multiply", "divide"):
            t = getattr(ffmodel, l.op)(ins[0], ins[1], name=l.name)
        elif l.op in ("scalar_add", "scalar_sub", "scalar_multiply",
                      "scalar_true_divide"):
            t = getattr(ffmodel, l.op)(ins[0], a["scalar"], name=l.name)
        elif l.op in ("relu", "gelu", "sigmoid", "tanh", "exp", "sin", "cos",
                      "identity"):
            t = getattr(ffmodel, l.op)(ins[0], name=l.name)
        else:
            raise ValueError(f"unknown IR op {l.op}")
        env[l.name] = t
    return outputs


class PyTorchModel:
    """reference model.py:2408 PyTorchModel: holds a torch module (or an IR
    file) and applies it to an FFModel."""

    def __init__(self, module=None, ir_lines: Optional[List[IRLine]] = None,
                 input_names: Optional[Sequence[str]] = None) -> None:
        assert (module is None) != (ir_lines is None)
        self.module = module
        self.input_names = input_names
        self.ir_lines = ir_lines

    @staticmethod
    def from_file(path: str) -> "PyTorchModel":
        with open(path) as f:
            lines = [IRLine.loads(s) for s in f if s.strip()]
        return PyTorchModel(ir_lines=lines)

    def torch_to_ff(self, ffmodel, input_tensors: Sequence) -> List:
        """Trace + build; then transfer the torch weights so the FF graph is
        numerically aligned with the torch module."""
        lines = (
            self.ir_lines
            if self.ir_lines is not None
            else trace_to_ir(self.module, self.input_names)
        )
        outs = apply_ir(ffmodel, lines, input_tensors)
        self._pending_weight_lines = [
            l for l in lines if "module_path" in l.attrs
        ]
        return outs

    def apply_ir(self, ffmodel, input_tensors: Sequence) -> List:
        return self.torch_to_ff(ffmodel, input_tensors)

    # -- weight transfer ---------------------------------------------------

    def transfer_weights(self, ffmodel) -> int:
        """Copy torch parameters into the compiled FFModel (call after
        compile()). Returns the number of tensors copied. The module may
        live on any device: its tensors are read through .detach().cpu().
        New capability: the reference re-initializes imported models."""
        assert self.module is not None, "weight transfer needs the module"
        mods = dict(self.module.named_modules())
        copied = 0
        for line in getattr(self, "_pending_weight_lines", []):
            copied += _transfer_module_weights(
                ffmodel, line, mods[line.attrs["module_path"]]
            )
        return copied


def _set(ffmodel, name: str, value: np.ndarray) -> int:
    try:
        p = ffmodel.get_parameter_by_name(name)
    except KeyError:
        return 0
    p.set_weights(ffmodel, value)
    return 1


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _transfer_module_weights(ffmodel, line: IRLine, mod) -> int:
    n = 0
    if isinstance(mod, nn.Linear):
        # torch stores (out, in); ours is (in, out)
        n += _set(ffmodel, f"{line.name}.weight0",
                  _host(mod.weight).T)
        if mod.bias is not None:
            n += _set(ffmodel, f"{line.name}.weight1",
                      _host(mod.bias))
    elif isinstance(mod, nn.Conv2d):
        n += _set(ffmodel, f"{line.name}.weight0",
                  _host(mod.weight))
        if mod.bias is not None:
            n += _set(ffmodel, f"{line.name}.weight1",
                      _host(mod.bias))
    elif isinstance(mod, nn.Embedding):
        n += _set(ffmodel, f"{line.name}.weight0",
                  _host(mod.weight))
    elif isinstance(mod, nn.LayerNorm) and mod.elementwise_affine:
        n += _set(ffmodel, f"{line.name}.weight0",
                  _host(mod.weight))
        n += _set(ffmodel, f"{line.name}.weight1",
                  _host(mod.bias))
    return n
