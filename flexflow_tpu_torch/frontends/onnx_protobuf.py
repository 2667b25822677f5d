"""Minimal ONNX ModelProto reader — no `onnx` package required (copy of
flexflow_tpu/frontends/onnx_protobuf.py).

Reference: python/flexflow/onnx/model.py loads real protobufs via the
`onnx` package; that package is optional here, so this module decodes the protobuf wire format directly for the subset of
fields the frontend consumes (nodes, attributes, initializers, graph
inputs/outputs). Field numbers are from the public onnx.proto3 schema.

The decoder produces the same duck-typed objects ONNXModel already accepts
(nodes with an `attrs` dict, initializers with a numpy `array`), so the op
mapping code has exactly one path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# -- protobuf wire format ----------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == _VARINT:
            val, pos = _read_varint(buf, pos)
        elif wtype == _I64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == _LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wtype == _I32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement in 64 bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


# -- ONNX message subset -----------------------------------------------------

_TENSOR_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64, 12: np.uint32,
    13: np.uint64,
}


@dataclass
class TensorStub:
    """Initializer/constant: carries dims + a decoded numpy array."""

    name: str = ""
    dims: List[int] = field(default_factory=list)
    array: np.ndarray = None


@dataclass
class NodeStub:
    op_type: str = ""
    name: str = ""
    input: List[str] = field(default_factory=list)
    output: List[str] = field(default_factory=list)
    attrs: Dict = field(default_factory=dict)


@dataclass
class ValueInfoStub:
    name: str = ""


@dataclass
class GraphStub:
    name: str = ""
    node: List[NodeStub] = field(default_factory=list)
    initializer: List[TensorStub] = field(default_factory=list)
    input: List[ValueInfoStub] = field(default_factory=list)
    output: List[ValueInfoStub] = field(default_factory=list)


@dataclass
class ModelStub:
    graph: GraphStub = None


def _parse_tensor(buf: bytes) -> TensorStub:
    t = TensorStub()
    data_type = 1
    raw = b""
    float_data: List[float] = []
    double_data: List[float] = []
    int64_data: List[int] = []
    int32_data: List[int] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:  # dims (repeated int64, possibly packed)
            if wtype == _VARINT:
                t.dims.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    t.dims.append(_signed(v))
        elif fnum == 2:
            data_type = val
        elif fnum == 4:  # float_data
            if wtype == _I32:
                float_data.append(struct.unpack("<f", val)[0])
            else:
                float_data.extend(
                    struct.unpack(f"<{len(val) // 4}f", val)
                )
        elif fnum == 5:  # int32_data
            if wtype == _VARINT:
                int32_data.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int32_data.append(_signed(v))
        elif fnum == 7:  # int64_data
            if wtype == _VARINT:
                int64_data.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(_signed(v))
        elif fnum == 8:
            t.name = val.decode()
        elif fnum == 9:
            raw = val
        elif fnum == 10:  # double_data
            if wtype == _I64:
                double_data.append(struct.unpack("<d", val)[0])
            else:
                double_data.extend(
                    struct.unpack(f"<{len(val) // 8}d", val)
                )
    dtype = _TENSOR_DTYPES.get(data_type)
    if dtype is None:
        # decoding unknown element types as f32 would garble raw_data
        # silently; fail at the decode site instead
        raise ValueError(
            f"unsupported ONNX tensor data_type {data_type} for "
            f"initializer {t.name!r}"
        )
    if raw:
        # TensorProto.raw_data is defined little-endian (onnx.proto); decode
        # explicitly and convert back to the native-order dtype
        arr = np.frombuffer(
            raw, dtype=np.dtype(dtype).newbyteorder("<")
        ).astype(dtype, copy=False)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif double_data:
        arr = np.asarray(double_data, dtype=dtype)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=dtype)
    elif int32_data:
        if data_type == 10:
            # FLOAT16 stores uint16 BIT PATTERNS in int32_data (onnx.proto
            # TensorProto.int32_data comment) — reinterpret, don't convert
            arr = (
                np.asarray(int32_data, dtype=np.uint16).view(np.float16)
            )
        else:
            arr = np.asarray(int32_data, dtype=dtype)
    else:
        arr = np.zeros(t.dims or (0,), dtype=dtype)
    t.array = arr.reshape(t.dims) if t.dims else arr
    return t


def _parse_attribute(buf: bytes) -> Tuple[str, object]:
    name = ""
    a_type = None  # AttributeProto.type (field 20): FLOAT=1 INT=2 STRING=3
    f_val = None  # TENSOR=4 FLOATS=6 INTS=7 STRINGS=8
    i_val = None
    s_val = None
    t_val = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[str] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            name = val.decode()
        elif fnum == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fnum == 3:
            i_val = _signed(val)
        elif fnum == 4:
            s_val = val.decode(errors="replace")
        elif fnum == 5:
            t_val = _parse_tensor(val)
        elif fnum == 9:  # strings (repeated bytes)
            strings.append(val.decode(errors="replace"))
        elif fnum == 7:  # floats
            if wtype == _I32:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fnum == 8:  # ints
            if wtype == _VARINT:
                ints.append(_signed(val))
            else:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(_signed(v))
        elif fnum == 20:
            a_type = val
    if a_type is not None:
        # proto3 omits zero-valued scalars from the wire, so the kind MUST
        # come from the declared type: Concat(axis=0) serializes as
        # name+type only and still means axis == 0
        if a_type == 1:
            return name, f_val if f_val is not None else 0.0
        if a_type == 2:
            return name, i_val if i_val is not None else 0
        if a_type == 3:
            return name, s_val if s_val is not None else ""
        if a_type == 4:
            return name, None if t_val is None else t_val.array
        if a_type == 6:
            return name, floats
        if a_type == 7:
            return name, ints
        if a_type == 8:
            return name, strings
    if t_val is not None:
        return name, t_val.array
    if floats:
        return name, floats
    if ints:
        return name, ints
    if strings:
        return name, strings
    if s_val is not None:
        return name, s_val
    if f_val is not None:
        return name, f_val
    return name, i_val


def _parse_node(buf: bytes) -> NodeStub:
    n = NodeStub()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            n.input.append(val.decode())
        elif fnum == 2:
            n.output.append(val.decode())
        elif fnum == 3:
            n.name = val.decode()
        elif fnum == 4:
            n.op_type = val.decode()
        elif fnum == 5:
            k, v = _parse_attribute(val)
            n.attrs[k] = v
    return n


def _parse_value_info(buf: bytes) -> ValueInfoStub:
    v = ValueInfoStub()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            v.name = val.decode()
    return v


def _parse_graph(buf: bytes) -> GraphStub:
    g = GraphStub()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            g.node.append(_parse_node(val))
        elif fnum == 2:
            g.name = val.decode()
        elif fnum == 5:
            g.initializer.append(_parse_tensor(val))
        elif fnum == 11:
            g.input.append(_parse_value_info(val))
        elif fnum == 12:
            g.output.append(_parse_value_info(val))
    return g


def load_onnx_bytes(data: bytes) -> ModelStub:
    """Decode a serialized ModelProto into the duck-typed model ONNXModel
    accepts."""
    m = ModelStub()
    for fnum, _, val in _fields(data):
        if fnum == 7:  # ModelProto.graph
            m.graph = _parse_graph(val)
    if m.graph is None:
        raise ValueError("not an ONNX ModelProto: no graph field")
    return m


def load_onnx_file(path: str) -> ModelStub:
    with open(path, "rb") as f:
        return load_onnx_bytes(f.read())
