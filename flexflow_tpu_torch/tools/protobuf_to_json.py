"""Convert a legacy TASO substitution rule collection from protobuf binary
format to the JSON the legacy-rules loader consumes (port of
bin/protobuf_to_json.py; FFConfig.substitution_json_path).

Reference: bin/protobuf_to_json (rules.proto: GraphSubst.RuleCollection /
Rule / Operator / Tensor / Parameter / MapOutput; enum-name mapping in
protobuf_to_json.cc). The wire decoder here is self-contained (proto2's
varint + length-delimited encodings only — the schema uses nothing else),
so no protoc/runtime dependency is needed.

Usage: python -m flexflow_tpu_torch.tools.protobuf_to_json <input.pb> <output.json>
"""

import json
import sys

# single source of truth for the enum-name tables, shared with the loader
from flexflow_tpu_torch.substitutions.legacy_rules import (
    LEGACY_ACTIVATION_NAMES as ACTIVATION_NAMES,
    LEGACY_OP_TYPE_NAMES as OP_TYPE_NAMES,
    LEGACY_PADDING_NAMES as PADDING_NAMES,
    LEGACY_PARAM_NAMES as PARAM_NAMES,
)


# -- minimal proto2 wire decoder -------------------------------------------


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            break
        shift += 7
    return result, pos


def _as_int32(v: int) -> int:
    """proto int32 fields are sign-extended to 64-bit varints on the wire."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _decode_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for a message's wire bytes.
    wire type 0 -> varint int; 2 -> bytes (submessage)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
            yield field, wt, _as_int32(v)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")


def decode_tensor(buf: bytes):
    out = {"_t": "Tensor", "opId": 0, "tsId": 0}
    for f, _, v in _decode_fields(buf):
        if f == 1:
            out["opId"] = v
        elif f == 2:
            out["tsId"] = v
    return out


def decode_parameter(buf: bytes):
    key = value = 0
    for f, _, v in _decode_fields(buf):
        if f == 1:
            key = v
        elif f == 2:
            value = v
    out = {"_t": "Parameter", "key": PARAM_NAMES[key]}
    # the reference's converter renders these two values by enum name
    if PARAM_NAMES[key] == "PM_ACTI":
        out["value"] = ACTIVATION_NAMES[value]
    elif PARAM_NAMES[key] == "PM_PAD":
        out["value"] = PADDING_NAMES[value]
    else:
        out["value"] = value
    return out


def decode_operator(buf: bytes):
    out = {"_t": "Operator", "type": None, "input": [], "para": []}
    for f, _, v in _decode_fields(buf):
        if f == 1:
            out["type"] = OP_TYPE_NAMES[v]
        elif f == 2:
            out["input"].append(decode_tensor(v))
        elif f == 3:
            out["para"].append(decode_parameter(v))
    return out


def decode_map_output(buf: bytes):
    out = {"_t": "MapOutput", "srcOpId": 0, "dstOpId": 0, "srcTsId": 0, "dstTsId": 0}
    names = {1: "srcOpId", 2: "dstOpId", 3: "srcTsId", 4: "dstTsId"}
    for f, _, v in _decode_fields(buf):
        if f in names:  # skip unknown fields like the other decoders
            out[names[f]] = v
    return out


def decode_rule(buf: bytes):
    out = {"_t": "Rule", "srcOp": [], "dstOp": [], "mappedOutput": []}
    for f, _, v in _decode_fields(buf):
        if f == 1:
            out["srcOp"].append(decode_operator(v))
        elif f == 2:
            out["dstOp"].append(decode_operator(v))
        elif f == 3:
            out["mappedOutput"].append(decode_map_output(v))
    return out


def decode_rule_collection(buf: bytes):
    rules = []
    for f, _, v in _decode_fields(buf):
        if f == 1:
            rules.append(decode_rule(v))
    for i, r in enumerate(rules):
        r["name"] = f"taso_rule_{i}"
    return {"_t": "RuleCollection", "rule": rules}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 2:
        print("Usage: python -m flexflow_tpu_torch.tools.protobuf_to_json "
              "<input-file> <output-file>", file=sys.stderr)
        return 1
    with open(argv[0], "rb") as f:
        collection = decode_rule_collection(f.read())
    print(f"Loaded {len(collection['rule'])} rules.")
    with open(argv[1], "w") as f:
        json.dump(collection, f, indent=2)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
