"""Minimal protobuf wire-format codec for ONNX, dependency-free (the
port's own copy of ``mxnet_tpu/onnx/proto.py``; ref: onnx.proto3).

The harness image has no ``onnx`` package, so we speak the protobuf wire
format directly (it is tiny: varints + length-delimited blobs). Only the
subset of onnx.proto3 that models need is implemented — ModelProto,
GraphProto, NodeProto, AttributeProto, TensorProto, ValueInfoProto
(ref: python/mxnet/onnx/mx2onnx — the reference leans on the onnx pip
package for the same job).
"""
from __future__ import annotations

import struct

import numpy as np

# ----------------------------------------------------------------- wire level

_WIRE_VARINT = 0
_WIRE_64BIT = 1
_WIRE_LEN = 2
_WIRE_32BIT = 5


def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64  # two's-complement, 10-byte form
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class Msg:
    """Append-only protobuf message builder."""

    def __init__(self):
        self._buf = bytearray()

    def _tag(self, field, wire):
        self._buf += _varint((field << 3) | wire)

    def varint(self, field, value):
        self._tag(field, _WIRE_VARINT)
        self._buf += _varint(int(value))
        return self

    def bytes_(self, field, data):
        if isinstance(data, str):
            data = data.encode("utf-8")
        elif isinstance(data, Msg):
            data = data.tobytes()
        self._tag(field, _WIRE_LEN)
        self._buf += _varint(len(data))
        self._buf += data
        return self

    def float_(self, field, value):
        self._tag(field, _WIRE_32BIT)
        self._buf += struct.pack("<f", float(value))
        return self

    def packed_varints(self, field, values):
        payload = b"".join(_varint(int(v)) for v in values)
        return self.bytes_(field, payload)

    def packed_floats(self, field, values):
        return self.bytes_(field, struct.pack("<%df" % len(values), *map(float, values)))

    def tobytes(self) -> bytes:
        return bytes(self._buf)


def read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse(buf):
    """Decode one message into {field: [raw values]} — varints as int,
    length-delimited as bytes, fixed32/64 as raw bytes."""
    fields = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, pos = read_varint(buf, pos)
        elif wire == _WIRE_LEN:
            ln, pos = read_varint(buf, pos)
            val = bytes(buf[pos:pos + ln])
            pos += ln
        elif wire == _WIRE_32BIT:
            val = bytes(buf[pos:pos + 4])
            pos += 4
        elif wire == _WIRE_64BIT:
            val = bytes(buf[pos:pos + 8])
            pos += 8
        else:
            raise ValueError("unsupported wire type %d" % wire)
        fields.setdefault(field, []).append(val)
    return fields


def signed(v):
    """Interpret a decoded varint as a signed int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def unpack_varints(payload):
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = read_varint(payload, pos)
        out.append(signed(v))
    return out


def unpack_floats(payload):
    return list(struct.unpack("<%df" % (len(payload) // 4), payload))


def repeated_ints(raw_values):
    """Decode a repeated int field that may arrive unpacked (ints) or packed
    (proto3 default: one length-delimited blob of varints)."""
    out = []
    for raw in raw_values:
        if isinstance(raw, (bytes, bytearray)):
            out.extend(unpack_varints(raw))
        else:
            out.append(signed(raw))
    return out


def repeated_floats(raw_values):
    """Decode a repeated float field: unpacked entries are 4-byte fixed32
    chunks, packed entries are one blob of n*4 bytes."""
    out = []
    for raw in raw_values:
        out.extend(unpack_floats(raw))
    return out


# ---------------------------------------------------------------- ONNX types

# onnx.TensorProto.DataType
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16

_NP2ONNX = {
    np.dtype(np.float32): FLOAT, np.dtype(np.float64): DOUBLE,
    np.dtype(np.float16): FLOAT16, np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64, np.dtype(np.int8): INT8,
    np.dtype(np.uint8): UINT8, np.dtype(np.bool_): BOOL,
}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}


def np_to_onnx_dtype(dt):
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return BFLOAT16
    return _NP2ONNX[dt]


def onnx_to_np_dtype(code):
    if code == BFLOAT16:
        return _bf16_dtype()
    return _ONNX2NP[code]


def _bf16_dtype():
    """numpy's bfloat16 (``ml_dtypes``, where installed); without it a
    bfloat16 tensor decodes to float32, which holds every bfloat16
    exactly."""
    try:
        import ml_dtypes
    except ImportError:
        return np.dtype(np.float32)
    return np.dtype(ml_dtypes.bfloat16)


# AttributeProto.AttributeType
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR, ATTR_GRAPH = 1, 2, 3, 4, 5
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8


class GraphAttr:
    """Marker for a subgraph-valued attribute (AttributeProto.g, e.g. the
    then_branch/else_branch of an If node). Holds encoded GraphProto bytes."""

    def __init__(self, graph_msg):
        self.data = graph_msg.tobytes() if hasattr(graph_msg, "tobytes") \
            else bytes(graph_msg)


def tensor_proto(name, arr):
    """TensorProto with raw_data (field 9)."""
    arr = np.ascontiguousarray(arr)
    m = Msg()
    for d in arr.shape:
        m.varint(1, d)                       # dims
    m.varint(2, np_to_onnx_dtype(arr.dtype))  # data_type
    m.bytes_(8, name)                        # name
    if arr.dtype.name == "bfloat16":
        raw = arr.view(np.uint16).astype("<u2").tobytes()
    else:
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    m.bytes_(9, raw)                         # raw_data
    return m


def parse_tensor(buf):
    """TensorProto bytes → (name, np.ndarray)."""
    f = parse(buf)
    dims = repeated_ints(f.get(1, []))
    code = f[2][0]
    name = f.get(8, [b""])[0].decode()
    if 9 in f:  # raw_data
        raw = f[9][0]
        if code == BFLOAT16:
            bits = np.frombuffer(raw, "<u2")
            dt = _bf16_dtype()
            arr = bits.view(dt) if dt.itemsize == 2 else \
                (bits.astype(np.uint32) << 16).view(np.float32)
        else:
            arr = np.frombuffer(raw, np.dtype(onnx_to_np_dtype(code)).newbyteorder("<"))
        arr = arr.reshape(dims)
    elif 4 in f:  # float_data (packed)
        arr = np.asarray(unpack_floats(f[4][0]), np.float32).reshape(dims)
    elif 7 in f:  # int64_data (packed)
        arr = np.asarray(unpack_varints(f[7][0]), np.int64).reshape(dims)
    elif 5 in f:  # int32_data (packed)
        arr = np.asarray(unpack_varints(f[5][0]),
                         onnx_to_np_dtype(code)).reshape(dims)
    else:
        arr = np.zeros(dims, onnx_to_np_dtype(code))
    return name, arr


def attr_proto(name, value):
    """AttributeProto from a python value (int/float/str/list/np.ndarray)."""
    m = Msg()
    m.bytes_(1, name)
    if isinstance(value, bool):
        m.varint(3, int(value)).varint(20, ATTR_INT)
    elif isinstance(value, int):
        m.varint(3, value).varint(20, ATTR_INT)
    elif isinstance(value, float):
        m.float_(2, value).varint(20, ATTR_FLOAT)
    elif isinstance(value, str):
        m.bytes_(4, value).varint(20, ATTR_STRING)
    elif isinstance(value, GraphAttr):
        m.bytes_(6, value.data).varint(20, ATTR_GRAPH)
    elif isinstance(value, np.ndarray):
        m.bytes_(5, tensor_proto("", value)).varint(20, ATTR_TENSOR)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                m.float_(7, v)
            m.varint(20, ATTR_FLOATS)
        elif value and isinstance(value[0], str):
            for v in value:
                m.bytes_(9, v)
            m.varint(20, ATTR_STRINGS)
        else:
            for v in value:
                m.varint(8, int(v))
            m.varint(20, ATTR_INTS)
    else:
        raise TypeError("unsupported attribute %r=%r" % (name, value))
    return m


def parse_attr(buf):
    """AttributeProto bytes → (name, python value)."""
    f = parse(buf)
    name = f[1][0].decode()
    atype = f.get(20, [0])[0]
    if atype == ATTR_INT:
        return name, signed(f[3][0])
    if atype == ATTR_FLOAT:
        return name, struct.unpack("<f", f[2][0])[0]
    if atype == ATTR_STRING:
        return name, f[4][0].decode()
    if atype == ATTR_TENSOR:
        return name, parse_tensor(f[5][0])[1]
    if atype == ATTR_GRAPH:
        return name, parse_graph(f[6][0])
    if atype == ATTR_INTS:
        return name, repeated_ints(f.get(8, []))
    if atype == ATTR_FLOATS:
        return name, repeated_floats(f.get(7, []))
    if atype == ATTR_STRINGS:
        return name, [raw.decode() for raw in f.get(9, [])]
    raise ValueError("unsupported attribute type %d for %s" % (atype, name))


def node_proto(op_type, inputs, outputs, name="", attrs=None):
    m = Msg()
    for i in inputs:
        m.bytes_(1, i)
    for o in outputs:
        m.bytes_(2, o)
    if name:
        m.bytes_(3, name)
    m.bytes_(4, op_type)
    for k, v in (attrs or {}).items():
        m.bytes_(5, attr_proto(k, v))
    return m


def parse_node(buf):
    f = parse(buf)
    inputs = [b.decode() for b in f.get(1, [])]
    outputs = [b.decode() for b in f.get(2, [])]
    name = f.get(3, [b""])[0].decode()
    op_type = f[4][0].decode()
    attrs = dict(parse_attr(b) for b in f.get(5, []))
    return {"op": op_type, "inputs": inputs, "outputs": outputs,
            "name": name, "attrs": attrs}


def value_info(name, dtype, shape):
    """ValueInfoProto: name + tensor type (elem_type, shape)."""
    shp = Msg()
    for d in shape:
        dim = Msg()
        if isinstance(d, str) or d is None or d < 0:
            dim.bytes_(2, str(d) if d is not None else "?")
        else:
            dim.varint(1, d)
        shp.bytes_(1, dim)
    tt = Msg()
    tt.varint(1, np_to_onnx_dtype(dtype))
    tt.bytes_(2, shp)
    tp = Msg()
    tp.bytes_(1, tt)
    m = Msg()
    m.bytes_(1, name)
    m.bytes_(2, tp)
    return m


def parse_value_info(buf):
    f = parse(buf)
    name = f[1][0].decode()
    dtype = None
    shape = None
    if 2 in f:
        tp = parse(f[2][0])
        if 1 in tp:
            tt = parse(tp[1][0])
            dtype = tt.get(1, [None])[0]
            if 2 in tt:
                shape = []
                for dim_buf in parse(tt[2][0]).get(1, []):
                    dim = parse(dim_buf)
                    if 1 in dim:
                        shape.append(signed(dim[1][0]))
                    else:
                        shape.append(dim.get(2, [b"?"])[0].decode())
    return {"name": name, "dtype": dtype, "shape": shape}


def graph_proto(name, nodes, inputs, outputs, initializers, value_infos=()):
    m = Msg()
    for nd_ in nodes:
        m.bytes_(1, nd_)
    m.bytes_(2, name)
    for t in initializers:
        m.bytes_(5, t)
    for vi in inputs:
        m.bytes_(11, vi)
    for vo in outputs:
        m.bytes_(12, vo)
    for vi in value_infos:
        m.bytes_(13, vi)
    return m


def parse_graph(buf):
    f = parse(buf)
    return {
        "name": f.get(2, [b""])[0].decode(),
        "nodes": [parse_node(b) for b in f.get(1, [])],
        "initializers": dict(parse_tensor(b) for b in f.get(5, [])),
        "inputs": [parse_value_info(b) for b in f.get(11, [])],
        "outputs": [parse_value_info(b) for b in f.get(12, [])],
    }


def model_proto(graph, opset=13, producer="mxnet_tpu_torch", ir_version=8):
    ops = Msg()
    ops.bytes_(1, "")        # domain: default
    ops.varint(2, opset)     # version
    m = Msg()
    m.varint(1, ir_version)
    m.bytes_(2, producer)
    m.bytes_(7, graph)
    m.bytes_(8, ops)
    return m


def parse_model(buf):
    f = parse(buf)
    opset = 13
    for b in f.get(8, []):
        op = parse(b)
        if op.get(1, [b""])[0] in (b"", b"ai.onnx"):
            opset = op.get(2, [13])[0]
    return {
        "ir_version": f.get(1, [0])[0],
        "producer": f.get(2, [b""])[0].decode(),
        "opset": opset,
        "graph": parse_graph(f[7][0]),
    }


def check_model(buf):
    """Structural validation of an encoded ModelProto (the spec rules the
    official onnx.checker enforces that don't need the full type system —
    that package is unavailable here): every node input is a graph input,
    an initializer, or an earlier node's output (SSA + topological order);
    node ops are named; output names exist; subgraphs check recursively
    against the outer scope (ONNX scoping). Raises ValueError.
    """
    model = parse_model(buf)
    if not model["ir_version"]:
        raise ValueError("checker: missing ir_version")
    _check_graph(model["graph"], set(), "main")
    return model


def _check_graph(g, outer_names, tag):
    known = set(outer_names)
    known.update(vi["name"] for vi in g["inputs"])
    known.update(g["initializers"])
    known.add("")  # optional (empty) inputs are legal
    for i, node in enumerate(g["nodes"]):
        if not node["op"]:
            raise ValueError("checker: %s node %d has no op_type" % (tag, i))
        for inp in node["inputs"]:
            if inp not in known:
                raise ValueError(
                    "checker: %s node %d (%s) input %r is not a graph "
                    "input, initializer, or earlier output (SSA order)"
                    % (tag, i, node["op"], inp))
        for attr, v in node["attrs"].items():
            if isinstance(v, dict) and "nodes" in v:  # subgraph
                _check_graph(v, known, "%s/%s.%s" % (tag, node["op"], attr))
        for out in node["outputs"]:
            if out in known and out:
                raise ValueError("checker: %s node %d (%s) output %r "
                                 "redefines an existing name (SSA)"
                                 % (tag, i, node["op"], out))
            known.add(out)
    for vo in g["outputs"]:
        if vo["name"] not in known:
            raise ValueError("checker: %s graph output %r is never produced"
                             % (tag, vo["name"]))
