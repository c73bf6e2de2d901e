"""Minimal ONNX weight reader with no onnx or onnxruntime dependency (the
port's copy of the JAX package's ``utils/onnx_io.py``).

The reference loads ``campplus.onnx`` through onnxruntime only to run the
speaker-embedding network (GLM_modules/flow_inference.py:86-89).  The port
runs that network itself (models/campplus.py); this module takes the
trained weights out of the .onnx file by walking the protobuf wire format:
the initializers are all it needs.

Wire format (protobuf):
  ModelProto.graph        = field 7  (embedded GraphProto)
  GraphProto.initializer  = field 5  (repeated TensorProto)
  TensorProto: dims=1, data_type=2, float_data=4, int32_data=5,
               int64_data=7, name=8, raw_data=9, double_data=11
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

# TensorProto.DataType values -> numpy dtypes
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                    # 64-bit
            val = buf[pos: pos + 8]
            pos += 8
        elif wire == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wire == 5:                    # 32-bit
            val = buf[pos: pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    dims = []
    dtype = 1
    name = ""
    raw = None
    floats = []
    int32s = []
    int64s = []
    doubles = []
    for field, wire, val in _fields(buf):
        if field == 1:                                 # dims
            if wire == 0:
                dims.append(val)
            else:                                      # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            dtype = val
        elif field == 4:                               # float_data
            if wire == 2:
                floats.append(np.frombuffer(val, np.float32))
            else:
                floats.append(np.frombuffer(bytes(val), np.float32))
        elif field == 5:                               # int32_data
            if wire == 0:
                int32s.append(np.asarray([val], np.int64))
            else:
                pos = 0
                vals = []
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    vals.append(v)
                int32s.append(np.asarray(vals, np.int64))
        elif field == 7:                               # int64_data
            if wire == 0:
                int64s.append(np.asarray([val], np.int64))
            else:
                pos = 0
                vals = []
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    vals.append(v)
                int64s.append(np.asarray(vals, np.int64))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = bytes(val)
        elif field == 11:                              # double_data
            doubles.append(np.frombuffer(val if wire == 2 else bytes(val),
                                         np.float64))
    np_dtype = _DTYPES.get(dtype)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype}")
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif floats:
        arr = np.concatenate(floats).astype(np_dtype)
    elif int64s:
        arr = np.concatenate(int64s).astype(np_dtype)
    elif int32s:
        arr = np.concatenate(int32s).astype(np_dtype)
    elif doubles:
        arr = np.concatenate(doubles).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Read an .onnx file and return {initializer_name: ndarray}."""
    with open(path, "rb") as f:
        buf = f.read()
    graph = None
    for field, wire, val in _fields(buf):
        if field == 7 and wire == 2:                   # ModelProto.graph
            graph = val
            break
    if graph is None:
        raise ValueError(f"{path}: no graph found (not an ONNX ModelProto?)")
    out: Dict[str, np.ndarray] = {}
    for field, wire, val in _fields(graph):
        if field == 5 and wire == 2:                   # initializer
            name, arr = _parse_tensor(val)
            out[name] = arr
    return out
