"""TFLite flatbuffer reader: ``.tflite`` bytes -> a plain-Python model IR.

Covers the subset of the TFLite schema used by the MediaPipe face-pipeline
models (BlazeFace variants, FaceMesh, Iris, Blendshapes, MobileFaceNet,
selfie segmenters): float32/float16 tensors, the ~25 builtin ops listed in
``OPNAMES`` below, fp16 DEQUANTIZE weight folding, sparse (DENSIFY) constant
tensors, and the MediaPipe ``Convolution2DTransposeBias`` custom op.

This is a standalone parser built on ``convert/flatbuffer.py`` — no
TensorFlow or flatbuffers-runtime dependency.  Parity with the upstream
schema is pinned by ``tests/test_torch_executor.py``, which checks it
against the JAX package's parser on a TensorFlow-built graph.

The reference package runs these models through LiteRT interpreters
(`lib/src/models/*.dart`); here the graphs are converted once into
PyTorch modules (see ``executor.py``) instead of being interpreted at
runtime.  This module is a numpy-only copy of the JAX package's parser, so
the port never imports that package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .flatbuffer import Table

# TensorType enum values from the TFLite schema.
TENSOR_DTYPE = {
    0: np.float32,
    1: np.float16,
    2: np.int32,
    3: np.uint8,
    4: np.int64,
    6: np.bool_,
    7: np.int16,
    9: np.int8,
    10: np.float64,
}

# BuiltinOperator codes (subset) -> canonical op names.
OPNAMES = {
    0: "ADD",
    1: "AVERAGE_POOL_2D",
    2: "CONCATENATION",
    3: "CONV_2D",
    4: "DEPTHWISE_CONV_2D",
    5: "DEPTH_TO_SPACE",
    6: "DEQUANTIZE",
    8: "FLOOR",
    9: "FULLY_CONNECTED",
    11: "L2_NORMALIZATION",
    14: "LOGISTIC",
    17: "MAX_POOL_2D",
    18: "MUL",
    19: "RELU",
    21: "RELU6",
    22: "RESHAPE",
    23: "RESIZE_BILINEAR",
    25: "SOFTMAX",
    26: "SPACE_TO_DEPTH",
    28: "TANH",
    32: "CUSTOM",
    34: "PAD",
    36: "GATHER",
    39: "TRANSPOSE",
    40: "MEAN",
    41: "SUB",
    42: "DIV",
    43: "SQUEEZE",
    45: "STRIDED_SLICE",
    69: "TILE",
    47: "EXP",
    49: "SPLIT",
    53: "CAST",
    54: "PRELU",
    55: "MAXIMUM",
    56: "ARG_MAX",
    57: "MINIMUM",
    59: "NEG",
    60: "PADV2",
    65: "SLICE",
    67: "TRANSPOSE_CONV",
    70: "EXPAND_DIMS",
    73: "LOG",
    74: "SUM",
    75: "SQRT",
    76: "RSQRT",
    78: "POW",
    82: "REDUCE_MAX",
    77: "SHAPE",
    83: "PACK",
    88: "UNPACK",
    89: "REDUCE_MIN",
    92: "SQUARE",
    97: "RESIZE_NEAREST_NEIGHBOR",
    98: "LEAKY_RELU",
    99: "SQUARED_DIFFERENCE",
    100: "MIRROR_PAD",
    101: "ABS",
    111: "ELU",
    117: "HARD_SWISH",
    124: "DENSIFY",
    126: "BATCH_MATMUL",
    114: "QUANTIZE",
    150: "GELU",
}

PADDING_SAME = 0
PADDING_VALID = 1

ACTIVATIONS = {0: None, 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6", 4: "TANH"}


def _activation(code: int):
    """Fused-activation enum -> name, raising on codes this runtime can't
    execute (e.g. SIGN_BIT=5).  A silent None here would be a wrong-output
    bug, not a missing feature — unknown OPCODES already fail loudly, and
    activations deserve the same contract."""
    if code not in ACTIVATIONS:
        raise NotImplementedError(
            f"unsupported fused activation code {code}")
    return ACTIVATIONS[code]


@dataclasses.dataclass
class TensorIR:
    """One tensor in the graph: shape/dtype plus constant data if any."""

    index: int
    name: str
    shape: tuple[int, ...]
    dtype: Any
    data: Optional[np.ndarray]  # None for activations
    sparsity: Optional[dict] = None
    quant: Optional[dict] = None  # {"scale", "zero_point", "dim"} if quantized


@dataclasses.dataclass
class OpIR:
    """One operator: canonical name, tensor indices, decoded options."""

    name: str
    inputs: list[int]  # -1 marks an omitted optional input
    outputs: list[int]
    options: dict


@dataclasses.dataclass
class ModelIR:
    tensors: list[TensorIR]
    ops: list[OpIR]
    inputs: list[int]
    outputs: list[int]
    description: str


def _decode_options(opname: str, op: Table) -> dict:
    """Decodes the builtin/custom options for the ops we support."""
    t = op.table(4)  # builtin_options union value

    def scalar(slot, kind, default=0):
        return t.scalar(slot, kind, default) if t is not None else default

    if opname in ("CONV_2D",):
        return {
            "padding": scalar(0, "int8"),
            "stride_w": scalar(1, "int32", 1),
            "stride_h": scalar(2, "int32", 1),
            "activation": _activation(scalar(3, "int8")),
            "dilation_w": scalar(4, "int32", 1) or 1,
            "dilation_h": scalar(5, "int32", 1) or 1,
        }
    if opname == "DEPTHWISE_CONV_2D":
        return {
            "padding": scalar(0, "int8"),
            "stride_w": scalar(1, "int32", 1),
            "stride_h": scalar(2, "int32", 1),
            "depth_multiplier": scalar(3, "int32", 1),
            "activation": _activation(scalar(4, "int8")),
            "dilation_w": scalar(5, "int32", 1) or 1,
            "dilation_h": scalar(6, "int32", 1) or 1,
        }
    if opname == "TRANSPOSE_CONV":
        return {
            "padding": scalar(0, "int8"),
            "stride_w": scalar(1, "int32", 1),
            "stride_h": scalar(2, "int32", 1),
            "activation": _activation(scalar(3, "int8")),
        }
    if opname in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
        return {
            "padding": scalar(0, "int8"),
            "stride_w": scalar(1, "int32", 1),
            "stride_h": scalar(2, "int32", 1),
            "filter_w": scalar(3, "int32", 1),
            "filter_h": scalar(4, "int32", 1),
            "activation": _activation(scalar(5, "int8")),
        }
    if opname == "CONCATENATION":
        return {
            "axis": scalar(0, "int32"),
            "activation": _activation(scalar(1, "int8")),
        }
    if opname in ("ADD", "MUL", "SUB", "DIV"):
        return {"activation": _activation(scalar(0, "int8"))}
    if opname == "RESHAPE":
        new_shape = (
            t.scalar_vector(0, "int32").tolist() if t is not None else None
        )
        return {"new_shape": new_shape}
    if opname in ("MEAN", "SUM", "REDUCE_MAX", "REDUCE_MIN"):
        return {"keep_dims": scalar(0, "bool", False)}
    if opname == "STRIDED_SLICE":
        return {
            "begin_mask": scalar(0, "int32"),
            "end_mask": scalar(1, "int32"),
            "ellipsis_mask": scalar(2, "int32"),
            "new_axis_mask": scalar(3, "int32"),
            "shrink_axis_mask": scalar(4, "int32"),
        }
    if opname == "PACK":
        return {
            "values_count": scalar(0, "int32"),
            "axis": scalar(1, "int32"),
        }
    if opname == "RESIZE_BILINEAR":
        # slots 0/1 are the deprecated new_height/new_width fields.
        return {
            "align_corners": scalar(2, "bool", False),
            "half_pixel_centers": scalar(3, "bool", False),
        }
    if opname == "RESIZE_NEAREST_NEIGHBOR":
        # ResizeNearestNeighborOptions has no deprecated leading fields.
        return {
            "align_corners": scalar(0, "bool", False),
            "half_pixel_centers": scalar(1, "bool", False),
        }
    if opname == "DEPTH_TO_SPACE":
        return {"block_size": scalar(0, "int32")}
    if opname == "SQUEEZE":
        dims = t.scalar_vector(0, "int32").tolist() if t is not None else []
        return {"squeeze_dims": dims}
    if opname == "FULLY_CONNECTED":
        return {
            "activation": _activation(scalar(0, "int8")),
            "keep_num_dims": scalar(2, "bool", False),
        }
    if opname == "LEAKY_RELU":
        return {"alpha": scalar(0, "float32", 0.0)}
    if opname == "SOFTMAX":
        return {"beta": scalar(0, "float32", 1.0)}
    if opname == "SPLIT":
        return {"num_splits": scalar(0, "int32", 0)}
    if opname == "UNPACK":
        return {"num": scalar(0, "int32", 0), "axis": scalar(1, "int32", 0)}
    if opname == "SPACE_TO_DEPTH":
        return {"block_size": scalar(0, "int32")}
    if opname == "BATCH_MATMUL":
        return {"adj_x": scalar(0, "bool", False),
                "adj_y": scalar(1, "bool", False)}
    if opname == "GELU":
        return {"approximate": scalar(0, "bool", False)}
    if opname == "L2_NORMALIZATION":
        # L2NormOptions carries a fused activation too; decode it so a
        # model using one fails loudly in the executor instead of
        # silently skipping it.
        return {"activation": _activation(scalar(0, "int8"))}
    if opname == "GATHER":
        return {"axis": scalar(0, "int32", 0),
                "batch_dims": scalar(1, "int32", 0)}
    if opname == "MIRROR_PAD":
        # MirrorPadMode: REFLECT = 0, SYMMETRIC = 1.
        return {"mode": scalar(0, "int8", 0)}
    return {}


def _decode_custom_options(custom_name: str, op: Table) -> dict:
    """Decodes custom-op options.

    MediaPipe's ``Convolution2DTransposeBias`` (and ``MaxPoolingWithArgmax2D``
    family) store a raw ``TfLiteTransposeConvParams`` struct in
    ``custom_options``: three little-endian int32s — padding (TfLitePadding:
    1=SAME, 2=VALID), stride_width, stride_height.
    """
    raw = op.scalar_vector(5, "uint8").tobytes()
    if custom_name == "Convolution2DTransposeBias":
        if len(raw) >= 12:
            vals = np.frombuffer(raw[:12], dtype="<i4")
            # TfLitePadding: 0=UNKNOWN, 1=SAME, 2=VALID -> schema Padding enum
            padding = PADDING_SAME if vals[0] == 1 else PADDING_VALID
            return {
                "padding": padding,
                "stride_w": int(vals[1]),
                "stride_h": int(vals[2]),
            }
        # Default used by the MediaPipe segmenter graphs.
        return {"padding": PADDING_SAME, "stride_w": 2, "stride_h": 2}
    return {"raw": raw}


def _read_sparsity(t: Table) -> Optional[dict]:
    sp = t.table(6)
    if sp is None:
        return None
    dim_metadata = []
    for dm in sp.table_vector(2):
        fmt = dm.scalar(0, "int8")  # 0=DENSE, 1=SPARSE_CSR
        entry: dict[str, Any] = {"format": int(fmt)}
        if fmt == 0:
            entry["dense_size"] = dm.scalar(1, "int32")
        else:
            seg_type, seg = dm.union(2, 3)
            idx_type, idx = dm.union(4, 5)
            # SparseIndexVector union: 1=Int32Vector, 2=Uint16Vector, 3=Uint8Vector
            dt = {1: "int32", 2: "uint16", 3: "uint8"}
            entry["array_segments"] = (
                seg.scalar_vector(0, dt[seg_type]).astype(np.int64)
                if seg is not None
                else np.empty(0, np.int64)
            )
            entry["array_indices"] = (
                idx.scalar_vector(0, dt[idx_type]).astype(np.int64)
                if idx is not None
                else np.empty(0, np.int64)
            )
        dim_metadata.append(entry)
    return {
        "traversal_order": sp.scalar_vector(0, "int32").tolist(),
        "block_map": sp.scalar_vector(1, "int32").tolist(),
        "dim_metadata": dim_metadata,
    }


def parse_tflite(buf: bytes) -> ModelIR:
    """Parses a .tflite flatbuffer into a :class:`ModelIR`."""
    if len(buf) < 8 or buf[4:8] != b"TFL3":
        raise ValueError(
            "Not a TFLite flatbuffer (missing 'TFL3' file identifier)")
    model = Table.root(buf)

    # Operator codes: name per opcode index.
    opcode_names = []
    for oc in model.table_vector(1):
        deprecated = oc.scalar(0, "int8")
        builtin = oc.scalar(3, "int32")
        code = max(int(deprecated), int(builtin))
        custom = oc.string(1)
        if custom is not None and code == 32:
            opcode_names.append(("CUSTOM", custom))
        else:
            name = OPNAMES.get(code)
            if name is None:
                raise NotImplementedError(f"Unsupported TFLite builtin op code {code}")
            opcode_names.append((name, None))

    buffers = model.table_vector(4)
    subgraphs = model.table_vector(2)
    if len(subgraphs) != 1:
        raise NotImplementedError("Only single-subgraph models are supported")
    g = subgraphs[0]

    tensors: list[TensorIR] = []
    for i, t in enumerate(g.table_vector(0)):
        shape = tuple(int(d) for d in t.scalar_vector(0, "int32"))
        ttype = t.scalar(1, "int8")
        dtype = TENSOR_DTYPE.get(int(ttype))
        if dtype is None:
            raise NotImplementedError(f"Unsupported tensor type {ttype}")
        buf_idx = t.scalar(2, "uint32")
        data = None
        sparsity = _read_sparsity(t)
        if 0 < buf_idx < len(buffers):
            raw = buffers[buf_idx].scalar_vector(0, "uint8")
            if raw.size:
                flat = raw.view(dtype)
                if sparsity is not None:
                    data = flat.copy()  # densified later by the executor pass
                else:
                    data = flat.reshape(shape).copy()
        quant = None
        qt = t.table(4)
        if qt is not None:
            scale = qt.scalar_vector(2, "float32")
            if scale.size:
                zp = qt.scalar_vector(3, "int64")
                quant = {
                    "scale": np.asarray(scale, np.float32).copy(),
                    "zero_point": (np.asarray(zp, np.int64).copy() if zp.size
                                   else np.zeros(scale.size, np.int64)),
                    # slot 6: the details union before it takes two slots
                    # (details_type, details).
                    "dim": int(qt.scalar(6, "int32", 0)),
                }
        tensors.append(
            TensorIR(
                index=i,
                name=t.string(3) or f"tensor_{i}",
                shape=shape,
                dtype=dtype,
                data=data,
                sparsity=sparsity,
                quant=quant,
            )
        )

    ops: list[OpIR] = []
    for op in g.table_vector(3):
        opcode_index = op.scalar(0, "uint32")
        name, custom = opcode_names[opcode_index]
        if name == "CUSTOM":
            options = _decode_custom_options(custom, op)
            name = f"CUSTOM:{custom}"
        else:
            options = _decode_options(name, op)
        ops.append(
            OpIR(
                name=name,
                inputs=[int(x) for x in op.scalar_vector(1, "int32")],
                outputs=[int(x) for x in op.scalar_vector(2, "int32")],
                options=options,
            )
        )

    return ModelIR(
        tensors=tensors,
        ops=ops,
        inputs=[int(x) for x in g.scalar_vector(1, "int32")],
        outputs=[int(x) for x in g.scalar_vector(2, "int32")],
        description=model.string(3) or "",
    )


def densify(tensor: TensorIR) -> np.ndarray:
    """Expands a TFLite sparse constant tensor to dense.

    Implements the TFLite sparsity format (traversal order over original +
    block dimensions, per-dimension DENSE or SPARSE_CSR metadata) as used by
    the ``face_detection_full_range_sparse`` model.
    """
    sp = tensor.sparsity
    assert sp is not None and tensor.data is not None
    shape = list(tensor.shape)
    traversal = sp["traversal_order"]
    block_map = sp["block_map"]
    dm = sp["dim_metadata"]
    n_orig = len(shape)

    # Block sizes: for each original dim d in block_map, the block dim size
    # is the dense_size of the dim_metadata entry at the traversal POSITION
    # whose VALUE names that block dim (n_orig + block_pos).  Indexing dm by
    # n_orig + block_pos directly would assume block dims are traversed in
    # block_map order — the spec allows any permutation.
    block_sizes = {}
    for block_pos, orig_dim in enumerate(block_map):
        p = traversal.index(n_orig + block_pos)
        block_sizes[orig_dim] = dm[p]["dense_size"]

    values = tensor.data
    out = np.zeros(int(np.prod(shape)), dtype=tensor.dtype)

    # Expanded shape in traversal order.
    def dim_extent(trav_pos):
        d = traversal[trav_pos]
        if trav_pos < n_orig:
            size = shape[d]
            if d in block_sizes:
                size //= block_sizes[d]
            return size
        return block_sizes[block_map[d - n_orig]]

    # Recursive walk over traversal dims, tracking CSR segment ranges.
    coords = [0] * len(traversal)
    val_pos = [0]

    def orig_index(coords):
        # Map traversal coords -> original tensor flat index.
        idx = [0] * n_orig
        for trav_pos, c in enumerate(coords):
            d = traversal[trav_pos]
            if trav_pos < n_orig:
                if d in block_sizes:
                    idx[d] += c * block_sizes[d]
                else:
                    idx[d] = c
            else:
                od = block_map[d - n_orig]
                idx[od] += c
        flat = 0
        for d in range(n_orig):
            flat = flat * shape[d] + idx[d]
        return flat

    def walk(trav_pos):
        if trav_pos == len(traversal):
            out[orig_index(coords)] = values[val_pos[0]]
            val_pos[0] += 1
            return
        meta = dm[trav_pos]
        if meta["format"] == 0:
            for c in range(dim_extent(trav_pos)):
                coords[trav_pos] = c
                walk(trav_pos + 1)
        else:
            # SPARSE_CSR over this dimension: the segment index is the flat
            # position within all outer dims iterated so far.
            seg = meta["array_segments"]
            idxs = meta["array_indices"]
            walk.seg_cursor = getattr(walk, "seg_cursor", {})
            pos = walk.seg_cursor.get(trav_pos, 0)
            start, end = int(seg[pos]), int(seg[pos + 1])
            walk.seg_cursor[trav_pos] = pos + 1
            for k in range(start, end):
                coords[trav_pos] = int(idxs[k])
                walk(trav_pos + 1)

    walk(0)
    return out.reshape(shape)
