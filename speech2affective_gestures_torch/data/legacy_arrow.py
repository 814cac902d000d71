"""Reader of pyarrow<1.0 ``pyarrow.serialize`` blobs (the port's copy of
the JAX package's `data/legacy_arrow.py`).

The TED Gesture DB's LMDB values were written with pyarrow 0.14's legacy
``serialize`` (reference utils/data_preprocessor.py:175-178, read back at
loader_v2.py with ``pyarrow.deserialize``); pyarrow >= 4 has no
(de)serialize. This module parses the container itself and hands the
record batch and the tensors to a modern pyarrow's IPC reader, so it needs
pyarrow when it is called (not when it is imported): without it
`deserialize` raises an ImportError that names the way round, the export
archive (`tools/export_ted_cache.py`, then `--packed-data`). It writes
nothing.

Blob layout (arrow 0.14 ``SerializedPyObject::WriteTo``,
cpp/src/arrow/python/serialize.cc):

    [int32 num_tensors][int32? num_sparse_tensors]
    [int32 num_ndarrays][int32 num_buffers]
    <pad to 8>
    RecordBatch stream (legacy framing, metadata V4):
        schema message + one batch (single dense-union column "list",
        length 1 = the [obj] wrapper the python serialize() adds) + EOS
    for each tensor, then each ndarray:
        <pad to 64> tensor IPC message
    for each buffer: int64 size + raw bytes

Header variants (with or without the sparse-tensor count, which landed
mid-0.x) are told apart by attempting the stream parse.

Python objects are rebuilt from the dense union by dispatching on each
child's arrow type and telling sequence kinds apart by field name
("list"/"tuple"/"set"; struct = dict with keys/vals lists; int32 children
named "tensor"/"ndarray"/"buffer" index the out-of-band components), as
arrow 0.14's cpp/src/arrow/python/deserialize.cc::GetValue does.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# pyarrow, imported by each public call (`load_pyarrow`) and read by the
# helpers under this name; the module imports without it
pa = None

NO_PYARROW = (
    "pyarrow is not installed, and the TED LMDB's values are pyarrow-0.14 "
    "serialize blobs that need its IPC reader: export the corpus once with "
    "tools/export_ted_cache.py where lmdb and pyarrow are installed, then "
    "train from the archive with --packed-data")


def load_pyarrow():
    global pa
    try:
        import pyarrow
    except ImportError as e:
        raise ImportError(NO_PYARROW) from e
    pa = pyarrow
    return pyarrow

_ALIGN_STREAM = 8
_ALIGN_TENSOR = 64


class LegacyFormatError(ValueError):
    pass


def _align(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) & ~(alignment - 1)


def _try_header(buf: bytes, n_counts: int):
    """Parse `n_counts` little-endian int32 counts + pad-to-8; returns
    (counts, stream_offset) or None if implausible."""
    size = 4 * n_counts
    if len(buf) < size:
        return None
    counts = struct.unpack(f"<{n_counts}i", buf[:size])
    if any(c < 0 or c > 10_000_000 for c in counts):
        return None
    return counts, _align(size, _ALIGN_STREAM)


def _read_batch(buf: bytes, offset: int):
    """Read the single record batch by walking IPC messages one at a time,
    returning (batch, exact_end_offset_after_EOS).

    `pa.ipc.read_message` consumes exactly one framed message (it handles
    both pre-0.15 legacy framing — what 0.14 wrote — and the continuation
    framing), so `reader.tell()` is exact, unlike the buffered stream
    reader whose tell() can overshoot. The EOS marker after the batch is
    parsed explicitly: 4 bytes (int32 0, legacy) or 8 bytes
    (0xFFFFFFFF + int32 0, continuation)."""
    reader = pa.BufferReader(buf)
    reader.seek(offset)
    schema_msg = pa.ipc.read_message(reader)
    schema = pa.ipc.read_schema(schema_msg)
    batch_msg = pa.ipc.read_message(reader)
    batch = pa.ipc.read_record_batch(batch_msg, schema)
    pos = reader.tell()
    # stream EOS (arrow 0.14 WriteRecordBatchStream closes the stream):
    if buf[pos:pos + 8] == b"\xff\xff\xff\xff\x00\x00\x00\x00":
        pos += 8
    elif buf[pos:pos + 4] == b"\x00\x00\x00\x00":
        pos += 4
    else:
        raise LegacyFormatError(
            f"no stream-EOS marker at offset {pos} after the record batch"
        )
    return batch, pos


def _read_tensors(buf: bytes, offset: int, count: int):
    """Read `count` tensor IPC messages from `offset`, each at the exact
    64-byte-aligned position the 0.14 writer produced (serialize.cc
    WriteTo: AlignStream(kTensorAlignment=64) before the block and after
    every WriteTensor). A tensor that fails to parse at its deterministic
    offset gets ONE fallback probe at the next 64-byte boundary (arrow
    builds with slightly different padding conventions), with a warning;
    anything else is a format error, raised loudly."""
    tensors = []
    reader = pa.BufferReader(buf)
    pos = offset
    for k in range(count):
        pos = _align(pos, _ALIGN_TENSOR)
        if pos >= len(buf):
            raise LegacyFormatError(
                f"tensor component {k}/{count}: offset {pos} past end of blob"
            )
        try:
            reader.seek(pos)
            t = pa.ipc.read_tensor(reader)
        except (pa.ArrowInvalid, OSError) as e:
            fallback = pos + _ALIGN_TENSOR
            try:
                reader.seek(fallback)
                t = pa.ipc.read_tensor(reader)
            except Exception:
                raise LegacyFormatError(
                    f"tensor component {k}/{count} failed to parse at its "
                    f"aligned offset {pos} (and at the one-shot fallback "
                    f"{fallback}): {e}"
                ) from e
            import warnings

            warnings.warn(
                f"legacy blob: tensor component {k} found at {fallback}, "
                f"64 bytes past the predicted offset {pos} (non-0.14 "
                "padding convention?)", stacklevel=3,
            )
        pos = reader.tell()
        tensors.append(t.to_numpy())
    return tensors, pos


def _union_children(arr: "pa.UnionArray"):
    ty = arr.type
    return {ty.type_codes[i]: ty.field(i).name for i in range(ty.num_fields)}


def _from_scalar(scalar, field_name: str, comps: dict) -> Any:
    """One dense-union element -> python object (deserialize.cc::GetValue)."""
    value = scalar.value
    if value is None or not scalar.is_valid:
        return None
    ty = value.type
    if pa.types.is_int32(ty) and field_name in ("tensor", "ndarray", "buffer"):
        pool = {"tensor": "tensors", "ndarray": "ndarrays",
                "buffer": "buffers"}[field_name]
        idx = value.as_py()
        if idx >= len(comps[pool]):
            raise LegacyFormatError(
                f"{field_name} component index {idx} out of range "
                f"({len(comps[pool])} {pool} in header)"
            )
        return comps[pool][idx]
    if pa.types.is_struct(ty):  # dict: field 0 = keys list, field 1 = vals
        keys = _from_list_scalar(value["keys"], comps)
        vals = _from_list_scalar(value["vals"], comps)
        d = dict(zip(keys, vals))
        return _maybe_custom(d)
    if pa.types.is_list(ty):
        items = _from_list_scalar(value, comps)
        if field_name == "tuple":
            return tuple(items)
        if field_name == "set":
            return set(items)
        return items
    if pa.types.is_string(ty) or pa.types.is_binary(ty) or \
            pa.types.is_boolean(ty) or pa.types.is_integer(ty) or \
            pa.types.is_floating(ty):
        return value.as_py()
    if pa.types.is_date64(ty) or pa.types.is_timestamp(ty):
        return value.as_py()
    return value.as_py()


def _from_list_scalar(list_scalar, comps: dict) -> list:
    out = []
    for element in list_scalar:
        if element is None or not element.is_valid:
            out.append(None)
            continue
        name = _scalar_field_name(element)
        out.append(_from_scalar(element, name, comps))
    return out


def _scalar_field_name(union_scalar) -> str:
    ty = union_scalar.type
    code = union_scalar.type_code
    for i in range(ty.num_fields):
        if ty.type_codes[i] == code:
            return ty.field(i).name
    return ""


def _maybe_custom(d: dict) -> Any:
    """0.14's python-level fallback serializes unknown types through the
    SerializationContext as dicts tagged "_pytype_". Only numpy scalars are
    reconstructed here (the only tagged type TED data can contain); anything
    else raises so corruption is loud, not silent."""
    tag = d.get("_pytype_")
    if tag is None:
        return d
    if isinstance(tag, bytes):
        tag = tag.decode()
    if tag.startswith("np.") or tag.startswith("numpy."):
        data = d.get("data")
        dtype = d.get("dtype")
        if dtype is not None:
            return np.dtype(str(dtype)).type(data)
    raise LegacyFormatError(f"unsupported custom-serialized type {tag!r}")


def deserialize(data: bytes) -> Any:
    """Modern-environment replacement for ``pyarrow.deserialize`` (legacy
    0.14 blobs). Supports everything the TED caches contain: nested
    lists/tuples/dicts/sets, str/bytes/bool/int/float/None, numpy arrays."""
    load_pyarrow()
    buf = bytes(data)

    errors = []
    # header variants: 0.14.0 writes 4 counts (tensors, sparse, ndarrays,
    # buffers); earliest 0.x wrote 3. Try the 0.14 layout first. Each
    # variant's FULL walk is attempted — a mid-walk failure under one
    # header interpretation (e.g. a 3-count blob with buffers misread as
    # 4-count) must not pre-empt the other; only when every variant fails
    # is the combined cause list raised.
    for n_counts in (4, 3):
        parsed = _try_header(buf, n_counts)
        if parsed is None:
            errors.append(f"{n_counts}-count header: too short/implausible")
            continue
        counts, offset = parsed
        if n_counts == 4:
            num_tensors, num_sparse, num_ndarrays, num_buffers = counts
            if num_sparse:
                # either a genuine sparse-tensor blob (unsupported, never
                # produced by the TED pipeline) or a 3-count header read
                # as 4 counts — try the next variant
                errors.append(
                    "4-count header: nonzero sparse-tensor count "
                    f"({num_sparse}) — sparse tensors are not supported"
                )
                continue
        else:
            num_tensors, num_ndarrays, num_buffers = counts
        try:
            return _decode_with_counts(
                buf, offset, num_tensors, num_ndarrays, num_buffers
            )
        except (LegacyFormatError, pa.ArrowInvalid, OSError) as e:
            errors.append(f"{n_counts}-count header: {e}")
    raise LegacyFormatError(
        "unrecognized legacy serialize blob: " + "; ".join(errors)
    )


def _decode_with_counts(buf: bytes, offset: int, num_tensors: int,
                        num_ndarrays: int, num_buffers: int) -> Any:
    """Walk one header interpretation end-to-end; raises LegacyFormatError
    (or ArrowInvalid/OSError from pa.ipc) if the blob is inconsistent under
    these counts."""
    batch, pos = _read_batch(buf, offset)
    tensors, pos = _read_tensors(buf, pos, num_tensors)
    ndarrays, pos = _read_tensors(buf, pos, num_ndarrays)
    buffers = []
    # the buffer block always starts 64-aligned: the writer aligns
    # after the stream and after every tensor (serialize.cc WriteTo)
    pos = _align(pos, _ALIGN_TENSOR)
    for b_idx in range(num_buffers):
        try:
            (size,) = struct.unpack_from("<q", buf, pos)
        except struct.error as e:
            raise LegacyFormatError(
                f"buffer component {b_idx}/{num_buffers}: size field at "
                f"{pos} past end of blob"
            ) from e
        pos += 8
        if size < 0 or pos + size > len(buf):
            raise LegacyFormatError(
                f"buffer component {b_idx}/{num_buffers}: size {size} at "
                f"{pos} exceeds blob length {len(buf)}"
            )
        buffers.append(buf[pos:pos + size])
        pos += size
    comps = {"tensors": tensors, "ndarrays": ndarrays, "buffers": buffers}

    col = batch.column(0)
    if isinstance(col, pa.ChunkedArray):
        col = col.combine_chunks()
    if not isinstance(col, pa.UnionArray):
        raise LegacyFormatError(
            f"expected a union column, got {col.type}"
        )
    # element 0 is python serialize()'s [obj] wrapper
    wrapper = _from_scalar(col[0], _scalar_field_name(col[0]), comps)
    if not isinstance(wrapper, list) or len(wrapper) != 1:
        raise LegacyFormatError("missing top-level [obj] wrapper")
    return wrapper[0]
