"""Fast batched row lookup from small parameter tables.

A lookup into a table of at most ONEHOT_MAX_ROWS rows is a one-hot
[N, K] x [K, C] matmul (the renderer's first accelerator could not gather
per lane; ARCHITECTURE §3), and packing all of a table's fields into one
[K, C] matrix amortizes a single lookup across every field. Whether a
plain gather is faster on the GPU is an open measurement (ROADMAP). This module provides the pack/lookup/unpack
machinery used by the material, primitive and light tables.

Integer fields round-trip exactly through float32 for |v| < 2^24.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Above this row count the one-hot matrix gets too large; fall back to a
# single (wide) gather which amortizes the index cost across all channels.
ONEHOT_MAX_ROWS = 128


def pack_fields(arrays) -> tuple[np.ndarray, list]:
    """Pack host arrays (each [K, ...]) into one [K, C] float32 matrix.

    Returns (packed, layout) where layout records (offset, shape, dtype)
    per field for `unpack_fields`.
    """
    cols = []
    layout = []
    offset = 0
    k = None
    for a in arrays:
        a = np.asarray(a)
        if k is None:
            k = a.shape[0]
        assert a.shape[0] == k
        flat = a.reshape(k, -1).astype(np.float32)
        cols.append(flat)
        layout.append((offset, a.shape[1:], a.dtype))
        offset += flat.shape[1]
    return np.concatenate(cols, axis=1), layout


def lookup_rows(packed, idx, num_rows: int):
    """Gather rows of packed [K, C] for index batch idx [N] -> [N, C]."""
    if num_rows <= ONEHOT_MAX_ROWS:
        onehot = (
            idx[:, None] == jnp.arange(num_rows, dtype=idx.dtype)[None, :]
        ).astype(packed.dtype)
        return onehot @ packed
    return packed[idx]


def unpack_fields(rows, layout):
    """Split [N, C] back into per-field arrays with original trailing shapes
    and dtypes."""
    out = []
    for offset, shape, dtype in layout:
        dtype = np.dtype(dtype)
        size = int(np.prod(shape)) if shape else 1
        chunk = rows[:, offset:offset + size]
        if shape:
            chunk = chunk.reshape(rows.shape[0], *shape)
        else:
            chunk = chunk[:, 0]
        if np.issubdtype(dtype, np.integer):
            chunk = jnp.round(chunk).astype(jnp.int32)
        elif dtype == np.bool_:
            chunk = chunk > 0.5
        out.append(chunk)
    return out


def select_slot(field, slot_idx):
    """Per-lane slot selection along axis 1 without take_along_axis:
    field [N, L, ...] + slot_idx [N] -> [N, ...] via masked sum (L is tiny)."""
    l = field.shape[1]
    onehot = (
        slot_idx[:, None] == jnp.arange(l, dtype=slot_idx.dtype)[None, :]
    )
    if field.ndim > 2:
        onehot = onehot.reshape(onehot.shape + (1,) * (field.ndim - 2))
    if jnp.issubdtype(field.dtype, jnp.integer) or field.dtype == bool:
        return jnp.sum(jnp.where(onehot, field, 0), axis=1).astype(field.dtype)
    return jnp.sum(field * onehot.astype(field.dtype), axis=1)
