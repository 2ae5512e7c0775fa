"""Row hashing for group-by and joins (torch counterpart of
presto_tpu/ops/hashing.py).

The equivalent of the reference's compiled hash strategies
(presto-main/.../sql/gen/JoinCompiler.java hash generation and
operator/InterpretedHashGenerator.java): per-column splitmix64 hashes
combined into one row hash. NULLs hash to a fixed constant.

torch has no uint64 `+` or `>>` on every device, so the hashes live in
int64 with the same bits as the JAX package's uint64 hashes: products and
sums wrap mod 2^64 either way, and every logical right shift is an
arithmetic shift masked by hand (`_srl`). `unsigned_order_key` maps a hash
to an int64 whose signed order is the uint64 order, for sorting.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def _signed(u: int) -> int:
    """uint64 constant -> the int64 with the same bits."""
    return u - (1 << 64) if u >= (1 << 63) else u


_C1 = _signed(0xBF58476D1CE4E5B9)
_C2 = _signed(0x94D049BB133111EB)
_GOLDEN = _signed(0x9E3779B97F4A7C15)
_NULL_HASH = _signed(0x9AE16A3B2F90404F)
_SIGN_BIT = -(1 << 63)


def _srl(x, k: int):
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x):
    x = (x ^ _srl(x, 30)) * _C1
    x = (x ^ _srl(x, 27)) * _C2
    return x ^ _srl(x, 31)


def _bits64(data) -> torch.Tensor:
    """The uint64 bits the JAX package hashes, as int64: signed integers
    sign-extend, float64 reinterprets, float32 zero-extends its 32 bits."""
    if data.is_floating_point():
        # canonicalize -0.0 == 0.0 and ALL NaN payloads to one quiet NaN
        data = torch.where(data == 0, torch.zeros_like(data), data)
        data = torch.where(torch.isnan(data), torch.full_like(data, float("nan")), data)
        if data.dtype == torch.float64:
            return data.view(torch.int64)
        return data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return data.to(torch.int64)


def hash_column(data, valid: Optional[torch.Tensor] = None):
    """64-bit hash (int64 bits) of one column's storage values.
    Multi-lane columns (long decimal) hash-combine per lane."""
    if data.ndim == 2:
        h = combine_hashes([hash_column(data[:, i]) for i in range(data.shape[1])])
    else:
        h = mix64(_bits64(data))
    if valid is not None:
        h = torch.where(valid, h, torch.full_like(h, _NULL_HASH))
    return h


def combine_hashes(hashes: Sequence[torch.Tensor]):
    """Order-dependent combination (reference CombineHashFunction semantics)."""
    out = torch.zeros_like(hashes[0])
    for h in hashes:
        out = out * 31 + h
        out = mix64(out + _GOLDEN)
    return out


def hash_rows(columns) -> torch.Tensor:
    """Hash a sequence of Blocks/Vals (anything with .data/.valid)."""
    hs = [hash_column(c.data, c.valid) for c in columns]
    return combine_hashes(hs) if len(hs) > 1 else hs[0]


def unsigned_order_key(h: torch.Tensor) -> torch.Tensor:
    """int64 key whose signed order equals the uint64 order of `h`."""
    return h ^ _SIGN_BIT


# -- value hashing (joins): varchar columns hash their dictionary VALUES, so
# the build and probe sides of a join tag equal strings identically even when
# the two columns were born with different dictionaries --

# dictionaries beyond this size skip value hashing (the one-time host pass
# over every entry would dominate the join); callers take the sorted layout
_VALUE_HASH_MAX_DICT_DEFAULT = 1 << 22

# (dict_id, device) -> int64 value hashes; interned dictionaries never change
_VALUE_HASH_BY_DICT: dict = {}


def dict_value_hashes(dict_id: int, device="cpu") -> torch.Tensor:
    """(len(dictionary),) value hashes (int64 bits) of an interned
    dictionary: splitmix64 of crc32(utf-8 bytes) | byte length << 32, as
    the JAX package computes them. Cached per dictionary and device."""
    device = torch.device(device)
    key = (dict_id, str(device))
    vh = _VALUE_HASH_BY_DICT.get(key)
    if vh is not None:
        return vh
    host = _VALUE_HASH_BY_DICT.get((dict_id, "cpu"))
    if host is None:
        import zlib

        from ..page import dictionary_by_id

        entries = dictionary_by_id(dict_id)
        raw = np.zeros(len(entries), np.uint64)
        for i, s in enumerate(entries):
            b = s.encode("utf-8", "surrogatepass")
            raw[i] = zlib.crc32(b) | ((len(b) & 0xFFFFFFFF) << 32)
        host = mix64(torch.from_numpy(raw.view(np.int64)))
        _VALUE_HASH_BY_DICT[(dict_id, "cpu")] = host
    vh = host.to(device)
    _VALUE_HASH_BY_DICT[key] = vh
    return vh


def value_hashable(columns) -> bool:
    """True when every varchar column's dictionary is small enough for the
    one-time value-hash pass (non-varchar columns are always fine)."""
    for c in columns:
        if getattr(c, "dict_id", None) is not None:
            d = c.dictionary
            if d is None or len(d) > _VALUE_HASH_MAX_DICT_DEFAULT:
                return False
    return True


def hash_rows_values(columns) -> torch.Tensor:
    """hash_rows with table-independent varchar hashing: dictionary columns
    hash their VALUES through dict_value_hashes. Bit-identical to the JAX
    package's np_hash_rows_values. Callers gate on value_hashable()."""
    hs = []
    for c in columns:
        if getattr(c, "dict_id", None) is not None:
            vh = dict_value_hashes(c.dict_id, c.data.device)
            if len(vh):
                h = vh[torch.clamp(c.data.to(torch.int64), 0, len(vh) - 1)]
            else:
                h = torch.full(c.data.shape, _NULL_HASH, dtype=torch.int64,
                               device=c.data.device)
            if c.valid is not None:
                h = torch.where(c.valid, h, torch.full_like(h, _NULL_HASH))
            hs.append(h)
        else:
            hs.append(hash_column(c.data, c.valid))
    return combine_hashes(hs) if len(hs) > 1 else hs[0]
