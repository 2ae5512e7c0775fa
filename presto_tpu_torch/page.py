"""Columnar Page/Block core as device-resident torch tensors.

Counterpart of presto_tpu/page.py, and like it a re-designed equivalent of
the reference data-plane representation
(presto-spi/src/main/java/com/facebook/presto/spi/Page.java:34 — "A Page is a
Block[]" — and the Block implementations under presto-spi/.../spi/block/).
The semantics are the JAX package's, so pages carry over between the two:

* A Block is a fixed-capacity tensor plus a validity (non-null) mask.
  Rows in [0, capacity) beyond the live set are garbage and masked out by
  `Page.live_mask()`; capacities are bucketed with `round_capacity`.
* The live row count is a 0-d int32 tensor on the page's device.
* Strings are int32 dictionary codes over a host-side sorted tuple (or a
  `LazyDict`); blocks carry an interned dictionary id.

Every constructor takes an explicit `device`. Entry points default to
"cuda"; the tests pass "cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import types as T

# Host-side dictionary interning: blocks carry a small int id instead of the
# string tuple, so equal dictionaries share one id and comparisons between
# columns of one table never need to unify dictionaries.
_DICT_INTERN: dict = {}
_DICT_BY_ID: list = []

_NP_DTYPE = {
    torch.bool: np.bool_,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float32: np.float32,
    torch.float64: np.float64,
}


class LazyDict:
    """A dictionary whose entries are computed on demand — for huge formatted
    string domains (c_name = 'Customer#%09d', phones, …) where materializing
    tuples of millions of python strings would defeat the point of dictionary
    encoding. Subclasses must be hashable value objects and implement
    __len__/__getitem__; `is_sorted` declares whether entry order equals
    lexicographic order (required for <,>,ORDER BY on codes)."""

    is_sorted: bool = True

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i: int) -> str:
        raise NotImplementedError

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _dict_key(d):
    """Intern key: tuples and lazy (hashable value-object) dictionaries as
    they are, anything else materialized to a tuple."""
    if isinstance(d, (tuple, LazyDict)):
        return d
    if hasattr(d, "is_sorted") and hasattr(d, "__getitem__"):
        return d  # a lazy dictionary of another package: hashable by value
    return tuple(d)


def intern_dictionary(d) -> int:
    key = _dict_key(d)
    did = _DICT_INTERN.get(key)
    if did is None:
        did = len(_DICT_BY_ID)
        _DICT_INTERN[key] = did
        _DICT_BY_ID.append(key)
    return did


def dictionary_by_id(did: int) -> Tuple[str, ...]:
    return _DICT_BY_ID[did]


def to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy array (or sequence) -> contiguous tensor of `dtype` on `device`."""
    a = np.ascontiguousarray(np.asarray(arr).astype(_NP_DTYPE[dtype], copy=False))
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class Block:
    """One column: `data[capacity]` storage + `valid[capacity]` non-null mask.

    `valid is None` means "no nulls". `dict_id` identifies a host-side sorted
    dictionary for VARCHAR blocks (see intern_dictionary). Long decimals have
    data of shape (capacity, 2) (ops/decimal128.py)."""

    data: torch.Tensor
    type: T.Type
    valid: Optional[torch.Tensor] = None
    dict_id: Optional[int] = None
    # collection blocks only (ArrayType / MapType results): data is
    # (capacity, width), `lengths` the per-row element counts, `elem_valid`
    # an optional per-element null mask, `key_block` the keys of a MAP
    lengths: Optional[torch.Tensor] = None
    elem_valid: Optional[torch.Tensor] = None
    key_block: Optional["Block"] = None

    @property
    def dictionary(self) -> Optional[Tuple[str, ...]]:
        return None if self.dict_id is None else dictionary_by_id(self.dict_id)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def take_rows(self, idx) -> "Block":
        """Reindex every row-aligned tensor (gather/slice/permutation),
        preserving collection companions."""
        return Block(
            self.data[idx],
            self.type,
            None if self.valid is None else self.valid[idx],
            self.dict_id,
            lengths=None if self.lengths is None else self.lengths[idx],
            elem_valid=(
                None if self.elem_valid is None else self.elem_valid[idx]
            ),
            key_block=(
                None if self.key_block is None else self.key_block.take_rows(idx)
            ),
        )

    def gather(self, idx, valid) -> "Block":
        """Rows `idx` of every row-aligned tensor, with the validity mask
        `valid` given by the caller (join and compaction outputs)."""
        return Block(
            self.data[idx], self.type, valid, self.dict_id,
            lengths=None if self.lengths is None else self.lengths[idx],
            elem_valid=(
                None if self.elem_valid is None else self.elem_valid[idx]
            ),
            key_block=(
                None if self.key_block is None else self.key_block.take_rows(idx)
            ),
        )

    def to(self, device, non_blocking: bool = False) -> "Block":
        """Every row-aligned tensor on `device` (no copy when it is there
        already)."""
        mv = lambda x: None if x is None else x.to(device, non_blocking=non_blocking)  # noqa: E731
        return Block(
            mv(self.data), self.type, mv(self.valid), self.dict_id,
            lengths=mv(self.lengths), elem_valid=mv(self.elem_valid),
            key_block=None if self.key_block is None else self.key_block.to(device,
                                                                            non_blocking),
        )

    def valid_mask(self) -> torch.Tensor:
        if self.valid is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool, device=self.device)
        return self.valid

    # -- host-side constructors --
    @staticmethod
    def from_numpy(
        arr: np.ndarray,
        typ: T.Type,
        valid: Optional[np.ndarray] = None,
        dictionary: Optional[Sequence[str]] = None,
        device="cuda",
    ) -> "Block":
        data = to_tensor(arr, typ.storage_dtype, device)
        v = None if valid is None else to_tensor(valid, torch.bool, device)
        did = intern_dictionary(dictionary) if dictionary is not None else None
        return Block(data, typ, v, did)

    @staticmethod
    def from_strings(
        values: Sequence[Optional[str]],
        dictionary: Optional[Sequence[str]] = None,
        device="cuda",
    ) -> "Block":
        """Dictionary-encode python strings into a sorted-dictionary block."""
        present = [v for v in values if v is not None]
        if dictionary is None:
            dictionary = tuple(sorted(set(present)))
        else:
            dictionary = tuple(dictionary)
        index = {s: i for i, s in enumerate(dictionary)}
        codes = np.array([index[v] if v is not None else 0 for v in values], np.int32)
        valid = (
            None
            if len(present) == len(values)
            else np.array([v is not None for v in values], np.bool_)
        )
        return Block.from_numpy(codes, T.VARCHAR, valid, dictionary, device)

    def to_numpy(self) -> np.ndarray:
        return to_numpy(self.data)


@dataclasses.dataclass
class Page:
    """A batch of rows: positional blocks + column names + live row count.

    `count` is a 0-d int32 tensor on the page's device. Live rows always
    occupy positions [0, count)."""

    blocks: Tuple[Block, ...]
    names: Tuple[str, ...]
    count: torch.Tensor  # int32 scalar

    # -- shape info --
    @property
    def capacity(self) -> int:
        return self.blocks[0].capacity if self.blocks else 0

    @property
    def device(self) -> torch.device:
        return self.count.device

    def live_mask(self) -> torch.Tensor:
        return (
            torch.arange(self.capacity, dtype=torch.int32, device=self.device)
            < self.count
        )

    def block(self, name: str) -> Block:
        return self.blocks[self.names.index(name)]

    def select(self, names: Sequence[str]) -> "Page":
        return Page(tuple(self.block(n) for n in names), tuple(names), self.count)

    def to(self, device) -> "Page":
        device = torch.device(device)
        if self.device == device:
            return self
        return Page(
            tuple(b.to(device) for b in self.blocks), self.names,
            self.count.to(device),
        )

    # -- construction --
    @staticmethod
    def from_blocks(
        blocks: Sequence[Block], names: Sequence[str], count=None, device=None
    ) -> "Page":
        blocks = tuple(blocks)
        if count is None:
            count = blocks[0].capacity if blocks else 0
        if device is None:
            if blocks:
                device = blocks[0].device
            elif isinstance(count, torch.Tensor):
                device = count.device
            else:
                raise ValueError("a page without blocks needs an explicit device")
        if isinstance(count, torch.Tensor):
            count = count.to(device=device, dtype=torch.int32).reshape(())
        else:
            count = torch.tensor(int(count), dtype=torch.int32, device=device)
        return Page(blocks, tuple(names), count)

    @staticmethod
    def from_dict(columns: dict, pad_to: Optional[int] = None, device="cuda") -> "Page":
        """Build a device page from {name: numpy array | (array, Type) | Block |
        list-of-strings}. Pads every column to `pad_to` capacity if given."""
        blocks = []
        names = []
        n = None
        for name, value in columns.items():
            blk = _to_block(value, device)
            if n is None:
                n = blk.capacity
            elif blk.capacity != n:
                raise ValueError(
                    f"column {name!r} has {blk.capacity} rows, expected {n}"
                )
            blocks.append(blk)
            names.append(name)
        if n is None:
            n = 0
        if pad_to is not None and pad_to != n:
            if pad_to < n:
                raise ValueError("pad_to smaller than data")
            blocks = [_pad_block(b, pad_to) for b in blocks]
        return Page.from_blocks(blocks, names, count=n, device=device)

    # -- host materialization --
    def to_pylist(self) -> list:
        """Materialize live rows as python tuples (decoding dictionaries;
        collection blocks decode to lists / dicts)."""
        n = int(self.count)
        cols = []
        for b in self.blocks:
            data = to_numpy(b.data[:n])
            valid = None if b.valid is None else to_numpy(b.valid[:n])
            if b.lengths is not None or isinstance(b.type, (T.ArrayType, T.MapType)):
                cols.append(_collection_pylist(b, data, valid, n))
                continue
            col = []
            for i in range(n):
                if valid is not None and not valid[i]:
                    col.append(None)
                else:
                    col.append(b.type.to_python(data[i], b.dictionary))
            cols.append(col)
        return [tuple(row) for row in zip(*cols)] if cols else []

    def to_dict_of_numpy(self) -> dict:
        n = int(self.count)
        return {name: to_numpy(b.data[:n]) for name, b in zip(self.names, self.blocks)}


def _collection_pylist(b: Block, data, valid, n: int) -> list:
    """Decode an ArrayType / MapType block's rows to lists / dicts. A
    fixed-width array with no per-row lengths (a sketch state: HLL
    registers, quantile-sketch bins) has every lane live."""
    if b.lengths is None:
        lens = np.full(n, data.shape[1] if data.ndim > 1 else 0, np.int64)
    else:
        lens = to_numpy(b.lengths[:n])
    ev = None if b.elem_valid is None else to_numpy(b.elem_valid[:n])
    if isinstance(b.type, T.MapType):
        kb = b.key_block
        kdata = to_numpy(kb.data[:n])
        kt, vt = b.type.key, b.type.value
        col = []
        for i in range(n):
            if valid is not None and not valid[i]:
                col.append(None)
                continue
            row = {}
            for j in range(int(lens[i])):
                k = kt.to_python(kdata[i, j], kb.dictionary)
                if data.ndim == 3:
                    # array-valued map (multimap_agg): the values of a key
                    # ride the third axis, liveness in the 3-D elem_valid
                    row[k] = [
                        vt.element.to_python(data[i, j, e], b.dictionary)
                        for e in range(data.shape[2])
                        if ev is None or ev[i, j, e]
                    ]
                elif ev is not None and not ev[i, j]:
                    row[k] = None
                else:
                    row[k] = vt.to_python(data[i, j], b.dictionary)
            col.append(row)
        return col
    et = b.type.element
    col = []
    for i in range(n):
        if valid is not None and not valid[i]:
            col.append(None)
            continue
        col.append([
            None if ev is not None and not ev[i, j]
            else et.to_python(data[i, j], b.dictionary)
            for j in range(int(lens[i]))
        ])
    return col


def page_from_numpy(columns, types, dictionaries=None, count=None, device="cuda",
                    valids=None) -> Page:
    """Carry host state onto the device: {name: numpy storage array} with
    {name: Type}, optional {name: dictionary} and {name: validity mask}.
    `count` defaults to the common column length (no padding)."""
    dictionaries = dictionaries or {}
    valids = valids or {}
    blocks, names = [], []
    for name, arr in columns.items():
        blocks.append(
            Block.from_numpy(
                arr, types[name], valids.get(name), dictionaries.get(name), device
            )
        )
        names.append(name)
    if count is None:
        count = blocks[0].capacity if blocks else 0
    return Page.from_blocks(blocks, names, count=count, device=device)


def page_from_reference(ref_page, device="cuda") -> Page:
    """Turn a presto_tpu Page (any object with blocks/names/count whose
    blocks expose data/valid/type/dictionary as array-likes) into this
    package's Page on `device`. Types map through their SQL spelling, the
    dictionaries through their entries (lazy ones stay lazy)."""
    blocks = [block_from_reference(b, device) for b in ref_page.blocks]
    return Page.from_blocks(blocks, ref_page.names, count=int(ref_page.count),
                            device=device)


def block_from_reference(b, device="cuda", typ: Optional[T.Type] = None) -> Block:
    """One presto_tpu Block (or expression value) as this package's Block,
    collection companions included: per-row lengths, the element null mask,
    a MAP's key block and the element dictionary."""
    if typ is None:
        typ = _type_from_reference(b.type)
    valid = None if b.valid is None else to_tensor(np.asarray(b.valid), torch.bool, device)
    lengths = getattr(b, "lengths", None)
    elem_valid = getattr(b, "elem_valid", None)
    kb = getattr(b, "key_block", None)
    key_block = None
    if kb is not None:
        key_block = block_from_reference(kb, device, T.ArrayType(typ.key))
    dictionary = b.dictionary
    return Block(
        to_tensor(np.asarray(b.data), typ.storage_dtype, device), typ, valid,
        None if dictionary is None else intern_dictionary(dictionary),
        lengths=None if lengths is None else to_tensor(np.asarray(lengths), torch.int32,
                                                       device),
        elem_valid=None if elem_valid is None else to_tensor(np.asarray(elem_valid),
                                                             torch.bool, device),
        key_block=key_block,
    )


def _type_from_reference(t) -> T.Type:
    """A presto_tpu type through its SQL spelling; the HLL sketch marker
    of approx_set's ARRAY(TINYINT) has no spelling, so it carries over."""
    typ = T.parse_type(t.display())
    sketch = getattr(t, "sketch", None)
    if sketch is not None and isinstance(typ, T.ArrayType):
        typ = T.ArrayType(typ.element, sketch=sketch)
    return typ


def _to_block(value, device) -> Block:
    if isinstance(value, Block):
        return value.to(device)
    if isinstance(value, tuple) and len(value) == 2 and isinstance(value[1], T.Type):
        arr, typ = value
        return Block.from_numpy(np.asarray(arr), typ, device=device)
    if isinstance(value, (list,)) and value and isinstance(value[0], (str, type(None))):
        return Block.from_strings(value, device=device)
    arr = np.asarray(value)
    typ = _infer_type(arr)
    return Block.from_numpy(arr, typ, device=device)


def _infer_type(arr: np.ndarray) -> T.Type:
    if arr.dtype == np.bool_:
        return T.BOOLEAN
    if np.issubdtype(arr.dtype, np.integer):
        return T.BIGINT if arr.dtype.itemsize > 4 else T.INTEGER
    if np.issubdtype(arr.dtype, np.floating):
        return T.DOUBLE
    raise TypeError(f"cannot infer SQL type for dtype {arr.dtype}")


def _pad_block(b: Block, capacity: int) -> Block:
    n = b.capacity
    pad = capacity - n

    def padarr(x, fill_bool=False):
        if x is None:
            return None
        z = torch.zeros(
            (pad,) + tuple(x.shape[1:]),
            dtype=torch.bool if fill_bool else x.dtype,
            device=x.device,
        )
        return torch.cat([x, z])

    return Block(
        padarr(b.data),
        b.type,
        padarr(b.valid, True),
        b.dict_id,
        lengths=padarr(b.lengths),
        elem_valid=padarr(b.elem_valid, True),
        key_block=None if b.key_block is None else _pad_block(b.key_block, capacity),
    )


def round_capacity(n: int, minimum: int = 16) -> int:
    """Bucket a row count to the next power of two (bounded shape variety —
    the analog of the reference's adaptive batch sizing in
    presto-main/.../sql/gen/PageFunctionCompiler)."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap
