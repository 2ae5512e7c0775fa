"""Small-G grouped aggregation through a hand-written CUDA kernel.

Counterpart of presto_tpu/ops/pallas_groupby.py's two kernel callers. The
dense path (`maybe_grouped_aggregate`): an aggregate list of count /
count_star / sum / avg / min / max grouped by small-domain dictionary or
boolean keys (at most MAX_GROUPS dense group ids) runs as ONE streaming pass
over the rows. The hash-slot path (`maybe_grouped_aggregate_hash`): keys of
any value get slot-ranked group ids, then the same pass. The eligibility
rules are the JAX package's, unchanged, so the same queries take the same
strategy.

`groupby_totals` is the kernel's wrapper: for CUDA tensors it makes ONE
launch of csrc/groupby_partials.cu (which replaces
pallas_groupby.py::_kernel_factory), which writes the (G, K) totals itself;
for CPU tensors it runs `groupby_totals_plain`, the same function in plain
torch. A launch copies nothing between host and device: the channel kinds
and pointers travel by value in one GroupbyParams struct. There is no fault
fallback: a kernel that fails to build or launch fails the query.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import types as T
from ..expr.compiler import evaluate
from ..page import Block, Page
from .aggregate import AggSpec, _masked_live, avg_from_sum_count, max_identity, min_identity

MAX_GROUPS = 64  # PALLAS_MAX_GROUPS of the JAX package
MAX_CHANNELS = 128
ADD, MIN, MAX, COUNT = 0, 1, 2, 3

# launch shape (csrc/groupby_partials.cu, 256 threads a block): one block
# per ROWS_PER_BLOCK rows, at most MAX_BLOCKS_PER_SM resident blocks per SM
ROWS_PER_BLOCK = 4096
MAX_BLOCKS_PER_SM = 2
# regimes: ATOMIC keeps the tile in shared memory; regime i >= 1 keeps it
# in registers, REGISTER_TILES[i - 1] = (channels, groups) a thread, with
# the channels split over up to MAX_SLICES slices of the block's threads:
# K <= channels * MAX_SLICES and G <= groups
ATOMIC = 0
REGISTER_TILES = ((4, 4), (4, 8), (2, 16), (1, 32))
MAX_SLICES = 2

# launches of the CUDA kernel (one per groupby_totals call on a CUDA tensor)
launches = 0
# aggregations the dense / hash-slot strategies answered (returned a page)
dense_hits = 0
hash_hits = 0


def _rows_pad(num_groups: int, num_channels: int) -> int:
    return -(-(num_groups * num_channels) // 8) * 8


def _channel_list(channels) -> List[torch.Tensor]:
    """A (D, n) tensor, a sequence of D length-n vectors, or None -> the
    list of D vectors (a tensor's rows are views)."""
    return [] if channels is None else list(channels)


def groupby_totals_plain(gid, live, count, channels, kinds, sources, num_groups):
    """(G, K) totals in plain torch: channel k of group g reduces
    channels[sources[k]] (kind ADD/MIN/MAX) or counts rows (COUNT) over rows
    with row < count (every row when count is None), live and gid == g."""
    chans = _channel_list(channels)
    n = gid.shape[0]
    dev = gid.device
    dtype = chans[0].dtype if chans else torch.int64
    sel = live & (gid >= 0) & (gid < num_groups)
    if count is not None:
        sel = sel & (torch.arange(n, device=dev) < count)
    g = torch.where(sel, gid.to(torch.int64), num_groups)  # overflow slot
    cols = []
    for kind, src in zip(kinds, sources):
        if kind == COUNT:
            col = torch.zeros(num_groups + 1, dtype=dtype, device=dev)
            col.index_add_(0, g, torch.ones(n, dtype=dtype, device=dev))
        elif kind == ADD:
            col = torch.zeros(num_groups + 1, dtype=dtype, device=dev)
            col.index_add_(0, g, chans[src])
        else:
            ident = min_identity(dtype) if kind == MIN else max_identity(dtype)
            col = torch.full((num_groups + 1,), ident, dtype=dtype, device=dev)
            col.scatter_reduce_(0, g, chans[src], "amin" if kind == MIN else "amax")
        cols.append(col[:num_groups])
    return torch.stack(cols, dim=1)


def _check_inputs(gid, live, count, chans, kinds, sources, num_groups):
    dev = gid.device
    if gid.dtype != torch.int32 or gid.ndim != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous int32 vector")
    n = gid.shape[0]
    if live.dtype != torch.bool or live.shape != (n,) or not live.is_contiguous():
        raise ValueError("live must be a contiguous bool vector of gid's length")
    if count is not None and (count.dtype != torch.int32 or count.numel() != 1):
        raise ValueError("count must be one int32 or None")
    if chans:
        dtype = chans[0].dtype
        if dtype not in (torch.int64, torch.float64):
            raise ValueError("channels must be int64 or float64")
        for c in chans:
            if c.dtype != dtype or c.shape != (n,) or not c.is_contiguous():
                raise ValueError("channels must be contiguous vectors of one dtype, gid's length")
        if dtype == torch.float64 and any(k in (MIN, MAX) for k in kinds):
            raise ValueError("float64 channels take ADD only")
    if not 0 < len(kinds) <= MAX_CHANNELS or len(kinds) != len(sources):
        raise ValueError(f"need 1..{MAX_CHANNELS} channels with one source each")
    for k, s in zip(kinds, sources):
        if k not in (ADD, MIN, MAX, COUNT) or (k != COUNT and not 0 <= s < len(chans)):
            raise ValueError(f"bad channel kind/source {k}/{s}")
    if not 0 < num_groups <= 4096:
        raise ValueError("num_groups out of range")
    for t in [live] + ([] if count is None else [count]) + chans:
        if t.device != dev:
            raise ValueError("all inputs must be on one device")


class GroupbyParams(ctypes.Structure):
    """csrc/groupby_partials.cu's GroupbyParams, field for field: passed by
    pointer to the C entry, which copies it into the launch."""

    _fields_ = [
        ("gid", ctypes.c_void_p),
        ("live", ctypes.c_void_p),
        ("count", ctypes.c_void_p),  # None: all n rows
        ("out", ctypes.c_void_p),
        ("scratch", ctypes.c_void_p),
        ("ticket", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("G", ctypes.c_int),
        ("K", ctypes.c_int),
        ("aligned", ctypes.c_int),
        ("kind", ctypes.c_int * MAX_CHANNELS),
        ("chan", ctypes.c_void_p * MAX_CHANNELS),
    ]


def pack_params(gid, live, count, out, scratch, ticket, n, num_groups, kinds, chans,
                aligned) -> GroupbyParams:
    """The launch's parameters from device addresses (ints, 0 for none):
    `chans[k]` is output channel k's vector (0 for COUNT)."""
    p = GroupbyParams(gid, live, count or None, out, scratch or None, ticket or None, n,
                      num_groups, len(kinds), int(aligned))
    p.kind[:len(kinds)] = kinds
    p.chan[:len(chans)] = [c or None for c in chans]
    return p


def register_regime(num_groups: int, num_channels: int) -> int:
    """The first register tile that holds (G, K), else ATOMIC."""
    for i, (kb, gb) in enumerate(REGISTER_TILES):
        if num_channels <= kb * MAX_SLICES and num_groups <= gb:
            return i + 1
    return ATOMIC


def launch_plan(n: int, num_groups: int, num_channels: int, sms: int,
                blocks_per_sm: int) -> Tuple[int, int]:
    """(regime, blocks) of one launch: one block per ROWS_PER_BLOCK rows,
    no more than the SMs hold at once (at most MAX_BLOCKS_PER_SM each)."""
    regime = register_regime(num_groups, num_channels)
    want = -(-n // ROWS_PER_BLOCK)
    resident = sms * max(1, min(blocks_per_sm, MAX_BLOCKS_PER_SM))
    return regime, max(1, min(want, resident))


_LIB = None
_DEVICES: Dict[int, tuple] = {}  # device index -> (SM count, ticket counter)
_PLANS: Dict[tuple, tuple] = {}  # (device, dtype, n, G, K) -> (regime, blocks, ticket)


def _lib():
    """The kernel library, built and bound at first use."""
    global _LIB
    if _LIB is None:
        from .. import cuda_build

        lib = cuda_build.load("groupby_partials")
        lib.groupby_totals_launch.restype = ctypes.c_int
        lib.groupby_totals_launch.argtypes = [
            ctypes.POINTER(GroupbyParams), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.groupby_blocks_per_sm.restype = ctypes.c_int
        lib.groupby_blocks_per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.groupby_params_layout.restype = ctypes.c_int
        lib.groupby_params_layout.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        _LIB = lib
    return _LIB


def params_layout() -> List[int]:
    """sizeof(GroupbyParams) and its field offsets as the C side reads them
    (the card's build; compare with `GroupbyParams`)."""
    buf = (ctypes.c_longlong * 16)()
    n = _lib().groupby_params_layout(buf)
    return list(buf[:n])


def _plan(idx: int, dtype, n: int, num_groups: int, num_channels: int) -> tuple:
    """(regime, blocks, ticket counter) of a launch on CUDA device `idx`,
    worked out once per shape (the SM count, the kernel instance's
    resident blocks per SM) and cached."""
    key = (idx, dtype, n, num_groups, num_channels)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    if idx not in _DEVICES:
        dev = torch.device("cuda", idx)
        _DEVICES[idx] = (torch.cuda.get_device_properties(idx).multi_processor_count,
                         torch.zeros(1, dtype=torch.int32, device=dev))
    sms, ticket = _DEVICES[idx]
    regime = register_regime(num_groups, num_channels)
    occ = ctypes.c_int(0)
    with torch.cuda.device(idx):
        rc = _lib().groupby_blocks_per_sm(int(dtype == torch.float64), regime, num_groups,
                                          num_channels, ctypes.byref(occ))
    if rc != 0:
        raise RuntimeError(f"groupby_partials occupancy query failed: cudaError {rc}")
    if len(_PLANS) >= 4096:
        _PLANS.clear()
    plan = _PLANS[key] = launch_plan(n, num_groups, num_channels, sms, occ.value) + (ticket,)
    return plan


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def launch_shape(dev, dtype, n, num_groups, num_channels) -> Tuple[int, int]:
    """(regime, blocks) of the launch for these sizes on CUDA device `dev`."""
    return _plan(_device_index(dev), dtype, n, num_groups, num_channels)[:2]


def _launch(gid, live, count, chans, kinds, sources, num_groups):
    """One launch of csrc/groupby_partials.cu on the current stream: the
    (G, K) totals."""
    global launches
    idx = _device_index(gid.device)
    n = gid.shape[0]
    K = len(kinds)
    dtype = chans[0].dtype if chans else torch.int64
    regime, blocks, ticket = _plan(idx, dtype, n, num_groups, K)
    out = torch.empty((num_groups, K), dtype=dtype, device=gid.device)
    scratch = None
    if blocks > 1:
        scratch = torch.empty((blocks, num_groups * K), dtype=dtype, device=gid.device)
    ptrs = [0 if kind == COUNT else chans[s].data_ptr() for kind, s in zip(kinds, sources)]
    aligned = (gid.data_ptr() % 16 == 0 and live.data_ptr() % 4 == 0
               and all(p % 16 == 0 for p in ptrs))
    params = pack_params(gid.data_ptr(), live.data_ptr(),
                         0 if count is None else count.data_ptr(), out.data_ptr(),
                         0 if scratch is None else scratch.data_ptr(), ticket.data_ptr(), n,
                         num_groups, kinds, ptrs, aligned)
    rc = _lib().groupby_totals_launch(ctypes.byref(params), int(dtype == torch.float64), regime,
                                      blocks, torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"groupby_partials launch failed: cudaError {rc}")
    launches += 1
    return out


def groupby_totals(gid, live, count, channels, kinds, sources, num_groups):
    """(G, K) per-group totals of the channels (see groupby_totals_plain).

    `channels` is a sequence of contiguous length-n int64 or float64
    vectors of one dtype, or a contiguous (D, n) tensor (its rows), or None
    when every channel is COUNT; kinds/sources are per output channel;
    `count` is a device int32 scalar or None for all n rows. CUDA tensors
    go through the kernel, CPU tensors through the plain version."""
    kinds, sources = list(kinds), list(sources)
    chans = _channel_list(channels)
    _check_inputs(gid, live, count, chans, kinds, sources, num_groups)
    if gid.device.type == "cuda":
        if gid.shape[0] == 0:  # nothing to launch over: every total is its identity
            dtype = chans[0].dtype if chans else torch.int64
            ident = [min_identity(dtype) if k == MIN else max_identity(dtype) if k == MAX else 0
                     for k in kinds]
            return torch.stack([torch.full((num_groups,), v, dtype=dtype, device=gid.device)
                                for v in ident], dim=1)
        return _launch(gid, live, count, chans, kinds, sources, num_groups)
    if gid.device.type != "cpu":
        raise ValueError(f"no groupby kernel for device {gid.device}")
    return groupby_totals_plain(gid, live, count, chans, kinds, sources, num_groups)


# ---------------------------------------------------------------------------
# channel plans: aggregates -> the kernel's channels, totals -> blocks
# ---------------------------------------------------------------------------


_SUPPORTED = {"count", "count_star", "sum", "avg", "min", "max"}


def _reference_channel_counts(aggs, ins):
    """Channels the JAX package's kernel would use (int limb channels, f32
    hi/lo channels): its MAX_CHANNELS and tile-size gates decide
    eligibility here too, so both packages pick the same strategy."""
    ch = fch = 0
    for a, v in zip(aggs, ins):
        if a.func in ("count", "count_star", "avg"):
            ch += 1
        if a.func in ("sum", "avg"):
            if v.data.is_floating_point():
                fch += 2
                continue
            ch += 3
        if a.func in ("min", "max"):
            ch += 1
    return ch, fch


def _tile_fits(num_groups: int, aggs, ins) -> bool:
    """The JAX package's kernel gates: channel counts and the output tile
    (rows_pad(G, channels) <= 1024)."""
    ch, fch = _reference_channel_counts(aggs, ins)
    if ch > MAX_CHANNELS or fch > MAX_CHANNELS:
        return False
    return max(_rows_pad(num_groups, ch), _rows_pad(num_groups, fch), 8) <= 1024


class _Channels:
    """One channel set (int64 or float64): data rows and output channels,
    with identical requests shared."""

    def __init__(self):
        self.data: List[torch.Tensor] = []
        self.kinds: List[int] = []
        self.sources: List[int] = []
        self._seen = {}

    def add(self, key, kind, tensor=None) -> int:
        hit = self._seen.get((key, kind))
        if hit is not None:
            return hit
        src = -1
        if tensor is not None:
            src = len(self.data)
            self.data.append(tensor)
        self.kinds.append(kind)
        self.sources.append(src)
        self._seen[(key, kind)] = len(self.kinds) - 1
        return len(self.kinds) - 1


@dataclasses.dataclass
class ChannelPlan:
    """The channels of an aggregate list over one page."""

    ints: _Channels
    floats: _Channels
    rows: int  # the int channel counting each group's live rows
    per_agg: list  # (count channel, value channel, "i"/"f"/None) per aggregate
    dict_ids: list  # the input's dictionary id per aggregate

    def calls(self, gid, live, count, num_groups):
        """[(gid, live, count, channels, kinds, sources, G)]: the
        groupby_totals calls of this plan (int64 set, then float64 set),
        each channel set a list of the plan's vectors (no stacked copy)."""
        return [(gid, live, count, [c.contiguous() for c in chans.data], chans.kinds,
                 chans.sources, num_groups)
                for chans in (self.ints, self.floats) if chans.kinds]


def channel_plan(aggs: Sequence[AggSpec], ins) -> Optional[ChannelPlan]:
    """Channels for evaluated aggregate inputs `ins` (None for count(*));
    None when they exceed MAX_CHANNELS."""
    ich, fchs = _Channels(), _Channels()
    rows = ich.add("rows", COUNT)
    per_agg = []
    for a, v in zip(aggs, ins):
        cnt_ch = rows
        if v is not None and v.valid is not None:
            cnt_ch = ich.add(("valid", a.input), ADD, v.valid.to(torch.int64))
        if a.func in ("count", "count_star"):
            per_agg.append((cnt_ch, None, None))
            continue
        if v.data.is_floating_point():
            chans, dtype, which = fchs, torch.float64, "f"
        else:
            chans, dtype, which = ich, torch.int64, "i"
        x = v.data.to(dtype)
        if a.func in ("sum", "avg"):
            kind, fill = ADD, 0
        else:
            kind = MIN if a.func == "min" else MAX
            fill = min_identity(dtype) if kind == MIN else max_identity(dtype)
        if v.valid is not None:
            x = torch.where(v.valid, x, fill)
        key = "sum" if kind == ADD else a.func
        per_agg.append((cnt_ch, chans.add((key, a.input), kind, x), which))
    if len(ich.kinds) > MAX_CHANNELS or len(fchs.kinds) > MAX_CHANNELS:
        return None
    dict_ids = [None if v is None else v.dict_id for v in ins]
    return ChannelPlan(ich, fchs, rows, per_agg, dict_ids)


def _run_calls(calls, totals=None):
    """(int64 totals, float64 totals) of a plan's calls through `totals`
    (by default the kernel wrapper, groupby_totals)."""
    tot_i = tot_f = None
    for call in calls:
        tot = (totals or groupby_totals)(*call)
        if tot.dtype == torch.float64:
            tot_f = tot
        else:
            tot_i = tot
    return tot_i, tot_f


def _agg_blocks(aggs, cp: ChannelPlan, tot_i, tot_f) -> List[Block]:
    """One output block per aggregate from the plan's (G, K) totals."""
    out: List[Block] = []
    for ai, (a, (cnt_ch, val_ch, which)) in enumerate(zip(aggs, cp.per_agg)):
        cnt = tot_i[:, cnt_ch]
        has = cnt > 0
        if a.func in ("count", "count_star"):
            out.append(Block(cnt, T.BIGINT, None))
            continue
        val = (tot_f if which == "f" else tot_i)[:, val_ch]
        if a.func == "avg":
            out.append(Block(avg_from_sum_count(val, cnt, a.output_type, a.input.type),
                             a.output_type, has))
        elif isinstance(a.output_type, T.DecimalType) and a.output_type.is_long:
            from . import decimal128 as d128

            out.append(Block(d128.from_int64(val), a.output_type, has))
        else:
            # min/max over varchar codes keep the input's dictionary
            out.append(Block(val.to(a.output_type.storage_dtype), a.output_type, has,
                             cp.dict_ids[ai]))
    return out


# ---------------------------------------------------------------------------
# the dense aggregation strategy
# ---------------------------------------------------------------------------


def _eligible_keys(page: Page, group_exprs):
    """Evaluated key Vals + domain sizes when every key is small-domain."""
    keys, domains = [], []
    for e in group_exprs:
        v = evaluate(e, page)
        if isinstance(v.type, T.VarcharType) and v.dictionary is not None:
            d = len(v.dictionary)
        elif isinstance(v.type, T.BooleanType):
            d = 2
        else:
            return None
        keys.append(v)
        domains.append(max(d, 1))
    total = 1
    for d in domains:
        total *= d
    if not 0 < total <= MAX_GROUPS:
        return None
    return keys, domains


@dataclasses.dataclass
class DensePlan:
    """An eligible aggregation, evaluated up to the kernel's inputs."""

    keys: list
    domains: List[int]
    eff_domains: List[int]
    num_groups: int
    gid: torch.Tensor
    live: torch.Tensor
    count: torch.Tensor
    channels: ChannelPlan

    def kernel_calls(self):
        """The groupby_totals calls of this plan (int64 set, then float64)."""
        return self.channels.calls(self.gid, self.live, self.count, self.num_groups)


def dense_plan(page: Page, group_exprs, aggs: Sequence[AggSpec], pre_mask) -> Optional[DensePlan]:
    """The dense strategy's inputs for an eligible aggregation; None when
    the shape is not eligible (the JAX package's rules)."""
    if not group_exprs:
        return None
    if any(a.func not in _SUPPORTED for a in aggs):
        return None
    elig = _eligible_keys(page, group_exprs)
    if elig is None:
        return None
    keys, domains = elig
    ins = []
    for a in aggs:
        if a.input is None:
            ins.append(None)
            continue
        v = evaluate(a.input, page)
        if v.data.ndim != 1:
            return None
        # no float min/max (the JAX package's kernel has no 64-bit compares)
        if v.data.is_floating_point() and a.func not in ("sum", "avg"):
            return None
        ins.append(v)

    dev = page.device
    # dense mixed-radix group id; NULL keys form their OWN group (one extra
    # slot per nullable key)
    gid = torch.zeros(page.capacity, dtype=torch.int32, device=dev)
    eff_domains: List[int] = []
    for v, d in zip(keys, domains):
        code = torch.clamp(v.data.to(torch.int32), 0, d - 1)
        eff = d
        if v.valid is not None:
            code = torch.where(v.valid, code, d)  # null slot = last
            eff = d + 1
        gid = gid * eff + code
        eff_domains.append(eff)
    G = 1
    for d in eff_domains:
        G *= d
    if G > MAX_GROUPS or not _tile_fits(G, aggs, ins):
        return None
    cp = channel_plan(aggs, ins)
    if cp is None:
        return None
    return DensePlan(keys, domains, eff_domains, G, gid, _masked_live(page, pre_mask),
                     page.count, cp)


def maybe_grouped_aggregate(
    page: Page, group_exprs, group_names, aggs: Sequence[AggSpec], pre_mask
) -> Optional[Page]:
    """Route an eligible aggregation through the groupby kernel; None when
    the shape is not eligible (the caller takes the next strategy)."""
    global dense_hits
    dp = dense_plan(page, group_exprs, aggs, pre_mask)
    if dp is None:
        return None
    G = dp.num_groups
    tot_i, tot_f = _run_calls(dp.kernel_calls())

    dev = page.device
    out_blocks: List[Block] = []
    # group key columns from the dense gid (mixed radix decode over the
    # EFFECTIVE domains; a nullable key's last slot decodes to NULL)
    rem = torch.arange(G, dtype=torch.int32, device=dev)
    key_codes = []
    for d in reversed(dp.eff_domains):
        key_codes.append(rem % d)
        rem = rem // d
    key_codes = list(reversed(key_codes))
    for v, code, d, eff in zip(dp.keys, key_codes, dp.domains, dp.eff_domains):
        valid = (code < d) if eff != d else None
        out_blocks.append(
            Block(torch.clamp(code, 0, d - 1).to(v.data.dtype), v.type, valid, v.dict_id)
        )
    out_blocks += _agg_blocks(aggs, dp.channels, tot_i, tot_f)
    out_names = list(group_names) + [a.name for a in aggs]
    out = Page.from_blocks(out_blocks, out_names, count=G, device=dev)
    from .filter import compact

    dense_hits += 1
    return compact(out, tot_i[:, dp.channels.rows] > 0)


# ---------------------------------------------------------------------------
# the hash-slot aggregation strategy
# ---------------------------------------------------------------------------
#
# Counterpart of pallas_groupby.py's maybe_grouped_aggregate_hash: group
# keys of any value hash to 32-bit tags; a distinct-insert assigns every
# live row the slot of its key's first occurrence (true key equality is
# verified against the slot's representative row, so tag collisions
# re-probe instead of merging groups); occupied slots rank-compact to gids
# 0..G-1, and the totals accumulate over those gids. The mode follows the
# device, as the JAX package's follows its backend:
#
# * kernel (CUDA): the groupby_totals kernel, eligible while the JAX
#   package's kernel tile fits (rows_pad(G, channels) <= 1024, G <= 1<<10),
#   with its restrictions on min/max inputs and sum magnitudes;
# * host (CPU): the plain totals, G <= 1<<16.

HASH_MAX_GROUPS_HOST = 1 << 16
HASH_MAX_GROUPS_KERNEL = 1 << 10
_HASH_START_BITS = 13
_HASH_ROUNDS = 96  # distinct-insert advance bound before resizing
_SUM_BOUND = 1 << 45  # the JAX kernel's exact int32-limb bound on |sum input|
_EMPTY_TAG = 0xFFFFFFFF


def _keys_match(keys, rows_a, rows_b) -> torch.Tensor:
    """GROUP BY equality of key tuples at rows_a vs rows_b: NULL == NULL,
    NaN == NaN, -0.0 == 0.0."""
    ok = torch.ones(rows_a.shape, dtype=torch.bool, device=rows_a.device)
    for v in keys:
        a, b = v.data[rows_a], v.data[rows_b]
        part = a == b
        if a.is_floating_point():
            part = part | (torch.isnan(a) & torch.isnan(b))
        if part.ndim == 2:
            part = part.all(dim=-1)
        if v.valid is not None:
            va, vb = v.valid[rows_a], v.valid[rows_b]
            part = (part & va & vb) | (~va & ~vb)
        ok = ok & part
    return ok


def _assign_slots(tag, keys, live, bits: int):
    """Distinct-insert: every live row ends at the slot of its key's first
    occurrence. Returns (slot_of_row, slot_rep, occupied), or None when
    displacement passes _HASH_ROUNDS (the caller retries a bigger table)."""
    dev = tag.device
    size = (1 << bits) + _HASH_ROUNDS + 2
    limit = size - 2  # slot size - 1 is the scatter sink for non-writers
    slot_rep = torch.full((size,), -1, dtype=torch.int64, device=dev)
    slot_tag = torch.full((size,), _EMPTY_TAG, dtype=torch.int64, device=dev)
    desired = tag >> (32 - bits)
    n = tag.shape[0]
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
    off = torch.zeros(n, dtype=torch.int64, device=dev)
    pend = torch.nonzero(live).flatten()
    for _ in range(2 * _HASH_ROUNDS):
        if not pend.numel():
            break
        cand = torch.clamp(desired[pend] + off[pend], max=limit)
        rep = slot_rep[cand]
        occ = rep >= 0
        # (a) occupied: join when tag AND true keys match the representative,
        # otherwise advance (a collision or another group)
        joined = occ & (slot_tag[cand] == tag[pend])
        joined = joined & _keys_match(keys, pend, torch.clamp(rep, min=0))
        off[pend] += (occ & ~joined).to(torch.int64)
        # (b) vacant: race-insert; winners become representatives, losers
        # retry the SAME slot next round (it is occupied now)
        vac = ~occ
        slot_rep[torch.where(vac, cand, size - 1)] = torch.where(vac, pend, -1)
        slot_rep[size - 1] = -1
        won = vac & (slot_rep[cand] == pend)
        slot_tag[torch.where(won, cand, size - 1)] = torch.where(won, tag[pend], _EMPTY_TAG)
        slot_tag[size - 1] = _EMPTY_TAG
        done = joined | won
        slot_of[pend] = torch.where(done, cand, slot_of[pend])
        if int(off[pend].max()) >= _HASH_ROUNDS:
            return None
        pend = pend[~done]
    if pend.numel():
        return None
    return slot_of, slot_rep, torch.nonzero(slot_rep >= 0).flatten()


def _estimate_ndv(tag, live, sample: int = 8192) -> int:
    """NDV estimate from the distinct tags of a strided sample: mostly
    repeats -> about the distinct count; mostly unique -> scale up
    (over-estimating only skips the hash path)."""
    rows = torch.nonzero(live).flatten()
    n = rows.numel()
    if n == 0:
        return 0
    if n > sample:
        rows = rows[:: max(n // sample, 1)][:sample]
    u = torch.unique(tag[rows]).numel()
    s = rows.numel()
    if u < s // 2:
        return max(int(u * 1.25), 1)
    return max(int(n * (u / max(s, 1))), 1)


def _host_accumulate(gid, live, aggs, ins, G) -> Optional[List[Block]]:
    """Host-mode totals: the plain torch version over the gids."""
    cp = channel_plan(aggs, ins)
    if cp is None:
        return None
    return _agg_blocks(aggs, cp, *_run_calls(cp.calls(gid, live, None, G),
                                             groupby_totals_plain))


def _kernel_accumulate(gid, live, aggs, ins, G) -> Optional[List[Block]]:
    """Kernel-mode totals through groupby_totals (csrc/groupby_partials.cu
    on CUDA tensors); None when the JAX package's tile gate rejects this
    (G, channels) plan."""
    if not _tile_fits(G, aggs, ins):
        return None
    cp = channel_plan(aggs, ins)
    if cp is None:
        return None
    return _agg_blocks(aggs, cp, *_run_calls(cp.calls(gid, live, None, G)))


def maybe_grouped_aggregate_hash(
    page: Page, group_exprs, group_names, aggs: Sequence[AggSpec], pre_mask, mode=None
) -> Optional[Page]:
    """Hash-slot grouped aggregation; None when ineligible (the caller
    takes the sorted strategy). `mode` is "kernel" or "host"; by default
    "kernel" on CUDA and "host" on the CPU."""
    global hash_hits
    if not group_exprs or any(a.func not in _SUPPORTED for a in aggs):
        return None
    if mode is None:
        mode = "kernel" if page.device.type == "cuda" else "host"
    live = _masked_live(page, pre_mask)
    keys = [evaluate(e, page) for e in group_exprs]
    ins = []
    for a in aggs:
        if a.input is None:
            ins.append(None)
            continue
        v = evaluate(a.input, page)
        if v.data.ndim != 1:
            return None
        floating = v.data.is_floating_point()
        if mode != "host" and a.func in ("min", "max") and (
            floating or v.data.element_size() > 4
        ):
            return None  # the JAX kernel's min/max ride int32 channels
        if a.func in ("sum", "avg") and not floating:
            amax = int(torch.where(live, v.data.to(torch.int64).abs(), 0).max())
            if isinstance(a.input.type, T.DecimalType) and amax * page.capacity >= (1 << 61):
                return None  # exact int64 totals, HALF_UP's 2|sum| + cnt included
            if mode != "host" and amax >= _SUM_BOUND:
                return None
        ins.append(v)

    from .hashing import _srl, hash_rows

    tag = torch.clamp(_srl(hash_rows(keys), 32), max=_EMPTY_TAG - 1)
    cap = HASH_MAX_GROUPS_HOST if mode == "host" else HASH_MAX_GROUPS_KERNEL
    # size the table from a sampled NDV estimate, and bail when the estimate
    # is far above the cap (the sorted strategy wins there anyway)
    est = _estimate_ndv(tag, live)
    if est > 2 * cap:
        return None
    max_bits = max(_HASH_START_BITS, int(np.ceil(np.log2(max(cap * 2, 2)))))
    bits = min(max(int(np.ceil(np.log2(max(est * 4, 16)))), 8), max_bits)
    assigned = None
    while assigned is None and bits <= max_bits:
        assigned = _assign_slots(tag, keys, live, bits)
        # resize when the table ran hot (load > 1/2): scans stay short
        if assigned is not None and bits < max_bits and assigned[2].numel() * 2 > (1 << bits):
            assigned = None
        if assigned is None:
            bits += 2
    if assigned is None:
        return None
    slot_of, slot_rep, occupied = assigned
    G = occupied.numel()
    if G == 0 or G > cap:
        return None
    rank = torch.zeros(slot_rep.shape[0], dtype=torch.int64, device=page.device)
    rank[occupied] = torch.arange(G, device=page.device)
    gid = torch.where(live, rank[torch.clamp(slot_of, min=0)], 0).to(torch.int32)
    accumulate = _host_accumulate if mode == "host" else _kernel_accumulate
    agg_blocks = accumulate(gid, live, aggs, ins, G)
    if agg_blocks is None:
        return None
    reps = slot_rep[occupied]
    out_blocks = [
        Block(v.data[reps], v.type, None if v.valid is None else v.valid[reps], v.dict_id)
        for v in keys
    ] + agg_blocks
    hash_hits += 1
    return Page.from_blocks(out_blocks, list(group_names) + [a.name for a in aggs],
                            count=G, device=page.device)
