"""The result cache's third verdict: PATCH a stale entry in place (torch
counterpart of presto_tpu/matview/patch.py).

A result-cache entry whose plan classifies as delta-patchable need not be
evicted when its base tables advance: the rows appended since the entry's
recorded tokens run through the view's core plan and merge into the
cached page. Consistency rule (shared with ResultCache.preversions): read
the version vector FIRST, the delta tokens SECOND, then the data, so a
racing writer can only make the patched entry FRESHER than the versions
it claims, never staler; the next lookup validates again and patches
again or invalidates.

patch_entry returns None (the caller invalidates) exactly where patching
does not apply: no tokens, a plan that does not classify, a rewrite
(nonappend version moved, or no row in the range while the versions
moved: a rewrite that raced the token read), a receding cursor (drop and
re-create), a connector's DeltaUnavailable, or a delta past
DELTA_MAX_FRAC of the base rows. Any other fault propagates: the JAX
package swallows every exception here and invalidates, which hides a
broken delta pipeline behind recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..connectors.spi import DeltaUnavailable
from ..exec import qcache
from ..exec.stats import page_device_bytes
from ..page import Page
from ..plan import nodes as N
from . import maintenance


def patch_entry(plan, ent, catalog) -> Optional[object]:
    """A fresh ResultEntry built by patching `ent` with the deltas between
    ent.tokens and the current snapshot, on the cached page's device, or
    None where patching does not apply (the caller invalidates)."""
    if not maintenance.PATCH_ENABLED:
        return None
    if ent.tokens is None or not isinstance(plan, N.Output):
        return None
    mplan, _reason = maintenance.classify(plan)
    if mplan is None or mplan.tables != ent.tables:
        return None
    scan_delta = getattr(catalog, "scan_delta", None)
    if scan_delta is None:
        return None
    versions = qcache.table_versions(catalog, ent.tables)
    if versions is None:
        return None
    new_tokens = qcache.delta_tokens(catalog, ent.tables)
    if new_tokens is None:
        return None

    deltas = {}
    total_delta = 0
    base_rows = 0
    for tb, old_tok, new_tok in zip(ent.tables, ent.tokens, new_tokens):
        # token = (high_seq, data_version, nonappend_version). A nonappend
        # bump means rows were rewritten or removed, which a delta cannot
        # express; a receding high_seq means the table was dropped and
        # re-created.
        if new_tok[2] != old_tok[2] or new_tok[0] < old_tok[0]:
            return None
        try:
            delta = scan_delta(tb, old_tok[0], new_tok[0])
        except DeltaUnavailable:
            return None
        deltas[tb] = delta
        total_delta += int(delta.count)
        base_rows += int(catalog.row_count(tb))
    if not total_delta:
        return None  # versions moved with no row in the range: a rewrite raced
    if base_rows and total_delta > maintenance.DELTA_MAX_FRAC * base_rows:
        return None

    # cached pages are title-named (Output renamed them); the merge runs
    # on channel names. The rename is positional both ways, as Output's.
    device = ent.page.device
    old = Page.from_blocks(list(ent.page.blocks), list(plan.channels), count=ent.page.count)
    merged, _rows = maintenance.patch_pages(catalog, mplan, old, deltas, device)
    new_page = Page.from_blocks(list(merged.blocks), list(plan.titles), count=merged.count)
    return dataclasses.replace(ent, page=new_page, versions=versions, tokens=new_tokens,
                               nbytes=page_device_bytes(new_page))
