"""The single parse site of the port's PRESTO_TPU_* server knobs (torch
counterpart of presto_tpu/server/knobs.py).

Ported so far: `feedback_enabled`, the switch of history-based feedback
(plan/history.py). The JAX package's replan knobs belong to its
coordinator (ROADMAP queue 1 item 9).

Knobs are read per call, not cached at import: tests and harnesses set
and restore the environment around single runs."""

from __future__ import annotations

import os


def feedback_enabled() -> bool:
    """Master switch for history-based feedback (plan/history.py): record
    observed per-plan-node row counts at query end and feed them back into
    join ordering, hybrid-join sizing and the matview delta decision. Off
    by default; PRESTO_TPU_FEEDBACK=1 turns it on."""
    return os.environ.get("PRESTO_TPU_FEEDBACK", "0") not in ("0", "false", "")
