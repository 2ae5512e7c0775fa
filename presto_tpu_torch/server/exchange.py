"""Pipelined concurrent exchange client for the pull-based HTTP shuffle
(torch counterpart of presto_tpu/server/exchange.py).

Re-designed equivalent of the reference's ExchangeClient +
HttpPageBufferClient (presto-main/.../operator/ExchangeClient.java:55 —
one concurrent HTTP client per upstream task, responses bounded by
`exchange.max-response-size`, pages landing in a bounded buffer the
operator drains).

Shape here:

* one **puller thread per producer location**, each long-polling
  `GET /v1/task/{id}/results/{buffer}/{token}?max_bytes=B` — the worker
  packs as many already-produced pages as fit the `max_response_bytes`
  budget into one response (the `exchange.max-response-size` analog);
* a **bounded staging deque** (bytes-bounded) between pullers and the
  consumer: pullers block when staging is full, which stops their pulls,
  which backpressures the producer's bounded output buffer — end-to-end
  flow control with no unbounded queue anywhere;
* pages are **acknowledged as they are staged** (DELETE up to token),
  freeing producer budget while the consumer is still decoding earlier
  pages — the ack IS the backpressure release;
* **deserialization overlaps the network**: each puller decodes its
  pages (onto the consumer's device) while the others' responses are in
  flight.

Pages decode onto the consuming worker's device (`device`).

Failure semantics match `_pull_buffer`: upstream failures surface as
ExchangeError (a RuntimeError) with the upstream cause in the message (the
coordinator's retry classifier matches on it) and the failing location.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import List, Optional, Sequence, Tuple

from . import knobs
from .serde import DictionaryCache, deserialize_page


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


DEFAULT_MAX_RESPONSE_BYTES = _env_int(
    "PRESTO_TPU_MAX_RESPONSE_BYTES", 8 << 20
)
DEFAULT_STAGING_BYTES = _env_int(
    "PRESTO_TPU_EXCHANGE_STAGING_BYTES", 64 << 20
)
DEFAULT_CONCURRENCY = _env_int("PRESTO_TPU_EXCHANGE_CONCURRENCY", 16)


class ExchangeError(RuntimeError):
    """A pull failed. Carries the failing location so the scheduler can
    attribute the failure (blacklist streaks, query retry)."""

    def __init__(self, message: str, uri: str = "", task_id: str = ""):
        super().__init__(message)
        self.uri = uri
        self.task_id = task_id


class ExchangeStats:
    """Observable pull-side accounting (acceptance: concurrency must be
    visible, not inferred from timing). `peak_concurrent` is the high
    water of simultaneously ALIVE pullers; `peak_inflight` counts
    overlapping HTTP requests."""

    def __init__(self):
        self._lock = threading.Lock()
        self.pages = 0
        self.wire_bytes = 0
        self.responses = 0
        self.pull_s = 0.0
        self.decode_s = 0.0
        self.sources = 0
        self.active = 0
        self.peak_concurrent = 0
        self.inflight = 0
        self.peak_inflight = 0
        self.by_source: dict = {}
        # overlap accounting (hierarchical exchange): `consumer_wait_s`
        # is the wall the consumer spent BLOCKED on an empty staging
        # deque — wire time the prefetch failed to hide. pull_s minus it
        # is the wire wall hidden behind the consumer's device compute.
        self.consumer_wait_s = 0.0

    def add_sources(self, n: int) -> None:
        """Locked source-count bump: one stats object may span several
        clients (a task with many sources), whose __init__ runs on task
        threads while the scheduler snapshots — the += must not tear."""
        with self._lock:
            self.sources += int(n)

    def consumer_waited(self, seconds: float) -> None:
        with self._lock:
            self.consumer_wait_s += seconds

    def puller_started(self) -> None:
        with self._lock:
            self.active += 1
            self.peak_concurrent = max(self.peak_concurrent, self.active)

    def puller_finished(self) -> None:
        with self._lock:
            self.active -= 1

    def request_started(self) -> None:
        with self._lock:
            self.inflight += 1
            self.peak_inflight = max(self.peak_inflight, self.inflight)

    def request_finished(self, seconds: float) -> None:
        with self._lock:
            self.inflight -= 1
            self.responses += 1
            self.pull_s += seconds

    def pages_staged(self, source: str, count: int, nbytes: int) -> None:
        with self._lock:
            self.pages += count
            self.wire_bytes += nbytes
            self.by_source[source] = self.by_source.get(source, 0) + count

    def page_decoded(self, seconds: float) -> None:
        with self._lock:
            self.decode_s += seconds

    def snapshot(self) -> dict:
        """One consistent snapshot under the stats lock: the scheduler
        and the worker status endpoint read this while pullers mutate
        counters, so every field (including the derived overlap numbers)
        comes from a single locked read — pages always equals the
        by_source sum, hidden_ms is never computed from a torn pair."""
        with self._lock:
            pull_ms = round(self.pull_s * 1e3, 2)
            wait_ms = round(self.consumer_wait_s * 1e3, 2)
            hidden_ms = round(max(pull_ms - wait_ms, 0.0), 2)
            return {
                "pages": self.pages,
                "wire_bytes": self.wire_bytes,
                "responses": self.responses,
                "sources": self.sources,
                "peak_concurrent": self.peak_concurrent,
                "peak_inflight": self.peak_inflight,
                "pull_ms": pull_ms,
                "decode_ms": round(self.decode_s * 1e3, 2),
                "consumer_wait_ms": wait_ms,
                "hidden_ms": hidden_ms,
                "overlap_frac": round(hidden_ms / pull_ms, 3)
                if pull_ms > 0 else 0.0,
                "by_source": dict(self.by_source),
            }


def fetch_pages(
    uri: str,
    task_id: str,
    buffer_id: int,
    token: int,
    max_bytes: Optional[int] = None,
    timeout: float = 300.0,
) -> Tuple[List[bytes], bool, bool]:
    """One results request: (pages, complete, ready). ready=False means
    the producer has nothing at `token` yet (HTTP 503 long-poll miss).
    Raises RuntimeError with the upstream cause on failure — the message
    shapes the coordinator's retryable/fatal classification."""
    url = f"{uri}/v1/task/{task_id}/results/{buffer_id}/{token}"
    if max_bytes:
        url += f"?max_bytes={int(max_bytes)}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            payload = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code == 503:
            return [], False, False
        # surface the UPSTREAM failure cause (e.g. a low-memory kill),
        # not a bare HTTP 500 — the coordinator matches on the message
        # (reference: HttpPageBufferClient propagates the task error)
        try:
            detail = json.loads(e.read()).get("error") or str(e)
        except (ValueError, AttributeError, OSError):
            # no JSON body: the ExchangeError below carries the failure
            detail = str(e)
        raise ExchangeError(
            f"upstream task {task_id} on {uri} results fetch "
            f"failed: {detail}",
            uri=uri, task_id=task_id,
        ) from None
    except (urllib.error.URLError, ConnectionError, OSError) as e:
        # a worker dying mid-stream must surface as a RETRYABLE
        # RuntimeError (the query-level retry contract), never as a
        # raw URLError that escapes the scheduler's retry handler
        raise ExchangeError(
            f"upstream task {task_id} on {uri} connection lost "
            f"mid-stream: {e}",
            uri=uri, task_id=task_id,
        ) from None
    if payload.get("pages") is not None:
        pages = [base64.b64decode(p) for p in payload["pages"]]
    elif payload.get("page"):
        pages = [base64.b64decode(payload["page"])]
    else:
        pages = []
    # an old worker answers without "pages"; an empty single-page answer
    # with complete unset means long-poll timed out server-side
    ready = bool(pages) or bool(payload.get("complete", not pages))
    return pages, bool(payload.get("complete", not pages)), ready


def ack_pages(uri: str, task_id: str, buffer_id: int, upto_token: int) -> None:
    """Acknowledge pages [0, upto_token) — frees the producer's bounded
    buffer budget. Advisory: a lost ack only delays the free (the task's
    DELETE at query end frees everything), so a failed request is let go."""
    try:
        req = urllib.request.Request(
            f"{uri}/v1/task/{task_id}/results/{buffer_id}/{upto_token}",
            method="DELETE",
        )
        urllib.request.urlopen(req, timeout=5).read()
    except OSError:  # URLError and HTTPError are OSErrors
        pass


def _page_nbytes(page) -> int:
    """Decoded footprint of a Page: every array a Block carries."""
    total = 0
    stack = list(getattr(page, "blocks", ()))
    while stack:
        b = stack.pop()
        for arr in (b.data, b.valid, b.lengths, b.elem_valid):
            if arr is not None:
                total += arr.numel() * arr.element_size()
        if b.key_block is not None:
            stack.append(b.key_block)
    return total


class ExchangeClient:
    """Concurrent pull over a set of producer buffer locations.

    `locations` is a sequence of (uri, task_id, buffer_id). `pages()`
    yields deserialized Pages, on `device`, in ARRIVAL order — per-location token order
    is preserved, interleaving across locations is whatever the network
    delivers (exchange consumers are order-insensitive across producers,
    exactly like the reference's ExchangeOperator)."""

    def __init__(
        self,
        locations: Sequence[Tuple[str, str, int]],
        ack: bool = True,
        max_response_bytes: Optional[int] = None,
        staging_bytes: Optional[int] = None,
        deadline: Optional[float] = None,
        concurrency: Optional[int] = None,
        stats: Optional[ExchangeStats] = None,
        device="cuda",
    ):
        self.locations = list(locations)
        self.ack = ack
        self.max_response_bytes = (
            DEFAULT_MAX_RESPONSE_BYTES
            if max_response_bytes is None
            else max_response_bytes
        )
        self.staging_bytes = (
            DEFAULT_STAGING_BYTES if staging_bytes is None else staging_bytes
        )
        # hierarchical-exchange tranche prefetch: guarantee each puller
        # can keep PRESTO_TPU_HIER_EXCHANGE_PREFETCH max-size responses
        # staged ahead of the consumer, so the next inter-host tranche
        # is on the wire while the current one's device-side collective
        # runs — the staging budget is a floor here, never a shrink
        prefetch = max(knobs.hier_exchange_prefetch(), 0)
        if prefetch:
            self.staging_bytes = max(
                self.staging_bytes,
                prefetch * self.max_response_bytes * max(len(self.locations), 1),
            )
        if deadline is None:
            deadline = knobs.task_deadline_s()
        self.deadline = deadline
        self.concurrency = max(
            1, DEFAULT_CONCURRENCY if concurrency is None else concurrency
        )
        self.stats = stats or ExchangeStats()
        self.stats.add_sources(len(self.locations))
        self.device = device
        # one receive-side dictionary cache per location: a producer that
        # negotiated `dict_cache` ships a dictionary once per buffer, and
        # each location's pages decode in token order on its puller thread
        # (numpy and stripe decompression release the GIL, so decoding
        # overlaps the pulls and the consumer)
        self._caches = [DictionaryCache() for _ in self.locations]
        self._cond = threading.Condition()
        self._staged: deque = deque()  # (loc_index, bytes)
        self._staged_bytes = 0
        self._done = 0
        self._error: Optional[ExchangeError] = None
        self._stop = threading.Event()
        self._sem = threading.Semaphore(self.concurrency)
        self._threads: List[threading.Thread] = []
        self._started = False

    # -- pull side --

    def _stage(self, idx: int, pages: List[bytes]) -> None:
        # page-at-a-time: decode (outside the lock), then admit against
        # the staging budget accounted at DECODED size — the light-weight
        # encodings routinely achieve 5-50x ratios, so bounding by wire
        # bytes while holding decoded Pages would amplify the bound by
        # the compression ratio. A blocked puller holds at most the one
        # page it just decoded.
        for p in pages:
            t0 = time.perf_counter()
            dec = deserialize_page(p, cache=self._caches[idx], device=self.device)
            self.stats.page_decoded(time.perf_counter() - t0)
            nbytes = max(len(p), _page_nbytes(dec))
            with self._cond:
                # bounded staging: block while full (unless empty — one
                # page must always be admissible or nothing moves)
                while (
                    self._staged_bytes + nbytes > self.staging_bytes
                    and self._staged
                    and not self._stop.is_set()
                ):
                    self._cond.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                self._staged.append((dec, nbytes))
                self._staged_bytes += nbytes
                self._cond.notify_all()
        uri, task, _buf = self.locations[idx]
        self.stats.pages_staged(
            f"{uri}/{task}", len(pages), sum(len(p) for p in pages)
        )

    def _pull_one(self, idx: int) -> None:
        uri, task, buf = self.locations[idx]
        token = 0
        give_up = time.time() + self.deadline
        while not self._stop.is_set():
            t0 = time.perf_counter()
            self.stats.request_started()
            try:
                pages, complete, ready = fetch_pages(
                    uri, task, buf, token,
                    max_bytes=self.max_response_bytes,
                )
            finally:
                self.stats.request_finished(time.perf_counter() - t0)
            if pages:
                token += len(pages)
                self._stage(idx, pages)
                # ack AFTER staging admitted the bytes: the bounded
                # staging deque is the consumer-side half of the
                # backpressure loop, the ack releases the producer half
                if self.ack:
                    ack_pages(uri, task, buf, token)
                give_up = time.time() + self.deadline  # progress
            if complete:
                return
            if not ready and not pages:
                # `deadline` caps the wall time between PAGES (a progress
                # deadline): a wedged producer (RUNNING forever,
                # producing nothing) must fail the pull — retryably —
                # instead of hanging its consumer forever
                if time.time() >= give_up:
                    raise ExchangeError(
                        f"upstream task {task} on {uri} produced no page "
                        f"within the {self.deadline:.0f}s task deadline "
                        "(wedged worker?)",
                        uri=uri, task_id=task,
                    )

    def _run_puller(self, idx: int) -> None:
        with self._sem:  # bound total concurrent pullers
            self.stats.puller_started()
            try:
                self._pull_one(idx)
            except ExchangeError as e:
                with self._cond:
                    if self._error is None:
                        self._error = e
                    self._cond.notify_all()
            except Exception as e:  # noqa: BLE001 - never die silently
                uri, task, _b = self.locations[idx]
                with self._cond:
                    if self._error is None:
                        self._error = ExchangeError(
                            f"upstream task {task} on {uri} pull failed: "
                            f"{e!r}",
                            uri=uri, task_id=task,
                        )
                    self._cond.notify_all()
            finally:
                self.stats.puller_finished()
                with self._cond:
                    self._done += 1
                    self._cond.notify_all()

    def start(self) -> "ExchangeClient":
        if self._started:
            return self
        self._started = True
        for i in range(len(self.locations)):
            t = threading.Thread(
                target=self._run_puller, args=(i,), daemon=True,
                name=f"ptpu-pull-{i}",
            )
            self._threads.append(t)
            t.start()
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()

    # -- consume side --

    def pages(self):
        """Yield the decoded Pages in arrival order. Raises the first
        puller failure once staged pages drain — pages already pulled are
        still delivered (acked)."""
        self.start()
        try:
            while True:
                with self._cond:
                    # time the consumer spends HERE with an empty deque
                    # is wire latency the prefetch failed to hide; time
                    # between two pages is the consumer's device
                    # compute, which the pullers' in-flight tranches
                    # overlap. pull_s - consumer_wait_s = hidden wall.
                    waited = time.perf_counter()
                    while (
                        not self._staged
                        and self._error is None
                        and self._done < len(self.locations)
                    ):
                        self._cond.wait(timeout=0.5)
                    waited = time.perf_counter() - waited
                    if self._staged:
                        dec, nbytes = self._staged.popleft()
                        self._staged_bytes -= nbytes
                        self._cond.notify_all()
                    elif self._error is not None:
                        self.stats.consumer_waited(waited)
                        raise self._error
                    else:
                        self.stats.consumer_waited(waited)
                        return
                self.stats.consumer_waited(waited)
                yield dec
        finally:
            self.close()
