"""The weight-plane: a versioned, double-buffered trainer->pool parameter
transfer service, the port of ``src/repro/transfer/service.py`` for one
card (no placement specs: every leaf stays on the trainer's device).

:class:`VersionedParamStore` — per-instance double buffer. Readers take an
ATOMIC ``(params, version)`` snapshot. Writers stage bucket deliveries for a
new version into the back buffer and flip front<->back only once EVERY
bucket of that version has landed — a partially-transferred tree is never
observable.

:class:`WeightTransferService` — drives a pool of stores from a
:class:`~repro_torch.transfer.plan.TransferPlan`. The trainer publishes at
the iteration boundary; with overlap the bucket stream runs on a
background thread from the moment the optimizer update has been issued, so
its time hides under the trainer's iteration tail. ``ensure`` is the
boundary barrier: it blocks until every instance has flipped to the
published version and reports the residual block time — the pool's
sync-gap.

Why overlap cannot break Proposition 1: rollouts are version-GATED. A
generation request for iteration *i* carries ``min_version=i`` and blocks
until the store's active buffer holds version *i*; the flip is atomic; and
in strict modes the scheduler's boundary ``ensure`` runs after the queue
drain, so no request is in flight while a flip lands (the paged engine also
refuses a weight swap while decoding).

The trainer and the stream thread issue their work on the device's default
stream, so a bucket's cast is ordered after the update that produced its
leaves; the stream thread waits for each bucket's tensors (a stream
synchronize) before delivering it, the port's ``jax.block_until_ready``.
A paged engine decodes on the card's engine stream: its flip hook
(``PagedGroupEngine.set_params``) orders its copy of a landed tree after
the flipping thread's stream with an event, marks the landed leaves as used
by its stream (``record_stream``) so the memory the store frees after the
flip is not reused before the copy has run, and makes the flipping thread's
stream wait for the copy.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

from repro_torch.transfer.plan import (TransferPlan, build_plan,
                                       flatten_with_keys, pack_bucket,
                                       unflatten, unpack_bucket)


def _settle(tensors) -> None:
    """Wait until the device has written ``tensors`` (CPU tensors: done):
    a host synchronize of the calling thread's current stream, the one
    that wrote them. It orders nothing on other streams (the paged
    engines' stream runs on); the engine's reads of the landed tree are ordered by
    its own event wait at the flip."""
    devices = {t.device for t in tensors if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


class VersionedParamStore:
    """Double-buffered (params, version) pair with staged bucket delivery."""

    def __init__(self, name: str = "store", on_flip=None,
                 defer_flip: bool = False):
        self.name = name
        # hook run under the flip lock with the NEW params (the paged
        # engine's set_params, which refuses a swap while decoding); it
        # returns the tree the instance decodes with, which the store
        # holds in place of the landed one (the weights stay resident once)
        self.on_flip = on_flip
        # True when background flips are unsafe (paged engines need
        # quiescence): the buffer stays staged and the boundary ``ensure``
        # flips it after the queue drain
        self.defer_flip = defer_flip
        self._cv = threading.Condition()
        self._params = None
        self._version = -1
        self._staging: Optional[dict] = None
        self._failed: Optional[BaseException] = None
        self.flips = 0

    # -- reader side --------------------------------------------------------
    @property
    def version(self) -> int:
        with self._cv:
            return self._version

    def snapshot(self) -> tuple:
        """Atomic (params, version) — the pair always belongs together."""
        with self._cv:
            return self._params, self._version

    def wait_version(self, min_version: Optional[int],
                     timeout: Optional[float] = None) -> tuple:
        """Atomic snapshot gated on ``version >= min_version``. A failed
        bucket stream poisons the gate (``fail``): gated requests raise
        instead of waiting forever."""
        with self._cv:
            if min_version is not None:
                ok = self._cv.wait_for(
                    lambda: (self._version >= min_version
                             or self._failed is not None), timeout=timeout)
                if not ok:
                    raise TimeoutError(
                        f"{self.name}: version {min_version} not published "
                        f"within {timeout}s (at {self._version})")
                if self._version < min_version:
                    raise RuntimeError(
                        f"{self.name}: weight stream failed before version "
                        f"{min_version} landed") from self._failed
            return self._params, self._version

    def fail(self, exc: BaseException) -> None:
        """Poison the gate after a stream failure: wake every gated reader
        with the error. Cleared by the next successful flip."""
        with self._cv:
            self._failed = exc
            self._cv.notify_all()

    # -- writer side --------------------------------------------------------
    def install(self, params, version: int) -> None:
        """Eager whole-tree path: publish the tree and flip in one atomic
        step (the tree is held as it is; nothing updates it in place)."""
        with self._cv:
            self._publish_locked(params, version)

    def begin(self, version: int, plan: TransferPlan) -> None:
        """Open the back buffer for ``version``'s bucket stream."""
        with self._cv:
            assert version > self._version, \
                f"{self.name}: stale publish {version} (at {self._version})"
            self._staging = {
                "version": version, "plan": plan,
                "slots": [None] * len(plan.leaves),
                "remaining": {b.bid for b in plan.buckets},
            }

    def deliver(self, bucket, placed) -> bool:
        """Land one bucket ([(leaf index, tensor)]) in the back buffer.
        Returns True when the version's LAST bucket landed."""
        with self._cv:
            st = self._staging
            assert st is not None, f"{self.name}: deliver without begin"
            assert bucket.bid in st["remaining"], \
                f"{self.name}: bucket {bucket.bid} delivered twice"
            for i, arr in placed:
                st["slots"][i] = arr
            st["remaining"].discard(bucket.bid)
            return not st["remaining"]

    @property
    def staged_version(self) -> Optional[int]:
        """Version whose buckets have ALL landed but not yet flipped."""
        with self._cv:
            st = self._staging
            return (st["version"]
                    if st is not None and not st["remaining"] else None)

    def staged_params(self):
        """The fully landed, not yet flipped tree (None if there is none)."""
        with self._cv:
            st = self._staging
            if st is None or st["remaining"]:
                return None
            return unflatten(st["plan"].keys, st["slots"])

    def flip(self) -> int:
        """front <- back: atomically publish the fully-landed version."""
        with self._cv:
            st = self._staging
            assert st is not None and not st["remaining"], \
                f"{self.name}: flip before all buckets landed"
            params = unflatten(st["plan"].keys, st["slots"])
            self._staging = None
            return self._publish_locked(params, st["version"])

    def _publish_locked(self, params, version: int) -> int:
        if self.on_flip is not None:
            params = self.on_flip(params)
        self._params = params
        self._version = version
        self._failed = None
        self.flips += 1
        self._cv.notify_all()
        return version


class WeightTransferService:  # repro: allow(lock-discipline): single in-flight publisher thread; _join_pending's Thread.join is the happens-before edge for every shared field
    """Streams versioned parameter buckets from the trainer to every
    instance store, with optional overlap (background streaming) and a
    boundary barrier that measures the pool's residual sync-gap."""

    def __init__(self, instances, *, bucket_bytes: int = 1 << 22,
                 wire_dtype: Optional[str] = None, overlap: bool = True):
        self.instances: List = getattr(instances, "instances", instances)
        self.bucket_bytes = bucket_bytes
        self.wire_dtype = wire_dtype or None
        self.overlap = overlap
        self.plan: Optional[TransferPlan] = None
        self._pending_version: Optional[int] = None
        self._pending_thread: Optional[threading.Thread] = None
        self._pending_error: Optional[BaseException] = None
        self.bytes_streamed = 0
        self.buckets_streamed = 0
        self.publishes: List[dict] = []
        self.gaps: List[dict] = []

    # ------------------------------------------------------------------
    def _ensure_plan(self, params) -> TransferPlan:
        if self.plan is None:
            self.plan = build_plan(params, bucket_bytes=self.bucket_bytes,
                                   wire_dtype=self.wire_dtype)
        return self.plan

    def _stream(self, params, version: int) -> None:
        """Pack and deliver every bucket to every store, flipping each
        store as its last bucket lands — except deferred (paged) stores,
        which stay staged until the boundary ``ensure``. A failure poisons
        every store's version gate."""
        stores = [inst.store for inst in self.instances]
        try:
            plan = self._ensure_plan(params)
            leaves = flatten_with_keys(params)[1]            # plan order
            for store in stores:
                store.begin(version, plan)
            t0 = time.perf_counter()
            for bucket in plan.buckets:
                wire = pack_bucket(plan, leaves, bucket)
                # a version must not publish before its buckets land
                _settle(wire)
                placed = unpack_bucket(plan, bucket, wire)
                _settle([x for _, x in placed])
                for store in stores:
                    if store.deliver(bucket, placed) and not store.defer_flip:
                        store.flip()
                self.bytes_streamed += bucket.wire_bytes
                self.buckets_streamed += 1
        except BaseException as exc:
            for store in stores:
                store.fail(exc)
            raise
        self.publishes.append({
            "version": version, "buckets": len(plan.buckets),
            "wire_bytes": plan.total_wire_bytes,
            "stream_wall": time.perf_counter() - t0})

    # ------------------------------------------------------------------
    def publish(self, params, version: int) -> None:
        """Blocking eager publish: stream every bucket and flip every
        store before returning (the overlap-off / first-iteration path).
        Caller guarantees paged engines are quiescent (queue drained)."""
        self._join_pending()
        self._stream(params, version)
        for inst in self.instances:
            if inst.store.version < version:
                inst.store.flip()

    def publish_async(self, params, version: int) -> None:
        """Overlap path: start the bucket stream on a background thread and
        return at once. Deferred (paged) stores stay staged for the
        boundary ``ensure``."""
        if not self.overlap:
            return      # boundary ensure() will publish eagerly
        self._join_pending()
        self._pending_version = version
        self._pending_error = None

        def run():
            try:
                self._stream(params, version)
            except BaseException as exc:        # surfaced by ensure()
                self._pending_error = exc

        self._pending_thread = threading.Thread(
            target=run, name=f"weight-plane-v{version}", daemon=True)
        self._pending_thread.start()

    def _join_pending(self) -> None:
        if self._pending_thread is not None:
            self._pending_thread.join()
            self._pending_thread = None
            if self._pending_error is not None:
                err, self._pending_error = self._pending_error, None
                self._pending_version = None
                raise RuntimeError(
                    "weight-plane background stream failed") from err

    # ------------------------------------------------------------------
    def ensure(self, params, version: int) -> int:
        """Boundary barrier: make every store hold exactly ``version`` and
        record the time this call blocked — the pool's sync-gap. Returns
        the version the stores are OBSERVED to hold, so the caller's
        ``refresh_old(expected_rollout_version=...)`` compares the pool's
        actual state against the policy's."""
        t0 = time.perf_counter()
        versions = [inst.store.version for inst in self.instances]
        if all(v == version for v in versions):
            self.gaps.append({"version": version, "gap": 0.0, "mode": "noop"})
            return versions[0]
        if self._pending_version == version:
            self._join_pending()
            self._pending_version = None
            mode = "overlap"
        else:
            self.publish(params, version)
            mode = "eager"
        for inst in self.instances:
            if inst.store.staged_version == version:
                inst.store.flip()
        versions = [inst.store.version for inst in self.instances]
        assert all(v == version for v in versions), \
            f"weight-plane flip incomplete: stores at {versions}, " \
            f"boundary requires {version}"
        self.gaps.append({"version": version, "gap": time.perf_counter() - t0,
                          "mode": mode})
        return versions[0]

    def drain(self) -> None:
        """Join any in-flight background bucket stream (flips stay with
        ``ensure``); surfaces a failed stream's error."""
        self._join_pending()

    # ------------------------------------------------------------------
    @property
    def last_gap(self) -> float:
        return self.gaps[-1]["gap"] if self.gaps else 0.0
