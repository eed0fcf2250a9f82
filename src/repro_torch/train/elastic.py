"""Failure handling and elasticity at the launcher level: the counterpart
of ``repro/train/elastic.py``.

A data-parallel run is a fixed group of processes, so node failure,
stragglers and preemption are handled by checkpoint-and-reconfigure:

  * ``StragglerDetector``: EWMA step-time z-score; a persistent straggler
    triggers a checkpoint and a restart on fewer ranks rather than
    letting one slow rank gate every collective.
  * ``PreemptionGuard``: SIGTERM flips a flag; the loop checkpoints and
    exits cleanly at the next step boundary.
  * ``run_resumable``: retry wrapper; on failure it restores the latest
    complete checkpoint (resliced for the current ranks by
    ``checkpoint.restore_resharded``) and continues.  The stateless data
    pipeline replays the batches exactly.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, Optional


class MeshDegraded(RuntimeError):
    """A request, raised inside ``run``, to restore the latest checkpoint
    and run again without using the restart budget: ``run_resumable``
    catches it.  The port's launcher does not raise it: a process group
    cannot shrink in-process, so its degrade checkpoints, exits with
    ``launch.train.EXIT_DEGRADE`` and is relaunched on half the ranks by
    its ``--devices`` spawner."""


class NodeLoss(RuntimeError):
    """A peer PROCESS died mid-run.

    Unlike :class:`MeshDegraded`, node loss is unrecoverable in-process:
    once a peer is gone the process group cannot re-form from inside the
    survivors (collectives against the dead peer hang or fail).
    ``run_resumable`` therefore RE-RAISES NodeLoss instead of retrying:
    the process exits non-zero, the job manager relaunches the survivors
    with ``--num-processes`` = the surviving count, and ``restore_latest``
    resumes from the last complete manifest (validated across processes
    by ``checkpoint.restore_resharded``)."""


#: substrings that mark a runtime error as a *distributed* failure, a dead
#: or unreachable peer, rather than a local bug; matched case-insensitively
_DISTRIBUTED_TOKENS = ("deadline", "barrier", "heartbeat", "connection",
                       "unavailable", "peer", "broken pipe", "timed out",
                       "timeout", "gloo", "nccl", "socket", "unreachable")

#: exception type names that can carry a distributed failure: torch's
#: ``DistError`` family (``DistBackendError`` for NCCL and gloo errors,
#: ``DistNetworkError``, ``DistStoreError``) is always one; the others only
#: when their message names a peer, a connection or a timeout
_DIST_TYPES = ("DistError", "DistBackendError", "DistNetworkError",
               "DistStoreError")
_GENERIC_TYPES = ("RuntimeError", "TimeoutError", "ConnectionError",
                  "ConnectionResetError", "ConnectionRefusedError",
                  "BrokenPipeError")


def is_distributed_failure(exc: BaseException) -> bool:
    """True when ``exc`` looks like a lost or unreachable peer process.

    Name-based, not isinstance, as in the reference: backends surface
    errors under several types.  Tokens are deliberately broad:
    misclassifying a local bug as NodeLoss costs one relaunch;
    misclassifying a dead peer as local makes ``run_resumable`` retry
    into a hang against a ghost."""
    names = {t.__name__ for t in type(exc).__mro__}
    if names & set(_DIST_TYPES):
        return True
    if type(exc).__name__ not in _GENERIC_TYPES:
        return False
    msg = str(exc).lower()
    return any(tok in msg for tok in _DISTRIBUTED_TOKENS)


class StragglerDetector:
    """Flags steps whose duration deviates from the EWMA by > z_thresh
    sigma.  A flagged rank => checkpoint-and-reconfigure."""

    def __init__(self, alpha: float = 0.1, z_thresh: float = 4.0,
                 warmup: int = 5):
        self.alpha = alpha
        self.z = z_thresh
        self.warmup = warmup
        self.mean = None
        self.var = 0.0
        self.n = 0           # deviation samples seen (excludes the baseline)
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            # the baseline seeds the EWMA and is not a deviation sample:
            # it does not count toward the warmup
            self.mean = dt
            return False
        self.n += 1
        delta = dt - self.mean
        # sigma floor: 1% of the mean, so perfectly steady step times
        # (var -> 0) still flag an obvious outlier instead of dividing by 0
        sigma = max(self.var ** 0.5, 0.01 * abs(self.mean), 1e-9)
        is_straggler = self.n > self.warmup and delta / sigma > self.z
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        if is_straggler:
            self.flagged += 1
        return is_straggler


class PreemptionGuard:
    """SIGTERM -> graceful checkpoint at the next step boundary."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not the main thread (tests)

    def _handler(self, signum, frame):
        self.requested = True

    def request(self):  # testable without a real signal
        self.requested = True


def run_resumable(make_state: Callable[[], object],
                  run: Callable[[object, int], object],
                  restore_latest: Callable[[], Optional[tuple]],
                  max_restarts: int = 3):
    """Generic retry-with-restore driver.

    make_state() -> fresh state; restore_latest() -> (state, step) or None;
    run(state, start_step) raises on failure, returns the final state on
    success.

    A ``restore_latest`` raising FileNotFoundError (no checkpoint yet)
    falls back to a fresh state: a crash before the first checkpoint is
    still retried.  Any other restore error (layout mismatch, corrupt
    leaves) propagates: starting fresh would overwrite the checkpoints it
    failed to read.

    ``MeshDegraded`` is a deliberate checkpoint-and-reconfigure request and
    restores without consuming the restart budget; ``NodeLoss`` propagates
    at once (the relaunch with fewer processes happens outside this
    process).
    """
    attempts = 0
    while True:
        try:
            restored = restore_latest()
        except FileNotFoundError:
            restored = None
        if restored is not None:
            state, start = restored
        else:
            state, start = make_state(), 0
        try:
            return run(state, start)
        except MeshDegraded:
            continue
        except NodeLoss:
            raise
        except Exception:
            attempts += 1
            if attempts > max_restarts:
                raise
            time.sleep(0.1)
