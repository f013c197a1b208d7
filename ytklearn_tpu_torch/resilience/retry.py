"""Retry with backoff: the one transient-fault primitive of the port
(``ytklearn_tpu/resilience/retry.py``).

  - typed classification: `is_transient` retries plain OSErrors (EIO,
    connection resets, timeouts) and EOFError, never the fatal shapes
    (FileNotFoundError and its kin, where a retry only delays the answer)
    and never non-IO errors
  - exponential backoff with deterministic jitter: the delay before retry
    k+1 is `min(max_s, base_s * 2^(k-1))` scaled into [0.5, 1.0) by a
    counter hash of (site, k), the JAX package's delays to the bit
  - evidence: the counters `io.retry.attempts`, `io.retry.<site>`,
    `io.retry.recovered` and `io.retry.giveup`, and a log line each
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional, TypeVar

from ..config import knobs
from . import inc
from .chaos import ChaosError, site_draw

log = logging.getLogger("ytklearn_tpu_torch.resilience")

T = TypeVar("T")

_JITTER_SEED = 0x5EED  # fixed: the jitter reproduces across runs

#: OSError shapes where a retry can only give the same answer later
_FATAL_OS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
    FileExistsError,
)


def is_transient(exc: BaseException) -> bool:
    """OSError (with ConnectionError, TimeoutError, InterruptedError) and
    EOFError, less the fatal OSError shapes; ChaosError (kind=error) is
    fatal by construction."""
    if isinstance(exc, ChaosError):
        return False
    if isinstance(exc, _FATAL_OS):
        return False
    return isinstance(exc, (OSError, EOFError))


@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0

    @classmethod
    def from_knobs(cls) -> "RetryPolicy":
        return cls(
            max_attempts=max(int(knobs.get_int("YTK_RETRY_MAX")), 1),
            base_s=max(float(knobs.get_float("YTK_RETRY_BASE_S")), 0.0),
            max_s=max(float(knobs.get_float("YTK_RETRY_MAX_S")), 0.0),
        )

    def delay_s(self, attempt: int, site: str) -> float:
        """Backoff before retry `attempt + 1` (attempt is 1-based): capped
        exponential, jittered into [0.5, 1.0)x."""
        raw = min(self.max_s, self.base_s * self.multiplier ** (attempt - 1))
        return raw * (0.5 + 0.5 * site_draw(_JITTER_SEED, site, attempt))


def _backoff_or_reraise(e: BaseException, attempt: int, policy: RetryPolicy,
                        site: str,
                        classify: Callable[[BaseException], bool],
                        context: str = "") -> None:
    """The one classify/budget/evidence/backoff block of retry_call and
    retry_lines. Called inside an except handler: re-raises a fatal
    exception or a spent budget, else counts the attempt and sleeps the
    jittered backoff."""
    if not classify(e):
        raise
    if attempt >= policy.max_attempts:
        inc("io.retry.giveup")
        log.error("retry[%s]: giving up after %d attempts: %s: %s",
                  site, attempt, type(e).__name__, e)
        raise
    delay = policy.delay_s(attempt, site)
    inc("io.retry.attempts")
    inc(f"io.retry.{site}")
    log.warning("retry[%s]: attempt %d/%d failed%s (%s: %s); backing off "
                "%.3fs", site, attempt, policy.max_attempts, context,
                type(e).__name__, e, delay)
    time.sleep(delay)


def _record_recovered(site: str, attempt: int) -> None:
    inc("io.retry.recovered")
    log.info("retry[%s]: recovered on attempt %d", site, attempt)


def retry_call(fn: Callable[[], T], site: str,
               policy: Optional[RetryPolicy] = None,
               classify: Callable[[BaseException], bool] = is_transient) -> T:
    """`fn()` with transient-fault retries. `site` names the seam in the
    counters (a FAULT_SITES name, so the chaos site and its retries line
    up). A fatal exception propagates at its first throw, a transient one
    after the attempt budget."""
    policy = policy or RetryPolicy.from_knobs()
    attempt = 0
    while True:
        attempt += 1
        try:
            out = fn()
        except Exception as e:
            _backoff_or_reraise(e, attempt, policy, site, classify)
            continue
        if attempt > 1:
            _record_recovered(site, attempt)
        return out


def retry_lines(open_fn: Callable[[], object], site: str,
                policy: Optional[RetryPolicy] = None,
                classify: Callable[[BaseException], bool] = is_transient):
    """Lines of a re-openable source with transient-fault retries, one line
    held at a time: after a transient failure mid-read the source is
    reopened and the lines already yielded are skipped, so no line is
    yielded twice."""
    policy = policy or RetryPolicy.from_knobs()
    attempt = 0
    yielded = 0
    while True:
        attempt += 1
        try:
            f = open_fn()
            try:
                skip = yielded
                for line in f:
                    if skip:
                        skip -= 1
                        continue
                    yielded += 1
                    yield line
            finally:
                f.close()
        except Exception as e:
            _backoff_or_reraise(e, attempt, policy, site, classify,
                                context=f" mid-stream after {yielded} lines")
            continue
        if attempt > 1:
            _record_recovered(site, attempt)
        return
