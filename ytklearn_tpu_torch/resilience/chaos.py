"""Deterministic fault injection: named chaos sites on the failure-prone
seams (``ytklearn_tpu/resilience/chaos.py``).

A fault site is one `chaos_point("<site>")` call on a seam (`FAULT_SITES`
is the catalog). With no spec armed a chaos point is one env read and a
return; armed through

    YTK_CHAOS=<site>:<kind>:<rate>:<seed>[,<site>:<kind>:<rate>:<seed>...]

each matching call draws from a counter-based hash: draw n at a site is a
pure function of (seed, site, n), with no host RNG state, so a fault
schedule reproduces exactly across runs and processes, and equals the
JAX package's for the same spec. `<site>` may end in `*` to match a
prefix (`io.*`).

Kinds:

  oserror   raise ChaosOSError (an OSError, EIO): transient, so the retry
            layer retries it
  error     raise ChaosError (RuntimeError): fatal, never retried
  sigterm   SIGTERM to this process: drives the preemption guard
  kill      os._exit(137): a kill -9 stand-in, no handlers, no atexit, no
            flushes; only what is on disk survives

Every injected fault counts `chaos.injected` and `chaos.injected.<site>`
(obs registry), drops a `chaos.inject` event into the flight ring and is
logged BEFORE it acts.

`collective.host` fires in parallel/collectives.py::host_allgather_objects
(and so in load_on_rank0, equal_row_target and the multi-process ingest and
binning merges): fatal by design, never retried, since a rank that
re-entered a collective alone would desync the group.
"""

from __future__ import annotations

import errno
import logging
import os
import signal
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..config import knobs
from ..obs import event as obs_event
from . import inc

log = logging.getLogger("ytklearn_tpu_torch.resilience")

#: site -> where it lives
FAULT_SITES: Dict[str, str] = {
    "io.read": "ingest/model text read (LocalFileSystem.read_lines, native "
               "parser byte reads)",
    "io.dump": "atomic dump commit (LocalFileSystem.atomic_open replace)",
    "collective.host": "host-side collective "
                       "(parallel/collectives.py::host_allgather_objects)",
    "gbdt.sync": "GBDT round-boundary loss read (device engine)",
    "continual.copy": "continual shadow/archive file copy "
                      "(continual/driver.py::_copy_file)",
    "continual.promote": "continual promotion/restore replace "
                         "(continual/driver.py::_replace_file)",
    "serve.load": "serve registry warm load (initial load + hot reload)",
    "serve.worker": "serve /predict hot path (ServeApp.predict)",
}

KINDS = ("oserror", "error", "sigterm", "kill")

_MASK = (1 << 64) - 1


class ChaosError(RuntimeError):
    """A fatal injected fault (kind=error): never classified transient."""


class ChaosOSError(OSError):
    """A transient injected IO fault (kind=oserror): retried."""


@dataclass(frozen=True)
class ChaosRule:
    site: str  # exact name or "prefix*"
    kind: str
    rate: float
    seed: int

    def matches(self, site: str) -> bool:
        if self.site.endswith("*"):
            return site.startswith(self.site[:-1])
        return site == self.site


def parse_chaos_spec(raw: str) -> Tuple[ChaosRule, ...]:
    """`site:kind:rate:seed[,...]` -> rules; a malformed spec raises (a
    typo that silently disarmed a drill would defeat it)."""
    rules = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 4:
            raise ValueError(
                f"bad YTK_CHAOS entry {part!r}: want site:kind:rate:seed")
        site, kind, rate_s, seed_s = (f.strip() for f in fields)
        if kind not in KINDS:
            raise ValueError(
                f"bad YTK_CHAOS kind {kind!r} (one of {'|'.join(KINDS)})")
        rate = float(rate_s)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"bad YTK_CHAOS rate {rate_s!r}: want [0, 1]")
        known = site in FAULT_SITES or (
            site.endswith("*")
            and any(s.startswith(site[:-1]) for s in FAULT_SITES))
        if not known:
            log.warning("YTK_CHAOS names unknown fault site %r (catalog: "
                        "%s)", site, ", ".join(sorted(FAULT_SITES)))
        rules.append(ChaosRule(site, kind, rate, int(seed_s)))
    return tuple(rules)


def site_draw(seed: int, site: str, n: int) -> float:
    """Draw n (1-based) at a site under a seed, in [0, 1): a splitmix64
    finalizer over (seed, site hash, n), the JAX package's bit for bit."""
    h = 0
    for ch in site.encode("utf-8"):
        h = (h * 131 + ch) & _MASK
    x = (h ^ ((seed & _MASK) * 0x9E3779B97F4A7C15)) & _MASK
    x = (x + n * 0xBF58476D1CE4E5B9) & _MASK
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK
    x ^= x >> 31
    return x / 2.0 ** 64


class _ChaosState:
    def __init__(self):
        self.lock = threading.Lock()
        self.counters: Dict[str, int] = {}  # site -> calls seen
        self.cached_raw: Optional[str] = None
        self.cached_rules: Tuple[ChaosRule, ...] = ()


_state = _ChaosState()


def reset_chaos() -> None:
    """Clear the per-site call counters (the spec itself lives in the env
    and is re-read at every chaos_point)."""
    with _state.lock:
        _state.counters.clear()
        _state.cached_raw = None
        _state.cached_rules = ()


def chaos_enabled() -> bool:
    return bool(knobs.get_str("YTK_CHAOS"))


def _rules() -> Tuple[ChaosRule, ...]:
    raw = knobs.get_str("YTK_CHAOS") or ""
    with _state.lock:
        if raw != _state.cached_raw:
            # parse BEFORE caching: a malformed spec raises at EVERY
            # chaos_point, not only the first
            rules = parse_chaos_spec(raw) if raw else ()
            _state.cached_rules = rules
            _state.cached_raw = raw
        return _state.cached_rules


def chaos_point(site: str) -> None:
    """Named fault site. Disarmed: one env read. Armed: advance the site's
    counter and inject by the first matching rule whose draw < rate."""
    rules = _rules()
    if not rules:
        return
    matching = [r for r in rules if r.matches(site)]
    if not matching:
        return
    with _state.lock:
        n = _state.counters.get(site, 0) + 1
        _state.counters[site] = n
    for r in matching:
        if site_draw(r.seed, site, n) < r.rate:
            _inject(site, r.kind, n)
            return  # sigterm returns here; one injection a call


def _inject(site: str, kind: str, n: int) -> None:
    # the evidence first: it must exist even when the injection is about
    # to take the process down
    inc("chaos.injected")
    inc(f"chaos.injected.{site}")
    obs_event("chaos.inject", site=site, kind=kind, call=n)
    log.warning("chaos: injecting %s at %s (call %d)", kind, site, n)
    if kind == "oserror":
        raise ChaosOSError(
            errno.EIO,
            f"chaos: injected transient IO fault at {site} (call {n})")
    if kind == "error":
        raise ChaosError(f"chaos: injected fatal fault at {site} (call {n})")
    if kind == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
        return
    # kill: no handlers, no atexit, as an external kill -9 would
    os._exit(137)
