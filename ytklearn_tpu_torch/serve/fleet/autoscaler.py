"""Load-driven fleet autoscaler: adapt *replica count* to offered load
(the JAX package's ``serve/fleet/autoscaler.py``).

The AIMD controller (aimd.py, Clipper §4.3) adapts the other axis —
batch size — to load. This module adapts the fleet's size: a control
thread on the front watches windowed load signals and grows or reaps
replica slots within `--replicas-min/--replicas-max`.

Two deliberately separate pieces:

  AutoscalePolicy   PURE decision logic — no threads, no clocks it does
                    not receive, no front. Feed it one `ScaleSignals`
                    per tick plus `now`, get a decision back. Every
                    threshold/hysteresis/cooldown rule lives here so the
                    unit tests drive synthetic signal streams through
                    the exact production code path.
  FleetAutoscaler   the control thread: samples the signals off the
                    front (forwarder backlog rows, shed-counter delta,
                    windowed client-visible p99, health.slo_burn delta),
                    runs the policy, and executes decisions through
                    `front.scale_up()` / `front.scale_down()`.

Signals (one `ScaleSignals` per tick, all windowed to the tick):

  backlog_rows  rows queued in the per-replica forwarders + rows already
                inside an HTTP round-trip (`front._load_of` summed over
                ready replicas) — the direct "capacity is behind" signal
  shed          `serve.shed` counter delta since the last tick: the
                front's forwarders shed typed 429s when their bounded
                queues fill, which is exactly the failure autoscaling
                exists to bound
  p99_ms        percentile over the front's client-visible latency ring
                WINDOWED to recent samples (the same windowing rule the
                fleet ring union uses) — every fleet request passes the
                front, so this ring is the fleet-wide client-visible
                latency, judged against the `--slo-ms` SLO
  slo_burn      `health.slo_burn` counter delta: the burn-rate
                sentinel firing is a sustained-violation signal already
                debounced over its own window

Decision rules (the robustness surface, each pinned by a unit test):

  hysteresis    an *overloaded* tick (backlog over the up threshold, or
                sheds, or p99 over the SLO, or a burn fire) advances the
                up-streak; an *idle* tick (backlog under the down
                threshold AND no sheds AND p99 comfortably inside the
                SLO) advances the down-streak; a tick in the band
                between resets BOTH streaks — the fleet never flaps
                around a single threshold
  windows       a decision needs `up_windows` / `down_windows`
                CONSECUTIVE qualifying ticks, so one bursty second
                cannot grow the fleet and one quiet second cannot reap it
  cooldowns     per-direction: after a scale-up, further ups wait
                `up_cooldown_s` (let the new capacity land before
                judging again) and downs wait `down_cooldown_s` (never
                reap capacity the spike just paid for); after a
                scale-down, further downs wait `down_cooldown_s`.
                Cooldown suppression is SILENT (no counter) — the streak
                stays saturated so the decision fires on the first tick
                after the cooldown expires if the condition persists
  defer         while the monitor is healing a slot (any slot dead or
                starting — including restart-backoff corpses), decisions
                are DEFERRED: a respawn already in flight is capacity
                arriving, not a reason to spawn more, and a dead slot
                still counts against `max` so heal + autoscale can never
                double-spawn past the bound (`serve.scale.deferred`)
  blocked       a decision at the boundary (up at `max` slots, down at
                `min` ready) is recorded once per streak as
                `serve.scale.blocked` and the streak resets — the
                operator sees saturated demand in the flight ring
                instead of a silent ceiling

Every executed decision lands `serve.scale.{up,down}` counters and a
flight-ring event naming the signal values that triggered it; deferred/
blocked decisions land `serve.scale.{deferred,blocked}` the same way.
The live `serve.fleet.replicas` gauge (ready slots) is maintained by the
front on every topology/health transition, so the metrics history plane
renders a scale ramp as a time series (`/metrics?history=1`).

Knobs: YTK_SERVE_REPLICAS_
{MIN,MAX}, YTK_SERVE_SCALE_{INTERVAL_S,UP_BACKLOG,DOWN_BACKLOG,
UP_WINDOWS,DOWN_WINDOWS,UP_COOLDOWN_S,DOWN_COOLDOWN_S}.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional

from ...config import knobs
from ...obs import event as obs_event, inc as obs_inc
from ...obs.core import REGISTRY as OBS_REGISTRY
from ...obs.recorder import thread_guard

log = logging.getLogger("ytklearn_tpu_torch.serve.fleet")

#: an idle tick additionally requires p99 comfortably INSIDE the SLO —
#: below this fraction of it — so the fleet never shrinks while latency
#: is merely "not violating yet" (half the SLO is the hysteresis floor)
DOWN_P99_FRACTION = 0.5

#: seconds of latency-ring history the p99 signal is computed over
P99_WINDOW_S = 15.0


@dataclass
class ScaleSignals:
    """One decision tick's windowed observation of the fleet."""

    backlog_rows: int = 0  # forwarder queues + in-HTTP-flight rows (ready)
    ready: int = 0  # slots currently serving traffic
    slots: int = 0  # ALL capacity-bearing slots incl. dead/starting
    unsettled: int = 0  # slots dead or starting (heal/spawn in flight)
    shed: float = 0.0  # serve.shed delta this tick (typed 429s)
    p99_ms: float = 0.0  # windowed client-visible p99 (0 = no recent traffic)
    slo_burn: float = 0.0  # health.slo_burn delta this tick


@dataclass
class ScaleDecision:
    """What the policy decided this tick (None action = hold steady)."""

    action: Optional[str] = None  # up | down | deferred | blocked | None
    want: Optional[str] = None  # the direction behind deferred/blocked
    reason: Optional[Dict[str, object]] = None  # signal values, for the event


class AutoscalePolicy:
    """Threshold + hysteresis + cooldown decision logic (pure; see module
    docstring for the rules). One instance per fleet front."""

    def __init__(
        self,
        min_replicas: int,
        max_replicas: int,
        slo_ms: Optional[float] = None,
        up_backlog: Optional[float] = None,
        down_backlog: Optional[float] = None,
        up_windows: Optional[int] = None,
        down_windows: Optional[int] = None,
        up_cooldown_s: Optional[float] = None,
        down_cooldown_s: Optional[float] = None,
    ):
        if min_replicas < 1:
            raise ValueError(f"replicas-min must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"replicas-max {max_replicas} < replicas-min {min_replicas}"
            )
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.slo_ms = float(slo_ms) if slo_ms and slo_ms > 0 else None
        #: overload when backlog exceeds this many rows PER READY REPLICA
        self.up_backlog = float(
            up_backlog if up_backlog is not None
            else knobs.get_float("YTK_SERVE_SCALE_UP_BACKLOG")
        )
        #: idle when backlog is under this many rows per ready replica
        self.down_backlog = float(
            down_backlog if down_backlog is not None
            else knobs.get_float("YTK_SERVE_SCALE_DOWN_BACKLOG")
        )
        if self.down_backlog >= self.up_backlog:
            raise ValueError(
                f"scale-down backlog threshold {self.down_backlog} must sit "
                f"below the scale-up threshold {self.up_backlog} "
                "(the gap IS the hysteresis band)"
            )
        self.up_windows = max(1, int(
            up_windows if up_windows is not None
            else knobs.get_int("YTK_SERVE_SCALE_UP_WINDOWS")
        ))
        self.down_windows = max(1, int(
            down_windows if down_windows is not None
            else knobs.get_int("YTK_SERVE_SCALE_DOWN_WINDOWS")
        ))
        self.up_cooldown_s = float(
            up_cooldown_s if up_cooldown_s is not None
            else knobs.get_float("YTK_SERVE_SCALE_UP_COOLDOWN_S")
        )
        self.down_cooldown_s = float(
            down_cooldown_s if down_cooldown_s is not None
            else knobs.get_float("YTK_SERVE_SCALE_DOWN_COOLDOWN_S")
        )
        self._up_streak = 0
        self._down_streak = 0
        self._up_not_before = 0.0
        self._down_not_before = 0.0
        self.last_decision: Optional[Dict[str, object]] = None

    # -- tick classification ---------------------------------------------

    def _overloaded(self, sig: ScaleSignals) -> bool:
        per_replica = sig.backlog_rows / max(sig.ready, 1)
        return (
            per_replica > self.up_backlog
            or sig.shed > 0
            or sig.slo_burn > 0
            or (self.slo_ms is not None and sig.p99_ms > self.slo_ms)
        )

    def _idle(self, sig: ScaleSignals) -> bool:
        per_replica = sig.backlog_rows / max(sig.ready, 1)
        return (
            per_replica < self.down_backlog
            and sig.shed <= 0
            and sig.slo_burn <= 0
            and (
                self.slo_ms is None
                or sig.p99_ms < self.slo_ms * DOWN_P99_FRACTION
            )
        )

    # -- the decision -----------------------------------------------------

    def decide(self, sig: ScaleSignals, now: Optional[float] = None) -> ScaleDecision:
        """One tick: advance the streaks, return the decision. `now` is
        injectable (tests drive synthetic timelines); production passes
        time.monotonic()."""
        if now is None:
            now = time.monotonic()
        if self._overloaded(sig):
            # saturate instead of growing without bound: a cooldown-
            # suppressed streak must fire on the first free tick, not
            # bank extra decisions
            self._up_streak = min(self._up_streak + 1, self.up_windows)
            self._down_streak = 0
        elif self._idle(sig):
            self._down_streak = min(self._down_streak + 1, self.down_windows)
            self._up_streak = 0
        else:
            # the hysteresis band between the thresholds: no streak
            # survives it, so the fleet cannot flap around either edge
            self._up_streak = 0
            self._down_streak = 0
        want: Optional[str] = None
        if self._up_streak >= self.up_windows:
            want = "up"
        elif self._down_streak >= self.down_windows:
            want = "down"
        if want is None:
            return ScaleDecision()
        reason = {
            "want": want,
            "backlog_rows": sig.backlog_rows,
            "ready": sig.ready,
            "slots": sig.slots,
            "shed": round(float(sig.shed), 1),
            "p99_ms": round(float(sig.p99_ms), 3),
            "slo_ms": self.slo_ms,
            "slo_burn": round(float(sig.slo_burn), 1),
            "streak": self._up_streak if want == "up" else self._down_streak,
        }
        if sig.unsettled > 0:
            # heal/spawn in flight: the monitor owns that slot. Respawn is
            # capacity arriving (and the dead slot still counts against
            # max), so the decision waits — this is what makes kill-mid-
            # ramp unable to double-spawn past the bound
            return ScaleDecision("deferred", want, reason)
        if want == "up":
            if sig.slots >= self.max_replicas:
                self._up_streak = 0  # one blocked per full streak
                return ScaleDecision("blocked", want, reason)
            if now < self._up_not_before:
                return ScaleDecision(None, want, reason)  # silent cooldown
            self._up_streak = 0
            self._up_not_before = now + self.up_cooldown_s
            # fresh capacity must not be reaped the moment the spike ends
            self._down_not_before = max(
                self._down_not_before, now + self.down_cooldown_s
            )
            return ScaleDecision("up", want, reason)
        if sig.ready <= self.min_replicas:
            self._down_streak = 0
            return ScaleDecision("blocked", want, reason)
        if now < self._down_not_before:
            return ScaleDecision(None, want, reason)  # silent cooldown
        self._down_streak = 0
        self._down_not_before = now + self.down_cooldown_s
        return ScaleDecision("down", want, reason)

    def snapshot(self, now: Optional[float] = None) -> dict:
        """/metrics `autoscale` block: bounds, thresholds, cooldown state,
        streaks, and the last executed decision."""
        if now is None:
            now = time.monotonic()
        return {
            "min": self.min_replicas,
            "max": self.max_replicas,
            "slo_ms": self.slo_ms,
            "up_backlog_per_replica": self.up_backlog,
            "down_backlog_per_replica": self.down_backlog,
            "up_windows": self.up_windows,
            "down_windows": self.down_windows,
            "up_streak": self._up_streak,
            "down_streak": self._down_streak,
            "up_cooldown_remaining_s": round(
                max(0.0, self._up_not_before - now), 2),
            "down_cooldown_remaining_s": round(
                max(0.0, self._down_not_before - now), 2),
            "last_decision": self.last_decision,
        }


class FleetAutoscaler:
    """The control thread: sample signals off the front, run the policy,
    execute decisions. Owns no locks of its own beyond the stop event —
    topology changes go through front.scale_up()/scale_down(), which
    serialize under the front's scale lock."""

    def __init__(
        self,
        front,
        policy: AutoscalePolicy,
        interval_s: Optional[float] = None,
    ):
        self.front = front
        self.policy = policy
        self.interval_s = float(
            interval_s if interval_s is not None
            else knobs.get_float("YTK_SERVE_SCALE_INTERVAL_S")
        )
        self.ticks = 0
        self._last_shed = 0.0
        self._last_burn = 0.0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        # baseline the counter deltas so pre-start sheds (or a previous
        # run in this process — tests) don't count as this tick's load
        counters = OBS_REGISTRY.snapshot()["counters"]
        self._last_shed = counters.get("serve.shed", 0.0)
        self._last_burn = counters.get("health.slo_burn", 0.0)
        self._thread = threading.Thread(
            target=self._loop, name="ytk-fleet-autoscaler", daemon=True
        )
        self._thread.start()
        log.info(
            "fleet: autoscaler armed (min=%d max=%d interval=%.2fs)",
            self.policy.min_replicas, self.policy.max_replicas,
            self.interval_s,
        )
        return self

    def stop(self, timeout: float = 60.0) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            # a scale-down mid-drain finishes its drain before exiting
            self._thread.join(timeout=timeout)

    # -- signal sampling --------------------------------------------------

    def signals(self) -> ScaleSignals:
        """One windowed observation of the fleet (see module docstring)."""
        from .front import latency_percentiles, window_ring_ms

        front = self.front
        ready = unsettled = backlog = 0
        handles = front.handles  # copy-on-write topology: stable snapshot
        for rid, h in handles.items():
            state = h.state
            if state == "ready":
                ready += 1
                backlog += front._load_of(rid)
            elif state in ("starting", "dead"):
                # dead-in-backoff and spawning slots are capacity that is
                # assigned but not serving: they defer decisions and still
                # count against max via `slots`
                unsettled += 1
        counters = OBS_REGISTRY.snapshot()["counters"]
        shed_total = counters.get("serve.shed", 0.0)
        burn_total = counters.get("health.slo_burn", 0.0)
        shed, self._last_shed = shed_total - self._last_shed, shed_total
        burn, self._last_burn = burn_total - self._last_burn, burn_total
        p99 = 0.0
        if front.latency is not None:
            recent = window_ring_ms(
                front.latency.raw(), time.time(), window_s=P99_WINDOW_S
            )
            p99 = latency_percentiles(recent).get("p99_ms", 0.0)
        return ScaleSignals(
            backlog_rows=backlog,
            ready=ready,
            slots=len(handles),
            unsettled=unsettled,
            shed=shed,
            p99_ms=p99,
            slo_burn=burn,
        )

    # -- the control loop -------------------------------------------------

    @thread_guard
    def _loop(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the control loop must survive
                log.exception("fleet: autoscaler tick crashed")

    def tick(self) -> ScaleDecision:
        """One decision tick (public: the drills/tests can step it)."""
        self.ticks += 1
        sig = self.signals()
        decision = self.policy.decide(sig)
        if decision.action in ("deferred", "blocked"):
            obs_inc(f"serve.scale.{decision.action}")
            obs_event(f"serve.scale.{decision.action}", **(decision.reason or {}))
            return decision
        # serve.scale.{up,down} evidence lands only AFTER the front
        # reports the action actually happened — the front can decline a
        # decision the policy made on a stale tick (a replica died
        # between signals() and here, or the fleet is closing), and a
        # phantom "executed decision" in the flight ring would make the
        # evidence plane disagree with the topology
        if decision.action == "up":
            if self.front.scale_up(reason=decision.reason):
                obs_inc("serve.scale.up")
                obs_event("serve.scale.up", **(decision.reason or {}))
                self.policy.last_decision = dict(
                    decision.reason or {}, action="up", at=time.time())
            else:
                log.warning("fleet: scale-up decision declined by the "
                            "front (closing or at max)")
        elif decision.action == "down":
            # drain-based reap runs HERE on the control thread (fence ->
            # forwarder drain/reroute -> SIGTERM) so a tick never
            # overlaps its own slot teardown
            reaped = self.front.scale_down(reason=decision.reason)
            if reaped is not None:
                obs_inc("serve.scale.down")
                obs_event("serve.scale.down", replica_id=reaped,
                          **(decision.reason or {}))
                self.policy.last_decision = dict(
                    decision.reason or {}, action="down", at=time.time())
            else:
                log.warning("fleet: scale-down decision declined by the "
                            "front (at floor or closing)")
        return decision

    def snapshot(self) -> dict:
        out = self.policy.snapshot()
        out["enabled"] = True
        out["interval_s"] = self.interval_s
        out["ticks"] = self.ticks
        return out


def maybe_autoscaler(front, replicas_min: int, replicas_max: int,
                     slo_ms: Optional[float] = None,
                     params: Optional[dict] = None):
    """A FleetAutoscaler when the band is real (max > min), else None —
    a fixed fleet stays fixed. `params` overrides individual
    policy/interval knobs (drills, tests)."""
    if replicas_max <= replicas_min:
        return None
    params = dict(params or {})
    interval_s = params.pop("interval_s", None)
    policy = AutoscalePolicy(replicas_min, replicas_max, slo_ms=slo_ms,
                             **params)
    return FleetAutoscaler(front, policy, interval_s=interval_s)
