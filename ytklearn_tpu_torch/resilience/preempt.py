"""Preemption-safe exit: deferred SIGTERM/SIGINT and an emergency
checkpoint (``ytklearn_tpu/resilience/preempt.py``).

Trainers run under a `PreemptionGuard`:

  1. the handler only sets a flag (no locks, no IO);
  2. the training loop checks the flag at its next safe boundary (the GBDT
     round start of either engine, the GBST tree boundary, the L-BFGS
     iteration callback of the convex families), dumps a complete
     checkpoint through the ordinary atomic dump path and raises
     `Preempted`;
  3. the CLI maps `Preempted` to the exit code 128+signum (143 for
     SIGTERM, 130 for SIGINT); `--resume auto` on the relaunch finds the
     checkpoint and re-enters training through continue_train.

GBDT resumes bit-identically to the uninterrupted run on the device
engine (every round's key is fold_in(root, round)) and on the host engine
at sampling rates of 1; convex families resume as an L-BFGS warm start
from the checkpoint weights; GBST at the last finished tree.

A second SIGINT escalates to the previous handler (a double Ctrl-C still
kills a hung run); SIGTERM stays deferred. `trainer_guard` installs the
flight recorder's hooks (`obs/recorder.py::auto_install`) before the
guard, as the reference's does.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading
from typing import Dict, Iterator, Optional

from ..config import knobs
from ..obs import event as obs_event, recorder
from . import inc

log = logging.getLogger("ytklearn_tpu_torch.resilience")


class Preempted(RuntimeError):
    """Training stopped early on a deferred SIGTERM/SIGINT after dumping an
    emergency checkpoint; `exit_code` is 128+signum."""

    def __init__(self, signum: int, checkpoint: str = ""):
        name = signal.Signals(signum).name if signum else "signal"
        msg = f"preempted by {name}"
        if checkpoint:
            msg += f"; emergency checkpoint at {checkpoint}"
        super().__init__(msg)
        self.signum = signum
        self.checkpoint = checkpoint

    @property
    def exit_code(self) -> int:
        return 128 + self.signum


class PreemptionGuard:
    """The deferred-signal flag and the boundary's exit helper."""

    def __init__(self):
        self._event = threading.Event()
        self._signum: Optional[int] = None
        self._counts: Dict[int, int] = {}
        self._prev: Dict[int, object] = {}
        self.installed = False

    # -- handler side (a flag and counters only) ------------------------------

    def _handler(self, signum, frame):
        first_of_kind = self._counts.get(signum, 0) == 0
        self._counts[signum] = self._counts.get(signum, 0) + 1
        if self._signum is None:
            self._signum = signum
        self._event.set()
        if signum == signal.SIGINT and not first_of_kind:
            # a second Ctrl-C means now: hand back to the previous handler
            prev = self._prev.get(signum)
            if callable(prev):
                signal.signal(signal.SIGINT, prev)
                prev(signum, frame)
                return
            raise KeyboardInterrupt

    def install(self) -> "PreemptionGuard":
        """Hook SIGTERM and SIGINT (idempotent). Off the main thread
        signal.signal is unavailable: the guard stays inert and
        `triggered` is always False."""
        if self.installed:
            return self
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handler)
            self.installed = True
        except ValueError:
            self._prev.clear()
        return self

    def uninstall(self) -> None:
        if not self.installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig,
                              prev if prev is not None else signal.SIG_DFL)
            except (ValueError, TypeError):
                pass
        self._prev.clear()
        self.installed = False

    # -- boundary side ----------------------------------------------------------

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self) -> int:
        return self._signum or signal.SIGTERM

    def preempt(self, checkpoint: str = "", **attrs) -> None:
        """Count and log the exit, then raise `Preempted`. Call it after the
        emergency checkpoint's dump, so the resume finds a complete
        model; the flight dump (when the recorder is installed) carries
        the chaos/retry/preempt event trail for the postmortem."""
        inc("preempt.exits")
        obs_event(
            "preempt.checkpoint", signum=self.signum,
            checkpoint=checkpoint, **attrs,
        )
        if recorder.installed():
            recorder.dump("preempt")
        log.warning("preempted (signal %d, %s): emergency checkpoint %s; "
                    "rerun with --resume auto to continue", self.signum,
                    " ".join(f"{k}={v}" for k, v in attrs.items()),
                    checkpoint or "n/a")
        raise Preempted(self.signum, checkpoint)


@contextlib.contextmanager
def preemption_guard(enabled: Optional[bool] = None
                     ) -> Iterator[Optional[PreemptionGuard]]:
    """A guard for the duration of a training loop; YTK_PREEMPT=0 yields
    None and the loop keeps the process's signal handlers."""
    if enabled is None:
        enabled = knobs.get_bool("YTK_PREEMPT")
    if not enabled:
        yield None
        return
    guard = PreemptionGuard().install()
    try:
        yield guard
    finally:
        guard.uninstall()


@contextlib.contextmanager
def trainer_guard(trainer) -> Iterator[Optional[PreemptionGuard]]:
    """The trainer-entry hook: the flight recorder's hooks first, then the
    guard, with `trainer._guard` set for the loop's boundary checks. The
    order is LIFO: the guard uninstalls at train end and must hand the
    signals back to the recorder's handlers, not the other way round (a
    recorder installed second would chain to a dead guard handler)."""
    recorder.auto_install()
    with preemption_guard() as guard:
        trainer._guard = guard
        try:
            yield guard
        finally:
            trainer._guard = None
