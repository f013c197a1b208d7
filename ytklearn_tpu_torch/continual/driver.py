"""`cli retrain`, the continual-training driver (the JAX package's
``continual/driver.py``): close the train -> serve loop.

One call does the whole freshness cycle:

  1. SHADOW    copy the serving incumbent's files to `<data_path>.shadow*`
               and warm-start a candidate there on the card: GBDT grows
               `continual.extra_rounds` more boosting rounds on the new
               data (`continue_train`), GBST more trees, the convex
               families either refit L-BFGS from the checkpoint weights
               (`mode=warm`) or stream one FTRL-proximal pass over the
               fresh rows (`mode=ftrl`, optimize/ftrl.py); the live model
               keeps serving untouched throughout.
  2. GATE      the health sentinels must stay silent over the candidate
               run AND the candidate's held-out loss must sit inside the
               band versus the incumbent, both measured now on the same
               held-out files (continual/gates.py).
  3. PROMOTE   on pass, archive the incumbent to `<data_path>.v<N>` (for
               `retrain --rollback`), move every candidate file over the
               live path with atomic per-file replaces, and stamp
               `<data_path>.version.json`: the serving registry's
               fingerprint watcher picks the new version up and swaps it
               in under traffic (serve/registry.py). On a fail the
               incumbent keeps serving, the shadow is left for
               inspection, and a `continual.rejected` obs event names
               every failed gate.

The candidate's training and the gates' scoring run under the serving
scorer's `compile_credit`: their library builds and first kernel
launches are expected work, so a `CompiledScorer` armed in the same
process keeps its zero-steady-state-retrace contract, and the driver
drops `health.retrace` from the health delta, as the reference does.

`devices` (a list of N rank devices) trains a warm candidate on N ranks
through the `cli train` launcher (parallel/launch.py) from the shadow
config; its ranks' health sentinel counts join the health gate, and the
lock, both gates, promotion and rollback stay in this process on
`device`. `mode=ftrl` takes no ranks, as in the reference
(continual/online.py streams one device): it runs here, on `device`.
"""

from __future__ import annotations

import json
import logging
import math
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..config import hocon, knobs
from ..config.params import CommonParams, GBDTParams
from ..io.fs import FileSystem, create_filesystem, is_tmp_path
from ..obs.recorder import thread_guard
from ..obs import (
    configure as obs_configure,
    enabled as obs_enabled,
    event as obs_event,
    inc as obs_inc,
    span as obs_span,
)
from ..device import resolve_device
from ..predict import create_predictor
from ..resilience import chaos_point, retry_call
from .gates import (
    GateReport,
    drift_advisory,
    evaluate_gates,
    health_counters,
    health_delta,
    holdout_loss,
)

log = logging.getLogger("ytklearn_tpu_torch.continual")

GBST_NAMES = ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt")
CONVEX_NAMES = ("linear", "multiclass_linear", "fm", "ffm")

SHADOW_SUFFIX = ".shadow"
VERSION_SUFFIX = ".version.json"
LOCK_SUFFIX = ".retrain.lock"


class RetrainRejected(RuntimeError):
    """A gated candidate failed promotion under YTK_CONTINUAL_STRICT=1;
    carries the gate report."""

    def __init__(self, report: GateReport):
        super().__init__(
            "retrain candidate rejected: " + "; ".join(report.reasons)
        )
        self.report = report


@dataclass
class RetrainResult:
    promoted: bool
    version: int  # serving version after the call
    gate: Optional[GateReport] = None
    model_path: str = ""
    shadow_path: str = ""
    mode: str = "warm"
    trained: Dict[str, float] = field(default_factory=dict)  # family metrics
    rolled_back: bool = False
    ranks: List[dict] = field(default_factory=list)  # --devices reports

    def to_json(self) -> dict:
        def _finite(v):
            # stdlib json emits bare NaN/Infinity, which is not JSON —
            # a rejected candidate's losses are exactly where they appear
            return v if v is None or math.isfinite(v) else None

        out = {
            "promoted": self.promoted,
            "version": self.version,
            "model_path": self.model_path,
            "mode": self.mode,
            "rolled_back": self.rolled_back,
        }
        if self.gate is not None:
            out["gate"] = {
                "passed": self.gate.passed,
                "reasons": self.gate.reasons,
                "candidate_loss": _finite(self.gate.candidate_loss),
                "incumbent_loss": _finite(self.gate.incumbent_loss),
                "band": self.gate.band,
                "holdout_rows": self.gate.holdout_rows,
            }
            if self.gate.advisory is not None:
                # serve-side drift snapshot recorded at gate time —
                # advisory by contract
                out["gate"]["drift_advisory"] = self.gate.advisory
        if self.trained:
            out["trained"] = {k: _finite(v) for k, v in self.trained.items()}
        if self.ranks:
            out["ranks"] = self.ranks
        return out


# ---------------------------------------------------------------------------
# File plumbing: every model family dumps under model.data_path plus a
# fixed set of sidecar roots; shadow/archive/promote move those trees as
# one unit, file by file, with atomic per-file replaces.
# ---------------------------------------------------------------------------


def _roots(data_path: str) -> Dict[str, str]:
    """The file roots a dumped model can span (missing ones are skipped):
    main tree (file or directory), the dict sidecar dir, the transform
    stat sidecar."""
    return {
        "": data_path,
        "_dict": data_path + "_dict",
        "_feature_transform_stat": data_path + "_feature_transform_stat",
        # serve-side bin-edge sidecar (gbdt/binning.dump_bin_edges): a
        # promoted candidate must carry its own edges, and a rollback must
        # restore the incumbent's
        ".bins.json": data_path + ".bins.json",
        # model-quality sketch sidecar (obs/quality.py): the drift
        # baseline must travel with the exact ensemble it was built for
        # through shadow/promote/archive/rollback
        ".sketch.json": data_path + ".sketch.json",
    }


def _files_under(fs: FileSystem, root: str) -> List[str]:
    if not fs.exists(root):
        return []
    return [p for p in sorted(fs.recur_get_paths([root])) if not is_tmp_path(p)]


def _rel(root: str, path: str) -> str:
    """'' when path IS the root file, else the '/'-relative suffix."""
    if path == root:
        return ""
    root = root.rstrip("/")
    if not path.startswith(root + "/"):
        raise ValueError(f"{path!r} is not under {root!r}")
    return path[len(root):]


def _copy_file(fs: FileSystem, src: str, dst: str) -> None:
    # chunked: a GBDT dump with stats can run to hundreds of MB, and
    # retrain copies the incumbent twice (shadow + archive). The whole
    # copy is one `continual.copy` retry unit — atomic_open guarantees a
    # failed attempt leaves dst untouched, so a rerun is exact
    def _once():
        chaos_point("continual.copy")
        with fs.open(src) as sf, fs.atomic_open(dst) as df:
            while True:
                chunk = sf.read(1 << 20)
                if not chunk:
                    break
                df.write(chunk)

    retry_call(_once, site="continual.copy")


def _replace_file(fs: FileSystem, src: str, dst: str) -> None:
    """Promotion/restore move under the `continual.promote` retry/chaos
    site. Idempotent per attempt: when a prior attempt actually landed
    (src gone, dst present) the rerun is a no-op, so a transient fault
    anywhere around the (atomic) replace never tears the file set."""

    def _once():
        chaos_point("continual.promote")
        if not fs.exists(src):
            if fs.exists(dst):
                return  # a previous attempt landed the move
            raise FileNotFoundError(src)
        fs.replace(src, dst)

    retry_call(_once, site="continual.promote")


def _copy_roots(fs: FileSystem, src_base: str, dst_base: str) -> int:
    """Copy every model file from the src root set to the dst root set;
    returns the file count."""
    n = 0
    for suffix, src_root in _roots(src_base).items():
        dst_root = _roots(dst_base)[suffix]
        for path in _files_under(fs, src_root):
            _copy_file(fs, path, dst_root + _rel(src_root, path))
            n += 1
    return n


def _promote_roots(fs: FileSystem, src_base: str, dst_base: str) -> int:
    """MOVE every candidate file over the live path (atomic per-file
    replace), then drop the emptied shadow roots."""
    n = 0
    for suffix, src_root in _roots(src_base).items():
        dst_root = _roots(dst_base)[suffix]
        for path in _files_under(fs, src_root):
            _replace_file(fs, path, dst_root + _rel(src_root, path))
            n += 1
        if fs.exists(src_root):
            fs.delete(src_root)  # now-empty shadow dir (or stale file)
    return n


def _delete_roots(fs: FileSystem, base: str) -> None:
    for root in _roots(base).values():
        if fs.exists(root):
            fs.delete(root)


def _restore_roots(fs: FileSystem, src_base: str, dst_base: str) -> int:
    """MOVE every archive file over the live path, then prune live files
    the archive does not carry (e.g. a longer ensemble's extra tree
    dirs). Restore-over-then-prune instead of delete-then-move: at no
    point is the live path without a complete model on disk — a crash
    mid-restore leaves every file whole and a re-run converges."""
    n = 0
    for suffix, src_root in _roots(src_base).items():
        dst_root = _roots(dst_base)[suffix]
        restored = set()
        for path in _files_under(fs, src_root):
            rel = _rel(src_root, path)
            _replace_file(fs, path, dst_root + rel)
            restored.add(rel)
            n += 1
        for path in _files_under(fs, dst_root):
            if _rel(dst_root, path) not in restored:
                fs.delete(path)
        if fs.exists(src_root):
            fs.delete(src_root)  # now-empty archive dir (or stale file)
    return n


# ---------------------------------------------------------------------------
# Retrain lock — `<data_path>.retrain.lock`: one retrain at a time per
# serving model. The lock carries OWNER METADATA (pid, host, heartbeat)
# and is self-healing: a dead same-host owner is reclaimed immediately, a
# stale heartbeat (owner host died / got preempted mid-retrain) after
# YTK_RETRAIN_LOCK_TTL_S — no more "delete the stale lock file and
# re-run" operator runbook step.
# ---------------------------------------------------------------------------


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return True  # can't tell: assume alive (never steal a live lock)
    return True


class RetrainLock:
    """Heartbeat-stamped retrain lockfile with dead-owner auto-reclaim."""

    def __init__(self, fs: FileSystem, path: str, ttl_s: Optional[float] = None):
        self.fs = fs
        self.path = path
        self.ttl_s = (
            float(knobs.get_float("YTK_RETRAIN_LOCK_TTL_S"))
            if ttl_s is None else float(ttl_s)
        )
        self._stop = threading.Event()
        self._beater: Optional[threading.Thread] = None
        self._started_at = 0.0

    # -- inspection --------------------------------------------------------

    def read_owner(self) -> Optional[dict]:
        """The lock's owner record, or None when absent/unreadable (an
        unreadable lock is a pre-metadata legacy file or debris — both
        reclaimable; atomic_open writes mean it can't be a torn write)."""
        if not self.fs.exists(self.path):
            return None
        try:
            with self.fs.open(self.path) as f:
                return json.load(f)
        except (json.JSONDecodeError, OSError, ValueError):
            return None

    def _reclaimable(self, owner: Optional[dict]) -> Optional[str]:
        """Reason string when the current lock can be reclaimed, else None."""
        if owner is None:
            return "unreadable/legacy lock file"
        age = time.time() - float(owner.get("heartbeat_at", 0.0))
        if age > self.ttl_s:
            return (
                f"heartbeat stale for {age:.0f}s "
                f"(> YTK_RETRAIN_LOCK_TTL_S={self.ttl_s:.0f}s)"
            )
        if owner.get("host") == socket.gethostname():
            pid = int(owner.get("pid", -1))
            if pid > 0 and not _pid_alive(pid):
                return f"owner pid {pid} on this host is dead"
        return None

    # -- lifecycle ---------------------------------------------------------

    def _owned(self, on_read_fault: bool = True) -> bool:
        """Is the on-disk record OURS? Heartbeats and release must never
        touch a lock another retrain legitimately reclaimed (e.g. this
        process was SIGSTOP'd/swapped past the TTL and a cron peer took
        over). A TRANSIENT read fault is ambiguous, so the caller picks
        the safe bias via `on_read_fault`: heartbeat/gate/promote assume
        still-owned (an IO blip must not stop the beat or abort a healthy
        promotion — the next check retries), while release() assumes NOT
        owned (uncertainty must never delete what might be a peer's
        healthy lock; worst case our own lock lingers until TTL)."""
        if not self.fs.exists(self.path):
            return False  # absent = released or deleted out from under us
        try:
            with self.fs.open(self.path) as f:
                owner = json.load(f)
        except (json.JSONDecodeError, ValueError):
            return False  # a peer's (or legacy) record
        except OSError:
            return on_read_fault
        return (
            int(owner.get("pid", -1)) == os.getpid()
            and owner.get("host") == socket.gethostname()
        )

    def _write(self) -> None:
        with self.fs.atomic_open(self.path) as f:
            json.dump({
                "pid": os.getpid(),
                "host": socket.gethostname(),
                "started_at": self._started_at,
                "heartbeat_at": time.time(),
            }, f)

    def acquire(self) -> "RetrainLock":
        if self.fs.exists(self.path):
            owner = self.read_owner()
            reason = self._reclaimable(owner)
            if reason is None:
                age = time.time() - float((owner or {}).get("heartbeat_at", 0.0))
                raise RuntimeError(
                    f"another retrain holds {self.path} "
                    f"(pid={(owner or {}).get('pid')} "
                    f"host={(owner or {}).get('host')}, heartbeat {age:.0f}s "
                    f"old); it auto-reclaims once the owner dies or the "
                    f"heartbeat stays stale for YTK_RETRAIN_LOCK_TTL_S="
                    f"{self.ttl_s:.0f}s"
                )
            obs_inc("continual.lock_reclaimed")
            obs_event(
                "continual.lock_reclaimed", path=self.path, reason=reason,
                prev_pid=(owner or {}).get("pid"),
                prev_host=(owner or {}).get("host"),
            )
            log.warning("retrain lock %s reclaimed: %s", self.path, reason)
            # no delete: the reclaim is the atomic replace below — a
            # delete-then-write window would let a second reclaimer erase
            # THIS process's freshly-written record and slip past the
            # read-back arbitration
        self._started_at = time.time()
        self._write()
        # read-back arbitration: two acquirers racing through the
        # check-then-write window both land an atomic_open replace, but
        # last-writer-wins leaves exactly ONE owner record — the loser
        # sees the winner's pid and backs off (plain filesystems offer no
        # compare-and-swap; this closes all but a vanishing window, and
        # the heartbeat _owned() check evicts a late loser's beater too)
        if not self._owned():
            winner = self.read_owner() or {}
            raise RuntimeError(
                f"lost the retrain-lock race for {self.path} to "
                f"pid={winner.get('pid')} host={winner.get('host')}"
            )
        # heartbeat at ttl/3 so one missed beat never looks stale
        interval = max(self.ttl_s / 3.0, 0.5)
        self._beater = threading.Thread(
            target=self._beat_loop, args=(interval,),
            name="ytk-retrain-lock", daemon=True,
        )
        self._beater.start()
        return self

    @thread_guard
    def _beat_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                if not self._owned():
                    obs_inc("continual.lock_lost")
                    obs_event("continual.lock_lost", path=self.path)
                    log.warning(
                        "retrain lock %s is no longer ours (reclaimed by a "
                        "peer after a stall?); stopping the heartbeat — "
                        "promotion will re-verify ownership and abort",
                        self.path,
                    )
                    return
                self._write()
            except Exception:  # noqa: BLE001 — the beater must survive
                log.exception("retrain lock heartbeat write failed")

    def release(self) -> None:
        self._stop.set()
        if self._beater is not None:
            self._beater.join(timeout=5.0)
            self._beater = None
        if self._owned(on_read_fault=False):
            self.fs.delete(self.path)
        elif self.fs.exists(self.path):
            log.warning(
                "retrain lock %s belongs to another retrain (or is "
                "unreadable) at release; leaving it in place — a stale "
                "leftover self-heals at the TTL", self.path,
            )


# ---------------------------------------------------------------------------
# Version sidecar — `<data_path>.version.json`: the promotion record the
# serving registry fingerprints (so even a content-identical re-promotion
# triggers a reload) and `--rollback` reads.
# ---------------------------------------------------------------------------


def read_version(fs: FileSystem, data_path: str) -> dict:
    path = data_path + VERSION_SUFFIX
    if not fs.exists(path):
        return {"version": 1, "archives": []}
    try:
        with fs.open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        log.warning("unreadable version sidecar %s; starting at v1", path)
        return {"version": 1, "archives": []}


def _write_version(fs: FileSystem, data_path: str, info: dict) -> None:
    with fs.atomic_open(data_path + VERSION_SUFFIX) as f:
        json.dump(info, f, indent=1)


# ---------------------------------------------------------------------------
# The driver
# ---------------------------------------------------------------------------


def _eval_cfg(cfg: dict, family: str) -> dict:
    """Config for gate-time holdout scoring: uncap `optimization.round_num`
    so the predictor scores the WHOLE dumped ensemble — the training cap
    names how many rounds to grow, not how many the gate may see (the
    GBDT predictor serves min(dumped, round_num) when the cap is > 0)."""
    if family != "gbdt":
        return cfg
    out = json.loads(json.dumps(cfg))
    hocon.set_path(out, "optimization.round_num", 0)
    return out


def _family(model_name: str) -> str:
    if model_name == "gbdt":
        return "gbdt"
    if model_name in GBST_NAMES:
        return "gbst"
    if model_name in CONVEX_NAMES:
        return "convex"
    raise ValueError(f"unknown model name {model_name!r}")


def _fetch_drift_advisory() -> Optional[dict]:
    """Serve-side drift snapshot as a RECORDED advisory gate input:
    `YTK_CONTINUAL_DRIFT_URL` names the serving front (or a replica) and
    the driver scrapes its `/metrics?quality=1` at gate time. Never
    fatal and never a gate reason: the freshness cycle must not depend
    on the serving plane being scrapeable."""
    url = knobs.get_str("YTK_CONTINUAL_DRIFT_URL")
    if not url:
        return None
    import urllib.request

    try:
        chaos_point("continual.drift_fetch")
        # no retry: the scrape is advisory, and the cycle must not wait
        with urllib.request.urlopen(
            url.rstrip("/") + "/metrics?quality=1", timeout=10.0
        ) as r:
            doc = json.loads(r.read() or b"{}")
    except Exception as e:  # noqa: BLE001 — advisory only, never the cycle
        obs_inc("continual.drift_advisory_failed")
        log.warning("drift advisory fetch from %s failed: %s: %s",
                    url, type(e).__name__, e)
        return None
    adv = drift_advisory(doc.get("quality"))
    if adv is not None:
        obs_inc("continual.drift_advisory")
        obs_event("continual.drift_advisory", **{
            k: (",".join(map(str, v)) if isinstance(v, list) else v)
            for k, v in adv.items()
        })
    return adv


def _gbdt_incumbent_rounds(fs: FileSystem, p: GBDTParams) -> int:
    from ..gbdt.tree import GBDTModel

    with fs.open(p.model.data_path) as f:
        model = GBDTModel.loads(f.read())
    return len(model.trees) // max(p.num_tree_in_group, 1)


def _gbst_finished_trees(fs: FileSystem, data_path: str) -> int:
    path = f"{data_path}/tree-info"
    if not fs.exists(path):
        return 0
    with fs.open(path) as f:
        for line in f:
            if line.startswith("finished_tree_num:"):
                return int(float(line.split(":", 1)[1]))
    return 0


def _summary(family: str, rec: dict) -> Dict[str, float]:
    """The family's summary metrics from a `cli train` JSON record."""
    keys = ("n_iter", "avg_loss") if family == "convex" \
        else ("trees", "train_loss")
    out = {k: float(rec[k]) for k in keys}
    if rec.get("test_loss") is not None:
        out["test_loss"] = rec["test_loss"]
    return out


def _train_candidate(
    model_name: str, family: str, cfg: dict, fs: FileSystem, mode: str,
    transform_hook, device, hist_precision: Optional[str],
    devices: Optional[List[str]] = None, ranks: Optional[list] = None,
) -> Dict[str, float]:
    """Run the warm-start (or FTRL) candidate training against the shadow
    config on `device`, or on the ranks of `devices` (their reports go
    into `ranks`); returns the family's summary metrics for the result
    JSON."""
    if devices and mode != "ftrl":
        from ..cli import run_devices

        rec = run_devices(model_name, cfg, devices, hook=transform_hook,
                          hist_precision=hist_precision or "bf16")
        ranks.extend(rec["ranks"])
        return _summary(family, rec)
    if family == "gbdt":
        from ..gbdt.data import GBDTIngest
        from ..gbdt.trainer import GBDTTrainer

        p = GBDTParams.from_config(cfg)
        train, test = GBDTIngest(
            p, fs=fs, transform_hook=transform_hook
        ).load()
        res = GBDTTrainer(p, device=device, fs=fs,
                          hist_precision=hist_precision).train(
            train=train, test=test)
        return {
            "trees": float(len(res.model.trees)),
            "train_loss": res.train_loss,
            **({"test_loss": res.test_loss} if res.test_loss is not None else {}),
        }
    if family == "gbst":
        from ..boost import GBSTTrainer
        from ..io.reader import DataIngest

        p = CommonParams.from_config(cfg)
        ingest = DataIngest(p, fs=fs, transform_hook=transform_hook).load()
        res = GBSTTrainer(p, model_name, fs=fs,
                          device=device).train(ingest=ingest)
        return {
            "trees": float(res.n_trees),
            "train_loss": res.train_loss,
            **({"test_loss": res.test_loss} if res.test_loss is not None else {}),
        }
    # convex families
    from ..train import HoagTrainer

    p = CommonParams.from_config(cfg)
    trainer = HoagTrainer(p, model_name, fs=fs,
                          transform_hook=transform_hook, device=device)
    if mode == "ftrl":
        from .online import ftrl_update_convex

        return ftrl_update_convex(trainer, p)
    res = trainer.train()
    return {
        "n_iter": float(res.n_iter),
        "avg_loss": res.avg_loss,
        **({"test_loss": res.test_loss} if res.test_loss is not None else {}),
    }


def retrain(
    model_name: str,
    cfg: dict,
    fs: Optional[FileSystem] = None,
    mode: Optional[str] = None,
    extra_rounds: Optional[int] = None,
    transform_hook: Optional[Callable] = None,
    candidate_hook: Optional[Callable[[str], None]] = None,
    device=None,
    hist_precision: Optional[str] = None,
    devices: Optional[List[str]] = None,
) -> RetrainResult:
    """Train a warm-started candidate on the config's (new) data, gate it
    against the incumbent, and atomically promote on pass.

    `cfg` is the parsed training config whose `model.data_path` names the
    SERVING model; `data.train.data_path` should point at the fresh data.
    The candidate trains, and the gate scores, on `device` (cuda unless
    the caller passes "cpu"); `hist_precision` picks a GBDT candidate's
    histograms (the trainer's default, bf16, when None); `devices` (more
    than one) trains a warm candidate on that many ranks.
    `candidate_hook(shadow_data_path)` runs after candidate training and
    before gating: the canary seam (tests inject a corrupted candidate
    through it). Raises RetrainRejected instead of returning a rejected
    result when YTK_CONTINUAL_STRICT=1.
    """
    family = _family(model_name)
    device = resolve_device(device)
    fs = fs or create_filesystem(str(cfg.get("fs_scheme", "local")))
    params = (
        GBDTParams.from_config(cfg) if family == "gbdt"
        else CommonParams.from_config(cfg)
    )
    # one retrain at a time per serving model: overlapping runs (e.g.
    # cron-driven) would share the same shadow path, and the second run's
    # shadow reset could hand the first run's gate a half-trained
    # candidate to promote. The lock is heartbeat-stamped and self-healing
    # (dead-owner / stale-heartbeat auto-reclaim) — a preempted retrain
    # never needs an operator to clean up after it.
    lock = RetrainLock(fs, params.model.data_path + LOCK_SUFFIX).acquire()
    obs_was_enabled = obs_enabled()
    if not obs_was_enabled:
        # the health gate reads sentinel counter deltas; collection must be
        # on for the candidate run (export stays un-configured)
        obs_configure(enabled=True)
    try:
        return _retrain_locked(
            model_name, family, params, cfg, fs, mode, extra_rounds,
            transform_hook, candidate_hook, device, hist_precision,
            lock=lock, devices=devices,
        )
    finally:
        if not obs_was_enabled:
            # scoped enable: a YTK_OBS=0 operator's embedding process must
            # not keep accumulating spans/events after the retrain returns
            obs_configure(enabled=False)
        lock.release()


def _retrain_locked(
    model_name: str,
    family: str,
    params,
    cfg: dict,
    fs: FileSystem,
    mode: Optional[str],
    extra_rounds: Optional[int],
    transform_hook: Optional[Callable],
    candidate_hook: Optional[Callable[[str], None]],
    device,
    hist_precision: Optional[str],
    lock: Optional["RetrainLock"] = None,
    devices: Optional[List[str]] = None,
) -> RetrainResult:
    t0 = time.time()
    cp = params.continual
    mode = mode or cp.mode
    if mode not in ("warm", "ftrl"):
        raise ValueError(f"continual.mode must be warm|ftrl, got {mode!r}")
    if mode == "ftrl" and family != "convex":
        raise ValueError(
            f"mode=ftrl is a convex-family online path; {model_name} "
            "retrains with mode=warm (boosting is already incremental)"
        )
    extra = cp.extra_rounds if extra_rounds is None else int(extra_rounds)
    band = cp.band if cp.band >= 0 else knobs.get_float("YTK_CONTINUAL_BAND")

    data_path = params.model.data_path
    shadow_path = data_path + SHADOW_SUFFIX
    test_paths = list(params.data.test_paths)
    incumbent = fs.exists(data_path)
    vinfo = read_version(fs, data_path)
    version = int(vinfo.get("version", 1))

    # builds below (candidate training, holdout scoring) are expected
    # work, not serving retraces: when serving runs in the same process,
    # credit them so armed CompiledScorers keep their zero-steady-state-
    # retrace contract (serve/scorer.py)
    from ..serve.scorer import compile_credit

    # ---- incumbent held-out loss (measured NOW, on the same files) ------
    incumbent_loss: Optional[float] = None
    if incumbent and test_paths:
        with compile_credit():
            incumbent_loss, _ = holdout_loss(
                create_predictor(model_name, _eval_cfg(cfg, family), fs),
                test_paths, device=device,
            )
    elif not test_paths:
        log.warning(
            "no data.test.data_path configured: the metric gate cannot "
            "compare candidate vs incumbent — promotion rides the health "
            "gate alone"
        )

    # ---- shadow warm start ----------------------------------------------
    _delete_roots(fs, shadow_path)  # stale shadow from an aborted run
    shadow_cfg = json.loads(json.dumps(cfg))  # deep copy; configs are JSON-shaped
    hocon.set_path(shadow_cfg, "model.data_path", shadow_path)
    fi_path = params.model.feature_importance_path
    if fi_path:
        # candidate training must not clobber the live importance sidecar:
        # a rejected candidate would leave it describing an ensemble that
        # never served; promoted candidates move theirs over at promote
        if fs.exists(fi_path + SHADOW_SUFFIX):
            fs.delete(fi_path + SHADOW_SUFFIX)
        hocon.set_path(
            shadow_cfg, "model.feature_importance_path",
            fi_path + SHADOW_SUFFIX,
        )
    if incumbent:
        with obs_span("continual.shadow_copy"):
            n_copied = _copy_roots(fs, data_path, shadow_path)
        log.info(
            "retrain: shadow-copied incumbent v%d (%d files) -> %s",
            version, n_copied, shadow_path,
        )
        hocon.set_path(shadow_cfg, "model.continue_train", True)
        if family == "gbdt":
            rounds = _gbdt_incumbent_rounds(fs, params) + extra
            hocon.set_path(shadow_cfg, "optimization.round_num", rounds)
            log.info("retrain: gbdt warm start -> %d total rounds", rounds)
        elif family == "gbst":
            trees = _gbst_finished_trees(fs, data_path) + extra
            hocon.set_path(shadow_cfg, "tree_num", trees)
            log.info("retrain: gbst warm start -> %d total trees", trees)
    else:
        log.info("retrain: no incumbent at %s — bootstrap training", data_path)
        hocon.set_path(shadow_cfg, "model.continue_train", False)

    health_before = health_counters()
    obs_inc("continual.retrains")
    ranks: List[dict] = []
    with obs_span("continual.train_candidate", mode=mode, model=model_name):
        with compile_credit():
            trained = _train_candidate(
                model_name, family, shadow_cfg, fs, mode, transform_hook,
                device, hist_precision, devices, ranks,
            )
    if candidate_hook is not None:
        candidate_hook(shadow_path)

    # ---- gates ----------------------------------------------------------
    candidate_loss: Optional[float] = None
    holdout_rows = 0
    if test_paths:
        with compile_credit():
            candidate_loss, holdout_rows = holdout_loss(
                create_predictor(model_name, _eval_cfg(shadow_cfg, family),
                                 fs),
                test_paths, device=device,
            )
    if lock is not None and not lock._owned():
        # this run stalled past the TTL and a peer reclaimed the lock —
        # abort before gating: the shadow may now be interleaved with the
        # peer's writes. (Residual window: writes this run issued WHILE
        # stalled can land in the peer's shadow before either side
        # notices; a plain filesystem lock cannot close that without
        # compare-and-swap, which is why the TTL defaults to 15 minutes.)
        raise RuntimeError(
            f"retrain lock {lock.path} was reclaimed by a peer during "
            "candidate training (stalled past YTK_RETRAIN_LOCK_TTL_S?); "
            "aborting before the gate — the incumbent keeps serving"
        )
    health_hits = health_delta(health_before)
    for rep in ranks:
        # the ranks' own sentinels (each rank process counts from zero)
        for k, v in rep.get("health", {}).items():
            if v > 0:
                health_hits[k] = health_hits.get(k, 0.0) + v
    # health.retrace is a serving-health signal: an in-process server's
    # retrace sentinel may fire it during this window, which is the
    # server's to report, not a fact about the candidate
    health_hits.pop("health.retrace", None)
    gate = evaluate_gates(
        candidate_loss, incumbent_loss, band, health_hits, holdout_rows,
        advisory=_fetch_drift_advisory(),
    )

    if not gate.passed:
        obs_inc("continual.rejected")
        obs_event(
            "continual.rejected",
            model=model_name,
            reasons="; ".join(gate.reasons),
            candidate_loss=gate.candidate_loss,
            incumbent_loss=gate.incumbent_loss,
        )
        log.warning(
            "retrain REJECTED (incumbent v%d keeps serving): %s "
            "(candidate left at %s for inspection)",
            version, "; ".join(gate.reasons), shadow_path,
        )
        result = RetrainResult(
            promoted=False, version=version, gate=gate,
            model_path=data_path, shadow_path=shadow_path, mode=mode,
            trained=trained, ranks=ranks,
        )
        if knobs.get_bool("YTK_CONTINUAL_STRICT"):
            raise RetrainRejected(gate)
        return result

    # ---- promote --------------------------------------------------------
    if lock is not None and not lock._owned():
        # this run stalled past the lock TTL and a peer reclaimed it: the
        # peer may be mid-retrain on the same shadow path, so OUR candidate
        # is no longer trustworthy — abort before touching the live model
        raise RuntimeError(
            f"retrain lock {lock.path} was reclaimed by a peer during "
            "candidate training (stalled past YTK_RETRAIN_LOCK_TTL_S?); "
            "aborting before promotion — the incumbent keeps serving"
        )
    new_version = version + 1 if incumbent else version
    with obs_span("continual.promote", version=new_version):
        archives = [int(v) for v in vinfo.get("archives", [])]
        if incumbent:
            archive_base = f"{data_path}.v{version}"
            _delete_roots(fs, archive_base)
            _copy_roots(fs, data_path, archive_base)
            archives.append(version)
            keep = max(int(knobs.get_int("YTK_CONTINUAL_KEEP")), 0)
            while len(archives) > keep:
                _delete_roots(fs, f"{data_path}.v{archives.pop(0)}")
        n_moved = _promote_roots(fs, shadow_path, data_path)
        if fi_path and fs.exists(fi_path + SHADOW_SUFFIX):
            _replace_file(fs, fi_path + SHADOW_SUFFIX, fi_path)
        _write_version(fs, data_path, {
            "version": new_version,
            "promoted_at": time.time(),
            "mode": mode,
            "model": model_name,
            "candidate_loss": gate.candidate_loss,
            "incumbent_loss": gate.incumbent_loss,
            "band": band,
            "archives": archives,
        })
    obs_inc("continual.promoted")
    obs_event(
        "continual.promoted",
        model=model_name,
        version=new_version,
        files=n_moved,
        candidate_loss=gate.candidate_loss,
        incumbent_loss=gate.incumbent_loss,
        wall_s=round(time.time() - t0, 3),
    )
    log.info(
        "retrain PROMOTED v%d -> v%d (%d files, held-out %s vs %s) in %.1fs",
        version, new_version, n_moved,
        f"{gate.candidate_loss:.6f}" if gate.candidate_loss is not None else "n/a",
        f"{gate.incumbent_loss:.6f}" if gate.incumbent_loss is not None else "n/a",
        time.time() - t0,
    )
    return RetrainResult(
        promoted=True, version=new_version, gate=gate,
        model_path=data_path, shadow_path=shadow_path, mode=mode,
        trained=trained, ranks=ranks,
    )


def rollback(
    model_name: str, cfg: dict, fs: Optional[FileSystem] = None
) -> RetrainResult:
    """Disk-level undo of the newest promotion: restore the latest
    `<data_path>.v<N>` archive over the live path (atomic per-file
    replaces) and stamp the version sidecar — the serving watcher picks
    the restored incumbent up like any promotion. Complements the
    in-memory `ModelRegistry.rollback()` hook, which undoes a bad swap
    without touching disk."""
    family = _family(model_name)
    fs = fs or create_filesystem(str(cfg.get("fs_scheme", "local")))
    params = (
        GBDTParams.from_config(cfg) if family == "gbdt"
        else CommonParams.from_config(cfg)
    )
    data_path = params.model.data_path
    vinfo = read_version(fs, data_path)
    archives = [int(v) for v in vinfo.get("archives", [])]
    if not archives:
        raise FileNotFoundError(
            f"no archived versions next to {data_path} — nothing to roll "
            "back to (archives are written at promotion time)"
        )
    target = archives.pop()
    archive_base = f"{data_path}.v{target}"
    with obs_span("continual.rollback", version=target):
        n = _restore_roots(fs, archive_base, data_path)
        _write_version(fs, data_path, {
            "version": target,
            "promoted_at": time.time(),
            "mode": str(vinfo.get("mode", "warm")),
            "model": model_name,
            "rolled_back_from": int(vinfo.get("version", target + 1)),
            "archives": archives,
        })
    obs_inc("continual.rollbacks")
    obs_event(
        "continual.rollback", model=model_name,
        from_version=int(vinfo.get("version", target + 1)), to_version=target,
    )
    log.warning(
        "retrain ROLLBACK: restored v%d over %s (%d files)",
        target, data_path, n,
    )
    return RetrainResult(
        promoted=False, version=target, model_path=data_path,
        mode=str(vinfo.get("mode", "warm")), rolled_back=True,
    )
