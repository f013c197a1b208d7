"""The port's resilience layer (ytklearn_tpu_torch/resilience) against the
JAX package's (tests/test_resilience.py:104-523, for what the port has).

Chaos: the spec grammar, counter-based draws, prefix matches and their
counters; `site_draw` and the retry delays equal the JAX package's on a
grid of (seed, site, n). Retry: recovery, backoff, fatal errors not
retried, the giveup budget, `retry_lines` resuming mid-stream without a
double yield; `read_lines`, the `atomic_open` commit and the native
parser's byte read under injected faults; transient ingest faults at the
default budget giving zero run failures and the unfaulted ingest. The
guard: SIGTERM deferred, a second SIGINT escalates, inert off the main
thread. Then the preemption contract, each through `cli.train_main(...
"--device", "cpu")`: the GBDT device engine at bf16 (the CLI's default)
and at int8, the kill -9 stand-in in a subprocess, the host engine, a
convex family and GBST, each preempted and resumed with `--resume auto`
to the uninterrupted run's dump, and `--max-restarts 1` recovering from
one injected error.
"""

import hashlib
import math
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import resilience as jres
from ytklearn_tpu_torch import resilience
from ytklearn_tpu_torch.cli import train_main
from ytklearn_tpu_torch.resilience import (
    ChaosError,
    ChaosOSError,
    Preempted,
    PreemptionGuard,
    RetryPolicy,
    chaos_point,
    is_transient,
    parse_chaos_spec,
    reset_chaos,
    retry_call,
    retry_lines,
    site_draw,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_chaos(monkeypatch):
    """Every test starts disarmed, with fresh counters and fast backoff."""
    monkeypatch.delenv("YTK_CHAOS", raising=False)
    monkeypatch.setenv("YTK_RETRY_BASE_S", "0.001")
    monkeypatch.setenv("YTK_RETRY_MAX_S", "0.01")
    reset_chaos()
    resilience.reset_counters()
    yield
    reset_chaos()
    resilience.reset_counters()


def _write_rows(path, n, seed, nonlinear=False):
    r = np.random.RandomState(seed)
    w = np.random.RandomState(7).randn(8)
    with open(path, "w") as f:
        for _ in range(n):
            x = r.randn(8)
            s = x @ w
            if nonlinear:
                s += 1.5 * x[0] * x[1] - abs(x[2])
            y = int(r.rand() < 1.0 / (1.0 + math.exp(-s)))
            f.write("1###%d###%s\n" % (
                y, ",".join(f"c{i}:{x[i]:.5f}" for i in range(8))))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("resilience_data")
    _write_rows(d / "lin.train", 300, 1)
    _write_rows(d / "g.train", 350, 3, nonlinear=True)
    return d


def _gbdt_conf(data_dir, tmp_path, model, dump_freq=2, rounds=5, extra=""):
    p = tmp_path / f"{model}.conf"
    p.write_text(
        f'data {{ train {{ data_path = "{data_dir / "g.train"}" }} '
        "max_feature_dim = 8 }\n"
        f'model {{ data_path = "{tmp_path / model}" '
        f"dump_freq = {dump_freq} }}\n"
        f"optimization {{ round_num = {rounds}, max_depth = 3, "
        f"loss_function = sigmoid, regularization {{ learning_rate = 0.3 }}"
        f" {extra} }}\n"
    )
    return str(p)


def _sha(path) -> str:
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def _train(args, capsys):
    rc = train_main(args + ["--device", "cpu"])
    capsys.readouterr()
    return rc


# ---------------------------------------------------------------------------
# chaos: the spec grammar and the counter-based draws
# ---------------------------------------------------------------------------


def test_chaos_spec_grammar():
    rules = parse_chaos_spec("io.read:oserror:0.5:7,gbdt.sync:sigterm:1:0")
    assert [r.site for r in rules] == ["io.read", "gbdt.sync"]
    assert rules[0].kind == "oserror" and rules[0].rate == 0.5
    with pytest.raises(ValueError, match="kind"):
        parse_chaos_spec("io.read:explode:0.5:7")
    with pytest.raises(ValueError, match="rate"):
        parse_chaos_spec("io.read:oserror:1.5:7")
    with pytest.raises(ValueError, match="site:kind:rate:seed"):
        parse_chaos_spec("io.read:oserror:0.5")
    # the same catalog and kinds as the JAX package's
    assert resilience.FAULT_SITES.keys() == jres.FAULT_SITES.keys()
    assert resilience.KINDS == jres.KINDS


def test_chaos_draws_are_deterministic_and_counter_based(monkeypatch):
    assert site_draw(7, "io.read", 3) == site_draw(7, "io.read", 3)
    assert site_draw(7, "io.read", 3) != site_draw(7, "io.read", 4)
    assert site_draw(8, "io.read", 3) != site_draw(7, "io.read", 3)
    monkeypatch.setenv("YTK_CHAOS", "io.read:oserror:0.5:7")

    def schedule(n):
        out = []
        for _ in range(n):
            try:
                chaos_point("io.read")
                out.append(False)
            except ChaosOSError:
                out.append(True)
        return out

    first = schedule(32)
    assert any(first) and not all(first)
    reset_chaos()
    assert schedule(32) == first
    assert first == [site_draw(7, "io.read", n + 1) < 0.5 for n in range(32)]


def test_site_draw_and_retry_delays_equal_the_reference():
    sites = ["io.read", "io.dump", "gbdt.sync", "serve.load", "x", ""]
    for seed in (0, 1, 7, 0x5EED, 2 ** 40 + 3, -1):
        for site in sites:
            for n in (1, 2, 3, 17, 1000, 2 ** 33):
                assert site_draw(seed, site, n) == jres.site_draw(seed, site,
                                                                  n)
    for kw in ({}, {"max_attempts": 9, "base_s": 0.1, "max_s": 10.0},
               {"base_s": 0.003, "max_s": 0.02, "multiplier": 3.0}):
        mine, ref = RetryPolicy(**kw), jres.RetryPolicy(**kw)
        for site in sites:
            for k in range(1, 12):
                assert mine.delay_s(k, site) == ref.delay_s(k, site)


def test_chaos_malformed_spec_raises_every_call(monkeypatch):
    monkeypatch.setenv("YTK_CHAOS", "io.read:explode:1:0")
    with pytest.raises(ValueError, match="kind"):
        chaos_point("io.read")
    with pytest.raises(ValueError, match="kind"):
        chaos_point("io.read")


def test_chaos_prefix_match_and_evidence(monkeypatch):
    monkeypatch.setenv("YTK_CHAOS", "io.*:oserror:1:0")
    with pytest.raises(ChaosOSError):
        chaos_point("io.dump")
    chaos_point("serve.load")  # no match: no injection
    snap = resilience.counters()
    assert snap.get("chaos.injected") == 1
    assert snap.get("chaos.injected.io.dump") == 1
    assert "chaos.injected.serve.load" not in snap


# ---------------------------------------------------------------------------
# retry: classification, backoff, budget
# ---------------------------------------------------------------------------


def test_retry_recovers_transient(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_call(flaky, site="t.flaky") == "ok"
    assert len(calls) == 3 and len(sleeps) == 2
    assert all(s > 0 for s in sleeps)
    snap = resilience.counters()
    assert snap["io.retry.attempts"] == 2
    assert snap["io.retry.t.flaky"] == 2
    assert snap["io.retry.recovered"] == 1


def test_retry_backoff_is_deterministic():
    p = RetryPolicy(max_attempts=5, base_s=0.1, max_s=10.0)
    d = [p.delay_s(k, "x") for k in range(1, 5)]
    assert d == [p.delay_s(k, "x") for k in range(1, 5)]
    for got, r in zip(d, [0.1, 0.2, 0.4, 0.8]):
        assert 0.5 * r <= got < r  # jittered into [0.5, 1.0)x
    assert p.delay_s(40, "x") < 10.0  # capped


def test_retry_fatal_not_retried(monkeypatch):
    sleeps = []
    monkeypatch.setattr(time, "sleep", lambda s: sleeps.append(s))
    for exc in (FileNotFoundError("gone"), ValueError("bug"),
                ChaosError("fatal-injected")):
        calls = []

        def fail(_e=exc):
            calls.append(1)
            raise _e

        with pytest.raises(type(exc)):
            retry_call(fail, site="t.fatal")
        assert len(calls) == 1 and sleeps == []
    assert not is_transient(ChaosError("x"))
    assert is_transient(ChaosOSError(5, "x"))
    assert is_transient(EOFError()) and not is_transient(PermissionError())


def test_retry_gives_up_at_budget(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    monkeypatch.setenv("YTK_RETRY_MAX", "3")
    calls = []

    def always():
        calls.append(1)
        raise OSError("still down")

    with pytest.raises(OSError, match="still down"):
        retry_call(always, site="t.giveup")
    assert len(calls) == 3
    assert resilience.counters()["io.retry.giveup"] == 1


def test_retry_lines_resumes_mid_stream_without_double_yield(monkeypatch):
    monkeypatch.setattr(time, "sleep", lambda s: None)
    opens = []

    class FlakyFile:
        def __init__(self, fail_after):
            self.lines = ["a\n", "b\n", "c\n", "d\n"]
            self.fail_after = fail_after
            self.i = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.i == self.fail_after:
                raise OSError("mid-read reset")
            if self.i >= len(self.lines):
                raise StopIteration
            self.i += 1
            return self.lines[self.i - 1]

        def close(self):
            pass

    def open_fn():
        opens.append(1)
        return FlakyFile(fail_after=2 if len(opens) == 1 else None)

    assert list(retry_lines(open_fn, site="t.stream")) == [
        "a\n", "b\n", "c\n", "d\n"]
    assert len(opens) == 2
    assert resilience.counters()["io.retry.recovered"] == 1


# ---------------------------------------------------------------------------
# the seams: read_lines, atomic_open, the native byte read, a whole ingest
# ---------------------------------------------------------------------------


def test_read_lines_retries_chaos_faults(tmp_path, monkeypatch):
    from ytklearn_tpu_torch.io.fs import LocalFileSystem

    p = tmp_path / "x.txt"
    p.write_text("a\nb\nc")
    monkeypatch.setenv("YTK_CHAOS", "io.read:oserror:0.5:3")
    assert list(LocalFileSystem().read_lines([str(p)])) == ["a", "b", "c"]
    snap = resilience.counters()
    assert snap["chaos.injected.io.read"] >= 1
    assert snap["io.retry.io.read"] == snap["chaos.injected.io.read"]


def test_atomic_open_commit_retries(tmp_path, monkeypatch):
    from ytklearn_tpu_torch.io.fs import LocalFileSystem

    # a seed that injects on the first commit draw and passes the second
    seed = next(s for s in range(1000)
                if site_draw(s, "io.dump", 1) < 0.6
                and site_draw(s, "io.dump", 2) >= 0.6)
    monkeypatch.setenv("YTK_CHAOS", f"io.dump:oserror:0.6:{seed}")
    target = tmp_path / "m.txt"
    with LocalFileSystem().atomic_open(str(target)) as f:
        f.write("payload")
    assert target.read_text() == "payload"
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    assert resilience.counters()["io.retry.recovered"] == 1


def test_atomic_open_giveup_leaves_the_old_model_and_no_temp(tmp_path,
                                                             monkeypatch):
    from ytklearn_tpu_torch.io.fs import LocalFileSystem

    target = tmp_path / "m.txt"
    target.write_text("old")
    monkeypatch.setenv("YTK_CHAOS", "io.dump:oserror:1:0")
    with pytest.raises(ChaosOSError):
        with LocalFileSystem().atomic_open(str(target)) as f:
            f.write("new")
    assert target.read_text() == "old"
    assert os.listdir(tmp_path) == ["m.txt"]
    assert resilience.counters()["io.retry.giveup"] == 1


def test_native_byte_read_retries_chaos_faults(data_dir, monkeypatch):
    from ytklearn_tpu_torch.io import native
    from ytklearn_tpu_torch.io.fs import LocalFileSystem

    if not native.native_available():
        pytest.skip("g++ could not build the native parser here")
    fs = LocalFileSystem()
    paths = [str(data_dir / "g.train"), str(data_dir / "lin.train")]
    clean = native.parse_paths(fs, paths)
    seed = next(s for s in range(1000)
                if site_draw(s, "io.read", 1) < 0.5
                and site_draw(s, "io.read", 2) >= 0.5)
    monkeypatch.setenv("YTK_CHAOS", f"io.read:oserror:0.5:{seed}")
    got = native.parse_paths(fs, paths)
    for f in ("weights", "label_ptr", "labels", "row_ptr", "feat_ids",
              "feat_vals"):
        assert np.array_equal(getattr(got, f), getattr(clean, f)), f
    assert got.names == clean.names
    snap = resilience.counters()
    assert snap["chaos.injected.io.read"] >= 1
    assert snap["io.retry.io.read"] == snap["chaos.injected.io.read"]


@pytest.mark.parametrize("parser", ["native", "python"])
def test_transient_ingest_faults_zero_run_failures(data_dir, tmp_path,
                                                   monkeypatch, capsys,
                                                   parser):
    """Injected transient IO faults at the default retry budget: zero run
    failures, and the ingest equals the unfaulted one."""
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.config.params import GBDTParams
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest

    if parser == "python":
        monkeypatch.setenv("YTK_NO_NATIVE", "1")
    conf = _gbdt_conf(data_dir, tmp_path, "m", rounds=2)
    p = GBDTParams.from_config(hocon.load(conf))
    clean, _ = GBDTIngest(p).load()
    monkeypatch.setenv("YTK_CHAOS", "io.read:oserror:0.5:3")
    faulted, _ = GBDTIngest(p).load()
    assert np.array_equal(faulted.X, clean.X, equal_nan=True)
    assert np.array_equal(faulted.y, clean.y)
    assert faulted.feature_names == clean.feature_names
    assert _train(["gbdt", conf], capsys) == 0
    assert (tmp_path / "m").exists()
    snap = resilience.counters()
    assert snap.get("chaos.injected.io.read", 0) >= 1
    assert snap["io.retry.io.read"] == snap["chaos.injected.io.read"]
    assert "io.retry.giveup" not in snap


# ---------------------------------------------------------------------------
# the preemption guard
# ---------------------------------------------------------------------------


def test_guard_defers_sigterm_and_raises_at_boundary():
    g = PreemptionGuard().install()
    try:
        assert not g.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.triggered and g.signum == signal.SIGTERM
        with pytest.raises(Preempted) as ei:
            g.preempt("/tmp/ckpt")
        assert ei.value.exit_code == 143
        assert "/tmp/ckpt" in str(ei.value)
    finally:
        g.uninstall()
    assert signal.getsignal(signal.SIGTERM) != g._handler
    assert resilience.counters()["preempt.exits"] == 1


def test_guard_second_sigint_escalates():
    prev = signal.signal(signal.SIGINT, signal.default_int_handler)
    g = PreemptionGuard().install()
    try:
        os.kill(os.getpid(), signal.SIGINT)
        assert g.triggered and g.signum == signal.SIGINT
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)
    finally:
        g.uninstall()
        signal.signal(signal.SIGINT, prev)


def test_guard_inert_off_main_thread():
    out = {}

    def run():
        g = PreemptionGuard().install()
        out["installed"] = g.installed
        out["triggered"] = g.triggered
        g.uninstall()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert out == {"installed": False, "triggered": False}


def test_preempt_knob_off_keeps_the_handlers(monkeypatch):
    from ytklearn_tpu_torch.resilience import preemption_guard

    monkeypatch.setenv("YTK_PREEMPT", "0")
    before = signal.getsignal(signal.SIGTERM)
    with preemption_guard() as g:
        assert g is None
        assert signal.getsignal(signal.SIGTERM) == before


# ---------------------------------------------------------------------------
# the preemption contract through cli train
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gbdt_baseline(data_dir, tmp_path_factory):
    """The uninterrupted run (bf16, the CLI's default): the oracle."""
    d = tmp_path_factory.mktemp("gbdt_base")
    conf = _gbdt_conf(data_dir, d, "base")
    assert train_main(["gbdt", conf, "--device", "cpu"]) == 0
    return _sha(d / "base")


def test_gbdt_sigterm_resume_bit_identical(data_dir, tmp_path, monkeypatch,
                                           gbdt_baseline, capsys):
    conf = _gbdt_conf(data_dir, tmp_path, "pre")
    monkeypatch.setenv("YTK_CHAOS", "gbdt.sync:sigterm:1:0")
    assert _train(["gbdt", conf], capsys) == 143
    assert (tmp_path / "pre").exists()  # the emergency checkpoint
    assert _sha(tmp_path / "pre") != gbdt_baseline  # partial
    monkeypatch.delenv("YTK_CHAOS")
    reset_chaos()
    assert _train(["gbdt", conf, "--resume", "auto"], capsys) == 0
    assert _sha(tmp_path / "pre") == gbdt_baseline


def test_gbdt_int8_sigterm_resume_bit_identical(data_dir, tmp_path,
                                                monkeypatch):
    """The same at int8, through GBDTTrainer and continue_train."""
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.config.params import GBDTParams
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    def params(name, resume=False):
        p = GBDTParams.from_config(hocon.load(
            _gbdt_conf(data_dir, tmp_path, name, rounds=6)))
        p.model.continue_train = resume
        return p

    GBDTTrainer(params("whole"), device="cpu", hist_precision="int8").train()
    monkeypatch.setenv("YTK_CHAOS", "gbdt.sync:sigterm:1:0")
    with pytest.raises(Preempted) as ei:
        GBDTTrainer(params("cut"), device="cpu",
                    hist_precision="int8").train()
    assert ei.value.exit_code == 143
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    assert len(GBDTModel.loads((tmp_path / "cut").read_text()).trees) == 1
    monkeypatch.delenv("YTK_CHAOS")
    reset_chaos()
    res = GBDTTrainer(params("cut", True), device="cpu",
                      hist_precision="int8").train()
    assert [r["round"] for r in res.round_log] == [1, 2, 3, 4, 5]
    assert (tmp_path / "cut").read_bytes() == (tmp_path / "whole").read_bytes()


def test_gbdt_kill9_resume_bit_identical(data_dir, tmp_path, gbdt_baseline,
                                         capsys):
    """kind=kill os._exit(137)s a subprocess with no handlers and no
    atexit: only the dump_freq checkpoint survives, and --resume auto
    still ends on the uninterrupted run's dump."""
    conf = _gbdt_conf(data_dir, tmp_path, "k9", dump_freq=1)
    env = dict(os.environ)
    env.update({"YTK_CHAOS": "gbdt.sync:kill:1:0",
                "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", "")})
    proc = subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli", "train", "gbdt",
         conf, "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert (tmp_path / "k9").exists()
    assert _train(["gbdt", conf, "--resume", "auto"], capsys) == 0
    assert _sha(tmp_path / "k9") == gbdt_baseline


def test_host_engine_preempt_resume_bit_identical(data_dir, tmp_path,
                                                  monkeypatch, capsys):
    """The host engine (precise LAD under l1, reached by engine="auto"):
    a SIGTERM at the first dump_freq commit exits 143 at the next round
    start; --resume auto ends on the uninterrupted run's dump (rates 1)."""
    extra = "loss_function = l1, lad_refine_appr = false, " \
            "tree_grow_policy = loss, max_leaf_cnt = 6"
    base = _gbdt_conf(data_dir, tmp_path, "hwhole", dump_freq=1, rounds=4,
                      extra=extra)
    assert _train(["gbdt", base], capsys) == 0
    conf = _gbdt_conf(data_dir, tmp_path, "hcut", dump_freq=1, rounds=4,
                      extra=extra)
    monkeypatch.setenv("YTK_CHAOS", "io.dump:sigterm:1:0")
    assert _train(["gbdt", conf], capsys) == 143
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel

    assert len(GBDTModel.loads((tmp_path / "hcut").read_text()).trees) == 1
    monkeypatch.delenv("YTK_CHAOS")
    reset_chaos()
    assert _train(["gbdt", conf, "--resume", "auto"], capsys) == 0
    assert _sha(tmp_path / "hcut") == _sha(tmp_path / "hwhole")


def _lin_conf(data_dir, tmp_path, dump_freq=1, iters=6):
    conf = tmp_path / "lin.conf"
    conf.write_text(
        f'data {{ train {{ data_path = "{data_dir / "lin.train"}" }} }}\n'
        f'model {{ data_path = "{tmp_path / "m"}" dump_freq = {dump_freq} }}'
        "\n"
        'loss { loss_function = "sigmoid" }\n'
        "optimization { line_search { lbfgs { convergence "
        f"{{ max_iter = {iters} }} }} }} }}\n")
    return str(conf)


def test_convex_preempt_and_resume(data_dir, tmp_path, monkeypatch, capsys):
    """SIGTERM at the dump_freq=1 checkpoint's commit: the next iteration
    callback dumps the weights and exits 143; --resume auto warm-starts
    from them and completes."""
    conf = _lin_conf(data_dir, tmp_path)
    monkeypatch.setenv("YTK_CHAOS", "io.dump:sigterm:1:0")
    assert _train(["linear", conf], capsys) == 143
    assert (tmp_path / "m").exists()
    monkeypatch.delenv("YTK_CHAOS")
    reset_chaos()
    assert _train(["linear", conf, "--resume", "auto"], capsys) == 0


def _gbst_conf(tmp_path, name):
    from ytklearn_tpu_torch.scripts.convex_synth import write_gbst_case

    import json

    d = tmp_path / name
    d.mkdir()
    cfg = write_gbst_case(str(d), 300, 100, 3, K=4, tree_num=3, vocab=60,
                          max_iter=3)
    conf = d / "gbst.conf"
    conf.write_text(json.dumps(cfg))
    return str(conf), cfg["model"]["data_path"]


def _gbst_texts(path):
    out = {}
    for root, _dirs, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            out[os.path.relpath(full, path)] = open(full, "rb").read()
    return out


def test_gbst_preempt_resume_tree_texts_identical(tmp_path, monkeypatch,
                                                  capsys):
    """gbmlr: a SIGTERM at the first tree's dump commit exits 143 at the
    next tree boundary; --resume auto finishes at the uninterrupted run's
    tree texts, byte for byte."""
    conf_a, model_a = _gbst_conf(tmp_path, "whole")
    assert _train(["gbmlr", conf_a], capsys) == 0
    conf_b, model_b = _gbst_conf(tmp_path, "cut")
    monkeypatch.setenv("YTK_CHAOS", "io.dump:sigterm:1:0")
    assert _train(["gbmlr", conf_b], capsys) == 143
    with open(os.path.join(model_b, "tree-info")) as f:
        assert "finished_tree_num:1\n" in f.read()
    monkeypatch.delenv("YTK_CHAOS")
    reset_chaos()
    assert _train(["gbmlr", conf_b, "--resume", "auto"], capsys) == 0
    a, b = _gbst_texts(model_a), _gbst_texts(model_b)
    assert sorted(a) == sorted(b) and len(a) >= 4
    assert a == b


def test_max_restarts_recovers_from_one_injected_error(data_dir, tmp_path,
                                                       monkeypatch,
                                                       gbdt_baseline,
                                                       capsys):
    """One fatal injected error at the third loss read (draws 1, 2 and
    4-40 pass): the restart resumes from the round-2 dump and ends on the
    uninterrupted run's dump; without --max-restarts the error surfaces."""
    rate = 0.05
    seed = next(s for s in range(20000)
                if site_draw(s, "gbdt.sync", 3) < rate
                and all(site_draw(s, "gbdt.sync", n) >= rate
                        for n in [1, 2] + list(range(4, 41))))
    conf = _gbdt_conf(data_dir, tmp_path, "mr", dump_freq=1)
    monkeypatch.setenv("YTK_CHAOS", f"gbdt.sync:error:{rate}:{seed}")
    assert _train(["gbdt", conf, "--max-restarts", "1"], capsys) == 0
    assert _sha(tmp_path / "mr") == gbdt_baseline
    assert resilience.counters()["chaos.injected"] == 1
    reset_chaos()
    os.unlink(tmp_path / "mr")
    with pytest.raises(ChaosError):
        _train(["gbdt", conf], capsys)


def test_sticky_cuda_errors_are_not_restarted(monkeypatch, capsys, data_dir,
                                              tmp_path):
    """An error that poisons the CUDA context is re-raised at the first
    attempt, whatever --max-restarts says; another error is retried."""
    from ytklearn_tpu_torch import cli

    calls = []

    def failing(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(cli, "_train_once", failing)
    conf = _gbdt_conf(data_dir, tmp_path, "st")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        _train(["gbdt", conf, "--max-restarts", "3"], capsys)
    assert len(calls) == 1
    assert cli.is_sticky_cuda_error(RuntimeError(
        "hist launch failed: CUDA error 710 (device-side assert triggered)"))
    assert not cli.is_sticky_cuda_error(RuntimeError("CUDA out of memory"))


def test_trainer_guard_installs_the_recorder_first(monkeypatch, tmp_path):
    """trainer_guard installs the flight recorder's hooks before the
    preemption guard (with obs collecting), so the guard hands SIGTERM
    back to the recorder at train end; the evidence lands in the obs
    registry and ring, and a preemption writes a flight dump."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import recorder
    from ytklearn_tpu_torch.resilience import Preempted, trainer_guard

    monkeypatch.setenv("YTK_PREEMPT", "1")
    monkeypatch.setenv("YTK_FLIGHT_DIR", str(tmp_path))
    recorder.uninstall()  # whatever an earlier test left installed
    was = obs.enabled()
    obs.configure(enabled=True)
    before = signal.getsignal(signal.SIGTERM)
    trainer = type("T", (), {})()
    try:
        with pytest.raises(Preempted):
            with trainer_guard(trainer) as guard:
                assert recorder.installed()
                assert signal.getsignal(signal.SIGTERM) == guard._handler
                os.kill(os.getpid(), signal.SIGTERM)
                assert guard.triggered
                guard.preempt(str(tmp_path / "ckpt"), rounds=1)
        assert signal.getsignal(signal.SIGTERM) == \
            recorder._sigterm_handler
        assert resilience.counters() == {"preempt.exits": 1}
        names = [e["name"] for e in obs.REGISTRY.ring]
        assert "preempt.checkpoint" in names
        assert recorder.last_dump_path().startswith(str(tmp_path))
    finally:
        recorder.uninstall()
        recorder._state.dir = None
        obs.configure(enabled=was)
    assert signal.getsignal(signal.SIGTERM) == before
