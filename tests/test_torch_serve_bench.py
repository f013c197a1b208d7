"""The port's serving bench (ytklearn_tpu_torch/scripts/serve_bench.py)
against the JAX package's scripts/serve_bench.py, both with REF pointed at
a missing path (the synthetic branch):

- the synthetic model text and the request rows are the reference's byte
  for byte, at a small size and at the card's width (500 trees, depth 6);
- every rung's scores (stacked, fused, binned, as measure_rung drives
  them) are bit-equal to the JAX package's `batch_scores`;
- the binned quality band and the bf16 bands sit inside the reference's
  bands (SERVE_BINNED_BAND 1e-9, SERVE_BF16_BAND 0.1);
- a ladder rung left out of warmup, walked by a kernel whose
  instantiation is keyed on its rows, is counted as a retrace (the
  counter the sweep holds at 0 really moves);
- `--device cpu` runs of the rung matrix (with `--rungs-fleet 1`) and of
  `--fleet` write the reference's record keys plus `device`, `card`,
  `floors` and `kernel_launches`, hold every correctness field, and the
  fleet's floor is this run's single-process default rung: no
  SERVE_r09.json is opened;
- with no `--device` on a machine without a GPU every new script raises.
"""

import ast
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_threads import ONE_THREAD_ENV

from ytklearn_tpu_torch.scripts import serve_bench as port_sb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MISSING_REF = "/nonexistent/reference-tree"
LOG = logging.getLogger("test_serve_bench")


def _load_ref(name: str):
    import importlib.util

    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_sb():
    return _load_ref("serve_bench")


@pytest.fixture
def both(ref_sb, monkeypatch):
    monkeypatch.setattr(ref_sb, "REF", MISSING_REF)
    monkeypatch.setattr(port_sb, "REF", MISSING_REF)
    return ref_sb, port_sb


@pytest.mark.parametrize("trees,depth", [(20, 4), (500, 6)])
def test_synthetic_model_text_and_rows_equal_the_reference(
        both, tmp_path, monkeypatch, trees, depth):
    ref, port = both
    monkeypatch.setenv("SERVE_BENCH_TREES", str(trees))
    monkeypatch.setenv("SERVE_BENCH_DEPTH", str(depth))
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    jpred, jnames, jgen, jsrc = ref._build_model(str(tmp_path / "ref"))
    ppred, pnames, pgen, psrc = port._build_model(str(tmp_path / "port"),
                                                  "cpu")
    assert jsrc == psrc == "synthetic"
    assert list(jnames) == list(pnames)
    assert (tmp_path / "ref" / "gbdt.model").read_bytes() == \
        (tmp_path / "port" / "gbdt.model").read_bytes()
    assert len(ppred.model.trees) == trees
    rows_j = jgen(np.random.RandomState(7), 64)
    rows_p = pgen(np.random.RandomState(7), 64)
    assert json.dumps(rows_j) == json.dumps(rows_p)


@pytest.fixture
def model(both, tmp_path, monkeypatch):
    ref, port = both
    monkeypatch.setenv("SERVE_BENCH_TREES", "24")
    monkeypatch.setenv("SERVE_BENCH_DEPTH", "5")
    (tmp_path / "ref").mkdir()
    jpred, _n, _g, _s = ref._build_model(str(tmp_path / "ref"))
    ppred, _n, gen, _s = port._build_model(str(tmp_path), "cpu")
    rows = gen(np.random.RandomState(7), 600)
    return jpred, ppred, gen, rows, tmp_path


def test_every_rung_bit_equals_the_jax_batch_scores(model):
    jpred, ppred, gen, rows, _tmp = model
    want = np.asarray(jpred.batch_scores(rows[:512]))
    backends = {}
    for mode in ("default", "fused", "binned"):
        rec, scorer, got = port_sb.measure_rung(
            ppred, rows, gen, np.random.RandomState(1), mode, 0.05, LOG,
            device="cpu")
        assert np.array_equal(got, want), mode
        assert rec["bit_identical"] and not rec["downgraded"], rec
        assert rec["retraces_after_warmup"] == 0 and rec["x64"]
        backends[mode] = rec["backend"]
    assert backends["default"] == "stacked-torch"
    assert backends["fused"] == "fused-plain"
    assert backends["binned"] in ("binned-native", "binned-plain")


def test_binned_quality_and_bf16_bands_inside_the_reference_bands(model):
    _jpred, ppred, gen, rows, tmp = model
    _rec, _s, default_scores = port_sb.measure_rung(
        ppred, rows, gen, np.random.RandomState(1), "default", 0.05, LOG,
        device="cpu")
    _rec, scorer, _got = port_sb.measure_rung(
        ppred, rows, gen, np.random.RandomState(1), "binned", 0.05, LOG,
        device="cpu")
    q = port_sb.binned_quality(ppred, scorer, rows, default_scores, LOG)
    assert q["max_abs_pred_diff"] <= 1e-9 and q["stream_diverged_rows"] == 0
    assert q["boundary_rows"] > 0
    bands = port_sb.measure_bf16_bands(str(tmp), LOG, device="cpu")
    assert set(bands) == {"linear", "fm", "ffm"}
    assert all(0.0 < b <= 0.1 for b in bands.values()), bands


def test_an_unwarmed_ladder_size_counts_as_a_retrace(model, monkeypatch):
    """The fused rung's walk made to report an instantiation a row count
    (the kernels' shared launch counter, keyed on rows). With every rung
    warm, the bench traffic and the mixed-size sweep count no build; with
    rung 64 left out of warmup, the first 64-row rung is counted as one."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.cuda_build import launching
    from ytklearn_tpu_torch.obs import health
    from ytklearn_tpu_torch.serve import kernels, scorer as scorer_mod

    _jpred, ppred, gen, rows, _tmp = model
    plain = kernels.heap_walk

    def keyed_walk(name):
        def walk(X, nodes, leaf, depth, max_feat=None, plan=None):
            with launching(walk, name, int(X.shape[0])):
                return plain(X, nodes, leaf, depth, max_feat)

        walk.launches = 0
        return walk

    def fused_retraces():
        rec, _s, _g = port_sb.measure_rung(
            ppred, rows, gen, np.random.RandomState(1), "fused", 0.05, LOG,
            device="cpu")
        return rec["retraces_after_warmup"]

    was_on = obs.enabled()
    obs.configure(enabled=True)
    health.install_trace_counters()
    try:
        monkeypatch.setattr(kernels, "heap_walk", keyed_walk("warm_walk"))
        assert fused_retraces() == 0

        real_warmup = scorer_mod.CompiledScorer.warmup

        def warmup_skipping_64(self):
            ladder = self.ladder
            self.ladder = tuple(r for r in ladder if r != 64)
            try:
                real_warmup(self)
            finally:
                self.ladder = ladder

        monkeypatch.setattr(scorer_mod.CompiledScorer, "warmup",
                            warmup_skipping_64)
        monkeypatch.setattr(kernels, "heap_walk", keyed_walk("cold_walk"))
        assert fused_retraces() == 1
    finally:
        obs.configure(enabled=was_on)


def _record_keys(path: str, schema: str) -> set:
    """The string keys of the dict literal in `path` whose "schema" entry
    is `schema` (a reference record as its script builds it)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            vals = dict(zip(keys, node.values))
            v = vals.get("schema")
            if isinstance(v, ast.Constant) and v.value == schema:
                return set(keys)
    raise AssertionError(f"no {schema} record in {path}")


PORT_KEYS = {"device", "card", "floors", "kernel_launches"}


def _run(*args, timeout=300, **env_over):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "YTK_", "SERVE_"))}
    env["PYTHONPATH"] = REPO
    env.update(ONE_THREAD_ENV)
    env.update(env_over)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _floors_named(rec):
    fl = rec["floors"]
    assert all(set(f) == {"name", "value", "limit", "met"} for f in fl)
    return {f["name"] for f in fl}


def test_rung_matrix_and_rungs_fleet_on_the_cpu(tmp_path):
    out = _run("-m", "ytklearn_tpu_torch.scripts.serve_bench", "--device",
               "cpu", "--seconds", "0.2", "--rungs-fleet", "1",
               "--record", str(tmp_path / "rungs.json"),
               SERVE_BENCH_TREES="20")
    # the speed floors of a CPU run may be missed (exit 1 after the line)
    assert out.returncode in (0, 1), out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    rec = json.loads((tmp_path / "rungs.json").read_text())
    assert line == rec
    want = _record_keys(os.path.join(REPO, "scripts", "serve_bench.py"),
                        "serve_rungs") | {"fleet"}
    assert set(rec) == want | PORT_KEYS
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert set(rec["kernel_launches"]) >= {"heap_walk", "binned_walk"}
    assert not any(rec["kernel_launches"].values())
    assert _floors_named(rec) == {
        "SERVE_BENCH_MIN_SPEEDUP", "SERVE_RUNG_MIN_X",
        "best_rung_p99_over_default", "BENCH_REGRESS_TOL tracing",
        "BENCH_REGRESS_TOL quality"}
    assert [r["rung"] for r in rec["rungs"]] == ["default", "fused",
                                                 "binned"]
    for r in rec["rungs"]:
        assert r["bit_identical"] and not r["downgraded"], r
        assert r["retraces_after_warmup"] == 0 and r["x64"]
    assert rec["binned_quality"]["max_abs_pred_diff"] <= 1e-9
    assert all(b <= 0.1 for b in rec["precision_bands"].values())
    tr = rec["transform_overhead"]
    assert tr["assembled_bit_identical"] and tr["raw_retraces"] == 0
    fl = rec["fleet"]
    assert fl["replicas"] == 1 and fl["retraces_fleet"] == 0
    assert fl["batches_fleet"] > 0
    assert fl["rung_by_replica"]["0"]["mode"] == "binned"
    assert fl["front_http"]["raw_splice_requests"] > 0
    assert fl["front_http"]["raw_splice"]["errors"] == 0
    # a failure is printed only for a missed speed floor
    missed = {f["name"] for f in rec["floors"] if not f["met"]}
    fails = [ln for ln in out.stderr.splitlines() if "FAIL:" in ln]
    assert bool(fails) == bool(missed), (fails, missed)


def test_fleet_floor_is_this_runs_single_process_rung(tmp_path):
    """`--fleet` at one replica: the floor's yardstick is measured in the
    same invocation, and no SERVE_r09.json is opened (an audit hook
    records every path the process opens)."""
    opened = tmp_path / "opened.json"
    code = (
        "import json, sys\n"
        "seen = []\n"
        "sys.addaudithook(lambda e, a: seen.append(str(a[0])) "
        "if e == 'open' else None)\n"
        "from ytklearn_tpu_torch.scripts import serve_bench as sb\n"
        "try:\n"
        "    rc = sb.main(sys.argv[1:])\n"
        "finally:\n"
        f"    open({str(opened)!r}, 'w').write(json.dumps(seen))\n"
        "sys.exit(rc)\n"
    )
    out = _run("-c", code, "--fleet", "--device", "cpu", "--replicas", "1",
               "--seconds", "0.1", "--mixed-seconds", "2", "--requests",
               "256", "--window", "64", "--record",
               str(tmp_path / "fleet.json"), SERVE_BENCH_TREES="10")
    assert out.returncode in (0, 1), out.stderr[-3000:]
    rec = json.loads((tmp_path / "fleet.json").read_text())
    want = _record_keys(os.path.join(REPO, "scripts", "serve_bench.py"),
                        "serve_fleet")
    assert set(rec) == want | PORT_KEYS | {"speedup_vs_single"}
    base = rec["baseline"]
    assert base["measured"] == "this run" and base["req_per_sec"] > 0
    assert rec["speedup_vs_single"] == round(
        rec["value"] / base["req_per_sec"], 2)
    assert _floors_named(rec) == {"SERVE_FLEET_MIN_X", "slo_ms"}
    assert [s["retraces"] for s in rec["scaling"]] == [0.0]
    assert rec["mixed_traffic"]["failures"] == 0
    paths = json.loads(opened.read_text())
    assert paths and not [p for p in paths if "SERVE_r" in p]


def test_ramp_record_keys_equal_the_reference():
    """The ramp's record literal holds the reference's keys (the ramp
    itself runs on the card, in chip_smoke.py)."""
    want = _record_keys(os.path.join(REPO, "scripts", "serve_bench.py"),
                        "serve_scale")
    got = _record_keys(port_sb.__file__, "serve_scale")
    assert got == want


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
@pytest.mark.parametrize("script", ["serve_bench", "trace_drill",
                                    "drift_drill", "mesh_drill"])
def test_no_device_raises_without_a_gpu(script):
    out = _run("-m", f"ytklearn_tpu_torch.scripts.{script}", timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
