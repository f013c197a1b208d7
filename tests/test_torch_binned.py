"""The port's binned serving rung (bin tables, K7's plain version and the
binned CompiledScorer, device="cpu") against the JAX package.

Models: two trained by the port's trainer on seeded data, with their
`.bins.json` sidecars (32 and 400 bins: uint8 and uint16 edge tables),
and one seeded random ensemble with more than 254 distinct split values on
a feature (a uint16 thresholds table). With the sidecar removed, or when
it was dumped for another model text, the table comes from the ensemble's
own split values (thresholds mode).

Everything here is exact: the tables, the row bins and the packed nodes
equal the JAX package's; binned_walk_plain equals the JAX XLA walk
(make_binned_xla) and the Pallas kernel body under the interpreter bit for
bit; in thresholds mode the binned scorer equals GBDTPredictor.batch_scores
bit for bit (rows exactly on split values included), and in edges mode the
JAX binned scorer (rows exactly on split midpoints included, which route
right where the float walk routes left).
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from serve_models import request_rows
from ytklearn_tpu.gbdt import binning as jbinning
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.predict import create_predictor as jax_create_predictor
from ytklearn_tpu.serve import CompiledScorer as JaxScorer
from ytklearn_tpu.serve import kernels as jk
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt import binning
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.tree import GBDTModel, Tree
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.predict import create_predictor
from ytklearn_tpu_torch.serve import CompiledScorer, kernels

F = 4
NAMES = [f"f{i}" for i in range(F)]
LADDER = (4, 32)


def _train(tmp, max_cnt):
    rng = np.random.RandomState(max_cnt)
    n = 8192
    X = rng.randn(n, F).astype(np.float32)
    X[rng.rand(n, F) < 0.05] = np.nan  # missing: filled with 0 (value@0)
    Xf = np.nan_to_num(X)
    y = ((Xf[:, 0] * Xf[:, 1] + np.sin(2 * Xf[:, 2]) + rng.randn(n) * 0.5)
         > 0).astype(np.float32)
    path = str(tmp / f"m{max_cnt}.model")
    p = GBDTParams(round_num=6, max_depth=6, max_leaf_cnt=15,
                   tree_grow_policy="loss", learning_rate=0.3,
                   min_child_hessian_sum=1.0,
                   approximate=[ApproximateSpec(max_cnt=max_cnt)],
                   model=ModelParams(data_path=path, dump_freq=0))
    GBDTTrainer(p, device="cpu", hist_precision="int8").train(
        GBDTData(Xf, y, np.ones(n, np.float32), n, NAMES,
                 missing_fill=np.zeros(F, np.float32)))
    return path


def _random_model(tmp, n_trees=150, depth=3):
    """A seeded ensemble whose split values are many and distinct."""
    rng = np.random.RandomState(7)
    trees = []
    for _ in range(n_trees):
        t = Tree()

        def grow(nid, d):
            if d >= depth:
                t.leaf_value[nid] = float(rng.randn() * 0.1)
                return
            t.feat[nid] = 0
            t.feat_name[nid] = NAMES[rng.randint(2)]
            t.split[nid] = float(np.float32(rng.randn()))
            t.default_left[nid] = bool(rng.rand() < 0.5)
            left, right = t.add_children(nid)
            grow(left, d + 1)
            grow(right, d + 1)

        grow(0, 0)
        trees.append(t)
    path = tmp / "random.model"
    path.write_text(GBDTModel(base_prediction=0.25, trees=trees).dumps())
    return str(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("binned")
    out = {"edges-u8": _train(tmp, 32), "edges-u16": _train(tmp, 400),
           "thresholds-u8": str(tmp / "copy.model"),
           "thresholds-u16": _random_model(tmp)}
    shutil.copy(out["edges-u8"], out["thresholds-u8"])  # without its sidecar
    return out


def _preds(path):
    cfg = {"model": {"data_path": path},
           "optimization": {"loss_function": "sigmoid", "round_num": 1000}}
    return create_predictor("gbdt", cfg), jax_create_predictor("gbdt", cfg)


def _vocab(trees):
    names = sorted({t.feat_name[i] for t in trees for i in range(t.n_nodes())
                    if not t.is_leaf(i)})
    return {n: i for i, n in enumerate(names)}


def _rows(pred, vocab, rng, n=120):
    """Random rows, rows exactly on split values (on edge midpoints for a
    trained model), and rows with every feature missing."""
    splits = [(t.feat_name[i], t.split[i]) for t in pred.model.trees
              for i in range(t.n_nodes()) if not t.is_leaf(i)]
    rows = request_rows(n, rng, list(vocab), p_missing=0.1)
    for k in range(0, len(splits), max(1, len(splits) // 60)):
        name, v = splits[k]
        rows.append({**rows[k % n], name: float(v)})
    rows.append({})
    return rows


def _tables(path):
    pred, jpred = _preds(path)
    trees, jtrees = pred.model.trees, jpred.model.trees
    vocab = _vocab(trees)
    assert vocab == _vocab(jtrees)
    digest = binning.model_text_digest(open(path).read())
    edges = binning.load_bin_edges(LocalFileSystem(),
                                   binning.bin_edges_path(path), digest)
    jedges = jbinning.load_bin_edges(JFS(), jbinning.bin_edges_path(path),
                                     digest)
    assert (edges is None) == (jedges is None)
    if edges is not None:
        assert edges.keys() == jedges.keys()
        for k in edges:
            np.testing.assert_array_equal(edges[k], jedges[k])
    heap, _ = kernels.build_heap(trees, vocab)
    jheap, _ = jk.build_heap(jtrees, vocab)
    table, _ = kernels.build_bin_table(trees, vocab, edges)
    jtable, _ = jk.build_bin_table(jtrees, vocab, jedges)
    return pred, jpred, vocab, heap, jheap, table, jtable


@pytest.mark.parametrize("which", ["edges-u8", "edges-u16", "thresholds-u8",
                                   "thresholds-u16"])
def test_tables_rows_and_nodes_match_jax(models, which):
    pred, _jpred, vocab, heap, jheap, table, jtable = _tables(models[which])
    mode, dtype = which.split("-")
    assert (table.mode, str(table.dtype)) == (mode, f"uint{dtype[1:]}")
    assert (table.mode, table.dtype, table.sentinel) == \
        (jtable.mode, jtable.dtype, jtable.sentinel)
    assert len(table.values) == len(jtable.values)
    for a, b in zip(table.values, jtable.values):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(table.flat(), jtable.flat()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(kernels.pack_heap_nodes(heap, table),
                                  jk.pack_heap_nodes(jheap, jtable))
    scorer = CompiledScorer(pred, ladder=LADDER, device="cpu", warmup=False)
    X = scorer.featurize(_rows(pred, vocab, np.random.RandomState(3)))
    got = kernels.bin_rows(X, table)
    assert got.dtype == table.dtype
    np.testing.assert_array_equal(got, jk.bin_rows(X, jtable))
    assert (got == table.sentinel).any()


def _random_binned(which):
    """Seeded packed heaps past the trained models' shapes: depth 10, and
    more trees than one of the kernel's chunks; bins with the sentinel,
    bin 0 and pad slots (rank 0xFFFF, dleft 1)."""
    T, depth, dtype, sentinel = {
        "heap-d10-u8": (16, 10, np.uint8, 255),
        "heap-chunk-u16": (kernels.WALK_CHUNK_CAP + 8, 3, np.uint16, 65535),
    }[which]
    rng = np.random.RandomState(T + depth)
    H, LL, Fb, B = (1 << (depth + 1)) - 1, 1 << depth, 5, 37
    hi = 300 if dtype == np.uint16 else 250
    feat = rng.randint(0, Fb, (T, H))
    rank1 = rng.randint(0, hi + 1, (T, H))
    dleft = rng.randint(0, 2, (T, H))
    pad = rng.rand(T, H) < 0.25
    feat[pad], rank1[pad], dleft[pad] = 0, 0xFFFF, 1
    packed = (feat | (rank1 << kernels.FEAT_BITS)
              | (dleft << (kernels.FEAT_BITS + kernels.RANK_BITS))
              ).astype(np.int32)
    leaf = rng.randn(T, LL)
    leaf[-8:] = -0.0  # pad trees
    bins = rng.randint(0, hi, (B, Fb))
    bins[rng.rand(B, Fb) < 0.15] = sentinel
    bins[rng.rand(B, Fb) < 0.1] = 0
    return bins.astype(dtype), packed, leaf, depth, sentinel


@pytest.mark.parametrize("which", ["edges-u8", "thresholds-u16",
                                   "heap-d10-u8", "heap-chunk-u16"])
def test_binned_walk_plain_matches_xla_and_pallas(models, which):
    if which.startswith("heap"):
        bins, packed, leaf, depth, sentinel = _random_binned(which)
    else:
        pred, _jpred, vocab, heap, _jheap, table, _ = _tables(models[which])
        packed = kernels.pack_heap_nodes(heap, table)
        scorer = CompiledScorer(pred, ladder=LADDER, device="cpu",
                                warmup=False)
        X = scorer.featurize(_rows(pred, vocab, np.random.RandomState(4), 40))
        bins = kernels.bin_rows(X, table)
        leaf, depth, sentinel = heap.leaf, heap.depth, table.sentinel
    want = np.asarray(jk.make_binned_xla(packed, leaf, depth, sentinel)(
        jnp.asarray(bins.astype(np.int32))))
    before = kernels.binned_walk.launches
    got = kernels.binned_walk(torch.from_numpy(bins), torch.from_numpy(packed),
                              torch.from_numpy(leaf), depth, sentinel)
    assert kernels.binned_walk.launches == before  # CPU: the plain version
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), want)
    feat, rank1, dleft = (f.numpy().astype(np.int32) for f in
                          kernels.unpack_nodes(torch.from_numpy(packed)))
    pallas = np.asarray(jk.binned_scores_pallas(
        jnp.asarray(bins.astype(np.int32).T), jnp.asarray(feat),
        jnp.asarray(rank1), jnp.asarray(dleft), jnp.asarray(leaf),
        depth, sentinel, interpret=True))
    assert np.array_equal(got.numpy(), pallas)


def test_thresholds_scorer_is_bit_equal_to_batch_scores(models):
    for which in ("thresholds-u8", "thresholds-u16"):
        pred, jpred = _preds(models[which])
        scorer = CompiledScorer(pred, ladder=LADDER, mode="binned",
                                device="cpu")
        info = scorer.rung_info()
        # the CPU binned rung walks in the native library when it builds
        backend = ("binned-native" if kernels.native_serve_available()
                   else "binned-plain")
        assert (info["mode"], info["backend"], info["bin_mode"]) == \
            ("binned", backend, "thresholds")
        assert info["bin_dtype"] == ("uint8" if which.endswith("u8")
                                     else "uint16")
        assert not info["downgraded"]
        rows = _rows(pred, scorer.vocab, np.random.RandomState(5))
        s, p = scorer.score_and_predict(rows)
        assert np.array_equal(s, pred.batch_scores(rows))
        assert np.array_equal(s, jpred.batch_scores(rows))
        js, jp = JaxScorer(jpred, ladder=LADDER, mode="binned"
                           ).score_and_predict(rows)
        assert np.array_equal(s, js)
        np.testing.assert_allclose(p, jp, rtol=1e-14, atol=0)


@pytest.mark.parametrize("which", ["edges-u8", "edges-u16"])
def test_edges_scorer_equals_the_jax_binned_scorer(models, which):
    pred, jpred = _preds(models[which])
    scorer = CompiledScorer(pred, ladder=LADDER, mode="binned", device="cpu")
    info = scorer.rung_info()
    assert (info["mode"], info["bin_mode"]) == ("binned", "edges")
    js = JaxScorer(jpred, ladder=LADDER, mode="binned")
    assert js.rung_info()["bin_mode"] == "edges"
    rng = np.random.RandomState(6)
    rows = _rows(pred, scorer.vocab, rng)
    n_random = 120
    s = scorer.score_batch(rows)
    assert np.array_equal(s, js.score_batch(rows))
    # random rows sit off the midpoints: there the binned walk routes as
    # the float walk does; rows exactly on a split midpoint go right
    want = pred.batch_scores(rows)
    assert np.array_equal(s[:n_random], want[:n_random])
    assert not np.array_equal(s[n_random:], want[n_random:])


def test_sidecar_of_another_model_gives_thresholds(models, tmp_path):
    """A sidecar whose digest names another model text is refused (the
    window between the trainer's two writes): thresholds, bit-exact."""
    src = models["edges-u8"]
    path = tmp_path / "m.model"
    path.write_text(open(src).read().replace("base_prediction=",
                                             "base_prediction=1", 1))
    shutil.copy(src + ".bins.json", str(path) + ".bins.json")
    pred, jpred = _preds(str(path))
    scorer = CompiledScorer(pred, ladder=LADDER, mode="binned", device="cpu")
    assert scorer.rung_info()["bin_mode"] == "thresholds"
    assert JaxScorer(jpred, ladder=LADDER,
                     mode="binned").rung_info()["bin_mode"] == "thresholds"
    rows = _rows(pred, scorer.vocab, np.random.RandomState(8), 30)
    assert np.array_equal(scorer.score_batch(rows), pred.batch_scores(rows))
    os.remove(str(path) + ".bins.json")
    assert binning.load_bin_edges(LocalFileSystem(),
                                  str(path) + ".bins.json") is None


def test_knob_picks_the_binned_rung(models, monkeypatch):
    pred, _ = _preds(models["edges-u8"])
    monkeypatch.setenv("YTK_SERVE_BINNED", "1")
    monkeypatch.setenv("YTK_SERVE_FUSED", "1")  # binned wins
    assert CompiledScorer(pred, ladder=LADDER,
                          device="cpu").rung_info()["mode"] == "binned"


def test_binned_walk_checks_its_inputs():
    packed = torch.zeros((8, 7), dtype=torch.int32)
    packed[0, 0] = 5  # feat id 5
    leaf = torch.zeros((8, 4), dtype=torch.float64)
    bins = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="indexes past"):
        kernels.binned_walk(bins, packed, leaf, 2, 255)
    with pytest.raises(ValueError, match="sentinel"):
        kernels.binned_walk(bins, packed, leaf, 2, 65535, max_feat=3)
    with pytest.raises(ValueError, match="uint8"):
        kernels.binned_walk(bins.int(), packed, leaf, 2, 255, max_feat=3)
