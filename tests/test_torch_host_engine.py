"""The port's GBDT host engine against the JAX package's
(`GBDTTrainer(engine="host")`, both on the CPU, on the same seeded data).

Held three ways:
- The device functions: the histogram against the reference's
  `hist_kernel` and `node_hist_kernel` at rtol 1e-6 plus 1e-6 of the
  channel's largest |sum| (the reference sums in f32, the port in float64
  rounded once) and exactly equal to the float64 sums rounded once; the position update and the tree walk exactly.
- Whole runs, one case each: level-wise and loss-wise with sigmoid,
  softmax with class_num 3, l1 with the precise LAD refine (reached
  through `engine="auto"`), `tree_maker = "feature"` under both policies,
  sample rates 0.8, a `max_depth` and a `max_leaf_cnt` cap, a missing-value
  fill. Every tree's structure, features, slots, split values and counts
  are equal; leaf values and hessians at rtol 1e-5 plus 1e-5 of the tree's
  largest, gains the same (a gain is a difference of sums, so the f32 noise
  of the sums shows relative to the tree's largest gain); each round's
  losses at rtol 1e-5 and the test AUC within 1e-5. The data has no near
  tie: every split the port's trees take is recomputed in float64 from
  its node's histogram, and it beats the runner-up by more than 1e-4
  relative, far above the f32 noise of the sums (about 1e-6), so no sum
  order can flip a choice. Both packages' model texts parse in both.
- The precise LAD refine, the reference's and the port's on the same tree,
  labels, scores and weights: the leaf values bit-equal.
Then continue_train and just_evaluate, and the reference's resume with
sampling rates below 1 (the stream restarts at round 0) in both packages.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt import trainer as jtrainer
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt import host_engine
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.gbdt.tree import GBDTModel

F = 5
NAMES = [f"f{i}" for i in range(F)]
MARGIN = 1e-4


def _data(loss, n, seed, missing=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * X[:, 3] + 0.2 * X[:, 4]
    if loss == "softmax":
        cls = (s > -0.4).astype(int) + (s > 0.6)
        y = np.eye(3, dtype=np.float32)[cls]
    elif loss == "sigmoid":
        y = (rng.rand(n) < 1 / (1 + np.exp(-2 * s))).astype(np.float32)
    else:
        y = (s + 0.3 * rng.laplace(size=n)).astype(np.float32)
    fill = None
    if missing:  # a tenth of column 1 missing, filled with value@0
        X[rng.rand(n) < 0.1, 1] = 0.0
        fill = np.zeros(F, np.float32)
    return X, y, np.ones(n, np.float32), fill


def _params(cls, spec, mcls, path, **kw):
    base = dict(round_num=3, max_depth=4, max_leaf_cnt=12, learning_rate=0.3,
                l2=1.0, min_child_hessian_sum=1e-3, eval_metric=[],
                tree_grow_policy="loss", loss_function="sigmoid")
    base.update(kw)
    return cls(approximate=[spec(max_cnt=32)],
               model=mcls(data_path=str(path), dump_freq=0), **base)


class _Recording(GBDTTrainer):
    """The port's trainer, keeping the float64 margin of each node search
    whose best split the tree takes."""

    def _splits(self, hist, feat_mask):
        out = super()._splits(hist, feat_mask)
        _chg, idx, _sl, GL, HL = out[:5]
        found = _margins(hist.numpy().astype(np.float64), feat_mask.numpy(),
                         self._cfg())
        for k, m in enumerate(found):
            self.searched[(int(idx[k]), float(GL[k]), float(HL[k]))] = m
        return out

    def _finish_split(self, tree, names, nid, fid, slot_l, slot_r, stats):
        B = self._bins_sidecar[1].max_bins
        self.margins.append(self.searched[(fid * B + slot_r,
                                           float(stats[0]),
                                           float(stats[1]))])
        return super()._finish_split(tree, names, nid, fid, slot_l, slot_r,
                                     stats)


def _margins(hist, fmask, cfg):
    """Per node: (best - runner-up) / |best| over every candidate split,
    split_kernel's rule recomputed in float64 (l1 = 0, no leaf clamp)."""
    _l1, l2, min_h, _max_abs = cfg

    def gain(G, H):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(H < min_h, 0.0, G * G / (H + l2))

    out = []  # one a node; NaN where no split gains
    for node in hist:
        G, H, C = node[..., 0], node[..., 1], node[..., 2]
        GL, HL = np.cumsum(G, 1) - G, np.cumsum(H, 1) - H
        Gt, Ht = G.sum(1, keepdims=True), H.sum(1, keepdims=True)
        ne = C > 0
        valid = ne & (np.cumsum(ne, 1) - ne > 0) & (HL >= min_h) \
            & (Ht - HL >= min_h) & fmask[:, None]
        chg = np.where(valid, gain(GL, HL) + gain(Gt - GL, Ht - HL)
                       - gain(Gt, Ht), -np.inf).ravel()
        if not np.isfinite(chg).any() or chg.max() <= 0:
            out.append(np.nan)
            continue
        best = int(np.argmax(chg))
        # an exact tie in float64 is a tie of equal sums, which both
        # packages break alike (the lowest index): the runner-up is the
        # best gain that differs
        rest = chg[chg != chg[best]]
        second = rest.max() if rest.size else -np.inf
        out.append((chg[best] - second) / abs(chg[best]))
    return out


def _run_pair(tmp, kw, ctor=None, loss=None, n=3000, missing=False,
              test=True):
    loss = kw.get("loss_function", "sigmoid") if loss is None else loss
    X, y, w, fill = _data(loss, n, 1, missing)
    Xt, yt, wt, _ = _data(loss, 1000, 2, missing)
    ctor = {"engine": "host"} if ctor is None else ctor
    jp = _params(JParams, JSpec, JModelParams, tmp / "j.model", **kw)
    pp = _params(GBDTParams, ApproximateSpec, ModelParams, tmp / "p.model",
                 **kw)
    jtr = JTrainer(jp, **ctor)
    jres = jtr.train(JData(X, y, w, n, NAMES, fill),
                     JData(Xt, yt, wt, len(Xt), NAMES, fill) if test
                     else None)
    ptr = _Recording(pp, device="cpu", **ctor)
    ptr.margins, ptr.searched = [], {}
    pres = ptr.train(GBDTData(X, y, w, n, NAMES, fill),
                     GBDTData(Xt, yt, wt, len(Xt), NAMES, fill) if test
                     else None)
    assert jtr.engine == ptr.engine == "host"
    return jres, pres, ptr


def _assert_same_trees(pt, jt):
    assert len(pt) == len(jt)
    for i, (a, b) in enumerate(zip(pt, jt)):
        for f in ("feat", "feat_name", "left", "right", "slot", "split",
                  "sample_cnt", "default_left"):
            assert getattr(a, f) == getattr(b, f), (i, f)
        for f in ("leaf_value", "hess_sum", "gain"):
            want = np.asarray(getattr(b, f))
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(getattr(a, f), want, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=f"{i} {f}")


def _assert_pair(jres, pres, ptr, tmp):
    assert ptr.margins and min(ptr.margins) > MARGIN, min(ptr.margins)
    _assert_same_trees(pres.model.trees, jres.model.trees)
    for key in ("train_loss", "test_loss"):
        got = [r.get(key) for r in pres.round_log]
        want = [r.get(key) for r in jres.round_log]
        if want[0] is not None:
            np.testing.assert_allclose(got, want, rtol=1e-5)
    assert pres.train_loss == pytest.approx(jres.train_loss, rel=1e-5)
    if "auc" in jres.test_metrics:
        assert abs(pres.test_metrics["auc"] - jres.test_metrics["auc"]) \
            <= 1e-5
    ptext = (tmp / "p.model").read_text()
    jtext = (tmp / "j.model").read_text()
    assert len(JModel.loads(ptext).trees) == len(pres.model.trees)
    assert len(GBDTModel.loads(jtext).trees) == len(jres.model.trees)


CASES = {
    "level-sigmoid": ({"tree_grow_policy": "level",
                       "eval_metric": ["auc"]}, None),
    "loss-sigmoid": ({"eval_metric": ["auc"]}, None),
    "softmax3": ({"loss_function": "softmax", "class_num": 3}, None),
    "l1-precise": ({"loss_function": "l1", "lad_refine_appr": False}, {}),
    "feature-level": ({"tree_maker": "feature", "tree_grow_policy": "level",
                       "eval_metric": ["auc"]}, {}),
    "feature-loss": ({"tree_maker": "feature"}, {}),
    "rates-0.8": ({"instance_sample_rate": 0.8, "feature_sample_rate": 0.8},
                  None),
    "max-depth": ({"max_depth": 2, "max_leaf_cnt": -1,
                   "tree_grow_policy": "level"}, None),
    "max-leaf-cnt": ({"max_depth": -1, "max_leaf_cnt": 8}, None),
    "missing-fill": ({"missing": True}, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_engine_matches_reference(tmp_path, case):
    kw, ctor = CASES[case]
    kw = dict(kw)
    missing = kw.pop("missing", False)
    jres, pres, ptr = _run_pair(tmp_path, kw, ctor, missing=missing)
    _assert_pair(jres, pres, ptr, tmp_path)
    if case == "max-depth":
        assert max(t.max_depth() for t in pres.model.trees) == 2
    if case == "max-leaf-cnt":
        assert max(t.leaf_cnt() for t in pres.model.trees) == 8
    if case == "missing-fill":
        assert not all(d for t in pres.model.trees for d in t.default_left)
    if case == "softmax3":
        assert len(pres.model.trees) == 9
    assert ptr.host_syncs > 0 and ptr.time_stats["host_syncs"] > 0


# -- the device functions -----------------------------------------------------


def _hist_inputs(seed, n=4000, B=17, nodes=6):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, F)).astype(np.int32)
    pos = rng.randint(-1, nodes, size=n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    return bins, pos, g, h


def _close(got, want):
    """rtol 1e-6 plus 1e-6 of the channel's largest |sum|: a cell whose
    f32 sum cancels keeps the absolute error of its terms."""
    for c in range(3):
        scale = float(np.abs(want[..., c]).max())
        np.testing.assert_allclose(got[..., c], want[..., c], rtol=1e-6,
                                   atol=1e-6 * scale)


def _f64_sums(bins, rows, node, g, h, nodes, B):
    out = np.zeros((nodes, F, B, 3))
    for f in range(F):
        for c, v in enumerate((g, h, np.ones_like(g))):
            np.add.at(out[..., c], (node, f, bins[rows, f]),
                      v[rows].astype(np.float64))
    return out.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_against_reference(seed):
    bins, pos, g, h = _hist_inputs(seed)
    B, nodes = 17, 6
    bt = torch.from_numpy(np.ascontiguousarray(bins.T))
    got = host_engine.hist_kernel(bt, torch.from_numpy(pos),
                                  torch.from_numpy(g), torch.from_numpy(h),
                                  nodes, B).numpy()
    want = np.asarray(jtrainer.hist_kernel(jnp.asarray(bins),
                                           jnp.asarray(pos), jnp.asarray(g),
                                           jnp.asarray(h), nodes, F, B))
    _close(got, want)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])  # counts
    rows = np.nonzero(pos >= 0)[0]
    assert np.array_equal(got, _f64_sums(bins, rows, pos[rows], g, h, nodes,
                                         B))
    # one node's rows: node_hist_kernel
    mask = pos == 3
    got1 = host_engine.node_hist_kernel(bt, torch.from_numpy(mask),
                                        torch.from_numpy(g),
                                        torch.from_numpy(h), B).numpy()
    want1 = np.asarray(jtrainer.node_hist_kernel(
        jnp.asarray(bins), jnp.asarray(mask), jnp.asarray(g),
        jnp.asarray(h), F, B))
    _close(got1, want1)
    rows = np.nonzero(mask)[0]
    assert np.array_equal(got1, _f64_sums(bins, rows, np.zeros_like(rows), g,
                                          h, 1, B)[0])


def test_position_update_and_walk_against_reference(tmp_path):
    bins, pos, _g, _h = _hist_inputs(3)
    rng = np.random.RandomState(4)
    nodes = 6
    feat = rng.randint(-1, F, size=nodes).astype(np.int32)
    slot = rng.randint(0, 17, size=nodes).astype(np.int32)
    base = np.where(feat >= 0, np.arange(nodes) * 2, -1).astype(np.int32)
    bt = torch.from_numpy(np.ascontiguousarray(bins.T))
    got = host_engine.pos_update_kernel(
        bt, torch.from_numpy(pos), torch.from_numpy(feat),
        torch.from_numpy(slot), torch.from_numpy(base)).numpy()
    want = np.asarray(jtrainer.pos_update_kernel(
        jnp.asarray(bins), jnp.asarray(pos), jnp.asarray(feat),
        jnp.asarray(slot), jnp.asarray(base)))
    assert np.array_equal(got, want)
    # a grown tree's leaf assignment and scores
    _j, pres, ptr = _run_pair(tmp_path, {"tree_grow_policy": "level"},
                              test=False)
    X, *_ = _data("sigmoid", 3000, 1)
    bins_np = np.asarray(jtrainer.bin_matrix(X, ptr._bins_sidecar[1]))
    tree = copy.deepcopy(pres.model.trees[0])
    # back to slot space: each split's slot from its value
    bins_meta = ptr._bins_sidecar[1]
    for nid in range(tree.n_nodes()):
        if not tree.is_leaf(nid):
            v = bins_meta.values[tree.feat[nid], :bins_meta.counts[
                tree.feat[nid]]]
            tree.slot[nid] = int(np.searchsorted(v, tree.split[nid],
                                                 side="right")) - 1
    bt = torch.from_numpy(np.ascontiguousarray(bins_np.T))
    got = ptr._tree_leaf_assignment(tree, bt).numpy()
    jt = JTrainer(_params(JParams, JSpec, JModelParams, tmp_path / "x"),
                  engine="host")
    want = np.asarray(jt._tree_leaf_assignment(tree, jnp.asarray(bins_np)))
    assert np.array_equal(got, want)
    assert np.array_equal(ptr._tree_scores_dev(tree, bt).numpy(),
                          np.asarray(jt._tree_scores_dev(
                              tree, jnp.asarray(bins_np))))


def test_precise_lad_bit_equal_on_the_same_inputs(tmp_path):
    _j, pres, ptr = _run_pair(tmp_path, {"loss_function": "l1",
                                         "lad_refine_appr": False}, {},
                              test=False)
    X, y, _w, _ = _data("l1", 3000, 1)
    rng = np.random.RandomState(9)
    w = rng.choice([0.0, 0.5, 1.0, 2.5], size=len(y)).astype(np.float32)
    scores = (0.1 * rng.randn(len(y))).astype(np.float32)
    bins = ptr._bins_sidecar[1]
    bins_np = np.asarray(jtrainer.bin_matrix(X, bins))
    grown = ptr.build_tree_loss_wise(
        torch.from_numpy(np.ascontiguousarray(bins_np.T)),
        torch.from_numpy(np.sign(scores - y)), torch.ones(len(y)),
        torch.zeros(len(y), dtype=torch.int32), F, bins.max_bins,
        torch.ones(F, dtype=torch.bool), NAMES)
    a, b = copy.deepcopy(grown), copy.deepcopy(grown)
    ptr._refine_lad(a, torch.from_numpy(np.ascontiguousarray(bins_np.T)),
                    y, torch.from_numpy(scores), w)
    jt = JTrainer(_params(JParams, JSpec, JModelParams, tmp_path / "x",
                          loss_function="l1"), engine="host")
    jt._refine_lad(b, jnp.asarray(bins_np), jnp.asarray(y),
                   jnp.asarray(scores), jnp.asarray(w))
    assert a.leaf_value == b.leaf_value
    assert a.leaf_value != grown.leaf_value


def test_continue_train_and_just_evaluate(tmp_path):
    """3 rounds, then 2 more from the dump, in both packages: each resumed
    text is its own uninterrupted 5-round text byte for byte, and the two
    packages' trees agree; just_evaluate replays the dump and trains
    nothing."""
    texts = {}
    X, y, w, _ = _data("sigmoid", 3000, 1)
    for who, (cls, pcls, spec, mcls, data) in {
            "jax": (JTrainer, JParams, JSpec, JModelParams, JData),
            "port": (GBDTTrainer, GBDTParams, ApproximateSpec, ModelParams,
                     GBDTData)}.items():
        extra = {"device": "cpu"} if who == "port" else {}
        for tag, rounds, resume in (("whole", 5, False), ("cut", 3, False),
                                    ("cut", 5, True)):
            p = _params(pcls, spec, mcls, tmp_path / f"{who}.{tag}",
                        round_num=rounds)
            p.model.continue_train = resume
            res = cls(p, engine="host", **extra).train(
                data(X, y, w, len(X), NAMES))
        assert [r["round"] for r in res.round_log] == [3, 4]
        texts[who] = [(tmp_path / f"{who}.{t}").read_text()
                      for t in ("whole", "cut")]
        assert texts[who][0] == texts[who][1]
        p = _params(pcls, spec, mcls, tmp_path / f"{who}.cut", round_num=5,
                    just_evaluate=True)
        p.model.continue_train = True
        ev = cls(p, engine="host", **extra).train(
            data(X, y, w, len(X), NAMES))
        assert len(ev.model.trees) == 5 and ev.round_log == []
        texts[who + "_eval"] = ev.train_loss
    _assert_same_trees(GBDTModel.loads(texts["port"][1]).trees,
                       JModel.loads(texts["jax"][1]).trees)
    assert texts["port_eval"] == pytest.approx(texts["jax_eval"], rel=1e-5)


def test_resume_with_sampling_restarts_the_stream_in_both(tmp_path):
    """The reference draws its row and feature masks from one RandomState
    seeded at every _train_host, from the first trained round on: a run
    resumed with rates below 1 draws round 0's masks again and is not the
    uninterrupted run, in the reference as in the port (ROADMAP.md §3).
    The two packages' resumed runs still agree with each other."""
    X, y, w, _ = _data("sigmoid", 3000, 1)
    out = {}
    for who, (cls, pcls, spec, mcls, data) in {
            "jax": (JTrainer, JParams, JSpec, JModelParams, JData),
            "port": (GBDTTrainer, GBDTParams, ApproximateSpec, ModelParams,
                     GBDTData)}.items():
        extra = {"device": "cpu"} if who == "port" else {}
        for tag, rounds, resume in (("whole", 4, False), ("cut", 2, False),
                                    ("cut", 4, True)):
            p = _params(pcls, spec, mcls, tmp_path / f"{who}.{tag}",
                        round_num=rounds, instance_sample_rate=0.7,
                        feature_sample_rate=0.7)
            p.model.continue_train = resume
            cls(p, engine="host", **extra).train(data(X, y, w, len(X), NAMES))
        whole = (tmp_path / f"{who}.whole").read_text()
        cut = (tmp_path / f"{who}.cut").read_text()
        assert whole != cut
        wt, ct = JModel.loads(whole).trees, JModel.loads(cut).trees
        assert [t.sample_cnt for t in wt[:2]] == [t.sample_cnt for t in ct[:2]]
        # the resumed rounds drew round 0's and round 1's masks again
        assert ct[2].sample_cnt[0] == wt[0].sample_cnt[0]
        assert ct[2].sample_cnt[0] != wt[2].sample_cnt[0]
        out[who] = cut
    _assert_same_trees(GBDTModel.loads(out["port"]).trees,
                       JModel.loads(out["jax"]).trees)
