"""GBDT tree + model containers with the reference text format.

The counterpart of ``ytklearn_tpu/gbdt/tree.py`` (reference:
data/gbdt/Tree.java node regexes :47-48 and recursive dump :255+,
GBDTModel.java dumpModel:63 / loadModel:79): parse, dump, depth, the
perfect-heap export the heap-walk kernel reads, and the training half
(the slot interval a grown split carries until its value conversion, and
feature importance). Text I/O is byte for byte the JAX package's.

Text format:
    base_prediction=<f>
    class_num=<int>
    obj=<loss name>
    tree_num=<int>
    booster[i] depth=<d>,node_num=<n>,leaf_cnt=<l>
    <indented node lines>
      inner: nid:[f_NAME<=VAL] yes=L,no=R,missing=M,gain=G,hess_sum=H,sample_cnt=C
      leaf:  nid:leaf=V,hess_sum=H,sample_cnt=C
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# The stats suffix is optional (dump(with_stats=False)), so every capture a
# comma terminates must be comma-safe or `missing=` swallows the stats.
INNER_RE = re.compile(
    r"(\S+):\[f_(\S+)<=(\S+)\] yes=([^,\s]+),no=([^,\s]+),missing=([^,\s]+)"
    r"(?:,gain=([^,\s]+),hess_sum=([^,\s]+),sample_cnt=([^,\s]+))?"
)
LEAF_RE = re.compile(
    r"(\S+):leaf=([^,\s]+)(?:,hess_sum=([^,\s]+),sample_cnt=([^,\s]+))?"
)


@dataclass
class Tree:
    """Flat-array regression tree. Node 0 is the root; children allocated in
    pairs. Leaves have feat == -1."""

    feat: List[int] = field(default_factory=lambda: [-1])
    feat_name: List[str] = field(default_factory=lambda: [""])
    split: List[float] = field(default_factory=lambda: [0.0])
    left: List[int] = field(default_factory=lambda: [-1])
    right: List[int] = field(default_factory=lambda: [-1])
    default_left: List[bool] = field(default_factory=lambda: [True])
    leaf_value: List[float] = field(default_factory=lambda: [0.0])
    gain: List[float] = field(default_factory=lambda: [0.0])
    hess_sum: List[float] = field(default_factory=lambda: [0.0])
    sample_cnt: List[int] = field(default_factory=lambda: [0])
    # train-time: split slot interval for value conversion
    slot: List[int] = field(default_factory=lambda: [-1])

    def n_nodes(self) -> int:
        return len(self.feat)

    def is_leaf(self, nid: int) -> bool:
        return self.feat[nid] < 0

    def add_children(self, nid: int) -> Tuple[int, int]:
        l = self.n_nodes()
        for arr, d in (
            (self.feat, -1),
            (self.feat_name, ""),
            (self.split, 0.0),
            (self.left, -1),
            (self.right, -1),
            (self.default_left, True),
            (self.leaf_value, 0.0),
            (self.gain, 0.0),
            (self.hess_sum, 0.0),
            (self.sample_cnt, 0),
            (self.slot, -1),
        ):
            arr.append(d)
            arr.append(d)
        self.left[nid] = l
        self.right[nid] = l + 1
        return l, l + 1

    def max_depth(self) -> int:
        depth = [0] * self.n_nodes()
        best = 0
        for nid in range(self.n_nodes()):
            if not self.is_leaf(nid):
                for c in (self.left[nid], self.right[nid]):
                    depth[c] = depth[nid] + 1
                    best = max(best, depth[c])
        return best

    def leaf_cnt(self) -> int:
        return sum(1 for i in range(self.n_nodes()) if self.is_leaf(i))

    def heap_arrays(
        self, depth: int, feat_ids: Optional[List[int]] = None
    ) -> Dict[str, np.ndarray]:
        """Perfect-heap export for the heap-walk kernel: the node at heap
        slot p has its children at 2p+1 / 2p+2, so a fixed-depth walk needs
        no child pointers (`slot = 2*slot + 2 - go_left`) and the leaf value
        is read from the last heap level only. Leaves above `depth` become
        always-go-left pad chains (split=+inf, dleft=1) whose leftmost
        last-level descendant carries the value; unreachable last-level
        slots hold -0.0 so a padded accumulation is a bit-exact no-op.

        Returns {feat (H,) i32, split (H,) f64, dleft (H,) i32,
        inner (H,) bool, leaf (LL,) f64} with H = 2^(depth+1)-1 and
        LL = 2^depth."""
        if depth < max(self.max_depth(), 1):
            raise ValueError(
                f"heap depth {depth} < tree depth {self.max_depth()}"
            )
        H = (1 << (depth + 1)) - 1
        LL = 1 << depth
        feat = np.zeros(H, np.int32)
        split = np.full(H, np.inf, np.float64)
        dleft = np.ones(H, np.int32)
        inner = np.zeros(H, bool)
        leaf = np.full(LL, -0.0, np.float64)
        ids = feat_ids if feat_ids is not None else self.feat

        stack = [(0, 0, 0)]  # (orig nid, heap pos, depth)
        while stack:
            nid, pos, d = stack.pop()
            if self.is_leaf(nid):
                # descend leftmost through the always-left pad chain
                for _ in range(depth - d):
                    pos = 2 * pos + 1
                leaf[pos - (LL - 1)] = float(self.leaf_value[nid])
                continue
            feat[pos] = int(ids[nid])
            split[pos] = float(self.split[nid])
            dleft[pos] = int(bool(self.default_left[nid]))
            inner[pos] = True
            stack.append((self.left[nid], 2 * pos + 1, d + 1))
            stack.append((self.right[nid], 2 * pos + 2, d + 1))
        return {
            "feat": feat, "split": split, "dleft": dleft,
            "inner": inner, "leaf": leaf,
        }

    def dump(self, booster_id: int, with_stats: bool = True) -> str:
        lines = [
            f"booster[{booster_id + 1}] depth={self.max_depth()},"
            f"node_num={self.n_nodes()},leaf_cnt={self.leaf_cnt()}"
        ]

        def rec(nid: int, depth: int):
            ind = "\t" * depth
            if self.is_leaf(nid):
                s = f"{ind}{nid}:leaf={_jfloat(self.leaf_value[nid])}"
                if with_stats:
                    s += (
                        f",hess_sum={_jfloat(self.hess_sum[nid])}"
                        f",sample_cnt={self.sample_cnt[nid]}"
                    )
                lines.append(s)
            else:
                missing = self.left[nid] if self.default_left[nid] else self.right[nid]
                s = (
                    f"{ind}{nid}:[f_{self.feat_name[nid]}<={_jfloat(self.split[nid])}]"
                    f" yes={self.left[nid]},no={self.right[nid]},missing={missing}"
                )
                if with_stats:
                    s += (
                        f",gain={_jfloat(self.gain[nid])}"
                        f",hess_sum={_jfloat(self.hess_sum[nid])}"
                        f",sample_cnt={self.sample_cnt[nid]}"
                    )
                lines.append(s)
                rec(self.left[nid], depth + 1)
                rec(self.right[nid], depth + 1)

        rec(0, 0)
        return "\n".join(lines) + "\n"

    @classmethod
    def parse(cls, lines: List[str]) -> "Tree":
        """Parse the node lines of one booster (reference: Tree.loadModel:192)."""
        t = cls()
        entries = []
        for raw in lines:
            line = raw.strip()
            if not line:
                continue
            m = LEAF_RE.match(line) if ":leaf=" in line else INNER_RE.match(line)
            if m is None:
                raise ValueError(f"bad tree node line: {line!r}")
            entries.append((":leaf=" in line, m))
        max_nid = 0
        for is_leaf, m in entries:
            nid = int(m.group(1))
            max_nid = max(max_nid, nid)
            if not is_leaf:
                max_nid = max(max_nid, int(m.group(4)), int(m.group(5)))
        n = max_nid + 1
        t.feat = [-1] * n
        t.feat_name = [""] * n
        t.split = [0.0] * n
        t.left = [-1] * n
        t.right = [-1] * n
        t.default_left = [True] * n
        t.leaf_value = [0.0] * n
        t.gain = [0.0] * n
        t.hess_sum = [0.0] * n
        t.sample_cnt = [0] * n
        t.slot = [-1] * n
        for is_leaf, m in entries:
            nid = int(m.group(1))
            if is_leaf:
                t.leaf_value[nid] = float(m.group(2))
                if m.group(3) is not None:
                    t.hess_sum[nid] = float(m.group(3))
                    t.sample_cnt[nid] = int(float(m.group(4)))
            else:
                t.feat_name[nid] = m.group(2)
                try:
                    t.feat[nid] = int(m.group(2))
                except ValueError:
                    t.feat[nid] = 0  # serving keys on feat_name
                t.split[nid] = float(m.group(3))
                t.left[nid] = int(m.group(4))
                t.right[nid] = int(m.group(5))
                t.default_left[nid] = int(m.group(6)) == int(m.group(4))
                if m.group(7) is not None:
                    t.gain[nid] = float(m.group(7))
                    t.hess_sum[nid] = float(m.group(8))
                    t.sample_cnt[nid] = int(float(m.group(9)))
        return t


    def feature_importance(self, acc: Dict[str, Tuple[int, float]]) -> None:
        """Accumulate (split_count, gain_sum) per feature name (reference:
        data/gbdt/Tree.featureImportance feeding GBDTModel:108-114)."""
        for nid in range(self.n_nodes()):
            if not self.is_leaf(nid):
                name = self.feat_name[nid]
                cnt, gain = acc.get(name, (0, 0.0))
                acc[name] = (cnt + 1, gain + float(self.gain[nid]))


def unbundle_tree(tree: Tree, plan) -> None:
    """Rewrite, in place, a tree grown on an EFB-bundled bin matrix into
    original feature space (the JAX package's tree.py:297): every inner
    node's column and slot interval (`feat`, `slot`, `split`, still slot
    space before the value conversion) go through
    `plan.unbundle_split`, so the value conversion, the dump, feature
    importance and serving see only original features. `plan` is a
    gbdt.binning.BundlePlan."""
    for nid in range(tree.n_nodes()):
        if tree.is_leaf(nid):
            continue
        fid, slot_l, slot_r = plan.unbundle_split(
            tree.feat[nid], tree.slot[nid], int(tree.split[nid]))
        tree.feat[nid] = fid
        tree.slot[nid] = slot_l
        tree.split[nid] = float(slot_r)


def _jfloat(v: float) -> str:
    """Java Float.toString-ish rendering (shortest round-trip of float32)."""
    return repr(float(np.float32(v)))


@dataclass
class GBDTModel:
    """Header + tree list (reference: data/gbdt/GBDTModel.java)."""

    base_prediction: float = 0.5
    num_tree_in_group: int = 1
    obj_name: str = "sigmoid"
    trees: List[Tree] = field(default_factory=list)

    def dumps(self, with_stats: bool = True) -> str:
        out = [
            f"base_prediction={_jfloat(self.base_prediction)}",
            f"class_num={self.num_tree_in_group}",
            f"obj={self.obj_name}",
            f"tree_num={len(self.trees)}",
        ]
        for i, t in enumerate(self.trees):
            out.append(t.dump(i, with_stats).rstrip("\n"))
        return "\n".join(out) + "\n"

    @classmethod
    def loads(cls, text: str) -> "GBDTModel":
        lines = text.split("\n")
        m = cls(
            base_prediction=float(lines[0].split("=")[1]),
            num_tree_in_group=int(lines[1].split("=")[1]),
            obj_name=lines[2].split("=")[1],
        )
        tree_num = int(lines[3].split("=")[1])
        blocks: List[List[str]] = []
        cur: Optional[List[str]] = None
        for line in lines[4:]:
            if line.strip().startswith("booster["):
                cur = []
                blocks.append(cur)
            elif cur is not None and line.strip():
                cur.append(line)
        if len(blocks) != tree_num:
            raise ValueError(f"expected {tree_num} trees, found {len(blocks)}")
        m.trees = [Tree.parse(b) for b in blocks]
        return m

    def feature_importance(self) -> Dict[str, Tuple[int, float]]:
        """name -> (sum_split_count, sum_gain), gain-descending, name
        ascending on ties (a deterministic dump order)."""
        acc: Dict[str, Tuple[int, float]] = {}
        for t in self.trees:
            t.feature_importance(acc)
        return dict(sorted(acc.items(), key=lambda kv: (-kv[1][1], kv[0])))
