"""GBDT tree growth on the device, wave by wave (``ytklearn_tpu/gbdt/engine.py``).

Growth runs in WAVES of up to `spec.wave` node expansions:
  1. select expandable frontier nodes: by (depth, node id) for the level
     policy, by descending best gain for the loss policy;
  2. record the splits into fixed-size tree arrays, allocate children;
  3. route rows to the children (kernel K5, gbdt/route.py);
  4. histogram the SMALLER child of each split (a full-scan kernel over
     all rows, or a gather kernel over the compacted rows of the wave in
     the partitioned phases) and derive the sibling by subtraction from
     the parent's histogram;
  5. enumerate the best split of every new child (split_kernel).

The reference runs a whole tree as one XLA program (three
`lax.while_loop` phases). Here the phases are Python loops whose
conditions (`can_split`, `wave_need`) are read on the host once per wave:
one device->host sync per wave, counted in `grow.host_syncs`. Arrays keep
the reference's fixed shapes; every scatter that the reference runs with
mode="drop" (index M = dropped) writes into an extra sink slot M that is
sliced off.

Histogram modes (`spec.hist_mode`). "int8": per-tree int8 quantization,
exact int32 sums scaled back to f32 (kernels K2 full scan, K4 gather).
"mxu" (the reference's default): raw f32 gradients summed in f32, each
row's g and h rounded to bf16 first when `spec.use_bf16` (kernels K1 full
scan, K3 gather); sibling subtraction stays f32 on f32 histograms.

Float order. The split scan takes prefix sums and totals over the bins in
f32. The port fixes
that order, the same on every device, so a tree grown on the card equals
the one grown on the CPU bit for bit: `ordered_cumsum` (16-wide blocks
scanned left to right, block totals scanned the same way, recursively) and
`ordered_sum` (32-wide chunks summed left to right, recursively). That is
the order XLA's CPU backend gives a lone `jnp.cumsum` / `jnp.sum`, and the
port's split_kernel equals the reference's bit for bit on the same
histograms. Inside the reference's whole-tree program XLA fuses and
reorders further, so there the f32 split statistics agree to about 1e-6
relative; with int8 histograms the tree structure, row counts and wave log
agree exactly. The f32/bf16 histograms themselves are order-dependent
float sums (the kernels' atomics add in an order that changes from run to
run), so in "mxu" mode trees agree with the reference, and across runs on
the card, where no two candidate splits lie within that noise.

GOSS (`spec.goss_a < 1`, the reference's engine.py:486-543): per tree the
top `goss_a` share of the included rows by |g| (a stable descending sort,
so ties keep the lowest index as `jax.lax.top_k` does) and `goss_b` of the
rest, drawn by the largest threefry uniforms (`gbdt.prng`, bit for bit
`jax.random`), whose g and h are amplified by f32(1 / goss_b). The kept
rows are compacted in order into a fit matrix that every histogram pass
runs on; the full matrix rides along as `aux[0]` for the final leaf
assignment. EFB (`ranges`): a bundled column's split boundary counts its
member's default rows on the left (split_kernel's closed form) and routes
only the member's own bins right (K5's `lo`/`hi`). A mesh is not ported
(ROADMAP.md 1.7).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import prng
from .hist import BMG_DEFAULT, BM_DEFAULT, compact_indices, hist_wave, \
    hist_wave_gather, hist_wave_q
from .route import route_wave

BIG32 = 2 ** 31 - 1
SCAN_BLOCK = 16
SUM_CHUNK = 32


def wave_log_rows(max_nodes: int) -> int:
    """Rows of the per-tree wave log grow() returns (one per histogram
    pass: root + slow-start ramp + growth waves)."""
    return max_nodes + 8


# ---------------------------------------------------------------------------
# Fixed-order f32 reductions
# ---------------------------------------------------------------------------


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last dim in the fixed blocked order."""
    L = x.shape[-1]
    if L <= SCAN_BLOCK:
        acc = torch.zeros_like(x[..., 0])
        outs = []
        for i in range(L):
            acc = acc + x[..., i]
            outs.append(acc)
        return torch.stack(outs, dim=-1)
    Lp = -(-L // SCAN_BLOCK) * SCAN_BLOCK
    if Lp != L:
        x = torch.nn.functional.pad(x, (0, Lp - L))
    blk = x.reshape(*x.shape[:-1], Lp // SCAN_BLOCK, SCAN_BLOCK)
    inner = _scan_last(blk)
    pre = _scan_last(inner[..., -1])
    excl = torch.cat([torch.zeros_like(pre[..., :1]), pre[..., :-1]], dim=-1)
    out = (inner + excl[..., None]).reshape(*x.shape[:-1], Lp)
    return out[..., :L]


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    L = x.shape[-1]
    if L <= SUM_CHUNK:
        acc = torch.zeros_like(x[..., 0])
        for i in range(L):
            acc = acc + x[..., i]
        return acc
    Lp = -(-L // SUM_CHUNK) * SUM_CHUNK
    if Lp != L:
        x = torch.nn.functional.pad(x, (0, Lp - L))
    return _sum_last(_sum_last(
        x.reshape(*x.shape[:-1], Lp // SUM_CHUNK, SUM_CHUNK)))


def ordered_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive f32 prefix sum along `dim` in a fixed, device-independent
    order (the order of XLA CPU's jnp.cumsum)."""
    return _scan_last(x.movedim(dim, -1).contiguous()).movedim(-1, dim)


def ordered_sum(x: torch.Tensor, dim: int, keepdim: bool = False
                ) -> torch.Tensor:
    """f32 sum along `dim` in a fixed, device-independent order (the order
    of XLA CPU's jnp.sum where the length is at most 32 or a multiple of
    32, as the engine's bin axes are)."""
    out = _sum_last(x.movedim(dim, -1).contiguous())
    return out.unsqueeze(dim) if keepdim else out


# ---------------------------------------------------------------------------
# Gain / leaf-value formulas (reference: UpdateStrategy.java:64-83)
# ---------------------------------------------------------------------------


def _threshold_l1(g, l1):
    zero = torch.zeros_like(g)
    return torch.where(g > l1, g - l1, torch.where(g < -l1, g + l1, zero))


def make_gain_fns(l1: float, l2: float, min_h: float, max_abs: float):
    def node_value(G, H):
        t = _threshold_l1(G, l1) if l1 > 0 else G
        val = -t / (H + l2)
        if max_abs > 0:
            val = torch.clamp(val, -max_abs, max_abs)
        return torch.where(H < min_h, torch.zeros_like(val), val)

    def gain(G, H):
        if max_abs <= 0:
            t = _threshold_l1(G, l1) if l1 > 0 else G
            out = t * t / (H + l2)
        else:
            v = node_value(G, H)
            out = -2.0 * (G * v + 0.5 * (H + l2) * v * v + l1 * torch.abs(v))
        return torch.where(H < min_h, torch.zeros_like(out), out)

    return gain, node_value


def split_kernel(hist, feat_mask, cfg, ranges=None):
    """Best split per node from (N, F, B, 3) f32 histograms.

    Returns per node: (loss_chg, flat_idx, slot_left, GL, HL, CL, GR, HR,
    CR): empty slots skipped, split interval [last nonempty, current],
    child-hessian guards, gain against the node's own; the first max wins
    a tie, so the lowest (feature, slot) does (SplitInfo.needReplace).

    ranges: optional (range_lo, range_hi) (F, B) integer tables of EFB
    bundle columns (`BundlePlan.range_tables`): the member slot range that
    holds slot s. A boundary inside member j counts j's default rows (node
    total less j's nonzero-range sum) on the left, `lo - 1` stands for the
    member's default bin, and has_prev looks only inside the member's
    range or at that default bin. With [0, B-1] the correction is zero."""
    l1, l2, min_h, max_abs = cfg
    N, F, B, _ = hist.shape
    dev = hist.device
    gain, _ = make_gain_fns(l1, l2, min_h, max_abs)

    incl = ordered_cumsum(hist, dim=2)  # (N, F, B, 3)
    tot = ordered_sum(hist, dim=2, keepdim=True)  # (N, F, 1, 3)
    G, H, C = hist[..., 0], hist[..., 1], hist[..., 2]
    GL = incl[..., 0] - G
    HL = incl[..., 1] - H
    CL = incl[..., 2] - C
    Gt, Ht, Ct = tot[..., 0], tot[..., 1], tot[..., 2]

    nonempty = C > 0
    ne = nonempty.to(torch.int32)
    ne_incl = torch.cumsum(ne, dim=-1, dtype=torch.int32)
    if ranges is None:
        has_prev = (ne_incl - ne) > 0
    else:
        rlo = torch.as_tensor(ranges[0], device=dev).long()
        rhi = torch.as_tensor(ranges[1], device=dev).long()
        i_lo = rlo[None].expand(N, F, B)
        i_hi = rhi[None].expand(N, F, B)

        def at_hi(A):  # inclusive prefix at the member range's end
            return torch.gather(A, 2, i_hi)

        def at_lo_excl(A_incl, A):  # exclusive prefix at the range's start
            return torch.gather(A_incl - A, 2, i_lo)

        # the member's default rows fold into the left side
        GL = GL + (Gt - at_hi(incl[..., 0]))
        HL = HL + (Ht - at_hi(incl[..., 1]))
        CL = CL + (Ct - at_hi(incl[..., 2]))
        ne_in_range = (ne_incl - ne) - at_lo_excl(ne_incl, ne) > 0
        dflt_cnt = Ct - (at_hi(incl[..., 2]) - at_lo_excl(incl[..., 2], C))
        has_prev = ne_in_range | (dflt_cnt > 0)
    GR, HR, CR = Gt - GL, Ht - HL, Ct - CL
    valid = nonempty & has_prev & (HL >= min_h) & (HR >= min_h)
    valid = valid & feat_mask[None, :, None]

    # node totals: every active row hits every feature, so feature 0's
    # bin-sum is the node total
    root_gain = gain(Gt[:, 0:1, 0], Ht[:, 0:1, 0])  # (N, 1)
    loss_chg = gain(GL, HL) + gain(GR, HR) - root_gain[:, :, None]
    loss_chg = torch.where(valid, loss_chg,
                           torch.full_like(loss_chg, float("-inf")))

    flat = loss_chg.reshape(N, F * B)
    best = torch.argmax(flat, dim=-1)  # first max
    bcol = best[:, None]
    best_chg = torch.gather(flat, 1, bcol)[:, 0]

    # last nonempty slot strictly before j (the split interval's left end)
    iota = torch.arange(B, device=dev)
    idxs = torch.where(nonempty, iota[None, None, :], -1)
    lastne_incl = torch.cummax(idxs, dim=2).values
    lastne = torch.cat(
        [torch.full((N, F, 1), -1, dtype=lastne_incl.dtype, device=dev),
         lastne_incl[:, :, :-1]], dim=2)
    if ranges is not None:
        # lo - 1: the member's default bin (the original feature's zero)
        lastne = torch.maximum(lastne, (rlo - 1)[None])
    slot_left = torch.gather(lastne.reshape(N, F * B), 1, bcol)[:, 0]

    def pick(A):
        return torch.gather(A.reshape(N, F * B), 1, bcol)[:, 0]

    return (
        best_chg, best.to(torch.int32), slot_left.to(torch.int32),
        pick(GL), pick(HL), pick(CL), pick(GR), pick(HR), pick(CR),
    )


# ---------------------------------------------------------------------------
# The growth engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GrowSpec:
    """Static shape/config of one tree growth (the reference's GrowSpec;
    `force_dense` and `fused_interpret` have no counterpart: `bm` is the
    row unit of the budget rungs that gather their rows and run the
    full-scan kernel, `bm_g` that of the fused rungs that run the gather
    kernel)."""

    F: int
    B: int
    max_nodes: int  # tree array capacity (2*max_leaves-1 or full level tree)
    wave: int  # node expansions per wave (loss policy: best-first pop width)
    policy: str  # "level" | "loss"
    max_depth: int  # <=0 = unlimited
    max_leaves: int  # <=0 = unlimited
    lr: float
    l1: float
    l2: float
    min_h: float
    max_abs: float
    min_split_loss: float
    min_split_samples: float
    bm: int = BM_DEFAULT
    use_bf16: bool = True  # "mxu" mode: round g/h to bf16 per row
    hist_mode: str = "int8"  # "int8" (K2/K4) | "mxu" (K1/K3)
    partition: bool = True
    ladder: Tuple[int, ...] = (8, 32)
    fused: bool = True
    fused_max_rows: int = 1 << 18
    bm_g: int = BMG_DEFAULT
    goss_a: float = 1.0
    goss_b: float = 0.0
    goss_scale: float = 1.0

    @property
    def depth_cap(self) -> int:
        return self.max_depth if self.max_depth > 0 else self.max_nodes

    @property
    def leaf_cap(self) -> int:
        return (self.max_leaves if self.max_leaves > 0
                else (self.max_nodes + 1) // 2)


class TreeArrays(NamedTuple):
    """Fixed-shape device tree; converted to gbdt.tree.Tree after the
    final fetch."""

    feat: torch.Tensor  # (M,) i32, -1 = leaf
    slot: torch.Tensor  # (M,) i32 routing threshold (last nonempty slot)
    slot_r: torch.Tensor  # (M,) i32 split interval right end
    left: torch.Tensor  # (M,) i32
    right: torch.Tensor  # (M,) i32
    leaf: torch.Tensor  # (M,) f32 (lr-scaled)
    gain: torch.Tensor  # (M,) f32
    hess: torch.Tensor  # (M,) f32
    cnt: torch.Tensor  # (M,) f32
    depth: torch.Tensor  # (M,) i32
    n_nodes: torch.Tensor  # () i32


class _Frontier(NamedTuple):
    chg: torch.Tensor  # (M,) f32, -inf = none
    flat: torch.Tensor  # (M,) i32 best f*B+slot
    slotl: torch.Tensor  # (M,) i32
    GL: torch.Tensor
    HL: torch.Tensor
    CL: torch.Tensor
    GR: torch.Tensor
    HR: torch.Tensor
    CR: torch.Tensor
    active: torch.Tensor  # (M,) bool


def float_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys whose order is lax.sort's order of f32 values: a total
    order after -0.0 becomes 0.0 and every NaN one NaN (-inf < ... < 0.0
    < ... < +inf < NaN); a stable sort then breaks ties by index."""
    x = torch.where(x == 0, torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _quantize(g, h, n: int):
    """Per-tree symmetric int8 quantization (reference engine.py:583-604):
    qmax shrinks above ~16.9M rows so no int32 sum can overflow."""
    qmax = float(min(127, (2 ** 31 - 1) // max(n, 1)))
    gmax = torch.clamp_min(torch.max(torch.abs(g)), 1e-12)
    hmax = torch.clamp_min(torch.max(torch.abs(h)), 1e-12)
    gq = torch.clamp(torch.round(g * (qmax / gmax)), -qmax, qmax)
    hq = torch.clamp(torch.round(h * (qmax / hmax)), -qmax, qmax)
    # the reference writes the inverse scale as 1 / (qmax / max|g|); XLA's
    # simplifier turns that into max|g| * f32(1 / qmax), which is what the
    # reference computes (on the CPU and the TPU alike)
    rq = float(np.float32(1.0) / np.float32(qmax))
    inv = torch.stack([gmax * rq, hmax * rq, torch.ones_like(gmax)])
    return gq, hq, inv


def _budget_rungs(spec: GrowSpec, n: int) -> List[Tuple[int, str]]:
    """Ascending [(R, impl)] partition budgets: "fused" runs the gather
    kernel (K4 or K3) on the compacted rows, "gather" gathers them and runs
    the full-scan kernel (K2 or K1)."""
    rungs: List[Tuple[int, str]] = []
    for div in spec.ladder:
        want = -(-n // div)
        fuse = spec.fused and want <= spec.fused_max_rows
        unit = spec.bm_g if fuse else spec.bm
        R = max(-(-want // unit) * unit, unit)
        if R < n and R not in [r for r, _ in rungs]:
            rungs.append((R, "fused" if fuse else "gather"))
    rungs.sort()
    return rungs


def _top_rows(score: torch.Tensor, k: int) -> torch.Tensor:
    """(n,) bool: the k largest scores, ties to the lowest index (the
    order of jax.lax.top_k), by a stable descending sort."""
    idx = torch.sort(score, descending=True, stable=True).indices[:k]
    mask = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    mask[idx] = True
    return mask


def goss_sample(spec: GrowSpec, bins_t, include, g, h, key):
    """GOSS's fit set (reference engine.py:486-543): the top k_a included
    rows by |g|, then the k_b largest uniform draws of the other included
    rows with g and h amplified by f32(1 / goss_b), compacted in row order
    into R_fit columns (k_a + k_b rounded up to spec.bm, at most n). k_a
    and k_b count over the real share `goss_scale` of the rows, on the
    host. Returns (fit bins (F, R_fit), fit include, fit g, fit h, kept
    count)."""
    n_full = bins_t.shape[1]
    dev = bins_t.device
    n_eff = max(1, min(n_full, int(np.ceil(spec.goss_scale * n_full))))
    k_a = max(1, min(n_eff, int(np.ceil(spec.goss_a * n_eff))))
    k_b = 0
    if spec.goss_b > 0.0:
        k_b = min(n_eff - k_a, int(np.ceil(spec.goss_b * (n_eff - k_a))))
    keep = _top_rows(torch.where(include, torch.abs(g), -1.0), k_a) & include
    if k_b > 0:
        u = prng.uniform(key, n_full, device=dev)
        rest = include & ~keep
        rmask = _top_rows(torch.where(rest, u, -1.0), k_b) & rest
        amp = float(np.float32(1.0 / spec.goss_b))
        g = torch.where(rmask, g * amp, g)
        h = torch.where(rmask, h * amp, h)
        keep = keep | rmask
    R_fit = max(spec.bm, -(-(k_a + k_b) // spec.bm) * spec.bm)
    R_fit = min(R_fit, n_full)
    idx, kept = compact_indices(keep, R_fit)
    valid = torch.arange(R_fit, dtype=torch.int32, device=dev) < kept
    li = idx.long()
    return (bins_t.index_select(1, li), valid,
            torch.where(valid, g[li], 0.0), torch.where(valid, h[li], 0.0),
            kept)


def grow(spec: GrowSpec, bins_t, include, g, h, feat_mask, aux=(), key=None,
         ranges=None):
    """Grow one tree.

    bins_t (F, n) u8|i32 transposed bin matrix, include (n,) bool rows
    that count, g/h (n,) f32 weighted gradients, feat_mask (F,) bool, aux:
    extra (F, n_aux) bin matrices (e.g. the test set) routed through the
    same splits. key: a `gbdt.prng` key for GOSS's remainder draw
    (PRNGKey(0) by default). ranges: optional EFB (range_lo, range_hi)
    (F, B) tables (see split_kernel). Returns (TreeArrays, pos (n,),
    aux_pos, wave_log) where the wave log (max_nodes+8, 5) f32 holds per
    histogram pass [rows_scanned, rows_needed, splits, hist_width,
    rows_sampled]. With GOSS (0 < goss_a < 1) pos is the leaf assignment of
    the compacted fit rows and the full matrix is routed as aux[0]: the
    train rows' positions are aux_pos[0], the caller's sets aux_pos[1:]."""
    if spec.hist_mode not in ("int8", "mxu"):
        raise ValueError(f"hist_mode must be int8|mxu, got {spec.hist_mode!r}")
    dev = bins_t.device
    M, NW, F, B = spec.max_nodes, spec.wave, spec.F, spec.B
    cfg = (spec.l1, spec.l2, spec.min_h, spec.max_abs)
    _, node_value = make_gain_fns(*cfg)
    i32, f32 = torch.int32, torch.float32
    if ranges is not None:
        ranges = tuple(torch.as_tensor(r, device=dev).to(i32)
                       for r in ranges)
        if ranges[0].shape != (F, B) or ranges[1].shape != (F, B):
            raise ValueError(f"grow: ranges must be two ({F}, {B}) tables")

    goss_rows = None
    if 0.0 < spec.goss_a < 1.0:
        aux = (bins_t,) + tuple(aux)
        bins_t, include, g, h, kept = goss_sample(
            spec, bins_t, include, g, h,
            prng.PRNGKey(0) if key is None else key)
        goss_rows = kept.to(f32)
    n = bins_t.shape[1]
    pos = torch.zeros(n, dtype=i32, device=dev)
    aux_pos = [torch.zeros(bt.shape[1], dtype=i32, device=dev) for bt in aux]
    if goss_rows is None:
        goss_rows = include.sum(dtype=f32)

    rungs = _budget_rungs(spec, n) if spec.partition else []
    bins_rows = None
    if rungs:
        # row-major copy for the per-wave row gather (once per tree)
        bins_rows = bins_t.t().contiguous()
        if B <= 256:
            bins_rows = bins_rows.to(torch.uint8)

    if spec.hist_mode == "int8":
        G_, H_, inv = _quantize(g, h, n)

        def hist_full(bt, pos_v, g_v, h_v, ids):
            return hist_wave_q(bt, pos_v, g_v, h_v, ids, B,
                               max_nodes=M).to(f32) * inv

        def hist_gather(idx, pg, gg, hg, ids):
            return hist_wave_gather(bins_rows, idx, pg, gg, hg, ids, B,
                                    max_nodes=M).to(f32) * inv
    else:
        # raw f32 gradients: the kernels round each row's g/h to bf16 (when
        # use_bf16) after the gather, as the reference does, and sum in f32
        G_, H_ = g, h

        def hist_full(bt, pos_v, g_v, h_v, ids):
            return hist_wave(bt, pos_v, g_v, h_v, ids, B, max_nodes=M,
                             use_bf16=spec.use_bf16)

        def hist_gather(idx, pg, gg, hg, ids):
            return hist_wave_gather(bins_rows, idx, pg, gg, hg, ids, B,
                                    mode="mxu", max_nodes=M,
                                    use_bf16=spec.use_bf16)

    def hist_call(pos_fit, ids):
        """Full-scan histogram (K2 or K1): root, slow start, big-wave
        phases."""
        return hist_full(bins_t, pos_fit, G_, H_, ids)

    def hist_budget(R: int, impl: str):
        """Histogram of the wave's rows only, compacted into a static
        budget of R rows (the phase condition guarantees they fit)."""

        def call(pos_fit, ids):
            member = torch.zeros(M + 2, dtype=torch.bool, device=dev)
            member[torch.where(ids >= 0, ids + 1, M + 1).long()] = True
            member[M + 1] = False
            mask = member[(pos_fit + 1).long()]
            idx, cnt = compact_indices(mask, R)
            valid = torch.arange(R, dtype=i32, device=dev) < cnt
            li = idx.long()
            pg = torch.where(valid, pos_fit[li], -1).to(i32)
            gg, hg = G_[li], H_[li]
            if impl == "fused":
                return hist_gather(idx, pg, gg, hg, ids)
            bt = bins_rows[li].t().contiguous()
            return hist_full(bt, pg, gg, hg, ids)

        return call

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # every per-node array carries a sink slot M for dropped scatters
    M1 = (M + 1,)
    tr = TreeArrays(
        feat=full(M1, -1, i32), slot=full(M1, 0, i32), slot_r=full(M1, 0, i32),
        left=full(M1, -1, i32), right=full(M1, -1, i32),
        leaf=full(M1, 0.0, f32), gain=full(M1, 0.0, f32),
        hess=full(M1, 0.0, f32), cnt=full(M1, 0.0, f32),
        depth=full(M1, 0, i32), n_nodes=torch.ones((), dtype=i32, device=dev),
    )

    ids0 = torch.zeros(1, dtype=i32, device=dev)
    pos_fit = torch.where(include, pos, -1)
    hist0 = hist_call(pos_fit, ids0)  # (1, F, B, 3)
    root_ghc = ordered_sum(hist0[0, 0], dim=0)  # feature 0 bin-sum = totals
    tr.hess[0] = root_ghc[1]
    tr.cnt[0] = root_ghc[2]
    tr.leaf[0] = node_value(root_ghc[0], root_ghc[1]) * spec.lr
    pool = torch.zeros((M + 1, F, B, 3), dtype=f32, device=dev)
    pool[0] = hist0[0]

    out0 = split_kernel(hist0, feat_mask, cfg, ranges)
    fr = _Frontier(
        chg=full(M1, float("-inf"), f32), flat=full(M1, 0, i32),
        slotl=full(M1, 0, i32), GL=full(M1, 0.0, f32), HL=full(M1, 0.0, f32),
        CL=full(M1, 0.0, f32), GR=full(M1, 0.0, f32), HR=full(M1, 0.0, f32),
        CR=full(M1, 0.0, f32), active=full(M1, False, torch.bool),
    )
    for arr, val in zip(fr[:9], out0):
        arr[0] = val[0]
    fr.active[0] = True

    MW = wave_log_rows(M)
    wlog = torch.zeros((MW, 5), dtype=f32, device=dev)
    wlog[0] = torch.stack([
        torch.tensor(float(n), device=dev), root_ghc[2],
        torch.zeros((), device=dev), torch.ones((), device=dev), goss_rows,
    ])
    st = {"tr": tr, "fr": fr, "pool": pool, "pos": pos, "aux_pos": aux_pos,
          "leaves": torch.ones((), dtype=i32, device=dev), "wlog": wlog,
          "wcnt": 1}

    def can_split(fr, tr, leaves):
        ok = fr.active[:M] & torch.isfinite(fr.chg[:M]) \
            & (fr.chg[:M] > spec.min_split_loss)
        ok &= (fr.CL[:M] + fr.CR[:M]) >= spec.min_split_samples
        ok &= (fr.HL[:M] + fr.HR[:M]) >= 2.0 * spec.min_h
        ok &= tr.depth[:M] < spec.depth_cap
        return ok & (leaves < spec.leaf_cap)

    def select(ok, fr, tr, nw: int):
        if spec.policy == "level":
            k1 = torch.where(ok, tr.depth[:M], BIG32)
        else:
            k1 = float_order_key(torch.where(
                ok, -fr.chg[:M], torch.full_like(fr.chg[:M], float("inf"))))
        order = torch.sort(k1, stable=True).indices
        sel = order[:nw]
        return sel, ok[sel]

    def count_off(sel_ok, leaves):
        order_cum = torch.cumsum(sel_ok.to(i32), dim=0, dtype=i32)
        return sel_ok & ((leaves + order_cum) <= spec.leaf_cap)

    def probe():
        """(any node can split, rows the next wave's histograms need):
        the phase conditions, read on the host (one sync)."""
        tr, fr, leaves = st["tr"], st["fr"], st["leaves"]
        ok = can_split(fr, tr, leaves)
        sel, sel_ok = select(ok, fr, tr, NW)
        sel_ok = count_off(sel_ok, leaves)
        small_cnt = torch.minimum(fr.CL[sel], fr.CR[sel])
        need = torch.sum(torch.where(sel_ok, small_cnt,
                                     torch.zeros_like(small_cnt)))
        any_ok, need_v = torch.stack([ok.any().to(f32), need]).tolist()
        with _sync_lock:
            grow.host_syncs += 1
        return any_ok > 0, need_v

    def wave_body(nw: int, hist_fn=None, hist_rows: Optional[int] = None):
        tr, fr, pool = st["tr"], st["fr"], st["pool"]
        leaves = st["leaves"]
        ok = can_split(fr, tr, leaves)
        sel, sel_ok = select(ok, fr, tr, nw)
        # leaf budget count-off in selection order
        sel_ok = count_off(sel_ok, leaves)
        ok_i = sel_ok.to(i32)
        k_cnt = ok_i.sum(dtype=i32)
        # children allocation in selection order
        prefix = torch.cumsum(ok_i, dim=0, dtype=i32) - ok_i
        lch = (tr.n_nodes + 2 * prefix).to(i32)
        rch = lch + 1
        nid = sel
        scatter_id = torch.where(sel_ok, nid, M)
        lch_id = torch.where(sel_ok, lch.long(), M)
        rch_id = torch.where(sel_ok, rch.long(), M)

        f_best = torch.div(fr.flat[nid], B, rounding_mode="floor")
        slot_r = fr.flat[nid] % B
        slot_l = fr.slotl[nid]
        if ranges is not None:
            # the chosen slot's EFB member range: other members' rows stay
            # on the default (left) side
            sel_lo = ranges[0][f_best.long(), slot_r.long()]
            sel_hi = ranges[1][f_best.long(), slot_r.long()]
        else:
            sel_lo = torch.zeros_like(f_best)
            sel_hi = torch.full_like(f_best, B - 1)
        GLs, HLs, CLs = fr.GL[nid], fr.HL[nid], fr.CL[nid]
        GRs, HRs, CRs = fr.GR[nid], fr.HR[nid], fr.CR[nid]
        child_depth = tr.depth[nid] + 1

        tr.feat[scatter_id] = f_best
        tr.slot[scatter_id] = slot_l
        tr.slot_r[scatter_id] = slot_r
        tr.left[scatter_id] = lch
        tr.right[scatter_id] = rch
        tr.gain[scatter_id] = fr.chg[nid]
        tr.leaf[lch_id] = node_value(GLs, HLs) * spec.lr
        tr.leaf[rch_id] = node_value(GRs, HRs) * spec.lr
        tr.hess[lch_id] = HLs
        tr.hess[rch_id] = HRs
        tr.cnt[lch_id] = CLs
        tr.cnt[rch_id] = CRs
        tr.depth[lch_id] = child_depth
        tr.depth[rch_id] = child_depth
        tr = tr._replace(n_nodes=(tr.n_nodes + 2 * k_cnt).to(i32))

        # routing (train + any aux sets), in place
        st["pos"] = route_wave(bins_t, st["pos"], sel_ok, nid, f_best, slot_l,
                               lch, rch, lo=sel_lo, hi=sel_hi, out=st["pos"])
        st["aux_pos"] = [
            route_wave(bt, ap, sel_ok, nid, f_best, slot_l, lch, rch,
                       lo=sel_lo, hi=sel_hi, out=ap)
            for bt, ap in zip(aux, st["aux_pos"])
        ]

        # smaller-child histogram + sibling subtraction
        small = torch.where(CLs <= CRs, lch, rch)
        big = torch.where(CLs <= CRs, rch, lch)
        ids = torch.where(sel_ok, small, -2).to(i32)
        pos_fit = torch.where(include, st["pos"], -1)
        h_small = (hist_fn or hist_call)(pos_fit, ids)
        h_big = pool[nid] - h_small
        pool[torch.where(sel_ok, small.long(), M)] = h_small
        pool[torch.where(sel_ok, big.long(), M)] = h_big

        # frontier refresh for the 2*nw children
        child_ids = torch.cat([small, big]).long()
        child_ok = torch.cat([sel_ok, sel_ok])
        out = split_kernel(torch.cat([h_small, h_big], dim=0), feat_mask,
                           cfg, ranges)
        cids = torch.where(child_ok, child_ids, M)
        fr.chg[scatter_id] = float("-inf")
        for arr, val in zip(fr[:9], out):
            arr[cids] = val
        fr.active[scatter_id] = False
        fr.active[cids] = True

        need = torch.sum(torch.where(sel_ok, torch.minimum(CLs, CRs),
                                     torch.zeros_like(CLs)))
        if st["wcnt"] < MW:
            st["wlog"][st["wcnt"]] = torch.stack([
                torch.tensor(float(n if hist_rows is None else hist_rows),
                             device=dev),
                need, k_cnt.to(f32), torch.tensor(float(nw), device=dev),
                goss_rows,
            ])
        st["tr"] = tr
        st["leaves"] = (leaves + k_cnt).to(i32)
        st["wcnt"] += 1

    # slow start: after k waves at most 2^k nodes are expandable, so the
    # first waves run right-sized (N = 1, 2, 4, ...), unconditionally
    nw_ss = 1
    while nw_ss < NW:
        wave_body(nw_ss)
        nw_ss *= 2

    # phase-separated growth: full scans while waves are big, then tighter
    # budgets as the frontier's row need shrinks, then a full-scan tail
    # (lo, hi, hist_fn, hist_rows): run while lo < need <= hi
    phases = []
    if rungs:
        Rs = sorted(rungs, reverse=True)
        phases.append((Rs[0][0], None, None, None))
        for i, (R, impl) in enumerate(Rs):
            nxt = Rs[i + 1][0] if i + 1 < len(Rs) else None
            phases.append((nxt, R, hist_budget(R, impl), R))
    phases.append((None, None, None, None))
    for lo, hi, hist_fn, hist_rows in phases:
        while True:
            can, need = probe()
            if not (can and (hi is None or need <= hi)
                    and (lo is None or need > lo)):
                break
            wave_body(NW, hist_fn, hist_rows)

    tr = st["tr"]
    tr = TreeArrays(*(a[:M] for a in tr[:10]), n_nodes=tr.n_nodes)
    return tr, st["pos"], tuple(st["aux_pos"]), st["wlog"]


_sync_lock = threading.Lock()
#: device->host reads of the phase conditions, summed over every grow()
grow.host_syncs = 0
