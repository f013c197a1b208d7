"""What the tuning tools share: arguments, the card line, CUDA-event
timing, the CPU's "not measured", and K1-K4 launch shapes that fit."""

from __future__ import annotations

import argparse
import statistics
import subprocess
from typing import Callable, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..gbdt import hist

NOT_MEASURED = "not measured (cpu)"


def parser(description: str, rows: int) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu: "
                         "the plain versions, control flow and spot checks "
                         "only, no times")
    ap.add_argument("--rows", type=int, default=rows,
                    help=f"rows of the synthetic data (default {rows})")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed runs per variant; the median is printed")
    return ap


def card_line(dev: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index}"],
            capture_output=True, text=True, timeout=60)
        line = out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    return line


def setup(args) -> Tuple[torch.device, str]:
    """The device (cuda unless --device cpu; raises without a GPU) and
    its card line."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev, card_line(dev)


class Timer:
    """CUDA-event times on the card; None (not measured) on the CPU."""

    def __init__(self, dev: torch.device, repeats: int):
        self.dev, self.repeats = dev, max(1, repeats)

    def ms(self, fn: Callable[[], object], chain: int = 1) -> Optional[float]:
        """After one warm-up call, the median over `repeats` of the time of
        `chain` back-to-back calls between two events, per call. On the CPU
        `fn` runs once (its control flow) and the time is None."""
        if self.dev.type != "cuda":
            fn()
            return None
        fn()
        torch.cuda.synchronize(self.dev)
        times = []
        for _ in range(self.repeats):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(chain):
                fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / chain)
        return statistics.median(times)


def fmt_ms(ms: Optional[float]) -> str:
    return NOT_MEASURED if ms is None else f"{ms:.6f} ms"


def k2k4_plans(fg: int, rows: int, N: int, F: int, B: int, M: int,
               n: int) -> List[Tuple[Optional[dict], str, str]]:
    """K2/K4 launch shapes of `fg` features a tile and `rows` rows a chunk,
    as (plan, label, why-not): the whole wave in one tile (ng = N, the
    reference's tile); when that does not fit shared memory, it with plan
    None and the bytes it would need, then the most slots that fit, spread
    evenly over the tiles. A tile past half an SM's shared memory runs one
    block of 1024 threads an SM, as tile_plan's does."""
    def shape(ng):
        big = hist.tile_bytes(N, ng, fg, B, M) > hist.SMEM_PER_BLOCK
        return {"fg": fg, "ng": ng, "rows_per_chunk": rows,
                "threads": 2 * hist.THREADS if big else hist.THREADS}

    whole = shape(N)
    need = hist.tile_bytes(N, N, fg, B, M)
    if need <= hist.SMEM_MAX:
        plan = hist.check_plan(whole, N, F, B, M, n)
        return [(plan, _label(plan), "")]
    out = [(None, _label(whole), f"its tile needs {need} bytes of shared "
            f"memory, more than {hist.SMEM_MAX}")]
    fit = [ng for ng in range(N - 1, 0, -1)
           if hist.tile_bytes(N, ng, fg, B, M) <= hist.SMEM_MAX]
    if fit:
        ng = -(-N // -(-N // fit[0]))  # the same tile count, evenly filled
        plan = hist.check_plan(shape(ng), N, F, B, M, n)
        out.append((plan, _label(plan), ""))
    return out


def k1_plans(fgs, chunk_rows, N: int, F: int, B: int, M: int, n: int,
             sm_count: int) -> List[Tuple[Optional[dict], str, str]]:
    """K1 launch shapes through check_float_plan, as (plan, label,
    why-not): the red kind at 512 and 1024 threads (one wave of blocks),
    then a tile of each of `fgs` features holding the most slots that fit
    (spread evenly over the slot tiles) at each of `chunk_rows` rows a
    chunk; a tile of fg features that does not fit even one slot is listed
    with plan None."""
    out = []
    for threads in (hist.THREADS, 2 * hist.THREADS):
        chunks = max(1, min(65535, sm_count * (2048 // threads)))
        plan = hist.check_float_plan(
            {"kind": "red", "threads": threads, "n_chunks": chunks}, N, F,
            B, M, n)
        out.append((plan, _label(plan), ""))
    for fg in fgs:
        fg = min(fg, F)
        fit = [ng for ng in range(N, 0, -1)
               if hist.tile_bytes(N, ng, fg, B, M) <= hist.SMEM_MAX]
        if not fit:
            need = hist.tile_bytes(N, 1, fg, B, M)
            out.append((None, f"kind=tile fg={fg} ng=1", f"its tile needs "
                        f"{need} bytes of shared memory, more than "
                        f"{hist.SMEM_MAX}"))
            continue
        ng = -(-N // -(-N // fit[0]))  # the same tile count, evenly filled
        big = hist.tile_bytes(N, ng, fg, B, M) > hist.SMEM_PER_BLOCK
        for rows in chunk_rows:
            plan = hist.check_float_plan(
                {"kind": "tile", "fg": fg, "ng": ng, "rows_per_chunk": rows,
                 "threads": 2 * hist.THREADS if big else hist.THREADS},
                N, F, B, M, n)
            out.append((plan, _label(plan), ""))
    return out


def _label(plan: dict) -> str:
    head = f"kind={plan['kind']} " if "kind" in plan else ""
    tile = "" if plan.get("kind") == "red" else \
        f"fg={plan['fg']} ng={plan['ng']} "
    return (f"{head}{tile}threads={plan['threads']} "
            f"rows/chunk={plan['rows_per_chunk']}")
