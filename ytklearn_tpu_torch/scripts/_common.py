"""What the tuning tools share: arguments, the card line, CUDA-event
timing, the device's busy time in a torch.profiler trace, the CPU's "not
measured", and K1-K4 launch shapes that fit (K1 through check_float_plan,
K2/K4 through check_q_plan)."""

from __future__ import annotations

import argparse
import math
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


def device_busy(prof, top_k: int = 0):
    """(busy ms, top device ops) of a torch.profiler trace. Busy time is
    the union of the device events' intervals (kernels, copies, sets):
    only events on the device count, since a CPU op's device time repeats
    the kernels it launched, and kernels launched through ctypes have no
    CPU op at all. The top ops are the `top_k` with the most self device
    time."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:top_k]
    return busy_us / 1e3, top


def fmt_ms(ms: Optional[float]) -> str:
    return NOT_MEASURED if ms is None else f"{ms:.6f} ms"


def k2k4_plans(fg: int, rows: int, N: int, F: int, B: int, M: int,
               n: int) -> List[Tuple[Optional[dict], str, str]]:
    """K2/K4 tile plans of `fg` features a tile and `rows` rows a chunk,
    through check_q_plan, as (plan, label, why-not): the whole wave in one
    tile (ng = N, the reference's tile); when that does not fit shared
    memory, it with plan None and the bytes it would need, then the most
    slots that fit, spread evenly over the tiles. A tile past half an SM's
    shared memory runs one block of 1024 threads an SM, as q_plan's
    does."""
    def shape(ng):
        big = hist.q_tile_bytes(ng, fg, B) > hist.SMEM_PER_BLOCK
        return {"kind": "tile", "fg": fg, "ng": ng, "rows_per_chunk": rows,
                "threads": 2 * hist.THREADS if big else hist.THREADS}

    whole = shape(N)
    need = hist.q_tile_bytes(N, fg, B)
    if need <= hist.SMEM_MAX:
        plan = hist.check_q_plan(whole, N, F, B, M, n)
        return [(plan, plan_label(plan), "")]
    out = [(None, plan_label(whole), f"its tile needs {need} bytes of "
            f"shared memory, more than {hist.SMEM_MAX}")]
    fit = [ng for ng in range(N - 1, 0, -1)
           if hist.q_tile_bytes(ng, fg, B) <= hist.SMEM_MAX]
    if fit:
        ng = -(-N // -(-N // fit[0]))  # the same tile count, evenly filled
        plan = hist.check_q_plan(shape(ng), N, F, B, M, n)
        out.append((plan, plan_label(plan), ""))
    return out


def k2k4_red_plans(N: int, F: int, B: int, M: int, n: int, sm_count: int
                   ) -> List[dict]:
    """K2/K4's red kind through check_q_plan at 512 and 1024 threads, one
    wave of blocks."""
    return [hist.check_q_plan(
        {"kind": "red", "threads": threads,
         "n_chunks": max(1, min(65535, sm_count * (2048 // threads)))},
        N, F, B, M, n) for threads in (hist.THREADS, 2 * hist.THREADS)]


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
        out.append((plan, plan_label(plan), ""))
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
            out.append((plan, plan_label(plan), ""))
    return out


def plan_label(plan: dict) -> str:
    """A plan's kind, tile, threads and chunk rows, for a tool's line."""
    head = f"kind={plan['kind']} " if "kind" in plan else ""
    tile = "" if plan.get("kind") == "red" else \
        f"fg={plan['fg']} ng={plan['ng']} "
    return (f"{head}{tile}threads={plan['threads']} "
            f"rows/chunk={plan['rows_per_chunk']}")
