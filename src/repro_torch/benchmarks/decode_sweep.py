"""Timing sweep of the paged decode kernel K5/K7 (``csrc/paged_attn.cu``)
on one CUDA card: what holds it back at long contexts, and where its
shape-only choices (the int8 warp layout, the KV split) should switch.

    PYTHONPATH=src python -m repro_torch.benchmarks.decode_sweep [--out PATH]

It builds ``paged_attn.cu`` five ways, one nvcc each, all started together:
as the wrappers build it (``kernel``); with half of the decode kernel's work
switched off (``BRAVO_DECODE_ABLATE``: ``copies_only`` stages the tiles and
scores nothing, ``arith_only`` scores tiles that were never copied); and
with the int8 layout pinned (``BRAVO_LONG_ROWS``: ``all_heads`` gives each
warp all four query heads at every row length, ``one_head`` one head a warp
at every length).  Each time is a CUDA graph of ``N_CALLS`` launches,
replayed, the median of ``REPS`` windows, in ms a call:

1. ``ablation``: K5 (bf16 pages) and K7 (int8) at the long-context shape
   (16 rows of 3584-4096 positions on 256 lanes of 16), each build at the
   split the wrapper picks for it;
2. ``layout``: K7 under both pinned layouts at the engine's decode tick
   (8 rows of 24-88 positions on 8 lanes of 16), on 256 lanes (capacity
   4096) at rows of about 100, 512, 1024, 2048 and 3584-4096 positions,
   and, with 8 and with 16 rows, on 64 lanes at rows of about 100 and at
   full rows of 256 to 2048 positions;
3. ``splits``: K5 and K7 at full rows of 256 to 2048 positions, 8 and 16
   rows, forced to 1, 2, 4, 8 and 16 splits and at the wrapper's pick.

Every time of the ``kernel``, ``all_heads`` and ``one_head`` builds comes
from outputs checked against the plain version (``ref.paged_attn_ref``,
1e-5 absolute).  Queries are float32, pages bf16 or int8 with float32
scales, llama3.2-1b's attention heads (H 32, KVH 8, hd 64), data from
``--seed``.  ``bound_ms`` is the bytes of the valid K/V rows (and, for int8,
their scales) at 3.35 TB/s.  Prints one JSON line per experiment and the
card's name and power limit; writes the whole record to ``--out`` if given;
exits 1 without a CUDA card or when a checked output is off.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import paged_attn as PA
from ..kernels import quant as Q
from ..kernels import ref as R

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
N_CALLS, REPS = 50, 7
HEADS = dict(h=32, kvh=8, hd=64)
ATOL = 1e-5
BUILDS = {"kernel": (),
          "copies_only": ("BRAVO_DECODE_ABLATE=1",),
          "arith_only": ("BRAVO_DECODE_ABLATE=2",),
          "all_heads": ("BRAVO_LONG_ROWS=0",),
          "one_head": (f"BRAVO_LONG_ROWS={2 ** 30}",)}
CHECKED = ("kernel", "all_heads", "one_head")
LONG = dict(b=16, lanes=256, ps=16, lengths=(3584, 4096))


def make_case(b: int, lanes: int, ps: int, lengths, int8: bool, seed: int,
              device, h: int = 32, kvh: int = 8, hd: int = 64) -> dict:
    """``b`` rows with cache_len drawn from ``lengths`` (inclusive) over
    ``lanes`` lanes of ``ps`` positions, each row on its own pages of a
    ``b * lanes``-page store (-1 past its length); q float32 (b, h, hd),
    K/V unit normal in bf16, or int8 with per-(page, KV head) scales.
    -> dict of the kernel's operands and the bytes its valid rows hold."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = b * lanes
    lo, hi = lengths
    clen = torch.randint(lo, hi + 1, (b,), generator=gen, dtype=torch.int32)
    clen = torch.clamp(clen, max=lanes * ps)
    perm = torch.randperm(n_pages, generator=gen, dtype=torch.int32)
    page_idx = torch.full((b, lanes), -1, dtype=torch.int32)
    for i in range(b):
        npg = -(-int(clen[i]) // ps)
        page_idx[i, :npg] = perm[i * lanes:i * lanes + npg]
    dgen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, h, hd), generator=dgen, device=device)
    pages = [torch.randn((n_pages, ps, kvh, hd), generator=dgen,
                         device=device) for _ in range(2)]
    rows = int(clen.sum())
    if int8:
        (kq, ks), (vq, vs) = (Q.quantize_pages(x) for x in pages)
        pages, scales = [kq, vq], (ks, vs)
        used = int((page_idx >= 0).sum())
        nbytes = 2 * rows * kvh * hd + 2 * used * kvh * 4
    else:
        pages, scales = [x.to(torch.bfloat16) for x in pages], ()
        nbytes = 2 * rows * kvh * hd * 2
    return {"q": q, "k": pages[0], "v": pages[1], "scales": scales,
            "page_idx": page_idx.to(device), "cache_len": clen.to(device),
            "bytes": nbytes + 2 * q.numel() * 4,
            "shape": {"B": b, "lanes": lanes, "page": ps, **HEADS,
                      "cache_len": [lo, hi],
                      "pages": "int8" if int8 else "bfloat16"}}


def graph_ms(fn) -> float:
    """Median ms a call of ``fn`` over ``REPS`` replays of a CUDA graph of
    ``N_CALLS`` calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(N_CALLS):
            fn()
    graph.replay()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / N_CALLS)
    return statistics.median(times)


class Sweep:
    def __init__(self, libs: dict):
        self.libs = libs
        self.wrong = []

    def time(self, build: str, case: dict, n_split=None) -> dict:
        """One timing of one build at one case (and split)."""
        lib = self.libs[build]
        args = (case["q"], case["k"], case["v"], case["scales"],
                case["page_idx"], case["cache_len"])
        if n_split is None:
            n_split, _ = PA.decode_plan(case["q"], case["k"],
                                        case["page_idx"].shape[1], lib)
        rec = {"build": build, "splits": n_split}
        if build in CHECKED:
            got = PA._decode(*args, n_split=n_split, lib=lib)
            want = (R.paged_attn_quant_ref(case["q"], case["k"], case["v"],
                                           *case["scales"],
                                           case["page_idx"],
                                           case["cache_len"])
                    if case["scales"] else
                    R.paged_attn_ref(case["q"], case["k"], case["v"],
                                     case["page_idx"], case["cache_len"]))
            err = float((got - want).abs().max())
            rec["max_abs_err"] = err
            if not err <= ATOL:
                self.wrong.append((build, case["shape"], n_split, err))
        rec["ms"] = graph_ms(
            lambda: PA._decode(*args, n_split=n_split, lib=lib))
        rec["bound_ms"] = case["bytes"] / HBM_BYTES_PER_S * 1e3
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        return rec


def ablation(sw: Sweep, dev, seed: int) -> list:
    out = []
    for int8 in (False, True):
        case = make_case(**LONG, int8=int8, seed=seed, device=dev)
        out.append({"shape": case["shape"], "runs": [
            sw.time(build, case)
            for build in ("kernel", "copies_only", "arith_only")]})
    return out


def layout(sw: Sweep, dev, seed: int) -> list:
    shapes = [dict(b=8, lanes=8, lengths=(24, 88))]      # the engine's tick
    shapes += [dict(b=16, lanes=256, lengths=ln) for ln in
               ((64, 128), (448, 576), (960, 1088), (1984, 2112),
                (3584, 4096))]
    shapes += [dict(b=b, lanes=64, lengths=(64, 128)) for b in (8, 16)]
    shapes += [dict(b=b, lanes=n, lengths=(16 * n, 16 * n))
               for b in (8, 16) for n in (16, 32, 64, 128)]
    out = []
    for sh in shapes:
        case = make_case(ps=16, int8=True, seed=seed, device=dev, **sh)
        out.append({"shape": case["shape"], "runs": [
            sw.time(build, case) for build in ("all_heads", "one_head")]})
    return out


def splits(sw: Sweep, dev, seed: int) -> list:
    out = []
    for int8 in (False, True):
        for b in (8, 16):
            for lanes in (16, 32, 64, 128):
                case = make_case(b=b, lanes=lanes, ps=16,
                                 lengths=(16 * lanes, 16 * lanes),
                                 int8=int8, seed=seed, device=dev)
                runs = [sw.time("kernel", case)]
                runs += [sw.time("kernel", case, n) for n in (1, 2, 4, 8, 16)
                         if n <= lanes]
                out.append({"shape": case["shape"], "runs": runs})
    return out


def build_all() -> tuple:
    """Compile every build of ``paged_attn.cu``, all nvcc processes started
    together; -> (libraries by build, nvcc seconds by build)."""
    src = _build.CSRC / PA.SOURCE
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as ex:
        futs = {k: ex.submit(_build.compile_source, src, d)
                for k, d in BUILDS.items()}
        secs = {k: f.result()[1] for k, f in futs.items()}
    libs = {k: _build.load(PA.SOURCE, PA.SIGNATURES, d)
            for k, d in BUILDS.items()}
    return libs, secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.splitlines()[0]
    libs, secs = build_all()
    sw = Sweep(libs)
    record = {"card": card, "nvcc_seconds": secs, "n_calls": N_CALLS,
              "reps": REPS}
    for name, fn in (("ablation", ablation), ("layout", layout),
                     ("splits", splits)):
        record[name] = fn(sw, dev, args.seed)
        print(json.dumps({"experiment": name, "card": card,
                          "results": record[name]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    if sw.wrong:
        print(f"decode_sweep: outputs off the plain version: {sw.wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
