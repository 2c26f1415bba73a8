"""Timing sweep of the chunk-prefill kernel K6/K8 (``csrc/paged_attn.cu``)
on one CUDA card: what holds it back, and where its split should sit.

    PYTHONPATH=src python -m repro_torch.benchmarks.chunk_sweep [--out PATH]

It builds ``paged_attn.cu`` five ways, one nvcc each, all started together:
as the wrappers build it (``kernel``); with half of the chunk kernel's work
switched off (``BRAVO_CHUNK_ABLATE``: ``copies_only`` stages the tiles and
computes nothing, ``arith_only`` computes on tiles that were never
copied); with hd 64's products on mma.sync instead of wgmma
(``mma_sync``, ``BRAVO_CHUNK_WGMMA=0``); and the parent chunk design
(``BRAVO_CHUNK_PARENT=1``, one CTA per request, block of columns and KV
head, no split, SIMT float32).  Each time
is a CUDA graph of ``N_CALLS`` launches, replayed, the median of ``REPS``
windows, in ms a call:

1. ``shapes``: K6 (bf16 pages) and K8 (int8) at the engine's prefill tick
   (2 rows x 32 columns, lengths 32 and 72, 8 lanes of 16) and at the two
   long-prefix shapes (2 rows x 32 or 256 columns at the end of 3584-4096
   positions, 256 lanes of 16), each build at the wrapper's split, the
   kernel also at one split;
2. ``tick``: K6 at the tick's grid with its work cut down (1, 2 and 4
   splits; rows of 32 positions; rows of none), every build;
3. ``splits``: K6 and K8 at both long-prefix shapes forced to 1, 2, 4, 8,
   12, 16 and 24 splits;
4. ``columns``: K6 at the long prefix with chunks of 16 to 512 columns,
   the kernel against the parent.

Every time of the ``kernel``, ``mma_sync`` and ``parent`` builds comes from
outputs checked against the plain version (``ref.paged_chunk_attn_ref``,
1e-5 absolute).  Queries are float32, pages bf16 or int8 with float32 scales,
llama3.2-1b's attention heads (H 32, KVH 8, hd 64), data from ``--seed``.
``bound_ms`` is the larger of the bytes of the valid K/V rows (and, for
int8, their scales), q and out at 3.35 TB/s and the operations (4 * hd a
query head and visible position) at the bf16 tensor-core rate, 989
TFLOP/s.  Prints one JSON line per experiment and the card's name and
power limit; writes the whole record to ``--out`` if given; exits 1
without a CUDA card or when a checked output is off.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import paged_attn as PA
from ..kernels import paged_chunk_attn as PCA
from ..kernels import quant as Q
from ..kernels import ref as R
from .decode_sweep import graph_ms

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
TENSOR_OPS_PER_S = 989e12     # H100 SXM bf16 tensor-core rate, dense
HEADS = dict(h=32, kvh=8, hd=64)
ATOL = 1e-5
BUILDS = {"kernel": (),
          "copies_only": ("BRAVO_CHUNK_ABLATE=1",),
          "arith_only": ("BRAVO_CHUNK_ABLATE=2",),
          "mma_sync": ("BRAVO_CHUNK_WGMMA=0",),
          "parent": PA.PARENT_DEFINES}
CHECKED = ("kernel", "mma_sync", "parent")
TICK = dict(b=2, s=32, lanes=8, ps=16, clen=(32, 72))
LONG = dict(b=2, lanes=256, ps=16, lengths=(3584, 4096))


def make_case(b: int, s: int, lanes: int, ps: int, int8: bool, seed: int,
              device, lengths=None, clen=None, h: int = 32, kvh: int = 8,
              hd: int = 64) -> dict:
    """``b`` rows of a chunk of ``s`` columns at the end of cache_len
    positions: ``clen`` (one per row) or drawn from ``lengths`` (lo, hi,
    inclusive), the columns real from position 0 on; over ``lanes``
    lanes of ``ps`` positions, each row on its own pages of a ``b *
    lanes``-page store (-1 past its length); q float32 (b, s, h, hd), K/V
    unit normal in bf16, or int8 with per-(page, KV head) scales.  -> dict
    of the kernel's operands, the bytes its valid rows, q and out hold,
    and the operations its visible positions take."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = b * lanes
    clen = (torch.tensor(clen, dtype=torch.int32) if clen is not None
            else torch.randint(lengths[0], lengths[1] + 1, (b,),
                               generator=gen, dtype=torch.int32))
    clen = torch.clamp(clen, max=lanes * ps)
    perm = torch.randperm(n_pages, generator=gen, dtype=torch.int32)
    page_idx = torch.full((b, lanes), -1, dtype=torch.int32)
    for i in range(b):
        npg = -(-int(clen[i]) // ps)
        page_idx[i, :npg] = perm[i * lanes:i * lanes + npg]
    dgen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, s, h, hd), generator=dgen, device=device)
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
    # each column sees the positions up to its own: cache_len - s + j + 1
    seen = sum(max(0, int(c) - s + j + 1) for c in clen for j in range(s))
    return {"q": q, "k": pages[0], "v": pages[1], "scales": scales,
            "page_idx": page_idx.to(device), "cache_len": clen.to(device),
            "new_lens": torch.full((b,), s, dtype=torch.int32,
                                   device=device),
            "bytes": nbytes + 2 * q.numel() * 4, "ops": 4 * hd * h * seen,
            "shape": {"B": b, "S": s, "lanes": lanes, "page": ps, **HEADS,
                      "cache_len": clen.tolist(),
                      "pages": "int8" if int8 else "bfloat16"}}


class Sweep:
    def __init__(self, libs: dict):
        self.libs = libs
        self.wrong = []

    def time(self, build: str, case: dict, n_split=None,
             pairs=None) -> dict:
        """One timing of one build at one case (and split and layout; the
        parent runs one split and its own layout)."""
        lib = self.libs[build]
        args = (case["q"], case["k"], case["v"], case["scales"],
                case["page_idx"], case["cache_len"], case["new_lens"])
        if build == "parent":
            n_split = 1
        else:
            plan, split, _ = PCA.chunk_plan(case["q"], case["k"],
                                            case["page_idx"].shape[1], lib)
            n_split = n_split or split
            pairs = pairs or plan
        rec = {"build": build, "splits": n_split, "pairs": pairs}
        run = functools.partial(PCA._chunk, *args, n_split=n_split, lib=lib,
                                pairs=pairs)
        if build in CHECKED:
            got = run()
            plain = (R.paged_chunk_attn_quant_ref if case["scales"]
                     else R.paged_chunk_attn_ref)
            want = plain(case["q"], case["k"], case["v"], *case["scales"],
                         case["page_idx"], case["cache_len"],
                         case["new_lens"])
            err = float((got - want).abs().max())
            rec["max_abs_err"] = err
            if not err <= ATOL:
                self.wrong.append((build, case["shape"], n_split, err))
        rec["ms"] = graph_ms(run)
        rec["bound_ms"] = max(case["bytes"] / HBM_BYTES_PER_S,
                              case["ops"] / TENSOR_OPS_PER_S) * 1e3
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
        return rec


def shapes(sw: Sweep, dev, seed: int) -> list:
    out = []
    for int8 in (False, True):
        for sh in (TICK, dict(LONG, s=32), dict(LONG, s=256)):
            case = make_case(**sh, int8=int8, seed=seed, device=dev)
            runs = [sw.time(build, case) for build in BUILDS]
            runs.append(sw.time("kernel", case, 1))
            out.append({"shape": case["shape"], "runs": runs})
    return out


def tick(sw: Sweep, dev, seed: int) -> list:
    """K6 at the prefill tick's grid with its work cut down: the tick
    itself at 1, 2 and 4 splits, rows of 32 positions (one tile each),
    rows of 0 (no tile: launch, prologue and the zero output alone), each
    build, and the kernel in both layouts (128 and 16 pairs a CTA)."""
    out = []
    for clen, forced in (((32, 72), (None, 2, 4)), ((32, 32), (None,)),
                         ((0, 0), (None,))):
        case = make_case(**dict(TICK, clen=clen), int8=False, seed=seed,
                         device=dev)
        runs = [sw.time(build, case) for build in BUILDS]
        runs += [sw.time("kernel", case, n) for n in forced if n]
        runs += [sw.time("kernel", case, 1, p)
                 for p in (PCA.WIDE_PAIRS, PCA.SMALL_PAIRS)]
        out.append({"shape": case["shape"], "runs": runs})
    return out


def splits(sw: Sweep, dev, seed: int) -> list:
    out = []
    for int8 in (False, True):
        for s in (32, 256):
            case = make_case(**LONG, s=s, int8=int8, seed=seed, device=dev)
            runs = [sw.time("kernel", case)]
            runs += [sw.time("kernel", case, n)
                     for n in (1, 2, 4, 8, 12, 16, 24)]
            out.append({"shape": case["shape"], "runs": runs})
    return out


def columns(sw: Sweep, dev, seed: int) -> list:
    out = []
    for s in (16, 64, 128, 512):
        case = make_case(**LONG, s=s, int8=False, seed=seed, device=dev)
        out.append({"shape": case["shape"], "runs": [
            sw.time(build, case) for build in ("kernel", "parent")]})
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


EXPERIMENTS = {"shapes": shapes, "tick": tick, "splits": splits,
               "columns": columns}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="output JSON path")
    ap.add_argument("--only", nargs="*", choices=list(EXPERIMENTS),
                    default=list(EXPERIMENTS), help="experiments to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chunk_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.splitlines()[0]
    libs, secs = build_all()
    sw = Sweep(libs)
    record = {"card": card, "nvcc_seconds": secs}
    for name in args.only:
        record[name] = EXPERIMENTS[name](sw, dev, args.seed)
        print(json.dumps({"experiment": name, "card": card,
                          "results": record[name]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(card, flush=True)
    if sw.wrong:
        print(f"chunk_sweep: outputs off the plain version: {sw.wrong}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
