"""Autotune sweep for the paged-attention kernels K5-K8, the twin of
``repro.kernels.autotune``.

Each paged kernel exposes one plan knob, read by its wrapper from the
tuning table (``ops.tuned``); 0 is the plan the wrapper computes without
one:

* ``paged_attn`` / ``paged_attn_quant`` (K5 / K7) — ``min_split_positions``:
  the least KV positions worth a split of the grid
  (``paged_attn.decode_plan``), the counterpart of ``repro``'s
  ``lanes_per_step`` (the KV one grid step takes).  0 is
  ``paged_attn.MIN_SPLIT_POSITIONS``.
* ``paged_chunk_attn`` / ``paged_chunk_attn_quant`` (K6 / K8) — ``pairs``:
  (column, query head) pairs a CTA (``paged_chunk_attn.chunk_plan``), the
  counterpart of ``repro``'s ``block_q`` (query rows a grid step).  16 and
  128 are built only for the head_dims of ``PAIRS_HD``, 64 only outside
  them; elsewhere a candidate gives the built-in plan.

Every candidate is checked against the plain version (:mod:`.ref`) on the
same operands before it is timed, at ``repro``'s 1e-5 (float32 outputs):
a wrong candidate is recorded as ``"WRONG"`` and cannot win.  The
survivors are timed as ``chip_smoke.py`` times its kernels: ``N_CALLS``
launches captured in one CUDA graph and replayed, the median of ``REPS``
windows, in ms a call; the candidates run twice in turns (in order, then
reversed) and each time is the mean of its two readings.  A candidate
whose plan (splits, lanes a split, pairs) is the built-in one launches
the same work, so it cannot displace 0.

On the card the sweep runs at llama3.2-1b's attention heads (H 32, KVH 8,
hd 64, pages of 16), float32 queries, bf16 pages for K5/K6 (the serving
store) and int8 pages with float32 scales for K7/K8, at the two shapes
where the knobs act: decode, 16 rows on 256 lanes (3569-4096 positions);
the chunk, 2 rows x 32 columns on 256 lanes.  The engine's tick shapes
(8 lanes of 16) hold fewer positions than one split, so neither knob moves
them.  With ``--device cpu`` the wrappers' plain versions are checked at
``repro``'s small cases and nothing is timed.

    python -m repro_torch.kernels.autotune [--out PATH] [--device cpu]

``--out`` merges the winners into a table file under this card's name
(``torch.cuda.get_device_name``) and keeps every other card's entries;
``kernels/tuning_table.json`` beside :mod:`.ops` is the table the
wrappers read.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import device as D
from . import paged_attn as PA
from . import paged_chunk_attn as PCA
from . import ref as R
from .quant import quantize_pages

__all__ = ["sweep", "run", "merge", "mode", "KNOBS", "CARD_SHAPES"]

# kernel (``repro``'s name) -> (knob, candidates)
KNOBS = {
    "paged_attn": ("min_split_positions", PA.SPLIT_POSITION_CANDIDATES),
    "paged_attn_quant": ("min_split_positions",
                         PA.SPLIT_POSITION_CANDIDATES),
    "paged_chunk_attn": ("pairs", PCA.PAIRS_CANDIDATES),
    "paged_chunk_attn_quant": ("pairs", PCA.PAIRS_CANDIDATES),
}
TOL = 1e-5
N_CALLS, REPS = 100, 11
# the card's sweep: llama3.2-1b's attention on 256 lanes of 16 in a
# 4096-page store; rows of 224-256 used lanes (3569-4096 positions)
_HEADS = dict(h=32, kvh=8, hd=64, ps=16, lanes=256, n_pages=4096,
              min_used=224)
CARD_SHAPES = {"decode": dict(b=16, **_HEADS),
               "chunk": dict(b=2, s=32, **_HEADS)}


def mode(device=None) -> str:
    """How the sweep runs on ``device``: ``cuda`` (the kernels launched,
    checked and timed) or ``plain`` (the CPU: the wrappers' plain versions
    checked, nothing timed)."""
    return "cuda" if D.resolve(device).type == "cuda" else "plain"


# --------------------------------------------------------------------------
# Case builders: ``repro``'s, drawn with numpy from the seed, so a case is
# the same arrays in both packages.  ``min_used`` (1 in ``repro``) is the
# least lanes a row uses.
# --------------------------------------------------------------------------


def _decode_case(seed: int, *, b: int = 4, h: int = 4, kvh: int = 2,
                 hd: int = 32, ps: int = 8, lanes: int = 8,
                 n_pages: int = 64, min_used: int = 1):
    r = np.random.default_rng(seed)
    q = torch.tensor(r.standard_normal((b, h, hd)), dtype=torch.float32)
    k = torch.tensor(r.standard_normal((n_pages, ps, kvh, hd)),
                     dtype=torch.float32)
    v = torch.tensor(r.standard_normal((n_pages, ps, kvh, hd)),
                     dtype=torch.float32)
    # each row gets a distinct page run; trailing lanes unused (-1)
    pi = np.full((b, lanes), -1, np.int32)
    cl = np.zeros((b,), np.int32)
    for i in range(b):
        used = int(r.integers(min_used, lanes + 1))
        pi[i, :used] = r.choice(n_pages, size=used, replace=False)
        cl[i] = int(r.integers((used - 1) * ps + 1, used * ps + 1))
    return q, k, v, torch.from_numpy(pi), torch.from_numpy(cl)


def _chunk_case(seed: int, *, s: int = 16, **kw):
    q1, k, v, pi, cl = _decode_case(seed, **kw)
    b, h, hd = q1.shape
    r = np.random.default_rng(seed + 1)
    q = torch.tensor(r.standard_normal((b, s, h, hd)), dtype=torch.float32)
    nl = torch.clamp(cl, max=s)
    return q, k, v, pi, cl, nl


def _median_ms(fn: Callable[[], torch.Tensor]) -> float:
    """ms a call of ``fn`` on the card: ``N_CALLS`` calls captured in one
    CUDA graph and replayed, the median of ``REPS`` CUDA-event windows."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(N_CALLS):
            fn()
    graph.replay()

    def window():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / N_CALLS

    return statistics.median(window() for _ in range(REPS))


# --------------------------------------------------------------------------
# The sweep table: kernel -> (run at a knob value, its plan, the oracle).
# On the card a run forces the plan of that knob value through the
# wrapper's launcher (which counts no launch: these are comparisons); on
# the CPU it is the wrapper, i.e. the plain version.
# --------------------------------------------------------------------------


def _candidates(seed: int, dev: torch.device,
                shapes: Optional[Dict[str, dict]] = None,
                page_dtype: torch.dtype = torch.float32) -> dict:
    shapes = shapes or {"decode": {}, "chunk": {}}
    q, k, v, pi, cl = (x.to(dev) for x in _decode_case(seed,
                                                        **shapes["decode"]))
    cq, ck, cv, cpi, ccl, cnl = (x.to(dev) for x in _chunk_case(
        seed, **shapes["chunk"]))
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    ckq, cks = quantize_pages(ck)
    cvq, cvs = quantize_pages(cv)
    k, v, ck, cv = (x.to(page_dtype) for x in (k, v, ck, cv))
    cuda = dev.type == "cuda"

    def decode(kp, vp, scales, ref_fn, wrapper):
        lanes = pi.shape[1]

        def plan(c):
            return PA.decode_plan(q, kp, lanes, knob=c) if cuda else None

        def fn(c):
            if not cuda:
                return wrapper(q, kp, vp, *scales, pi, cl)
            return PA._decode(q, kp, vp, scales, pi, cl,
                              n_split=plan(c)[0])
        return dict(fn=fn, plan=plan,
                    oracle=lambda: ref_fn(q, kp, vp, *scales, pi, cl))

    def chunk(kp, vp, scales, ref_fn, wrapper):
        lanes = cpi.shape[1]

        def plan(c):
            return PCA.chunk_plan(cq, kp, lanes, knob=c) if cuda else None

        def fn(c):
            if not cuda:
                return wrapper(cq, kp, vp, *scales, cpi, ccl, cnl)
            pairs, n_split, _ = plan(c)
            return PCA._chunk(cq, kp, vp, scales, cpi, ccl, cnl,
                              n_split=n_split, pairs=pairs)
        return dict(fn=fn, plan=plan,
                    oracle=lambda: ref_fn(cq, kp, vp, *scales, cpi, ccl,
                                          cnl))

    return {
        "paged_attn": decode(k, v, (), R.paged_attn_ref, PA.paged_attention),
        "paged_attn_quant": decode(kq, vq, (ks, vs), R.paged_attn_quant_ref,
                                   PA.paged_attention_quant),
        "paged_chunk_attn": chunk(ck, cv, (), R.paged_chunk_attn_ref,
                                  PCA.paged_chunk_attention),
        "paged_chunk_attn_quant": chunk(ckq, cvq, (cks, cvs),
                                        R.paged_chunk_attn_quant_ref,
                                        PCA.paged_chunk_attention_quant),
    }


def sweep(seed: int = 0, device=None) -> dict:
    """Check, then time, every candidate of every kernel on ``device`` (the
    card unless ``"cpu"``): at :data:`CARD_SHAPES` over bf16 (K5/K6) pages
    on the card, at ``repro``'s cases over float32 pages on the CPU.
    -> report dict::

        {kernel: {"knob": str, "mode": str, "best": value,
                  "results": {value: {"ms", "readings_ms", "plan",
                                      "max_abs_err"} | "WRONG"}}}
    """
    dev = D.resolve(device)
    cuda = dev.type == "cuda"
    if cuda:
        specs = _candidates(seed, dev, CARD_SHAPES, torch.bfloat16)
    else:
        specs = _candidates(seed, dev)
    out: dict = {}
    right: Dict[str, list] = {}
    for kernel, spec in specs.items():
        knob, cands = KNOBS[kernel]
        want = spec["oracle"]().float()
        results: dict = {}
        for c in cands:
            err = float((spec["fn"](c).float() - want).abs().max())
            if not err <= TOL:
                results[c] = "WRONG"   # disqualified before timing
                continue
            plan = spec["plan"](c)
            results[c] = {"ms": None, "readings_ms": [], "max_abs_err": err,
                          "plan": None if plan is None else list(plan)}
        right[kernel] = [c for c in cands if results[c] != "WRONG"]
        out[kernel] = {"knob": knob, "mode": "cuda" if cuda else "plain",
                       "results": results, "best": None}
    if cuda:
        # every candidate of every kernel, in order and then reversed
        for order in (1, -1):
            for kernel, spec in specs.items():
                for c in right[kernel][::order]:
                    out[kernel]["results"][c]["readings_ms"].append(
                        _median_ms(lambda c=c: spec["fn"](c)))
    for kernel, r in out.items():
        r["best"] = _best(r["results"], right[kernel])
    return out


def _best(results: dict, right: list) -> Optional[int]:
    """The fastest right candidate.  A candidate whose plan is 0's launches
    the same work, so it does not compete: only plans other than the
    built-in one can displace 0.  Untimed (the CPU): 0 if it is right."""
    for c in right:
        rec = results[c]
        if rec["readings_ms"]:
            rec["ms"] = statistics.mean(rec["readings_ms"])
    if not right:
        return None
    if any(results[c]["ms"] is None for c in right):
        return 0 if 0 in right else None
    if 0 in right:
        right = [0] + [c for c in right
                       if results[c]["plan"] != results[0]["plan"]]
    return min(right, key=lambda c: results[c]["ms"])


def merge(path: str, card: str, report: dict) -> dict:
    """Merge ``report``'s winners into the table at ``path`` under
    ``card``; every other card's entries stay.  -> the table written."""
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    for kernel, r in report.items():
        if r["best"] is None:
            continue
        table.setdefault(kernel, {}).setdefault(card, {})[r["knob"]] = \
            r["best"]
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    return table


def run(out_path: Optional[str] = None, seed: int = 0, device=None,
        card: Optional[str] = None) -> dict:
    """Sweep and, with ``out_path``, merge the winners into a tuning table
    under ``card`` (default: the card's name; the CPU, which times nothing,
    writes no entry unless ``card`` is given)."""
    dev = D.resolve(device)
    report = sweep(seed=seed, device=dev)
    if card is None and dev.type == "cuda":
        card = torch.cuda.get_device_name(dev)
    if out_path and card is not None:
        merge(out_path, card, report)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.autotune",
        description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="tuning table to merge the winners into")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' checks the plain versions and times "
                    "nothing; default: the CUDA card")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    report = run(args.out, seed=args.seed, device=dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device={name} mode={mode(dev)}")
    for kernel, r in report.items():
        print(f"  {kernel} ({r['knob']}):")
        for c, rec in r["results"].items():
            mark = " <- best" if c == r["best"] else ""
            if rec == "WRONG":
                val = "WRONG"
            elif rec["ms"] is None:
                val = f"checked, err {rec['max_abs_err']:.2e}"
            else:
                val = (f"{rec['ms'] * 1e3:9.3f} us  plan {rec['plan']}  "
                       f"err {rec['max_abs_err']:.2e}")
            print(f"    {c:>5}: {val}{mark}")
    if args.out and dev.type == "cuda":
        print(f"wrote winners to {args.out}")
    print(json.dumps({"autotune": report}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
