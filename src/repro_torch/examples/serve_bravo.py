"""Serve a small model with batched requests under concurrent weight
hot-swap, comparing the engine's model-epoch lock implementations: the
paper's technique as a first-class serving feature.

    PYTHONPATH=src python -m repro_torch.examples.serve_bravo
        [--locks bravo-ba,ba,bravo-pthread] [--requests 8] [--device cpu]

The twin of ``repro``'s ``examples/serve_bravo.py``: the smoke llama3.2-1b
(weights from seed 0) in handler mode, one handler of two slots,
``max_seq`` 24, 8 requests of 6 prompt and 6 new tokens, a weight swap
every 0.25 s and page compaction every 0.4 s, once for each lock; each
prints tokens/s, decode steps, swaps and the model lock's fast-path share
and revocations.  ``repro`` builds a one-device ``Mesh`` and
``MeshRules``; on one card there is nothing to shard, so the port has no
counterpart.  It runs on the CUDA card unless given ``--device cpu``; on
the card the handler's prefill and decode steps run as CUDA graphs.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from .. import configs
from ..device import DeviceLike, resolve
from ..models import model as M
from ..serving.engine import Request, ServingEngine


def run_once(lock_name: str, n_requests: int = 8,
             device: DeviceLike = None) -> Dict:
    """Serve ``n_requests`` under swaps and compaction with ``lock_name``
    guarding the model epoch; print the lock's line and return its
    readings."""
    dev = resolve(device)
    cfg = configs.get_smoke("llama3.2-1b")
    params = M.init_params(0, cfg, device=dev)
    eng = ServingEngine(cfg, params, lock_name=lock_name, handlers=1,
                        max_seq=24, slots_per_handler=2, device=dev)
    # background writers: weight hot-swap + page compaction
    eng.start(swap_period_s=0.25, compact_period_s=0.4)
    t0 = time.time()
    rng = np.random.default_rng(0)
    # fixed prompt length -> one (B, S) prefill shape per batch size
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab, size=6).astype(
                        np.int32),
                    max_new=6) for i in range(n_requests)]
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        if not r.done.wait(timeout=900):
            eng.stop()
            raise TimeoutError(f"request {r.rid} timed out")
    dt = time.time() - t0
    eng.stop()
    st = eng.lock_stats()
    engs = st["engine"]
    out = {"lock": lock_name, "tokens_per_s": engs["tokens_out"] / dt,
           "decode_steps": engs["decode_steps"],
           "weight_swaps": engs["weight_swaps"],
           "sample": reqs[0].out.tolist(),
           "handler_steps": st["handler_steps"]}
    line = (f"{lock_name:16s} {out['tokens_per_s']:8.1f} tok/s  "
            f"decode_steps={out['decode_steps']} "
            f"swaps={out['weight_swaps']}")
    if "model" in st:
        ms = st["model"]
        tot = ms["fast_acquires"] + ms["slow_acquires"]
        out.update(fast_acquires=ms["fast_acquires"], acquires=tot,
                   revocations=ms["revocations"])
        line += (f"  fast-path={ms['fast_acquires']}/{tot} "
                 f"({100*ms['fast_acquires']/max(tot,1):.1f}%) "
                 f"revocations={ms['revocations']}")
    print(line, flush=True)
    print("  sample completion:", out["sample"])
    return out


def main(argv=None) -> List[Dict]:
    """Run each lock in turn; -> each lock's readings."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--locks", default="bravo-ba,ba,bravo-pthread")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    return [run_once(lock.strip(), args.requests, args.device)
            for lock in args.locks.split(",")]


if __name__ == "__main__":
    main()
