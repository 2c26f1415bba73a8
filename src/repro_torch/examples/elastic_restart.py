"""Fault-tolerance drill: train, kill mid-run, restart from the last
committed checkpoint with a CHANGED worker count (elastic rescale), and
verify the loss trajectory continues; a straggling host is detected and
excluded from the new membership.

    PYTHONPATH=src python -m repro_torch.examples.elastic_restart
        [--device cpu] [--ckpt-dir DIR]

The twin of ``repro``'s ``examples/elastic_restart.py``: the smoke llama,
4 "hosts" with host 3 slow, a crash at step 25, the restart from the last
committed checkpoint on 3 hosts, the data pipeline's shard index
rebalanced from 4 loaders to 3 (the writer path of its BRAVO lock), and
15 more steps.  It runs on the CUDA card unless given ``--device cpu``.
The step is ``jit_train_step``, one CUDA graph on the card, where
``repro`` jits it; the restored trees are new, so the step's first call
after the restart runs eagerly and its second captures again.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

from .. import configs
from ..core.factory import LockEnv
from ..data import DataConfig, ShardIndex, make_batches
from ..device import resolve
from ..ft.checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..ft.elastic import remicrobatch, reshard_tree
from ..ft.straggler import StragglerDetector
from ..models import model as M
from ..training.optimizer import OptimizerConfig, adamw_init
from ..training.train_step import TrainConfig, jit_train_step

CRASH_AT = 25


def main(argv=None) -> dict:
    """Run the drill; returns its readings (the stragglers, the step
    resumed from, the losses before the crash and after the restart)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_elastic_ckpt"))
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    ckpt = args.ckpt_dir
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = configs.get_smoke("llama3.2-1b")
    opt = OptimizerConfig(lr=2e-3, warmup_steps=5)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=16)
    mgr = CheckpointManager(ckpt, keep=2)
    det = StragglerDetector(hosts=4, slow_factor=2.0)

    params = M.init_params(0, cfg, device=dev)
    state = adamw_init(params, opt)
    step = jit_train_step(cfg, opt, TrainConfig(remat="none"))
    out = {"run1": [], "run2": []}

    # ---- phase 1: 4 "hosts", host 3 is slow; crash at step 25 ----
    it = make_batches(data)
    for s in range(CRASH_AT):
        params, state, m = step(params, state, next(it))
        out["run1"].append(float(m["loss"]))
        for h in range(4):
            det.heartbeat(h, 100.0 if h != 3 else 350.0)
        if (s + 1) % 10 == 0:
            mgr.save_async(s + 1, {"params": params, "state": state})
            print(f"[run1] step {s+1} loss {out['run1'][-1]:.4f} "
                  f"(checkpoint)")
    mgr.wait()
    snap = det.snapshot()
    out["stragglers"] = snap["stragglers"]
    print(f"[run1] CRASH simulated at step {CRASH_AT}. "
          f"stragglers={snap['stragglers']}")

    # ---- phase 2: restart on 3 hosts (straggler excluded) ----
    last = latest_step(ckpt)
    out["resumed_from"] = last
    out["microbatches"] = remicrobatch(data.global_batch, 1, 4096,
                                       data.seq_len)
    print(f"[run2] resuming from step {last} on 3 hosts "
          f"(excluded host 3); remicrobatch -> {out['microbatches']}")
    like = {"params": params, "state": state}
    restored = reshard_tree(load_checkpoint(ckpt, last, like), like,
                            device=dev)
    params, state = restored["params"], restored["state"]
    # elastic data rebalance: 4 loaders -> 3 (writer path of the shard lock)
    env = LockEnv()
    idx = ShardIndex(data.n_shards, 4, env.make("bravo-ba"))
    idx.rebalance(3)
    out["index_epoch"] = idx.epoch
    it = make_batches(data, start_step=last, index=idx)
    for s in range(last, last + 15):
        params, state, m = step(params, state, next(it))
        out["run2"].append(float(m["loss"]))
    print(f"[run2] step {s+1} loss {out['run2'][-1]:.4f} — continued "
          f"cleanly after elastic restart")
    return out


if __name__ == "__main__":
    main()
