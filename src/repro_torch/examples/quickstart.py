"""Quickstart: train a ~100M-param llama3-family model for a few hundred
steps on the deterministic synthetic corpus, with async checkpointing and
restart-on-failure: the end-to-end training script.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 300]
        [--device cpu]

The twin of ``repro``'s ``examples/quickstart.py``: the same arguments,
model, WSD schedule, data and checkpoint cadence.  It runs on the CUDA card
unless given ``--device cpu``, and resumes from the newest checkpoint in
``--ckpt-dir`` when there is one.  The step is ``jit_train_step``: one CUDA
graph on the card that updates the trees in place, where ``repro`` jits
the step.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

from ..data import DataConfig, make_batches
from ..device import resolve
from ..ft.checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..ft.elastic import reshard_tree
from ..models import model as M
from ..models.common import ModelConfig
from ..training.optimizer import OptimizerConfig, adamw_init
from ..training.train_step import TrainConfig, jit_train_step


def main(argv=None) -> float:
    """Train; returns the final loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_quickstart_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    # CPU-friendly overrides (the 100M default targets a real accelerator)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    # default: ~100M params, llama3-family, reduced
    cfg = ModelConfig(
        name="llama3-100m", family="dense", n_layers=args.layers,
        d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=args.d_model // 8, d_ff=4 * args.d_model, vocab=32768,
        tie_embeddings=True)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                          schedule="wsd")
    data = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    params = M.init_params(0, cfg, device=dev)
    state = adamw_init(params, opt)
    n = sum(x.numel() for x in M.leaves(params))
    print(f"model: {n/1e6:.1f}M params")

    start = 0
    last = latest_step(args.ckpt_dir)
    if last is not None:
        print(f"resuming from checkpoint step {last}")
        like = {"params": params, "state": state}
        restored = reshard_tree(load_checkpoint(args.ckpt_dir, last, like),
                                like, device=dev)
        params, state = restored["params"], restored["state"]
        start = last

    step = jit_train_step(cfg, opt, tcfg=TrainConfig(remat="none"))
    it = make_batches(data, start_step=start)
    t0 = time.time()
    m = None
    for s in range(start, args.steps):
        params, state, m = step(params, state, next(it))
        if (s + 1) % 20 == 0:
            print(f"step {s+1:4d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"({(s + 1 - start) / (time.time() - t0):.2f} it/s)",
                  flush=True)
        if (s + 1) % args.ckpt_every == 0:
            mgr.save_async(s + 1, {"params": params, "state": state})
    mgr.wait()
    if m is None:
        print(f"nothing to do: checkpoint step {start} >= --steps")
        return float("nan")
    loss = float(m["loss"])
    print(f"done; final loss {loss:.4f}; checkpoints at {args.ckpt_dir}")
    return loss


if __name__ == "__main__":
    main()
