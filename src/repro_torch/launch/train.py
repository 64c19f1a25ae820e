"""Training entry point (port of the JAX package's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch llama31_8b --reduced --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/run1

Trains on the card unless ``--device cpu``; ``--full`` trains the
published config.  Fault tolerance comes from ``TrainingRunner``
(checkpoint/restart, straggler flagging, deterministic data).  The run
uses deterministic kernels (:func:`deterministic`), so a resumed run
equals an uninterrupted one bit for bit.
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM, eval_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     RunnerConfig,
                                                     TrainingRunner)
from repro_torch.models import api
from repro_torch.obs.clock import now
from repro_torch.optim import adamw


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels for the block: the embedding and gather
    backwards accumulate by index, with atomics on the card and across
    threads on the CPU, so two runs of one step could differ in the last
    bit.  Sets cuBLAS's workspace config that the mode requires on CUDA
    and turns off its NaN fill of fresh allocations; the previous
    settings come back after."""
    import torch.utils.deterministic as tud
    prev = (torch.are_deterministic_algorithms_enabled(),
            os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
            tud.fill_uninitialized_memory)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    tud.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0])
        if prev[1] is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[1]
        tud.fill_uninitialized_memory = prev[2]


def train(arch: str = "llama31_8b", use_reduced: bool = True,
          steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 1e-3, ckpt_dir: str = None, ckpt_every: int = 50,
          remat: str = "none", accum: int = 1, seed: int = 0,
          compress_grads: bool = False, fail_at: tuple = (),
          mesh=None, log=print, device="cuda"):
    """Returns (params, cfg, data_cfg, metrics_hist, final held-out
    loss).  ``metrics_hist`` holds one dict per executed step: the step's
    ``loss``, ``grad_norm`` and ``lr``, and ``step_s``, its seconds until
    those reached the host.  ``mesh`` is accepted and unused, as in the
    reference."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if use_reduced:
        cfg = reduced(cfg)
    opt_cfg = adamw.AdamWConfig(lr_peak=lr, warmup_steps=max(steps // 20, 5),
                                decay_steps=steps,
                                compress_grads=compress_grads)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch, seed=seed)
    ds = SyntheticLM(data_cfg)

    params = api.init_model(cfg, seed, device=dev)
    opt_state = adamw.init(params, opt_cfg)
    train_step = api.make_train_step(cfg, opt_cfg, remat=remat,
                                     accum_steps=accum)
    metrics_hist = []

    def step_fn(state, batch_tokens):
        params, opt_state = state
        t0 = now()
        params, opt_state, metrics = train_step(params, opt_state,
                                                {"tokens": batch_tokens})
        rec = {k: float(v) for k, v in metrics.items()}
        rec["step_s"] = now() - t0
        metrics_hist.append(rec)
        return (params, opt_state), metrics

    def batch_fn(step):
        return torch.from_numpy(ds.batch(step)).to(dev)

    with deterministic():
        if ckpt_dir:
            ckpt = CheckpointManager(ckpt_dir, keep=2, async_save=True)
            runner = TrainingRunner(
                RunnerConfig(total_steps=steps, checkpoint_every=ckpt_every),
                ckpt, injector=FailureInjector(fail_at) if fail_at else None,
                log=log)
            state = runner.run((params, opt_state), step_fn, batch_fn,
                               metadata={"arch": arch})
        else:
            state = (params, opt_state)
            for s in range(steps):
                state, m = step_fn(state, batch_fn(s))
                if s % max(steps // 10, 1) == 0:
                    log(f"step {s} loss={float(m['loss']):.4f}")
    params = state[0]
    del state, opt_state

    # held-out eval
    ev = torch.from_numpy(eval_batch(data_cfg)).to(dev)
    with torch.no_grad():
        final = float(api.make_loss_fn(cfg)(params, {"tokens": ev}))
    log(f"final held-out loss: {final:.4f} "
        f"(init ~{np.log(cfg.vocab_size):.2f})")
    return params, cfg, data_cfg, metrics_hist, final


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama31_8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs the "
                         "reduced quickstart here)")
    args = ap.parse_args()
    train(args.arch, args.reduced, args.steps, args.batch, args.seq,
          args.lr, args.ckpt_dir, args.ckpt_every, args.remat, args.accum,
          compress_grads=args.compress_grads, device=args.device)


if __name__ == "__main__":
    main()
