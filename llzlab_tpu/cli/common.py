"""Shared CLI plumbing: WAV in → streamed Chain → WAV out (SURVEY.md §3.1).

The reference's per-tool ``main.c`` loop (parseopt → wavfmt → per-frame
process → write) becomes: parse args → read WAV → push super-blocks
through one jitted chain with carried state → write WAV.  Supports
checkpoint/resume at block granularity (utils/checkpoint.py) and JSONL
metrics (utils/metrics.py).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from llzlab_tpu.io.wav import read_wav, write_wav
from llzlab_tpu.utils.checkpoint import load_state, save_state
from llzlab_tpu.utils.metrics import MetricsLogger, config_hash

__all__ = ["add_io_args", "pin_backend", "run_chain_tool"]


def pin_backend(args):
    """Apply ``--cpu`` and turn on the persistent compile cache BEFORE any
    jax array is created (stage constructors device-put their tap tables,
    which would initialise the default backend).  Must be the first call
    after ``parse_args`` in every tool."""
    import jax

    from llzlab_tpu.runtime.platform import enable_compile_cache

    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()


def add_io_args(p: argparse.ArgumentParser):
    p.add_argument("--input", "-i", required=True, help="input WAV")
    p.add_argument("--output", "-o", required=True, help="output WAV")
    p.add_argument("--block-seconds", type=float, default=2.0,
                   help="super-block length fed per jit step")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--checkpoint", default=None,
                   help="state checkpoint path (.npz); written per block")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    return p


def run_chain_tool(args, chain, *, out_rate_fn=lambda r: r, tool: str):
    """Stream a WAV through ``chain`` with state carry and optional
    checkpoint/resume.  Returns (out_path, Msamples/s)."""
    import jax

    pin_backend(args)
    import jax.numpy as jnp

    x, rate = read_wav(args.input)
    c, t = x.shape
    m = chain.block_multiple
    blk = max(int(args.block_seconds * rate) // m, 1) * m
    log = MetricsLogger(args.metrics, echo=True)
    chash = config_hash({"tool": tool, "blk": blk, "rate": rate})
    log.event("start", tool=tool, channels=c, samples=t, rate=rate,
              block=blk, config=chash)

    state = chain.init_state((c,))
    start_block = 0
    if args.resume and args.checkpoint:
        state, start_block, _ = load_state(args.checkpoint, like=state)
        log.event("resume", block=start_block)

    apply_fn = jax.jit(chain.apply)
    outs = []
    n_blocks = -(-t // blk)
    total_in = 0
    t0 = time.perf_counter()
    for bi in range(n_blocks):
        seg = x[:, bi * blk : (bi + 1) * blk]
        if seg.shape[-1] < blk:  # zero-pad tail block, trim after
            pad = blk - seg.shape[-1]
            seg = np.pad(seg, ((0, 0), (0, pad)))
        else:
            pad = 0
        if bi < start_block:
            continue  # blocks already processed before checkpoint
        y, state = apply_fn(jnp.asarray(seg), state)
        y = np.asarray(y)
        if pad:
            keep = y.shape[-1] * (blk - pad) // blk
            y = y[..., :keep]
        outs.append(y)
        total_in += blk - pad
        if args.checkpoint:
            save_state(args.checkpoint, state, block_index=bi + 1,
                       config_hash=chash)
    dt = time.perf_counter() - t0
    y_all = np.concatenate(outs, axis=-1) if outs else np.zeros((c, 0))
    out_rate = out_rate_fn(rate)
    write_wav(args.output, y_all.astype(np.float32), int(out_rate))
    msps = c * total_in / dt / 1e6 if dt > 0 else 0.0
    log.event("done", out_samples=y_all.shape[-1], seconds=round(dt, 3),
              msps=round(msps, 2))
    return args.output, msps
