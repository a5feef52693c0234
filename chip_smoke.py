#!/usr/bin/env python
"""Smoke test of llzlab_tpu on one NVIDIA GPU, through the public entry
points, at the BASELINE sizes.

    python chip_smoke.py              # one card: headline, configs 1-5, CLI
    python chip_smoke.py --devices 4  # four cards: the sharded chains only

Every phase checks its output against an independent float64 reference
(scipy / numpy) at >= 80 dB and prints one line: engine, shapes, SNR,
ms per step and compile seconds.  The script stops at the first failure
with a non-zero exit code.  The last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

It runs in one process (a JAX process reserves most of the card's
memory) and needs a GPU: on any other backend it exits non-zero before
doing any work.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np

MIN_SNR_DB = 80.0

#: phase shapes (channels, samples per step[, steps]) — BASELINE sizes
SIZES = {
    "headline": (64, 245760, 3),
    "config1": (1, 480000),
    "config2": (8, 96000),
    "config3": (64, 94208),
    "config4": (256, 94208),
    "config5": (1024, 2),          # samples per step: block_multiple()
    "sosfilt_sharded": (64, 94208),  # per time shard
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, default=1, choices=[1, 4],
                   help="1: the one-card phases; 4: only the sharded "
                        "chains on a four-card mesh")
    return p.parse_args(argv)


def require_gpu(n_devices: int):
    """The JAX devices, if the backend is the GPU with enough cards;
    raises SystemExit otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform "
                         f"{devs[0].platform!r})")
    if len(devs) < n_devices:
        raise SystemExit(f"chip_smoke: need {n_devices} GPUs, "
                         f"found {len(devs)}")
    return devs[:n_devices]


def result_line(devs) -> str:
    """The final JSON line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def snr_db(ref, y) -> float:
    """Minimum over rows (channels) of the signal-to-error ratio."""
    ref = np.asarray(ref)
    y = np.asarray(y)
    ref = ref.reshape(ref.shape[0], -1) if ref.ndim > 1 else ref[None]
    y = y.reshape(ref.shape)
    err = np.sum(np.abs(ref - y) ** 2, axis=-1)
    sig = np.sum(np.abs(ref) ** 2, axis=-1)
    with np.errstate(divide="ignore"):
        return float(np.min(10 * np.log10(sig / err)))


def split_note(whole, parts) -> str:
    """Split-versus-unsplit comparison: bit-exact, or the SNR in dB."""
    whole = np.asarray(whole)
    parts = np.asarray(parts)
    if np.array_equal(whole, parts):
        return "bit-exact"
    return f"{snr_db(whole, parts):.1f} dB"


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


class Phase:
    """Times a jitted step: compile seconds (first call minus a steady
    call) and ms per steady step."""

    def __init__(self, name):
        self.name = name
        self.compile_s = 0.0
        self.ms = float("nan")

    def time(self, fn, *args, reps=5):
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        steady = (time.perf_counter() - t0) / reps
        self.compile_s = max(first - steady, 0.0)
        self.ms = steady * 1e3
        return out

    def report(self, engine, shape, snr, extra=""):
        print(f"[{self.name}] engine={engine} shape={shape} "
              f"snr={snr:.2f}dB ms/step={self.ms:.3f} "
              f"compile={self.compile_s:.1f}s {extra}".rstrip(), flush=True)
        if not snr >= MIN_SNR_DB:
            raise SystemExit(f"chip_smoke: {self.name} SNR {snr:.2f} dB "
                             f"< {MIN_SNR_DB} dB")


def headline(lz, jax, jnp, ss):
    """FusedFirResampleStage, 64 ch x 245 760, 3 streamed steps, at both
    precision tiers."""
    from llzlab_tpu.pipeline import Chain, FusedFirResampleStage

    c, t, steps = SIZES["headline"]
    taps = lz.firwin(1024, 0.25, window="hamming")
    rtaps = lz.resample_taps(147, 160, 64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((c, steps * t)).astype(np.float32)
    y64 = ss.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    z64 = ss.upfirdn(rtaps, y64, 147, 160, axis=-1)
    xd = jnp.asarray(x)
    for prec in ("high", "highest"):
        stage = FusedFirResampleStage(taps, 147, 160, rtaps=rtaps,
                                      precision=prec)
        chain = Chain([stage])
        step = jax.jit(chain.apply)
        ph = Phase(f"headline/{prec}")
        state = chain.init_state((c,))
        ph.time(step, xd[:, :t], state)
        outs = []
        for i in range(steps):
            y, state = step(xd[:, i * t:(i + 1) * t], state)
            outs.append(np.asarray(y))
        z = np.concatenate(outs, axis=-1)
        whole = np.asarray(jax.jit(chain.__call__)(xd))
        ph.report(stage.engine, f"{c}x{t}x{steps}",
                  snr_db(z64[:, :z.shape[-1]], z),
                  f"split-vs-unsplit={split_note(whole, z)}")


def config1(lz, jax, jnp, ss):
    taps = lz.firwin(1024, 0.25, window="hamming")
    c, t = SIZES["config1"]
    x = np.random.default_rng(1).standard_normal((c, t)).astype(np.float32)
    ph = Phase("config1/fir")
    y = ph.time(jax.jit(lambda v: lz.fir_filter(v, taps)), jnp.asarray(x))
    ref = ss.lfilter(taps, [1.0], x.astype(np.float64), axis=-1)
    from llzlab_tpu.ops.fir import fir_method_auto

    ph.report(fir_method_auto(1024), f"{c}x{t}", snr_db(ref, y))


def config2(lz, jax, jnp, ss):
    rtaps = lz.resample_taps(147, 160, 64)
    c, t = SIZES["config2"]
    x = np.random.default_rng(2).standard_normal((c, t)).astype(np.float32)
    ph = Phase("config2/resample")
    y = ph.time(jax.jit(lambda v: lz.resample_poly(v, 147, 160,
                                                   taps=rtaps)),
                jnp.asarray(x))
    ref = ss.upfirdn(rtaps, x.astype(np.float64), 147, 160, axis=-1)
    ph.report("polyphase slab", f"{c}x{t}",
              snr_db(ref[:, :y.shape[-1]], y))


def eq_sos(lz):
    return lz.peaking_eq_sos(
        [100, 200, 400, 800, 1600, 3200, 6400, 12800],
        [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0)


def config3(lz, jax, jnp, ss):
    sos = eq_sos(lz)
    c, t = SIZES["config3"]
    x = np.random.default_rng(3).standard_normal((c, t)).astype(np.float32)
    step = jax.jit(lambda v, z: lz.sosfilt(sos, v, zi=z, return_zf=True))
    ph = Phase("config3/sosfilt")
    zi = jnp.zeros((c, sos.shape[0], 2), jnp.float32)
    ph.time(step, jnp.asarray(x[:, :t // 2]), zi)
    y1, zf = step(jnp.asarray(x[:, :t // 2]), zi)
    y2, _ = step(jnp.asarray(x[:, t // 2:]), zf)   # carried state
    y = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
    ref = ss.sosfilt(sos, x.astype(np.float64), axis=-1)
    ph.report("scan", f"{c}x{t} in 2 blocks", snr_db(ref, y))


def wola_gain_f64(xs, gain, n_fft=2048, hop=512):
    """Independent numpy-f64 one-shot istft(gain·stft(x)): causal
    framing at 0, periodic Hann, window-square envelope division."""
    import scipy.signal as ss

    w = ss.get_window("hann", n_fft).astype(np.float64)
    nf = 1 + (xs.shape[-1] - n_fft) // hop
    idx = np.arange(n_fft) + hop * np.arange(nf)[:, None]
    syn = np.fft.irfft(np.fft.rfft(xs[:, idx] * w, axis=-1) * gain, n_fft,
                       axis=-1) * w
    out_len = n_fft + (nf - 1) * hop
    y = np.zeros((xs.shape[0], out_len))
    env = np.zeros(out_len)
    for i in range(nf):
        y[:, i * hop:i * hop + n_fft] += syn[:, i]
        env[i * hop:i * hop + n_fft] += w * w
    return y / np.maximum(env, 1e-8)


def config4(lz, jax, jnp, ss):
    from llzlab_tpu.pipeline import SpectralGainStage

    c, t = SIZES["config4"]
    gain = np.linspace(1.0, 0.5, 1025)
    x = np.random.default_rng(4).standard_normal((c, t)).astype(np.float32)
    ref = wola_gain_f64(x.astype(np.float64), gain)
    for prec in ("high", "highest"):
        stage = SpectralGainStage(gain.astype(np.float32), precision=prec)
        step = jax.jit(stage.apply)
        ph = Phase(f"config4/stft_gain/{prec}")
        st = stage.init_state((c,))
        half = t // 2
        ph.time(step, jnp.asarray(x[:, :half]), st)
        ys = []
        for blk in (x[:, :half], x[:, half:]):
            yb, st = step(jnp.asarray(blk), st)
            ys.append(np.asarray(yb))
        ys.append(np.asarray(stage.flush(st)))
        cut = np.concatenate(ys, axis=-1)[:, stage.latency:]
        # skip both window-square envelope ramps (start and flush tail),
        # where 1/env amplifies any engine's rounding
        skip = stage.latency + (stage.n_fft - stage.hop)
        n = min(cut.shape[-1], ref.shape[-1]) - 2 * stage.n_fft
        ph.report(stage.engine, f"{c}x{t} in 2 blocks + flush",
                  snr_db(ref[:, skip:n], cut[:, skip:n]))


def channelizer_ref(chan, x):
    """f64 FIR → resample → rfft frames of ``x`` (C, T), complex."""
    import scipy.signal as ss

    y = ss.lfilter(chan.fir_taps, [1.0], x.astype(np.float64), axis=-1)
    z = ss.upfirdn(chan.resample_taps, y, chan.up, chan.down, axis=-1)
    nf = (x.shape[-1] * chan.up // chan.down) // chan.fft_n
    z = z[:, :nf * chan.fft_n].reshape(x.shape[0], nf, chan.fft_n)
    return np.fft.rfft(z, axis=-1)


def pair_complex(spec):
    spec = np.asarray(spec, np.float64)
    h = spec.shape[-1] // 2
    return spec[..., :h] + 1j * spec[..., h:]


def config5(lz, jax, jnp, ss):
    from llzlab_tpu.chains.channelizer import Channelizer

    chan = Channelizer(spec_format="pair")
    (c, steps), m = SIZES["config5"], chan.block_multiple()
    x = jax.random.normal(jax.random.PRNGKey(5), (c, steps * m),
                          jnp.float32)
    step = jax.jit(chan.step)
    ph = Phase("config5/channelizer")
    st = chan.init_state(c)
    ph.time(step, x[:, :m], st)
    specs = []
    for i in range(steps):
        s, st = step(x[:, i * m:(i + 1) * m], st)
        specs.append(np.asarray(s[:8]))
    got = pair_complex(np.concatenate(specs, axis=1))
    ref = channelizer_ref(chan, np.asarray(x[:8]))
    engine = chan.fir_method + (f"({chan.fused_engine})"
                                if chan.fir_method == "fused" else "")
    ph.report(f"{engine}+pair_rdft", f"{c}x{m}x{steps} (SNR on 8 ch)",
              snr_db(ref, got))


def cli_phase(lz):
    from llzlab_tpu.cli import fir as fir_cli
    from llzlab_tpu.io.wav import read_wav, write_wav

    rate = 48000
    t = np.arange(10 * rate) / rate
    x = (0.5 * np.sin(2 * np.pi * 1000 * t)
         + 0.5 * np.sin(2 * np.pi * 18000 * t)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.wav"), os.path.join(d, "out.wav")
        write_wav(src, x[None, :], rate)
        t0 = time.perf_counter()
        fir_cli.main(["-i", src, "-o", dst, "--taps", "1024",
                      "--cutoff", "0.25"])
        wall = time.perf_counter() - t0
        y, _ = read_wav(dst)
    y = y[0, 2048:]
    win = np.hanning(len(y))
    spec = np.abs(np.fft.rfft(y * win))
    xs = np.abs(np.fft.rfft(x[2048:] * win))
    f = np.fft.rfftfreq(len(y), 1 / rate)
    b1, b18 = np.argmin(np.abs(f - 1000)), np.argmin(np.abs(f - 18000))
    keep = 20 * np.log10(spec[b1] / xs[b1])
    drop = 20 * np.log10(xs[b18] / max(spec[b18], 1e-30))
    print(f"[cli/fir] 10 s 48 kHz WAV: 1 kHz {keep:+.2f} dB, 18 kHz "
          f"down {drop:.1f} dB, wall {wall:.2f}s", flush=True)
    if not (abs(keep) < 0.1 and drop >= 90.0):
        raise SystemExit("chip_smoke: cli/fir tone check failed")


def sharded(lz, jax, jnp, devs):
    """Four cards: the sharded channelizer (2x2 mesh, ppermute halo,
    with and without halo_overlap) against the one-card step, and the
    sharded IIR carry-scan (1x4 mesh) against lz.sosfilt."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from llzlab_tpu.chains.channelizer import Channelizer
    from llzlab_tpu.parallel import sharded_ops as so
    from llzlab_tpu.parallel.mesh import (CHANNEL_AXIS, TIME_AXIS,
                                          make_dsp_mesh)

    # the fused engine: the one halo_overlap supports besides block2
    chan = Channelizer(spec_format="pair", fir_method="fused")
    mesh = make_dsp_mesh(2, 2, devices=devs)
    (c, steps), m = SIZES["config5"], chan.block_multiple()
    t = 2 * m                                   # per step, 2 time shards
    x = jax.random.normal(jax.random.PRNGKey(6), (c, steps * t),
                          jnp.float32)
    one = jax.jit(chan.step)
    ph = Phase("sharded/1card")
    st = chan.init_state(c)
    ph.time(one, x[:, :t], st)
    ref = []
    for i in range(steps):
        s, st = one(x[:, i * t:(i + 1) * t], st)
        ref.append(np.asarray(s))
    ref = np.concatenate(ref, axis=1)
    print(f"[sharded/1card] engine={chan.fir_method} shape={c}x{t}x{steps}"
          f" ms/step={ph.ms:.3f} compile={ph.compile_s:.1f}s", flush=True)
    xs = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
    ss_ = NamedSharding(mesh, P(CHANNEL_AXIS, None))
    for overlap in (False, True):
        step = chan.sharded_step(mesh, halo_overlap=overlap)
        ph = Phase(f"sharded/2x2/halo_overlap={overlap}")
        st = tuple(jax.device_put(s, ss_) for s in chan.init_state(c))
        ph.time(step, jax.device_put(x[:, :t], xs), st)
        outs = []
        for i in range(steps):
            s, st = step(jax.device_put(x[:, i * t:(i + 1) * t], xs), st)
            outs.append(np.asarray(s))
        got = np.concatenate(outs, axis=1)
        ph.report(f"{chan.fir_method}+ppermute", f"{c}x{t}x{steps}",
                  snr_db(pair_complex(ref), pair_complex(got)),
                  f"vs-1card={split_note(ref, got)}")

    sos = eq_sos(lz)
    mesh14 = make_dsp_mesh(1, 4, devices=devs)
    ci, ti = SIZES["sosfilt_sharded"]
    xi = jax.random.normal(jax.random.PRNGKey(7), (ci, 4 * ti),
                           jnp.float32)
    xi_sh = jax.device_put(xi, NamedSharding(mesh14,
                                             P(CHANNEL_AXIS, TIME_AXIS)))
    ph1 = Phase("sharded/sosfilt/1card")
    y1 = np.asarray(ph1.time(jax.jit(lambda v: lz.sosfilt(sos, v)), xi))
    ph = Phase("sharded/sosfilt/1x4")
    y4 = np.asarray(ph.time(
        lambda v: so.sosfilt_sharded(v, sos, mesh14, jitted=True), xi_sh))
    ph.report("scan carry", f"{ci}x{4 * ti}", snr_db(y1, y4),
              f"vs-1card={split_note(y1, y4)} 1card-ms/step={ph1.ms:.3f}")


def main(argv=None):
    args = parse_args(argv)
    import jax

    devs = require_gpu(args.devices)
    import jax.numpy as jnp
    import scipy.signal as ss

    import llzlab_tpu as lz
    from llzlab_tpu.runtime.platform import enable_compile_cache

    cache = enable_compile_cache()
    print(nvidia_smi(), flush=True)
    print(f"device_kind={devs[0].device_kind} | jax {jax.__version__} | "
          f"devices={len(devs)} | compile cache={cache}", flush=True)
    t0 = time.perf_counter()
    if args.devices == 4:
        sharded(lz, jax, jnp, devs)
    else:
        for phase in (headline, config1, config2, config3, config4,
                      config5):
            phase(lz, jax, jnp, ss)
        cli_phase(lz)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(result_line(devs), flush=True)


if __name__ == "__main__":
    main()
