#!/usr/bin/env python
"""Bench all five BASELINE workloads (BASELINE.json:6-12) on one chip.

Importable: ``run_all(...)`` returns one dict per workload (bench.py
embeds them in the driver JSON record).  As a script, prints one JSON
line per workload (stderr gets human detail).  Each measurement loop
runs on-device via lax.scan (see bench.py).

    python bench/all_configs.py [--cpu] [--iters 10] [--channels5 64]
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _snr(ref, y):
    ref = np.asarray(ref)
    y = np.asarray(y)
    e = np.abs(ref - y)
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(e**2)))


def run_all(iters: int = 10, seconds: float = 2.0, channels5: int = 1024):
    """Measure the five BASELINE configs on the current backend.

    ``channels5``: channelizer row channel count — default 1024, the
    BASELINE.json:11 spec shape.  Its input is generated ON DEVICE
    (keyed jax.random); the SNR golden checks a small channel slice
    fetched D2H (channels are independent).  Roofline fractions are
    reported on the GPU only.
    """
    import jax
    import jax.numpy as jnp
    import scipy.signal as ss
    from jax import lax

    import llzlab_tpu as lz
    from llzlab_tpu.ops.fir import fir_method_auto, fir_state_len
    from llzlab_tpu.utils.profiling import roofline_report

    dev = jax.devices()[0]
    _log(f"backend={jax.default_backend()} {dev.device_kind}")
    on_gpu = jax.default_backend() == "gpu"
    rng = np.random.default_rng(0)
    results = []

    def run_scanned(step_fn, state0, x, n):
        """Per-step seconds over an n-step on-device lax.scan: the wall
        of one jitted call, as measured, over n.

        Anti-DCE/LICM: the probe is the FULL-output sum, scaled to an
        underflowing ~1e-27 and added to the next iteration's input —
        every element is consumed and the body is never loop-invariant,
        so XLA cannot slice away or hoist work for pure-XLA engines.
        """
        @jax.jit
        def go(v, st):
            def body(carry, _):
                c, eps = carry
                out, c2 = step_fn(v + eps, c)
                # abs() = nonlinear probe; a plain sum collapses
                # through linear XLA engines
                e2 = ((jnp.sum(jnp.abs(jnp.real(out)))
                       + (jnp.sum(jnp.abs(jnp.imag(out)))
                          if jnp.iscomplexobj(out) else 0.0))
                      * 1e-30).astype(jnp.float32)
                return (c2, e2), ()
            (c, eps), _ = lax.scan(
                body, (st, jnp.float32(0)), None, length=n)
            return eps

        _ = np.asarray(go(x, state0))
        best = 1e9
        for _i in range(2):
            t0 = time.perf_counter()
            _ = np.asarray(go(x, state0))
            best = min(best, time.perf_counter() - t0)
        return best / n

    # Shared roofline cost models (bench/cost_models.py) — the
    # cross-checked single source (tests/bench/test_cost_models.py
    # asserts them against XLA's compiled cost_analysis).
    from bench import cost_models as cm

    _prec = os.environ.get("LLZ_MATMUL_PRECISION", "highest").lower()
    _passes = cm.passes(_prec)

    def report(name, msps, snr_db, flops_per_sample=None,
               bytes_per_sample=None, dt=None, samples=None, **extra):
        rec = {"config": name, "msps_per_chip": round(msps, 1),
               "snr_db": round(snr_db, 1), **extra}
        if bytes_per_sample is not None and on_gpu:
            # Per-row speed-of-light position: the flops model counts
            # bf16-pass FLOPs of the row's engine formulation (none for
            # an FFT-library engine); bytes counts the op's device-memory
            # floor (read + write).
            roof = roofline_report(
                seconds=dt, flops=samples * (flops_per_sample or 0.0),
                bytes_moved=samples * bytes_per_sample,
                device_kind=dev.device_kind)
            if flops_per_sample is not None:
                rec["tc_fraction_bf16"] = round(roof["tc_fraction_bf16"], 4)
            rec["hbm_fraction"] = round(roof["hbm_fraction"], 4)
        results.append(rec)
        _log(json.dumps(rec))
        return rec

    T = int(48000 * seconds)

    # ---- config 1: 1024-tap FIR lowpass, 1 channel ----------------------
    # Spec shape is 10 s of 48 kHz audio (BASELINE.json:7); the scan count
    # is scaled up because a single-channel step is tens of microseconds.
    taps = lz.firwin(1024, 0.25, window="hamming")
    t1 = (480000 // 3072) * 3072
    x1 = rng.standard_normal((1, t1)).astype(np.float32)
    m1 = fir_method_auto(1024)
    h = fir_state_len(1024, method=m1)

    def fir_step(v, st):
        y, zf = lz.fir_filter(v, taps, method=m1, zi=st, return_zf=True)
        return y, zf

    dt = run_scanned(fir_step, jnp.zeros((1, h)), jnp.asarray(x1),
                     iters * 20)
    y = np.asarray(lz.fir_filter(x1, taps, method=m1))
    ref = ss.lfilter(taps, [1.0], x1.astype(np.float64), axis=-1)
    report("fir_lowpass_1ch", t1 / dt / 1e6, _snr(ref, y), engine=m1,
           seconds=10,
           flops_per_sample=cm.fir_block2_flops_per_sample(1024) * _passes,
           bytes_per_sample=8.0, dt=dt, samples=t1)

    # ---- config 2: 147/160 resample, 8 channels -------------------------
    rtaps = lz.resample_taps(147, 160, 64)
    t2 = (T // 160) * 160
    x2 = rng.standard_normal((8, t2)).astype(np.float32)

    def rs_step(v, st):
        y, zf = lz.resample_poly(v, 147, 160, taps=rtaps, zi=st,
                                 return_zf=True)
        return y, zf

    dt = run_scanned(rs_step, jnp.zeros((8, 63)), jnp.asarray(x2),
                     iters * 10)
    y = np.asarray(lz.resample_poly(x2[:1], 147, 160, taps=rtaps))
    ref = ss.upfirdn(rtaps, x2[0].astype(np.float64), 147, 160)[: y.shape[-1]]
    report("resample_8ch", 8 * t2 / dt / 1e6, _snr(ref, y[0]),
           flops_per_sample=cm.resample_flops_per_sample(147, 160, 64)
           * _passes,
           bytes_per_sample=4.0 * (1.0 + 147.0 / 160.0),
           dt=dt, samples=8 * t2)

    # ---- config 3: 8-section EQ, 64 channels ----------------------------
    sos8 = lz.peaking_eq_sos(
        [100, 200, 400, 800, 1600, 3200, 6400, 12800],
        [3, -4, 5, -2, 6, -3, 2, -5], 48000.0, q=1.0,
    )
    t3 = (T // 4096) * 4096
    x3 = rng.standard_normal((64, t3)).astype(np.float32)
    ref3 = ss.sosfilt(sos8, x3[:4].astype(np.float64), axis=-1)

    def sos_step(v, st):
        return lz.sosfilt(sos8, v, zi=st, block_size=4096, return_zf=True)

    dt = run_scanned(sos_step, jnp.zeros((64, 8, 2)), jnp.asarray(x3),
                     iters * 2)
    y = np.asarray(lz.sosfilt(sos8, x3[:4], block_size=4096))
    # scan engine has no matmuls: its tensor-core fraction is 0; the
    # bytes floor is one r/w pass per associative-scan level.
    report("iir_eq_64ch", 64 * t3 / dt / 1e6, _snr(ref3, y), engine="scan",
           flops_per_sample=0.0,
           bytes_per_sample=8.0 * np.log2(4096),
           dt=dt, samples=64 * t3)

    # Same workload on the matmul engine (ops/iir_matmul.py), at both
    # precision tiers.
    for prec in ("highest", "high"):
        def sos_mm_step(v, st, _p=prec):
            return lz.sosfilt_matmul(sos8, v, zi=st, return_zf=True,
                                     precision=_p)

        dt = run_scanned(sos_mm_step, jnp.zeros((64, 8, 2)),
                         jnp.asarray(x3), iters * 2)
        y = np.asarray(lz.sosfilt_matmul(sos8, x3[:4], precision=prec))
        report(f"iir_eq_64ch_matmul_{prec}", 64 * t3 / dt / 1e6,
               _snr(ref3, y), engine="matmul", precision=prec,
               flops_per_sample=cm.iir_matmul_flops_per_sample(8)
               * cm.passes(prec),
               bytes_per_sample=8.0, dt=dt, samples=64 * t3)

    # ---- config 4: STFT→gain→iSTFT, 256 channels ------------------------
    # The STREAMING SpectralGainStage (real per-bin gain, carried WOLA
    # state) is what gets timed and golden-checked — full-sample SNR
    # including block boundaries vs an independent f64 WOLA reference.
    from llzlab_tpu.pipeline.chain import SpectralGainStage

    t4 = (T // 4096) * 4096
    x4 = rng.standard_normal((256, t4)).astype(np.float32)
    gain_np = np.linspace(1.0, 0.5, 1025)
    stage = SpectralGainStage(gain_np.astype(np.float32))

    def stft_step(v, st):
        return stage.apply(v, st)

    dt = run_scanned(stft_step, stage.init_state((256,)),
                     jnp.asarray(x4), iters)

    def wola_gain_f64(xs, n_fft=2048, hop=512):
        """Independent numpy-f64 one-shot istft(gain·stft(x)) — causal
        framing at 0, periodic Hann, window-square envelope division."""
        w = ss.get_window("hann", n_fft).astype(np.float64)
        tt = xs.shape[-1]
        nf = 1 + (tt - n_fft) // hop
        idx = np.arange(n_fft) + hop * np.arange(nf)[:, None]
        fr = xs[:, idx] * w
        spec = np.fft.rfft(fr, axis=-1) * gain_np
        syn = np.fft.irfft(spec, n_fft, axis=-1) * w
        out_len = n_fft + (nf - 1) * hop
        y = np.zeros((xs.shape[0], out_len))
        env = np.zeros(out_len)
        for i in range(nf):
            y[:, i * hop : i * hop + n_fft] += syn[:, i]
            env[i * hop : i * hop + n_fft] += w * w
        return y / np.maximum(env, 1e-8)

    xs = x4[:2].astype(np.float64)
    st = stage.init_state((2,))
    half = t4 // 2
    ys = []
    for blk in (x4[:2, :half], x4[:2, half:]):
        yb, st = stage.apply(jnp.asarray(blk), st)
        ys.append(np.asarray(yb))
    ys.append(np.asarray(stage.flush(st)))
    ys = np.concatenate(ys, axis=-1)
    ref4 = wola_gain_f64(xs)
    cut = ys[:, stage.latency :]
    # Skip BOTH envelope ramps: at the stream's start AND at the flush
    # tail the WOLA output divides by a near-zero window-square
    # envelope, which amplifies engine rounding ~40-60 dB in ANY
    # implementation (an artifact of 1/env, identical for every engine,
    # not a streaming defect).  Every mid-stream block boundary stays in
    # the window (the streamed run splits at t4/2).
    skip = stage.latency + (stage.n_fft - stage.hop)
    n4 = min(cut.shape[-1], ref4.shape[-1]) - 2 * stage.n_fft
    snr4 = _snr(ref4[:, skip:n4], cut[:, skip:n4])
    # engine cost model by the stage's resolved engine
    # (bench/cost_models.py)
    def _c4_model(st_, passes):
        if st_.engine == "reference":
            return None  # the FFT library: no matmul FLOP model
        return passes * (cm.cwola_flops_per_sample(st_.n_fft, st_.hop)
                         if st_.engine == "cwola"
                         else cm.wdft_flops_per_sample(st_.n_fft, st_.hop))

    report("stft_gain_256ch", 256 * t4 / dt / 1e6, snr4,
           engine=f"SpectralGainStage({stage.engine},highest)",
           golden="f64 WOLA, all samples past the startup envelope "
                  "ramp (mid-stream block boundaries included)",
           flops_per_sample=_c4_model(stage, 6),
           bytes_per_sample=8.0, dt=dt, samples=256 * t4)

    # Same workload at precision="high" (3-pass): the throughput tier
    # when the chain's budget does not need the 6-pass SNR margin.
    stage_h = SpectralGainStage(gain_np.astype(np.float32),
                                precision="high")
    dt = run_scanned(stft_step_h := (lambda v, st: stage_h.apply(v, st)),
                     stage_h.init_state((256,)), jnp.asarray(x4), iters)
    st = stage_h.init_state((2,))
    ys = []
    for blk in (x4[:2, :half], x4[:2, half:]):
        yb, st = stage_h.apply(jnp.asarray(blk), st)
        ys.append(np.asarray(yb))
    ys.append(np.asarray(stage_h.flush(st)))
    ys = np.concatenate(ys, axis=-1)
    cut = ys[:, stage_h.latency :]
    snr4h = _snr(ref4[:, skip:n4], cut[:, skip:n4])
    report("stft_gain_256ch_high", 256 * t4 / dt / 1e6, snr4h,
           engine=f"SpectralGainStage({stage_h.engine},high)",
           flops_per_sample=_c4_model(stage_h, 3),
           bytes_per_sample=8.0, dt=dt, samples=256 * t4)

    # ---- config 5: channelizer chain at the spec channel count ----------
    # (single chip; the sharded variant is exercised by
    # __graft_entry__.dryrun_multichip and chip_smoke.py --devices 4).
    # Input is GENERATED ON DEVICE, so H2D is not on this row's path.
    from llzlab_tpu.chains.channelizer import Channelizer

    # pair spec format: ONE combined-table rDFT matmul, no complex pack
    # (chains/channelizer.py docstring)
    chan = Channelizer(spec_format="pair")
    m = chan.block_multiple()
    c5 = int(channels5)

    @jax.jit
    def gen5(key):
        return jax.random.normal(key, (c5, m), jnp.float32)

    x5_dev = gen5(jax.random.PRNGKey(5))
    x5_dev.block_until_ready()

    def chan_step(v, st):
        spec, st2 = chan.step(v, st)
        return spec, st2

    dt = run_scanned(chan_step, chan.init_state(c5), x5_dev, iters)
    # SNR vs float64 scipy golden on an 8-channel slice of the same chain
    # (channels are independent — per-channel math is identical).  The
    # slice is fetched D2H.
    nsnr = min(8, c5)
    x5s = np.asarray(x5_dev[:nsnr])
    spec_dev = chan.step(jnp.asarray(x5s), chan.init_state(nsnr))[0]
    # pair layout → numpy complex
    _sp = np.asarray(spec_dev)[:2]
    _h1 = _sp.shape[-1] // 2
    spec = _sp[..., :_h1] + 1j * _sp[..., _h1:]
    y64 = ss.lfilter(chan.fir_taps, [1.0], x5s[:2].astype(np.float64),
                     axis=-1)
    z64 = np.stack([
        ss.upfirdn(chan.resample_taps, y64[c], chan.up, chan.down)
        for c in range(2)
    ])
    n_out = spec.shape[1] * chan.fft_n
    zf64 = z64[:, :n_out].reshape(2, -1, chan.fft_n)
    ref5 = np.fft.rfft(zf64, axis=-1)
    # fused FIR+resample + frames engine (bench/cost_models.py)
    report("channelizer_1chip", c5 * m / dt / 1e6, _snr(ref5, spec),
           channels=c5, block=m,
           engine=f"{chan.fir_method}+pair_rdft",
           input="on-device jax.random (no H2D)",
           flops_per_sample=cm.channelizer_flops_per_sample(
               1024, chan.up, chan.down, chan.k, chan.fft_n, _prec,
               frames_engine="pair")
           * _passes,
           bytes_per_sample=4.0 * (1.0 + 147.0 / 160.0
                                   + (147.0 / 160.0) * 8 * 1025 / 2048),
           dt=dt, samples=c5 * m)
    return results


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--channels5", type=int, default=1024,
                   help="channelizer channel count (spec shape 1024; input "
                        "is generated on device so H2D is not a factor)")
    args = p.parse_args()

    import jax

    from llzlab_tpu.runtime.platform import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit("no GPU found (pass --cpu for a CPU run)")
    enable_compile_cache()
    results = run_all(iters=args.iters, seconds=args.seconds,
                      channels5=args.channels5)
    for rec in results:
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
