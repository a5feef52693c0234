#!/usr/bin/env python
"""Parameterized engine sweep: {Msps, SNR dB} per (op, engine, precision)
on the current backend, every timing loop on-device via lax.scan.

    python bench/sweep.py --suite chain          # headline engines
    python bench/sweep.py --suite iir            # sosfilt engine matrix
    python bench/sweep.py --suite fir            # FIR engines
    python bench/sweep.py --suite all [--cpu]

Prints one JSON line per measurement; stderr gets progress.  Walls are
host-clock times around work that ends in a device->host fetch; a number
from a ``--cpu`` run is a CPU number, never a device metric.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np

t0 = time.time()


def log(msg):
    print(f"[{time.time()-t0:6.1f}] {msg}", file=sys.stderr, flush=True)


def snr_db(ref, y):
    ref = np.asarray(ref)
    y = np.asarray(y)
    e = np.abs(ref - y)
    return float(10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(e**2)))


#: a timing wall at least this long is compute-dominated
MIN_WALL_S = 0.2


#: the iir suite measures at the config-3 bench row's shape
#: (bench/all_configs.py: 64 channels, 2 s of 48 kHz in 4096-blocks)
IIR_CHANNELS, IIR_BLOCK = 64, (2 * 48000 // 4096) * 4096


def calib_record(device_kind, channels, block, rows):
    """The ops/iir_select.py calibration artifact for the iir suite's
    measured ``rows`` at a ``channels`` × ``block`` workload.  Raises if
    a row's run-to-run spread is 10% or more: such walls would bake
    measurement noise into engine selection."""
    bad = [r for r in rows if r["spread_pct"] >= 10.0]
    if bad:
        raise ValueError(f"spread >= 10% on {bad}")
    return {
        "device_kind": device_kind,
        "workload": "8-section peaking-EQ cascade, "
                    f"{channels}ch x {block}",
        "channels": channels,
        "block": block,
        "measured": rows,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--suite", default="all",
                   help="comma-separated subset of "
                        "{all,chain,fir,iir,fft,fftsize,ifftsize}")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--channels", type=int, default=64)
    p.add_argument("--block", type=int, default=245760)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--fft-sizes", default="256,512,1024,2048,4096,8192",
                   help="sizes for --suite fftsize")
    p.add_argument("--write-calib", action="store_true",
                   help="write the iir-suite measurements to "
                        "llzlab_tpu/calib/<device_kind>.json (the "
                        "ops/iir_select.py selection artifact)")
    args = p.parse_args()

    import jax

    from llzlab_tpu.runtime.platform import enable_compile_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit("no GPU found (pass --cpu for a CPU run)")
    enable_compile_cache()
    import jax.numpy as jnp
    import scipy.signal as ss
    from jax import lax

    import llzlab_tpu as lz
    from llzlab_tpu.ops import fir as fir_mod

    log(f"backend={jax.default_backend()} dev={jax.devices()[0].device_kind}")

    suites = set(args.suite.split(","))

    def want(name):
        return "all" in suites or name in suites

    C, T, ITERS = args.channels, args.block, args.iters
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((C, T)).astype(np.float32)
    x = jnp.asarray(x_np)

    def _probe(out):
        # full-output ABS sum, scaled to underflow when fed back:
        # anti-DCE AND nonlinear — a plain sum is algebraically
        # collapsible through linear XLA engines (sum∘matmul → matmul
        # of column sums)
        s = jnp.sum(jnp.abs(jnp.real(out)))
        if jnp.iscomplexobj(out):
            s = s + jnp.sum(jnp.abs(jnp.imag(out)))
        return (s * 1e-30).astype(jnp.float32)

    def timeit(fn, *fargs):
        # Anti-DCE/LICM: perturb the first arg with the carried
        # full-output probe — a real cross-iteration dependence, so XLA
        # can neither slice away unconsumed output nor hoist the
        # loop-invariant body.
        @jax.jit
        def go(*a):
            def body(c, _):
                return _probe(fn(a[0] + c, *a[1:])), ()
            c, _ = lax.scan(body, jnp.float32(0), None, length=ITERS)
            return c

        r = go(*fargs); r.block_until_ready()
        t1 = time.perf_counter()
        r = go(*fargs); r.block_until_ready()
        return C * T * ITERS / (time.perf_counter() - t1) / 1e6

    def timeit_stable(fn, *fargs, reps=5, samples=None):
        """Adaptive + repeated timing: grow the scan length until the
        wall is compute-dominated (≥ 200 ms), then measure ``reps`` walls
        and report min-based Msps WITH the observed spread (the
        calibration artifact refuses spreads ≥ 10%)."""
        n = ITERS

        def make(length):
            @jax.jit
            def go(*a):
                def body(c, _):
                    return _probe(fn(a[0] + c, *a[1:])), ()
                c, _ = lax.scan(body, jnp.float32(0), None, length=length)
                return c
            return go

        go = make(n)
        for _r in range(6):
            np.asarray(go(*fargs))
            t1 = time.perf_counter()
            np.asarray(go(*fargs))
            wall = time.perf_counter() - t1
            if wall >= MIN_WALL_S or n >= 100000:
                break
            n *= min(16, max(2, int(MIN_WALL_S / max(wall, 1e-9)) + 1))
            go = make(n)
        walls = []
        for _r in range(reps):
            t1 = time.perf_counter()
            np.asarray(go(*fargs))
            walls.append(time.perf_counter() - t1)
        dts = np.asarray(walls)
        samples = fargs[0].size if samples is None else samples
        msps = samples * n / dts / 1e6
        return {
            "msps": round(float(msps.max()), 1),      # min wall
            "msps_median": round(float(np.median(msps)), 1),
            "spread_pct": round(
                100.0 * float((dts.max() - dts.min()) / dts.min()), 1),
            "scan_iters": n,
        }

    def report(**rec):
        print(json.dumps(rec), flush=True)
        log(json.dumps(rec))

    taps = lz.firwin(1024, 0.25, window="hamming")
    rtaps = lz.resample_taps(147, 160, 64)

    # ---- chain: 1024-tap FIR + 147/160 resample (the headline) ----------
    if want("chain"):
        from llzlab_tpu.ops import fused_chain as fc

        y64 = ss.lfilter(taps, [1.0], x_np[0].astype(np.float64))
        z64 = ss.upfirdn(rtaps, y64, 147, 160)

        def chain_snr(z):
            ours = np.asarray(z[0], np.float64)
            return snr_db(z64[: ours.shape[0]], ours)

        k = len(rtaps) // 147
        for prec in ("high", "highest"):
            os.environ["LLZ_MATMUL_PRECISION"] = prec
            jax.clear_caches()  # precision env is captured at trace time
            for method in ("ols", "block2"):
                hlen = fir_mod.fir_state_len(1024, method=method)
                f0 = jnp.zeros((C, hlen), jnp.float32)
                r0 = jnp.zeros((C, k - 1), jnp.float32)

                @jax.jit
                def chain_xla(x, f=f0, r=r0, _m=method):
                    y, _ = lz.fir_filter(x, taps, method=_m, zi=f,
                                         return_zf=True)
                    z, _ = lz.resample_poly(y, 147, 160, taps=rtaps, zi=r,
                                            return_zf=True)
                    return z

                z = chain_xla(x)
                report(op="chain", engine=f"{method}+resample",
                       precision=prec, msps=round(timeit(chain_xla, x), 1),
                       snr=round(chain_snr(z), 1))

            st0 = jnp.zeros(
                (C, fc.fir_resample_state_len(1024, 147, 160, len(rtaps))),
                jnp.float32)
            for engine in ("pallas", "composite"):
                @jax.jit
                def chain_fused(x, st=st0, _e=engine, _p=prec):
                    return fc.fir_resample(x, taps, 147, 160, rtaps=rtaps,
                                           zi=st, engine=_e, precision=_p)

                z = chain_fused(x)
                report(op="chain", engine=f"fused_{engine}", precision=prec,
                       msps=round(timeit(chain_fused, x), 1),
                       snr=round(chain_snr(z), 1))
        os.environ["LLZ_MATMUL_PRECISION"] = "highest"

    # ---- fir: engines at 1024 taps ---------------------------------------
    if want("fir"):
        ref = ss.lfilter(taps, [1.0], x_np[:2].astype(np.float64), axis=-1)
        for method in ("ols", "block2", "im2col"):
            for prec in ("high", "highest"):
                os.environ["LLZ_MATMUL_PRECISION"] = prec
                jax.clear_caches()  # precision env captured at trace time
                hlen = fir_mod.fir_state_len(1024, method=method)
                st0 = jnp.zeros((C, hlen), jnp.float32)

                @jax.jit
                def f(x, st=st0, _m=method):
                    y, _ = lz.fir_filter(x, taps, method=_m, zi=st,
                                         return_zf=True)
                    return y

                y = np.asarray(f(x)[:2])
                report(op="fir", engine=method, precision=prec,
                       msps=round(timeit(f, x), 1),
                       snr=round(snr_db(ref, y), 1))
        os.environ["LLZ_MATMUL_PRECISION"] = "highest"

    # ---- iir: the sosfilt engine matrix (ops/iir_select.py source) ------
    if want("iir"):
        iir_rows = []
        sos8 = lz.peaking_eq_sos(
            [100, 300, 700, 1500, 3000, 6000, 10000, 15000],
            [3, -4, 2, 5, -3, 4, -2, 3], 48000, q=1.0)
        x3_np = rng.standard_normal((IIR_CHANNELS, IIR_BLOCK)).astype(
            np.float32)
        x3 = jnp.asarray(x3_np)
        ref = ss.sosfilt(np.asarray(sos8, np.float64),
                         x3_np[:2].astype(np.float64), axis=-1)
        st0 = jnp.zeros((IIR_CHANNELS, 8, 2), jnp.float32)

        @jax.jit
        def scan_f(x, st=st0):
            y, _ = lz.sosfilt(sos8, x, zi=st, block_size=4096,
                              return_zf=True)
            return y

        y = np.asarray(scan_f(x3)[:2])
        iir_rows.append(dict(engine="scan", precision="f32",
                             snr=round(snr_db(ref, y), 1),
                             **timeit_stable(scan_f, x3)))
        report(op="iir", **iir_rows[-1])

        for prec in ("highest", "high"):
            @jax.jit
            def mm_f(x, st=st0, _p=prec):
                y, _ = lz.sosfilt_matmul(sos8, x, zi=st, return_zf=True,
                                         precision=_p)
                return y

            y = np.asarray(mm_f(x3)[:2])
            iir_rows.append(dict(engine="matmul", precision=prec,
                                 snr=round(snr_db(ref, y), 1),
                                 **timeit_stable(mm_f, x3)))
            report(op="iir", **iir_rows[-1])

        if args.write_calib:
            from llzlab_tpu.ops.iir_select import calib_path

            kind = jax.devices()[0].device_kind
            try:
                rec = calib_record(kind, IIR_CHANNELS, IIR_BLOCK, iir_rows)
            except ValueError as e:
                log(f"calib NOT written: {e}")
            else:
                path = calib_path(kind)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                log(f"calibration artifact written: {path}")

    def timeit_n(fn, samples, iters, *fargs):
        """Like timeit but with explicit sample count / scan length."""
        @jax.jit
        def go(*a):
            def body(c, _):
                return _probe(fn(a[0] + c, *a[1:])), ()
            c, _ = lax.scan(body, jnp.float32(0), None, length=iters)
            return c

        r = go(*fargs); r.block_until_ready()
        t1 = time.perf_counter()
        r = go(*fargs); r.block_until_ready()
        return samples * iters / (time.perf_counter() - t1) / 1e6

    # ---- fft: standalone FFT engine rows --------------------------------
    if want("fft"):
        from llzlab_tpu.ops import transform as tr

        nfft = 2048
        frames = (C * T) // nfft
        xf = x[:, : frames // C * C * nfft].reshape(C, -1, nfft)
        ref = np.fft.rfft(np.asarray(xf[:2], np.float64), axis=-1)
        engines = []
        for prc in ("highest", "high"):
            for eng in ("real", "real16", "dense", "pack"):
                engines.append((
                    f"matmul_{eng}", prc,
                    lambda v, _e=eng, _p=prc: tr._jit_pack(
                        *tr._rfft_matmul_jit(v, nfft, _p, _e)),
                ))
        engines.append(("xla", "n/a",
                        lambda v: jnp.fft.rfft(v, n=nfft, axis=-1)))
        if args.cpu:
            engines = engines[-1:]
        samples = xf.shape[0] * xf.shape[1] * nfft
        for name, prc, ffn in engines:
            try:
                y = ffn(xf[:2])
                yh = (np.asarray(jnp.real(y), np.float64)
                      + 1j * np.asarray(jnp.imag(y), np.float64))
                report(op="fft", engine=name, precision=prc, nfft=nfft,
                       msps=round(timeit_n(ffn, samples, ITERS, xf), 1),
                       snr=round(snr_db(ref, yh), 1))
            except Exception as e:
                report(op="fft", engine=name, precision=prc,
                       error=str(e)[:160])

        # inverse engines: time irfft(spec) on a precomputed spectrum
        spec_dev = tr._jit_pack(*tr._rfft_matmul_jit(xf, nfft, "highest",
                                                     "real"))
        refi = np.fft.irfft(
            np.asarray(np.fft.rfft(np.asarray(xf[:2], np.float64),
                                   axis=-1)), nfft, axis=-1)
        for prc in ("highest", "high"):
            for eng in ("real", "dense", "pack"):
                def ifn(v, _e=eng, _p=prc):
                    sr, si = tr._jit_split(v)
                    return tr._irfft_matmul_jit(sr, si, nfft, _p, _e)
                try:
                    y = np.asarray(ifn(spec_dev[:2]), np.float64)
                    report(op="ifft", engine=eng, precision=prc,
                           nfft=nfft,
                           msps=round(timeit_n(ifn, samples, ITERS,
                                               spec_dev), 1),
                           snr=round(snr_db(refi, y), 1))
                except Exception as e:
                    report(op="ifft", engine=eng, precision=prc,
                           error=str(e)[:160])

    # ---- fftsize: rfft engine ranking ACROSS SIZES ------------------------
    # The dense table is O(n²) and its MACs/sample grow as n; this suite
    # measures the ranking over the size range the API accepts so the
    # matmul thresholds are evidence, not extrapolation.  NOT in --suite
    # all: run explicitly (it holds the chip for minutes).
    if want("fftsize"):
        from llzlab_tpu.ops import transform as tr

        for nfft in (int(s) for s in args.fft_sizes.split(",")):
            nfr = T // nfft
            xf = x[:, : nfr * nfft].reshape(C, nfr, nfft)
            ref = np.fft.rfft(np.asarray(xf[:2], np.float64), axis=-1)
            samples = C * nfr * nfft
            # timeit_stable (not timeit_n): these rows drive the
            # thresholds, so they need compute-dominated walls + a
            # recorded spread, same as the IIR calib rows.
            rows = []
            for prc in ("high", "highest"):
                for eng in ("dense", "real", "pack"):
                    def ffn(v, _e=eng, _p=prc, _n=nfft):
                        return tr._jit_pack(
                            *tr._rfft_matmul_jit(v, _n, _p, _e))
                    try:
                        y = ffn(xf[:2])
                        yh = (np.asarray(jnp.real(y), np.float64)
                              + 1j * np.asarray(jnp.imag(y), np.float64))
                        rows.append(dict(
                            op="fft", nfft=nfft, engine=eng, precision=prc,
                            snr=round(snr_db(ref, yh), 1),
                            **timeit_stable(ffn, xf, reps=3)))
                    except Exception as e:
                        rows.append(dict(op="fft", nfft=nfft, engine=eng,
                                         precision=prc,
                                         error=str(e)[:160]))
                    report(**rows[-1])
            def xfn(v, _n=nfft):
                return jnp.fft.rfft(v, n=_n, axis=-1)
            y = xfn(xf[:2])
            yh = (np.asarray(jnp.real(y), np.float64)
                  + 1j * np.asarray(jnp.imag(y), np.float64))
            report(op="fft", nfft=nfft, engine="xla", precision="n/a",
                   snr=round(snr_db(ref, yh), 1),
                   **timeit_stable(xfn, xf, reps=3))

    # ---- ifftsize: irfft engine ranking across sizes --------------------
    if want("ifftsize"):
        from llzlab_tpu.ops import transform as tr

        for nfft in (int(s) for s in args.fft_sizes.split(",")):
            nfr = T // nfft
            xf = x[:, : nfr * nfft].reshape(C, nfr, nfft)
            spec_dev = tr._jit_pack(*tr._rfft_matmul_jit(
                xf, nfft, "highest", "real"))
            refi = np.fft.irfft(
                np.fft.rfft(np.asarray(xf[:2], np.float64), axis=-1),
                nfft, axis=-1)
            for prc in ("high", "highest"):
                for eng in ("dense", "real", "pack"):
                    def ifn(v, _e=eng, _p=prc, _n=nfft):
                        sr, si = tr._jit_split(v)
                        return tr._irfft_matmul_jit(sr, si, _n, _p, _e)
                    try:
                        y = np.asarray(ifn(spec_dev[:2]), np.float64)
                        report(op="ifft", nfft=nfft, engine=eng,
                               precision=prc,
                               snr=round(snr_db(refi, y), 1),
                               **timeit_stable(ifn, spec_dev, reps=3,
                                                      samples=xf.size))
                    except Exception as e:
                        report(op="ifft", nfft=nfft, engine=eng,
                               precision=prc, error=str(e)[:160])

    log("done")


if __name__ == "__main__":
    main()
