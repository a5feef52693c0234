#!/usr/bin/env python
"""Weak-scaling measurement harness (BASELINE.json:5 weak-scaling
efficiency target).

Measures the sharded channelizer chain (config 5, BASELINE.json:11) at a
FIXED per-device workload while the mesh grows — the weak-scaling
definition — and reports samples/s/chip efficiency against the 1-device
point, plus the analytic collective bytes per step (halo ppermutes are
the chain's only steady-state communication, so the model is exact).

Topology-agnostic by design (SURVEY.md §7 hard part 6):

* --backend cpu: functional curve on the 8-virtual-device CPU mesh
  (n_time ∈ {1,2,4,8}); numbers characterise the *code path*, not the
  interconnect, and are never device metrics.
* --backend gpu (default): the visible GPUs (e.g. four H100s joined by
  NVLink); the script walks n_time/n_channel splits of the real device
  set and the efficiency column is meaningful.

    python scripts/pod_scaling.py [--backend cpu] [--devices 8]
        [--channels-per-dev 8] [--t-loc-mult 1] [--iters 5]
        [--metrics out.jsonl]

Prints one JSON line per mesh point and a final summary line.
"""

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--backend", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--devices", type=int, default=0,
                   help="devices to use (0 = all visible)")
    p.add_argument("--channels-per-dev", type=int, default=8)
    p.add_argument("--t-loc-mult", type=int, default=1,
                   help="per-device time block = mult × block_multiple()")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--fir-method", default="direct",
                   help="'direct' keeps the CPU-mesh granularity small; "
                        "use 'fused' on GPUs")
    p.add_argument("--fir-taps", type=int, default=256)
    p.add_argument("--fft-n", type=int, default=128)
    p.add_argument("--metrics", default=None,
                   help="append JSONL events to this path")
    p.add_argument("--control", action="store_true",
                   help="also measure the same TOTAL workload unsharded "
                        "on one device at every mesh size — separates "
                        "host-capacity saturation (virtual CPU devices "
                        "share the physical cores) from real sharding "
                        "overhead (comm + imbalance + sync)")
    p.add_argument("--meshes", default=None,
                   help="comma-separated explicit mesh points "
                        "'CxT[,CxT…]' (e.g. '2x2,1x4') instead of the "
                        "default time-major power-of-two walk — used to "
                        "pin outliers")
    args = p.parse_args()

    if args.backend == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
    import jax

    from llzlab_tpu.runtime.platform import enable_compile_cache

    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit("no GPU found (pass --backend cpu for a CPU run)")
    enable_compile_cache()
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import llzlab_tpu as lz
    from llzlab_tpu.chains.channelizer import Channelizer
    from llzlab_tpu.parallel.mesh import make_dsp_mesh, CHANNEL_AXIS, TIME_AXIS
    from llzlab_tpu.utils.metrics import MetricsLogger, config_hash

    devs = jax.devices()
    nd_all = args.devices or len(devs)
    log = MetricsLogger(path=args.metrics, echo=True)
    print(f"backend={jax.default_backend()} devices={nd_all} "
          f"kind={devs[0].device_kind}", file=sys.stderr, flush=True)

    chan = Channelizer(
        fir_taps=lz.firwin(args.fir_taps, 0.4),
        fft_n=args.fft_n,
        taps_per_phase=16,
        fir_method=args.fir_method,
    )
    m = chan.block_multiple() * args.t_loc_mult
    cfg = {"fir_taps": args.fir_taps, "fft_n": args.fft_n,
           "fir_method": args.fir_method, "t_loc": m,
           "channels_per_dev": args.channels_per_dev}
    cfg_hash = config_hash(cfg)

    # Per-step communication, the exact analytic model for the ppermute
    # traffic (cross-checked against the compiled HLO below —
    # tests/parallel/test_collective_traffic.py pins the equality):
    #   FIR halo:       (n_time-1) sends of C × h_fir floats
    #   resample halo:  (n_time-1) sends of C × h_rs floats
    #   tail broadcast: (n_time-1) one-to-all sends of the same tails
    #                   (masked ppermute from the last shard)
    def comm_bytes(n_channel, n_time, c_total):
        return 2 * (n_time - 1) * c_total * (chan.h_fir + chan.h_rs) * 4

    points = []
    if args.meshes:
        shapes = []
        for tok in args.meshes.split(","):
            c_, t_ = tok.lower().split("x")
            shapes.append((int(c_), int(t_)))
    else:
        n = 1
        shapes = []
        while n <= nd_all:
            shapes.append((1, n))  # time-major walk (halo comm axis)
            n *= 2

    rng = np.random.default_rng(0)
    base = None
    for n_channel, n_time in shapes:
        # weak scaling: keep per-device (channels × time) fixed; grow
        # the mesh (default: time-major — halo comm is the interesting
        # axis; --meshes overrides for specific points).
        nd = n_channel * n_time
        c_total = args.channels_per_dev * n_channel
        t_total = m * n_time
        mesh = make_dsp_mesh(n_channel, n_time, devices=devs[:nd])
        chan.validate_sharded_shapes(mesh, c_total, t_total)
        step = chan.sharded_step(mesh)

        x_spec = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
        st_spec = NamedSharding(mesh, P(CHANNEL_AXIS, None))
        x = jax.device_put(
            rng.standard_normal((c_total, t_total)).astype(np.float32),
            x_spec,
        )
        state = tuple(
            jax.device_put(s, st_spec) for s in chan.init_state(c_total)
        )

        # Measured collective traffic from the compiled HLO — the
        # ground-truth cross-check for the analytic model above:
        # ppermute bytes must agree exactly.
        from llzlab_tpu.utils.profiling import collective_traffic

        hlo = step.lower(x, state).compile().as_text()
        traffic = collective_traffic(hlo)

        spec, st2 = step(x, state)  # compile + warmup
        jax.block_until_ready(spec)
        t0 = time.perf_counter()
        st = state
        for _ in range(args.iters):
            spec, st = step(x, st)
        jax.block_until_ready(spec)
        dt = (time.perf_counter() - t0) / args.iters

        msps_chip = c_total * t_total / dt / 1e6 / nd
        if base is None:
            base = msps_chip
        eff = msps_chip / base
        rec = {
            "mesh": f"{n_channel}x{n_time}",
            "devices": nd,
            "msps_per_chip": round(msps_chip, 2),
            "aggregate_msps": round(msps_chip * nd, 2),
            "weak_scaling_eff": round(eff, 4),
            "step_seconds": round(dt, 6),
            "comm_bytes_per_step": comm_bytes(n_channel, n_time, c_total),
            "comm_bytes_hlo": traffic["total_bytes"],
            "comm_ops_hlo": [
                f"{o['op']}:{o['bytes']}" for o in traffic["ops"]],
            "host_cores": os.cpu_count(),
            "config": cfg_hash,
        }
        if args.control:
            # Same TOTAL workload, unsharded, one device: what the HOST
            # can actually do at this size.  On a virtual CPU mesh the
            # "devices" share the physical cores, so per-device
            # efficiency is bounded by host capacity regardless of the
            # comm model; sharding_eff = sharded aggregate ÷ this is
            # the honest sharding-overhead number.
            xs = jnp.asarray(np.asarray(x))
            st0 = chan.init_state(c_total)
            stepc = jax.jit(chan.step)
            sc, _ = stepc(xs, st0)
            jax.block_until_ready(sc)
            t0 = time.perf_counter()
            stc = st0
            for _ in range(args.iters):
                sc, stc = stepc(xs, stc)
            jax.block_until_ready(sc)
            dtc = (time.perf_counter() - t0) / args.iters
            ctrl = c_total * t_total / dtc / 1e6
            rec["control_aggregate_msps"] = round(ctrl, 2)
            rec["sharding_eff_vs_host"] = round(
                rec["aggregate_msps"] / ctrl, 4)
        points.append(rec)
        log.event("weak_scaling", **rec)
        print(json.dumps(rec), flush=True)

    summary = {
        "metric": "weak-scaling efficiency, sharded channelizer",
        "backend": jax.default_backend(),
        "device": devs[0].device_kind,
        "points": points,
        "final_efficiency": points[-1]["weak_scaling_eff"] if points else None,
        "config": cfg,
    }
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
