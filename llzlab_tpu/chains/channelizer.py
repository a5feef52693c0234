"""Wideband channelizer — the flagship chain (BASELINE.json:11).

``x (C, T)`` → 1024-tap FIR band-shaping → 147/160 polyphase resample →
2048-point spectral framing, with channels and time-blocks distributed
over the (channel, time) mesh.  The whole step is ONE ``shard_map`` region
under jit: left-halo ppermutes of the stream histories are the only
steady-state communication, nearest-neighbour on the ``time`` axis;
everything else is local work (the fused FIR+resample kernel or
overlap-save block conv + polyphase slab matmul, then the FFT).

Reference counterpart: the per-tool frontends composing llz_fir/
llz_resample/llz_fft in a serial frame loop (mount empty — SURVEY.md §3.5
is the normative call stack for this chain).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from llzlab_tpu.ops import fir as _fir
from llzlab_tpu.ops import fused_chain as _fc
from llzlab_tpu.ops import resample as _rs
from llzlab_tpu.ops import transform as _tf
from llzlab_tpu.parallel.mesh import CHANNEL_AXIS, TIME_AXIS
from llzlab_tpu.parallel.halo import left_halo, broadcast_from_last
from llzlab_tpu.runtime.platform import backend

__all__ = ["Channelizer", "fir_method_auto"]


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def fir_method_auto() -> str:
    """The FIR+resample engine "auto" resolves to, read at construction.

    On the GPU: "fused" (the Pallas kernel) at the "high"/"default"
    precision tiers, where it is the fastest; "ols" → resample at
    "highest", where the kernel's TF32×3 product is the slower one
    (H100: 28.6 vs 13.1 ms per 1024 ch × 327 680 step — PERF.md).  On
    the CPU: "ols"."""
    if backend() == "cpu":
        return "ols"
    return "ols" if _tf.matmul_precision_name() == "highest" else "fused"


class Channelizer:
    """FIR → resample → FFT chain, single-device or mesh-sharded.

    Args:
      fir_taps: band-shaping FIR (default 1024-tap 0.4·Nyquist lowpass).
      up, down: resampling ratio (default 147/160 = 48 k→44.1 k).
      fft_n: spectral frame length (default 2048).
      resample_taps: polyphase prototype (default 64 taps/phase design).
      fir_method: "auto" (default — :func:`fir_method_auto`) | "fused"
        (FIR + resample as one composite map, ops/fused_chain.fir_resample:
        the Pallas kernel on the GPU, the XLA composite on the CPU) |
        "ols" | "direct" | "block2" (two-matmul Toeplitz).
      spec_format: "complex" (default) emits complex64 frames
        ``(C, F, fft_n//2+1)``; "pair" emits the (re, im) pair layout
        ``(C, F, fft_n+2)`` f32 via ONE combined-table rDFT matmul
        (ops/transform.py rfft_pair) — no second signal read, no DC pass,
        no complex pack.  Values are identical (``pair_to_complex``
        converts).
    """

    def __init__(
        self,
        *,
        fir_taps=None,
        up: int = 147,
        down: int = 160,
        fft_n: int = 2048,
        resample_taps=None,
        taps_per_phase: int = 64,
        fir_method: str = "auto",
        fft_method: str = "auto",
        spec_format: str = "complex",
    ):
        if spec_format not in ("complex", "pair"):
            raise ValueError(f"unknown spec_format {spec_format!r}")
        self.spec_format = spec_format
        if fir_taps is None:
            fir_taps = _fir.firwin(1024, 0.4, window="hamming")
        self.fir_taps = np.asarray(fir_taps, np.float64)
        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        if resample_taps is None:
            resample_taps = _rs.resample_taps(self.up, self.down, taps_per_phase)
        rt = np.asarray(resample_taps, np.float64)
        if len(rt) % self.up:
            rt = np.pad(rt, (0, self.up - len(rt) % self.up))
        self.resample_taps = rt
        self.k = len(rt) // self.up
        self.fft_n = fft_n
        ntaps = len(self.fir_taps)
        if fir_method == "auto":
            fir_method = fir_method_auto()
        self.fir_method = fir_method
        self.fft_method = fft_method
        self.nfft = _fir.default_nfft(ntaps)
        if fir_method == "fused":
            # One combined state: the composite map's input history
            # carries both the FIR reach and the resampler's lookback.
            self.fused_engine = _fc.fir_resample_engine()
            self.h_fir = _fc.fir_resample_state_len(
                ntaps, self.up, self.down, len(rt))
            self.h_rs = 0
        else:
            self.h_fir = _fir.fir_state_len(ntaps, self.nfft, fir_method)
            self.h_rs = self.k - 1

    # ---------------- granularity ----------------

    def block_multiple(self, frames: str = "local") -> int:
        """Smallest per-shard T granularity satisfying every stage:
        multiple of the OLS hop and of `down`, with the resampled length a
        multiple of fft_n.

        ``frames="a2a"`` drops the fft_n alignment term: the all-to-all
        framing mode (see :meth:`sharded_step`) reshards to channel-major
        before the FFT, so frames may straddle time-shard boundaries and
        only the FIR/resample granularity remains.
        """
        if self.fir_method == "ols":
            hop = _fir.ols_hop(len(self.fir_taps), self.nfft)
        elif self.fir_method == "block2":
            hop = _fir.block2_block(len(self.fir_taps))
        else:
            hop = 1
        m = _lcm(hop, self.down)
        if frames == "a2a":
            return m
        # need (m·k)·up/down % fft_n == 0 → k multiple of fft_n/gcd
        per = m * self.up // self.down  # resampled samples per m inputs
        k = self.fft_n // math.gcd(per, self.fft_n)
        return m * k

    # ---------------- state ----------------

    def init_state(self, n_channels: int, dtype=jnp.float32):
        return (
            jnp.zeros((n_channels, self.h_fir), dtype),
            jnp.zeros((n_channels, self.h_rs), dtype),
        )

    # ---------------- single-device step ----------------

    def _fused_step(self, x: jnp.ndarray, hist: jnp.ndarray):
        """Fused-engine local compute: ``(x, input history)`` →
        ``(z, new_history)``."""
        return _fc.fir_resample(
            x, self.fir_taps, self.up, self.down, rtaps=self.resample_taps,
            zi=hist, return_zf=True, engine=self.fused_engine)

    def step(self, x: jnp.ndarray, state):
        """Unsharded pure step: ``(C, T)`` → ``(C, F, fft_n//2+1)``."""
        if self.fir_method == "fused":
            hist, rs_st = state
            z, zf = self._fused_step(x, hist)
            return self._frames(z), (zf, rs_st)
        fir_st, rs_st = state
        y, fir_tail = _fir.fir_filter(
            x, self.fir_taps, method=self.fir_method, nfft=self.nfft,
            zi=fir_st, return_zf=True,
        )
        z, rs_tail = _rs.resample_poly(
            y, self.up, self.down, taps=self.resample_taps, zi=rs_st,
            return_zf=True,
        )
        spec = self._frames(z)
        return spec, (fir_tail, rs_tail)

    def _frames(self, z):
        c = z.shape[0]
        nf = z.shape[-1] // self.fft_n
        zf = z[..., : nf * self.fft_n].reshape(c, nf, self.fft_n)
        if self.spec_format == "pair":
            return _tf.rfft_pair(zf, self.fft_n)
        return _tf.rfft(zf, self.fft_n, method=self.fft_method)

    # ---------------- sharded step ----------------

    def sharded_step(self, mesh, *, frames: str = "local",
                     halo_overlap: bool = False):
        """Build the jitted mesh-sharded step: ``(x, state) → (spec, state)``.

        ``x (C, T)`` sharded P(channel, time); state replicated over time.
        Requires ``C % n_channel == 0`` and ``T/n_time`` a multiple of
        :meth:`block_multiple(frames)`.  Stream histories cross shard
        boundaries by ``ppermute`` (parallel/halo.py).

        ``halo_overlap``: overlap the halo exchange with the bulk FIR
        compute (SURVEY §7 hard part 4).  The stages are linear, so the
        step is split as ``f(halo, x) = f(0, x) + f(halo, 0)`` — the
        collective's result then feeds only a SMALL correction term
        while the bulk ``f(0, x)`` has no data dependence on it, and
        XLA's latency-hiding scheduler runs the ppermute concurrently
        with the main compute.  Trade-off: the split reassociates f32
        additions, so sharded==unsharded holds at ~140 dB instead of
        bit-exactly (hence opt-in).  Supported for fir_method "fused"
        and "block2".

        ``frames``: "local" keeps the FFT framing inside each time shard
        (zero extra communication; needs the resampled per-shard length
        to be a multiple of fft_n).  "a2a" is the Ulysses analog (SURVEY
        §2d): after FIR+resample, ONE all-to-all reshards the signal to
        channel-major — every device then holds full time for a channel
        subset — so spectral frames may straddle time-shard boundaries
        and any FIR/resample-aligned granularity works.  Output sharding:
        P(channel, time, None) for "local", P((channel, time), None,
        None) for "a2a" (requires ``C`` divisible by the total device
        count).
        """
        axes = tuple(mesh.axis_names)
        c_ax = CHANNEL_AXIS if CHANNEL_AXIS in axes else None

        def halo_fn(v, h, first):
            return left_halo(v, h, first_shard_value=first)

        if frames not in ("local", "a2a"):
            raise ValueError(f"unknown frames mode {frames!r}")
        emit_frames = frames == "local"
        if halo_overlap and self.fir_method not in ("fused", "block2"):
            raise ValueError(
                "halo_overlap needs fir_method 'fused' or 'block2' "
                f"(got {self.fir_method!r})"
            )

        def local_overlapped(x_l, fir_st, rs_st):
            """f(halo, x) = f(0, x) + f(halo, 0): the collective feeds
            only the correction term, freeing XLA to overlap it with the
            bulk compute."""
            ntaps = len(self.fir_taps)
            block = _fir.block2_block(ntaps)
            if self.fir_method == "fused":
                halo = halo_fn(x_l, self.h_fir, fir_st)
                # the history reaches the first h_fir/down output groups
                p = self.h_fir
                z0, _ = self._fused_step(
                    x_l, jnp.zeros_like(halo))           # bulk, no halo dep
                zc, _ = self._fused_step(
                    jnp.zeros(x_l.shape[:-1] + (p,), x_l.dtype), halo)
                p_out = p * self.up // self.down
                z = z0.at[..., :p_out].add(zc[..., :p_out])
                tail = broadcast_from_last(x_l[..., -self.h_fir:])
                out = self._frames(z) if emit_frames else z
                return out, tail, rs_st
            # block2: y_0 = x_0 @ A + halo @ B — only the B term waits.
            halo_f = halo_fn(x_l, self.h_fir, fir_st)
            _a, bm = _fir._block2_cached(self.fir_taps.tobytes(), block)
            y0, _ = _fir.fir_filter(
                x_l, self.fir_taps, method="block2", zi=None,
                return_zf=True,
            )
            corr = jnp.einsum(
                "...m,mi->...i", halo_f, bm,
                preferred_element_type=jnp.float32,
            ).astype(y0.dtype)
            y = y0.at[..., :block].add(corr)
            fir_tail = broadcast_from_last(x_l[..., -self.h_fir:])
            # resampler halo: same split — zi feeds only the first
            # ceil((k−1)/down) output groups.
            halo_r = halo_fn(y, self.h_rs, rs_st)
            z0, _ = _rs.resample_poly(
                y, self.up, self.down, taps=self.resample_taps, zi=None,
                return_zf=True,
            )
            t0 = self.down * (-(-(self.k - 1) // self.down))
            zc = _rs.resample_poly(
                jnp.zeros(y.shape[:-1] + (t0,), y.dtype), self.up,
                self.down, taps=self.resample_taps, zi=halo_r,
            )
            n0 = zc.shape[-1]
            z = z0.at[..., :n0].add(zc)
            rs_tail = broadcast_from_last(y[..., -self.h_rs:])
            out = self._frames(z) if emit_frames else z
            return out, fir_tail, rs_tail

        def local(x_l, fir_st, rs_st):
            if self.fir_method == "fused":
                # ONE halo: the input history carries both the FIR reach
                # and the resampler's lookback, so the fused engine halves
                # the chain's steady-state collectives.
                halo_v = halo_fn(x_l, self.h_fir, fir_st)
                z, _ = self._fused_step(x_l, halo_v)
                tail = broadcast_from_last(x_l[..., -self.h_fir:])
                out = self._frames(z) if emit_frames else z
                return out, tail, rs_st
            halo_f = halo_fn(x_l, self.h_fir, fir_st)
            y, _ = _fir.fir_filter(
                x_l, self.fir_taps, method=self.fir_method,
                nfft=self.nfft, zi=halo_f, return_zf=True,
            )
            fir_tail = broadcast_from_last(x_l[..., -self.h_fir:])
            halo_r = halo_fn(y, self.h_rs, rs_st)
            z, _ = _rs.resample_poly(
                y, self.up, self.down, taps=self.resample_taps, zi=halo_r,
                return_zf=True,
            )
            rs_tail = broadcast_from_last(y[..., -self.h_rs:])
            out = self._frames(z) if emit_frames else z
            return out, fir_tail, rs_tail

        out0_spec = (P(c_ax, TIME_AXIS, None) if emit_frames
                     else P(c_ax, TIME_AXIS))
        fn = jax.shard_map(
            local_overlapped if halo_overlap else local,
            mesh=mesh,
            in_specs=(
                P(c_ax, TIME_AXIS),
                P(c_ax, None),
                P(c_ax, None),
            ),
            out_specs=(
                out0_spec,
                P(c_ax, None),
                P(c_ax, None),
            ),
            check_vma=False,
        )

        if emit_frames:
            @jax.jit
            def step(x, state):
                spec, ft, rt = fn(x, state[0], state[1])
                return spec, (ft, rt)

            return step

        from jax.sharding import NamedSharding

        flat = ((CHANNEL_AXIS, TIME_AXIS) if c_ax is not None
                else (TIME_AXIS,))
        cmajor = NamedSharding(mesh, P(flat, None))

        @jax.jit
        def step_a2a(x, state):
            z, ft, rt = fn(x, state[0], state[1])
            # The Ulysses-analog reshard: XLA emits ONE all-to-all moving
            # the time-sharded resampled signal to channel-major; frames
            # then span the full stream on every device.
            zc = jax.lax.with_sharding_constraint(z, cmajor)
            return self._frames(zc), (ft, rt)

        return step_a2a

    def validate_sharded_shapes(self, mesh, c: int, t: int,
                                frames: str = "local"):
        nc = dict(mesh.shape).get(CHANNEL_AXIS, 1)
        nt = mesh.shape[TIME_AXIS]
        if c % nc:
            raise ValueError(f"C={c} not divisible by n_channel={nc}")
        if t % nt:
            raise ValueError(f"T={t} not divisible by n_time={nt}")
        m = self.block_multiple(frames)
        if (t // nt) % m:
            raise ValueError(
                f"T_loc={t // nt} must be a multiple of {m} "
                f"(OLS hop × down{' × fft' if frames == 'local' else ''}"
                " alignment)"
            )
        if frames == "a2a" and c % math.prod(
                [mesh.shape[a] for a in mesh.axis_names]):
            raise ValueError(
                f"frames='a2a' needs C={c} divisible by the device count"
            )
