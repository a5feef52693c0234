"""Chain: graph composition of ops with streaming state carry.

Capability parity target: the reference's per-tool frame loops (wav in →
process → wav out, with per-module history buffers; mount empty — spec
anchors BASELINE.json:10 "STFT→spectral-gain→iSTFT chain" and
BASELINE.json:11 "FIR+resample+FFT channelizer").

Design: a ``Chain`` is a pure function over ``(signal, state)``
pytrees — one jit region per block, no per-frame host loop.  Each
``Stage`` declares its streaming state (FIR history, biquad z1/z2,
resampler phase history) so a chain can process an unbounded stream as an
outer host loop over super-blocks with carried state, and can be
checkpointed/resumed mid-stream (state is a few KB per channel).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from llzlab_tpu.ops import fir as _fir
from llzlab_tpu.ops import iir as _iir
from llzlab_tpu.ops import resample as _resample
from llzlab_tpu.ops import spectral as _stft
from llzlab_tpu.ops import transform as _fft
from llzlab_tpu.ops.spectral import spectral_engine_auto

__all__ = [
    "Stage",
    "FIRStage",
    "SOSStage",
    "ResampleStage",
    "FusedFirResampleStage",
    "SpectralGainStage",
    "FFTStage",
    "LambdaStage",
    "Chain",
]


class Stage:
    """One processing stage.  Subclasses are static (hashable) configs; all
    array data flows through ``apply``."""

    #: output_rate = input_rate · rate_num / rate_den (for stream bookkeeping)
    rate: Tuple[int, int] = (1, 1)
    #: input block lengths must be a multiple of this for exact streaming
    block_multiple: int = 1

    def init_state(self, batch_shape: Tuple[int, ...], dtype=jnp.float32):
        return None

    def apply(self, x: jnp.ndarray, state):
        raise NotImplementedError


class FIRStage(Stage):
    """Causal FIR filtering (overlap-save or direct; ops/fir.py)."""

    def __init__(self, taps, *, method: str = "auto", nfft: Optional[int] = None):
        self.taps = np.asarray(taps, dtype=np.float64)
        self.nfft = nfft
        ntaps = len(self.taps)
        if method == "auto":
            # Resolve once at stage-build time (mirrors ops/fir.py "auto")
            # so the carried state length is fixed for the stage's life.
            method = _fir.fir_method_auto(ntaps)
        self.method = method
        eff_nfft = nfft or _fir.default_nfft(ntaps)
        self._state_len = _fir.fir_state_len(ntaps, eff_nfft, method)
        # exact streaming when blocks align with the engine's frame grid
        if method == "ols":
            self.block_multiple = _fir.ols_hop(ntaps, eff_nfft)
        elif method == "block2":
            self.block_multiple = _fir.block2_block(ntaps)
        else:
            self.block_multiple = 1

    def init_state(self, batch_shape, dtype=jnp.float32):
        return jnp.zeros(batch_shape + (self._state_len,), dtype)

    def apply(self, x, state):
        y, zf = _fir.fir_filter(
            x, self.taps, method=self.method, nfft=self.nfft, zi=state,
            return_zf=True,
        )
        return y, zf


class SOSStage(Stage):
    """Cascaded-biquad filtering via blockwise parallel scan (ops/iir.py)."""

    def __init__(self, sos, *, block_size: int = 4096):
        self.sos = np.asarray(sos, dtype=np.float64)
        self.block_size = block_size
        self.block_multiple = block_size

    def init_state(self, batch_shape, dtype=jnp.float32):
        return jnp.zeros(batch_shape + (self.sos.shape[0], 2), jnp.float32)

    def apply(self, x, state):
        return _iir.sosfilt(
            self.sos, x, zi=state, block_size=self.block_size, return_zf=True
        )


class ResampleStage(Stage):
    """Rational polyphase resampling (ops/resample.py)."""

    def __init__(self, up: int, down: int, *, taps=None, taps_per_phase: int = 64):
        import math

        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        if taps is None:
            taps = _resample.resample_taps(self.up, self.down, taps_per_phase)
        taps = np.asarray(taps, dtype=np.float64)
        if len(taps) % self.up != 0:
            taps = np.pad(taps, (0, self.up - len(taps) % self.up))
        self.taps = taps
        self.k = len(taps) // self.up
        self.rate = (self.up, self.down)
        self.block_multiple = self.down

    def init_state(self, batch_shape, dtype=jnp.float32):
        return jnp.zeros(batch_shape + (self.k - 1,), jnp.float32)

    def apply(self, x, state):
        return _resample.resample_poly(
            x, self.up, self.down, taps=self.taps, zi=state, return_zf=True
        )


class FusedFirResampleStage(Stage):
    """FIR + rational resample as ONE fused stage (ops/fused_chain.py).

    ``Chain([FIRStage, ResampleStage])`` runs the two engines unfused,
    bouncing the full-rate intermediate through device memory; this stage
    routes through ``lz.fir_resample`` so ``Chain`` users get its engine
    choice (the Pallas kernel on the GPU, the XLA composite matmul on the
    CPU).  Every engine carries the same history, so the state does not
    depend on the engine.
    """

    def __init__(self, fir_taps, up: int, down: int, *, rtaps=None,
                 taps_per_phase: int = 64, engine: str = "auto",
                 precision: Optional[str] = None):
        import math

        from llzlab_tpu.ops import fused_chain as _fc

        g = math.gcd(up, down)
        self.up, self.down = up // g, down // g
        self.fir_taps = np.asarray(fir_taps, np.float64)
        if rtaps is None:
            rtaps = _resample.resample_taps(self.up, self.down,
                                            taps_per_phase)
        rtaps = np.asarray(rtaps, np.float64)
        if len(rtaps) % self.up:
            rtaps = np.pad(rtaps, (0, self.up - len(rtaps) % self.up))
        self.rtaps = rtaps
        self.precision = precision
        self.rate = (self.up, self.down)
        self.engine = _fc.fir_resample_engine() if engine == "auto" \
            else engine
        self._state_len = _fc.fir_resample_state_len(
            len(self.fir_taps), self.up, self.down, len(rtaps))
        self.block_multiple = self.down

    def init_state(self, batch_shape, dtype=jnp.float32):
        return jnp.zeros(batch_shape + (self._state_len,), jnp.float32)

    def apply(self, x, state):
        from llzlab_tpu.ops.fused_chain import fir_resample

        return fir_resample(
            x, self.fir_taps, self.up, self.down, rtaps=self.rtaps,
            zi=state, return_zf=True, engine=self.engine,
            precision=self.precision,
        )


class SpectralGainStage(Stage):
    """STFT → per-bin gain → iSTFT (the BASELINE.json:10 workload).

    ``gain`` is an ``(n_fft//2+1,)`` array, or a callable mapping the
    complex spectrum ``(..., nf, bins)`` to a (broadcastable) gain.

    Streaming is boundary-exact: the stage carries the analysis lookback
    (``overlap = n_fft − hop`` input samples), the synthesis OLA tail and
    the window-square envelope tail, so concatenated streamed blocks equal
    the one-shot ``istft(gain·stft(x))`` at EVERY sample — not just the
    frame interior (same math as parallel/spectral_sp.py's shard-boundary
    exchange, applied in time).  A frame can only be synthesized once all
    of its samples have arrived, so the stage has a fixed latency of
    ``overlap`` samples: block ``b`` (length T) emits one-shot samples
    ``[b·T − overlap, (b+1)·T − overlap)`` and the stream leads with
    ``overlap`` zeros.  :meth:`flush` drains the final ``overlap`` samples.

    ``precision`` pins the matmul precision of the stage's transforms
    (default "highest", so that a process-wide LLZ_MATMUL_PRECISION=high
    cannot silently lower the stage's SNR).  Pass ``None`` to inherit the
    env default.
    """

    def __init__(
        self,
        gain,
        *,
        n_fft: int = 2048,
        hop: Optional[int] = None,
        window: str = "hann",
        method: str = "auto",
        precision: Optional[str] = "highest",
        engine: str = "auto",
    ):
        self.gain = gain if callable(gain) else np.asarray(gain, np.float32)
        self.n_fft = n_fft
        self.hop = hop or n_fft // 4
        if self.n_fft % self.hop:
            raise ValueError("hop must divide n_fft")
        self.window = window
        self.method = method
        self.precision = precision
        # "cwola" (r5): for a STATIC gain vector the whole analysis→
        # gain→synthesis per-frame map composes on host to ONE
        # (n_fft, n_fft) real matrix — n² MACs/frame vs the wdft
        # engine's 2·2·n·(n/2+1) (2.0× fewer at n=2048), no
        # intermediate spectrum in HBM (ops/spectral.composed_wola).
        # "wdft": frame-free windowed shifted-matmul analysis/synthesis
        # (window folded into the DFT tables, no 4x frame expansion —
        # ops/spectral.windowed_rdft) — required when gain is callable
        # (data-dependent, cannot compose).  "reference": frame->rfft->
        # irfft->overlap_add.  "auto" = reference on every backend (the
        # FFT library beats dense matmuls on the CPU; the GPU choice is
        # unmeasured — ROADMAP A4).
        if engine == "auto":
            engine = spectral_engine_auto()
        if engine == "cwola" and callable(self.gain):
            raise ValueError(
                "engine='cwola' composes a STATIC gain into the frame "
                "map; a callable gain needs engine='wdft'")
        self.engine = engine
        self.block_multiple = self.hop
        #: output samples lag input samples by this much (WOLA lookback)
        self.latency = self.n_fft - self.hop

    def init_state(self, batch_shape, dtype=jnp.float32):
        ov = self.latency
        return {
            "x_hist": jnp.zeros(batch_shape + (ov,), jnp.float32),
            "ola": jnp.zeros(batch_shape + (ov,), jnp.float32),
            "env": jnp.zeros((ov,), jnp.float32),
            # input samples consumed so far, saturated at `ov` — only the
            # threshold matters (masks the zero-pad frames at stream start)
            "pos": jnp.zeros((), jnp.int32),
        }

    def _window(self):
        from llzlab_tpu.ops.window import get_window

        return jnp.asarray(
            get_window(self.window, self.n_fft, periodic=True).astype(
                np.float32
            )
        )

    def apply(self, x, state):
        from llzlab_tpu.ops.transform import precision_scope

        ov = self.latency
        ratio = self.n_fft // self.hop
        t = x.shape[-1]
        if t % self.hop:
            raise ValueError(f"block length {t} not a multiple of hop")
        w = self._window()
        ext = jnp.concatenate(
            [state["x_hist"], x.astype(jnp.float32)], axis=-1
        )
        nf = t // self.hop
        # Early stream blocks: ext leads with zero-pad frames (global
        # frame start < 0) that the one-shot run never sees — mask them.
        # Frame k starts at global input position pos + k·hop − ov.
        mask = (
            state["pos"] + jnp.arange(nf) * self.hop >= ov
        ).astype(jnp.float32)
        if self.engine == "cwola":
            with precision_scope(self.precision):
                buf = _stft.composed_wola(
                    ext, mask, self.n_fft, self.hop, self.window,
                    np.asarray(self.gain, np.float64),
                    prec=self.precision)
        elif self.engine == "wdft":
            with precision_scope(self.precision):
                spec = _stft.windowed_rdft(
                    ext, self.n_fft, self.hop, self.window,
                    prec=self.precision)
                if callable(self.gain):
                    spec = spec * self.gain(spec)
                else:
                    spec = spec * jnp.asarray(self.gain)
                # synthesis masking commutes with the linear inverse
                buf = _stft.windowed_irdft_ola(
                    spec * mask[:, None], self.n_fft, self.hop,
                    self.window, prec=self.precision)
        else:
            frames = _stft.frame(ext, self.n_fft, self.hop) * w
            with precision_scope(self.precision):
                spec = _fft.rfft(frames, self.n_fft, method=self.method)
                if callable(self.gain):
                    spec = spec * self.gain(spec)
                else:
                    spec = spec * jnp.asarray(self.gain)
                synth = _fft.irfft(spec, self.n_fft,
                                   method=self.method) * w
            synth = synth * mask[:, None]
            buf = _stft.overlap_add(synth, self.hop)  # (..., ov + t)
        wsq = jnp.broadcast_to(w * w, (nf, self.n_fft)) * mask[:, None]
        env = _stft.overlap_add(wsq, self.hop)  # (ov + t,)
        buf = buf.at[..., :ov].add(state["ola"])
        env = env.at[:ov].add(state["env"])
        y = (buf[..., :t] / jnp.maximum(env[:t], 1e-8)).astype(x.dtype)
        new_state = {
            "x_hist": ext[..., t:],
            "ola": buf[..., t:],
            "env": env[t:],
            "pos": jnp.minimum(state["pos"] + t, ov).astype(jnp.int32),
        }
        return y, new_state

    def flush(self, state, dtype=jnp.float32):
        """Final ``overlap`` output samples once the stream ends."""
        return (
            state["ola"] / jnp.maximum(state["env"], 1e-8)
        ).astype(dtype)


class FFTStage(Stage):
    """Frame the stream into n-point blocks and emit their spectra
    (channelizer back-end: (..., T) → complex (..., T//n, n//2+1))."""

    def __init__(self, n: int, *, window=None, method: str = "auto"):
        self.n = n
        self.window = window
        self.method = method
        self.block_multiple = n

    def apply(self, x, state):
        t = x.shape[-1]
        nfr = t // self.n
        xf = x[..., : nfr * self.n].reshape(x.shape[:-1] + (nfr, self.n))
        if self.window is not None:
            from llzlab_tpu.ops.window import get_window

            xf = xf * jnp.asarray(
                get_window(self.window, self.n, periodic=True).astype(np.float32)
            )
        return _fft.rfft(xf, self.n, method=self.method), state


class LambdaStage(Stage):
    """Stateless elementwise stage from a plain function."""

    def __init__(self, fn: Callable[[jnp.ndarray], jnp.ndarray]):
        self.fn = fn

    def apply(self, x, state):
        return self.fn(x), state


class Chain:
    """Composition of stages with a combined streaming state pytree.

    One-shot: ``y = chain(x)``.  Streaming: ``state = chain.init_state(
    batch_shape)``; then ``y, state = chain.apply(x_block, state)`` per
    block (wrap ``chain.apply`` in ``jax.jit`` — stages are static).
    """

    def __init__(self, stages: Sequence[Stage]):
        self.stages = tuple(stages)

    @property
    def block_multiple(self) -> int:
        """Smallest chain-input block granularity M for exact streaming.

        Stage i sees block length M·(num_acc/den_acc) where (num_acc,
        den_acc) accumulates the upstream rate changes; M is the LCM of the
        per-stage requirements that this be a multiple of
        ``stage.block_multiple``.
        """
        m = 1
        num_acc, den_acc = 1, 1
        for st in self.stages:
            need = st.block_multiple * den_acc
            need //= _gcd(num_acc, need)
            m = _lcm(m, need)
            num_acc *= st.rate[0]
            den_acc *= st.rate[1]
            g = _gcd(num_acc, den_acc)
            num_acc //= g
            den_acc //= g
        return m

    def init_state(self, batch_shape: Tuple[int, ...], dtype=jnp.float32):
        return tuple(st.init_state(batch_shape, dtype) for st in self.stages)

    def apply(self, x: jnp.ndarray, state):
        new_state = []
        for st, s in zip(self.stages, state):
            x, s = st.apply(x, s)
            new_state.append(s)
        return x, tuple(new_state)

    def __call__(self, x: jnp.ndarray):
        y, _ = self.apply(x, self.init_state(x.shape[:-1], x.dtype))
        return y

    def stream(self, blocks, batch_shape=None, dtype=jnp.float32):
        """Generator: yield processed blocks, carrying state.

        Every shipped stage is jittable (their apply bodies are traced
        jax ops with static config), so the block loop runs under one
        jit; a stage with genuinely untraceable apply logic should
        override ``jittable = False`` on itself."""
        state = None
        jittable = all(getattr(s, "jittable", True) for s in self.stages)
        apply_fn = jax.jit(self.apply) if jittable else self.apply
        for blk in blocks:
            if state is None:
                bs = batch_shape if batch_shape is not None else blk.shape[:-1]
                state = self.init_state(bs, dtype)
            y, state = apply_fn(blk, state)
            yield y


def _gcd(a, b):
    import math

    return math.gcd(int(a), int(b))


def _lcm(a, b):
    return a * b // _gcd(a, b)



