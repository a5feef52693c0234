"""llzlab_tpu — a JAX DSP framework for NVIDIA GPUs.

A ground-up JAX/XLA/Pallas re-design of the capability surface of the
``templeblock/llzlab`` C audio lab (reference mount at /root/reference was
empty at survey time; the binding spec is /root/repo/BASELINE.json — see
SURVEY.md §0).  Capabilities: FFT/STFT transforms, FIR design + overlap-save
fast convolution, IIR biquad cascades as parallel scans, polyphase rational
resampling, and composed multi-channel chains sharded over device meshes.

Layering (SURVEY.md §1b):
    runtime/  — mesh + platform bootstrap           (T0)
    kernels/  — Pallas GPU kernels                  (T1)
    ops/      — user-facing numerical ops           (T2)
    parallel/ — sharding strategies (DP/SP/carry)   (T3)
    pipeline/ — chain composition + streaming       (T4)
    io/, cli/ — WAV I/O and tool frontends          (T5)
"""

__version__ = "0.1.0"

from llzlab_tpu.ops import (  # noqa: F401
    remez,
    fft,
    ifft,
    rfft,
    irfft,
    stft,
    istft,
    firwin,
    fir_filter,
    butter_sos,
    cheby1_sos,
    cheby2_sos,
    ellip_sos,
    bessel_sos,
    iirfilter_sos,
    peaking_eq_sos,
    rbj_biquad,
    sosfilt,
    sosfilt_matmul,
    sosfilt_auto,
    resample_poly,
    resample_taps,
    fir_resample,
    get_window,
    firls,
    minimum_phase,
    filtfilt,
    sosfiltfilt,
    lfilter,
    lfilter_zi,
    sosfilt_zi,
    sosfilt_zi_scan,
)
# imported from the submodule, not llzlab_tpu.ops, so the scipy-named
# function never shadows the ops.resample module
from llzlab_tpu.ops.resample import resample, decimate  # noqa: F401
from llzlab_tpu.ops.fir import (  # noqa: F401
    firwin2, kaiserord, kaiser_beta, kaiser_atten,
)
from llzlab_tpu.ops.iir import (  # noqa: F401
    buttord, cheb1ord, cheb2ord, ellipord, tf2sos,
)
from llzlab_tpu.ops.analysis import (  # noqa: F401
    freqz, sosfreqz, group_delay, spectrogram, hilbert, periodogram,
    welch, csd, coherence,
)
from llzlab_tpu.ops.convolve import fftconvolve, correlate  # noqa: F401
from llzlab_tpu.ops.smooth import (  # noqa: F401
    detrend, savgol_coeffs, savgol_filter, medfilt, wiener,
)
from llzlab_tpu.ops.dct import dct, idct, dst, idst  # noqa: F401
from llzlab_tpu.ops.chirpz import czt, zoom_fft  # noqa: F401
from llzlab_tpu.ops.signals import (  # noqa: F401
    chirp, square, sawtooth, gausspulse,
)
# scipy.signal-compatible front doors (ops/compat.py): designers with
# ba/zpk/sos outputs, representation conversions, and utilities
from llzlab_tpu.ops.compat import (  # noqa: F401
    butter, cheby1, cheby2, ellip, bessel, iirfilter, iirdesign,
    bilinear_zpk, zpk2tf, tf2zpk, zpk2sos, sos2tf, sos2zpk, normalize,
    lfiltic, deconvolve, freqs, convolve, oaconvolve, upfirdn,
    analytic_envelope, unit_impulse, lombscargle, find_peaks,
)
from llzlab_tpu.pipeline import Chain  # noqa: F401
