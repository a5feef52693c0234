"""User-facing numerical ops (SURVEY.md layer T2).

Every op has a pure-jnp path that runs on the CPU and the GPU and is
jit/vmap-able;
Pallas fast paths live in ``llzlab_tpu.kernels`` and are dispatched from
here where profitable.
"""

from llzlab_tpu.ops.transform import (  # noqa: F401
    fft,
    ifft,
    rfft,
    irfft,
    fft_matmul,
    rfft_matmul,
    irfft_matmul,
    rfft_pair,
    pair_to_complex,
)
from llzlab_tpu.ops.spectral import stft, istft, frame, overlap_add  # noqa: F401
from llzlab_tpu.ops.fir import (  # noqa: F401
    firwin,
    firwin2,
    firls,
    minimum_phase,
    kaiserord,
    kaiser_beta,
    kaiser_atten,
    fir_filter,
    fir_halo,
    default_nfft,
    ols_hop,
    fir_state_len,
)
from llzlab_tpu.ops.signals import (  # noqa: F401
    tone,
    multitone,
    chirp,
    square,
    sawtooth,
    gausspulse,
    white_noise,
    pink_noise,
    noisy_tones,
)
from llzlab_tpu.ops.iir import (  # noqa: F401
    butter_sos,
    cheby1_sos,
    cheby2_sos,
    ellip_sos,
    bessel_sos,
    iirfilter_sos,
    buttord,
    cheb1ord,
    cheb2ord,
    ellipord,
    peaking_eq_sos,
    rbj_biquad,
    sosfilt,
)
from llzlab_tpu.ops.fused_chain import (  # noqa: F401
    fir_resample,
    fir_resample_state_len,
)
from llzlab_tpu.ops.iir_matmul import sosfilt_matmul  # noqa: F401
from llzlab_tpu.ops.iir_select import sosfilt_auto  # noqa: F401
from llzlab_tpu.ops.remez import remez  # noqa: F401
from llzlab_tpu.ops.resample import (  # noqa: F401
    resample_poly,
    resample_taps,
    resample_output_len,
)
from llzlab_tpu.ops.window import get_window  # noqa: F401
from llzlab_tpu.ops.mdct import mdct, imdct  # noqa: F401
from llzlab_tpu.ops.dct import dct, idct, dst, idst  # noqa: F401
from llzlab_tpu.ops.iir import (  # noqa: F401
    sosfiltfilt,
    filtfilt,
    lfilter,
    lfilter_zi,
    sosfilt_zi,
    sosfilt_zi_scan,
    tf2sos,
)
# NOTE: the scipy-named `resample` FUNCTION is exported only from the
# top-level package — binding it here would shadow the `ops.resample`
# submodule name.
from llzlab_tpu.ops.resample import decimate  # noqa: F401
from llzlab_tpu.ops.resample import resample as resample_fft  # noqa: F401
from llzlab_tpu.ops.convolve import fftconvolve, correlate  # noqa: F401
from llzlab_tpu.ops.analysis import (  # noqa: F401
    freqz,
    sosfreqz,
    group_delay,
    spectrogram,
)
from llzlab_tpu.ops.analysis import (  # noqa: F401
    hilbert,
    periodogram,
    welch,
    csd,
    coherence,
)
from llzlab_tpu.ops.smooth import (  # noqa: F401
    detrend,
    savgol_coeffs,
    savgol_filter,
    medfilt,
    wiener,
)
from llzlab_tpu.ops.chirpz import czt, zoom_fft, resample_fourier  # noqa: F401
