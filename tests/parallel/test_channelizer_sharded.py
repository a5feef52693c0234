"""Sharded channelizer == unsharded streaming (VERDICT r1 missing #6).

The flagship chain's `sharded_step` was previously verified only by the
driver dryrun; these tests pin the sharded==unsharded invariant on the
8-device CPU mesh (SURVEY.md §4.6) including state carry across
super-blocks.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

import llzlab_tpu as lz
from llzlab_tpu.chains.channelizer import Channelizer
from llzlab_tpu.parallel.mesh import make_dsp_mesh, CHANNEL_AXIS, TIME_AXIS


def _chan():
    # Small flagship: every collective (halo ppermute ×2, tail broadcast)
    # is exercised while block_multiple stays CPU-mesh-sized.
    return Channelizer(
        fir_taps=lz.firwin(256, 0.4),
        fft_n=128,
        taps_per_phase=16,
        fir_method="direct",
    )


def _run_sharded(chan, mesh, x, n_steps=1):
    c, t = x.shape
    chan.validate_sharded_shapes(mesh, c, t)
    step = chan.sharded_step(mesh)
    x_spec = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
    st_spec = NamedSharding(mesh, P(CHANNEL_AXIS, None))
    xd = jax.device_put(jnp.asarray(x), x_spec)
    st = tuple(jax.device_put(s, st_spec) for s in chan.init_state(c))
    outs = []
    for _ in range(n_steps):
        spec, st = step(xd, st)
        outs.append(np.asarray(spec))
    return outs, st


def _run_streaming(chan, x, t_loc, n_steps=1):
    """Unsharded streaming reference at t_loc granularity."""
    c, t = x.shape
    st = chan.init_state(c)
    outs = []
    for _ in range(n_steps):
        frames = []
        for j in range(t // t_loc):
            spec, st = chan.step(
                jnp.asarray(x[:, j * t_loc : (j + 1) * t_loc]), st
            )
            frames.append(np.asarray(spec))
        outs.append(np.concatenate(frames, axis=1))
    return outs, st


@pytest.fixture(scope="module")
def chan():
    return _chan()


@pytest.fixture(scope="module")
def snr():
    def f(ref, y):
        ref = np.asarray(ref)
        y = np.asarray(y)
        e = np.abs(ref - y)
        return 10 * np.log10(np.sum(np.abs(ref) ** 2) / np.sum(e**2))

    return f


class TestChannelizerSharded:
    @pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
    def test_matches_unsharded_streaming(self, chan, mesh_shape, snr):
        nc, nt = mesh_shape
        mesh = make_dsp_mesh(nc, nt)
        m = chan.block_multiple()
        c, t = 2 * nc if nc > 1 else 4, m * nt
        rng = np.random.default_rng(77)
        x = rng.standard_normal((c, t)).astype(np.float32)
        (spec_sh,), _ = _run_sharded(chan, mesh, x)
        (spec_ref,), _ = _run_streaming(chan, x, m)
        assert spec_sh.shape == spec_ref.shape
        # FIR/resample locals are bit-exact vs streaming; the rfft frames
        # go through the same local shapes — require >=140 dB (complex).
        assert snr(spec_ref, spec_sh) >= 140.0

    def test_state_carry_across_superblocks(self, chan, snr):
        mesh = make_dsp_mesh(2, 4)
        m = chan.block_multiple()
        c, t = 4, m * 4
        rng = np.random.default_rng(78)
        x = rng.standard_normal((c, t)).astype(np.float32)
        outs_sh, st_sh = _run_sharded(chan, mesh, x, n_steps=2)
        outs_ref, st_ref = _run_streaming(chan, x, m, n_steps=2)
        # Super-block 2 consumed the carried state — it must still match.
        assert snr(outs_ref[1], outs_sh[1]) >= 140.0
        for a, b in zip(st_sh, st_ref):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=0
            )

    def test_spec_energy_is_finite_and_nonzero(self, chan):
        mesh = make_dsp_mesh(1, 8)
        m = chan.block_multiple()
        rng = np.random.default_rng(79)
        x = rng.standard_normal((4, m * 8)).astype(np.float32)
        (spec,), _ = _run_sharded(chan, mesh, x)
        e = np.abs(spec).sum()
        assert np.isfinite(e) and e > 0


class TestChannelizerFusedSharded:
    """fir_method='fused' under shard_map: ONE 2·block halo replaces the
    FIR+resampler pair; sharded == unsharded streaming (VERDICT r2 #2)."""

    def _chan_fused(self):
        return Channelizer(
            fir_taps=lz.firwin(256, 0.4),
            up=3,
            down=4,
            fft_n=128,
            taps_per_phase=8,
            fir_method="fused",
        )

    @pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4)])
    def test_matches_unsharded_streaming(self, mesh_shape, snr):
        chan = self._chan_fused()
        nc, nt = mesh_shape
        mesh = make_dsp_mesh(nc, nt)
        m = chan.block_multiple()
        c, t = 8, m * nt  # local C = 8/nc: kernel path at nc=1, fallback at nc=2
        rng = np.random.default_rng(81)
        x = rng.standard_normal((c, t)).astype(np.float32)
        (spec_sh,), st_sh = _run_sharded(chan, mesh, x)
        (spec_ref,), st_ref = _run_streaming(chan, x, m)
        assert spec_sh.shape == spec_ref.shape
        assert snr(spec_ref, spec_sh) >= 110.0
        np.testing.assert_allclose(
            np.asarray(st_sh[0]), np.asarray(st_ref[0]), rtol=0, atol=0)

    def test_superblock_carry(self, snr):
        chan = self._chan_fused()
        mesh = make_dsp_mesh(1, 8)
        m = chan.block_multiple()
        c, t = 8, m * 8
        rng = np.random.default_rng(82)
        x = rng.standard_normal((c, t)).astype(np.float32)
        outs_sh, _ = _run_sharded(chan, mesh, x, n_steps=2)
        outs_ref, _ = _run_streaming(chan, x, m, n_steps=2)
        assert snr(outs_ref[1], outs_sh[1]) >= 110.0


class TestChannelizerHaloOverlap:
    """halo_overlap=True — the halo collective feeds only a correction
    term so XLA can overlap it with the bulk FIR compute (SURVEY §7 hard
    part 4).  The f(0,x)+f(halo,0) split reassociates f32 adds, so parity
    is ~140 dB, not bit-exact."""

    def _run(self, chan, mesh, x, **kw):
        c = x.shape[0]
        step = chan.sharded_step(mesh, **kw)
        x_spec = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
        st_spec = NamedSharding(mesh, P(CHANNEL_AXIS, None))
        xd = jax.device_put(jnp.asarray(x), x_spec)
        st = tuple(jax.device_put(s, st_spec) for s in chan.init_state(c))
        s1, st = step(xd, st)
        s2, _ = step(xd, st)  # carried state exercises a nonzero halo
        return np.asarray(s1), np.asarray(s2)

    @pytest.mark.parametrize("method", ["block2", "fused"])
    def test_overlap_matches_exact(self, method, snr):
        chan = Channelizer(
            fir_taps=lz.firwin(256, 0.4),
            up=3,
            down=4,
            fft_n=128,
            taps_per_phase=8,
            fir_method=method,
        )
        mesh = make_dsp_mesh(1, 8)
        m = chan.block_multiple()
        rng = np.random.default_rng(84)
        x = rng.standard_normal((8, m * 8)).astype(np.float32)
        a1, a2 = self._run(chan, mesh, x, halo_overlap=True)
        b1, b2 = self._run(chan, mesh, x, halo_overlap=False)
        assert snr(b1, a1) >= 135.0
        assert snr(b2, a2) >= 135.0

    def test_rejects_ols(self):
        chan = _chan()  # fir_method="direct"
        with pytest.raises(ValueError, match="halo_overlap"):
            chan.sharded_step(make_dsp_mesh(1, 8), halo_overlap=True)


class TestChannelizerA2AFrames:
    """frames='a2a' — the Ulysses analog in actual use (VERDICT r2 weak
    #4): spectral frames straddle time-shard boundaries, so the chain
    reshards to channel-major with ONE all-to-all before the FFT."""

    def test_straddling_frames_match_unsharded(self, chan, snr):
        mesh = make_dsp_mesh(2, 4)
        m_a2a = chan.block_multiple("a2a")
        m_loc = chan.block_multiple("local")
        # pick a per-shard length that is FIR/resample-aligned but NOT
        # fft-aligned — the local mode must reject it, a2a must run.
        t_loc = -(-max(chan.h_fir, chan.h_rs, 1) // m_a2a) * m_a2a
        while ((t_loc * chan.up // chan.down) % chan.fft_n == 0
               or t_loc % m_loc == 0):
            t_loc += m_a2a
        assert t_loc % m_loc != 0
        c, t = 8, t_loc * 4
        with pytest.raises(ValueError):
            chan.validate_sharded_shapes(mesh, c, t, frames="local")
        chan.validate_sharded_shapes(mesh, c, t, frames="a2a")

        rng = np.random.default_rng(83)
        x = rng.standard_normal((c, t)).astype(np.float32)
        step = chan.sharded_step(mesh, frames="a2a")
        x_spec = NamedSharding(mesh, P(CHANNEL_AXIS, TIME_AXIS))
        st_spec = NamedSharding(mesh, P(CHANNEL_AXIS, None))
        xd = jax.device_put(jnp.asarray(x), x_spec)
        st = tuple(jax.device_put(s, st_spec) for s in chan.init_state(c))
        spec_sh, st2 = step(xd, st)
        # one-shot unsharded step frames the whole stream contiguously —
        # exactly the a2a semantic
        spec_ref, _ = chan.step(jnp.asarray(x), chan.init_state(c))
        assert spec_sh.shape == spec_ref.shape
        assert snr(np.asarray(spec_ref), np.asarray(spec_sh)) >= 110.0

    def test_rejects_bad_channel_count(self, chan):
        mesh = make_dsp_mesh(2, 4)
        with pytest.raises(ValueError, match="device count"):
            chan.validate_sharded_shapes(
                mesh, 4, chan.block_multiple("a2a") * 4, frames="a2a")


def _chan_m(method):
    return Channelizer(
        fir_taps=lz.firwin(256, 0.4),
        up=3,
        down=4,
        fft_n=128,
        taps_per_phase=8,
        fir_method=method,
    )


def _run_sharded_1d(chan, mesh, x, n_steps=1, **kw):
    c, t = x.shape
    chan.validate_sharded_shapes(mesh, c, t)
    step = chan.sharded_step(mesh, **kw)
    x_spec = NamedSharding(mesh, P(None, TIME_AXIS))
    st_spec = NamedSharding(mesh, P(None, None))
    xd = jax.device_put(jnp.asarray(x), x_spec)
    st = tuple(jax.device_put(s, st_spec) for s in chan.init_state(c))
    outs = []
    for _ in range(n_steps):
        spec, st = step(xd, st)
        outs.append(np.asarray(spec))
    return outs, st


def _time_mesh(n):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]), (TIME_AXIS,))


class TestChannelizerPpermuteHalo1D:
    """The ppermute halo on a 1-D (time,) mesh of all 8 devices: every
    shard boundary of the stream crosses a device, and the sharded step
    reproduces the unsharded streaming chain (state carry included)."""

    @pytest.mark.parametrize("method", ["direct", "block2", "fused"])
    def test_matches_streaming(self, method, snr):
        chan = _chan_m(method)
        mesh = _time_mesh(8)
        m = chan.block_multiple()
        c, t = 4, m * 8
        rng = np.random.default_rng(80)
        x = rng.standard_normal((c, t)).astype(np.float32)
        (a,), st_a = _run_sharded_1d(chan, mesh, x)
        (b,), st_b = _run_streaming(chan, x, m)
        assert snr(b, a) >= 120.0
        # the carried FIR history is an input slice: bit-identical
        np.testing.assert_array_equal(np.asarray(st_a[0]),
                                      np.asarray(st_b[0]))

    @pytest.mark.parametrize("method", ["block2", "fused"])
    def test_superblock_carry(self, method, snr):
        chan = _chan_m(method)
        mesh = _time_mesh(4)
        m = chan.block_multiple()
        c, t = 8, m * 4
        rng = np.random.default_rng(86)
        x = rng.standard_normal((c, t)).astype(np.float32)
        outs, _ = _run_sharded_1d(chan, mesh, x, n_steps=2)
        refs, _ = _run_streaming(chan, x, m, n_steps=2)
        # step 2 sees a nonzero carried history through the halo
        assert snr(refs[1], outs[1]) >= 120.0

    @pytest.mark.parametrize("method", ["block2", "fused"])
    def test_overlap_1d(self, method, snr):
        chan = _chan_m(method)
        mesh = _time_mesh(8)
        m = chan.block_multiple()
        rng = np.random.default_rng(87)
        x = rng.standard_normal((4, m * 8)).astype(np.float32)
        a, _ = _run_sharded_1d(chan, mesh, x, n_steps=2, halo_overlap=True)
        b, _ = _run_sharded_1d(chan, mesh, x, n_steps=2)
        assert snr(b[0], a[0]) >= 135.0
        assert snr(b[1], a[1]) >= 135.0


class TestChannelizerShardedPairFormat:
    def test_pair_spec_format_sharded_matches_unsharded(self, snr):
        """spec_format='pair' (r5 bench default) through sharded_step:
        the pair frames engine must survive the shard_map out_specs and
        match the unsharded pair step."""
        import llzlab_tpu as lz
        from llzlab_tpu.chains.channelizer import Channelizer

        chan = Channelizer(
            fir_taps=lz.firwin(96, 0.4),
            up=3,
            down=4,
            fft_n=128,
            taps_per_phase=16,
            fir_method="direct",
            spec_format="pair",
        )
        mesh = make_dsp_mesh(2, 4)
        m = chan.block_multiple()
        c, t = 4, m * 4
        rng = np.random.default_rng(79)
        x = rng.standard_normal((c, t)).astype(np.float32)
        (spec_sh,), _ = _run_sharded(chan, mesh, x)
        ref, _ = chan.step(jnp.asarray(x), chan.init_state(c))
        ref = np.asarray(ref)
        assert spec_sh.shape == ref.shape
        assert spec_sh.shape[-1] == chan.fft_n + 2
        assert snr(ref, spec_sh) >= 140.0
