"""Flagship model: wideband coherent-dedispersion + fold pipeline.

One jit-compiled step covering BASELINE.json configs 4/5: a block of
channelized dual/quad-pol complex baseband → per-channel coherent
dedispersion (overlap-save chirp) → detection → phase-binned fold, sharded
over a (time, chan) device mesh:

- **chan axis**: frequency channels spread across devices; dedispersion
  and folding are per-channel, so this axis needs no communication.
- **time axis**: the sample axis is block-sharded; overlap-save pads move
  between neighbor devices by ``ppermute`` halo exchange
  (parallel/halo.py), and fold partial profiles reduce with ``psum``.

Everything in the step is static-shaped; XLA fuses the chirp multiply,
detection and fold into the FFTs' neighbours.  Float blocks enter as
trailing float32 (re, im) pairs; packed 1/2/4/8-bit blocks enter as
uint32 words and are decoded inside the step (ops/unpack_device.py).

Reference parity: composes the semantics of dispersion.py Disperse (chirp),
functions.py Square, and integration.py Fold into one device program.
"""

from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dm import DispersionMeasure
from ..ops.fold import FX_MASK, FX_ONE, fold_accumulate, fold_bins
from ..ops.unpack_device import unpack_time_words
from ..parallel.halo import halo_exchange
from ..utils import units as u

__all__ = ["WidebandPulsarPipeline"]

#: packed bit depths the step decodes, and the scale that keeps each
#: depth's decoded samples of order unity
_PACKED_NORM = {8: 1.0 / 64.0, 4: 1.0 / 4.0, 2: 1.0, 1: 1.0}


class WidebandPulsarPipeline:
    """Dedisperse→detect→fold step over a (time, chan) mesh.

    Parameters
    ----------
    n_chan, n_pol : int
        Channels and polarizations of the input block.
    dm : float or DispersionMeasure
        Dispersion measure to remove (pc/cm³).
    freq_center : Quantity
        Band-centre sky frequency; channels are spaced by ``chan_rate``.
    chan_rate : Quantity
        Per-channel (complex) sample rate.
    period_samples : Fraction or tuple (q, p)
        Pulsar period as the exact rational q/p in units of channel
        samples.  The sample-offset bookkeeping stays exact integer
        (mod q) forever; per block the phase is re-encoded into the
        fixed-point fold map of ops/fold.py (error <= 2^-32
        cycle/sample within a block, never cumulative).  Requires
        p·q < 2^31 and q < 2^23.
    n_phase : int
        Phase bins per profile.
    block_samples : int
        Samples per time shard per step (grown to fill an FFT-fast
        window).
    mesh : jax.sharding.Mesh, optional
        (time, chan) mesh; default: single current device.
    phase_model, start_time : optional
        A drifting phase model (e.g. PolycoPhase) and the time of global
        sample 0; the fold then follows it block by block
        (models/foldmodel.py).
    detect : 'power' or 'stokes'
    """

    def __init__(self, *, n_chan=1024, n_pol=4, dm=500.0,
                 freq_center=None, chan_rate=None,
                 period_samples=(16000, 3), n_phase=64,
                 block_samples=16384, mesh=None,
                 phase_model=None, start_time=None, detect="power"):
        if freq_center is None:
            freq_center = 1400 * u.MHz
        if chan_rate is None:
            chan_rate = 250 * u.kHz
        self.n_chan = n_chan
        self.n_pol = n_pol
        if detect not in ("power", "stokes"):
            raise ValueError(f"detect={detect!r}: 'power' or 'stokes'")
        if detect == "stokes" and n_pol != 2:
            raise ValueError("detect='stokes' needs dual polarization "
                             "(n_pol=2): (X, Y) pairs per channel")
        #: 'power' -> |x|^2 per (chan, pol); 'stokes' -> per channel
        #: [XX, YY, Re(X Y*), Im(X Y*)] (reference functions.py:132-143)
        self.detect = detect
        self.n_phase = n_phase
        if mesh is None:
            mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                        ("time", "chan"))
        self.mesh = mesh
        self.n_time_shards = mesh.shape["time"]
        self.n_chan_shards = mesh.shape["chan"]
        if n_chan % self.n_chan_shards:
            raise ValueError("n_chan must divide over the chan mesh axis")
        if isinstance(period_samples, Fraction):
            frac = period_samples
        else:
            q, p = period_samples
            frac = Fraction(q, p)
        self._per_q = int(frac.numerator)    # q samples per p periods
        self._per_p = int(frac.denominator)
        if self._per_p * self._per_q >= (1 << 31) or \
                self._per_q >= (1 << 23):
            raise ValueError(
                f"period_samples {self._per_q}/{self._per_p} too fine: "
                f"need p*q < 2^31 and q < 2^23 for exact bookkeeping")
        if not 0 < int(n_phase) <= (1 << 15):
            raise ValueError(f"n_phase={n_phase} must be in [1, 32768]")
        # static fixed-point phase rate for the fixed-period mode
        self._p_fx = int(round((Fraction(self._per_p, self._per_q) % 1)
                               * FX_ONE)) & FX_MASK
        # Optional drifting phase model (e.g. PolycoPhase): per block the
        # host refreshes a fixed-point (i0_fx, p_fx) encoding of the
        # linearized phase (models/foldmodel.py); when None the fixed
        # rational period above is used forever.
        if phase_model is not None:
            from .foldmodel import FoldModel
            if start_time is None:
                raise ValueError("phase_model requires start_time")
            self.fold_model = FoldModel(phase_model, start_time,
                                        chan_rate, n_phase)
        else:
            self.fold_model = None

        dm = dm if isinstance(dm, DispersionMeasure) else DispersionMeasure(dm)
        self.dm = dm
        rate_hz = chan_rate.to_value(u.Hz)
        self.chan_rate = chan_rate
        # channel carrier frequencies: contiguous band around the centre
        chan_idx = np.arange(n_chan) - n_chan / 2 + 0.5
        freqs_mhz = freq_center.to_value(u.MHz) \
            + chan_idx * chan_rate.to_value(u.MHz)
        self.freqs = u.Quantity(freqs_mhz, u.MHz)
        ref = freq_center
        self.reference_frequency = ref
        # pads from the dispersion delay across the whole band: removing
        # a delay d advances the channel by d samples, so an output
        # sample reads input up to max(d) samples after it and -min(d)
        # before it (Dedisperse's pads, dispersion.py)
        edges = np.concatenate([freqs_mhz - rate_hz / 2e6,
                                freqs_mhz + rate_hz / 2e6])
        delays = dm.time_delay(u.Quantity(edges, u.MHz), ref).to_value(u.s)
        self.pad_start = max(int(np.ceil(-delays.min() * rate_hz)), 0) + 64
        self.pad_end = max(int(np.ceil(delays.max() * rate_hz)), 0) + 64
        # pads and window on a 128-sample grid: the valid block is then a
        # multiple of 128, which every packed bit depth's 32/bits
        # samples-per-word divides
        self.pad_start = -(-self.pad_start // 128) * 128
        self.pad_end = -(-self.pad_end // 128) * 128
        if self.pad_start + self.pad_end >= block_samples:
            raise ValueError(
                f"block_samples {block_samples} too small for dispersion "
                f"pads ({self.pad_start}, {self.pad_end}); raise it or "
                f"lower the DM")
        from ..fourier import next_fast_len
        n_min = block_samples + self.pad_start + self.pad_end
        n_fft = 128 * next_fast_len(-(-n_min // 128))
        self.block_samples = n_fft - self.pad_start - self.pad_end
        self._n_fft = n_fft
        self._chirp_np = self._build_chirp()
        self._step_cache = None

    def _build_chirp(self):
        """Dedispersion chirp conj(exp(2πi φ)) over (n_fft, n_chan, 1),
        complex64 (phase reduced mod 1 in float64)."""
        n = self._n_fft
        offsets_mhz = np.fft.fftfreq(n) * self.chan_rate.to_value(u.MHz)
        f_sky = self.freqs.to_value(u.MHz)[np.newaxis, :] \
            + offsets_mhz[:, np.newaxis]
        phase = self.dm.phase_delay(u.Quantity(f_sky, u.MHz),
                                    self.reference_frequency)
        cyc = np.asarray(phase.to_value(u.cycle), dtype=np.float64)
        cyc -= np.round(cyc)
        chirp = np.exp(-2j * np.pi * cyc)  # conjugate: REMOVE dispersion
        return chirp.astype(np.complex64)[:, :, np.newaxis]

    # -- the step ----------------------------------------------------------
    def _shard_fold3(self, foldv, shard, T):
        """Per-shard (3,) int32 [i0_fx, p_fx, 0] from the block-level
        vector whose i0_fx encodes the pulse phase at the block's first
        valid sample (models/foldmodel.py): adds the shard offset in
        phase units via multiplication by p_fx (int32 products wrap
        exactly mod 2^32, and 2^31 | 2^32, so the masked result is
        exact)."""
        base = (foldv[0] + (shard * T) * foldv[1]) & FX_MASK
        return jnp.stack([base, foldv[1], jnp.int32(0)])

    def _fixed_foldv(self, offset_mod):
        """(3,) int32 fixed-point fold vector for the fixed rational
        period mode, from a float32 *integer-valued* sample offset
        (phase zero at global sample 0, rate per_p/per_q cycles/sample).
        The offset is reduced mod per_q exactly in integers; only the
        final scaling to 2^-31-cycle units rounds (through float32,
        error < 2^-24 cycle — far below a phase bin)."""
        off = jnp.mod(offset_mod.astype(jnp.float32),
                      jnp.float32(self._per_q)).astype(jnp.int32)
        num = (off * self._per_p) % self._per_q   # exact: p*q < 2^31
        i0 = jnp.round(num.astype(jnp.float32)
                       * np.float32(FX_ONE / self._per_q))
        i0 = i0.astype(jnp.int32) & FX_MASK
        return jnp.stack([i0, jnp.int32(self._p_fx), jnp.int32(0)])

    @staticmethod
    def _foldv_from_halves(h):
        """(3,) int32 [i0_fx, p_fx, 0] from the (4,) float32 halves
        vector [i0_hi, i0_lo, p_hi, p_lo] (models/foldmodel.py)."""
        f = h.astype(jnp.int32)
        return jnp.stack([(f[0] << 16) | f[1], (f[2] << 16) | f[3],
                          jnp.int32(0)])

    def _foldv_device(self, fold_in):
        """Normalize a traced step input to the (3,) int32 fold vector:
        a scalar sample offset (fixed-period mode), a (4,) halves vector,
        or an already-built (3,) fixed-point vector."""
        if fold_in.ndim == 0:
            return self._fixed_foldv(fold_in)
        if fold_in.shape == (4,):
            return self._foldv_from_halves(fold_in)
        return fold_in.astype(jnp.int32)

    def _detect(self, y):
        """Detect a complex (T, C, P) block: power, or full Stokes-style
        [XX, YY, Re(X Y*), Im(X Y*)] per channel (reference
        functions.py:132-143)."""
        if self.detect == "power":
            return y.real ** 2 + y.imag ** 2
        x0, x1 = y[..., 0], y[..., 1]
        cross = x0 * jnp.conj(x1)
        return jnp.stack([jnp.abs(x0) ** 2, jnp.abs(x1) ** 2,
                          cross.real, cross.imag], axis=-1)

    def _dedisperse_detect(self, x, chirp):
        """Halo-extend a complex (T, C, P) shard, FFT·chirp·IFFT, trim
        the pads, detect."""
        T = x.shape[0]
        w = halo_exchange(x, self.pad_start, self.pad_end, "time")
        y = jnp.fft.ifft(jnp.fft.fft(w, axis=0) * chirp, axis=0)
        y = jax.lax.dynamic_slice_in_dim(y, self.pad_start, T, axis=0)
        return self._detect(y)

    def _fold(self, power, foldv):
        """Fold a detected shard and reduce over the time axis."""
        T = power.shape[0]
        shard = jax.lax.axis_index("time")
        fold3 = self._shard_fold3(foldv, shard, T)
        bins = fold_bins(fold3, jnp.arange(T, dtype=jnp.int32),
                         self.n_phase)
        prof, cnt = fold_accumulate(power, bins, self.n_phase)
        return jax.lax.psum(prof, "time"), jax.lax.psum(cnt, "time")

    def _local_step(self, xf, chirp, foldv):
        """Per-shard computation.

        xf : (T_local, C_local, P, 2) float32 — complex as trailing pairs
        chirp : (n_fft, C_local, 1) complex64
        foldv : (3,) int32 [i0_fx, p_fx, 0] — fixed-point fold vector
            at the block's first valid sample (built on device by
            :meth:`_foldv_device`).
        """
        x = jax.lax.complex(xf[..., 0], xf[..., 1])
        return self._fold(self._dedisperse_detect(x, chirp), foldv)

    def _local_step_packed(self, bits, wr, wi, chirp, scale, foldv):
        """Per-shard computation from packed words.

        wr, wi : (T_local*bits/32, C_local, P) uint32 — the real and
            imaginary components, ``32/bits`` time-consecutive samples
            per word (ops/unpack_device.pack_time_words), decoded here
            inside the step.
        scale : scalar multiplier applied to the decoded samples.
        """
        s = scale * _PACKED_NORM[bits]
        x = jax.lax.complex(unpack_time_words(wr, bits) * s,
                            unpack_time_words(wi, bits) * s)
        return self._fold(self._dedisperse_detect(x, chirp), foldv)

    def _out_specs(self):
        return (P(None, "chan"), P())

    def _chirp_arg(self):
        return jax.device_put(self._chirp_np,
                              NamedSharding(self.mesh, P(None, "chan")))

    def step_fn(self):
        """The jitted sharded step: (xf, offset_mod) -> (profile, counts).

        xf has global shape (time_shards * block_samples, n_chan, n_pol, 2)
        sharded P('time','chan'); output profile (n_phase, n_chan, n_pol)
        sharded P(None,'chan') and counts (n_phase,) replicated.
        ``offset_mod`` is a scalar sample offset (fixed-period mode) or a
        (4,) fold-halves vector from :meth:`FoldModel.foldv`.
        """
        if self._step_cache is not None:
            return self._step_cache
        sharded = jax.shard_map(
            self._local_step, mesh=self.mesh,
            in_specs=(P("time", "chan"), P(None, "chan"), P()),
            out_specs=self._out_specs())
        chirp = self._chirp_arg()
        jstep = jax.jit(
            lambda xf, fold_in, c: sharded(xf, c,
                                           self._foldv_device(fold_in)))

        def step(xf, offset_mod):
            return jstep(xf, jnp.asarray(offset_mod), chirp)

        self._step_cache = step
        return step

    def _packed_sharded(self, bits):
        return jax.shard_map(
            functools.partial(self._local_step_packed, bits),
            mesh=self.mesh,
            in_specs=(P("time", "chan"), P("time", "chan"),
                      P(None, "chan"), P(), P()),
            out_specs=self._out_specs())

    def packed_step_fn(self, bits):
        """Jitted step from packed words: ``(wr, wi, offset_mod) ->
        (profile, counts)``.  ``wr``/``wi`` have global shape
        (global_block*bits/32, n_chan, n_pol) uint32, sharded
        P('time','chan'), holding ``32/bits`` time-consecutive samples
        per word (ops/unpack_device.pack_time_words); the decoded
        samples are scaled to order unity (``byte - 127.5`` over 64 for
        8 bits, ``nibble - 7.5`` over 4 for 4 bits, VDIF levels for 2
        bits, ±1 for 1 bit)."""
        self._check_bits(bits)
        sharded = self._packed_sharded(bits)
        chirp = self._chirp_arg()
        jstep = jax.jit(
            lambda wr, wi, fold_in, c: sharded(
                wr, wi, c, jnp.float32(1.0), self._foldv_device(fold_in)))

        def step(wr, wi, offset_mod):
            return jstep(wr, wi, jnp.asarray(offset_mod), chirp)

        return step

    @staticmethod
    def _check_bits(bits):
        # the valid block is a multiple of 128 samples (see __init__),
        # so every depth's 32/bits samples per word divide it
        if bits not in _PACKED_NORM:
            raise ValueError("ingest_bits must be None, 1, 2, 4 or 8")

    # -- precision folding with host-computed bins -----------------------
    def _local_step_bins(self, xf, chirp, bins_f):
        """Like :meth:`_local_step` but folding on externally supplied
        bins: ``bins_f`` — (T_local,) float32 phase-bin indices computed
        on the host at full two-double Phase precision (e.g. from a
        Polyco); int-cast on device."""
        x = jax.lax.complex(xf[..., 0], xf[..., 1])
        power = self._dedisperse_detect(x, chirp)
        bins = jnp.clip(bins_f.astype(jnp.int32), 0, self.n_phase - 1)
        prof, cnt = fold_accumulate(power, bins, self.n_phase)
        return jax.lax.psum(prof, "time"), jax.lax.psum(cnt, "time")

    def step_bins_fn(self):
        """Jitted step ``(xf, bins_f) -> (profile, counts)`` where
        ``bins_f`` are host-computed phase bins (see :meth:`phase_bins`)."""
        sharded = jax.shard_map(
            self._local_step_bins, mesh=self.mesh,
            in_specs=(P("time", "chan"), P(None, "chan"), P("time")),
            out_specs=self._out_specs())
        chirp = self._chirp_arg()
        jstep = jax.jit(sharded)

        def step(xf, bins_f):
            return jstep(xf, chirp, bins_f)

        return step

    def phase_bins(self, phase, start_time, offset=0):
        """Host-side phase-bin computation for one global block.

        ``phase``: callable Time -> Phase/Quantity (e.g. PolycoPhase);
        evaluated at the ``global_block`` sample times starting at stream
        ``offset``, binned at full two-double precision, returned as the
        float32 array :meth:`step_bins_fn` expects.
        """
        from ..integration import _phase_to_cycles
        from ..utils import units as u
        rate = self.chan_rate.to_value(u.Hz)
        idx = offset + np.arange(self.global_block)
        t = start_time + u.Quantity(idx / rate, u.s)
        hi, lo = _phase_to_cycles(phase(t))
        frac = (hi - np.floor(hi)) + lo
        frac = frac - np.floor(frac)
        bins = np.minimum((frac * self.n_phase).astype(np.int64),
                          self.n_phase - 1)
        return bins.astype(np.float32)

    def run_fn(self, n_iter, offset0=0, ingest_bits=None, unroll=4):
        """A jitted on-device loop of ``n_iter`` pipeline steps.

        ``unroll`` places that many pipeline steps inside each device
        loop iteration, which cuts the per-iteration loop overhead.

        The loop input is one block generated on device (counter PRNG
        keyed on ``seed``, outside the timed loop); each iteration scales
        it by ``1 + 1e-6·off`` (so no pass can be hoisted), advances the
        fold offset by one global block, and accumulates the profiles —
        one host dispatch runs ``n_iter`` full dedisperse→detect→fold
        steps with no host round trips.

        With a ``phase_model`` configured, the host pre-evaluates the
        polyco once per block into an (n_iter, 4) fold-parameter table
        (models/foldmodel.py) that rides into the loop as one array —
        the pipeline then folds a *drifting* pulsar with no extra device
        work per sample (reference integration.py:380-395 semantics).

        With ``ingest_bits`` (1, 2, 4 or 8) the loop input is *packed*
        random words resident in device memory (see
        :meth:`packed_step_fn`), and every iteration decodes them inside
        the step: the decode's cost is inside the timed loop.  Reference
        analogue: the decode layer under ``Base.read``
        (base.py:389-438).

        Returns ``run(seed) -> (profile_sum, count_sum)``;
        ``run.inputs(seed)`` gives the device input block(s) the loop
        reads for that seed (float pairs, or the ``(wr, wi)`` words).
        """
        T = self.global_block
        per_q = float(self._per_q)
        if ingest_bits is not None:
            self._check_bits(ingest_bits)
        if self.fold_model is not None:
            fold_table = jnp.asarray(self.fold_model.table(
                offset0 + np.arange(n_iter) * T, T))
        else:
            fold_table = None
        chirp = self._chirp_arg()
        in_sharding = NamedSharding(self.mesh, P("time", "chan"))
        if ingest_bits:
            sharded = self._packed_sharded(ingest_bits)
            shape = (T * ingest_bits // 32, self.n_chan, self.n_pol)
            n_in = 2
        else:
            sharded = jax.shard_map(
                self._local_step, mesh=self.mesh,
                in_specs=(P("time", "chan"), P(None, "chan"), P()),
                out_specs=self._out_specs())
            shape = (T, self.n_chan, self.n_pol, 2)
            n_in = 1

        @functools.partial(jax.jit, out_shardings=(in_sharding,) * n_in)
        def jgen(seed):
            key = jax.random.key(seed.astype(jnp.int32))
            if ingest_bits:
                return tuple(jax.random.bits(jax.random.fold_in(key, i),
                                             shape, jnp.uint32)
                             for i in (0, 1))
            return (jax.random.normal(key, shape, jnp.float32),)

        def run_inner(*args):
            bases, c = args[:n_in], args[n_in]

            def body(k, carry):
                off, acc, cnt_acc = carry
                if fold_table is not None:
                    foldv = self._foldv_from_halves(jax.lax.dynamic_slice(
                        fold_table, (k, 0), (1, 4))[0])
                else:
                    foldv = self._fixed_foldv(off)
                scale = 1.0 + 1e-6 * off
                if ingest_bits:
                    prof, cnt = sharded(bases[0], bases[1], c, scale,
                                        foldv)
                else:
                    prof, cnt = sharded(bases[0] * scale, c, foldv)
                off = jnp.mod(off + T, per_q)
                return off, acc + prof, cnt_acc + cnt
            # the fixed-period offset carry starts at offset0 (mod the
            # exact period denominator), so tiled runs fold coherently
            init = (jnp.float32(float(offset0) % per_q),
                    jnp.zeros((self.n_phase, self.n_chan,
                               4 if self.detect == "stokes"
                               else self.n_pol),
                              jnp.float32),
                    jnp.zeros((self.n_phase,), jnp.float32))
            _, acc, cnt_acc = jax.lax.fori_loop(
                0, n_iter, body, init,
                unroll=min(int(unroll), int(n_iter)) or 1)
            return acc, cnt_acc

        jrun = jax.jit(run_inner)
        base_cache = {}

        def inputs(seed=0):
            s = float(seed)
            if s not in base_cache:
                base_cache[s] = jgen(jnp.float32(s))
            return base_cache[s]

        def run(seed=0):
            return jrun(*inputs(seed), chirp)

        run.inputs = inputs
        return run

    # -- conveniences ----------------------------------------------------
    @property
    def global_block(self):
        """Samples consumed per step across the whole mesh."""
        return self.block_samples * self.n_time_shards

    def example_inputs(self, seed=0):
        """Small random inputs with the right shapes/shardings."""
        rng = np.random.default_rng(seed)
        T = self.global_block
        xf = rng.standard_normal(
            (T, self.n_chan, self.n_pol, 2)).astype(np.float32)
        xf = jax.device_put(
            xf, NamedSharding(self.mesh, P("time", "chan")))
        return xf, jnp.float32(0)
