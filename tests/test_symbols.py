"""Symbol demodulator tests against a direct sample-walk oracle."""

import numpy as np
import jax.numpy as jnp

from isee3_decoder_tpu.ops import symbols as sym


def oracle_trial_demod(samples, firstsample, symbolsamples, nsymbols, symbolclocks, gain):
    """Sample-by-sample walk of trial_demod (symdemod.c:202-256)."""
    halfclock = (0.5 / symbolclocks) * symbolsamples
    ind = firstsample
    scount = ind + halfclock
    scount_int = int(np.rint(scount))
    out = []
    integrators = []
    energy = 0.0
    for i in range(nsymbols):
        integ = 0
        for j in range(symbolclocks):
            while ind < scount_int:
                integ -= samples[ind]
                ind += 1
            scount += halfclock
            scount_int = int(np.rint(scount))
            while ind < scount_int:
                integ += samples[ind]
                ind += 1
            scount += halfclock
            scount_int = int(np.rint(scount))
        integrators.append(integ)
        if gain != 0:
            scaled = gain * integ + 128
            scaled = min(max(scaled, 0), 255)
            out.append(int(scaled))
        energy += float(integ) * integ
    return np.array(integrators), np.array(out, np.uint8), energy / nsymbols


def manchester_signal(rng, nsymbols, symbolsamples, amp=1000, clocks=1):
    bits = rng.integers(0, 2, nsymbols)
    n = int(np.ceil((nsymbols + 4) * symbolsamples)) + 64
    x = np.zeros(n, np.int16)
    half = symbolsamples / (2 * clocks)
    for i, b in enumerate(bits):
        lvl = amp if b else -amp
        for c in range(clocks):
            s0 = int(np.rint(i * symbolsamples + 2 * c * half))
            s1 = int(np.rint(i * symbolsamples + (2 * c + 1) * half))
            s2 = int(np.rint(i * symbolsamples + (2 * c + 2) * half))
            x[s0:s1] = -lvl
            x[s1:s2] = lvl
    return bits, x


def test_integrate_matches_oracle():
    rng = np.random.default_rng(0)
    symbolsamples = 244.089  # 250000 / 1024.3-ish, fractional
    nsymbols = 40
    clocks = 1
    n = int((nsymbols + 2) * symbolsamples) + 200
    samples = rng.integers(-3000, 3000, n).astype(np.int16)
    firstsample = 37
    half = (0.5 / clocks) * symbolsamples
    res = sym.integrate_symbols(
        jnp.asarray(samples), firstsample, half, nsymbols, clocks, gain=0.013
    )
    want_int, want_soft, want_energy = oracle_trial_demod(
        samples.astype(np.int64), firstsample, symbolsamples, nsymbols, clocks, 0.013
    )
    np.testing.assert_array_equal(np.asarray(res.integrators)[0], want_int)
    np.testing.assert_array_equal(np.asarray(res.soft)[0], want_soft)
    assert abs(float(res.energy[0]) - want_energy) < 1e-6


def test_integrate_subcarrier_mode():
    """Symbolclocks > 1 (low-speed 1024 Hz subcarrier modes, CHANGES:35)."""
    rng = np.random.default_rng(1)
    symbolsamples = 1953.125  # 250000/128: 8 clocks per symbol at 64 bps
    nsymbols = 6
    clocks = 8
    n = int((nsymbols + 2) * symbolsamples) + 100
    samples = rng.integers(-2000, 2000, n).astype(np.int16)
    half = (0.5 / clocks) * symbolsamples
    res = sym.integrate_symbols(jnp.asarray(samples), 11, half, nsymbols, clocks, 0.0)
    want_int, _, want_energy = oracle_trial_demod(
        samples.astype(np.int64), 11, symbolsamples, nsymbols, clocks, 0
    )
    np.testing.assert_array_equal(np.asarray(res.integrators)[0], want_int)


def test_timesearch_finds_phase():
    rng = np.random.default_rng(2)
    symbolsamples = 244.140625  # 250000/1024
    nsymbols = 64
    bits, clean = manchester_signal(rng, nsymbols + 8, symbolsamples)
    noisy = (clean + rng.normal(0, 200, clean.shape)).astype(np.int16)

    true_shift = 77
    shifted = np.concatenate([np.zeros(true_shift, np.int16), noisy])
    half = 0.5 * symbolsamples
    noff = 2 * int(symbolsamples / 2) + 1
    firstsample = int(symbolsamples / 2) + true_shift + 30  # misaligned start
    res = sym.timesearch(
        jnp.asarray(shifted), firstsample, half, nsymbols, 1, noff
    )
    # Best offset should realign us to a symbol boundary: (firstsample +
    # symphase - true_shift) mod symbolsamples ≈ 0
    resid = (firstsample + int(res.symphase[0]) - true_shift) % symbolsamples
    resid = min(resid, symbolsamples - resid)
    assert resid < 3, (int(res.symphase[0]), resid)

    # And demodulating at that phase recovers the Manchester bits
    start = firstsample + int(res.symphase[0])
    out = sym.integrate_symbols(jnp.asarray(shifted), start, half, nsymbols, 1, 0.0)
    integ = np.asarray(out.integrators)[0]
    first_bit = int(np.rint((start - true_shift) / symbolsamples))
    got_bits = (integ > 0).astype(int)
    np.testing.assert_array_equal(
        got_bits, bits[first_bit : first_bit + nsymbols]
    )


def test_timesearch_matches_bruteforce_energy():
    """Energies per offset must equal direct per-offset integration."""
    rng = np.random.default_rng(3)
    symbolsamples = 52.7
    nsymbols = 20
    n = int((nsymbols + 4) * symbolsamples) + 120
    samples = rng.integers(-500, 500, n).astype(np.int16)
    half = 0.5 * symbolsamples
    noff = 2 * int(symbolsamples / 2) + 1
    firstsample = 60
    res = sym.timesearch(jnp.asarray(samples), firstsample, half, nsymbols, 1, noff)

    # Oracle mirrors the C timesearch: switchpoints are rounded *relative*
    # positions (scount starts at halfclock with no firstsample term,
    # symdemod.c:269-283), then shifted by firstsample + offset.
    def relative_energy(off):
        scount = half
        sp = []
        for _ in range(2 * nsymbols):
            sp.append(int(np.rint(scount)))
            scount += half
        s = samples.astype(np.int64)
        energy = 0.0
        ind = firstsample + off
        for i in range(nsymbols):
            integ = 0
            for j, sign in ((2 * i, -1), (2 * i + 1, +1)):
                stop = sp[j] + firstsample + off
                while ind < stop:
                    integ += sign * s[ind]
                    ind += 1
            energy += float(integ) * integ
        return energy / nsymbols

    best_e = -1.0
    best_o = None
    for off in range(-(noff // 2), noff - noff // 2):
        e = relative_energy(off)
        if e > best_e:
            best_e, best_o = e, off
    assert int(res.symphase[0]) == best_o
    assert abs(float(res.maxenergy[0]) - best_e) < 1e-6


def test_integrate_edges_exact_at_large_firstsample():
    """Segment edges are nearbyint(firstsample + rel) evaluated exactly:
    deep into a capture (firstsample ~ 2e7, where float32 spacing is 2.0)
    the integrators must still match the float64 oracle, even with x64
    disabled (the production mode)."""
    import jax

    rng = np.random.default_rng(0)
    nsymbols, symbolclocks = 8, 1
    halfclock = 122.0650634765625  # non-trivial fraction + exact ties
    first = 20_000_037
    need = first + int(halfclock * 2 * symbolclocks * nsymbols) + 4
    samples = rng.integers(-30, 30, need, dtype=np.int32)
    csum_np = np.concatenate([[0], np.cumsum(samples, dtype=np.int64)])

    # float64 oracle (C's trial_demod absolute rounding, symdemod.c:217)
    rel = sym.trial_edges(halfclock, nsymbols, symbolclocks)
    edges = np.round(first + rel).astype(np.int64)
    g = csum_np[edges]
    seg = (g[1:] - g[:-1]).reshape(nsymbols, symbolclocks, 2)
    want = (seg[..., 1] - seg[..., 0]).sum(axis=-1)

    with jax.enable_x64(False):
        csum = jnp.asarray(csum_np.astype(np.int32))[None, :]
        got = np.asarray(
            sym.integrate_from_csum(
                csum, first, halfclock, nsymbols, symbolclocks
            )
        )[0]
    np.testing.assert_array_equal(got, want)


def test_timesearch_dispersed_channels_match_gather():
    """Channels whose firstsample spread exceeds TRACK_DELTA fall off the
    channel-shared base-slice tier onto the per-channel-base grouped tier
    (ops/symbols._timesearch_grouped).  That tier must pick identical
    symphases to the elementwise-gather formulation — it reads the same
    csum entries through per-channel dynamic slices."""
    rng = np.random.default_rng(7)
    B = 8
    sc = sym.SymConfig(samprate=250_000.0, symrate=1024.545058, window=0.05)
    nsym, noff, hc, c = sc.nsymbols, sc.noffsets, sc.halfclock, sc.symbolclocks
    span = sym.timesearch_csum_span(hc, nsym, c, noff)
    L = span + 4000
    x = rng.integers(-3000, 3000, (B, L), dtype=np.int16)
    csum = sym.prefix_sum(jnp.asarray(x))
    # spread 0..2000 >> TRACK_DELTA=384: shared tier's ok-guard is False
    firsts = jnp.asarray(rng.integers(noff // 2 + 1, 2000, B), jnp.int32)
    got = sym.timesearch_from_csum(csum, firsts, hc, nsym, c, noff)

    rel = sym.search_edges(hc, nsym, c)
    es = sym._esum_gather(csum, firsts, rel, nsym, c, noff) / nsym
    best = sym.argmax_first(es, axis=-1)
    want_phase = np.arange(-(noff // 2), noff - noff // 2)[np.asarray(best)]
    np.testing.assert_array_equal(np.asarray(got.symphase), want_phase)
    want_e = np.asarray(jnp.take_along_axis(es, best[:, None], -1)[:, 0])
    np.testing.assert_allclose(np.asarray(got.maxenergy), want_e, rtol=1e-5)


def test_integrate_edges_bitexact_vs_numpy_oracle():
    """integrate_from_csum's exact-integer edge rounding must match an
    independent int64 numpy walk for every firstsample parity, including
    odd starts where nearbyint half-to-even ties round differently."""
    rng = np.random.default_rng(3)
    B = 6
    sc = sym.SymConfig(samprate=250_000.0, symrate=1024.545058, window=0.03)
    nsym, hc, c = sc.nsymbols, sc.halfclock, sc.symbolclocks
    L = int(np.ceil(2 * c * nsym * hc)) + 6000
    x = rng.integers(-2000, 2000, (B, L), dtype=np.int16)
    csum = sym.prefix_sum(jnp.asarray(x))
    firsts = np.array([0, 1, 17, 1024, 2047, 2500], np.int32)
    got = np.asarray(
        sym.integrate_from_csum(csum, jnp.asarray(firsts), hc, nsym, c)
    )

    # oracle: exact integer edges + int64 walk
    rel = sym.trial_edges(hc, nsym, c)
    csum_np = np.asarray(csum, np.int64)
    for b, f in enumerate(firsts):
        edges = np.round(f + rel).astype(np.int64)
        g = csum_np[b, edges]
        seg = (g[1:] - g[:-1]).reshape(nsym, c, 2)
        want = (seg[..., 1] - seg[..., 0]).sum(axis=-1)
        np.testing.assert_array_equal(got[b], want)


def test_tracked_channels_climb_independently():
    """Batched -t tracking must equal per-channel runs (VERDICT r3 weak #3).

    Two channels with deliberately divergent symbol clocks: a whole-batch
    accept test would deadlock both climbs; per-channel climbs converge
    each channel toward its own clock exactly like a lone reference run.
    """
    from isee3_decoder_tpu.models.symdemod import symdemod_tracked
    from isee3_decoder_tpu.ops.symbols import SymConfig

    rng = np.random.default_rng(7)
    samprate, window = 8000.0, 0.5
    cfg = SymConfig(samprate=samprate, symrate=100.0, window=window)
    # true clocks straddle the configured 80 samples/symbol (climb steps
    # are 0.5*s/(w*fs) = 0.01 samples, so keep the divergence reachable)
    _, x_a = manchester_signal(rng, 80, 79.9, amp=1200)
    _, x_b = manchester_signal(rng, 80, 80.1, amp=1200)
    n = min(x_a.size, x_b.size)
    batch = np.stack([x_a[:n], x_b[:n]])

    soft2, infos2 = symdemod_tracked(batch, cfg, 1)
    soft_a, infos_a = symdemod_tracked(batch[0:1], cfg, 1)
    soft_b, infos_b = symdemod_tracked(batch[1:2], cfg, 1)

    # independence: the batched run reproduces each lone run BITWISE —
    # the grid tables are built by the same sequential ``ss += incr``
    # accumulation the host/C tracker performs, so a monotone climb
    # lands on the identical float64 clock (build_track_tables).
    assert infos2[0]["symbolsamples"][0] == infos_a[0]["symbolsamples"][0]
    assert infos2[0]["symbolsamples"][1] == infos_b[0]["symbolsamples"][0]
    assert infos2[0]["firstsample"][0] == infos_a[0]["firstsample"][0]
    assert infos2[0]["firstsample"][1] == infos_b[0]["firstsample"][0]
    la, lb = soft_a.shape[1], soft_b.shape[1]
    np.testing.assert_array_equal(soft2[0, :la], soft_a[0])
    np.testing.assert_array_equal(soft2[1, :lb], soft_b[0])

    # channel B climbs its clock upward; channel A (which does not profit
    # from that direction and under the old whole-batch accept test would
    # have vetoed every one of B's steps) stays put — the climbs diverge
    sa = infos2[0]["symbolsamples"][0]
    sb = infos2[0]["symbolsamples"][1]
    assert sb > 80.0 >= sa
