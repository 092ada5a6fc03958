"""RFI flagger ("FluctuFlagger"): dynamic-threshold flagging.

Reference: visibility/sdp_flagger.{h,cpp} (CPU only). Per (baseline, pol),
three methods over ``vis[time, baseline, chan, pol]``:

1. magnitude outliers: modified z-score
   ``0.6795 * (val - median) / mad`` of |vis| against the channel-sampled
   median/MAD per time step (sdp_flagger.cpp:171-247);
2. fluctuation outliers: z-scores of a recursive EWMA "transit score" of
   |d|vis|/dt|, flagging both t and t-1 (:251-341);
3. broadband: z-score of the current median against a trailing window of
   median history flags the entire time step (:190-212).

Flags are dilated by ``window`` channels either side (dilation never
reaches channel 0 — the reference's `c - w - 1 > 0` bound is replicated).

Deliberately replicated quirks (bit-parity with the reference):
- the "median" picks sorted[round(n/2)] — one above the true median for
  odd n (median_calc, :83-88);
- the fluctuation MAD is computed around the *magnitude* median, not the
  fluctuation median (:292-295);
- transit scores start fresh at t == 1 (:266-269).

Design: everything is one jit — vmap over (baseline, pol), sorts for
the medians, one `lax.scan` over time for the EWMA, windowed shifts for
the dilation. No data-dependent host loop.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..utility.errors import SdpDataTypeError, SdpShapeError

Array = jax.Array

_ZSCORE_SCALE = 0.6795
_MAD_ZERO_SENTINEL = 10000000.0


def _c_mid(n):
    """int(round(0.5 * n)) with C round-half-away semantics."""
    return (n + 1) // 2 if n % 2 else n // 2


def _modified_zscore(median, mad, val):
    plain = _ZSCORE_SCALE * (val - median) / jnp.where(mad == 0, 1.0, mad)
    sentinel = jnp.where(val == median, 0.0, _MAD_ZERO_SENTINEL)
    return jnp.where(mad == 0, sentinel, plain)


def _median_and_mad(values, mid):
    """Reference median/MAD: sorted[mid] and sorted(|x - med|)[mid]."""
    s = jnp.sort(values, axis=-1)
    median = s[..., mid]
    devs = jnp.sort(jnp.abs(values - median[..., None]), axis=-1)
    return median, devs[..., mid]


def _dilate(trigger: Array, window: int) -> Array:
    """Flag channels within `window` of a trigger; channel 0 only triggers
    itself (the reference's `c - w - 1 > 0` / `c + w + 1 < C` bounds)."""
    if window <= 0:
        return trigger
    out = trigger
    for d in range(1, window + 1):
        left = jnp.concatenate(
            [trigger[..., d:],
             jnp.zeros(trigger.shape[:-1] + (d,), trigger.dtype)], axis=-1)
        right = jnp.concatenate(
            [jnp.zeros(trigger.shape[:-1] + (d,), trigger.dtype),
             trigger[..., :-d]], axis=-1)
        out = out | left | right
    # dilation never writes channel 0
    return out.at[..., 0].set(trigger[..., 0])


@partial(jax.jit, static_argnames=(
    "sampling_step", "window", "window_median_history"))
def _flag_one(mags: Array, alpha, threshold_magnitudes,
              threshold_variations, threshold_broadband,
              sampling_step: int, window: int,
              window_median_history: int) -> Array:
    """Flag one (baseline, pol) plane; mags is |vis| [T, C] float."""
    num_t, num_c = mags.shape
    num_samples = num_c // sampling_step
    mid = _c_mid(num_samples)
    samples = mags[:, ::sampling_step][:, :num_samples]

    # Method 1: magnitude z-scores per time step.
    median, mad = _median_and_mad(samples, mid)           # [T]
    z_mags = _modified_zscore(median[:, None], mad[:, None], mags)
    trig_mag = jnp.abs(z_mags) > threshold_magnitudes

    # Method 3: broadband via trailing median history.
    hist_len = window_median_history
    t_idx = jnp.arange(num_t)
    offs = jnp.arange(hist_len)
    src = t_idx[:, None] - offs[None, :]
    valid = src >= 0
    medwindow = jnp.minimum(t_idx + 1, hist_len)          # [T]
    inf = jnp.asarray(jnp.inf, mags.dtype)
    hist = jnp.where(valid, median[jnp.maximum(src, 0)], inf)
    hist_sorted = jnp.sort(hist, axis=-1)
    mid_w = jnp.where(medwindow % 2 == 1, (medwindow + 1) // 2,
                      medwindow // 2)
    mid_w = jnp.minimum(mid_w, hist_len - 1)  # t=0 OOB in C; unused here
    medmed = jnp.take_along_axis(hist_sorted, mid_w[:, None], axis=1)[:, 0]
    devs = jnp.sort(jnp.abs(hist - medmed[:, None]), axis=-1)
    medmeddev = jnp.take_along_axis(devs, mid_w[:, None], axis=1)[:, 0]
    z_med = _modified_zscore(medmed, medmeddev, median)
    situation = (jnp.abs(z_med) > threshold_broadband) & (t_idx != 0)

    flags = _dilate(trig_mag | situation[:, None], window)

    # Method 2: fluctuation (EWMA transit score) z-scores.
    rate = jnp.abs(mags[1:] - mags[:-1])                  # [T-1, C]

    def ewma(carry, xs):
        r, is_first = xs
        ts = jnp.where(is_first, r, alpha * r + (1.0 - alpha) * carry)
        return ts, ts

    is_first = jnp.zeros((max(num_t - 1, 1),), bool).at[0].set(True)
    if num_t > 1:
        _, ts = jax.lax.scan(ewma, jnp.zeros((num_c,), mags.dtype),
                             (rate, is_first))            # [T-1, C]
        ts_samples = ts[:, ::sampling_step][:, :num_samples]
        s = jnp.sort(ts_samples, axis=-1)
        medianvar = s[:, mid]
        # NB: deviations around the *magnitude* median (reference :292-295).
        devs_var = jnp.sort(jnp.abs(ts_samples - median[1:, None]), axis=-1)
        mediandevvar = devs_var[:, mid]
        z_var = _modified_zscore(medianvar[:, None], mediandevvar[:, None],
                                 ts)
        trig_var = _dilate(jnp.abs(z_var) > threshold_variations, window)
        pad = jnp.zeros((1, num_c), bool)
        flags = flags | jnp.concatenate([pad, trig_var])      # at t
        flags = flags | jnp.concatenate([trig_var, pad])      # at t - 1
    return flags


def flagger_dynamic_threshold(vis: Array, alpha: float = 0.5,
                              threshold_magnitudes: float = 3.5,
                              threshold_variations: float = 3.5,
                              threshold_broadband: float = 3.5,
                              sampling_step: int = 1, window: int = 0,
                              window_median_history: int = 10) -> Array:
    """Run the FluctuFlagger; returns int32 flags (1 = RFI) shaped like vis.

    Equivalent of `sdp_flagger_dynamic_threshold` (sdp_flagger.h:53-64)
    with the flags returned instead of written into a preallocated array.
    """
    vis = jnp.asarray(vis)
    if vis.ndim != 4:
        raise SdpShapeError(
            "vis must be 4D [time, baseline, chan, pol]")
    if not jnp.issubdtype(vis.dtype, jnp.complexfloating):
        raise SdpDataTypeError("vis must be complex")
    mags = jnp.abs(vis)
    fdtype = mags.dtype
    # [T, B, C, P] -> [B, P, T, C] for the per-plane kernel.
    planes = jnp.transpose(mags, (1, 3, 0, 2))
    flag_fn = lambda m: _flag_one(  # noqa: E731
        m, jnp.asarray(alpha, fdtype),
        jnp.asarray(threshold_magnitudes, fdtype),
        jnp.asarray(threshold_variations, fdtype),
        jnp.asarray(threshold_broadband, fdtype),
        int(sampling_step), int(window), int(window_median_history))
    flags = jax.vmap(jax.vmap(flag_fn))(planes)           # [B, P, T, C]
    return jnp.transpose(flags, (2, 0, 3, 1)).astype(jnp.int32)
