"""Device→host result fetching.

Every device→host copy pays a round trip of latency.  Two strategies:

  * ``fetch_all``/``fetch_async`` — start non-blocking copies for every
    output (the transfers overlap each other).
  * ``flatten_result`` — bit-pack every per-snarl output into ONE uint32
    wire array inside jit (f64 statistics bitcast to word pairs, counts
    as packed u16 halfwords, booleans as bitfields) and copy that:
    one round trip and fewer bytes than a naive f64 concat.
    ``FlatResult`` re-exposes the dict interface on host via numpy
    decodes; the f64 bitcast is exact, so the formatted output strings
    are identical to the per-array path (pinned by the runner tests).
    This is what the pipelined runner ships per chunk.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["fetch_all", "fetch_async", "flatten_result", "FlatResult"]


def fetch_async(out: Dict[str, object]) -> Dict[str, object]:
    """Start non-blocking host copies for every output and return the
    dict of device arrays as-is."""
    for value in out.values():
        copy_async = getattr(value, "copy_to_host_async", None)
        if copy_async is not None:
            copy_async()
    return out


def fetch_all(out: Dict[str, object]) -> Dict[str, np.ndarray]:
    return {key: np.asarray(value)
            for key, value in fetch_async(out).items()}


# Wire kinds: how each result key is encoded into uint32 words.
#   f64  — bitcast to 2 words (exact; needed for p-value string parity)
#   u16  — integer counts < 65536 packed two per word
#   u32  — integer counts (wide-cohort variant of u16)
#   bool — bitfields, 32 flags per word
_KIND_F64 = ("p_fisher", "p_chi2", "p", "beta", "se", "r2",
             "q_p", "q_beta", "q_se", "q_r2")
_KIND_INT = ("g0", "g1", "allele_paths", "k", "q_allele_paths")
_KIND_BOOL = ("filtered", "keep", "chi2_invalid", "chi2_zexp",
              "q_filtered")
# host-side dtypes the writers expect back
_INT_DTYPES = {"g0": np.float64, "g1": np.float64,
               "allele_paths": np.int32, "k": np.int64,
               "q_allele_paths": np.int32}
# keys never wire-packed (per-sample-sized -T table outputs)
_EXCLUDE = ("norm", "used", "kept")

_pack_cache: Dict[Tuple, object] = {}


def _build_packer(layout_key):
    """Jitted wire packer for one (key, kind, k) layout.

    Returns (u32 wire array, f64 stats array): counts and flags ride in
    the u32 wire, the float statistics in their own f64 concat, so a
    chunk costs two host copies instead of seven-plus."""
    import jax
    import jax.numpy as jnp

    layout = layout_key[0]
    wide = layout_key[1]

    @jax.jit
    def _pack(cols):
        parts = []
        fparts = []
        for (key, kind, k), a in zip(layout, cols):
            if kind == "f64":
                fparts.append(a.astype(jnp.float64)[:, None])
            elif kind == "int" and not wide:
                a2 = a if a.ndim == 2 else a[:, None]
                a2 = a2.astype(jnp.uint32) & jnp.uint32(0xFFFF)
                if a2.shape[1] % 2:
                    a2 = jnp.pad(a2, ((0, 0), (0, 1)))
                parts.append(a2[:, 0::2] | (a2[:, 1::2] << jnp.uint32(16)))
            elif kind == "int":
                a2 = a if a.ndim == 2 else a[:, None]
                parts.append(a2.astype(jnp.uint32))
            else:  # bool bitfield
                a2 = a if a.ndim == 2 else a[:, None]
                kk = a2.shape[1]
                W = (kk + 31) // 32
                a3 = jnp.pad(a2.astype(jnp.uint32),
                             ((0, 0), (0, W * 32 - kk)))
                a3 = a3.reshape(a2.shape[0], W, 32)
                shifts = jnp.arange(32, dtype=jnp.uint32)
                # bits occupy distinct positions: sum == bitwise-or
                parts.append(jnp.sum(a3 << shifts[None, None, :],
                                     axis=-1, dtype=jnp.uint32))
        wire = (jnp.concatenate(parts, axis=1) if parts else None)
        stats = (jnp.concatenate(fparts, axis=1) if fparts else None)
        return wire, stats

    return _pack


def _n_words(kind: str, k: int, wide: bool) -> int:
    if kind == "f64":
        return 0                     # rides in the f64 stats array
    if kind == "int":
        return k if wide else (k + 1) // 2
    return (k + 31) // 32


class FlatResult:
    """Dict-like view over one wire-packed [S, words] uint32 array.

    The single device array materializes on first access (one round
    trip); per-key reads decode numpy slices.  Keys excluded from the
    pack (e.g. -T table outputs) are kept as device arrays and fetched
    on demand."""

    def __init__(self, packed, layout, wide, extra=None, stats=None):
        self._packed = packed        # u32 wire array (device)
        self._stats = stats          # f64 stats array (device)
        self._layout = layout        # [(key, kind, k), ...]
        self._wide = wide
        self._extra = extra or {}
        self._np = None
        self._stats_np = None
        self._cache: Dict[str, np.ndarray] = {}

    def keys(self):
        return [k for k, _, _ in self._layout] + list(self._extra.keys())

    def __contains__(self, key):
        return key in self._extra or any(k == key
                                         for k, _, _ in self._layout)

    def __getitem__(self, key):
        got = self._cache.get(key)
        if got is not None:
            return got
        if key in self._extra:
            arr = np.asarray(self._extra[key])
            self._cache[key] = arr
            return arr
        lo = 0          # u32 word offset
        flo = 0         # f64 stats column offset
        for k, kind, kk in self._layout:
            w = _n_words(kind, kk, self._wide)
            if k == key:
                break
            lo += w
            flo += 1 if kind == "f64" else 0
        else:
            raise KeyError(key)
        if kind == "f64":
            if self._stats_np is None:
                self._stats_np = np.asarray(self._stats)
            arr = self._stats_np[:, flo]
            self._cache[key] = arr
            return arr
        if self._np is None:
            self._np = np.asarray(self._packed)
        words = self._np[:, lo:lo + w]
        if kind == "int":
            if self._wide:
                dec = words.astype(np.int64)
            else:
                halves = np.empty((words.shape[0], w * 2), np.int64)
                halves[:, 0::2] = words & 0xFFFF
                halves[:, 1::2] = words >> 16
                dec = halves
            dec = dec[:, :kk]
            dt = _INT_DTYPES.get(key, np.int64)
            arr = dec[:, 0].astype(dt) if kk == 1 else dec.astype(dt)
        else:
            bits = ((words[:, :, None] >> np.arange(32, dtype=np.uint32)
                     [None, None, :]) & 1).reshape(words.shape[0], -1)
            dec = bits[:, :kk] != 0
            arr = dec[:, 0] if kk == 1 else dec
        self._cache[key] = arr
        return arr


def flatten_result(out: Dict[str, object],
                   exclude=_EXCLUDE, wide: bool = False) -> "FlatResult":
    """Wire-pack a result dict into ONE uint32 device array (one jitted
    dispatch) and start its host copy.

    ``wide``: integer counts may reach 65536+ (cohorts over 32k samples)
    — encode them as full u32 words instead of packed u16 halfwords."""
    layout: List[Tuple[str, str, int]] = []
    cols = []
    extra = {}
    for key, value in out.items():
        shape = getattr(value, "shape", ())
        if key in exclude or len(shape) not in (1, 2):
            extra[key] = value
            continue
        k = 1 if len(shape) == 1 else int(shape[1])
        if key in _KIND_F64:
            kind = "f64"
            if len(shape) == 2:      # unexpected wide float: keep exact
                extra[key] = value
                continue
        elif key in _KIND_INT:
            kind = "int"
        elif key in _KIND_BOOL:
            kind = "bool"
        else:                        # unknown key: ship as exact f64 pair
            kind = "f64" if len(shape) == 1 else "int"
            if kind == "int":
                extra[key] = value
                continue
        layout.append((key, kind, k))
        cols.append(value)
    if not cols:
        return FlatResult(None, [], wide, extra)

    layout_key = (tuple(layout), wide)
    packer = _pack_cache.get(layout_key)
    if packer is None:
        packer = _build_packer(layout_key)
        _pack_cache[layout_key] = packer
    packed, stats = packer(cols)
    for arr in (packed, stats, *extra.values()):
        copy_async = getattr(arr, "copy_to_host_async", None)
        if copy_async is not None:
            copy_async()
    return FlatResult(packed, layout, wide, extra, stats=stats)
