"""Fused jitted composites for the demux pipeline.

The production path is ONE fused device call per batch:
:func:`demux_call` runs flank scan -> top-K valley compaction into fixed
hit lanes -> flank traceback -> strand-aware barcode-window mapping ->
barcode rank, and returns a single packed int32 buffer (one dispatch,
one fetch, no host bookkeeping between stages).  Every stage has a jnp
formulation in :mod:`barbell_tpu.ops.device`; on the GPU the flank
scan's interior runs the bit-parallel Myers kernel
(:mod:`barbell_tpu.ops.triton_myers`) and the all-patterns Lodhi
ranking runs :mod:`barbell_tpu.ops.triton_rank`, selected by a static
:class:`barbell_tpu.ops.kernels.Kernels` (identical semantics, tested).

The staged composites :func:`flank_trace` and :func:`barcode_rank`
remain as independently testable pieces and conformance anchors (with
``*_reference`` variants of the original move-table + traceback
implementations).

Row coordinate model: every row holds its text in columns
``[start_col, end_col]`` (forward rows left-aligned at 0; synthesized
rc rows right-aligned ending at L). End positions are column indices;
hosts convert with the per-row text-start column.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .device import (
    BIG,
    UNIT,
    best_valley_per_pattern,
    flank_ends,
    traceback_reduce,
    window_dp,
    window_dp_summary,
)
from .kernels import XLA, Kernels
from .triton_myers import TOPK as MYERS_TOPK
from .triton_myers import myers_topk
from .triton_rank import rank_pass1


def _complement_masks(m):
    """Nibble complement (A<->T, C<->G = bit reversal), elementwise."""
    m = m.astype(jnp.int32)
    c = ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3)
    return c.astype(jnp.uint8)


def unpack_rows(packed):
    """[R, L/2] nibble-packed -> [R, L] mask bytes."""
    lo = (packed & 0xF).astype(jnp.uint8)
    hi = (packed >> 4).astype(jnp.uint8)
    return jnp.stack([lo, hi], axis=2).reshape(packed.shape[0], -1)


def pack_rows_np(rows):
    """Host-side nibble packing (numpy).

    Masks to 4 bits first: invalid bytes encode to 255, which would
    otherwise clobber the neighbouring nibble (255 | x<<4 == 0xFF).
    A 255 mask degrades to 15 (N) — matching the oracle's "matches
    everything" semantics for unknown bytes."""
    r = rows & 0xF
    return (r[:, 0::2] | (r[:, 1::2] << 4)).astype(rows.dtype)


def _valley_keys(ends, lo, hi, k_scaled, L_key, csc=None, cec=None):
    """Key map (cost*L_key + col) over valley positions, BIG elsewhere.

    The plateau-valley test compares CONTENT neighbors (±inf only at
    the row's true text boundaries ``[csc, cec]``), then filters to the
    claim range ``[lo, hi]``: a cost plateau declining THROUGH a claim
    edge must not spawn a spurious edge valley — the full scan has a
    deeper valley there (outside this row's claims), and the Myers
    kernel, which compares real neighbors before range-filtering
    emission, reports none either (pinned by
    tests/test_ends.py::test_claim_boundary_exact).  ``csc``/``cec``
    default to the claim range (whole-text callers, where they
    coincide)."""
    B, N = ends.shape
    jpos = jnp.arange(N, dtype=jnp.int32)
    if csc is None:
        csc, cec = lo, hi
    in_c = (jpos[None, :] >= csc[:, None]) & (jpos[None, :] <= cec[:, None])
    e = jnp.where(in_c, ends, BIG)
    prv = jnp.concatenate([jnp.full((B, 1), BIG), e[:, :-1]], axis=1)
    nxt = jnp.concatenate([e[:, 1:], jnp.full((B, 1), BIG)], axis=1)
    claim = (jpos[None, :] >= lo[:, None]) & (jpos[None, :] <= hi[:, None])
    isv = claim & (e <= k_scaled) & (e < nxt) & (e <= prv)
    key = jnp.where(isv, e * L_key + jpos[None, :], BIG)
    return key, isv.sum(axis=1, dtype=jnp.int32)


def _slab_windows(rows, row_idx, starts, W: int):
    """windows[h] = rows[row_idx[h], starts[h] : starts[h]+W] via a
    SLICE gather of 128-column slabs plus a small local take.

    Instead of one flat per-element ``jnp.take`` over the row matrix,
    slab slices gather whole (1, nsub, 32) uint32 chunks and the
    remaining take_along_axis runs over a [H, nsub*32] uint32 operand
    with perfect locality — gathering the CONTAINING 4-byte word and
    extracting the byte in-register rather than taking single bytes.
    Out-of-range columns (including negative starts — the right
    boundary window can start at -1 for minimum-length reads) are
    clamped into the row; callers mask those positions, so clamp
    artifacts are never read."""
    R, L = rows.shape
    H = row_idx.shape[0]
    nsub = W // 128 + 2
    if L % 128 != 0 or L // 128 < nsub:
        jpos = jnp.arange(W, dtype=jnp.int32)
        cols = jnp.clip(starts[:, None] + jpos[None, :], 0, L - 1)
        flat = row_idx.astype(jnp.int32)[:, None] * L + cols
        return jnp.take(rows.reshape(-1), flat)
    # rows as little-endian u32 words: byte j of row r lives in word
    # j // 4 at bit 8 * (j % 4)
    rows32 = jax.lax.bitcast_convert_type(
        rows.reshape(R, L // 128, 32, 4), jnp.uint32
    )
    sub = jnp.minimum(
        jnp.clip(starts, 0, L - 1) // 128, jnp.int32(L // 128 - nsub)
    )
    slabs = jax.lax.gather(
        rows32,
        jnp.stack([row_idx.astype(jnp.int32), sub], axis=1),
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2),
            collapsed_slice_dims=(0,),
            start_index_map=(0, 1),
        ),
        slice_sizes=(1, nsub, 32),
        mode="clip",
    ).reshape(H, nsub * 32)
    off = starts - sub * 128
    cols = jnp.clip(
        off[:, None] + jnp.arange(W, dtype=jnp.int32)[None, :],
        0,
        nsub * 128 - 1,
    )
    words = jnp.take_along_axis(slabs, cols >> 2, axis=1)
    return (
        words >> ((cols & 3).astype(jnp.uint32) << 3)
    ).astype(jnp.uint8)


def _window_cols(rows, starts, W):
    """Per-row fixed-width slices (row h reads its own row)."""
    R = rows.shape[0]
    return _slab_windows(rows, jnp.arange(R, dtype=jnp.int32), starts, W)


def _assemble_rows(host_packed, simple_idx):
    """Unpack nibble-packed host rows and synthesize rc simple rows."""
    host_rows = unpack_rows(host_packed)
    rc_simple = _complement_masks(host_rows[simple_idx][:, ::-1])
    rows = jnp.concatenate([host_rows, rc_simple], axis=0)
    return jax.lax.optimization_barrier(rows)


def _assemble_rows2cat(
    flat_codes, row_start, exc, hlen, simple_idx, L,
    align: int = 128, twin_slice: int = -1,
):
    """Concatenated 2-bit variant: rows pack back to back in one flat
    byte buffer (no row padding in the upload — reads average ~56% of
    the padded row width); the device scatters each row's ceil(len/4)
    code bytes into the padded layout, then proceeds as _assemble_rows2.

    Row starts are ``align``-byte aligned by the host packer, so the
    gather runs over whole align-byte slabs instead of one element
    ``jnp.take`` per byte.  One (1, align) slab per index (row r's
    slabs are ``row_start[r]//align + [0, Q/align)``) keeps XLA on the
    vectorized row-gather path; a single (Q/align, align) slice per row
    lowers to a sequential while loop of dynamic-slices.  Small row
    widths (Q % align != 0, tests only) keep the element gather.

    ``twin_slice >= 0`` (meta_mode='desc') builds the rc twin block as
    a flip+complement of host rows ``[0, twin_slice)`` — a static
    SLICE, no ``simple_idx`` gather (the descriptor layout makes the
    twin map the identity)."""
    R0 = row_start.shape[0]
    Q = L // 4
    if Q % align == 0:
        flat2 = flat_codes.reshape(-1, align)
        slab_idx = (
            (row_start // align)[:, None]
            + jnp.arange(Q // align, dtype=jnp.int32)[None, :]
        ).reshape(-1)
        slab_idx = jnp.clip(slab_idx, 0, flat2.shape[0] - 1)
        b = (
            jnp.take(flat2, slab_idx, axis=0)
            .reshape(R0, Q)
            .astype(jnp.int32)
        )
    else:
        qpos = jnp.arange(Q, dtype=jnp.int32)
        idx = jnp.clip(
            row_start[:, None] + qpos[None, :], 0, flat_codes.shape[0] - 1
        )
        b = jnp.take(flat_codes, idx).astype(jnp.int32)
    codes = jnp.stack(
        [(b >> (2 * s)) & 3 for s in range(4)], axis=2
    ).reshape(R0, L)
    masks = (1 << codes).astype(jnp.uint8)
    jpos = jnp.arange(L, dtype=jnp.int32)
    masks = jnp.where(jpos[None, :] < hlen[:, None], masks, 0)
    flat = masks.reshape(-1)
    flat = flat.at[exc[:, 0]].set(exc[:, 1].astype(jnp.uint8), mode="drop")
    host_rows = flat.reshape(R0, L)
    if twin_slice >= 0:
        rc_simple = _complement_masks(host_rows[:twin_slice, ::-1])
    else:
        rc_simple = _complement_masks(host_rows[simple_idx][:, ::-1])
    rows = jnp.concatenate([host_rows, rc_simple], axis=0)
    return jax.lax.optimization_barrier(rows)


def _assemble_rows2(host_packed2, exc, hlen, simple_idx):
    """2-bit variant: codes unpack to single-base masks (1 << code),
    positions past each row's content zero out (code 0 would otherwise
    read as 'A'), and the exception list overrides N/IUPAC/junk bytes
    (entries are [E, 2] int32 (flat_pos, mask) pairs — pairs, not
    flat_pos*16|mask, so positions don't wrap int32 on big batches;
    out-of-range pos = padding, dropped).  Host->device bytes halve
    versus the nibble form."""
    R0, Q = host_packed2.shape
    L = Q * 4
    b = host_packed2.astype(jnp.int32)
    codes = jnp.stack(
        [(b >> (2 * s)) & 3 for s in range(4)], axis=2
    ).reshape(R0, L)
    masks = (1 << codes).astype(jnp.uint8)
    jpos = jnp.arange(L, dtype=jnp.int32)
    masks = jnp.where(jpos[None, :] < hlen[:, None], masks, 0)
    flat = masks.reshape(-1)
    flat = flat.at[exc[:, 0]].set(exc[:, 1].astype(jnp.uint8), mode="drop")
    host_rows = flat.reshape(R0, L)
    rc_simple = _complement_masks(host_rows[simple_idx][:, ::-1])
    rows = jnp.concatenate([host_rows, rc_simple], axis=0)
    return jax.lax.optimization_barrier(rows)


def _boundary_keys(
    pattern, rows, start_col, end_col, lo, hi, csc, cec, alpha_scaled,
    K: int, m: int, k_units: int, L_key: int,
):
    """Top-K valley keys + exact counts of the alpha-aware boundary
    windows that the unit-cost Myers kernel leaves out: the first
    ``m+k+1`` end positions after each read's true start and the last
    two before its true end.  Both windows of every row run as ONE
    [2R, m+k+3] jnp DP (:func:`device.flank_ends` over gathered window
    text, alpha at the window's true-start column and true-end column)
    and the same content-neighbour valley rule as the whole-row path, so
    keys are identical to :func:`_valley_keys` over the full row.  A
    window's DP is exact for every end cost <= k: a match within k
    spans at most m+k text bytes, which the window holds."""
    R, L = rows.shape
    Wb_ = m + k_units + 3
    mk1 = m + k_units + 1
    tsc = jnp.maximum(start_col, 0)
    text_len = end_col - tsc
    has_start = start_col >= 0
    lw = _window_cols(rows, tsc, Wb_)
    l_lo = jnp.maximum(lo - tsc, 0)
    l_hi = jnp.minimum(jnp.minimum(mk1, hi - tsc), text_len)
    l_hi = jnp.where(has_start, l_hi, -1)
    l_end = jnp.where(text_len <= Wb_, text_len, Wb_ + 2)

    r_active = (end_col <= L) & (text_len > mk1)
    r_start = jnp.where(r_active, end_col - Wb_, 0)
    rw = _window_cols(rows, r_start, Wb_)
    r_lo = jnp.where(r_active, Wb_ - 1, 1)
    # the right window never re-claims the left window's zone
    r_lo = jnp.maximum(r_lo, jnp.where(has_start, tsc + mk1 + 1 - r_start, 0))
    r_hi = jnp.where(r_active, Wb_, -1)

    ends = flank_ends(
        pattern,
        jnp.concatenate([lw, rw], axis=0),
        jnp.concatenate([jnp.where(has_start, 0, -1), jnp.full((R,), -1)]),
        jnp.concatenate([l_end, jnp.where(r_active, Wb_, Wb_ + 2)]),
        alpha_scaled,
    )
    zero = jnp.zeros((2 * R,), jnp.int32)
    key, count = _valley_keys(
        ends,
        jnp.concatenate([l_lo, r_lo]),
        jnp.concatenate([l_hi, r_hi]),
        k_units * UNIT,
        L_key,
        csc=jnp.maximum(zero, jnp.concatenate([csc - tsc, csc - r_start])),
        cec=jnp.concatenate(
            [jnp.minimum(cec - tsc, Wb_), jnp.minimum(cec - r_start, Wb_)]
        ),
    )
    neg, _ = jax.lax.top_k(-key, K)
    bkey = -neg
    # window-local column -> row column
    shift = jnp.concatenate([tsc, r_start])[:, None]
    bkey = jnp.where(bkey < BIG, bkey + shift, BIG)
    return bkey[:R], count[:R], bkey[R:], count[R:]


def _scan_keys(
    pattern,
    patw,
    rows,
    start_col,
    end_col,
    lo,
    hi,
    emit_lo,
    emit_hi,
    alpha_scaled,
    K: int,
    kernels: Kernels,
    m: int,
    k_units: int,
    W_words: int,
    top_bit: int,
    csc=None,  # content-column range for valley neighbor tests
    cec=None,  # (defaults to the claim range — whole-text callers)
):
    """Top-K flank valley keys (cost*L_key + col) + total count per row."""
    R, L = rows.shape
    L_key = L + 2
    k_scaled = k_units * UNIT
    if csc is None:
        csc, cec = lo, hi

    if not kernels.myers:
        ends = flank_ends(pattern, rows, start_col, end_col, alpha_scaled)
        key, count = _valley_keys(
            ends, lo, hi, k_scaled, L_key, csc=csc, cec=cec
        )
        neg, idx = jax.lax.top_k(-key, K)
        return -neg, count

    # Interior: unit-cost Myers with in-kernel top-K valley keys (an
    # [R, L] key map + lax.top_k is what the kernel replaces).  Rows
    # with > TOPK interior valleys overflow (count is made to exceed K
    # so the caller resolves them on the host).
    keys8, kcnt = myers_topk(
        patw, rows, emit_lo, emit_hi, W=W_words, top_bit=top_bit, m=m,
        k_units=k_units, klmul=UNIT * L_key, interpret=kernels.interpret,
    )
    kernel_count = jnp.where(kcnt > MYERS_TOPK, kcnt + K + 1, kcnt)
    lkey, lcount, rkey, rcount = _boundary_keys(
        pattern, rows, start_col, end_col, lo, hi, csc, cec, alpha_scaled,
        K=K, m=m, k_units=k_units, L_key=L_key,
    )
    merged = jnp.concatenate([-keys8, -lkey, -rkey], axis=1)
    neg, _ = jax.lax.top_k(merged, K)
    return -neg, kernel_count + lcount + rcount


# Column layout of the fused demux_call per-hit record.
REC_COLS = 14
(REC_ROW, REC_COL, REC_COST, REC_HAS, REC_BSTART, REC_FSTEXT, REC_TOP,
 REC_ACC, REC_IVPJ, REC_IVEJ, REC_IVPI, REC_IVEI, REC_IVCOST,
 REC_HASIV) = range(REC_COLS)

# Packed wire layout: 6 int32 lanes per hit instead of 14 (fewer
# device->host bytes per batch).  Bit layout (rec_wire_spec
# guards every width statically; wbits = (Wb + 2).bit_length()):
#   lane 0: row (17) | col << 17 (14)
#   lane 1: top (8) | has2 << 8 | accepted << 9 | flank_cost << 10 (21)
#   lane 2: bstart   (read coordinates, unpacked)
#   lane 3: fs_text  (read coordinates, unpacked)
#   lane 4: iv_pj | iv_ej << wbits | iv_pi << 2*wbits | has_iv << 3*wbits
#   lane 5: iv_ei | iv_cost << wbits (21)
REC_WIRE_COLS = 6


def rec_wire_spec(L, R_total, k_units, P, plen, Wb):
    """wbits of the packed 6-lane hit record, or None when any field
    could overflow its lane (then the unpacked 14-lane layout is used).
    demux_call (device pack) and the engine (host unpack) must compute
    this from the same static shapes."""
    wbits = int(Wb + 2).bit_length()
    ok = (
        R_total < 2**17
        and L + 2 < 2**14
        and k_units * UNIT < 2**21
        and 2 * P < 2**8
        and plen * UNIT < 2**21
        and 3 * wbits + 1 <= 31
        and wbits + 21 <= 31
    )
    return wbits if ok else None


def unpack_rec_np(flat, cap, wbits):
    """[cap * REC_WIRE_COLS] packed int32 -> [cap, REC_COLS] int32."""
    w = np.asarray(flat[: cap * REC_WIRE_COLS]).reshape(cap, REC_WIRE_COLS)
    u = w.astype(np.uint32)
    mask = np.uint32((1 << wbits) - 1)
    rec = np.empty((cap, REC_COLS), dtype=np.int32)
    rec[:, REC_ROW] = (u[:, 0] & np.uint32(0x1FFFF)).astype(np.int32)
    rec[:, REC_COL] = (u[:, 0] >> 17).astype(np.int32)
    rec[:, REC_TOP] = (u[:, 1] & np.uint32(0xFF)).astype(np.int32)
    rec[:, REC_HAS] = ((u[:, 1] >> 8) & 1).astype(np.int32)
    rec[:, REC_ACC] = ((u[:, 1] >> 9) & 1).astype(np.int32)
    rec[:, REC_COST] = (u[:, 1] >> 10).astype(np.int32)
    rec[:, REC_BSTART] = w[:, 2]
    rec[:, REC_FSTEXT] = w[:, 3]
    rec[:, REC_IVPJ] = (u[:, 4] & mask).astype(np.int32)
    rec[:, REC_IVEJ] = ((u[:, 4] >> wbits) & mask).astype(np.int32)
    rec[:, REC_IVPI] = ((u[:, 4] >> (2 * wbits)) & mask).astype(np.int32)
    rec[:, REC_HASIV] = ((u[:, 4] >> (3 * wbits)) & 1).astype(np.int32)
    rec[:, REC_IVEI] = (u[:, 5] & mask).astype(np.int32)
    rec[:, REC_IVCOST] = (u[:, 5] >> wbits).astype(np.int32)
    return rec

# Column layout of the per-row metadata matrix demux_call consumes.
# M_ENDS marks ends-only fast-path rows (SURVEY §5.7): the row holds one
# END WINDOW of a long read (prefix [0, W) or suffix [n-W, n)) and its
# barcode-window gather selects prefix vs suffix cover row by
# ``bstart >= n - ends_w`` instead of the chunk ``bstart // step`` rule.
META_COLS = 13
(M_TSC, M_TEC, M_TSTART, M_TEND, M_LO, M_HI, M_OFF, M_N, M_ISRC,
 M_FSIMPLE, M_BASEROW, M_NCHUNKS, M_ENDS) = range(META_COLS)

# Wire layout: the 12 logical columns ship as 6 int32 lanes (halves the
# per-batch metadata upload).  Bit budget:
# tsc/tec/lo/hi+1 are row coordinates <= MAX_ROW_LEN(8192) < 2**14,
# off/n/fsimple keep full 32 bits (chunk offsets / read lengths are
# unbounded), baserow < 2**16 rows, nchunks < 2**15 chunks.
META_WIRE_COLS = 6


def pack_meta_np(meta) -> np.ndarray:
    """[R, META_COLS] logical int32 -> [R, META_WIRE_COLS] wire int32."""
    m = np.ascontiguousarray(meta, dtype=np.int64)
    tsc, tec = m[:, M_TSC], m[:, M_TEC]
    lo, hi = m[:, M_LO], m[:, M_HI]
    baserow, nch = m[:, M_BASEROW], m[:, M_NCHUNKS]
    # Real exceptions, not asserts: an overflow here silently bleeds
    # into the adjacent bit field under python -O (wrong chunk base
    # rows -> windows gathered from unrelated reads).
    if not (
        tsc.min(initial=0) >= 0
        and lo.min(initial=0) >= 0
        and hi.min(initial=0) >= -1
        and baserow.min(initial=0) >= 0
        and max(tsc.max(initial=0), tec.max(initial=0),
                lo.max(initial=0), hi.max(initial=0) + 1) < 1 << 14
    ):
        raise ValueError("row coordinate exceeds the 14-bit meta wire field")
    if baserow.max(initial=0) >= 1 << 16:
        raise ValueError("baserow exceeds the 16-bit meta wire field")
    if nch.min(initial=0) < 0 or nch.max(initial=0) >= 1 << 15:
        raise ValueError("nchunks exceeds the 15-bit meta wire field")
    lane1 = (
        lo
        | ((m[:, M_TSTART] != 0) << 14)
        | ((m[:, M_TEND] != 0) << 15)
        | ((hi + 1) << 16)
        | ((m[:, M_ISRC] != 0) << 30)
        | ((m[:, M_ENDS] != 0).astype(np.int64) << 31)
    )
    out = np.empty((m.shape[0], META_WIRE_COLS), dtype=np.int32)
    out[:, 0] = tsc | (tec << 16)
    out[:, 1] = (lane1 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    out[:, 2] = m[:, M_OFF]
    out[:, 3] = m[:, M_N]
    out[:, 4] = m[:, M_FSIMPLE]
    out[:, 5] = baserow | (nch << 16)
    return out


def _unpack_meta(meta, with_ends: bool = False):
    """Device-side inverse of :func:`pack_meta_np` -> [R, META_COLS].

    ``with_ends=False`` (the default full-scan path) returns only the
    first 12 columns — the extra M_ENDS column would change the traced
    HLO (and hence the persistent compile-cache keys) of every existing
    executable for a bit it never reads."""
    c0, c1, c5 = meta[:, 0], meta[:, 1], meta[:, 5]
    cols = [None] * META_COLS
    cols[M_TSC] = c0 & 0xFFFF
    cols[M_TEC] = c0 >> 16  # c0 >= 0: arithmetic shift is logical here
    cols[M_TSTART] = (c1 >> 14) & 1
    cols[M_TEND] = (c1 >> 15) & 1
    cols[M_LO] = c1 & 0x3FFF
    cols[M_HI] = ((c1 >> 16) & 0x3FFF) - 1
    cols[M_OFF] = meta[:, 2]
    cols[M_N] = meta[:, 3]
    cols[M_ISRC] = (c1 >> 30) & 1
    cols[M_FSIMPLE] = meta[:, 4]
    cols[M_BASEROW] = c5 & 0xFFFF
    cols[M_NCHUNKS] = c5 >> 16
    cols[M_ENDS] = (c1 >> 31) & 1  # sign bit: arithmetic shift, & 1 ok
    if not with_ends:
        cols = cols[:M_ENDS]
    return jnp.stack(cols, axis=1)


def _derive_meta(
    rowdesc, chunk_meta, S_pad: int, L: int, ends_w: int, ends_wr: int,
    halo: int, padding: int, with_ends: bool,
):
    """Device-side metadata synthesis from the 4-byte/row descriptor
    (``meta_mode='desc'``): full per-row metadata never crosses the
    wire — it is a pure function of (read length, row type, W, L).
    ``ends_w``/``ends_wr`` are the per-side window widths (prefix /
    suffix; ``ends_wr == 0`` means symmetric) — the filter presets
    bound the two read ends differently (`@prev_left` chains anchor
    left), so the suffix window can ship narrower than the prefix.

    ``rowdesc`` is int32 per HOST row, low 2 bits a type tag, the rest
    the payload:

    * tag 0: simple forward read, payload = read length ``n`` (0 for
      padding rows -> invalid)
    * tag 1: ends-mode PREFIX row of a long read, payload = ``n``
    * tag 2: ends-mode SUFFIX row (always immediately after its prefix
      row), payload = ``n``
    * tag 3: long-read chunk row, payload = index into ``chunk_meta``
      (a [C_pad, META_WIRE_COLS] pack_meta_np table for just the chunk
      rows — the only rows whose metadata is not length-derivable)

    Rows ``[R_host_pad, R_host_pad + S_pad)`` are the on-device
    flip+complement twins of host rows ``[0, S_pad)``: a tag-0 twin is
    the classic rc simple row, a tag-1 twin is the RC SUFFIX window
    (flip of the forward prefix), a tag-2 twin the RC PREFIX window,
    and a tag-3 twin (a chunk row that happened to fall below S_pad)
    is marked invalid — chunk rows ship both strands from the host.
    Returns the same [R_total, META_COLS(12/13)] matrix
    :func:`_unpack_meta` would."""
    R_host_pad = rowdesc.shape[0]
    tag = rowdesc & 3
    n = rowdesc >> 2  # rowdesc >= 0: arithmetic shift is logical here
    Wl = jnp.int32(ends_w)
    Wr = jnp.int32(ends_wr if ends_wr else ends_w)
    rowid = jnp.arange(R_host_pad, dtype=jnp.int32)
    cm = _unpack_meta(chunk_meta, with_ends=with_ends)
    ci = jnp.clip(n, 0, chunk_meta.shape[0] - 1)

    def build(block_tag, block_n, block_row, twin: bool):
        is_simple = block_tag == 0
        is_pre = block_tag == 1
        is_suf = block_tag == 2
        is_chunk = block_tag == 3
        is_ends = is_pre | is_suf
        valid = block_n > 0
        if twin:
            valid = valid & ~is_chunk
        z = jnp.zeros_like(block_n)
        # Suffix-claim start, row-local: the prefix (width Wl) claims
        # end positions [0, Wl-1-PADDING] and the suffix (width Wr)
        # [C, n] with C = max(n-Wr+halo+1, Wl-PADDING) — claims tile
        # exactly for n <= Wl+Wr-halo-PADDING-1 (the windows overlap
        # mid-read), and the suffix DP always has >= halo left context
        # at its first claim.  Must match _materialize's host formula.
        suf_lo = jnp.maximum(halo + 1, Wl + Wr - padding - block_n)
        if not twin:
            tsc = z
            tec = jnp.where(is_simple, block_n, jnp.where(is_pre, Wl, Wr))
            ts = is_simple | is_pre
            te = is_simple | is_suf
            lo = jnp.where(is_suf, suf_lo, 0)
            hi = jnp.where(
                is_simple, block_n, jnp.where(is_pre, Wl - 1 - padding, Wr)
            )
            off = jnp.where(is_suf, block_n - Wr, 0)
            isrc = z
        else:
            # flip of the corresponding host row, right-aligned at L
            tsc = jnp.where(
                is_simple, L - block_n, jnp.where(is_pre, L - Wl, L - Wr)
            )
            tec = jnp.full_like(block_n, L)
            ts = is_simple | is_suf  # tag-2 flip = rc PREFIX
            te = is_simple | is_pre  # tag-1 flip = rc SUFFIX
            lo = jnp.where(is_pre, (L - Wl) + suf_lo, tsc)
            hi = jnp.where(is_suf, L - 1 - padding, L)
            off = jnp.where(is_pre, block_n - Wl, 0)
            isrc = jnp.ones_like(block_n)
        # ends rows: prefix host row p, suffix p+1; the barcode-window
        # cover base must be p for both (frow = baserow + suffix?1:0),
        # and for twins the cover rows are the FORWARD host rows.
        base = jnp.where(is_suf, block_row - 1, block_row)
        fsimple = jnp.where(is_simple, block_row, -1)
        cols = [None] * META_COLS
        cols[M_TSC] = tsc
        cols[M_TEC] = jnp.where(valid, tec, 0)
        cols[M_TSTART] = (ts & valid).astype(jnp.int32)
        cols[M_TEND] = (te & valid).astype(jnp.int32)
        cols[M_LO] = jnp.where(valid, lo, 0)
        cols[M_HI] = jnp.where(valid, hi, -1)
        cols[M_OFF] = jnp.where(valid, off, 0)
        cols[M_N] = block_n
        cols[M_ISRC] = isrc
        cols[M_FSIMPLE] = fsimple
        cols[M_BASEROW] = jnp.where(valid, base, 0)
        cols[M_NCHUNKS] = jnp.where(is_ends, 2, 1)
        cols[M_ENDS] = (is_ends & valid).astype(jnp.int32)
        out = jnp.stack(
            cols[: META_COLS if with_ends else M_ENDS], axis=1
        ).astype(jnp.int32)
        if not twin:
            # splice real chunk metadata over tag-3 host rows
            out = jnp.where(
                is_chunk[:, None],
                jnp.take(cm, ci, axis=0, mode="clip"),
                out,
            )
        return out

    host = build(tag, n, rowid, twin=False)
    twin = build(tag[:S_pad], n[:S_pad], rowid[:S_pad], twin=True)
    return jnp.concatenate([host, twin], axis=0)


_DEMUX_STATICS = (
    "gi", "gf", "K", "m", "k_units", "W_words", "top_bit", "Wf",
    "plen", "Wb", "P", "H_cap", "padding", "kernels",
    "pack_mode", "L_rows", "ends_w", "ends_wr", "halo", "meta_mode",
    "S_pad", "cat_align", "_stages",
)


@functools.partial(jax.jit, static_argnames=_DEMUX_STATICS)
def demux_call(
    flank,  # [m] u8 flank masks
    patw,  # [4, W_words] u32 (Myers kernel path)
    patterns_all,  # [2P, m] u8: fwd pattern stack then rc stack
    host_packed,  # [R_host_pad, L/2] nibble-packed rows
    simple_idx,  # [S_pad] host-row indices of fwd simple reads
    meta,  # [R_total_pad, META_WIRE_COLS] int32 packed per-row metadata
    #     (see pack_meta_np; unpacked to META_COLS on device)
    exc,  # [E, 2] int32 (flat_pos, mask) exceptions (2-bit modes; dummy otherwise)
    row_start,  # [R_host] int32 byte starts (pack_mode 2; dummy otherwise)
    *,
    gi: tuple,  # (alpha, mask_a, mask_b, k1, iv_a, iv_b, step) ints —
    #     group constants; static so they bake into the executable
    #     instead of shipping + staging two arrays every call
    gf: tuple,  # (perfect, min_score, min_score_diff) floats
    K: int,
    m: int,
    k_units: int,
    W_words: int,
    top_bit: int,
    Wf: int,  # flank trace window span
    plen: int,  # barcode pattern length
    Wb: int,  # barcode window width
    P: int,  # patterns per strand
    H_cap: int,  # hit-lane capacity
    padding: int,  # barcode window padding (PADDING)
    kernels: Kernels = XLA,  # hand-written kernels to use (static)
    pack_mode: int = 0,  # 0 nibble, 1 = 2-bit padded, 2 = 2-bit concatenated
    L_rows: int = 0,  # row width (pack_mode 2; other modes derive it)
    ends_w: int = 0,  # ends-only fast path: PREFIX window width (0 = full scan)
    ends_wr: int = 0,  # SUFFIX window width (0 = symmetric = ends_w)
    halo: int = 0,  # flank halo (meta_mode='desc' derivation)
    meta_mode: str = "wire",  # 'wire' = uploaded meta; 'desc' = derived
    S_pad: int = 0,  # twin-block rows (meta_mode='desc')
    cat_align: int = 128,  # cat-row byte alignment (pack_mode 2)
    _stages: int = 4,  # debug: 1=scan, 2=+trace, 3=+rank1, 4=full
):
    """The full demux pipeline for one (group, batch) in ONE device call.

    Fuses flank scan -> hit compaction -> flank traceback -> barcode
    window mapping -> barcode rank, eliminating three intermediate
    host round trips and the host-side hit bookkeeping.  Returns one flat int32 array:
    ``[H_cap * REC_COLS hit records] ++ [ceil(R/32) overflow-bitmask
    words (bit r: row r had more than K valleys)] ++ [total]``.
    Hits beyond H_cap are dropped on device — the caller must check
    ``total <= H_cap`` and retry with a larger capacity (or fall back).

    Semantics per stage are identical to flank_scan / flank_trace /
    barcode_rank (conformance-tested); the only difference is that both
    strands run through one barcode-rank pass over the concatenated
    [fwd; rc] pattern stack with a per-lane strand mask.

    ``meta_mode='desc'`` (pack_mode 2 only) replaces the per-row
    metadata upload with a 4-byte/row descriptor: the ``meta`` argument
    carries the int32 rowdesc vector, ``simple_idx`` carries the packed
    chunk-row metadata table, ``row_start`` is ignored (byte starts are
    re-derived on device with the same cumsum the host packer used) and
    the rc twin block is a slice-flip of host rows [0, S_pad).
    """
    (alpha_scaled, mask_a, mask_b, k1_scaled, iv_a, iv_b, step) = (
        jnp.int32(v) for v in gi
    )
    perfect, min_score, min_score_diff = (jnp.float32(v) for v in gf)

    if meta_mode == "desc":
        if pack_mode != 2:
            raise ValueError("meta_mode='desc' requires pack_mode 2")
        rowdesc, chunk_meta = meta, simple_idx
        meta = _derive_meta(
            rowdesc, chunk_meta, S_pad, L_rows, ends_w, ends_wr, halo,
            padding, with_ends=ends_w > 0,
        )
        R_host = rowdesc.shape[0]
        hlen = meta[:R_host, M_TEC]
        nb = (hlen + 3) >> 2
        stride = (nb + (cat_align - 1)) // cat_align * cat_align
        row_start = jnp.concatenate(
            [jnp.zeros(1, dtype=jnp.int32),
             jnp.cumsum(stride[:-1], dtype=jnp.int32)]
        )
        rows = _assemble_rows2cat(
            host_packed, row_start, exc, hlen, None, L_rows,
            align=cat_align, twin_slice=S_pad,
        )
    elif pack_mode == 2:
        meta = _unpack_meta(meta, with_ends=ends_w > 0)
        R_host = row_start.shape[0]
        rows = _assemble_rows2cat(
            host_packed, row_start, exc, meta[:R_host, M_TEC], simple_idx,
            L_rows, align=cat_align,
        )
    elif pack_mode == 1:
        meta = _unpack_meta(meta, with_ends=ends_w > 0)
        R_host = host_packed.shape[0]
        rows = _assemble_rows2(
            host_packed, exc, meta[:R_host, M_TEC], simple_idx
        )
    else:
        meta = _unpack_meta(meta, with_ends=ends_w > 0)
        rows = _assemble_rows(host_packed, simple_idx)
    R, L = rows.shape
    L_key = L + 2
    # Valley keys are cost_scaled * L_key + col with BIG (2**30)
    # sentinels on both kernel paths: any valid key reaching the
    # sentinel would silently drop hits.  Static shapes make this
    # checkable at trace time (the engine also pre-shrinks row width).
    if k_units * UNIT * L_key + L >= 2**30:
        # a plain assert vanishes under python -O and the overflow
        # silently drops valid hits — always raise
        raise ValueError(
            f"valley keys overflow the 2**30 sentinel: k_units={k_units}, "
            f"L={L}; shrink the row width"
        )

    tsc = meta[:, M_TSC]
    tec = meta[:, M_TEC]
    true_start = meta[:, M_TSTART] != 0
    true_end = meta[:, M_TEND] != 0
    v_lo = meta[:, M_LO]
    v_hi = meta[:, M_HI]
    start_col = jnp.where(true_start, tsc, -1)
    end_col = jnp.where(true_end, tec, L + 2)
    mk = m + k_units
    emit_lo = jnp.where(true_start, tsc + mk + 2, v_lo)
    emit_hi = jnp.where(true_end, jnp.minimum(v_hi, tec - 2), v_hi)

    key_top, count = _scan_keys(
        flank, patw, rows, start_col, end_col, v_lo, v_hi, emit_lo, emit_hi,
        alpha_scaled, K=K, kernels=kernels,
        m=m, k_units=k_units, W_words=W_words, top_bit=top_bit,
        csc=tsc, cec=tec,
    )

    # ---- compact valid hits into H_cap lanes ---------------------------
    # Strand-split layout (rank kernel): fwd hits in lanes [0, H_cap/2),
    # rc hits in [H_cap/2, H_cap) — the rank kernel then evaluates only
    # the lane's own strand's P patterns instead of all 2P.
    # Valid hits compact into lanes in flat (row-major, then slot)
    # order via cumsum + scatter — an argsort-based compaction costs a
    # full bitonic sort (~log^2 passes over R*K keys) for what is just
    # a stable partition.  Lane validity comes from the counts, so the
    # scatter's zero-initialized slack lanes are never read.
    split = kernels.rank and Wb <= 255 and H_cap % 256 == 0
    flat_valid = (key_top < BIG).reshape(-1)
    total = flat_valid.sum(dtype=jnp.int32)
    flat_idx = jnp.arange(R * K, dtype=jnp.int32)

    def compact(valid, cap):
        """Indices of valid entries in flat order, padded with 0s; a
        lane is meaningful iff its index < the valid count."""
        pos = jnp.cumsum(valid.astype(jnp.int32)) - 1
        pos = jnp.where(valid & (pos < cap), pos, cap)  # OOB -> dropped
        return jnp.zeros(cap, dtype=jnp.int32).at[pos].set(
            flat_idx, mode="drop"
        )

    if split:
        rc_row = meta[:, M_ISRC] != 0
        rc_flat = jnp.repeat(rc_row, K)
        half = H_cap // 2
        fwd_valid = flat_valid & ~rc_flat
        take = jnp.concatenate(
            [compact(fwd_valid, half), compact(flat_valid & rc_flat, half)]
        )
        n_fwd = fwd_valid.sum(dtype=jnp.int32)
        n_rc = total - n_fwd
        # either half overflowing must trigger the caller's retry
        total_out = jnp.maximum(total, 2 * jnp.maximum(n_fwd, n_rc))
        lane = jnp.arange(H_cap)
        hvalid = jnp.where(lane < half, lane < n_fwd, lane - half < n_rc)
    else:
        take = compact(flat_valid, H_cap)
        hvalid = jnp.arange(H_cap) < total
        total_out = total
    hrow = take // K
    hkey = key_top.reshape(-1)[take]
    hcol = jnp.where(hvalid, hkey % L_key, 0)
    hcost = jnp.where(hvalid, hkey // L_key, 0)

    hm = meta[hrow]  # [H_cap, META_COLS]
    h_tsc, h_tec = hm[:, M_TSC], hm[:, M_TEC]
    h_tstart, h_tend = hm[:, M_TSTART] != 0, hm[:, M_TEND] != 0
    h_off, h_n = hm[:, M_OFF], hm[:, M_N]
    h_isrc = hm[:, M_ISRC]

    # ---- flank traceback (forward-summary DP) --------------------------
    s_col = jnp.maximum(h_tsc, hcol - Wf)
    w_len_tr = hcol - s_col
    left_edge = h_tstart & (s_col == h_tsc)
    right_pos = jnp.where(h_tend & (hcol == h_tec), w_len_tr, -1)
    tw = _gather_windows(rows, hrow, s_col, Wf)
    jposf = jnp.arange(Wf, dtype=jnp.int32)
    tw = jnp.where(jposf[None, :] < w_len_tr[:, None], tw, 0)
    summ = window_dp_summary(
        flank[None, None, :], tw, left_edge, right_pos, alpha_scaled,
        mask_a, mask_b, jnp.int32(0), jnp.int32(0),
        with_region=True, with_start=True,
    )

    def at_end(arr):
        return jnp.take_along_axis(arr[:, 0, :], w_len_tr[:, None], axis=1)[:, 0]

    f_ts = at_end(summ.text_start)
    rlo = at_end(summ.region_lo)
    rhi = at_end(summ.region_hi)

    # ---- map mask region to a padded fwd barcode window ----------------
    s_text = h_off + (s_col - h_tsc)
    lo_t = s_text + rlo
    hi_t = s_text + rhi
    lo2 = jnp.where(h_isrc != 0, h_n - hi_t, lo_t)
    hi2 = jnp.where(h_isrc != 0, h_n - lo_t, hi_t)
    bstart = jnp.maximum(0, lo2 - padding)
    bend = jnp.minimum(hi2 + padding, h_n)
    has2 = hvalid & (rhi >= 0) & (bend > bstart)
    fs_text = s_text + f_ts

    simple = hm[:, M_FSIMPLE] >= 0
    k_idx = jnp.clip(
        jnp.where(step > 0, bstart // jnp.maximum(step, 1), 0),
        0,
        jnp.maximum(hm[:, M_NCHUNKS] - 1, 0),
    )
    foff = jnp.where(simple, 0, k_idx * step)
    if ends_w:
        # Ends rows: the forward cover rows are baserow (prefix, width
        # Wl, text offset 0) and baserow+1 (suffix, width Wr, offset
        # n - Wr).  Prefix-claimed windows end before Wl - PADDING and
        # suffix windows start past offset + 3 > n - Wr (valid-range
        # margins), so the window's home row is decided by
        # ``bstart >= n - Wr`` alone.
        wr_eff = ends_wr if ends_wr else ends_w
        is_ends = hm[:, M_ENDS] != 0
        suf = is_ends & (bstart >= h_n - wr_eff)
        k_idx = jnp.where(is_ends, suf.astype(jnp.int32), k_idx)
        foff = jnp.where(
            is_ends, jnp.where(suf, h_n - wr_eff, 0), foff
        )
    frow = jnp.where(simple, hm[:, M_FSIMPLE], hm[:, M_BASEROW] + k_idx)
    frow = jnp.clip(frow, 0, R - 1)
    b_startw = jnp.maximum(bstart - foff, 0)
    b_len = jnp.where(has2, bend - bstart, 0)

    # ---- barcode rank over the concatenated fwd+rc pattern stack -------
    windows = _gather_windows(rows, frow, b_startw, Wb)
    jposb = jnp.arange(Wb, dtype=jnp.int32)
    windows = jnp.where(jposb[None, :] < b_len[:, None], windows, 0)

    Pa = patterns_all.shape[0]  # 2P
    if kernels.rank and Wb <= 255:
        # split: [H, P] strand-local, each lane ranked against its own
        # strand's pattern stack only; else all 2P with a strand mask
        key2, lodhi_best = rank_pass1(
            patterns_all, windows, b_len, P=P if split else Pa, split=split,
            interpret=kernels.interpret,
        )
        best_cost = key2 // 256
        best_pos = key2 % 256
    else:
        no_edge = jnp.zeros(H_cap, dtype=bool)
        no_right = jnp.full(H_cap, -1, dtype=jnp.int32)
        summ1 = window_dp_summary(
            patterns_all[None, :, :], windows, no_edge, no_right,
            jnp.int32(UNIT), jnp.int32(0), jnp.int32(-1), iv_a, iv_b,
            with_lodhi=True,
        )
        best = best_valley_per_pattern(summ1.ends, b_len)
        best_cost, best_pos = best.cost, best.pos
        lodhi_best = jnp.take_along_axis(
            summ1.lodhi, best_pos[:, :, None], axis=2
        )[:, :, 0]
    if split:
        lane_mask = jnp.ones((H_cap, P), dtype=bool)
        strand_off = jnp.where(h_isrc != 0, P, 0).astype(jnp.int32)
    else:
        lane_mask = (
            jnp.arange(Pa, dtype=jnp.int32)[None, :] // P
        ) == h_isrc[:, None]
        strand_off = jnp.zeros(H_cap, dtype=jnp.int32)

    in_k1 = (best_cost <= k1_scaled) & lane_mask
    matched = in_k1.sum(axis=1)
    use_all = matched <= 1
    cand = (use_all[:, None] | in_k1) & has2[:, None] & lane_mask

    scores = jnp.where(cand, lodhi_best / perfect, -jnp.inf)
    top_local = jnp.argmax(scores, axis=1).astype(jnp.int32)
    top = top_local + strand_off  # index into patterns_all
    top_norm = jnp.take_along_axis(scores, top_local[:, None], axis=1)[:, 0]
    rest = jnp.where(
        jnp.arange(scores.shape[1])[None, :] == top_local[:, None],
        -jnp.inf,
        scores,
    )
    second_norm = jnp.max(rest, axis=1)
    n_cand = cand.sum(axis=1)
    accepted = (top_norm >= min_score) & (
        (n_cand <= 1) | ((top_norm - second_norm) >= min_score_diff)
    )
    accepted = accepted & has2 & (n_cand > 0)

    # interval mapping for the winner only
    pat_top = jnp.take(patterns_all, top, axis=0)
    end_top = jnp.take_along_axis(best_pos, top_local[:, None], axis=1)
    summ2 = window_dp_summary(
        pat_top[:, None, :], windows,
        jnp.zeros(H_cap, dtype=bool), jnp.full(H_cap, -1, dtype=jnp.int32),
        jnp.int32(UNIT), jnp.int32(0), jnp.int32(-1), iv_a, iv_b,
        with_interval=True,
    )

    def pick(arr):
        return jnp.take_along_axis(arr[:, 0, :], end_top, axis=1)[:, 0]

    iv_vals = [
        pick(summ2.iv_pj),
        pick(summ2.iv_ej) + 1,
        pick(summ2.iv_pi),
        pick(summ2.iv_ei) + 1,
        pick(summ2.iv_cost),
        pick(summ2.has_interval.astype(jnp.int32)),
    ]

    def gate(x, lvl):  # debug stage gating; zeros_like lets XLA DCE the stage
        return x if _stages >= lvl else jnp.zeros_like(x)

    wbits = rec_wire_spec(L, R, k_units, P, plen, Wb)
    if wbits is not None:
        # packed 6-lane wire record (see rec_wire_spec / unpack_rec_np)
        has2_i = gate(has2.astype(jnp.int32), 2)
        acc_i = gate(accepted.astype(jnp.int32), 3)
        top_i = gate(top, 3)
        hasiv_i = gate(iv_vals[5], 4)
        ivs = [
            jnp.where(hasiv_i != 0, gate(v, 4), 0) for v in iv_vals[:5]
        ]
        rec = jnp.stack(
            [
                hrow | (hcol << 17),
                top_i | (has2_i << 8) | (acc_i << 9) | (hcost << 10),
                gate(bstart, 2),
                gate(fs_text, 2),
                ivs[0] | (ivs[1] << wbits) | (ivs[2] << (2 * wbits))
                | (hasiv_i << (3 * wbits)),
                ivs[3] | (ivs[4] << wbits),
            ],
            axis=1,
        ).astype(jnp.int32)
    else:
        rec = jnp.stack(
            [
                hrow,
                hcol,
                hcost,
                gate(has2.astype(jnp.int32), 2),
                gate(bstart, 2),
                gate(fs_text, 2),
                gate(top, 3),
                gate(accepted.astype(jnp.int32), 3),
                gate(iv_vals[0], 4),
                gate(iv_vals[1], 4),
                gate(iv_vals[2], 4),
                gate(iv_vals[3], 4),
                gate(iv_vals[4], 4),
                gate(iv_vals[5], 4),
            ],
            axis=1,
        ).astype(jnp.int32)
    # Per-row valley counts are fetched ONLY to flag rows whose valley
    # count exceeded the top-K lanes (engine falls those reads back to
    # the scalar path): pack the single bit per row into int32 words —
    # the count vector was ~R*4 bytes (~24-32KB per 2048-read batch),
    # the bitmask is R/8 bytes.
    over = (count > K).astype(jnp.uint32)
    nw = (R + 31) // 32
    over = jnp.concatenate(
        [over, jnp.zeros(nw * 32 - R, dtype=jnp.uint32)]
    ).reshape(nw, 32)
    # disjoint power-of-two lanes: the sum IS the bitwise or
    words = (over << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
        axis=1, dtype=jnp.uint32
    )
    return jnp.concatenate(
        [
            rec.reshape(-1),
            jax.lax.bitcast_convert_type(words, jnp.int32),
            total_out[None],
        ]
    )


def _call_from_parts(flank, patw, patterns_all, parts, **statics):
    """demux_call on named blob segments — maps both the classic
    ('simple_idx'/'meta'/'row_start') and the descriptor
    ('rowdesc'/'chunk_meta') layouts onto the positional signature."""
    if "rowdesc" in parts:
        dummy = jnp.zeros(1, dtype=jnp.int32)
        return demux_call.__wrapped__(
            flank, patw, patterns_all, parts["host_packed"],
            parts["chunk_meta"], parts["rowdesc"], parts["exc"], dummy,
            **statics,
        )
    return demux_call.__wrapped__(
        flank, patw, patterns_all, parts["host_packed"],
        parts["simple_idx"], parts["meta"], parts["exc"],
        parts["row_start"], **statics,
    )


@functools.partial(jax.jit, static_argnames=("spans",) + _DEMUX_STATICS)
def demux_call_mono(flank, patw, patterns_all, blob, *, spans, **statics):
    """demux_call with every per-batch host array riding ONE uint8
    upload: every transfer carries a fixed overhead, so one fused
    buffer replaces five small uploads per batch.
    ``spans`` is a static tuple of (name, byte_off, shape) laid out by
    the engine's blob builder; int32 segments are 4-byte aligned and
    bitcast on device (little-endian on every supported backend —
    row-identity on the GPU is covered by tests/test_gpu_smoke.py)."""
    parts = _blob_parts(blob, spans)
    return _call_from_parts(flank, patw, patterns_all, parts, **statics)


def _blob_parts(blob, spans):
    """Slice the fused upload back into named device arrays (traced)."""
    parts = {}
    for name, off, shape in spans:
        n = 1
        for s in shape:
            n *= s
        if name == "host_packed":
            parts[name] = blob[off : off + n].reshape(shape)
        else:
            raw = blob[off : off + 4 * n]
            parts[name] = jax.lax.bitcast_convert_type(
                raw.reshape(n, 4), jnp.int32
            ).reshape(shape)
    return parts


@functools.partial(
    jax.jit, static_argnames=("spans", "group_statics", "common")
)
def demux_call_fused(group_args, blob, *, spans, group_statics, common):
    """EVERY group's fused demux in one device call on one uploaded
    blob: multi-group configs (NBD front+rear custom runs, RBK
    ``--use-extended``) otherwise pay a dispatch + fetch round trip per
    group per batch.  ``group_args`` is a tuple of
    (flank, patw, patterns_all) per group; ``group_statics`` a tuple of
    per-group static item-tuples, ``common`` the shared statics.  The
    output is the concatenation of each group's packed buffer in plan
    order (lengths differ per group via its wire-record layout)."""
    parts = _blob_parts(blob, spans)
    outs = []
    for (flank, patw, patterns_all), st in zip(group_args, group_statics):
        outs.append(
            _call_from_parts(
                flank, patw, patterns_all, parts, **dict(st), **dict(common)
            )
        )
    return jnp.concatenate(outs)


def build_blob_np(host_packed, simple_idx, meta_packed, exc, row_start):
    """(blob uint8, spans) — host side of demux_call_mono's layout."""
    return build_blob_named(
        ("host_packed", np.ascontiguousarray(host_packed, dtype=np.uint8)),
        ("simple_idx", np.ascontiguousarray(simple_idx, dtype=np.int32)),
        ("meta", np.ascontiguousarray(meta_packed, dtype=np.int32)),
        ("exc", np.ascontiguousarray(exc, dtype=np.int32)),
        ("row_start", np.ascontiguousarray(row_start, dtype=np.int32)),
    )


def build_blob_desc_np(host_packed, rowdesc, chunk_meta_packed, exc):
    """(blob uint8, spans) — the meta_mode='desc' mono layout: content
    bytes + 4-byte/row descriptor + chunk-meta table + exceptions (no
    simple_idx / full meta / row_start — all device-derived)."""
    return build_blob_named(
        ("host_packed", np.ascontiguousarray(host_packed, dtype=np.uint8)),
        ("rowdesc", np.ascontiguousarray(rowdesc, dtype=np.int32)),
        ("chunk_meta", np.ascontiguousarray(chunk_meta_packed, dtype=np.int32)),
        ("exc", np.ascontiguousarray(exc, dtype=np.int32)),
    )


def build_blob_named(*segs):
    """(blob uint8, spans) from (name, np array) segments; int32
    segments 4-byte aligned for the device bitcast."""
    spans = []
    off = 0
    chunks = []
    for name, arr in segs:
        if off % 4:
            pad = 4 - off % 4
            chunks.append(np.zeros(pad, dtype=np.uint8))
            off += pad
        spans.append((name, off, arr.shape))
        raw = arr.reshape(-1).view(np.uint8)
        chunks.append(raw)
        off += raw.size
    return np.concatenate(chunks), tuple(spans)


def _gather_windows(rows, row_idx, starts, W: int):
    """windows[h] = rows[row_idx[h], starts[h] : starts[h]+W].

    Slab slice-gather + local take (see :func:`_slab_windows`); callers
    zero out anything past their window length, so clamp artifacts are
    never read."""
    return _slab_windows(rows, row_idx, starts, W)


@functools.partial(jax.jit, static_argnames=("m", "W"))
def flank_trace(
    pattern,  # [m]
    rows,  # [R_total, L] device-resident
    row_idx,  # [H]
    win_start,  # [H] window start column within row
    left_edge,  # [H]
    right_pos,  # [H]
    end_j,  # [H] = window length
    valid,  # [H]
    region_a,
    region_b,
    alpha_scaled,
    m: int,
    W: int,
):
    """Packed [H, 4] int32: text_start, region_lo, region_hi, has_region
    (all window-relative).  Fused forward-summary DP — no move tables,
    no traceback scan (see :func:`device.window_dp_summary`)."""
    windows = _gather_windows(rows, row_idx, win_start, W)
    jpos = jnp.arange(W, dtype=jnp.int32)
    windows = jnp.where(jpos[None, :] < end_j[:, None], windows, 0)
    summ = window_dp_summary(
        pattern[None, None, :],
        windows,
        left_edge,
        right_pos,
        alpha_scaled,
        region_a,
        region_b,
        jnp.int32(0),
        jnp.int32(0),
        with_region=True,
        with_start=True,
    )

    def at_end(arr):  # [H, 1, W+1] -> value at end_j
        return jnp.take_along_axis(arr[:, 0, :], end_j[:, None], axis=1)[:, 0]

    region_hi = at_end(summ.region_hi)
    return jnp.stack(
        [
            at_end(summ.text_start),
            at_end(summ.region_lo),
            region_hi,
            (region_hi >= 0).astype(jnp.int32),
        ],
        axis=1,
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m", "W"))
def flank_trace_reference(
    pattern,
    rows,
    row_idx,
    win_start,
    left_edge,
    right_pos,
    end_j,
    valid,
    region_a,
    region_b,
    alpha_scaled,
    m: int,
    W: int,
):
    """Original window_dp + traceback_reduce implementation; kept as the
    conformance anchor for :func:`flank_trace` (tests only)."""
    windows = _gather_windows(rows, row_idx, win_start, W)
    jpos = jnp.arange(W, dtype=jnp.int32)
    windows = jnp.where(jpos[None, :] < end_j[:, None], windows, 0)
    wdp = window_dp(pattern[None, :], windows, left_edge, right_pos, alpha_scaled)
    tr = traceback_reduce(
        wdp.moves,
        end_j[:, None],
        valid[:, None],
        region_a,
        region_b,
        jnp.int32(0),
        jnp.int32(0),
        m=m,
        W=W,
    )
    return jnp.stack(
        [
            tr.text_start[:, 0],
            tr.region_lo[:, 0],
            tr.region_hi[:, 0],
            tr.has_region[:, 0].astype(jnp.int32),
        ],
        axis=1,
    ).astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("m", "W")
)
def barcode_rank(
    patterns,  # [P, m] one strand's pattern stack
    rows,  # [R_total, L]
    row_idx,  # [H]
    win_start,  # [H]
    w_len,  # [H]
    hvalid,  # [H]
    k1_scaled,
    iv_a,
    iv_b,
    perfect,  # f32 scalar
    min_score,
    min_score_diff,
    m: int,
    W: int,
):
    """Packed [H, 8] int32: top_idx, accepted, read_bar_start,
    read_bar_end, bar_start, bar_end, bar_cost, has_interval.

    Two fused passes, no move tables: (1) a forward-summary DP carries
    the Lodhi state for ALL patterns (selection needs every candidate's
    score — on real windows ~90 of 96 barcodes pass the k1 filter, so
    candidate compaction can't help); (2) the interval mapping runs the
    same summary DP for just the winning pattern per window."""
    P = patterns.shape[0]
    windows = _gather_windows(rows, row_idx, win_start, W)
    jpos = jnp.arange(W, dtype=jnp.int32)
    windows = jnp.where(jpos[None, :] < w_len[:, None], windows, 0)

    H = windows.shape[0]
    no_edge = jnp.zeros(H, dtype=bool)
    no_right = jnp.full(H, -1, dtype=jnp.int32)
    summ = window_dp_summary(
        patterns[None, :, :],
        windows,
        no_edge,
        no_right,
        jnp.int32(UNIT),
        jnp.int32(0),
        jnp.int32(-1),
        iv_a,
        iv_b,
        with_lodhi=True,
    )
    best = best_valley_per_pattern(summ.ends, w_len)
    best_cost, best_pos = best.cost, best.pos
    lodhi_best = jnp.take_along_axis(
        summ.lodhi, best_pos[:, :, None], axis=2
    )[:, :, 0]

    in_k1 = best_cost <= k1_scaled
    matched = in_k1.sum(axis=1)
    use_all = matched <= 1
    cand = (use_all[:, None] | in_k1) & hvalid[:, None]

    scores = jnp.where(cand, lodhi_best / perfect, -jnp.inf)
    top = jnp.argmax(scores, axis=1).astype(jnp.int32)
    top_norm = jnp.take_along_axis(scores, top[:, None], axis=1)[:, 0]
    rest = jnp.where(jnp.arange(P)[None, :] == top[:, None], -jnp.inf, scores)
    second_norm = jnp.max(rest, axis=1)
    n_cand = cand.sum(axis=1)

    accepted = (top_norm >= min_score) & (
        (n_cand <= 1) | ((top_norm - second_norm) >= min_score_diff)
    )
    accepted = accepted & hvalid & (n_cand > 0)

    # Pass 2: interval mapping for the winning pattern only ([H, 1]).
    pat_top = jnp.take(patterns, top, axis=0)  # [H, m]
    summ2 = window_dp_summary(
        pat_top[:, None, :],
        windows,
        no_edge,
        no_right,
        jnp.int32(UNIT),
        jnp.int32(0),
        jnp.int32(-1),
        iv_a,
        iv_b,
        with_interval=True,
    )
    end_top = jnp.take_along_axis(best_pos, top[:, None], axis=1)  # [H, 1]

    def pick(arr):  # [H, 1, W+1] -> value at the top pattern's end pos
        return jnp.take_along_axis(arr[:, 0, :], end_top, axis=1)[:, 0]

    return jnp.stack(
        [
            top,
            accepted.astype(jnp.int32),
            pick(summ2.iv_pj),
            pick(summ2.iv_ej) + 1,
            pick(summ2.iv_pi),
            pick(summ2.iv_ei) + 1,
            pick(summ2.iv_cost),
            pick(summ2.has_interval.astype(jnp.int32)),
        ],
        axis=1,
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("m", "W"))
def barcode_rank_reference(
    patterns,
    rows,
    row_idx,
    win_start,
    w_len,
    hvalid,
    k1_scaled,
    iv_a,
    iv_b,
    perfect,
    min_score,
    min_score_diff,
    m: int,
    W: int,
):
    """Original all-lanes window_dp + traceback_reduce implementation;
    kept as the conformance anchor for :func:`barcode_rank` (tests
    only).  For lanes outside ``cand`` the traceback is masked, so
    interval fields there hold init values — compare only rows/lanes
    where ``hvalid`` (and interval fields only where accepted)."""
    P = patterns.shape[0]
    windows = _gather_windows(rows, row_idx, win_start, W)
    jpos = jnp.arange(W, dtype=jnp.int32)
    windows = jnp.where(jpos[None, :] < w_len[:, None], windows, 0)

    H = windows.shape[0]
    no_edge = jnp.zeros(H, dtype=bool)
    no_right = jnp.full(H, -1, dtype=jnp.int32)
    bdp = window_dp(patterns, windows, no_edge, no_right, jnp.int32(UNIT))
    best = best_valley_per_pattern(bdp.ends, w_len)

    in_k1 = best.cost <= k1_scaled
    matched = in_k1.sum(axis=1)
    use_all = matched <= 1
    cand = (use_all[:, None] | in_k1) & hvalid[:, None]

    tr = traceback_reduce(
        bdp.moves,
        best.pos,
        cand,
        jnp.int32(0),
        jnp.int32(-1),
        iv_a,
        iv_b,
        m=m,
        W=W,
    )

    scores = jnp.where(cand, tr.lodhi / perfect, -jnp.inf)
    top = jnp.argmax(scores, axis=1).astype(jnp.int32)
    top_norm = jnp.take_along_axis(scores, top[:, None], axis=1)[:, 0]
    rest = jnp.where(jnp.arange(P)[None, :] == top[:, None], -jnp.inf, scores)
    second_norm = jnp.max(rest, axis=1)
    n_cand = cand.sum(axis=1)

    accepted = (top_norm >= min_score) & (
        (n_cand <= 1) | ((top_norm - second_norm) >= min_score_diff)
    )
    accepted = accepted & hvalid & (n_cand > 0)

    def pick(arr):
        return jnp.take_along_axis(arr, top[:, None], axis=1)[:, 0]

    return jnp.stack(
        [
            top,
            accepted.astype(jnp.int32),
            pick(tr.iv_pj),
            pick(tr.iv_ej) + 1,
            pick(tr.iv_pi),
            pick(tr.iv_ei) + 1,
            pick(tr.iv_cost),
            pick(tr.has_interval.astype(jnp.int32)),
        ],
        axis=1,
    ).astype(jnp.int32)
