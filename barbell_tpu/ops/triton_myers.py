"""GPU kernel (Pallas, Triton route): bit-parallel Myers flank scan with
in-kernel top-K valley keys.

The jnp twin (:func:`barbell_tpu.ops.device.flank_ends` + valley keys +
``lax.top_k``) runs an m-row ``lax.scan`` over the whole ``[R, L]`` row
matrix with a ``log L`` associative scan in every row: a chain of
memory-bound passes.  Here one thread owns one row: the whole pattern
lives in ``W = ceil(m/32)`` u32 words (Myers' recurrence, ~30 bit-ops
per word and text column), the running end cost, its two neighbours and
the TOPK best valley keys are loop carries, and nothing but the text
column is read from memory.  Text is pre-transposed to ``[L, R]`` so
each column load is coalesced across the block's rows.

Semantics: unit-cost semiglobal search (column-0 boundary ``i``, no
overhang alpha).  The caller recomputes the alpha-aware boundary windows
(first ``m+k+1`` positions and the read end) with the jnp DP and merges
them; overhang never changes an end cost <= k outside those windows
(docs/SEMANTICS.md).  For every position j in ``[emit_lo, emit_hi]``
that is a plateau-valley minimum with cost <= k the kernel offers the
key ``cost * klmul + j`` to a sorted TOPK insertion chain and counts it.
Positions are decided for j in ``[0, L-1]`` only (every caller clamps
``emit_hi <= L-2``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

TOPK = 8  # valley slots per row
BLOCK_ROWS = 64  # rows (threads) per program; a power of two
NUM_WARPS = 2
BIG = 2**30


def pattern_words(pattern_masks: np.ndarray):
    """(words [4, W] uint32, W, top_bit) — per-base membership bitvectors."""
    m = len(pattern_masks)
    W = (m + 31) // 32
    words = np.zeros((4, W), dtype=np.uint32)
    for i, mask in enumerate(pattern_masks):
        w, b = divmod(i, 32)
        for base in range(4):
            if mask & (1 << base):
                words[base, w] |= np.uint32(1 << b)
    return words, W, (m - 1) % 32


def _kernel(patw_ref, text_ref, lo_ref, hi_ref, keys_ref, cnt_ref, *,
            W: int, top_bit: int, m: int, L: int, k_units: int, klmul: int):
    BR = lo_ref.shape[0]
    pw = [[patw_ref[b, w] for w in range(W)] for b in range(4)]
    emit_lo = lo_ref[...]
    emit_hi = hi_ref[...]
    zu = jnp.zeros((BR,), jnp.uint32)
    zi = jnp.zeros((BR,), jnp.int32)

    def step(j, carry):
        pv, mv, e_cur, e_prev, count, tk = carry
        t = text_ref[j, :].astype(jnp.uint32)
        # per-base lane masks: all-ones where the text byte has the base
        sel = [zu - ((t >> b) & 1) for b in range(4)]
        sc = zu
        ph_in = zu
        mh_in = zu
        ph_top = zu
        mh_top = zu
        pv_new, mv_new = [], []
        for w in range(W):
            eq = ((sel[0] & pw[0][w]) | (sel[1] & pw[1][w])
                  | (sel[2] & pw[2][w]) | (sel[3] & pw[3][w]))
            xv = eq | mv[w]
            t1 = eq & pv[w]
            s1 = t1 + pv[w]
            c1 = (s1 < t1).astype(jnp.uint32)
            s2 = s1 + sc
            c2 = (s2 < s1).astype(jnp.uint32)
            sc = c1 | c2
            xh = (s2 ^ pv[w]) | eq
            ph = mv[w] | ~(xh | pv[w])
            mh = pv[w] & xh
            if w == W - 1:
                ph_top = (ph >> top_bit) & 1
                mh_top = (mh >> top_bit) & 1
            ph_s = (ph << 1) | ph_in
            ph_in = ph >> 31
            mh_s = (mh << 1) | mh_in
            mh_in = mh >> 31
            pv_new.append(mh_s | ~(xv | ph_s))
            mv_new.append(ph_s & xv)
        e_next = e_cur + ph_top.astype(jnp.int32) - mh_top.astype(jnp.int32)
        # decide position j from (e_prev, e_cur, e_next) = ends[j-1..j+1]
        valley = ((e_cur <= k_units) & (e_cur <= e_prev) & (e_cur < e_next)
                  & (j >= emit_lo) & (j <= emit_hi))
        x = jnp.where(valley, jnp.where(valley, e_cur, 0) * klmul + j, BIG)
        slots = []
        for cur in tk:  # sorted insertion chain, the max spills off
            slots.append(jnp.minimum(x, cur))
            x = jnp.maximum(x, cur)
        count = count + valley.astype(jnp.int32)
        return (tuple(pv_new), tuple(mv_new), e_next, e_cur, count,
                tuple(slots))

    init = (
        tuple(~zu for _ in range(W)),
        tuple(zu for _ in range(W)),
        zi + m,  # ends[0]
        zi + 2**20,  # ends[-1]
        zi,
        tuple(zi + BIG for _ in range(TOPK)),
    )
    _, _, _, _, count, tk = jax.lax.fori_loop(0, L, step, init)
    for s in range(TOPK):
        keys_ref[s, :] = tk[s]
    cnt_ref[...] = count


@functools.partial(
    jax.jit,
    static_argnames=("W", "top_bit", "m", "k_units", "klmul", "interpret"),
)
def myers_topk(patw, rows, emit_lo, emit_hi, *, W: int, top_bit: int,
               m: int, k_units: int, klmul: int, interpret: bool = False):
    """Top-K valley keys per row: (keys [R, TOPK] int32 sorted ascending
    with 2**30 sentinels, count [R] int32 exact valley count).  Rows
    with more than TOPK valleys keep the best TOPK — callers treat
    ``count > TOPK`` as overflow.

    patw: [4, W] uint32 pattern words (:func:`pattern_words`);
    rows: [R, L] uint8 IUPAC masks, L a power of two;
    emit_lo/emit_hi: [R] int32 inclusive emission range."""
    R0, L = rows.shape
    if L & (L - 1):
        raise ValueError(f"row width must be a power of two, got {L}")
    BR = BLOCK_ROWS
    R = -(-R0 // BR) * BR
    if R != R0:  # dead rows: empty emission range
        pad = R - R0
        rows = jnp.concatenate([rows, jnp.zeros((pad, L), rows.dtype)])
        emit_lo = jnp.concatenate([emit_lo, jnp.ones(pad, emit_lo.dtype)])
        emit_hi = jnp.concatenate([emit_hi, jnp.zeros(pad, emit_hi.dtype)])
    Wp = 1 << (W - 1).bit_length()  # block dims must be powers of two
    if Wp != W:
        patw = jnp.concatenate(
            [patw, jnp.zeros((4, Wp - W), patw.dtype)], axis=1
        )
    text_t = jnp.transpose(rows, (1, 0))
    keys, cnt = pl.pallas_call(
        functools.partial(_kernel, W=W, top_bit=top_bit, m=m, L=L,
                          k_units=k_units, klmul=klmul),
        out_shape=[
            jax.ShapeDtypeStruct((TOPK, R), jnp.int32),
            jax.ShapeDtypeStruct((R,), jnp.int32),
        ],
        grid=(R // BR,),
        in_specs=[
            pl.BlockSpec((4, Wp), lambda r: (0, 0)),
            pl.BlockSpec((L, BR), lambda r: (0, r)),
            pl.BlockSpec((BR,), lambda r: (r,)),
            pl.BlockSpec((BR,), lambda r: (r,)),
        ],
        out_specs=[
            pl.BlockSpec((TOPK, BR), lambda r: (0, r)),
            pl.BlockSpec((BR,), lambda r: (r,)),
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="myers_topk",
    )(patw, text_t, emit_lo.astype(jnp.int32), emit_hi.astype(jnp.int32))
    return jnp.transpose(keys, (1, 0))[:R0], cnt[:R0]
